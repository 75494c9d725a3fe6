// Hash-grid row gather (kernel K2) and its scatter-add backward, for
// Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel snerf_tpu/ops/pallas/hash_gather_dense.py
// (`hash_gather_dense` -> `gather_rows_dense` -> `_kernel`) and its custom
// VJP's backward (`_bwd` -> snerf_tpu/ops/hash_ops.py `scatter_add_rows`,
// an XLA scatter on the TPU). The forward computes
//   out[q, :] = table[idx[q], :]     table [T, C] f32, C in 1..8,
// idx int32 [N], out [N, C], for every level of the instant-NGP encoder,
// dense or hashed; the backward
//   dT[idx[q], :] += g[q, :]         dT [T, C] f32 zeroed by the caller.
// The indices must lie in [0, T); the callers build them in range (level
// offset + a hash or stride taken modulo the level size).
//
// The TPU kernel keeps the table channels-on-sublanes in VMEM and resolves
// each 128-query vreg with one in-vreg gather plus a select per 128-row
// table block, because the v5e's only hardware gather spans one vreg; its
// cost grows with T, so the hashed 2^21-row levels could not use it, and
// the v5e has no scatter at all. None of that carries over: Hopper loads
// any address and adds into any address with atomics in L2, so there is
// no table layout change and no block loop, and one kernel per direction
// serves every level.
//
// Gather: bound by device-memory bytes, and the 32-byte sector
// granularity of random reads. A row is C * 4 bytes, so at C = 1 a row
// read pulls a whole 32-byte sector for 4 useful bytes, and at C = 4 for
// 16. The proposal tables (10.4 M and 13.3 M rows at C = 1, 40-50 MiB)
// mostly fit the 50 MB L2; the nerf table (15.0 M rows at C = 4, 229 MiB)
// does not, so its gathers are served from HBM. The index reads and the
// output writes are streaming and coalesced. Each thread takes kUnroll
// indices per grid-stride step (index j of a step sits kThreads apart, so
// the index loads and output stores of a warp stay coalesced), issues all
// their row loads before any store to keep several random reads in flight
// per thread, and loads a row with float4 / float2 / float vectors as C
// and the pointers' alignment allow. Offsets are 64-bit; the grid-stride
// loop covers any N.
//
// Scatter-add: bound by atomic throughput rather than by bytes. Each
// update to device memory is one reduction (RED) per vector of the row,
// resolved in the L2 slice that owns the address; updates to different
// addresses proceed in parallel, updates to one address serialise there.
// The hashed levels spread their updates over 2^21 rows; the dense coarse
// levels do not (level 0 of a 16^3 grid holds 17^3 = 4,913 rows, and a
// proposal MLP sends it 32,768 x 64 x 7 x 8 ~ 1.2e8 updates a step, ~24k
// a row), and the step's indices are coherent: a warp's 32 consecutive
// updates (4 points x 8 corners) touch 8.6 distinct rows at level 0 and
// 22-32 at level 9. The first design, one vector atomicAdd a row piece,
// took ~7.7 ms on level 0, and its f32 sums there strayed 1.3e-4 of
// max|dT| from an f64 sum (the f32 index_add_ as far), since a row's ~24k
// coherent updates pile up in one address. Two remedies, picked per
// launch by the host from the level's size (ops/hash_ops.py
// `scatter_variant`):
//   * warp aggregation (variant 0): __match_any_sync on the row; the
//     lanes of a row hand their vectors to its lowest lane through a word
//     a lane of shared memory, and only that lane adds the sum, so a
//     level takes one global atomic per distinct row a warp. On the
//     step's indices it beat the first design on every level but one
//     hashed level, where it lost 6% (1.09 against 1.03 ms), and tied it
//     on uniform indices, so that design is gone;
//   * a shared-memory copy (variant 1): a block zeroes a copy of the
//     whole level gradient, takes its updates with shared-memory atomics
//     (no trip to L2, and each block's share of a row summed apart) and
//     at the end adds its nonzero rows into dT. It pays at one channel up
//     to 128 KB (the coarse proposal levels); at four channels its
//     per-channel shared atomics lose to warp aggregation.
// A warp takes 32 consecutive updates at a time in a grid-stride loop,
// with coalesced index and gradient loads.
// Atomics add in a different order on every run, in both variants, so dT
// differs from run to run in its last bits; it is checked against an f64
// index_add_ control with a tolerance, never for bit-equality.
//
// No model path launches these kernels any more: the hash encoder runs
// the fused multi-level encode (hash_encode.cu), which gathers and
// scatters every level inside one kernel each way with the designs above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSM = 8;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

// C channels per row, read as C / V vectors of V floats.
template <int C, int V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table,
                   const int32_t* __restrict__ idx, float* __restrict__ out,
                   long long n) {
  using VT = typename Vec<V>::T;
  constexpr int kVecs = C / V;
  const VT* tab = reinterpret_cast<const VT*>(table);
  VT* dst = reinterpret_cast<VT*>(out);
  const long long stride = (long long)gridDim.x * kThreads * kUnroll;
  for (long long base = (long long)blockIdx.x * kThreads * kUnroll +
                        threadIdx.x;
       base < n; base += stride) {
    VT rows[kUnroll][kVecs];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long q = base + (long long)j * kThreads;
      if (q < n) {
        const long long row = (long long)__ldg(idx + q);
#pragma unroll
        for (int v = 0; v < kVecs; ++v)
          rows[j][v] = __ldg(tab + row * kVecs + v);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long q = base + (long long)j * kThreads;
      if (q < n) {
#pragma unroll
        for (int v = 0; v < kVecs; ++v) dst[q * kVecs + v] = rows[j][v];
      }
    }
  }
}

// ---- the scatter-add (see the note at the top)
constexpr int kScatterThreads = 512;

__device__ __forceinline__ void unpack(float* v, float x) { v[0] = x; }
__device__ __forceinline__ void unpack(float* v, float2 x) {
  v[0] = x.x;
  v[1] = x.y;
}
__device__ __forceinline__ void unpack(float* v, float4 x) {
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ float pack(const float* v, float*) { return v[0]; }
__device__ __forceinline__ float2 pack(const float* v, float2*) {
  return make_float2(v[0], v[1]);
}
__device__ __forceinline__ float4 pack(const float* v, float4*) {
  return make_float4(v[0], v[1], v[2], v[3]);
}

// dT_row (global) += v, as C / V vector atomics.
template <int C, int V>
__device__ __forceinline__ void atomic_row(float* dT_row, const float (&v)[C]) {
  using VT = typename Vec<V>::T;
  VT* d = reinterpret_cast<VT*>(dT_row);
#pragma unroll
  for (int i = 0; i < C / V; ++i)
    atomicAdd(d + i, pack(v + i * V, static_cast<VT*>(nullptr)));
}

// dT[idx[q]] += g[q] for q < n, C channels a row read as C / V vectors.
// A warp takes 32 consecutive updates at a time (kUnroll groups of them
// loaded first). kShared: into a zeroed copy of all num_rows rows in
// shared memory with shared atomics, whose nonzero rows are then added
// into dT. Else straight into dT, aggregated: the lanes that hold one row
// (__match_any_sync) hand their vectors to the lowest of them through a
// word a lane of shared memory, and only that lane adds the sum.
template <int C, int V, bool kShared>
__global__ void __launch_bounds__(kScatterThreads)
scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                            const float* __restrict__ g,
                            float* __restrict__ dT, long long n,
                            int num_rows) {
  using VT = typename Vec<V>::T;
  extern __shared__ float s_rows[];  // kShared: [num_rows, C]
  __shared__ float stage[kShared ? 1 : kScatterThreads];
  const int lane = threadIdx.x & 31;
  float* my_stage = stage + (kShared ? 0 : (threadIdx.x & ~31));
  if (kShared) {
    for (int i = threadIdx.x; i < num_rows * C; i += blockDim.x)
      s_rows[i] = 0.f;
    __syncthreads();
  }
  const VT* src = reinterpret_cast<const VT*>(g);
  const long long step = (long long)gridDim.x * blockDim.x * kUnroll;
  for (long long base = ((long long)blockIdx.x * blockDim.x +
                         (threadIdx.x & ~31)) * kUnroll;
       base < n; base += step) {
    int row[kUnroll];
    float v[kUnroll][C];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long q = base + 32 * j + lane;
      row[j] = -1;
      if (q < n) {
        row[j] = __ldg(idx + q);
#pragma unroll
        for (int i = 0; i < C / V; ++i)
          unpack(v[j] + i * V, __ldg(src + q * (C / V) + i));
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      bool lead = row[j] >= 0;
      if (!kShared) {
        const unsigned peers = __match_any_sync(0xffffffffu, row[j]);
        lead = lead && (__ffs(peers) - 1) == lane;
        if (__any_sync(0xffffffffu, lead && peers != (1u << lane))) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            my_stage[lane] = v[j][c];
            __syncwarp();
            if (lead) {
              for (unsigned rest = peers & (peers - 1); rest;
                   rest &= rest - 1)
                v[j][c] += my_stage[__ffs(rest) - 1];
            }
            __syncwarp();
          }
        }
      }
      if (!lead) continue;
      if (kShared) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          atomicAdd(s_rows + (long long)row[j] * C + c, v[j][c]);
      } else {
        atomic_row<C, V>(dT + (long long)row[j] * C, v[j]);
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int r = threadIdx.x; r < num_rows; r += blockDim.x) {
      float v[C];
      bool nonzero = false;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] = s_rows[r * C + c];
        nonzero |= v[c] != 0.f;
      }
      if (nonzero) atomic_row<C, V>(dT + (long long)r * C, v);
    }
  }
}

template <int C, int V>
int launch(const float* table, const int32_t* idx, float* out, long long n,
           int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = (long long)kThreads * kUnroll;
  long long blocks = (n + per_block - 1) / per_block;
  const long long cap = (long long)sms * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  gather_rows_kernel<C, V>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(table, idx, out, n);
  return (int)cudaGetLastError();
}

template <int C, int V, bool kShared>
int launch_scatter(const int32_t* idx, const float* g, float* dT, long long n,
               int num_rows, int device, cudaStream_t stream) {
  auto kernel = scatter_add_rows_kernel<C, V, kShared>;
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const size_t smem = kShared ? (size_t)num_rows * C * sizeof(float) : 0;
  if (err == cudaSuccess && kShared)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kScatterThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long per_block = (long long)kScatterThreads * kUnroll;
  long long blocks = (n + per_block - 1) / per_block;
  const long long cap = (long long)sms * per_sm;
  if (blocks > cap) blocks = cap;
  kernel<<<(unsigned)blocks, kScatterThreads, smem, stream>>>(idx, g, dT, n,
                                                          num_rows);
  return (int)cudaGetLastError();
}

// Variant 0: warp aggregation, global atomics; 1: the shared-memory
// copy.
template <int C, int V>
int launch_variant(const int32_t* idx, const float* g, float* dT,
                   long long n, int num_rows, int variant, int device,
                   cudaStream_t stream) {
  switch (variant) {
    case 0:
      return launch_scatter<C, V, false>(idx, g, dT, n, num_rows, device,
                                         stream);
    case 1:
      return launch_scatter<C, V, true>(idx, g, dT, n, num_rows, device,
                                        stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The widest vector (4, 2 or 1 floats) that divides C and keeps every
// row of `table` and `out` aligned to it.
template <int C>
int dispatch(const float* table, const int32_t* idx, float* out, long long n,
             int device, cudaStream_t stream) {
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out;
  if constexpr (C % 4 == 0) {
    if (align % 16 == 0)
      return launch<C, 4>(table, idx, out, n, device, stream);
  }
  if constexpr (C % 2 == 0) {
    if (align % 8 == 0)
      return launch<C, 2>(table, idx, out, n, device, stream);
  }
  return launch<C, 1>(table, idx, out, n, device, stream);
}

// The widest vector (4, 2 or 1 floats) that divides C and keeps every row
// of `g` and `dT` aligned to it.
template <int C>
int dispatch_scatter(const int32_t* idx, const float* g, float* dT,
                     long long n, int num_rows, int variant, int device,
                     cudaStream_t stream) {
  const uintptr_t align = (uintptr_t)g | (uintptr_t)dT;
  if constexpr (C % 4 == 0) {
    if (align % 16 == 0)
      return launch_variant<C, 4>(idx, g, dT, n, num_rows, variant, device,
                                  stream);
  }
  if constexpr (C % 2 == 0) {
    if (align % 8 == 0)
      return launch_variant<C, 2>(idx, g, dT, n, num_rows, variant, device,
                                  stream);
  }
  return launch_variant<C, 1>(idx, g, dT, n, num_rows, variant, device,
                              stream);
}

}  // namespace

extern "C" {

// table [rows, c] f32, idx [n] int32 with every value in [0, rows), out
// [n, c] f32; contiguous, on `device`, 1 <= c <= 8. Launches on `stream`
// without synchronising; returns the cudaError_t of the launch (0 =
// launched).
int snerf_gather_rows(const void* table, const void* idx, void* out,
                      long long n, int c, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const float* t = static_cast<const float*>(table);
  const int32_t* i = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return dispatch<1>(t, i, o, n, device, s);
    case 2: return dispatch<2>(t, i, o, n, device, s);
    case 3: return dispatch<3>(t, i, o, n, device, s);
    case 4: return dispatch<4>(t, i, o, n, device, s);
    case 5: return dispatch<5>(t, i, o, n, device, s);
    case 6: return dispatch<6>(t, i, o, n, device, s);
    case 7: return dispatch<7>(t, i, o, n, device, s);
    case 8: return dispatch<8>(t, i, o, n, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// idx [n] int32 with every value in [0, rows), g [n, c] f32, dT [rows, c]
// f32 zeroed by the caller; contiguous, on `device`, 1 <= c <= 8. Adds
// g[q] into dT[idx[q]] with atomics, by `variant` (0: warp-aggregated; 1:
// through a shared-memory copy of dT, which must fit a block).
// Launches on `stream` without synchronising; returns the cudaError_t of
// the launch (0 = launched).
int snerf_scatter_add_rows(const void* idx, const void* g, void* dT,
                           long long n, int c, int rows, int variant,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  if (rows <= 0 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  const int32_t* i = static_cast<const int32_t*>(idx);
  const float* s = static_cast<const float*>(g);
  float* d = static_cast<float*>(dT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return dispatch_scatter<1>(i, s, d, n, rows, variant, device, st);
    case 2: return dispatch_scatter<2>(i, s, d, n, rows, variant, device, st);
    case 3: return dispatch_scatter<3>(i, s, d, n, rows, variant, device, st);
    case 4: return dispatch_scatter<4>(i, s, d, n, rows, variant, device, st);
    case 5: return dispatch_scatter<5>(i, s, d, n, rows, variant, device, st);
    case 6: return dispatch_scatter<6>(i, s, d, n, rows, variant, device, st);
    case 7: return dispatch_scatter<7>(i, s, d, n, rows, variant, device, st);
    case 8: return dispatch_scatter<8>(i, s, d, n, rows, variant, device, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* snerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
