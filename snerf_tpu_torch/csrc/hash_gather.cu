// Hash-grid row gather (kernel K2), forward only, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel snerf_tpu/ops/pallas/hash_gather_dense.py
// (`hash_gather_dense` -> `gather_rows_dense` -> `_kernel`). It computes
//   out[q, :] = table[idx[q], :]     table [T, C] f32, C in 1..8,
// idx int32 [N], out [N, C], for every level of the instant-NGP encoder,
// dense or hashed. The indices must lie in [0, T); the callers build them
// in range (level offset + a hash or stride taken modulo the level size).
//
// The TPU kernel keeps the table channels-on-sublanes in VMEM and resolves
// each 128-query vreg with one in-vreg gather plus a select per 128-row
// table block, because the v5e's only hardware gather spans one vreg; its
// cost grows with T, so the hashed 2^21-row levels could not use it. None
// of that carries over: Hopper loads any address, so there is no table
// layout change and no block loop, and one kernel serves every level.
//
// What bounds it on this card: device-memory bytes, and the 32-byte
// sector granularity of random reads. A row is C * 4 bytes, so at C = 1 a
// row read pulls a whole 32-byte sector for 4 useful bytes, and at C = 4
// for 16. The proposal tables (10.4 M and 13.3 M rows at C = 1, 40-50 MiB)
// mostly fit the 50 MB L2; the nerf table (15.0 M rows at C = 4, 229 MiB)
// does not, so its gathers are served from HBM. The index reads and the
// output writes are streaming and coalesced.
//
// Design: each thread takes kUnroll indices per grid-stride step (index
// j of a step sits kThreads apart, so the index loads and output stores
// of a warp stay coalesced), issues all their row loads before any store
// to keep several random reads in flight per thread, and loads a row with
// float4 / float2 / float vectors as C and the pointers' alignment allow.
// Offsets are 64-bit; the grid-stride loop covers any N. The scatter-add
// backward (atomicAdd into the table) comes with the training path.

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

const char* snerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
