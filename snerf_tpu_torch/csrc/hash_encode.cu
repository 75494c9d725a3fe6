// The fused multi-level hash encode (kernel K2 redesigned), forward and
// backward, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel snerf_tpu/ops/pallas/hash_gather_dense.py
// (`hash_gather_dense` -> `gather_rows_dense`) and its custom VJP's
// scatter-add, together with the per-level index and weight math around
// them in snerf_tpu/models/hashgrid.py `hash_encode`: for positions x
// [N, 3] f32 and a table [T, C] f32 (C <= 8) holding L <= 16 levels,
//   out[n, l, :] = sum_k w_k(x_n, l) * table[offset_l + idx_k(x_n, l), :]
// over the 8 corners k = i*4 + j*2 + k' of the point's cell at level l,
// with pos = x * scale_l + 0.5, c0 = floor(pos), frac = pos - c0, the
// weight (a_x * a_y) * a_z of a = 1 - frac or frac per axis, the row
// (cx + cy r + cz r^2) % size for a dense level (r = resolution + 1) and
// (cx ^ cy * 2654435761 ^ cz * 805459861) % size in uint32 for a hashed
// one. A point with a coordinate outside [0, 1] encodes to zeros and gets
// no gradient. The backward adds w_k * g[n, l, :] into the table's
// gradient and, when the positions need it, gives
//   dx[n, a] = sum_l scale_l sum_k (d w_k / d frac_a) <row_k, g[n, l, :]>.
//
// What it removes: the encoder used to run, per level, eager PyTorch ops
// for the int64 indices and the weights, K2's row gather into an [N, 8, C]
// tensor, the blend, and in the backward K2's scatter-add, the blend's
// backward and the [N, 8] indices and weights autograd kept for them (64
// bytes a point and level). Here a thread takes one (point, level) pair
// and does all of it in registers: it reads only x and the table's rows
// and writes only [N, L, C]; the backward recomputes the cell from x.
//
// Bound by bytes and by the table's random rows. The grid puts the level
// in the slow dimension (blockIdx.y forward; the level's block range in a
// 1-D grid backward), so the blocks in flight work on one level and its
// table stays in the 50 MB L2 while its points run (a hashed nerf level
// is 2^21 x 4 x 4 B = 32 MiB). x is read once a level. The row loads are
// float4 / float2 / float vectors as C and alignment allow, all 8 issued
// before the blend. The [N, L, C] store is strided by L * C floats
// between the threads of a warp; the host passes the output's point and
// level strides, so a level-major layout can be timed beside it.
//
// Rounding: pos = x * scale + 0.5 and the blend are written with
// __fmul_rn / __fadd_rn, so nvcc cannot contract them into FMAs: the
// corners, the weights and the features are those of the plain version
// (ops/hash_encode.py `hash_encode_fwd_plain`, whose blend adds the
// corners in the same order) bit for bit.
//
// The backward's table gradient is a scatter-add, bound by atomics. Per
// level the host picks one of the two designs measured for the scatter-
// add at the zip step's own indices (ops/hash_ops.py `scatter_variant`,
// which reads only the level's rows and C):
//   * a shared-memory copy (one channel, up to 128 KB): each block zeroes
//     a copy of the level's gradient, takes its updates with shared
//     atomics while it walks its share of the points, then adds its
//     nonzero rows into the gradient;
//   * warp aggregation elsewhere: for each corner, the lanes that hold
//     one row (__match_any_sync) hand their update to the lowest of them
//     through shared memory, which adds the sum with one vector atomic
//     (float4 / float2 atomicAdd on sm_90). When the whole warp holds one
//     row, as on the coarse levels where a warp's 32 consecutive points
//     (4 to 5 intervals of 7 multisamples) share a cell, the sum is a
//     5-step shuffle butterfly instead of the lowest lane's 31 serial
//     adds, which had made the nerf MLP's level 0 take 2.9 ms.
// The gradient is one zeroed [T, C] tensor (one memset by the caller).
// Atomics add in a new order on every run, so the table gradient and dx
// differ from run to run in their last bits, as the reference
// gridencoder's atomicAdd backward does; they are checked against f64
// controls with a tolerance. Offsets are 64-bit throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;       // forward
constexpr int kBwdThreads = 512;    // backward
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;

}  // namespace

// The level layout as the host packs it (ops/hash_encode.py `_Spec`,
// field for field).
struct HashSpec {
  int num_levels;
  int channels;
  float scale[kMaxLevels];
  uint32_t res1[kMaxLevels];     // resolution + 1: the dense stride base
  uint32_t size[kMaxLevels];     // rows of the level
  int32_t dense[kMaxLevels];     // 1: stride indexing; 0: the hash
  int32_t shared[kMaxLevels];    // backward: 1 shared copy, 0 warp agg.
  long long offset[kMaxLevels + 1];
};

namespace {

// The backward's grid: level l owns blocks [start[l], start[l + 1]).
struct BwdGrid {
  long long start[kMaxLevels + 1];
};

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

// v[0..C) = src[0..C), as C / V vectors; src aligned to V floats.
template <int C, int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ src,
                                         float (&v)[C]) {
  using VT = typename Vec<V>::T;
  const VT* s = reinterpret_cast<const VT*>(src);
#pragma unroll
  for (int i = 0; i < C / V; ++i) unpack(v + i * V, __ldg(s + i));
}

template <int C, int V>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[C]) {
  using VT = typename Vec<V>::T;
  VT* d = reinterpret_cast<VT*>(dst);
#pragma unroll
  for (int i = 0; i < C / V; ++i)
    d[i] = pack(v + i * V, static_cast<VT*>(nullptr));
}

// dst (global) += v, as C / V vector atomics.
template <int C, int V>
__device__ __forceinline__ void atomic_vec(float* dst, const float (&v)[C]) {
  using VT = typename Vec<V>::T;
  VT* d = reinterpret_cast<VT*>(dst);
#pragma unroll
  for (int i = 0; i < C / V; ++i)
    atomicAdd(d + i, pack(v + i * V, static_cast<VT*>(nullptr)));
}

// The cell of point xp at `lvl`: the 8 corners' level-local rows and the
// per-axis factors a[0][axis] = 1 - frac, a[1][axis] = frac. False (and
// nothing computed) for a point outside [0, 1]^3.
__device__ __forceinline__ bool cell(const float* __restrict__ xp,
                                     const HashSpec& s, int lvl,
                                     uint32_t (&row)[8], float (&a)[2][3]) {
  const float p[3] = {__ldg(xp), __ldg(xp + 1), __ldg(xp + 2)};
  // as the plain version's test: a NaN coordinate counts as in range, and
  // its corner converts to 0 below (in range), with NaN weights
  if (p[0] < 0.f || p[0] > 1.f || p[1] < 0.f || p[1] > 1.f || p[2] < 0.f ||
      p[2] > 1.f)
    return false;
  const float sc = s.scale[lvl];
  uint32_t c[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float pos = __fadd_rn(__fmul_rn(p[ax], sc), 0.5f);
    const float fl = floorf(pos);
    const float frac = __fsub_rn(pos, fl);
    c[ax] = (uint32_t)(int)fl;    // NaN converts to 0
    a[0][ax] = __fsub_rn(1.f, frac);
    a[1][ax] = frac;
  }
  const uint32_t size = s.size[lvl];
  if (s.dense[lvl]) {
    const uint32_t r = s.res1[lvl];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      row[k] = ((c[0] + (k >> 2)) + (c[1] + ((k >> 1) & 1)) * r +
                (c[2] + (k & 1)) * r * r) % size;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      row[k] = ((c[0] + (k >> 2)) ^ (c[1] + ((k >> 1) & 1)) * kPrime1 ^
                (c[2] + (k & 1)) * kPrime2) % size;
  }
  return true;
}

__device__ __forceinline__ float weight(const float (&a)[2][3], int k) {
  return __fmul_rn(__fmul_rn(a[k >> 2][0], a[(k >> 1) & 1][1]), a[k & 1][2]);
}

// out[p * ps + l * ls, :] for every point p < n and level l = blockIdx.y.
template <int C, int V>
__global__ void __launch_bounds__(kThreads)
hash_encode_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ table,
                       float* __restrict__ out, long long n, HashSpec s,
                       long long ps, long long ls) {
  const int lvl = blockIdx.y;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  float acc[C];
  uint32_t row[8];
  float a[2][3];
  if (cell(x + 3 * p, s, lvl, row, a)) {
    const float* lt = table + s.offset[lvl] * C;
    float r[8][C];
#pragma unroll
    for (int k = 0; k < 8; ++k) load_vec<C, V>(lt + (long long)row[k] * C,
                                               r[k]);
    const float w0 = weight(a, 0);
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = __fmul_rn(w0, r[0][c]);
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      const float w = weight(a, k);
#pragma unroll
      for (int c = 0; c < C; ++c)
        acc[c] = __fadd_rn(acc[c], __fmul_rn(w, r[k][c]));
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
  }
  store_vec<C, V>(out + p * ps + lvl * ls, acc);
}

// The table gradient (and dx when kDx) of every level, the level of a
// block from `grid`. A warp walks 32 consecutive points at a time in a
// grid-stride loop over the level's points, all lanes together (for
// __match_any_sync); lanes past n or outside [0, 1]^3 add nothing.
// Blocks of the backward an SM should hold: 3 for one or two channels
// without dx (the proposal MLPs, whose shared-copy levels let 3 blocks of
// up to 64.5 KB, or 2 of up to 99.6 KB, share an SM; 3 caps a thread at
// 40 registers), 2 for more channels, 1 with dx (up to 128 registers).
template <int C, bool kDx>
constexpr int bwd_min_blocks() {
  return kDx ? 1 : (C <= 2 ? 3 : 2);
}

template <int C, int V, bool kDx>
__global__ void __launch_bounds__(kBwdThreads, bwd_min_blocks<C, kDx>())
hash_encode_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ table,
                       const float* __restrict__ g, float* __restrict__ dT,
                       float* __restrict__ dx, long long n, HashSpec s,
                       BwdGrid grid) {
  extern __shared__ float s_rows[];             // shared levels: [size, C]
  __shared__ float stage[kBwdThreads * C];      // warp aggregation
  int lvl = 0;
  while (lvl + 1 < s.num_levels && blockIdx.x >= grid.start[lvl + 1]) ++lvl;
  const long long block = blockIdx.x - grid.start[lvl];
  const long long blocks = grid.start[lvl + 1] - grid.start[lvl];
  const bool shared = s.shared[lvl] != 0;
  const uint32_t size = s.size[lvl];
  const int L = s.num_levels;
  const int lane = threadIdx.x & 31;
  float* my_stage = stage + (threadIdx.x & ~31) * C;
  float* level_dT = dT + s.offset[lvl] * C;
  const float* lt = table + s.offset[lvl] * C;
  const float sc = s.scale[lvl];
  if (shared) {
    for (uint32_t i = threadIdx.x; i < size * C; i += kBwdThreads)
      s_rows[i] = 0.f;
    __syncthreads();
  }
  for (long long base = block * kBwdThreads + (threadIdx.x & ~31); base < n;
       base += blocks * kBwdThreads) {
    const long long p = base + lane;
    uint32_t row[8];
    float a[2][3];
    float gp[C];
    const bool valid = p < n && cell(x + 3 * p, s, lvl, row, a);
    if (valid) load_vec<C, V>(g + (p * L + lvl) * C, gp);
    if (kDx && valid) {
      // dx through the weights: d w_k / d frac_ax is w_k with the axis's
      // factor replaced by -1 (i = 0) or +1 (i = 1)
      float r[8][C];
#pragma unroll
      for (int k = 0; k < 8; ++k) load_vec<C, V>(lt + (long long)row[k] * C,
                                                 r[k]);
      float d[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = k >> 2, j = (k >> 1) & 1, kk = k & 1;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) dot += r[k][c] * gp[c];
        d[0] += (i ? dot : -dot) * (a[j][1] * a[kk][2]);
        d[1] += (j ? dot : -dot) * (a[i][0] * a[kk][2]);
        d[2] += (kk ? dot : -dot) * (a[i][0] * a[j][1]);
      }
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) atomicAdd(dx + 3 * p + ax, sc * d[ax]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float v[C] = {};
      if (valid) {
        const float w = weight(a, k);
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = __fmul_rn(w, gp[c]);
      }
      const int key = valid ? (int)row[k] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      bool lead = valid;
      if (peers == 0xffffffffu) {
        // one row for the whole warp (common on the coarse levels, where
        // a warp's 32 points share a cell): a butterfly sum, lane 0 adds
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[c] += __shfl_xor_sync(0xffffffffu, v[c], off);
        }
        lead = valid && lane == 0;
      } else if (!shared) {
        lead = valid && (__ffs(peers) - 1) == lane;
        if (__any_sync(0xffffffffu, lead && peers != (1u << lane))) {
#pragma unroll
          for (int c = 0; c < C; ++c) my_stage[lane * C + c] = v[c];
          __syncwarp();
          if (lead) {
            for (unsigned rest = peers & (peers - 1); rest;
                 rest &= rest - 1) {
              const float* o = my_stage + (__ffs(rest) - 1) * C;
#pragma unroll
              for (int c = 0; c < C; ++c) v[c] += o[c];
            }
          }
          __syncwarp();
        }
      }
      if (!lead) continue;
      if (shared) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          atomicAdd(s_rows + (long long)row[k] * C + c, v[c]);
        continue;
      }
      atomic_vec<C, V>(level_dT + (long long)row[k] * C, v);
    }
  }
  if (shared) {
    __syncthreads();
    for (uint32_t r = threadIdx.x; r < size; r += kBwdThreads) {
      float v[C];
      bool nonzero = false;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] = s_rows[r * C + c];
        nonzero |= v[c] != 0.f;
      }
      if (nonzero) atomic_vec<C, V>(level_dT + (long long)r * C, v);
    }
  }
}

template <int C, int V>
int launch_fwd(const float* x, const float* table, float* out, long long n,
               const HashSpec& s, long long ps, long long ls,
               cudaStream_t stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), s.num_levels);
  hash_encode_fwd_kernel<C, V><<<grid, kThreads, 0, stream>>>(
      x, table, out, n, s, ps, ls);
  return (int)cudaGetLastError();
}

template <int C, int V, bool kDx>
int launch_bwd(const float* x, const float* table, const float* g, float* dT,
               float* dx, long long n, const HashSpec& s, int device,
               cudaStream_t stream) {
  auto kernel = hash_encode_bwd_kernel<C, V, kDx>;
  size_t smem = 0;
  for (int l = 0; l < s.num_levels; ++l)
    if (s.shared[l] && (size_t)s.size[l] * C * sizeof(float) > smem)
      smem = (size_t)s.size[l] * C * sizeof(float);
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && smem > 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBwdThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  // a shared level: as many blocks as run at once (each zeroes and adds
  // its copy once); a warp level: a warp per 32 points
  BwdGrid grid;
  grid.start[0] = 0;
  const long long per_level = (n + kBwdThreads - 1) / kBwdThreads;
  const long long resident = (long long)sms * per_sm;
  for (int l = 0; l < s.num_levels; ++l)
    grid.start[l + 1] = grid.start[l] +
        (s.shared[l] && per_level > resident ? resident : per_level);
  if (grid.start[s.num_levels] >= (1LL << 31))
    return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)grid.start[s.num_levels], kBwdThreads, smem, stream>>>(
      x, table, g, dT, dx, n, s, grid);
  return (int)cudaGetLastError();
}

// The widest vector (4, 2 or 1 floats) that divides C and keeps every row
// of the pointers' arrays aligned to it.
template <int C>
int vec_width(uintptr_t align) {
  if (C % 4 == 0 && align % 16 == 0) return 4;
  if (C % 2 == 0 && align % 8 == 0) return 2;
  return 1;
}

template <int C>
int dispatch_fwd(const float* x, const float* table, float* out, long long n,
                 const HashSpec& s, long long ps, long long ls,
                 cudaStream_t stream) {
  // every row of out starts at a multiple of C floats only if the strides
  // are multiples of C (they are: [N, L, C] or [L, N, C])
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out |
                          (uintptr_t)((ps | ls) * sizeof(float));
  switch (vec_width<C>(align)) {
    case 4:
      if constexpr (C % 4 == 0)
        return launch_fwd<C, 4>(x, table, out, n, s, ps, ls, stream);
      break;
    case 2:
      if constexpr (C % 2 == 0)
        return launch_fwd<C, 2>(x, table, out, n, s, ps, ls, stream);
      break;
    default:
      break;
  }
  return launch_fwd<C, 1>(x, table, out, n, s, ps, ls, stream);
}

template <int C, int V>
int launch_bwd_dx(const float* x, const float* table, const float* g,
                  float* dT, float* dx, long long n, const HashSpec& s,
                  int device, cudaStream_t stream) {
  if (dx != nullptr)
    return launch_bwd<C, V, true>(x, table, g, dT, dx, n, s, device, stream);
  return launch_bwd<C, V, false>(x, table, g, dT, dx, n, s, device, stream);
}

template <int C>
int dispatch_bwd(const float* x, const float* table, const float* g,
                 float* dT, float* dx, long long n, const HashSpec& s,
                 int device, cudaStream_t stream) {
  const uintptr_t align = (uintptr_t)table | (uintptr_t)g | (uintptr_t)dT;
  switch (vec_width<C>(align)) {
    case 4:
      if constexpr (C % 4 == 0)
        return launch_bwd_dx<C, 4>(x, table, g, dT, dx, n, s, device, stream);
      break;
    case 2:
      if constexpr (C % 2 == 0)
        return launch_bwd_dx<C, 2>(x, table, g, dT, dx, n, s, device, stream);
      break;
    default:
      break;
  }
  return launch_bwd_dx<C, 1>(x, table, g, dT, dx, n, s, device, stream);
}

bool spec_ok(const HashSpec& s) {
  if (s.num_levels < 1 || s.num_levels > kMaxLevels || s.channels < 1 ||
      s.channels > 8)
    return false;
  for (int l = 0; l < s.num_levels; ++l)
    if (s.size[l] == 0 || s.offset[l + 1] - s.offset[l] != (long long)s.size[l])
      return false;
  return true;
}

}  // namespace

extern "C" {

// x [n, 3] f32, table [spec->offset[L], C] f32, out f32 with the features
// of point p and level l at out[p * ps + l * ls .. + C); contiguous, on
// `device`, C = spec->channels. Launches on `stream` without
// synchronising; returns the cudaError_t of the launch (0 = launched).
int snerf_hash_encode_fwd(const void* x, const void* table, void* out,
                          long long n, const HashSpec* spec, long long ps,
                          long long ls, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!spec_ok(*spec) || ps % spec->channels || ls % spec->channels)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const float* xs = static_cast<const float*>(x);
  const float* t = static_cast<const float*>(table);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const HashSpec& s = *spec;
  switch (s.channels) {
    case 1: return dispatch_fwd<1>(xs, t, o, n, s, ps, ls, st);
    case 2: return dispatch_fwd<2>(xs, t, o, n, s, ps, ls, st);
    case 3: return dispatch_fwd<3>(xs, t, o, n, s, ps, ls, st);
    case 4: return dispatch_fwd<4>(xs, t, o, n, s, ps, ls, st);
    case 5: return dispatch_fwd<5>(xs, t, o, n, s, ps, ls, st);
    case 6: return dispatch_fwd<6>(xs, t, o, n, s, ps, ls, st);
    case 7: return dispatch_fwd<7>(xs, t, o, n, s, ps, ls, st);
    case 8: return dispatch_fwd<8>(xs, t, o, n, s, ps, ls, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x [n, 3], table [T, C], g [n, L, C], dT [T, C] zeroed by the caller, dx
// [n, 3] zeroed by the caller or null (no dx); f32, contiguous, on
// `device`. Adds every level's w * g into dT (and the positions' gradient
// into dx) with atomics. Launches on `stream` without synchronising;
// returns the cudaError_t of the launch (0 = launched).
int snerf_hash_encode_bwd(const void* x, const void* table, const void* g,
                          void* dT, void* dx, long long n,
                          const HashSpec* spec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!spec_ok(*spec)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const float* xs = static_cast<const float*>(x);
  const float* t = static_cast<const float*>(table);
  const float* gs = static_cast<const float*>(g);
  float* d = static_cast<float*>(dT);
  float* dxs = static_cast<float*>(dx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const HashSpec& s = *spec;
  switch (s.channels) {
    case 1: return dispatch_bwd<1>(xs, t, gs, d, dxs, n, s, device, st);
    case 2: return dispatch_bwd<2>(xs, t, gs, d, dxs, n, s, device, st);
    case 3: return dispatch_bwd<3>(xs, t, gs, d, dxs, n, s, device, st);
    case 4: return dispatch_bwd<4>(xs, t, gs, d, dxs, n, s, device, st);
    case 5: return dispatch_bwd<5>(xs, t, gs, d, dxs, n, s, device, st);
    case 6: return dispatch_bwd<6>(xs, t, gs, d, dxs, n, s, device, st);
    case 7: return dispatch_bwd<7>(xs, t, gs, d, dxs, n, s, device, st);
    case 8: return dispatch_bwd<8>(xs, t, gs, d, dxs, n, s, device, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* snerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
