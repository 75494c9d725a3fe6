// The CP level encode (models/cpgrid.py `level_encode_rows`), forward and
// table gradient, for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX module (snerf_tpu/models/cpgrid.py
// `_level_encode`) runs this encode in XLA, as dense [rows, R] Gaussian
// profiles fed to MXU matmuls. The port's plain version does the same in
// PyTorch: ~8 elementwise passes over a [rows, R] float32 profile an axis,
// then a [rows, R] x [R, F] cuBLAS product, and all of it again under
// autograd in the backward. Those passes move ~60 bytes an entry through
// HBM; at the cp_hash step's 21e9 profile entries a forward they were most
// of the step. Here the profile never leaves registers.
//
// What it computes, for rows u, var [M, n, 3] float32 (grid units) and a
// level's table T [3, R, FT] = [V | P] (the bounded tables in the compute
// dtype; FT = F + F2, the CP width and the pair width):
//   w_a[m, i] = exp(-0.5 (u_ma - i)^2 / var_ma), normalised over i as
//               w / (sum_i w + 1e-12) in float32, then rounded to the dtype
//   o_a = w_a @ T_a                      [M, FT], rounded to the dtype
//   f = [o_0 o_1 o_2 (the F columns) | p01 p12 p02 (F2 each)], the mean
//       over the n components; every product, sum and the mean rounded to
//       the dtype as the plain version's bf16 or float32 ops round them.
// The table gradient: dT_a = sum over rows and components of
// w_a^T (g-chain)_a, where the chain is the plain version's autograd of
// the products, op for op at its rounding points.
//
// Design (mma.sync, the warp as the unit):
//   * A warp owns 16 consecutive rows (a quarter or half of a ray's
//     samples, so the rows lie close in the grid). For each component and
//     axis it sweeps the nodes twice: the normaliser, then the product.
//     Each lane generates its entries of the profile straight in the
//     register layout of the mma's A operand (m16n8k16 bf16, or m16n8k8
//     tf32 for float32), from u, var and the node index alone. The table
//     is B, pre-arranged by the host in fragment order, read through the
//     read-only cache (a level's table is 3-400 KB).
//   * Window: a term whose float32 exp is exactly +0 adds nothing, so a
//     node i with (u - i)^2 > 216 var (an exponent below -108; the float32
//     exp is 0 below -103.98) is skipped. The warp sweeps the union of its
//     16 rows' windows in steps of 16 nodes; every node inside is
//     computed. No tolerance enters: the skipped terms are those the plain
//     version adds as exact zeros.
//   * Precision: bf16 operands with float32 accumulation (m16n8k16) in a
//     bf16 dtype; in float32 the split 3xTF32 product (big and small TF32
//     halves of both operands, small terms first, as K1 does), never one
//     TF32 product, each step of 16 nodes (or rows) into a fresh
//     accumulator added to the sum in float32 (`add`).
//   * Bound: the profile's exps (one ex2 an entry and ~5 float32 ops; the
//     SFU does 16 ex2 a clock an SM) and the issue slots, not bytes (the
//     kernel reads u, var and g and writes the features) and not the
//     product (tensor cores). Only the mma.sync rate of the 3xTF32 product
//     at F 64 comes close.
//   * Backward, in two launches (the table gradient needs all three axes'
//     o for a row, and a row's o needs every node): the first recomputes
//     the forward and writes, per row tile, the chained gradient of each
//     axis in the fragment order of the second's A operand, each row's
//     (u, exp2 coefficient, normaliser) and the tile's window. The second
//     gives each warp 32 nodes of one axis and a split of the row tiles:
//     it regenerates the profile as the B operand (K = rows, N = nodes)
//     with the same arithmetic, skips tiles whose window misses its
//     nodes, and writes its float32 partial; the host sums the splits.
//     The forward's inputs u and var get no gradient here (the caller
//     takes the plain path when they need one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;      // nodes a warp owns in the table gradient
constexpr float kLog2e = 1.4426950408889634f;
// (u - i)^2 > kWindow var: the exponent -0.5 (u - i)^2 / var is below -108
constexpr float kWindow = 216.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool BF>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// The offset (within a step of 16 along K) of a lane's j-th K index, j =
// 0..3, for lane % 4 = t: m16n8k16 holds 2t, 2t+1, 2t+8, 2t+9; two
// m16n8k8 steps hold t, t+4 and t+8, t+12.
template <bool BF>
__device__ __forceinline__ int kcol(int t, int j) {
  if constexpr (BF) {
    return 2 * t + (j & 1) + 8 * (j >> 1);
  } else {
    return t + 4 * j;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += s with float32 adds (round to nearest): the tensor cores' own
// accumulation truncates, which over a long chain of mma on one accumulator
// drifts by ~1 ulp a link (2^-24 relative), 3.8e-5 over a 1,024-node sweep
// in 3xTF32; a fresh accumulator a step added here keeps float32's rounding
__device__ __forceinline__ void add(float (&d)[4], const float (&s)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += s[e];
}

// d += a b in 3xTF32: the small terms first, then big x big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// o = w_a @ T_a (rounded to the dtype) for the warp's 16 rows from row0,
// component k, axis a, in the mma's C layout: o[nt][0..1] row g, o[nt][2..3]
// row g + 8, columns 8 nt + 2t, + 1. With `rows` set, also writes each
// row's (u, exp2 coefficient, normaliser) and the warp's window.
template <bool BF, int NT>
__device__ __forceinline__ void level_axis(
    float (&o)[NT][4], const float* __restrict__ u,
    const float* __restrict__ var, const void* __restrict__ table,
    long long row0, long long m, int n, int k, int a, int r, int ksteps,
    int lane, float4* __restrict__ rows, int2* __restrict__ win) {
  const int g = lane >> 2, t = lane & 3;
  float uh[2], ch[2], inv[2];
  bool valid[2];
  int lo = r, hi = -1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + g + 8 * h;
    valid[h] = row < m;
    const long long at = (row * n + k) * 3 + a;
    const float uu = valid[h] ? u[at] : 0.f;
    const float vv = valid[h] ? var[at] : 1.f;
    uh[h] = uu;
    ch[h] = (-0.5f * kLog2e) / vv;
    if (valid[h]) {
      const float half = sqrtf(kWindow * vv);
      const float l = fmaxf(ceilf(uu - half), 0.f);
      const float e = fminf(floorf(uu + half), (float)(r - 1));
      if (l <= e) {
        lo = min(lo, (int)l);
        hi = max(hi, (int)e);
      }
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  // lo > hi (no row reaches a node): no step, the features are 0, as the
  // plain version's 0 / (0 + 1e-12)
  const int k0 = lo >> 4, k1 = hi >> 4;

  float s[2] = {0.f, 0.f};
  for (int ks = k0; ks <= k1; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 16 * ks + kcol<BF>(t, j);
      const float fi = (float)i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d = uh[h] - fi;
        const float e = ex2(ch[h] * (d * d));
        s[h] += i < r ? e : 0.f;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(kFull, s[h], 1);
    s[h] += __shfl_xor_sync(kFull, s[h], 2);
    inv[h] = valid[h] ? 1.f / (s[h] + 1e-12f) : 0.f;
  }
  if (rows != nullptr) {
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + g + 8 * h;
        rows[(row * n + k) * 3 + a] = make_float4(uh[h], ch[h], inv[h], 0.f);
      }
    }
    if (lane == 0) win[((row0 >> 4) * n + k) * 3 + a] = make_int2(lo, hi);
  }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int ks = k0; ks <= k1; ++ks) {
    // the table's padded nodes (i >= r) are zero rows, so w there is moot
    float w[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float fi = (float)(16 * ks + kcol<BF>(t, j));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d = uh[h] - fi;
        w[h][j] = ex2(ch[h] * (d * d)) * inv[h];
      }
    }
    const size_t entry = (size_t)(a * ksteps + ks) * NT * 32 + lane;
    if constexpr (BF) {
      const uint32_t a0 = pack_bf16(w[0][0], w[0][1]);
      const uint32_t a1 = pack_bf16(w[1][0], w[1][1]);
      const uint32_t a2 = pack_bf16(w[0][2], w[0][3]);
      const uint32_t a3 = pack_bf16(w[1][2], w[1][3]);
      const uint2* tb = static_cast<const uint2*>(table) + entry;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = __ldg(tb + nt * 32);
        mma_bf16(acc[nt], a0, a1, a2, a3, b.x, b.y);
      }
    } else {
      // m16n8k8 step q: a0 (row g, K j=2q), a1 (row g+8, 2q), a2 (row g,
      // 2q+1), a3 (row g+8, 2q+1)
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        split(w[0][2 * q], ab[q][0], as[q][0]);
        split(w[1][2 * q], ab[q][1], as[q][1]);
        split(w[0][2 * q + 1], ab[q][2], as[q][2]);
        split(w[1][2 * q + 1], ab[q][3], as[q][3]);
      }
      const uint4* tb = static_cast<const uint4*>(table) + 2 * entry;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // (big j0..j3, small j0..j3) of column 8 nt + g
        const uint4 bb = __ldg(tb + nt * 64);
        const uint4 bs = __ldg(tb + nt * 64 + 1);
        float step[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(step, ab[0], as[0], bb.x, bb.y, bs.x, bs.y);
        mma_3xtf32(step, ab[1], as[1], bb.z, bb.w, bs.z, bs.w);
        add(acc[nt], step);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = rnd<BF>(acc[nt][e]);
}

template <int NT>
__device__ __forceinline__ void keep(float (&dst)[NT][4],
                                     const float (&src)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[nt][e] = src[nt][e];
}

// One row tile's features: NF tiles of 8 CP columns, NP tiles of 8 pair
// columns; out [m, 8 (NF + 3 NP)] in the dtype.
template <bool BF, int NF, int NP>
__global__ void __launch_bounds__(kThreads) cp_encode_fwd_kernel(
    const float* __restrict__ u, const float* __restrict__ var,
    const void* __restrict__ table, void* __restrict__ out, long long m,
    int n, int r, int ksteps) {
  constexpr int NT = NF + NP, NO = NF + 3 * NP, NPP = NP > 0 ? NP : 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long row0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 16;
  if (row0 >= m) return;
  float res[NO][4];
  for (int k = 0; k < n; ++k) {
    float prod[NF][4], pf0[NPP][4], pf1[NPP][4], pf2[NPP][4];
    for (int a = 0; a < 3; ++a) {
      float o[NT][4];
      level_axis<BF, NT>(o, u, var, table, row0, m, n, k, a, r, ksteps, lane,
                         nullptr, nullptr);
#pragma unroll
      for (int nt = 0; nt < NF; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          prod[nt][e] = a == 0 ? o[nt][e] : rnd<BF>(prod[nt][e] * o[nt][e]);
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = o[NF + p][e];
          if (a == 0) pf0[p][e] = v;
          else if (a == 1) pf1[p][e] = v;
          else pf2[p][e] = v;
        }
    }
    float comp[NO][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int nt = 0; nt < NF; ++nt) comp[nt][e] = prod[nt][e];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        comp[NF + p][e] = rnd<BF>(pf0[p][e] * pf1[p][e]);
        comp[NF + NP + p][e] = rnd<BF>(pf1[p][e] * pf2[p][e]);
        comp[NF + 2 * NP + p][e] = rnd<BF>(pf0[p][e] * pf2[p][e]);
      }
#pragma unroll
      for (int ot = 0; ot < NO; ++ot)
        res[ot][e] = k == 0 ? comp[ot][e] : rnd<BF>(res[ot][e] + comp[ot][e]);
    }
  }
  if (n > 1) {
#pragma unroll
    for (int ot = 0; ot < NO; ++ot)
#pragma unroll
      for (int e = 0; e < 4; ++e) res[ot][e] = rnd<BF>(res[ot][e] / (float)n);
  }
  constexpr int W = 8 * NO;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + g + 8 * h;
    if (row >= m) continue;
#pragma unroll
    for (int ot = 0; ot < NO; ++ot) {
      const long long at = row * W + 8 * ot + 2 * t;
      if constexpr (BF) {
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(out) + at) =
            __floats2bfloat162_rn(res[ot][2 * h], res[ot][2 * h + 1]);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
            make_float2(res[ot][2 * h], res[ot][2 * h + 1]);
      }
    }
  }
}

// The output gradient at the warp's rows, column tile ot, C layout; /n
// (rounded) as the mean's backward gives it
template <bool BF>
__device__ __forceinline__ void load_g(float (&gv)[4], const void* gout,
                                       long long row0, long long m, int w,
                                       int ot, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + g + 8 * h;
    float2 v = make_float2(0.f, 0.f);
    if (row < m) {
      const long long at = row * w + 8 * ot + 2 * t;
      if constexpr (BF) {
        v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            static_cast<const __nv_bfloat16*>(gout) + at));
      } else {
        v = *reinterpret_cast<const float2*>(static_cast<const float*>(gout) +
                                             at);
      }
    }
    gv[2 * h] = v.x;
    gv[2 * h + 1] = v.y;
  }
  if (n > 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[e] = rnd<BF>(gv[e] / (float)n);
  }
}

// Writes one chained gradient value (row rr of the tile, table column f)
// into the fragment-ordered buffer of the table gradient's A operand (M =
// table columns, K = rows): per (tile, component, axis) FQ blocks of 16
// columns, each 32 lanes x 8 values, in the order of the lane's registers.
template <bool BF>
__device__ __forceinline__ void put(void* gp, size_t base, int rr, int f,
                                    float v) {
  const int q = f >> 4, fl = f & 15, gg = fl & 7, fhi = fl >> 3;
  int tt, j, e;
  if constexpr (BF) {
    tt = (rr & 7) >> 1;
    j = (rr & 1) + 2 * (rr >> 3);
    e = (j >> 1) * 4 + fhi * 2 + (j & 1);
  } else {
    tt = rr & 3;
    j = rr >> 2;
    e = (j >> 1) * 4 + (j & 1) * 2 + fhi;
  }
  const size_t at = base + ((size_t)q * 32 + gg * 4 + tt) * 8 + e;
  if constexpr (BF) {
    static_cast<__nv_bfloat16*>(gp)[at] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(gp)[at] = v;
  }
}

template <bool BF>
__device__ __forceinline__ void put_tile(void* gp, size_t base, int nt,
                                         const float (&v)[4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    put<BF>(gp, base, g + 8 * (e >> 1), 8 * nt + 2 * t + (e & 1), v[e]);
}

// The backward's first launch: recomputes the warp's rows as the forward
// does and writes, per component and axis, the chained gradient gp (the
// plain version's autograd of the products, op for op), the rows' (u,
// coefficient, normaliser) and the tile's window.
template <bool BF, int NF, int NP>
__global__ void __launch_bounds__(kThreads) cp_encode_bwd_chain_kernel(
    const float* __restrict__ u, const float* __restrict__ var,
    const void* __restrict__ table, const void* __restrict__ gout,
    void* __restrict__ gp, float4* __restrict__ rows, int2* __restrict__ win,
    long long m, int n, int r, int ksteps) {
  constexpr int NT = NF + NP, NO = NF + 3 * NP, FQ = (NT + 1) / 2;
  const int lane = threadIdx.x & 31;
  const long long row0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 16;
  if (row0 >= m) return;
  for (int k = 0; k < n; ++k) {
    float o0[NT][4], o1[NT][4], o2[NT][4];
    for (int a = 0; a < 3; ++a) {
      float o[NT][4];
      level_axis<BF, NT>(o, u, var, table, row0, m, n, k, a, r, ksteps, lane,
                         rows, win);
      if (a == 0) keep<NT>(o0, o);
      else if (a == 1) keep<NT>(o1, o);
      else keep<NT>(o2, o);
    }
    const size_t blk = (size_t)((row0 >> 4) * n + k) * 3;
    const size_t stride = (size_t)FQ * 32 * 8;
#pragma unroll
    for (int nt = 0; nt < NF; ++nt) {
      // f = (1.0 o0) o1 o2: d o2 = g (o0 o1), d o1 = (g o2) o0, d o0 =
      // (g o2) o1
      float gv[4], d0[4], d1[4], d2[4];
      load_g<BF>(gv, gout, row0, m, 8 * NO, nt, n, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float go2 = rnd<BF>(gv[e] * o2[nt][e]);
        d2[e] = rnd<BF>(gv[e] * rnd<BF>(o0[nt][e] * o1[nt][e]));
        d1[e] = rnd<BF>(go2 * o0[nt][e]);
        d0[e] = rnd<BF>(go2 * o1[nt][e]);
      }
      put_tile<BF>(gp, (blk + 0) * stride, nt, d0, lane);
      put_tile<BF>(gp, (blk + 1) * stride, nt, d1, lane);
      put_tile<BF>(gp, (blk + 2) * stride, nt, d2, lane);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      // p01 = pf0 pf1, p12 = pf1 pf2, p02 = pf0 pf2; a factor's two
      // gradients added in the dtype
      float g01[4], g12[4], g02[4], d0[4], d1[4], d2[4];
      load_g<BF>(g01, gout, row0, m, 8 * NO, NF + p, n, lane);
      load_g<BF>(g12, gout, row0, m, 8 * NO, NF + NP + p, n, lane);
      load_g<BF>(g02, gout, row0, m, 8 * NO, NF + 2 * NP + p, n, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float f0 = o0[NF + p][e], f1 = o1[NF + p][e],
                    f2 = o2[NF + p][e];
        d0[e] = rnd<BF>(rnd<BF>(g01[e] * f1) + rnd<BF>(g02[e] * f2));
        d1[e] = rnd<BF>(rnd<BF>(g01[e] * f0) + rnd<BF>(g12[e] * f2));
        d2[e] = rnd<BF>(rnd<BF>(g12[e] * f1) + rnd<BF>(g02[e] * f0));
      }
      put_tile<BF>(gp, (blk + 0) * stride, NF + p, d0, lane);
      put_tile<BF>(gp, (blk + 1) * stride, NF + p, d1, lane);
      put_tile<BF>(gp, (blk + 2) * stride, NF + p, d2, lane);
    }
  }
}

// The backward's second launch: each warp one axis, kChunk nodes and a
// split of the row tiles; dT^T [FT, nodes] += gp^T [FT, rows] @ w [rows,
// nodes], w regenerated from the rows' (u, coefficient, normaliser) with
// the forward's arithmetic. Writes partial[split, axis, node, column].
template <bool BF, int NT>
__global__ void __launch_bounds__(kThreads) cp_encode_bwd_table_kernel(
    const float4* __restrict__ rows, const int2* __restrict__ win,
    const void* __restrict__ gp, float* __restrict__ partial,
    long long tiles, int n, int chunks, int splits) {
  constexpr int FQ = (NT + 1) / 2, FT = 8 * NT;
  constexpr bool kHalf = NT % 2 == 1;   // the last 16 columns half empty
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long unit = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= (long long)splits * 3 * chunks) return;
  const int chunk = (int)(unit % chunks);
  const int a = (int)((unit / chunks) % 3);
  const int s = (int)(unit / (3LL * chunks));
  const long long t0 = tiles * s / splits, t1 = tiles * (s + 1) / splits;
  const int nb = chunk * kChunk;

  float acc[FQ][4][4];
#pragma unroll
  for (int q = 0; q < FQ; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][c][e] = 0.f;

  for (long long tile = t0; tile < t1; ++tile) {
    for (int k = 0; k < n; ++k) {
      const size_t blk = (size_t)(tile * n + k) * 3 + a;
      const int2 wd = win[blk];
      if (wd.x > wd.y || wd.y < nb || wd.x >= nb + kChunk) continue;
      float ur[4], cr[4], ir[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 rd =
            rows[((tile * 16 + kcol<BF>(t, j)) * n + k) * 3 + a];
        ur[j] = rd.x;
        cr[j] = rd.y;
        ir[j] = rd.z;
      }
      if constexpr (BF) {
        uint32_t af[FQ][4];
        const uint4* src = static_cast<const uint4*>(gp) + blk * FQ * 32;
#pragma unroll
        for (int q = 0; q < FQ; ++q) {
          const uint4 v = src[q * 32 + lane];
          const bool half = kHalf && q == FQ - 1;
          af[q][0] = v.x;
          af[q][1] = half ? 0u : v.y;
          af[q][2] = v.z;
          af[q][3] = half ? 0u : v.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float node = (float)(nb + 8 * c + g);
          float w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float d = ur[j] - node;
            w[j] = ex2(cr[j] * (d * d)) * ir[j];
          }
          const uint32_t b0 = pack_bf16(w[0], w[1]);
          const uint32_t b1 = pack_bf16(w[2], w[3]);
#pragma unroll
          for (int q = 0; q < FQ; ++q)
            mma_bf16(acc[q][c], af[q][0], af[q][1], af[q][2], af[q][3], b0,
                     b1);
        }
      } else {
        // per m16n8k8 step p: a0 (column g, row j=2p), a1 (g+8, 2p), a2
        // (g, 2p+1), a3 (g+8, 2p+1)
        uint32_t ab[FQ][2][4], as[FQ][2][4];
        const float4* src = static_cast<const float4*>(gp) + blk * FQ * 64;
#pragma unroll
        for (int q = 0; q < FQ; ++q) {
          const bool half = kHalf && q == FQ - 1;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const float4 v = src[(q * 32 + lane) * 2 + p];
            split(v.x, ab[q][p][0], as[q][p][0]);
            split(half ? 0.f : v.y, ab[q][p][1], as[q][p][1]);
            split(v.z, ab[q][p][2], as[q][p][2]);
            split(half ? 0.f : v.w, ab[q][p][3], as[q][p][3]);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float node = (float)(nb + 8 * c + g);
          uint32_t bb[4], bs[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float d = ur[j] - node;
            split(ex2(cr[j] * (d * d)) * ir[j], bb[j], bs[j]);
          }
#pragma unroll
          for (int q = 0; q < FQ; ++q) {
            float step[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int p = 0; p < 2; ++p)
              mma_3xtf32(step, ab[q][p], as[q][p], bb[2 * p], bb[2 * p + 1],
                         bs[2 * p], bs[2 * p + 1]);
            add(acc[q][c], step);
          }
        }
      }
    }
  }
  // C layout: rows (table columns) 16 q + g and + 8, columns (nodes)
  // nb + 8 c + 2t and + 1
  float* dst = partial + (size_t)(s * 3 + a) * chunks * kChunk * FT;
#pragma unroll
  for (int q = 0; q < FQ; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 16 * q + g + 8 * (e >> 1);
        const int node = nb + 8 * c + 2 * t + (e & 1);
        if (f < FT) dst[(size_t)node * FT + f] = acc[q][c][e];
      }
}

// Calls fn(bf16, NF, NP) with each as a compile-time constant: F in {8,
// 16, 32, 64}, F2 in {0, 8}.
template <class Fn>
cudaError_t by_width(int bf16, int nf, int np, Fn&& fn) {
  auto with_np = [&](auto bf, auto npc) -> cudaError_t {
    switch (nf) {
      case 1: return fn(bf, std::integral_constant<int, 1>{}, npc);
      case 2: return fn(bf, std::integral_constant<int, 2>{}, npc);
      case 4: return fn(bf, std::integral_constant<int, 4>{}, npc);
      case 8: return fn(bf, std::integral_constant<int, 8>{}, npc);
      default: return cudaErrorInvalidValue;
    }
  };
  auto with_bf = [&](auto bf) -> cudaError_t {
    if (np == 0) return with_np(bf, std::integral_constant<int, 0>{});
    if (np == 1) return with_np(bf, std::integral_constant<int, 1>{});
    return cudaErrorInvalidValue;
  };
  return bf16 ? with_bf(std::true_type{}) : with_bf(std::false_type{});
}

// Calls fn(bf16, NT) for the table widths FT = 8 NT that by_width covers
template <class Fn>
cudaError_t by_table_width(int bf16, int nt, Fn&& fn) {
  auto with_bf = [&](auto bf) -> cudaError_t {
    switch (nt) {
      case 1: return fn(bf, std::integral_constant<int, 1>{});
      case 2: return fn(bf, std::integral_constant<int, 2>{});
      case 3: return fn(bf, std::integral_constant<int, 3>{});
      case 4: return fn(bf, std::integral_constant<int, 4>{});
      case 5: return fn(bf, std::integral_constant<int, 5>{});
      case 8: return fn(bf, std::integral_constant<int, 8>{});
      case 9: return fn(bf, std::integral_constant<int, 9>{});
      default: return cudaErrorInvalidValue;
    }
  };
  return bf16 ? with_bf(std::true_type{}) : with_bf(std::false_type{});
}

unsigned row_blocks(long long m) {
  const long long tiles = (m + 15) / 16;
  return (unsigned)((tiles + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

// u, var [m, n, 3] f32; table: the level's table [3, r, 8 (nf + np)] in
// fragment order (ops/cp_encode.py `table_fragments`), bf16 or f32 as
// `bf16` says; out [m, 8 (nf + 3 np)] in that dtype. Contiguous, on
// `device`. Launches on `stream` without synchronising; returns the
// cudaError_t of the launch (0 = launched).
int snerf_cp_encode_fwd(const void* u, const void* var, const void* table,
                        void* out, long long m, int n, int r, int nf, int np,
                        int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || r < 1) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  const float* us = static_cast<const float*>(u);
  const float* vs = static_cast<const float*>(var);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ksteps = (r + 15) / 16;
  return (int)by_width(bf16, nf, np, [&](auto bf, auto nfc, auto npc) {
    cp_encode_fwd_kernel<decltype(bf)::value, decltype(nfc)::value,
                         decltype(npc)::value>
        <<<row_blocks(m), kThreads, 0, st>>>(us, vs, table, out, m, n, r,
                                             ksteps);
    return cudaGetLastError();
  });
}

// The table gradient, two launches. g [m, 8 (nf + 3 np)] in the dtype;
// scratch from the caller: gp (ceil(m / 16) n 3 ceil((nf + np) / 2) 256
// values of the dtype), rows (ceil(m / 16) 16 n 3 float4), win
// (ceil(m / 16) n 3 int2); partial [splits, 3, chunks 32, 8 (nf + np)]
// f32 with chunks = ceil(r / 32), every value written. Returns the first
// launch's error.
int snerf_cp_encode_bwd(const void* u, const void* var, const void* table,
                        const void* g, void* gp, void* rows, void* win,
                        void* partial, long long m, int n, int r, int nf,
                        int np, int bf16, int splits, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || r < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  const float* us = static_cast<const float*>(u);
  const float* vs = static_cast<const float*>(var);
  float4* rd = static_cast<float4*>(rows);
  int2* wd = static_cast<int2*>(win);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ksteps = (r + 15) / 16;
  err = by_width(bf16, nf, np, [&](auto bf, auto nfc, auto npc) {
    cp_encode_bwd_chain_kernel<decltype(bf)::value, decltype(nfc)::value,
                               decltype(npc)::value>
        <<<row_blocks(m), kThreads, 0, st>>>(us, vs, table, g, gp, rd, wd, m,
                                             n, r, ksteps);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (m + 15) / 16;
  const int chunks = (r + kChunk - 1) / kChunk;
  const long long units = (long long)splits * 3 * chunks;
  const unsigned blocks = (unsigned)((units + kWarps - 1) / kWarps);
  return (int)by_table_width(bf16, nf + np, [&](auto bf, auto ntc) {
    cp_encode_bwd_table_kernel<decltype(bf)::value, decltype(ntc)::value>
        <<<blocks, kThreads, 0, st>>>(rd, wd, gp, static_cast<float*>(partial),
                                      tiles, n, chunks, splits);
    return cudaGetLastError();
  });
}

const char* snerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
