// Fused uniform-width ReLU MLP, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel snerf_tpu/ops/pallas/fused_mlp.py
// (`fused_mlp` -> `_fwd` -> `_fwd_kernel`, and the custom VJP
// `_fused_fwd` / `_fused_bwd`, XLA einsums there). The forward computes,
// for L layers,
//   h = cast(act(h @ W[i] + b[i]))      W[i] laid out [in, out]
// with f32 accumulation, act = relu except on the last layer when
// last_relu == 0, and the cast to the storage type after EVERY layer, as
// the TPU kernel does.
//
// What bounds it on this card: at the render path's shapes (N ~ 5e5
// rows, D = 1024) each layer is ~1.1 TFLOP. On the SIMT FP32 pipes
// (67 TFLOP/s peak) that is the limit; cuBLAS reaches ~45 TFLOP/s there.
// The tensor cores are faster but multiply TF32 (10-bit mantissa), so
// f32 operands are split 3xTF32: x = big + small, both TF32, and
// a*b ~ a_big*b_big + a_big*b_small + a_small*b_big (three MMAs; the
// dropped term is ~2^-22 relative). bf16 operands are exact in TF32 and
// take one MMA. The tensor cores' f32 accumulation truncates, so an
// output drifts ~3e-5 from an IEEE f32 sum at D = 1024, L = 4. The other
// limit is weight traffic: the 4 MB f32 layer is re-read from L2 once
// per row tile.
//
// Design: the TPU kernel keeps a 512-row activation tile in VMEM across
// layers. Here 227 KB of shared memory would hold only 16 f32 rows at
// D = 1024, which caps the reuse of every weight read at 16 (a SIMT
// kernel of that design measured 21.6 TFLOP/s on an H100). Instead a
// block owns a band of 128 rows through all L layers and writes each
// layer's output to device memory (the final layer to `out`, earlier
// ones alternating with the scratch `tmp`; a 5e5 x 1024 f32 layer is
// ~1 ms of HBM traffic), so every weight read serves 128 rows. Per layer
// the block sweeps 128-column tiles: a 3-stage cp.async pipeline stages
// 128 x 32 activation and 32 x 128 weight tiles in shared memory (rows
// padded so the fragment reads are bank-conflict free), and 8 warps each
// own a 32 x 64 accumulator tile and issue mma.sync m16n8k8 TF32. The
// epilogue adds the bias, applies relu, casts and stores. Rows past N
// are zero-filled by cp.async and never stored; the TPU code padded N
// instead. A __syncthreads between layers orders the band's writes
// before its reads; bands are disjoint, so blocks never wait on each
// other. wgmma/TMA are later work.
//
// For training the forward takes an optional `saved` [L-1, N, D]: layer
// i < L-1 then lands in saved[i] instead of the scratch, so the backward
// reads every layer's output and recomputes nothing (the TPU kernel
// recomputes, since HBM there is scarce; here 3 x 2.1 GB at the fine
// trunk's 520,192 rows is what plain autograd keeps too). The arithmetic
// is unchanged, so the output is bit-equal to the eval call's.
//
// Backward, per layer i from the last (act_0 = x, act_{i+1} = layer i's
// output, dz_i = dL/d(pre-activation of layer i), all f32):
//   dgrad: dz_{i-1} = (dz_i W_i^T) * (act_i > 0), or dx = dz_0 W_0^T;
//   wgrad: dW_i = act_i^T dz_i, db_i = sum over rows of dz_i.
// Both are GEMMs on the same mma.sync 3xTF32 tiles, 3-stage cp.async
// pipeline and 128 x 128 block tile as the forward, with the operands
// staged in whichever orientation makes the fragment reads
// bank-conflict free (W^T for dgrad is W's rows staged [n][k]; act^T for
// wgrad is act's rows staged [k][m]). dgrad: a block owns a 128-row band
// and sweeps the D/128 column tiles (the band stays in L2 across them),
// and applies the ReLU mask of the layer below in its epilogue, so the
// next layer's dz is written once. wgrad reduces over N (~5e5 rows) into
// only (D/128)^2 output tiles, so N is split across blocks (the caller
// picks the split; the truncating tensor-core accumulator drifts with
// the rows a split sums, ~1.7e-5 of max|dW| at 2,048 rows): each writes
// an f32 partial tile (and, in the first tile row, the column sums of dz
// for db), and a second kernel sums the partials in split order. No
// atomics: two identical steps give bit-identical grads. The ReLU mask
// of the last layer (when last_relu) is an elementwise pass in the
// wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;     // rows per block (the band)
constexpr int kBN = 128;     // columns per output tile
constexpr int kBK = 32;      // k-depth of one pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;          // 8 warps: 4 along M x 2 along N
constexpr int kWM = 32, kWN = 64;      // warp tile
constexpr int kMT = kWM / 16;          // m16 MMA tiles per warp
constexpr int kNT = kWN / 8;           // n8 MMA tiles per warp

template <typename T>
struct Smem {
  static constexpr int kChunk = 16 / sizeof(T);       // elements per cp.async
  static constexpr int kAStride = kBK + kChunk;       // padded row, elements
  static constexpr int kBStride = kBN + 8;
  static constexpr int kAStage = kBM * kAStride;
  static constexpr int kBStage = kBK * kBStride;
  static constexpr size_t kBytes =
      (size_t)kStages * (kAStage + kBStage) * sizeof(T);
  static_assert((kAStride * sizeof(T)) % 16 == 0, "cp.async alignment");
  static_assert((kBStride * sizeof(T)) % 16 == 0, "cp.async alignment");
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x ~ big + small, both TF32. For bf16 inputs big == x and small == 0.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows row0.. / cols k0.. of the band, and rows k0.. / cols c0.. of
// the weights, into one pipeline stage. Rows past n are zero-filled.
template <typename T>
__device__ __forceinline__ void load_stage(T* As, T* Bs,
                                           const T* __restrict__ in,
                                           const T* __restrict__ wl, int n,
                                           int d, long long row0, int k0,
                                           int c0) {
  using S = Smem<T>;
  constexpr int kC = S::kChunk;
#pragma unroll
  for (int i = 0; i < kBM * kBK / kC / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (kBK / kC);
    const int c = (e - r * (kBK / kC)) * kC;
    const bool valid = row0 + r < n;
    const T* src = in + (valid ? (row0 + r) * d + k0 + c : 0);
    cp_async16(As + r * S::kAStride + c, src, valid);
  }
#pragma unroll
  for (int i = 0; i < kBK * kBN / kC / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int kr = e / (kBN / kC);
    const int c = (e - kr * (kBN / kC)) * kC;
    cp_async16(Bs + kr * S::kBStride + c,
               wl + (long long)(k0 + kr) * d + c0 + c, true);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ b, T* out, T* tmp, T* saved,
                     int n, int d, int n_layers, int last_relu) {
  using S = Smem<T>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kStages * S::kAStage;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // warp grid 4 x 2
  const int g = lane / 4, t = lane % 4;    // MMA fragment coordinates
  const long long row0 = (long long)blockIdx.x * kBM;
  const int ktiles = d / kBK;

  const T* in = x;
  for (int layer = 0; layer < n_layers; ++layer) {
    const T* wl = w + (long long)layer * d * d;
    const T* bl = b + (long long)layer * d;
    const bool relu = layer < n_layers - 1 || last_relu;
    // The last layer lands in out; earlier ones in saved[layer] when the
    // caller keeps them, else alternate backwards between out and tmp.
    T* dst = layer == n_layers - 1 ? out
             : saved != nullptr    ? saved + (long long)layer * n * d
             : ((n_layers - 1 - layer) % 2 == 0) ? out : tmp;
    for (int c0 = 0; c0 < d; c0 += kBN) {
      float acc[kMT][kNT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < ktiles)
          load_stage<T>(As + s * S::kAStage, Bs + s * S::kBStage, in, wl, n,
                        d, row0, s * kBK, c0);
        cp_async_commit();
      }
      for (int kt = 0; kt < ktiles; ++kt) {
        cp_async_wait<kStages - 2>();  // stage kt has landed
        __syncthreads();               // ... and stage kt - 1 is free
        const int nk = kt + kStages - 1;
        if (nk < ktiles) {
          const int s = nk % kStages;
          load_stage<T>(As + s * S::kAStage, Bs + s * S::kBStage, in, wl, n,
                        d, row0, nk * kBK, c0);
        }
        cp_async_commit();
        const T* A = As + (kt % kStages) * S::kAStage;
        const T* B = Bs + (kt % kStages) * S::kBStage;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 8) {
          // A fragment (16 x 8, row-major): rows g, g+8; cols t, t+4.
          uint32_t a_big[kMT][4], a_small[kMT][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const T* ap = A + (wm * kWM + mt * 16 + g) * S::kAStride + kk + t;
            split(to_f(ap[0]), a_big[mt][0], a_small[mt][0]);
            split(to_f(ap[8 * S::kAStride]), a_big[mt][1], a_small[mt][1]);
            split(to_f(ap[4]), a_big[mt][2], a_small[mt][2]);
            split(to_f(ap[8 * S::kAStride + 4]), a_big[mt][3],
                  a_small[mt][3]);
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            // B fragment (8 x 8, col-major): rows t, t+4; col g.
            const T* bp = B + (kk + t) * S::kBStride + wn * kWN + nt * 8 + g;
            uint32_t b0_big, b0_small, b1_big, b1_small;
            split(to_f(bp[0]), b0_big, b0_small);
            split(to_f(bp[4 * S::kBStride]), b1_big, b1_small);
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              if (kSplit) {  // small terms first
                mma(acc[mt][nt], a_big[mt], b0_small, b1_small);
                mma(acc[mt][nt], a_small[mt], b0_big, b1_big);
              }
              mma(acc[mt][nt], a_big[mt], b0_big, b1_big);
            }
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the stages

      // Epilogue. Accumulator fragment: rows g, g+8; cols 2t, 2t+1.
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = c0 + wn * kWN + nt * 8 + 2 * t;
        const float bias0 = to_f(bl[col]), bias1 = to_f(bl[col + 1]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long row = row0 + wm * kWM + mt * 16 + g + 8 * h;
            float v0 = acc[mt][nt][2 * h] + bias0;
            float v1 = acc[mt][nt][2 * h + 1] + bias1;
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            if (row < n) store2(dst + row * d + col, v0, v1);
          }
        }
      }
    }
    __threadfence_block();
    __syncthreads();  // this layer's band is written before the next reads
    in = dst;
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* out,
           void* tmp, void* saved, int n, int d, int n_layers, int last_relu,
           cudaStream_t stream) {
  if (d <= 0 || d % kBN != 0) return (int)cudaErrorInvalidValue;
  if (n_layers > 1 && tmp == nullptr && saved == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<T>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + kBM - 1) / kBM);
  fused_mlp_fwd_kernel<T><<<grid, kThreads, Smem<T>::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), static_cast<T*>(tmp),
      static_cast<T*>(saved), n, d, n_layers, last_relu);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
// f32 only. A GEMM tile C[128 x 128] += A[128 x K] B[K x 128]; each
// operand lies in device memory either way round:
//   A: kATrans false: A[m][k] = a[m * lda + k], staged [kBM][kBK + 4]
//      kATrans true:  A[m][k] = a[k * lda + m], staged [kBK][kBM + 8]
//   B: kBTrans false: B[k][n] = b[k * ldb + n], staged [kBK][kBN + 8]
//      kBTrans true:  B[k][n] = b[n * ldb + k], staged [kBN][kBK + 4]
// The strides put the 32 lanes of every fragment read on 32 banks.
template <bool kATrans, bool kBTrans>
struct BwdSmem {
  static constexpr int kAStride = kATrans ? kBM + 8 : kBK + 4;
  static constexpr int kAStage = (kATrans ? kBK : kBM) * kAStride;
  static constexpr int kBStride = kBTrans ? kBK + 4 : kBN + 8;
  static constexpr int kBStage = (kBTrans ? kBN : kBK) * kBStride;
  static constexpr size_t kBytes =
      (size_t)kStages * (kAStage + kBStage) * sizeof(float);
};

// Stage the A tile at (m0, k0) and the B tile at (k0, n0). A rows at or
// past m_lim (the ragged N of dgrad) and k rows at or past k_lim (the
// ragged N of wgrad, which is its k) are zero-filled.
template <bool kATrans, bool kBTrans>
__device__ __forceinline__ void load_bwd_stage(
    float* As, float* Bs, const float* __restrict__ a, int lda,
    const float* __restrict__ b, int ldb, long long m0, long long n0,
    long long k0, long long m_lim, long long k_lim) {
  using S = BwdSmem<kATrans, kBTrans>;
  constexpr int kC = 4;  // floats per 16-byte copy
#pragma unroll
  for (int i = 0; i < kBM * kBK / kC / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (!kATrans) {
      const int r = e / (kBK / kC), c = (e % (kBK / kC)) * kC;
      const bool valid = m0 + r < m_lim;
      const float* src = a + (valid ? (m0 + r) * lda + k0 + c : 0);
      cp_async16(As + r * S::kAStride + c, src, valid);
    } else {
      const int r = e / (kBM / kC), c = (e % (kBM / kC)) * kC;
      const bool valid = k0 + r < k_lim;
      const float* src = a + (valid ? (k0 + r) * lda + m0 + c : 0);
      cp_async16(As + r * S::kAStride + c, src, valid);
    }
  }
#pragma unroll
  for (int i = 0; i < kBK * kBN / kC / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (!kBTrans) {
      const int r = e / (kBN / kC), c = (e % (kBN / kC)) * kC;
      const bool valid = k0 + r < k_lim;
      const float* src = b + (valid ? (k0 + r) * ldb + n0 + c : 0);
      cp_async16(Bs + r * S::kBStride + c, src, valid);
    } else {
      const int r = e / (kBK / kC), c = (e % (kBK / kC)) * kC;
      cp_async16(Bs + r * S::kBStride + c, b + (n0 + r) * ldb + k0 + c,
                 true);
    }
  }
}

// acc = A[m0.., k_begin..k_end) B[k_begin..k_end), n0..] over one 128 x
// 128 tile, 3xTF32. With col_sum non-null (kBTrans false only), threads
// 0..127 also add up column threadIdx.x of B over the k range, in order.
template <bool kATrans, bool kBTrans>
__device__ __forceinline__ void bwd_mainloop(
    float (&acc)[kMT][kNT][4], float* As, float* Bs,
    const float* __restrict__ a, int lda, const float* __restrict__ b,
    int ldb, long long m0, long long n0, long long k_begin, long long k_end,
    long long m_lim, float* col_sum) {
  using S = BwdSmem<kATrans, kBTrans>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  const int ktiles = (int)((k_end - k_begin + kBK - 1) / kBK);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles)
      load_bwd_stage<kATrans, kBTrans>(As + s * S::kAStage,
                                       Bs + s * S::kBStage, a, lda, b, ldb,
                                       m0, n0, k_begin + s * kBK, m_lim,
                                       k_end);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < ktiles) {
      const int s = nk % kStages;
      load_bwd_stage<kATrans, kBTrans>(As + s * S::kAStage,
                                       Bs + s * S::kBStage, a, lda, b, ldb,
                                       m0, n0, k_begin + (long long)nk * kBK,
                                       m_lim, k_end);
    }
    cp_async_commit();
    const float* A = As + (kt % kStages) * S::kAStage;
    const float* B = Bs + (kt % kStages) * S::kBStage;
    if (!kBTrans && col_sum != nullptr && threadIdx.x < kBN) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < kBK; ++r) s += B[r * S::kBStride + threadIdx.x];
      *col_sum += s;
    }
    auto a_at = [&](int m, int k) {
      return kATrans ? A[k * S::kAStride + m] : A[m * S::kAStride + k];
    };
    auto b_at = [&](int k, int n) {
      return kBTrans ? B[n * S::kBStride + k] : B[k * S::kBStride + n];
    };
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t a_big[kMT][4], a_small[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int m = wm * kWM + mt * 16 + g;
        split(a_at(m, kk + t), a_big[mt][0], a_small[mt][0]);
        split(a_at(m + 8, kk + t), a_big[mt][1], a_small[mt][1]);
        split(a_at(m, kk + t + 4), a_big[mt][2], a_small[mt][2]);
        split(a_at(m + 8, kk + t + 4), a_big[mt][3], a_small[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int n = wn * kWN + nt * 8 + g;
        uint32_t b0_big, b0_small, b1_big, b1_small;
        split(b_at(kk + t, n), b0_big, b0_small);
        split(b_at(kk + t + 4, n), b1_big, b1_small);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(acc[mt][nt], a_big[mt], b0_small, b1_small);
          mma(acc[mt][nt], a_small[mt], b0_big, b1_big);
          mma(acc[mt][nt], a_big[mt], b0_big, b1_big);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages
}

// out[r][c] = sum_j dz[r][j] w[c][j] (w is the layer's [in, out] weight),
// times (mask[r][c] > 0) when mask is non-null. dz, mask, out: [n, d].
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_bwd_dgrad_kernel(const float* __restrict__ dz,
                           const float* __restrict__ w,
                           const float* __restrict__ mask, float* out, int n,
                           int d) {
  using S = BwdSmem<false, true>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + kStages * S::kAStage;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, t = lane % 4;
  const long long row0 = (long long)blockIdx.x * kBM;
  for (int c0 = 0; c0 < d; c0 += kBN) {
    float acc[kMT][kNT][4];
    bwd_mainloop<false, true>(acc, As, Bs, dz, d, w, d, row0, c0, 0, d, n,
                              nullptr);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = c0 + wn * kWN + nt * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + wm * kWM + mt * 16 + g + 8 * h;
          if (row >= n) continue;
          float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
          if (mask != nullptr) {
            const float2 m =
                *reinterpret_cast<const float2*>(mask + row * d + col);
            v0 *= m.x > 0.f ? 1.f : 0.f;
            v1 *= m.y > 0.f ? 1.f : 0.f;
          }
          store2(out + row * d + col, v0, v1);
        }
      }
    }
  }
}

// Split s of N: part_w[s][r][c] = sum over its rows k of act[k][r] dz[k][c]
// and, from the blocks of the first tile row, part_b[s][c] = sum of
// dz[k][c]. Split s covers rows [s * rows_per_split, + rows_per_split).
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_bwd_wgrad_kernel(const float* __restrict__ act,
                           const float* __restrict__ dz, float* part_w,
                           float* part_b, int n, int d, int rows_per_split) {
  using S = BwdSmem<true, false>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + kStages * S::kAStage;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int g = lane / 4, t = lane % 4;
  const long long c0 = (long long)blockIdx.x * kBN;
  const long long r0 = (long long)blockIdx.y * kBM;
  const long long k_begin = (long long)blockIdx.z * rows_per_split;
  const long long k_end = k_begin + rows_per_split < n
                              ? k_begin + rows_per_split : (long long)n;
  float col_sum = 0.f;
  float acc[kMT][kNT][4];
  bwd_mainloop<true, false>(acc, As, Bs, act, d, dz, d, r0, c0, k_begin,
                            k_end, d, blockIdx.y == 0 ? &col_sum : nullptr);
  float* pw = part_w + (long long)blockIdx.z * d * d;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const long long col = c0 + wn * kWN + nt * 8 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + wm * kWM + mt * 16 + g + 8 * h;
        store2(pw + row * d + col, acc[mt][nt][2 * h],
               acc[mt][nt][2 * h + 1]);
      }
    }
  }
  if (blockIdx.y == 0 && threadIdx.x < kBN)
    part_b[(long long)blockIdx.z * d + c0 + threadIdx.x] = col_sum;
}

// dw[e] = sum over s, in order, of part_w[s][e]; db likewise from part_b.
__global__ void fused_mlp_bwd_reduce_kernel(const float* __restrict__ part_w,
                                            const float* __restrict__ part_b,
                                            float* dw, float* db, int d,
                                            int splits) {
  const long long dd = (long long)d * d;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < dd + d; e += (long long)gridDim.x * blockDim.x) {
    const float* src = e < dd ? part_w + e : part_b + (e - dd);
    const long long stride = e < dd ? dd : d;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += src[k * stride];
    if (e < dd)
      dw[e] = s;
    else
      db[e - dd] = s;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x [n, d], w [n_layers, d, d]
// ([in, out]), b [n_layers, d], out [n, d] and, when n_layers > 1, either
// the scratch tmp [n, d] or saved [n_layers - 1, n, d], which then keeps
// every layer's output but the last (tmp is not used): contiguous,
// 16-byte aligned, on `device`; d a multiple of 128; out, tmp and saved
// distinct from x and each other. Launches on `stream` without
// synchronising; returns the cudaError_t of the launch (0 = launched).
int snerf_fused_mlp_fwd(const void* x, const void* w, const void* b,
                        void* out, void* tmp, void* saved, int n, int d,
                        int n_layers, int last_relu, int dtype, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, b, out, tmp, saved, n, d, n_layers,
                         last_relu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, out, tmp, saved, n, d, n_layers,
                                 last_relu, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's three kernels, float32 only; every array contiguous,
// 16-byte aligned, on `device`; d a multiple of 128; each launches on
// `stream` without synchronising and returns the cudaError_t of the
// launch.
//
// dgrad: out [n, d] = (dz [n, d] w^T) * (mask [n, d] > 0), w [d, d]
// ([in, out]); mask may be null (no mask). out distinct from dz.
int snerf_fused_mlp_bwd_dgrad(const void* dz, const void* w,
                              const void* mask, void* out, int n, int d,
                              int device, void* stream) {
  if (d <= 0 || d % kBN != 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = set_smem(fused_mlp_bwd_dgrad_kernel, BwdSmem<false, true>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + kBM - 1) / kBM);
  fused_mlp_bwd_dgrad_kernel<<<grid, kThreads, BwdSmem<false, true>::kBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dz), static_cast<const float*>(w),
      static_cast<const float*>(mask), static_cast<float*>(out), n, d);
  return (int)cudaGetLastError();
}

// wgrad: the partials of dW = act^T dz and db = colsum(dz) over `splits`
// runs of rows_per_split rows (a multiple of 32, splits * rows_per_split
// >= n): act, dz [n, d]; part_w [splits, d, d]; part_b [splits, d].
int snerf_fused_mlp_bwd_wgrad(const void* act, const void* dz, void* part_w,
                              void* part_b, int n, int d, int rows_per_split,
                              int splits, int device, void* stream) {
  if (d <= 0 || d % kBN != 0 || n <= 0 || rows_per_split <= 0 ||
      rows_per_split % kBK != 0 || splits <= 0 || splits > 65535 ||
      (long long)splits * rows_per_split < n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = set_smem(fused_mlp_bwd_wgrad_kernel, BwdSmem<true, false>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d / kBN, d / kBM, splits);
  fused_mlp_bwd_wgrad_kernel<<<grid, kThreads, BwdSmem<true, false>::kBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(act), static_cast<const float*>(dz),
      static_cast<float*>(part_w), static_cast<float*>(part_b), n, d,
      rows_per_split);
  return (int)cudaGetLastError();
}

// reduce: dw [d, d] and db [d] = the sums over s of part_w[s], part_b[s].
int snerf_fused_mlp_bwd_reduce(const void* part_w, const void* part_b,
                               void* dw, void* db, int d, int splits,
                               int device, void* stream) {
  if (d <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)d * d + d;
  const unsigned grid = (unsigned)((total + 255) / 256);
  fused_mlp_bwd_reduce_kernel<<<grid, 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_w), static_cast<const float*>(part_b),
      static_cast<float*>(dw), static_cast<float*>(db), d, splits);
  return (int)cudaGetLastError();
}

const char* snerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
