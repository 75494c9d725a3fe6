// Fused uniform-width ReLU MLP, forward only, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel snerf_tpu/ops/pallas/fused_mlp.py
// (`fused_mlp` -> `_fwd` -> `_fwd_kernel`). It computes, for L layers,
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
                     const T* __restrict__ b, T* out, T* tmp, int n, int d,
                     int n_layers, int last_relu) {
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
    // The last layer lands in out; earlier ones alternate backwards.
    T* dst = ((n_layers - 1 - layer) % 2 == 0) ? out : tmp;
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
           void* tmp, int n, int d, int n_layers, int last_relu,
           cudaStream_t stream) {
  if (d <= 0 || d % kBN != 0) return (int)cudaErrorInvalidValue;
  if (n_layers > 1 && tmp == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<T>::kBytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + kBM - 1) / kBM);
  fused_mlp_fwd_kernel<T><<<grid, kThreads, Smem<T>::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), static_cast<T*>(tmp),
      n, d, n_layers, last_relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x [n, d], w [n_layers, d, d]
// ([in, out]), b [n_layers, d], out [n, d] and, when n_layers > 1, the
// scratch tmp [n, d]: contiguous, 16-byte aligned, on `device`; d a
// multiple of 128; out and tmp distinct from x and each other. Launches
// on `stream` without synchronising; returns the cudaError_t of the
// launch (0 = launched).
int snerf_fused_mlp_fwd(const void* x, const void* w, const void* b,
                        void* out, void* tmp, int n, int d, int n_layers,
                        int last_relu, int dtype, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, b, out, tmp, n, d, n_layers, last_relu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, out, tmp, n, d, n_layers,
                                 last_relu, s);
  return (int)cudaErrorInvalidValue;
}

const char* snerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
