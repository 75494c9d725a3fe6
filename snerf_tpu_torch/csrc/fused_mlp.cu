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
// dropped term is ~2^-22 relative), 165 TFLOP/s of f32 work at the
// card's 495 TFLOP/s of TF32. bf16 operands are exact in TF32 and take
// one MMA. The tensor cores' f32 accumulation truncates, so an output
// drifts ~3e-5 from an IEEE f32 sum at D = 1024, L = 4.
//
// f32 forward and dgrad (the hot path): warpgroup MMAs fed by TMA.
//   Only wgmma reaches Hopper's TF32 rate (mma.sync, the first design,
//   ran at ~50 TFLOP/s of f32 work), and for .tf32 wgmma reads both
//   operands K-major only. A block owns a band of kHBM = 128 rows and
//   sweeps the output in kHBN = 128-column tiles, K in kHBK = 32 floats
//   (one 128-byte swizzle row) a stage. One producer warp issues TMA
//   loads (cp.async.bulk.tensor, 128-byte swizzle) of the [128, 32] A
//   tile and the two [128, 32] B tiles (big and small) into a 4-stage
//   ring of mbarrier-tracked stages; TMA zero-fills rows past N. Two
//   consumer warpgroups (64 rows each) run wgmma m64n128k8 f32.tf32.
//   * The weights are split once per call (`tf32_split_kernel` below):
//     big = cvt.rna.tf32(w), small = cvt.rna.tf32(w - big). B is then
//     read from shared memory as it lies; before, each B element was split
//     again by every warp along M.
//   * A is split in registers by the warpgroup that uses it (the RS form:
//     A from registers, B from shared memory): each A fragment then serves
//     all 128 columns of the tile, so the split costs ~3 ALU ops per 384
//     tensor-core MACs. The SS form with A split beforehand would move
//     A's bytes through HBM twice more (~1.2 ms a 520k x 1024 layer) and
//     double A's shared-memory stage. The order is the small terms first:
//     a_big * b_small, a_small * b_big, a_big * b_big.
//   * A fragments for two stages stay live (register double-buffering):
//     a stage's wgmmas are committed as one group, and wgmma.wait_group 1
//     retires the previous stage's group before its stage is released to
//     the producer and its registers are refilled.
//   * Why 128 x 128 tiles: a stage holds three 16 KB tiles, so 4 stages
//     fit in 227 KB (a 256-column tile would be 80 KB a stage, 2 stages);
//     the 64-float accumulator leaves room for the two A fragment sets
//     (64 registers) under setmaxnreg 232 without spills. D = 256 (the
//     proposal trunk) is two column tiles; every D that is a multiple of
//     128 works.
//   * Forward: the weights are split transposed, [L, out, in], since W is
//     stored [in, out] and B(k = in, n = out) must be K-major. As before,
//     a block keeps its band through all L layers and writes each layer
//     to device memory (the last to `out`, earlier ones to saved[i] when
//     the caller keeps them, else alternating backwards between `out` and
//     the scratch `tmp`), so a call is one launch and the keep-layers
//     forward is bit-equal to the eval forward. The next layer reads the
//     band back by TMA: the consumers' stores are fenced into the async
//     proxy (fence.proxy.async.global) and a named barrier holds the
//     producer until the layer is written. Epilogue: bias, ReLU (not on
//     the last layer when last_relu is 0), store.
//   * dgrad: dz_{i-1} = (dz_i W_i^T) * (act_i > 0). A = dz [N, out] is
//     K-major; B(k = out, n = in) = W[in][out] already lies K-major, so
//     the split is not transposed. The ReLU mask of the layer below is
//     applied in the epilogue; no split-K, no atomics: two backward runs
//     are bit-identical.
//   TMA descriptors are encoded on the host per call
//   (cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint so the
//   library does not link libcuda) and passed as __grid_constant__.
//
// The bf16 forward keeps the first design: a 128-row band through all
// layers, a 3-stage cp.async ring of 128 x 32 activation and 32 x 128
// weight tiles, 8 warps of mma.sync m16n8k8 TF32, one MMA a product.
//
// Backward, per layer i from the last (act_0 = x, act_{i+1} = layer i's
// output, dz_i = dL/d(pre-activation of layer i), all f32):
//   dgrad: dz_{i-1} = (dz_i W_i^T) * (act_i > 0), or dx = dz_0 W_0^T,
//          on the wgmma mainloop above;
//   wgrad: dW_i = act_i^T dz_i, db_i = sum over rows of dz_i.
// wgrad reduces over N, the row index of both stored operands, so both
// are MN-major, which TF32 wgmma does not take; it stays on mma.sync
// 3xTF32 with a 3-stage cp.async ring and 128 x 128 block tiles, the
// operands staged so the fragment reads are bank-conflict free (act^T
// staged [k][m]). It reduces over N (~5e5 rows) into only (D/128)^2
// output tiles, so N is split across blocks (the caller picks the split;
// the truncating tensor-core accumulator drifts with the rows a split
// sums, ~1.7e-5 of max|dW| at 2,048 rows): each writes an f32 partial
// tile (and, in the first tile row, the column sums of dz for db), and a
// second kernel sums the partials in split order. No atomics: two
// identical steps give bit-identical grads. The ReLU mask of the last
// layer (when last_relu) is an elementwise pass in the wrapper.

#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;     // rows per block (the band)
constexpr int kBN = 128;     // columns per output tile
constexpr int kBK = 32;      // k-depth of one pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;          // 8 warps: 4 along M x 2 along N
constexpr int kWM = 32, kWN = 64;      // warp tile
constexpr int kMT = kWM / 16;          // m16 MMA tiles per warp
constexpr int kNT = kWN / 8;           // n8 MMA tiles per warp

using bf16 = __nv_bfloat16;

// The bf16 forward's stages: activation rows padded so the fragment reads
// are bank-conflict free.
struct Bf16Smem {
  static constexpr int kChunk = 8;                    // elements per cp.async
  static constexpr int kAStride = kBK + kChunk;       // padded row, elements
  static constexpr int kBStride = kBN + 8;
  static constexpr int kAStage = kBM * kAStride;
  static constexpr int kBStage = kBK * kBStride;
  static constexpr size_t kBytes =
      (size_t)kStages * (kAStage + kBStage) * sizeof(bf16);
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
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
// x ~ big + small, both TF32.
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

// ------------------------------------------------------- bf16 forward
// Stage rows row0.. / cols k0.. of the band, and rows k0.. / cols c0.. of
// the weights, into one pipeline stage. Rows past n are zero-filled.
__device__ __forceinline__ void load_stage(bf16* As, bf16* Bs,
                                           const bf16* __restrict__ in,
                                           const bf16* __restrict__ wl,
                                           int n, int d, long long row0,
                                           int k0, int c0) {
  using S = Bf16Smem;
  constexpr int kC = S::kChunk;
#pragma unroll
  for (int i = 0; i < kBM * kBK / kC / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (kBK / kC);
    const int c = (e - r * (kBK / kC)) * kC;
    const bool valid = row0 + r < n;
    const bf16* src = in + (valid ? (row0 + r) * d + k0 + c : 0);
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

__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_fwd_bf16_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ w,
                          const bf16* __restrict__ b, bf16* out, bf16* tmp,
                          int n, int d, int n_layers, int last_relu) {
  using S = Bf16Smem;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kStages * S::kAStage;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // warp grid 4 x 2
  const int g = lane / 4, t = lane % 4;    // MMA fragment coordinates
  const long long row0 = (long long)blockIdx.x * kBM;
  const int ktiles = d / kBK;

  const bf16* in = x;
  for (int layer = 0; layer < n_layers; ++layer) {
    const bf16* wl = w + (long long)layer * d * d;
    const bf16* bl = b + (long long)layer * d;
    const bool relu = layer < n_layers - 1 || last_relu;
    // The last layer lands in out; earlier ones alternate backwards
    // between out and tmp.
    bf16* dst = ((n_layers - 1 - layer) % 2 == 0) ? out : tmp;
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
          load_stage(As + s * S::kAStage, Bs + s * S::kBStage, in, wl, n, d,
                     row0, s * kBK, c0);
        cp_async_commit();
      }
      for (int kt = 0; kt < ktiles; ++kt) {
        cp_async_wait<kStages - 2>();  // stage kt has landed
        __syncthreads();               // ... and stage kt - 1 is free
        const int nk = kt + kStages - 1;
        if (nk < ktiles) {
          const int s = nk % kStages;
          load_stage(As + s * S::kAStage, Bs + s * S::kBStage, in, wl, n, d,
                     row0, nk * kBK, c0);
        }
        cp_async_commit();
        const bf16* A = As + (kt % kStages) * S::kAStage;
        const bf16* B = Bs + (kt % kStages) * S::kBStage;
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 8) {
          // A fragment (16 x 8, row-major): rows g, g+8; cols t, t+4. A
          // bf16 value is exact in TF32: one MMA a product.
          uint32_t a[kMT][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const bf16* ap =
                A + (wm * kWM + mt * 16 + g) * S::kAStride + kk + t;
            a[mt][0] = __float_as_uint(__bfloat162float(ap[0]));
            a[mt][1] = __float_as_uint(__bfloat162float(ap[8 * S::kAStride]));
            a[mt][2] = __float_as_uint(__bfloat162float(ap[4]));
            a[mt][3] =
                __float_as_uint(__bfloat162float(ap[8 * S::kAStride + 4]));
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            // B fragment (8 x 8, col-major): rows t, t+4; col g.
            const bf16* bp =
                B + (kk + t) * S::kBStride + wn * kWN + nt * 8 + g;
            const uint32_t b0 = __float_as_uint(__bfloat162float(bp[0]));
            const uint32_t b1 =
                __float_as_uint(__bfloat162float(bp[4 * S::kBStride]));
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) mma(acc[mt][nt], a[mt], b0, b1);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the stages

      // Epilogue. Accumulator fragment: rows g, g+8; cols 2t, 2t+1.
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = c0 + wn * kWN + nt * 8 + 2 * t;
        const float bias0 = __bfloat162float(bl[col]);
        const float bias1 = __bfloat162float(bl[col + 1]);
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

// -------------------------------------------- f32 forward and dgrad (wgmma)
constexpr int kHBM = 128;     // rows per block: two consumer warpgroups
constexpr int kHBN = 128;     // columns per output tile (the wgmma's n)
constexpr int kHBK = 32;      // f32 k-depth of a stage: 128 bytes a row
constexpr int kHStages = 4;
constexpr int kHThreads = 384;  // warpgroups 0, 1 consume; 2 produces
constexpr int kProducerThreads = 32;  // the one producer warp that works
constexpr uint32_t kTileBytes = kHBM * kHBK * 4;  // A, B big, B small: 16 KB
constexpr uint32_t kStageBytes = 3 * kTileBytes;
constexpr size_t kHSmem = (size_t)kHStages * kStageBytes +
                          2 * kHStages * sizeof(uint64_t) + 1024;
constexpr int kLayerBarrier = 1;  // named barrier: consumers + producer
static_assert(kHBM == kHBN, "A and B tiles share one TMA box");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// One [kHBK, 128, 1] box at (c0, c1, c2) of a 3-D map into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Orders this thread's generic-proxy global accesses with later TMA ones.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep registers that an in-flight wgmma reads or writes where they are:
// the compiler may not move, reuse or read them across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
// The shared-memory descriptor of a K-major [rows, 32] f32 tile written by
// TMA with the 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), the
// leading offset unused for a swizzled K-major tile, layout SWIZZLE_128B.
// The tile is 1024-byte aligned; +2 per 8-deep k step (32 bytes).
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}
// d[64] (a 64 x 128 f32 tile) += A (64 x 8 tf32, registers) B (8 x 128
// tf32, shared memory through desc).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Where layer `layer` of the forward writes: 0 = out, 1 = tmp, 2 =
// saved[layer]. The last layer lands in out; earlier ones in saved when
// the caller keeps them, else alternate backwards between out and tmp.
__device__ __forceinline__ int dst_kind(int layer, int n_layers,
                                        bool keep) {
  if (layer == n_layers - 1) return 0;
  if (keep) return 2;
  return (n_layers - 1 - layer) % 2 == 0 ? 0 : 1;
}

struct Ring {
  unsigned char* base;  // 1024-byte aligned
  uint64_t* full;
  uint64_t* empty;
  __device__ float* a(int s) const {
    return reinterpret_cast<float*>(base + s * kStageBytes);
  }
  __device__ float* b_big(int s) const {
    return reinterpret_cast<float*>(base + s * kStageBytes + kTileBytes);
  }
  __device__ float* b_small(int s) const {
    return reinterpret_cast<float*>(base + s * kStageBytes + 2 * kTileBytes);
  }
};

// One stage of a consumer warpgroup: load its 64 x 32 A slice from the
// swizzled stage, split it into (ab[kBuf], as[kBuf]), issue 3 x 4 wgmmas
// on the stage's B tiles as one group, then retire the previous stage's
// group and release that stage. `first`: no previous stage of this tile.
template <int kBuf>
__device__ __forceinline__ void consume_stage(
    const Ring& ring, float (&acc)[64], uint32_t (&ab)[2][4][4],
    uint32_t (&as)[2][4][4], int& it, bool first, int r_lo, int g, int t,
    int lane) {
  const int s = it % kHStages;
  mbar_wait(&ring.full[s], (it / kHStages) & 1);
  const float* A = ring.a(s);
  // A fragment of k step kk: (r, 8kk + t), (r + 8, ..), (r, 8kk + t + 4),
  // (r + 8, ..); in the 128-byte swizzle a row's 16-byte chunk c sits at
  // c ^ (r % 8), and r % 8 == g.
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c_lo = (((2 * kk) ^ g) << 2) + t;
    const int c_hi = (((2 * kk + 1) ^ g) << 2) + t;
    split(A[r_lo * kHBK + c_lo], ab[kBuf][kk][0], as[kBuf][kk][0]);
    split(A[(r_lo + 8) * kHBK + c_lo], ab[kBuf][kk][1], as[kBuf][kk][1]);
    split(A[r_lo * kHBK + c_hi], ab[kBuf][kk][2], as[kBuf][kk][2]);
    split(A[(r_lo + 8) * kHBK + c_hi], ab[kBuf][kk][3], as[kBuf][kk][3]);
  }
  const uint64_t db = smem_desc(ring.b_big(s));
  const uint64_t ds = smem_desc(ring.b_small(s));
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // small terms first
    wgmma_tf32(acc, ab[kBuf][kk], ds + 2 * kk);
    wgmma_tf32(acc, as[kBuf][kk], db + 2 * kk);
    wgmma_tf32(acc, ab[kBuf][kk], db + 2 * kk);
  }
  wgmma_commit();
  fence_regs(acc);
  wgmma_wait<1>();  // the previous stage's group is done
  fence_regs(ab[kBuf ^ 1]);
  fence_regs(as[kBuf ^ 1]);
  if (!first && lane == 0)
    mbar_arrive(&ring.empty[(it + kHStages - 1) % kHStages]);
  ++it;
}

// f32 forward (kDgrad false) or dgrad (kDgrad true) on a 128-row band;
// see the note at the top. Forward: tm_in[0] = x, tm_in[1] = out,
// tm_in[2] = tmp, tm_in[3] = saved (one slab a layer); tm_wb / tm_ws the
// transposed split weights [L, out, in]; vec = the biases [L, d]. dgrad:
// tm_in[0] = dz, tm_wb / tm_ws the layer's split W [in, out] (one slab);
// vec = the mask (null: none); n_layers = 1, so the band never reads a
// layer back: tm_out, tm_tmp, tm_saved, tmp, saved and last_relu go
// unread (zero maps and nulls), the price of one mainloop, producer and
// epilogue for both.
template <bool kDgrad>
__global__ void __launch_bounds__(kHThreads, 1)
k1_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_out,
                const __grid_constant__ CUtensorMap tm_tmp,
                const __grid_constant__ CUtensorMap tm_saved,
                const __grid_constant__ CUtensorMap tm_wb,
                const __grid_constant__ CUtensorMap tm_ws,
                const float* __restrict__ vec, float* out, float* tmp,
                float* saved, int n, int d, int n_layers, int last_relu) {
  extern __shared__ unsigned char smem_raw[];
  Ring ring;
  ring.base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  ring.full = reinterpret_cast<uint64_t*>(ring.base + kHStages * kStageBytes);
  ring.empty = ring.full + kHStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int row0 = blockIdx.x * kHBM;
  const int ktiles = d / kHBK;
  const bool keep = saved != nullptr;

  if (wg == 2) {
    // ---- producer: one warp, lane 0 issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 8) return;
    int it = 0;
    for (int layer = 0; layer < n_layers; ++layer) {
      const CUtensorMap* tin = &tm_x;
      int slab = 0;
      if (layer > 0) {
        // wait until the consumers have written the previous layer
        named_barrier_sync(kLayerBarrier, 2 * 128 + kProducerThreads);
        fence_proxy_async_global();
        const int k = dst_kind(layer - 1, n_layers, keep);
        tin = k == 0 ? &tm_out : k == 1 ? &tm_tmp : &tm_saved;
        slab = k == 2 ? layer - 1 : 0;
      }
      for (int c0 = 0; c0 < d; c0 += kHBN) {
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % kHStages;
          mbar_wait(&ring.empty[s], ((it / kHStages) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(&ring.full[s], kStageBytes);
            tma_load(ring.a(s), tin, &ring.full[s], kt * kHBK, row0, slab);
            tma_load(ring.b_big(s), &tm_wb, &ring.full[s], kt * kHBK, c0,
                     layer);
            tma_load(ring.b_small(s), &tm_ws, &ring.full[s], kt * kHBK, c0,
                     layer);
          }
          __syncwarp();
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = lane / 4, t = lane % 4;
    const int r_lo = wg * 64 + (warp % 4) * 16 + g;  // row in the band
    float acc[64];
    uint32_t ab[2][4][4] = {}, as[2][4][4] = {};
    int it = 0;
    for (int layer = 0; layer < n_layers; ++layer) {
      const bool relu = layer < n_layers - 1 || last_relu;
      const int k = dst_kind(layer, n_layers, keep);
      float* dst = kDgrad ? out
                   : k == 0 ? out
                   : k == 1 ? tmp
                            : saved + (long long)layer * n * d;
      for (int c0 = 0; c0 < d; c0 += kHBN) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        for (int kt = 0; kt < ktiles; kt += 2) {
          consume_stage<0>(ring, acc, ab, as, it, kt == 0, r_lo, g, t, lane);
          consume_stage<1>(ring, acc, ab, as, it, false, r_lo, g, t, lane);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(ab[1]);
        fence_regs(as[1]);
        if (lane == 0)
          mbar_arrive(&ring.empty[(it + kHStages - 1) % kHStages]);

        // Epilogue. Accumulator fragment of n8 block j: rows r, r + 8;
        // cols 8j + 2t, 8j + 2t + 1 (d[4j + 2h + e]).
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = c0 + 8 * j + 2 * t;
          float2 bias = make_float2(0.f, 0.f);
          if (!kDgrad) bias = *reinterpret_cast<const float2*>(
                           vec + (long long)layer * d + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long row = (long long)row0 + r_lo + 8 * h;
            if (row >= n) continue;
            float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            if (kDgrad) {
              if (vec != nullptr) {
                const float2 m =
                    *reinterpret_cast<const float2*>(vec + row * d + col);
                v0 *= m.x > 0.f ? 1.f : 0.f;
                v1 *= m.y > 0.f ? 1.f : 0.f;
              }
            } else {
              v0 += bias.x;
              v1 += bias.y;
              if (relu) {
                v0 = fmaxf(v0, 0.f);
                v1 = fmaxf(v1, 0.f);
              }
            }
            store2(dst + row * d + col, v0, v1);
          }
        }
      }
      if (layer < n_layers - 1) {
        // the next layer reads this band back through TMA
        fence_proxy_async_global();
        named_barrier_sync(kLayerBarrier, 2 * 128 + kProducerThreads);
      }
    }
  }
}

// big = cvt.rna.tf32(w), small = cvt.rna.tf32(w - big) for w [L, d, d];
// (big_t, small_t) are transposed per layer, [l][j][i] = [l][i][j];
// (big, small) keep w's layout and may be null. A 32 x 32 tile a block,
// transposed through shared memory so both writes are coalesced.
__global__ void tf32_split_kernel(const float* __restrict__ w, float* big,
                                  float* small, float* big_t, float* small_t,
                                  int d) {
  __shared__ float tb[32][33], ts[32][33];
  const long long base = (long long)blockIdx.z * d * d;
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const long long e = base + (long long)(i0 + r) * d + j0 + threadIdx.x;
    const float v = w[e];
    const float vb = __uint_as_float(to_tf32(v));
    const float vs = __uint_as_float(to_tf32(v - vb));
    if (big != nullptr) {
      big[e] = vb;
      small[e] = vs;
    }
    tb[r][threadIdx.x] = vb;
    ts[r][threadIdx.x] = vs;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const long long e = base + (long long)(j0 + r) * d + i0 + threadIdx.x;
    big_t[e] = tb[threadIdx.x][r];
    small_t[e] = ts[threadIdx.x][r];
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map over `slabs` row-major [rows, d] f32 slabs at ptr, boxes of
// [128 rows, kHBK floats] with the 128-byte swizzle; rows past `rows` of a
// slab read as zeros.
cudaError_t encode(CUtensorMap* map, const void* ptr, int d, long long rows,
                   int slabs) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4,
                                 (cuuint64_t)d * 4 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {kHBK, kHBM, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool kDgrad>
int launch_wgmma(const void* in, const void* wb, const void* ws,
                 const void* vec, void* out, void* tmp, void* saved, int n,
                 int d, int n_layers, int last_relu, cudaStream_t stream) {
  if (n <= 0 || d <= 0 || d % kHBN != 0 || n_layers <= 0)
    return (int)cudaErrorInvalidValue;
  if (!kDgrad && n_layers > 1 && tmp == nullptr && saved == nullptr)
    return (int)cudaErrorInvalidValue;
  // dgrad (one layer) reads only tm[0], tm[4] and tm[5]; the forward's
  // maps of the layers it reads back stay zero there.
  CUtensorMap tm[6] = {};
  const int w_slabs = kDgrad ? 1 : n_layers;
  cudaError_t err = encode(&tm[0], in, d, n, 1);
  if (!kDgrad) {
    if (err == cudaSuccess) err = encode(&tm[1], out, d, n, 1);
    if (err == cudaSuccess)
      err = encode(&tm[2], tmp != nullptr ? tmp : out, d, n, 1);
    if (err == cudaSuccess)
      err = encode(&tm[3], saved != nullptr ? saved : out, d, n,
                   saved != nullptr ? n_layers - 1 : 1);
  }
  if (err == cudaSuccess) err = encode(&tm[4], wb, d, d, w_slabs);
  if (err == cudaSuccess) err = encode(&tm[5], ws, d, d, w_slabs);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k1_wgmma_kernel<kDgrad>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kHSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + kHBM - 1) / kHBM);
  k1_wgmma_kernel<kDgrad><<<grid, kHThreads, kHSmem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], tm[5],
      static_cast<const float*>(vec), static_cast<float*>(out),
      static_cast<float*>(tmp), static_cast<float*>(saved), n, d, n_layers,
      last_relu);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- wgrad
// f32 only. A GEMM tile C[128 x 128] += A[128 x K] B[K x 128] with both
// operands K-outer in device memory, as wgrad has them (K = N rows):
//   A[m][k] = act[k * d + m], staged [kBK][kBM + 8];
//   B[k][n] = dz[k * d + n],  staged [kBK][kBN + 8].
// The strides put the 32 lanes of every fragment read on 32 banks.
struct WgradSmem {
  static constexpr int kAStride = kBM + 8;
  static constexpr int kAStage = kBK * kAStride;
  static constexpr int kBStride = kBN + 8;
  static constexpr int kBStage = kBK * kBStride;
  static constexpr size_t kBytes =
      (size_t)kStages * (kAStage + kBStage) * sizeof(float);
};

// Stage the A tile at (m0, k0) and the B tile at (k0, n0). k rows at or
// past k_lim (the ragged N) are zero-filled.
__device__ __forceinline__ void load_wgrad_stage(
    float* As, float* Bs, const float* __restrict__ a,
    const float* __restrict__ b, int d, long long m0, long long n0,
    long long k0, long long k_lim) {
  using S = WgradSmem;
  constexpr int kC = 4;  // floats per 16-byte copy
#pragma unroll
  for (int i = 0; i < kBM * kBK / kC / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (kBM / kC), c = (e % (kBM / kC)) * kC;
    const bool valid = k0 + r < k_lim;
    const float* src = a + (valid ? (k0 + r) * d + m0 + c : 0);
    cp_async16(As + r * S::kAStride + c, src, valid);
  }
#pragma unroll
  for (int i = 0; i < kBK * kBN / kC / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / (kBN / kC), c = (e % (kBN / kC)) * kC;
    const bool valid = k0 + r < k_lim;
    const float* src = b + (valid ? (k0 + r) * d + n0 + c : 0);
    cp_async16(Bs + r * S::kBStride + c, src, valid);
  }
}

// acc = A[m0.., k_begin..k_end) B[k_begin..k_end), n0..] over one 128 x
// 128 tile, 3xTF32. With col_sum non-null, threads 0..127 also add up
// column threadIdx.x of B over the k range, in order.
__device__ __forceinline__ void wgrad_mainloop(
    float (&acc)[kMT][kNT][4], float* As, float* Bs,
    const float* __restrict__ a, const float* __restrict__ b, int d,
    long long m0, long long n0, long long k_begin, long long k_end,
    float* col_sum) {
  using S = WgradSmem;
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
      load_wgrad_stage(As + s * S::kAStage, Bs + s * S::kBStage, a, b, d,
                       m0, n0, k_begin + s * kBK, k_end);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nk = kt + kStages - 1;
    if (nk < ktiles) {
      const int s = nk % kStages;
      load_wgrad_stage(As + s * S::kAStage, Bs + s * S::kBStage, a, b, d,
                       m0, n0, k_begin + (long long)nk * kBK, k_end);
    }
    cp_async_commit();
    const float* A = As + (kt % kStages) * S::kAStage;
    const float* B = Bs + (kt % kStages) * S::kBStage;
    if (col_sum != nullptr && threadIdx.x < kBN) {
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < kBK; ++r) s += B[r * S::kBStride + threadIdx.x];
      *col_sum += s;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t a_big[kMT][4], a_small[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* ap = A + (kk + t) * S::kAStride + wm * kWM + mt * 16 + g;
        split(ap[0], a_big[mt][0], a_small[mt][0]);
        split(ap[8], a_big[mt][1], a_small[mt][1]);
        split(ap[4 * S::kAStride], a_big[mt][2], a_small[mt][2]);
        split(ap[4 * S::kAStride + 8], a_big[mt][3], a_small[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float* bp = B + (kk + t) * S::kBStride + wn * kWN + nt * 8 + g;
        uint32_t b0_big, b0_small, b1_big, b1_small;
        split(bp[0], b0_big, b0_small);
        split(bp[4 * S::kBStride], b1_big, b1_small);
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

// Split s of N: part_w[s][r][c] = sum over its rows k of act[k][r] dz[k][c]
// and, from the blocks of the first tile row, part_b[s][c] = sum of
// dz[k][c]. Split s covers rows [s * rows_per_split, + rows_per_split).
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_bwd_wgrad_kernel(const float* __restrict__ act,
                           const float* __restrict__ dz, float* part_w,
                           float* part_b, int n, int d, int rows_per_split) {
  using S = WgradSmem;
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
  wgrad_mainloop(acc, As, Bs, act, dz, d, r0, c0, k_begin, k_end,
                 blockIdx.y == 0 ? &col_sum : nullptr);
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

// Every array contiguous, 16-byte aligned, on `device`; d a multiple of
// 128. Each entry point launches on `stream` without synchronising and
// returns the cudaError_t of the launch (0 = launched).

// f32 forward: x [n, d]; w_big_t, w_small_t [n_layers, d, d], the
// transposed split of W ([out, in], from snerf_tf32_split); b [n_layers,
// d]; out [n, d] and, when n_layers > 1, either the scratch tmp [n, d] or
// saved [n_layers - 1, n, d], which then keeps every layer's output but
// the last (tmp is not used); out, tmp and saved distinct from x and each
// other.
int snerf_fused_mlp_fwd_f32(const void* x, const void* w_big_t,
                            const void* w_small_t, const void* b, void* out,
                            void* tmp, void* saved, int n, int d,
                            int n_layers, int last_relu, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_wgmma<false>(x, w_big_t, w_small_t, b, out, tmp, saved, n,
                             d, n_layers, last_relu,
                             static_cast<cudaStream_t>(stream));
}

// bf16 forward: x [n, d], w [n_layers, d, d] ([in, out]), b [n_layers, d],
// out [n, d], tmp [n, d] when n_layers > 1.
int snerf_fused_mlp_fwd_bf16(const void* x, const void* w, const void* b,
                             void* out, void* tmp, int n, int d,
                             int n_layers, int last_relu, int device,
                             void* stream) {
  if (d <= 0 || d % kBN != 0) return (int)cudaErrorInvalidValue;
  if (n_layers > 1 && tmp == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = set_smem(fused_mlp_fwd_bf16_kernel, Bf16Smem::kBytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + kBM - 1) / kBM);
  fused_mlp_fwd_bf16_kernel<<<grid, kThreads, Bf16Smem::kBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<bf16*>(out),
      static_cast<bf16*>(tmp), n, d, n_layers, last_relu);
  return (int)cudaGetLastError();
}

// The 3xTF32 split of w [n_layers, d, d] (d a multiple of 32): big_t,
// small_t transposed per layer and, unless both are null, big, small in
// w's layout.
int snerf_tf32_split(const void* w, void* big, void* small, void* big_t,
                     void* small_t, int n_layers, int d, int device,
                     void* stream) {
  if (d <= 0 || d % 32 != 0 || n_layers <= 0 || n_layers > 65535 ||
      (big == nullptr) != (small == nullptr) || big_t == nullptr ||
      small_t == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  tf32_split_kernel<<<dim3(d / 32, d / 32, n_layers), dim3(32, 8), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(big),
      static_cast<float*>(small), static_cast<float*>(big_t),
      static_cast<float*>(small_t), d);
  return (int)cudaGetLastError();
}

// The backward's three kernels, float32 only.
//
// dgrad: out [n, d] = (dz [n, d] W^T) * (mask [n, d] > 0), W [d, d]
// ([in, out]) given as its split w_big, w_small (snerf_tf32_split, not
// transposed); mask may be null (no mask). out distinct from dz.
int snerf_fused_mlp_bwd_dgrad(const void* dz, const void* w_big,
                              const void* w_small, const void* mask,
                              void* out, int n, int d, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_wgmma<true>(dz, w_big, w_small, mask, out, nullptr, nullptr,
                            n, d, 1, 0, static_cast<cudaStream_t>(stream));
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
    err = set_smem(fused_mlp_bwd_wgrad_kernel, WgradSmem::kBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d / kBN, d / kBM, splits);
  fused_mlp_bwd_wgrad_kernel<<<grid, kThreads, WgradSmem::kBytes,
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
