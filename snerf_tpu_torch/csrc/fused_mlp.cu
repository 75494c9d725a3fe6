// Fused uniform-width ReLU MLP, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel snerf_tpu/ops/pallas/fused_mlp.py
// (`fused_mlp` -> `_fwd` -> `_fwd_kernel`, and the custom VJP
// `_fused_fwd` / `_fused_bwd`, XLA einsums there). The forward computes,
// for L layers,
//   h = cast(act(h @ W[i] + b[i]))      W[i] laid out [in, out]
// with f32 accumulation, act = relu except on the last layer when
// last_relu == 0, and the cast to the storage type (f32 or bf16) after
// EVERY layer, as the TPU kernel does.
//
// What bounds it on this card: at the render path's shapes (N ~ 5e5
// rows, D = 1024) each layer is ~1.1 TFLOP. On the SIMT FP32 pipes
// (67 TFLOP/s peak) that is the limit; cuBLAS reaches ~45 TFLOP/s there.
// The tensor cores are faster but multiply TF32 (10-bit mantissa), so
// f32 operands are split 3xTF32: x = big + small, both TF32, and
// a*b ~ a_big*b_big + a_big*b_small + a_small*b_big (three MMAs; the
// dropped term is ~2^-22 relative), 165 TFLOP/s of f32 work at the
// card's 495 TFLOP/s of TF32. bf16 operands take one bf16 MMA (below).
// The tensor cores' f32 accumulation truncates, so an output
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
//   * The entry layer: an f32 run may open with one layer of another
//     input width, h = act(x W_0 + b_0) with x [N, K] and W_0 [K, D] (a
//     trunk's first layer, the layer after a skip-cat), K a multiple of 4
//     (TMA's 16-byte row stride). Layer 0 reads x in ceil(K / 32) stages,
//     the last one ragged (TMA zero-fills the columns past K of x and of
//     W_0's transposed split, so they add nothing), an odd count ending
//     on the first register buffer; its B operand comes from its own
//     maps, the square layers' from theirs. Its dgrad, dx = dz W_0^T, is
//     the same kernel with K-wide output: column tiles over K, the last
//     clipped in the epilogue. Its wgrad is the wgrad kernel below over
//     ceil(K / 128) tile rows. Before, these layers ran on cuBLAS's f32
//     SIMT kernels (~48 TFLOP/s at the mip shapes, 72% of the FP32 pipes'
//     peak), so only the tensor cores could make them faster.
//   TMA descriptors are encoded on the host per call
//   (cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint so the
//   library does not link libcuda) and passed as __grid_constant__.
//
// bf16 forward, dgrad and wgrad (the training path of the bf16 trunks):
//   the same machinery on bf16 operands, which are exact products on the
//   tensor cores, so one wgmma a product and no split: m64n256k16
//   f32.bf16.bf16 in the SS form (both operands from shared memory), K
//   in kQBK = 64 values (one 128-byte swizzle row) a stage, one producer
//   warp issuing TMA loads and two consumer warpgroups of 64 rows, as
//   above. The output tile is 128 x kQBN = 256 columns, 4 stages of 48
//   KB: against 128-column tiles (6 stages of 32 KB) a block re-reads its
//   A band from L2 half as often and each A fragment serves twice the
//   columns; at 2,097,152 x 512 x 4 the forward went from 13.2 to 11.8 ms
//   and no shape got slower (PERF.md). So D must be a multiple of 256 in
//   bf16 (every bf16 trunk's is: 256, 512, 1024). For 16-bit types wgmma
//   reads an operand K-major or MN-major (its transpose bit), so no
//   operand is transposed anywhere:
//   * forward: A = the band [N, in] K-major; B(k = in, n = out) = W[in]
//     [out] as it lies, MN-major: 4 TMA boxes of [64 in rows, 64 out
//     values] a stage. The band stays in the block through the
//     layers and the keep/eval outputs land as in the f32 forward (bf16,
//     one rounding a layer after the bias and ReLU in f32, as the Pallas
//     kernel's epilogue).
//   * dgrad: dz_{i-1} = bf16((dz_i W_i^T) * (act_i > 0)); B(k = out, n =
//     in) = W[in][out] lies K-major, A = dz K-major. Its first kernel ran
//     the forward's schedule at ~2x the bf16 cuBLAS GEMM, and without its
//     epilogue's stores its mainloop beat that GEMM (PERF.md): the bf16x2
//     stores straight from the accumulator (8 rows x 16 bytes a warp) and
//     the short blocks that exited after them cost the rest. So dgrad is
//     persistent, one block a SM walking its (band, column tile) tiles in
//     order, the producer's ring running on across tiles, and its
//     epilogue goes through shared memory: each consumer warpgroup writes
//     its 64 x 256 half, bank-free in the 128-byte swizzle, into its own
//     buffer, and warp 9 stores the half by TMA (cp.async.bulk.tensor,
//     clipping the ragged edge) while the next tile's loads and wgmmas
//     run, then loads the next tile's mask half into the same buffer by
//     TMA, so the epilogue reads the mask from shared memory. A stage is
//     handed back as soon as its own wgmmas retire. 3 stages of 48 KB
//     beside the 64 KB of buffers.
//   * wgrad: dW = act^T dz over a split of N: A(m, k) = act[k][m] and
//     B(k, n) = dz[k][n] both MN-major, boxes of [64 rows, 64 values]; no
//     shared-memory transpose. The f32 partial is added into every 2,048
//     rows, the fixed-order reduce below sums the partials, and the
//     wrapper rounds dW and db to bf16 once. db: the blocks of the first
//     tile row sum their dz columns from the stage in shared memory while
//     the wgmmas run. The caller splits N into runs of ~2,048 rows (64
//     waves of blocks): longer splits ran slower. Splits of a wave each
//     (1 GiB of partials down to 16 MiB at 2,097,152 x 512) run their
//     mainloop faster than the bf16 cuBLAS GEMM, but every way tried of
//     adding the accumulator into an f32 sum every 2,048 rows, and of
//     summing db, on this card cost more than the partials save (PERF.md).
//   What bounds them: at the zip trunks' shapes (2,097,152 x 512) the
//   forward's 4 layers are 4.4 TFLOP, 4.45 ms at 989 TFLOP/s; dgrad
//   moves dz, the mask and its output (6.4 GB, 1.92 ms at 3.35 TB/s)
//   above its 1.1 ms of products; wgrad reads act and dz (4.3 GB, 1.28
//   ms). Tried and slower for dgrad (PERF.md): two-CTA clusters sharing W
//   by TMA multicast (here and in the first kernel), a band's column
//   tiles on one block, its stores by the warps instead of TMA, a skew
//   between the warpgroups, 6 stages of 24 KB, an L2 prefetch of the mask.
//
// Backward, per layer i from the last (act_0 = x, act_{i+1} = layer i's
// output, dz_i = dL/d(pre-activation of layer i), all f32):
//   dgrad: dz_{i-1} = (dz_i W_i^T) * (act_i > 0), or dx = dz_0 W_0^T,
//          on the wgmma mainloop above;
//   wgrad: dW_i = act_i^T dz_i, db_i = sum over rows of dz_i.
// wgrad on wgmma + TMA, 3xTF32 (mma.sync, the first design, ran at the
// ~50 TFLOP/s above). wgrad reduces over N, the row index of both stored
// operands, so both are MN-major, and TF32 wgmma reads B only K-major.
//   * A = act^T in the RS form: its registers are filled from shared
//     memory, so its staging is free. TMA boxes of [32 rows, 32 columns]
//     (the 128-byte swizzle's inner limit) land act as [k][m]; the
//     consumer threads read their fragments and split them, as the
//     forward does. Along k the 32 lanes would hit each bank twice, so the
//     k positions of a wgmma step are permuted: position j reads stage row
//     2j (j < 4) or 2(j - 4) + 1, and the swizzle then puts the lanes on
//     32 banks.
//   * B = dz, transposed in shared memory: the two consumer warpgroups
//     turn each [k][n] TMA stage into K-major [n][k] big and small TF32
//     tiles in the swizzled layout `smem_desc` describes (k in the same
//     permuted order), each thread a column and half the rows, once a
//     stage rather than once per warp along M, while the previous stage's
//     wgmmas run. They fence their generic stores into the async proxy
//     (fence.proxy.async.shared::cta) and meet at a named barrier before
//     any wgmma reads the tiles. The threads sum their columns for db. A
//     third warpgroup for the transpose, or a producer warp (registers
//     are allocated in groups of 4 warps), caps the block at 168 registers
//     a thread, under which the consumers spilled; with 256 threads they
//     may take 255, and thread 0 issues the TMA loads after the barrier
//     that ends a stage's reads, so no mbarrier hands stages back.
//   * Two consumer warpgroups of 64 rows run m64n128k8 on a 128 x 128
//     tile of dW, a block per tile and split of N. The tensor cores' f32
//     accumulation truncates, so a run's error grows with its rows: every
//     2,048 rows the accumulator is added into the block's f32 partial
//     (a deterministic read-modify-write of the block's own tile) and
//     cleared, which lets a block cover a long split: the caller picks
//     ~16 waves of blocks, and a second kernel sums the partials in split
//     order. No atomics: two identical steps give bit-identical grads.
//   * Stages: 4 raw (act and dz boxes, 32 KB) and 3 transposed (big and
//     small, 32 KB), 224 KB.
// The ReLU mask of the last layer (when last_relu) is an elementwise pass
// in the wrapper.

#include <cuda.h>  // CUtensorMap and its enums (types only; no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// The k-depth stages of a layer: k0 wide for layer 0 (the last stage
// ragged), d for the square layers after it.
__device__ __forceinline__ int layer_ktiles(int layer, int k0, int d) {
  return ((layer == 0 ? k0 : d) + kHBK - 1) / kHBK;
}

// f32 forward (kDgrad false) or dgrad (kDgrad true) on a 128-row band;
// see the note at the top. Every layer writes d columns; layer 0 reads
// k0 (a square run: k0 = d). Forward: tm_x = x [n, k0], tm_out, tm_tmp,
// tm_saved the layer outputs read back (one slab a layer); tm_w0b /
// tm_w0s layer 0's transposed split [d, k0], tm_wb / tm_ws the square
// layers' [*, d, d], layer l >= 1 in slab l - w_base (a square run passes
// the whole stack as both and w_base 0); vec = the biases [L, d]. dgrad:
// tm_x = dz [n, k0], tm_w0b / tm_w0s the layer's split W [d in, k0 out]
// as it lies, out [n, d] (d may be ragged: the epilogue clips it); vec =
// the mask [n, d] (null: none); n_layers = 1, so the band never reads a
// layer back: tm_out, tm_tmp, tm_saved, tm_wb, tm_ws, tmp, saved and
// last_relu go unread (zero maps and nulls), the price of one mainloop,
// producer and epilogue for both.
template <bool kDgrad>
__global__ void __launch_bounds__(kHThreads, 1)
k1_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_out,
                const __grid_constant__ CUtensorMap tm_tmp,
                const __grid_constant__ CUtensorMap tm_saved,
                const __grid_constant__ CUtensorMap tm_w0b,
                const __grid_constant__ CUtensorMap tm_w0s,
                const __grid_constant__ CUtensorMap tm_wb,
                const __grid_constant__ CUtensorMap tm_ws,
                const float* __restrict__ vec, float* out, float* tmp,
                float* saved, int n, int k0, int d, int n_layers,
                int w_base, int last_relu) {
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
  const bool keep = saved != nullptr;

  if (wg == 2) {
    // ---- producer: one warp, lane 0 issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 8) return;
    int it = 0;
    for (int layer = 0; layer < n_layers; ++layer) {
      const CUtensorMap* tin = &tm_x;
      const CUtensorMap* twb = &tm_w0b;
      const CUtensorMap* tws = &tm_w0s;
      int slab = 0, wslab = 0;
      if (layer > 0) {
        // wait until the consumers have written the previous layer
        named_barrier_sync(kLayerBarrier, 2 * 128 + kProducerThreads);
        fence_proxy_async_global();
        const int k = dst_kind(layer - 1, n_layers, keep);
        tin = k == 0 ? &tm_out : k == 1 ? &tm_tmp : &tm_saved;
        slab = k == 2 ? layer - 1 : 0;
        twb = &tm_wb;
        tws = &tm_ws;
        wslab = layer - w_base;
      }
      const int ktiles = layer_ktiles(layer, k0, d);
      for (int c0 = 0; c0 < d; c0 += kHBN) {
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % kHStages;
          mbar_wait(&ring.empty[s], ((it / kHStages) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(&ring.full[s], kStageBytes);
            tma_load(ring.a(s), tin, &ring.full[s], kt * kHBK, row0, slab);
            tma_load(ring.b_big(s), twb, &ring.full[s], kt * kHBK, c0, wslab);
            tma_load(ring.b_small(s), tws, &ring.full[s], kt * kHBK, c0,
                     wslab);
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
      const int ktiles = layer_ktiles(layer, k0, d);
      for (int c0 = 0; c0 < d; c0 += kHBN) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        for (int kt = 0; kt < ktiles; kt += 2) {
          consume_stage<0>(ring, acc, ab, as, it, kt == 0, r_lo, g, t, lane);
          if (kt + 1 < ktiles)  // an entry layer's count may be odd
            consume_stage<1>(ring, acc, ab, as, it, false, r_lo, g, t, lane);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(ab[0]);
        fence_regs(as[0]);
        fence_regs(ab[1]);
        fence_regs(as[1]);
        if (lane == 0)
          mbar_arrive(&ring.empty[(it + kHStages - 1) % kHStages]);

        // Epilogue. Accumulator fragment of n8 block j: rows r, r + 8;
        // cols 8j + 2t, 8j + 2t + 1 (d[4j + 2h + e]); dgrad's d may end
        // inside the tile (d even, so a pair is in or out whole).
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = c0 + 8 * j + 2 * t;
          if (kDgrad && col >= d) continue;
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

// big = cvt.rna.tf32(w), small = cvt.rna.tf32(w - big) for w [L, rows,
// cols]; (big_t, small_t) are transposed per layer, [l][j][i] = [l][i][j];
// (big, small) keep w's layout and may be null. A 32 x 32 tile a block
// (the edge tiles clipped), transposed through shared memory so both
// writes are coalesced.
__global__ void tf32_split_kernel(const float* __restrict__ w, float* big,
                                  float* small, float* big_t, float* small_t,
                                  int rows, int cols) {
  __shared__ float tb[32][33], ts[32][33];
  const long long base = (long long)blockIdx.z * rows * cols;
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  if (j0 + (int)threadIdx.x < cols) {
    for (int r = threadIdx.y; r < 32 && i0 + r < rows; r += 8) {
      const long long e = base + (long long)(i0 + r) * cols + j0 + threadIdx.x;
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
  }
  __syncthreads();
  if (i0 + (int)threadIdx.x < rows) {
    for (int r = threadIdx.y; r < 32 && j0 + r < cols; r += 8) {
      const long long e = base + (long long)(j0 + r) * rows + i0 + threadIdx.x;
      big_t[e] = tb[threadIdx.x][r];
      small_t[e] = ts[threadIdx.x][r];
    }
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

// A map over `slabs` row-major [rows, d] f32 (or bf16) slabs at ptr, boxes
// of [box_rows, 128 bytes] (kHBK floats or kQBK bf16 values) with the
// 128-byte swizzle; rows past `rows` of a slab read as zeros.
cudaError_t encode(CUtensorMap* map, const void* ptr, int d, long long rows,
                   int slabs, int box_rows = kHBM, bool is_bf16 = false) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elem_bytes = is_bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)d * elem_bytes,
                                 (cuuint64_t)d * elem_bytes * rows};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem_bytes),
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map,
                        is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// in [n, k0]; layer 0's split (w0b, w0s) [d, k0] and, when w0b differs
// from wb, the square layers' (wb, ws) [n_layers - 1, d, d]; a square run
// passes its whole stack [n_layers, d, d] as both (k0 = d). Forward: d a
// multiple of 128; dgrad (n_layers 1): k0 a multiple of 128, d of 4.
template <bool kDgrad>
int launch_wgmma(const void* in, const void* w0b, const void* w0s,
                 const void* wb, const void* ws, const void* vec, void* out,
                 void* tmp, void* saved, int n, int k0, int d, int n_layers,
                 int last_relu, cudaStream_t stream) {
  if (n <= 0 || d <= 0 || k0 <= 0 || k0 % 4 != 0 || d % 4 != 0 ||
      n_layers <= 0 || (kDgrad ? k0 : d) % kHBN != 0)
    return (int)cudaErrorInvalidValue;
  const int w_base = w0b == wb ? 0 : 1;
  if (!kDgrad && w_base == 0 && k0 != d) return (int)cudaErrorInvalidValue;
  if (!kDgrad && n_layers > 1 && tmp == nullptr && saved == nullptr)
    return (int)cudaErrorInvalidValue;
  // dgrad (one layer) reads only tm[0], tm[4] and tm[5]; the forward's
  // maps of the layers it reads back stay zero there.
  CUtensorMap tm[8] = {};
  cudaError_t err = encode(&tm[0], in, k0, n, 1);
  if (!kDgrad) {
    if (err == cudaSuccess) err = encode(&tm[1], out, d, n, 1);
    if (err == cudaSuccess)
      err = encode(&tm[2], tmp != nullptr ? tmp : out, d, n, 1);
    if (err == cudaSuccess)
      err = encode(&tm[3], saved != nullptr ? saved : out, d, n,
                   saved != nullptr ? n_layers - 1 : 1);
  }
  const int w0_slabs = w_base == 0 ? n_layers : 1;
  if (err == cudaSuccess) err = encode(&tm[4], w0b, k0, d, w0_slabs);
  if (err == cudaSuccess) err = encode(&tm[5], w0s, k0, d, w0_slabs);
  tm[6] = tm[4];
  tm[7] = tm[5];
  if (w_base == 1 && n_layers > 1) {
    if (err == cudaSuccess) err = encode(&tm[6], wb, d, d, n_layers - 1);
    if (err == cudaSuccess) err = encode(&tm[7], ws, d, d, n_layers - 1);
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k1_wgmma_kernel<kDgrad>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kHSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + kHBM - 1) / kHBM);
  k1_wgmma_kernel<kDgrad><<<grid, kHThreads, kHSmem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], tm[6], tm[7],
      static_cast<const float*>(vec), static_cast<float*>(out),
      static_cast<float*>(tmp), static_cast<float*>(saved), n, k0, d,
      n_layers, w_base, last_relu);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- wgrad
// dW = act^T dz over a split of N, on the wgmma + TMA machinery above; see
// the note at the top. A block owns one 128 x 128 tile of dW (rows m0.. of
// act's m columns, columns n0.. of dz's d) and one split of N, K = N rows
// in stages of kHBK = 32. An entry layer's act is m = K wide: its last
// tile row reads zeros past K (TMA fills them) and stores only rows < m.
constexpr int kWThreads = 256;  // two consumer warpgroups; thread 0 loads
constexpr int kWRaw = 4;      // raw stages: the act and dz boxes, by TMA
constexpr int kWB = 3;        // dz stages transposed and split, K-major
constexpr uint32_t kBoxBytes = kHBK * 32 * 4;   // one [32 rows, 32 floats]
constexpr uint32_t kRawHalf = 4 * kBoxBytes;    // 128 columns: 16 KB
constexpr uint32_t kRawBytes = 2 * kRawHalf;    // act, then dz
constexpr uint32_t kBPairBytes = 2 * kTileBytes;  // big, small
constexpr uint32_t kWBarOffset = kWRaw * kRawBytes + kWB * kBPairBytes;
constexpr int kConsumerBarrier = 1;  // named barrier of the 256 consumers
// The truncating tensor-core accumulator drifts with the rows it sums:
// every 2,048 rows it is added into the block's f32 partial and cleared.
constexpr int kPromoteStages = 2048 / kHBK;
constexpr size_t kWSmem = kWBarOffset + kWRaw * sizeof(uint64_t) +
                          kHBN * sizeof(float) + 1024;
static_assert(kWSmem <= 232448, "wgrad's stages exceed 227 KB");

// The stages of a wgrad block at fixed offsets from its 1024-byte aligned
// base. A raw half holds 128 columns of 32 rows as four TMA boxes of
// [32 rows, 32 floats] in the 128-byte swizzle; element (k, c) sits at
// raw_at(k, c).
struct WRing {
  unsigned char* base;
  __device__ float* act(int s) const {
    return reinterpret_cast<float*>(base + s * kRawBytes);
  }
  __device__ float* dz(int s) const {
    return reinterpret_cast<float*>(base + s * kRawBytes + kRawHalf);
  }
  __device__ float* b_big(int s) const {
    return reinterpret_cast<float*>(base + kWRaw * kRawBytes +
                                    s * kBPairBytes);
  }
  __device__ float* b_small(int s) const {
    return b_big(s) + kTileBytes / 4;
  }
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + kWBarOffset) + s;
  }
  __device__ float* col(int c) const {  // db's second halves
    return reinterpret_cast<float*>(full(kWRaw)) + c;
  }
};
__device__ __forceinline__ int raw_at(int k, int c) {
  return (c >> 5) * 1024 + k * 32 + ((((c & 31) >> 2) ^ (k & 7)) << 2) +
         (c & 3);
}
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA loads of stage p of a wgrad block into raw slot p % kWRaw: the
// block's 128 act columns from m0 and 128 dz columns from n0 over the 32
// rows from k_begin + 32p.
__device__ __forceinline__ void wgrad_load(const WRing& ring,
                                           const CUtensorMap* tm_act,
                                           const CUtensorMap* tm_dz, int p,
                                           long long k_begin, int m0, int n0) {
  const int s = p % kWRaw;
  mbar_expect_tx(ring.full(s), kRawBytes);
  const int k0 = (int)(k_begin + (long long)p * kHBK);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    tma_load(ring.act(s) + q * 1024, tm_act, ring.full(s), m0 + 32 * q, k0,
             0);
    tma_load(ring.dz(s) + q * 1024, tm_dz, ring.full(s), n0 + 32 * q, k0, 0);
  }
}

// One stage of a consumer warpgroup. A = act^T: its fragments from the
// raw act stage, split into (ab[kBuf], as[kBuf]). B = dz: consumer thread
// ct turns column c = ct % 128 of the raw dz stage, rows 16 (ct / 128)
// .. + 15, into row c of the K-major big and small tiles of slot it % kWB
// (the 128-byte swizzle: 16-byte chunk j of row c at j ^ (c % 8)), and
// adds the values into col for db. wgmma k position j of step kk reads
// stage row 8kk + 2j (j < 4) or 8kk + 2(j - 4) + 1: with the swizzle the
// 32 lanes then read act on 32 banks, and the tiles hold dz in the same
// order. The generic stores are fenced into the async proxy, and a
// barrier of both warpgroups completes the tiles, ends every read of the
// raw stage (thread 0 then loads stage it + kWRaw into its slot) and, a
// stage on, frees the tiles' slot (a warpgroup reaches it only after the
// wgmmas of three stages back are done); the 3 x 4 wgmmas run as one
// group.
template <int kBuf>
__device__ __forceinline__ void wgrad_stage(
    const WRing& ring, float (&acc)[64], uint32_t (&ab)[2][4][4],
    uint32_t (&as)[2][4][4], float& col, int& it, int stages, int r_lo,
    int t, const CUtensorMap* tm_act, const CUtensorMap* tm_dz,
    long long k_begin, int m0, int n0) {
  const int s = it % kWRaw, sb = it % kWB;
  mbar_wait(ring.full(s), (it / kWRaw) & 1);
  const float* A = ring.act(s);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = 8 * kk + 2 * t;
    split(A[raw_at(k, r_lo)], ab[kBuf][kk][0], as[kBuf][kk][0]);
    split(A[raw_at(k, r_lo + 8)], ab[kBuf][kk][1], as[kBuf][kk][1]);
    split(A[raw_at(k + 1, r_lo)], ab[kBuf][kk][2], as[kBuf][kk][2]);
    split(A[raw_at(k + 1, r_lo + 8)], ab[kBuf][kk][3], as[kBuf][kk][3]);
  }
  const int c = threadIdx.x & 127, half = threadIdx.x >> 7;
  const float* src = ring.dz(s);
  float* big = ring.b_big(sb) + c * kHBK;
  float* small = ring.b_small(sb) + c * kHBK;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int a = 2 * half + i;
    float v[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      v[kk] = src[raw_at(8 * a + kk, c)];
      col += v[kk];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t vb[4], vs[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(v[2 * e + h], vb[e], vs[e]);
      const int off = ((2 * a + h) ^ (c & 7)) << 2;
      *reinterpret_cast<uint4*>(big + off) =
          make_uint4(vb[0], vb[1], vb[2], vb[3]);
      *reinterpret_cast<uint4*>(small + off) =
          make_uint4(vs[0], vs[1], vs[2], vs[3]);
    }
  }
  fence_proxy_async_shared();
  named_barrier_sync(kConsumerBarrier, kWThreads);
  if (threadIdx.x == 0 && it + kWRaw < stages)
    wgrad_load(ring, tm_act, tm_dz, it + kWRaw, k_begin, m0, n0);
  const uint64_t db = smem_desc(ring.b_big(sb));
  const uint64_t ds = smem_desc(ring.b_small(sb));
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
  ++it;
}

// Split z of N (rows [z * rows_per_split, + rows_per_split) of act [n, m]
// and dz [n, d]): part_w[z][r][c] = sum over its rows k of act[k][r]
// dz[k][c] for the block's 128 x 128 tile (rows r < m) and, from the
// blocks of the first tile row, part_b[z][c] = sum of dz[k][c]. Two
// warpgroups, 64 rows of the tile and half of each dz stage's transpose
// each; thread 0 also issues the TMA loads, kWRaw stages ahead.
__global__ void __launch_bounds__(kWThreads, 1)
fused_mlp_bwd_wgrad_kernel(const __grid_constant__ CUtensorMap tm_act,
                           const __grid_constant__ CUtensorMap tm_dz,
                           float* part_w, float* part_b, int n, int m, int d,
                           int rows_per_split) {
  extern __shared__ unsigned char smem_raw[];
  WRing ring;
  ring.base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWRaw; ++s) mbar_init(ring.full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kHBN, m0 = blockIdx.y * kHBM;
  const long long k_begin = (long long)blockIdx.z * rows_per_split;
  const long long k_end = k_begin + rows_per_split < n
                              ? k_begin + rows_per_split : (long long)n;
  const int stages = (int)((k_end - k_begin + kHBK - 1) / kHBK);
  if (threadIdx.x == 0)
    for (int p = 0; p < kWRaw && p < stages; ++p)
      wgrad_load(ring, &tm_act, &tm_dz, p, k_begin, m0, n0);

  // warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int r_lo = wg * 64 + (warp % 4) * 16 + g;
  float* pw = part_w + (long long)blockIdx.z * m * d;
  float acc[64];
  uint32_t ab[2][4][4] = {}, as[2][4][4] = {};
  float col = 0.f;
  int it = 0;
  for (int c0 = 0; c0 < stages; c0 += kPromoteStages) {
    const int nst = min(kPromoteStages, stages - c0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int st = 0; st < nst; st += 2) {
      wgrad_stage<0>(ring, acc, ab, as, col, it, stages, r_lo, t, &tm_act,
                     &tm_dz, k_begin, m0, n0);
      if (st + 1 < nst)
        wgrad_stage<1>(ring, acc, ab, as, col, it, stages, r_lo, t, &tm_act,
                       &tm_dz, k_begin, m0, n0);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ab[1]);
    fence_regs(as[1]);
    // The partial (+)= this run's sum, in run order. Accumulator fragment
    // of n8 block j: rows r, r + 8; cols 8j + 2t, 8j + 2t + 1.
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (m0 + r_lo + 8 * h >= m) continue;
        float2* p = reinterpret_cast<float2*>(
            pw + (long long)(m0 + r_lo + 8 * h) * d + n0 + 8 * j + 2 * t);
        float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (c0 > 0) {
          const float2 o = *p;
          v = make_float2(o.x + v.x, o.y + v.y);
        }
        *p = v;
      }
    }
  }
  // db: each column's two halves of rows, the first plus the second
  if (blockIdx.y == 0) {
    if (wg == 1) *ring.col(threadIdx.x & 127) = col;
    named_barrier_sync(kConsumerBarrier, kWThreads);
    if (wg == 0)
      part_b[(long long)blockIdx.z * d + n0 + threadIdx.x] =
          col + *ring.col(threadIdx.x);
  }
}

// dw[e] = sum over s, in order, of part_w[s][e] (dw [m, d]); db likewise
// from part_b.
__global__ void fused_mlp_bwd_reduce_kernel(const float* __restrict__ part_w,
                                            const float* __restrict__ part_b,
                                            float* dw, float* db, int m,
                                            int d, int splits) {
  const long long dd = (long long)m * d;
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

// ------------------------------------------------ bf16 (wgmma, SS form)
// See the note at the top. A forward or dgrad stage: a [128, kQBK] A tile
// (16 KB), then the B tile of kQBN columns (K-major [kQBN, kQBK], or 4
// MN-major [kQBK, 64] boxes, 32 KB).
constexpr int kQBK = 64;                       // bf16 k-depth of a stage
constexpr int kQBN = 256;                      // columns of an output tile
constexpr uint32_t kQTileA = 128 * kQBK * 2;   // 16 KB
constexpr uint32_t kQBox = 64 * kQBK * 2;      // one [64, 64] box: 8 KB
constexpr int kQBoxElems = kQBox / 2;
constexpr uint32_t kQStageBytes = kQTileA + kQBN * kQBK * 2;
constexpr int kQStages = 4;
constexpr size_t kQSmem = (size_t)kQStages * kQStageBytes +
                          2 * kQStages * sizeof(uint64_t) + 1024;
static_assert(kQSmem <= 232448, "the bf16 stages exceed 227 KB");

__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

struct QRing {
  unsigned char* base;  // 1024-byte aligned
  uint64_t* full;
  uint64_t* empty;
  __device__ bf16* a(int s) const {
    return reinterpret_cast<bf16*>(base + s * kQStageBytes);
  }
  __device__ bf16* b(int s) const {
    return reinterpret_cast<bf16*>(base + s * kQStageBytes + kQTileA);
  }
};

__device__ __forceinline__ QRing qring_init(unsigned char* raw) {
  QRing ring;
  ring.base = align1024(raw);
  ring.full = reinterpret_cast<uint64_t*>(ring.base + kQStages * kQStageBytes);
  ring.empty = ring.full + kQStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// The descriptor of an MN-major bf16 operand as TMA writes it: [kQBK k
// rows, 64 values] boxes with the 128-byte swizzle, 8-row k groups 1024
// bytes apart (SBO) and each next 64 values of MN one box (8 KB) on (LBO).
// +128 per 16-deep k step (16 rows, 2 KB). smem_desc above describes a
// K-major tile of bf16 as of f32 (+2 per k step, 32 bytes).
__device__ __forceinline__ uint64_t smem_desc_mn(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(kQBox >> 4) << 16) |
         ((1024ull >> 4) << 32) | (1ull << 62);
}
// d (a 64 x 256 f32 tile, 128 a thread) += A (64 x 16 bf16) B (16 x 256
// bf16), both from shared memory; kTransA / kTransB: the operand is
// MN-major.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[kQBN / 2],
                                           uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

// One landed stage of a consumer warpgroup: its four 16-deep wgmmas as one
// group, then retire the previous stage's group and hand that stage back
// to the producer (not when `first`: no previous stage of this tile).
template <int kTransA, int kTransB>
__device__ __forceinline__ void qstage(const QRing& ring,
                                       float (&acc)[kQBN / 2], int it,
                                       uint64_t da, uint64_t db, bool first,
                                       int lane) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_bf16<kTransA, kTransB>(acc, da + (kTransA ? 128 : 2) * j,
                                 db + (kTransB ? 128 : 2) * j);
  wgmma_commit();
  fence_regs(acc);
  wgmma_wait<1>();
  if (!first && lane == 0)
    mbar_arrive(&ring.empty[(it + kQStages - 1) % kQStages]);
}
// After a tile's last stage (it already past it): retire it, hand it back.
__device__ __forceinline__ void qdrain(const QRing& ring,
                                       float (&acc)[kQBN / 2], int it,
                                       int lane) {
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(&ring.empty[(it + kQStages - 1) % kQStages]);
}

// One landed stage of dgrad's consumer warpgroup: its four wgmmas as one
// group, retired before the stage is handed back, so that the producer
// refills it a stage sooner (3 stages; with wait_group 1 and the release
// a stage later, as qstage, dgrad ran 4-8% slower).
__device__ __forceinline__ void qstage_retire(uint64_t* empty, int s,
                                              float (&acc)[kQBN / 2],
                                              uint64_t da, uint64_t db,
                                              int lane) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_bf16<0, 0>(acc, da + 2 * j, db + 2 * j);
  wgmma_commit();
  fence_regs(acc);
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(&empty[s]);
}

// bf16 forward on a 128-row band in output tiles of kQBN columns, the f32
// kernel's schedule: tm_x = x, tm_out / tm_tmp / tm_saved the layer
// outputs read back, tm_w the weights [L, in, out]; b = the biases [L, d].
__global__ void __launch_bounds__(kHThreads, 1)
k1_bf16_fwd_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_out,
                   const __grid_constant__ CUtensorMap tm_tmp,
                   const __grid_constant__ CUtensorMap tm_saved,
                   const __grid_constant__ CUtensorMap tm_w,
                   const bf16* __restrict__ b, bf16* out, bf16* tmp,
                   bf16* saved, int n, int d, int n_layers, int last_relu) {
  extern __shared__ unsigned char smem_raw[];
  const QRing ring = qring_init(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int row0 = blockIdx.x * kHBM;
  const int ktiles = d / kQBK;
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
        named_barrier_sync(kLayerBarrier, 2 * 128 + kProducerThreads);
        fence_proxy_async_global();
        const int k = dst_kind(layer - 1, n_layers, keep);
        tin = k == 0 ? &tm_out : k == 1 ? &tm_tmp : &tm_saved;
        slab = k == 2 ? layer - 1 : 0;
      }
      for (int c0 = 0; c0 < d; c0 += kQBN) {
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % kQStages;
          mbar_wait(&ring.empty[s], ((it / kQStages) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(&ring.full[s], kQStageBytes);
            tma_load(ring.a(s), tin, &ring.full[s], kt * kQBK, row0, slab);
#pragma unroll
            for (int q = 0; q < kQBN / 64; ++q)
              tma_load(ring.b(s) + q * kQBoxElems, &tm_w, &ring.full[s],
                       c0 + 64 * q, kt * kQBK, layer);
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
    float acc[kQBN / 2];
    int it = 0;
    for (int layer = 0; layer < n_layers; ++layer) {
      const bool relu = layer < n_layers - 1 || last_relu;
      const int k = dst_kind(layer, n_layers, keep);
      bf16* dst = k == 0 ? out
                  : k == 1 ? tmp
                           : saved + (long long)layer * n * d;
      for (int c0 = 0; c0 < d; c0 += kQBN) {
#pragma unroll
        for (int i = 0; i < kQBN / 2; ++i) acc[i] = 0.f;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % kQStages;
          mbar_wait(&ring.full[s], (it / kQStages) & 1);
          qstage<0, 1>(ring, acc, it, smem_desc(ring.a(s) + wg * 64 * kQBK),
                       smem_desc_mn(ring.b(s)), kt == 0, lane);
        }
        qdrain(ring, acc, it, lane);

        // Epilogue. Accumulator fragment of n8 block j: rows r, r + 8;
        // cols 8j + 2t, 8j + 2t + 1 (d[4j + 2h + e]).
#pragma unroll
        for (int j = 0; j < kQBN / 8; ++j) {
          const int col = c0 + 8 * j + 2 * t;
          const float2 bias = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(
                  b + (long long)layer * d + col));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const long long row = (long long)row0 + r_lo + 8 * h;
            if (row >= n) continue;
            float v0 = acc[4 * j + 2 * h] + bias.x;
            float v1 = acc[4 * j + 2 * h + 1] + bias.y;
            if (relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            store2(dst + row * d + col, v0, v1);
          }
        }
      }
      if (layer < n_layers - 1) {
        fence_proxy_async_global();
        named_barrier_sync(kLayerBarrier, 2 * 128 + kProducerThreads);
      }
    }
  }
}

// Bulk copies from shared memory back to device memory (TMA stores).
// One [64, 64] box of a 3-D map at (c0, c1, c2) from shared memory; rows
// past the map's end are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Until they have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------- bf16 dgrad (persistent)
// See the note at the top. A block a SM walks the (band, column tile)
// tiles b, b + gridDim.x, ..., in that order, so the blocks running at a
// time share their bands' A rows in L2; a tile is 128 rows x kQBN
// columns, K = d in stages of kQBK. The ring of kDStages stages runs on
// across tiles. Each consumer warpgroup owns a 64 x 256 half of the tile
// and its own half of the epilogue buffer: 4 [64 rows, 64 columns] boxes
// in the 128-byte swizzle (32 KB), into which warp 9 loads the half's
// mask tile by TMA ahead of the epilogue and from which it stores the
// half's output by TMA.
constexpr int kDStages = 3;
constexpr uint32_t kDBox = 64 * 64 * 2;      // one [64, 64] box: 8 KB
constexpr int kDBoxElems = kDBox / 2;
constexpr uint32_t kDHalf = (kQBN / 64) * kDBox;  // 32 KB
constexpr int kDBars = 2 * kDStages + 4;
constexpr size_t kDSmem = (size_t)kDStages * kQStageBytes + 2 * kDHalf +
                          kDBars * sizeof(uint64_t) + 1024;
static_assert(kDSmem <= 232448, "dgrad's stages exceed 227 KB");

// The stages, the two epilogue halves and the barriers of a dgrad block:
// full / empty a stage; ready(h), a half's buffer free for the next
// epilogue (and holding its mask); done(h), the half's outputs written.
struct DRing {
  unsigned char* base;  // 1024-byte aligned
  __device__ bf16* a(int s) const {
    return reinterpret_cast<bf16*>(base + s * kQStageBytes);
  }
  __device__ bf16* b(int s) const {
    return reinterpret_cast<bf16*>(base + s * kQStageBytes + kQTileA);
  }
  __device__ bf16* e(int h) const {
    return reinterpret_cast<bf16*>(base + kDStages * kQStageBytes +
                                   h * kDHalf);
  }
  __device__ uint64_t* bars() const {
    return reinterpret_cast<uint64_t*>(base + kDStages * kQStageBytes +
                                       2 * kDHalf);
  }
  __device__ uint64_t* full(int s) const { return bars() + s; }
  __device__ uint64_t* empty() const { return bars() + kDStages; }
  __device__ uint64_t* ready(int h) const { return bars() + 2 * kDStages + h; }
  __device__ uint64_t* done(int h) const {
    return bars() + 2 * kDStages + 2 + h;
  }
};

// out = bf16((dz W^T) * (mask > 0)) (kMask) or bf16(dz W^T): tm_dz = dz
// [n, d] in [128, kQBK] boxes, tm_w = W [in, out] in K-major [kQBN, kQBK]
// boxes, tm_mask / tm_out = the mask and out in [64, 64] boxes.
template <bool kMask>
__global__ void __launch_bounds__(kHThreads, 1)
k1_bf16_dgrad_kernel(const __grid_constant__ CUtensorMap tm_dz,
                     const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_mask,
                     const __grid_constant__ CUtensorMap tm_out, int n,
                     int d) {
  extern __shared__ unsigned char smem_raw[];
  DRing ring;
  ring.base = align1024(smem_raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDStages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty() + s, 8);  // lane 0 of each consumer warp
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(ring.ready(h), 1);
      mbar_init(ring.done(h), 128);  // every thread of the half's warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int ctiles = d / kQBN, ktiles = d / kQBK;
  const int tiles = (n + kHBM - 1) / kHBM * ctiles;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (lane != 0 || warp > 9) return;
    if (warp == 8) {
      // ---- producer: the stages of every tile, in order
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / ctiles * kHBM, c0 = tile % ctiles * kQBN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % kDStages;
          mbar_wait(ring.empty() + s, ((it / kDStages) & 1) ^ 1);
          mbar_expect_tx(ring.full(s), kQStageBytes);
          tma_load(ring.a(s), &tm_dz, ring.full(s), kt * kQBK, row0, 0);
          tma_load(ring.b(s), &tm_w, ring.full(s), kt * kQBK, c0, 0);
        }
      }
      return;
    }
    // ---- warp 9: each half's output out by TMA once written, then the
    // next tile's mask in (or the half marked free)
    int tc = 0, prev_row0 = 0, prev_c0 = 0;
    for (int tile = blockIdx.x;; tile += gridDim.x, ++tc) {
      const bool more = tile < tiles;
      const int row0 = tile / ctiles * kHBM, c0 = tile % ctiles * kQBN;
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        if (tc > 0) {
          mbar_wait(ring.done(h), (tc - 1) & 1);
          if (prev_row0 + 64 * h < n) {
#pragma unroll
            for (int q = 0; q < kQBN / 64; ++q)
              tma_store(&tm_out, ring.e(h) + q * kDBoxElems, prev_c0 + 64 * q,
                        prev_row0 + 64 * h, 0);
            bulk_commit();
            bulk_wait_read();
          }
        }
        if (!more) continue;
        if (kMask && row0 + 64 * h < n) {
          mbar_expect_tx(ring.ready(h), kDHalf);
#pragma unroll
          for (int q = 0; q < kQBN / 64; ++q)
            tma_load(ring.e(h) + q * kDBoxElems, &tm_mask, ring.ready(h),
                     c0 + 64 * q, row0 + 64 * h, 0);
        } else {
          mbar_arrive(ring.ready(h));
        }
      }
      if (!more) break;
      prev_row0 = row0;
      prev_c0 = c0;
    }
    bulk_wait();
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int g = lane / 4, t = lane % 4;
  const int r = (warp % 4) * 16 + g;  // row in the half; r % 8 == g
  bf16* e = ring.e(wg);
  float acc[kQBN / 2];
  int it = 0, tc = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++tc) {
#pragma unroll
    for (int i = 0; i < kQBN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % kDStages;
      mbar_wait(ring.full(s), (it / kDStages) & 1);
      qstage_retire(ring.empty(), s, acc,
                    smem_desc(ring.a(s) + wg * 64 * kQBK),
                    smem_desc(ring.b(s)), lane);
    }

    // Epilogue into the half's buffer, where the mask landed. Fragment of
    // n8 block j: rows r, r + 8; cols 8j + 2t, + 1 (acc[4j + 2h + e]); in
    // the 128-byte swizzle (r, c) sits in box c / 64, row r, 16-byte chunk
    // ((c % 64) / 8) ^ (r % 8): the 32 lanes of a warp on 32 banks.
    mbar_wait(ring.ready(wg), tc & 1);
#pragma unroll
    for (int j = 0; j < kQBN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            e + (j >> 3) * kDBoxElems + (r + 8 * h) * 64 +
            ((((j & 7) ^ g) << 3) | (2 * t)));
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (kMask) {
          const float2 m = __bfloat1622float2(*p);
          v0 *= m.x > 0.f ? 1.f : 0.f;
          v1 *= m.y > 0.f ? 1.f : 0.f;
        }
        *p = __floats2bfloat162_rn(v0, v1);
      }
    }
    fence_proxy_async_shared();
    mbar_arrive(ring.done(wg));
  }
}

// ------------------------------------------------------------ bf16 wgrad
constexpr int kQPromoteStages = 2048 / kQBK;   // wgrad: partial every 2,048

// bf16 wgrad: split z of N (rows [z rows_per_split, + rows_per_split) of
// act and dz): part_w[z] (+)= act^T dz on the block's 128 x kQBN tile (rows
// m0.. of act's columns, columns n0.. of dz's) and, from the blocks of the
// first tile row, part_b[z][c] = the sum of dz[k][c], in f32.
__global__ void __launch_bounds__(kHThreads, 1)
k1_bf16_wgrad_kernel(const __grid_constant__ CUtensorMap tm_act,
                     const __grid_constant__ CUtensorMap tm_dz, float* part_w,
                     float* part_b, int n, int d, int rows_per_split) {
  extern __shared__ unsigned char smem_raw[];
  const QRing ring = qring_init(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int n0 = blockIdx.x * kQBN, m0 = blockIdx.y * kHBM;
  const long long k_begin = (long long)blockIdx.z * rows_per_split;
  const long long k_end = k_begin + rows_per_split < n
                              ? k_begin + rows_per_split : (long long)n;
  const int stages = (int)((k_end - k_begin + kQBK - 1) / kQBK);

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 8) return;
    for (int p = 0; p < stages; ++p) {
      const int s = p % kQStages;
      mbar_wait(&ring.empty[s], ((p / kQStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(&ring.full[s], kQStageBytes);
        const int k0 = (int)(k_begin + (long long)p * kQBK);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          tma_load(ring.a(s) + q * kQBoxElems, &tm_act, &ring.full[s],
                   m0 + 64 * q, k0, 0);
#pragma unroll
        for (int q = 0; q < kQBN / 64; ++q)
          tma_load(ring.b(s) + q * kQBoxElems, &tm_dz, &ring.full[s],
                   n0 + 64 * q, k0, 0);
      }
      __syncwarp();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = lane / 4, t = lane % 4;
    const int r_lo = wg * 64 + (warp % 4) * 16 + g;
    // db: consumer thread c sums dz column c of the tile over each stage's
    // rows; (k, c) of the MN-major dz boxes sits at box c / 64, row k,
    // 16-byte chunk ((c % 64) / 8) ^ (k % 8)
    static_assert(kQBN == 256, "one consumer thread a column");
    const int c = threadIdx.x, cc = c & 63;
    const bool db_block = blockIdx.y == 0;
    float* pw = part_w + (long long)blockIdx.z * d * d;
    float acc[kQBN / 2];
    float col = 0.f;
    int it = 0;
    for (int c0 = 0; c0 < stages; c0 += kQPromoteStages) {
      const int nst = min(kQPromoteStages, stages - c0);
#pragma unroll
      for (int i = 0; i < kQBN / 2; ++i) acc[i] = 0.f;
      for (int st = 0; st < nst; ++st, ++it) {
        const int s = it % kQStages;
        mbar_wait(&ring.full[s], (it / kQStages) & 1);
        if (db_block) {
          const bf16* B = ring.b(s) + (c >> 6) * kQBoxElems;
#pragma unroll 8
          for (int k = 0; k < kQBK; ++k) {
            col += __bfloat162float(
                B[k * 64 + ((((cc >> 3) ^ (k & 7)) << 3) | (cc & 7))]);
          }
        }
        const uint64_t da = smem_desc_mn(ring.a(s) + wg * kQBoxElems);
        const uint64_t db = smem_desc_mn(ring.b(s));
        qstage<1, 1>(ring, acc, it, da, db, st == 0, lane);
      }
      qdrain(ring, acc, it, lane);
      // the partial (+)= this run's sum, in run order
#pragma unroll
      for (int j = 0; j < kQBN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* p = reinterpret_cast<float2*>(
              pw + (long long)(m0 + r_lo + 8 * h) * d + n0 + 8 * j + 2 * t);
          float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          if (c0 > 0) {
            const float2 o = *p;
            v = make_float2(o.x + v.x, o.y + v.y);
          }
          *p = v;
        }
      }
    }
    if (db_block) part_b[(long long)blockIdx.z * d + n0 + c] = col;
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int launch_bf16_fwd(const void* x, const void* w, const void* b, void* out,
                    void* tmp, void* saved, int n, int d, int n_layers,
                    int last_relu, cudaStream_t stream) {
  if (n <= 0 || d <= 0 || d % kQBN != 0 || n_layers <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_layers > 1 && tmp == nullptr && saved == nullptr)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm[5] = {};
  cudaError_t err = encode(&tm[0], x, d, n, 1, kHBM, true);
  if (err == cudaSuccess) err = encode(&tm[1], out, d, n, 1, kHBM, true);
  if (err == cudaSuccess)
    err = encode(&tm[2], tmp != nullptr ? tmp : out, d, n, 1, kHBM, true);
  if (err == cudaSuccess)
    err = encode(&tm[3], saved != nullptr ? saved : out, d, n,
                 saved != nullptr ? n_layers - 1 : 1, kHBM, true);
  // W [L, in, out] in MN-major boxes of [64 in, 64 out]
  if (err == cudaSuccess) err = encode(&tm[4], w, d, d, n_layers, kQBK, true);
  if (err == cudaSuccess) err = set_smem(k1_bf16_fwd_kernel, kQSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + kHBM - 1) / kHBM);
  k1_bf16_fwd_kernel<<<grid, kHThreads, kQSmem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], static_cast<const bf16*>(b),
      static_cast<bf16*>(out), static_cast<bf16*>(tmp),
      static_cast<bf16*>(saved), n, d, n_layers, last_relu);
  return (int)cudaGetLastError();
}

// One block a SM (or a tile, if fewer), each walking its tiles.
template <bool kMask>
int launch_bf16_dgrad(const CUtensorMap (&tm)[4], int n, int d, int device,
                      cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = set_smem(k1_bf16_dgrad_kernel<kMask>, kDSmem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((n + kHBM - 1) / kHBM) * (d / kQBN);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  k1_bf16_dgrad_kernel<kMask><<<grid, kHThreads, kDSmem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], n, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every array contiguous, 16-byte aligned, on `device`; d a multiple of
// 128 (the f32 dgrad's output width and an entry layer's input width k of
// 4). Each entry point launches on `stream` without synchronising and
// returns the cudaError_t of the launch (0 = launched).

// f32 forward: x [n, k]; w_big_t, w_small_t the transposed split of the
// square layers' W ([out, in], from snerf_tf32_split): [n_layers, d, d]
// when w0_big_t is null (then k = d), else [n_layers - 1, d, d] (null
// when n_layers is 1) after the entry layer's w0_big_t, w0_small_t [d,
// k]; b [n_layers, d]; out [n, d] and, when n_layers > 1, either the
// scratch tmp [n, d] or saved [n_layers - 1, n, d], which then keeps
// every layer's output but the last (tmp is not used); out, tmp and saved
// distinct from x and each other.
int snerf_fused_mlp_fwd_f32(const void* x, const void* w0_big_t,
                            const void* w0_small_t, const void* w_big_t,
                            const void* w_small_t, const void* b, void* out,
                            void* tmp, void* saved, int n, int k, int d,
                            int n_layers, int last_relu, int device,
                            void* stream) {
  if (w0_big_t == nullptr) {
    w0_big_t = w_big_t;
    w0_small_t = w_small_t;
  } else if (w_big_t == nullptr && n_layers != 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (w0_big_t == nullptr || w0_small_t == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_wgmma<false>(x, w0_big_t, w0_small_t, w_big_t, w_small_t, b,
                             out, tmp, saved, n, k, d, n_layers, last_relu,
                             static_cast<cudaStream_t>(stream));
}

// bf16 forward: x [n, d], w [n_layers, d, d] ([in, out]), b [n_layers,
// d]; out [n, d] and, when n_layers > 1, either tmp [n, d] or saved
// [n_layers - 1, n, d] (every layer's output but the last), as the f32
// forward takes them.
int snerf_fused_mlp_fwd_bf16(const void* x, const void* w, const void* b,
                             void* out, void* tmp, void* saved, int n, int d,
                             int n_layers, int last_relu, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_bf16_fwd(x, w, b, out, tmp, saved, n, d, n_layers, last_relu,
                         static_cast<cudaStream_t>(stream));
}

// The 3xTF32 split of w [n_layers, rows, cols]: big_t, small_t [n_layers,
// cols, rows], transposed per layer, and, unless both are null, big,
// small in w's layout.
int snerf_tf32_split(const void* w, void* big, void* small, void* big_t,
                     void* small_t, int n_layers, int rows, int cols,
                     int device, void* stream) {
  if (rows <= 0 || cols <= 0 || rows > 65535 * 32 || n_layers <= 0 ||
      n_layers > 65535 || (big == nullptr) != (small == nullptr) ||
      big_t == nullptr || small_t == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  tf32_split_kernel<<<dim3((cols + 31) / 32, (rows + 31) / 32, n_layers),
                      dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(big),
      static_cast<float*>(small), static_cast<float*>(big_t),
      static_cast<float*>(small_t), rows, cols);
  return (int)cudaGetLastError();
}

// The f32 backward's three kernels.
//
// dgrad: out [n, k] = (dz [n, d] W^T) * (mask [n, k] > 0), W [k, d]
// ([in, out]) given as its split w_big, w_small (snerf_tf32_split, not
// transposed); k = d for a square layer, an entry layer's input width
// (a multiple of 4) for its dx; mask may be null (no mask). out distinct
// from dz.
int snerf_fused_mlp_bwd_dgrad(const void* dz, const void* w_big,
                              const void* w_small, const void* mask,
                              void* out, int n, int d, int k, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch_wgmma<true>(dz, w_big, w_small, w_big, w_small, mask, out,
                            nullptr, nullptr, n, d, k, 1, 0,
                            static_cast<cudaStream_t>(stream));
}

// wgrad: the partials of dW = act^T dz and db = colsum(dz) over `splits`
// runs of rows_per_split rows (a multiple of 32, splits * rows_per_split
// >= n): act [n, m] (m = d, or an entry layer's input width, a multiple of
// 4), dz [n, d]; part_w [splits, m, d]; part_b [splits, d].
int snerf_fused_mlp_bwd_wgrad(const void* act, const void* dz, void* part_w,
                              void* part_b, int n, int m, int d,
                              int rows_per_split, int splits, int device,
                              void* stream) {
  if (d <= 0 || d % kHBN != 0 || m <= 0 || m % 4 != 0 || n <= 0 ||
      rows_per_split <= 0 || rows_per_split % kHBK != 0 || splits <= 0 ||
      splits > 65535 || (long long)splits * rows_per_split < n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  CUtensorMap tm[2] = {};
  if (err == cudaSuccess) err = encode(&tm[0], act, m, n, 1, 32);
  if (err == cudaSuccess) err = encode(&tm[1], dz, d, n, 1, 32);
  if (err == cudaSuccess) err = set_smem(fused_mlp_bwd_wgrad_kernel, kWSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d / kHBN, (m + kHBM - 1) / kHBM, splits);
  fused_mlp_bwd_wgrad_kernel<<<grid, kWThreads, kWSmem,
                               static_cast<cudaStream_t>(stream)>>>(
      tm[0], tm[1], static_cast<float*>(part_w), static_cast<float*>(part_b),
      n, m, d, rows_per_split);
  return (int)cudaGetLastError();
}

// reduce: dw [m, d] and db [d] = the sums over s of part_w[s] [m, d] and
// part_b[s] [d].
int snerf_fused_mlp_bwd_reduce(const void* part_w, const void* part_b,
                               void* dw, void* db, int m, int d, int splits,
                               int device, void* stream) {
  if (m <= 0 || d <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)m * d + d;
  const unsigned grid = (unsigned)((total + 255) / 256);
  fused_mlp_bwd_reduce_kernel<<<grid, 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_w), static_cast<const float*>(part_b),
      static_cast<float*>(dw), static_cast<float*>(db), m, d, splits);
  return (int)cudaGetLastError();
}

// The bf16 backward (wgmma on bf16 operands, no split).
//
// dgrad: out [n, d] = bf16((dz [n, d] W^T) * (mask [n, d] > 0)), W [d, d]
// ([in, out]) bf16; mask may be null (no mask). out distinct from dz and
// the mask.
int snerf_fused_mlp_bwd_dgrad_bf16(const void* dz, const void* w,
                                   const void* mask, void* out, int n, int d,
                                   int device, void* stream) {
  if (n <= 0 || d <= 0 || d % kQBN != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  // dz in [128, 64] boxes; W's K-major tile [kQBN in, 64 out]; the mask
  // and out in the epilogue's [64, 64] boxes
  CUtensorMap tm[4] = {};
  if (err == cudaSuccess) err = encode(&tm[0], dz, d, n, 1, kHBM, true);
  if (err == cudaSuccess) err = encode(&tm[1], w, d, d, 1, kQBN, true);
  if (err == cudaSuccess && mask != nullptr)
    err = encode(&tm[2], mask, d, n, 1, 64, true);
  if (err == cudaSuccess) err = encode(&tm[3], out, d, n, 1, 64, true);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mask != nullptr ? launch_bf16_dgrad<true>(tm, n, d, device, s)
                         : launch_bf16_dgrad<false>(tm, n, d, device, s);
}

// wgrad: the f32 partials of dW = act^T dz and db = colsum(dz) over
// `splits` runs of rows_per_split rows (a multiple of 64): act, dz [n, d]
// bf16; part_w [splits, d, d] and part_b [splits, d] f32, summed by
// snerf_fused_mlp_bwd_reduce.
int snerf_fused_mlp_bwd_wgrad_bf16(const void* act, const void* dz,
                                   void* part_w, void* part_b, int n, int d,
                                   int rows_per_split, int splits, int device,
                                   void* stream) {
  if (d <= 0 || d % kQBN != 0 || n <= 0 || rows_per_split <= 0 ||
      rows_per_split % kQBK != 0 || splits <= 0 || splits > 65535 ||
      (long long)splits * rows_per_split < n)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  CUtensorMap tm[2] = {};
  if (err == cudaSuccess) err = encode(&tm[0], act, d, n, 1, kQBK, true);
  if (err == cudaSuccess) err = encode(&tm[1], dz, d, n, 1, kQBK, true);
  if (err == cudaSuccess) err = set_smem(k1_bf16_wgrad_kernel, kQSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d / kQBN, d / kHBM, splits);
  k1_bf16_wgrad_kernel<<<grid, kHThreads, kQSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      tm[0], tm[1], static_cast<float*>(part_w), static_cast<float*>(part_b),
      n, d, rows_per_split);
  return (int)cudaGetLastError();
}

const char* snerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
