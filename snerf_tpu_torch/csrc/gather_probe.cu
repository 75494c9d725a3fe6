// The gather probes P1 and P2, for Hopper (sm_90a).
//
// P1 replaces scripts/probe_gather.py `run` (`kernel_lane`, `kernel_sub`):
// take_along_axis along the last or the first axis of x [S, L],
//   axis 1: out[s, l] = x[s, idx[s, l]]      axis 0: out[s, l] = x[idx[s, l], l]
// idx int32 [S, L] with values in [0, L) or [0, S). On the TPU the probe
// asked whether the vreg gather addresses the full lane or sublane range
// of a VMEM tile; the card has no such limit, and its question is the
// gather rate by axis and width. One kernel serves both axes: the axis's
// stride (1 or L) and extent (L or S) are arguments, and neighbouring
// threads take neighbouring outputs, so the index loads and output stores
// are coalesced and only the source reads scatter (within a row of L
// floats for axis 1, down a column for axis 0). Bound by device-memory
// bytes: an index read and an output write per element, plus the source
// reads, which hit L2 when x fits it.
//
// P2 replaces scripts/probe_hash_ops.py `f7` (`kern`): the gather-select
// from a small dense table, out[c, q] = tab[c, idx[c, q]], tab [C <= 8, T]
// f32, idx int32 [C, Q]. The TPU kernel resolved each query vreg with one
// in-vreg gather and a select per 128-row block of the VMEM-resident
// table, at a cost that grows with T. Here a block takes one channel and
// one tile of 2,048 of its queries: it copies only that channel's row of
// the table into shared memory (T * 4 bytes, 19.5 KB at T = 4,992; up to
// 227 KB, T <= 58,112), with float4 loads where the row is aligned, then
// resolves its queries there with one shared-memory load each: no select
// loop, cost flat in T up to the shared-memory limit. A thread takes 4
// consecutive queries at a time, with one int4 index load and one float4
// store where the rows of idx and out are 16-byte aligned. The first
// design copied the whole [C, T] table into every block (160 KB: one
// 1,024-thread block an SM, no gather before its copy ended) and queried
// the device's attributes and occupancy on every call; the row a block
// and the values cached once per device remove both. The row copies are
// read from L2 (T * 4 bytes a block); the queries then stream: bound by
// the index reads and output writes, 8 bytes an output.
//
// Indices are trusted to lie in range; both kernels copy bits, so they
// are equal to their plain versions. Loops are grid-stride, with 64-bit
// offsets wherever a size can pass 2^30.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kSelectThreads = 256;
constexpr int kSelectPerThread = 8;   // two groups of 4 queries
constexpr int kSelectTile = kSelectThreads * kSelectPerThread;

// I: the offset type, 32-bit where n allows it (a 64-bit division costs
// tens of instructions an element).
template <typename I>
__global__ void __launch_bounds__(kThreads)
take_along_axis_kernel(const float* __restrict__ x,
                       const int32_t* __restrict__ idx,
                       float* __restrict__ out, I n, I stride, I extent) {
  for (I q = (I)blockIdx.x * kThreads + threadIdx.x; q < n;
       q += (I)gridDim.x * kThreads) {
    const I pos = (q / stride) % extent;
    out[q] = __ldg(x + q + ((I)__ldg(idx + q) - pos) * stride);
  }
}

// One channel's row of tab in shared memory, then out[c, i] = row[idx[c,
// i]] for the block's tile of queries. kVec: the rows of idx and out are
// 16-byte aligned (q % 4 == 0 and aligned pointers).
template <bool kVec>
__global__ void __launch_bounds__(kSelectThreads)
gather_select_kernel(const float* __restrict__ tab,
                     const int32_t* __restrict__ idx,
                     float* __restrict__ out, int t, long long q) {
  extern __shared__ float row[];
  const int ch = blockIdx.y;
  const float* src = tab + (long long)ch * t;
  int start = 0;
  if (((uintptr_t)src & 15) == 0) {
    start = t & ~3;
    for (int i = threadIdx.x; i < start / 4; i += kSelectThreads)
      reinterpret_cast<float4*>(row)[i] =
          __ldg(reinterpret_cast<const float4*>(src) + i);
  }
  for (int i = start + threadIdx.x; i < t; i += kSelectThreads)
    row[i] = __ldg(src + i);
  __syncthreads();
  const int32_t* ip = idx + (long long)ch * q;
  float* op = out + (long long)ch * q;
#pragma unroll
  for (int r = 0; r < kSelectPerThread / 4; ++r) {
    const long long i = (long long)blockIdx.x * kSelectTile +
                        (long long)(r * kSelectThreads + threadIdx.x) * 4;
    if (kVec && i + 4 <= q) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(ip + i));
      *reinterpret_cast<float4*>(op + i) =
          make_float4(row[v.x], row[v.y], row[v.z], row[v.w]);
    } else {
      for (long long j = i; j < i + 4 && j < q; ++j) op[j] = row[__ldg(ip + j)];
    }
  }
}

constexpr int kMaxDevices = 64;

// The device's SM count, cached (0 on failure).
int sm_count(int device) {
  static int sms[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 0;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    sms[device] = 0;
  return sms[device];
}

// The most shared memory a block may opt into on `device`, cached; the
// select kernels are opened up to it once (0 on failure).
int select_smem_bytes(int device) {
  static int bytes[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 0;
  if (bytes[device] == 0) {
    int b = 0;
    if (cudaDeviceGetAttribute(&b, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device) != cudaSuccess ||
        cudaFuncSetAttribute(gather_select_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             b) != cudaSuccess ||
        cudaFuncSetAttribute(gather_select_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             b) != cudaSuccess)
      return 0;
    bytes[device] = b;
  }
  return bytes[device];
}

// cudaSetDevice only when another device is current.
cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// x [s, l] f32, idx [s, l] int32, out [s, l] f32, contiguous, on
// `device`; axis 1 gathers along l (values in [0, l)), axis 0 along s
// (values in [0, s)). Returns the cudaError_t of the launch (0 =
// launched); does not synchronise.
int snerf_take_along_axis(const void* x, const void* idx, void* out,
                          long long s, long long l, int axis, int device,
                          void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (axis != 0 && axis != 1) return (int)cudaErrorInvalidValue;
  const long long n = s * l;
  if (n <= 0) return 0;
  const int sms = sm_count(device);
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * kBlocksPerSM) blocks = (long long)sms *
                                                       kBlocksPerSM;
  const float* xs = static_cast<const float*>(x);
  const int32_t* is = static_cast<const int32_t*>(idx);
  float* os = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long stride = axis == 1 ? 1 : l, extent = axis == 1 ? l : s;
  if (n < (1LL << 30))   // q + the grid's stride stays below 2^31
    take_along_axis_kernel<int><<<(unsigned)blocks, kThreads, 0, st>>>(
        xs, is, os, (int)n, (int)stride, (int)extent);
  else
    take_along_axis_kernel<long long><<<(unsigned)blocks, kThreads, 0, st>>>(
        xs, is, os, n, stride, extent);
  return (int)cudaGetLastError();
}

// The most table floats of one channel (t) a block can hold in shared
// memory.
int snerf_gather_select_max_floats(int device) {
  return select_smem_bytes(device) / (int)sizeof(float);
}

// tab [c, t] f32, idx [c, q] int32 with values in [0, t), out [c, q] f32,
// contiguous, on `device`, t * 4 bytes within the opt-in shared memory of
// a block. Returns the cudaError_t of the launch.
int snerf_gather_select(const void* tab, const void* idx, void* out, int c,
                        int t, long long q, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (c <= 0 || c > 65535 || t <= 0) return (int)cudaErrorInvalidValue;
  if (q <= 0) return 0;
  const size_t smem = (size_t)t * sizeof(float);
  const int max_bytes = select_smem_bytes(device);
  if (max_bytes == 0) return (int)cudaErrorInvalidDevice;
  if (smem > (size_t)max_bytes) return (int)cudaErrorInvalidValue;
  const long long tiles = (q + kSelectTile - 1) / kSelectTile;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)c);
  const bool vec = q % 4 == 0 && ((uintptr_t)idx | (uintptr_t)out) % 16 == 0;
  auto kernel = vec ? gather_select_kernel<true> : gather_select_kernel<false>;
  kernel<<<grid, kSelectThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), t, q);
  return (int)cudaGetLastError();
}

const char* snerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
