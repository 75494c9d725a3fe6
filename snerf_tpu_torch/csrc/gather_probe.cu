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
// table, at a cost that grows with T. Here each block copies the whole
// table into shared memory (C * T * 4 bytes, up to 227 KB: T <= 7,264 at
// C = 8, 58,112 at C = 1), then resolves its share of the queries there
// with one shared-memory load each: no select loop, cost flat in T up to
// the shared-memory limit. The table copy is one read per block out of
// L2; the queries then stream: bound by the index reads and output
// writes, 8 bytes an output.
//
// Indices are trusted to lie in range; both kernels copy bits, so they
// are equal to their plain versions. Loops are grid-stride, with 64-bit
// offsets wherever a size can pass 2^30.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kSelectThreads = 1024;

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

__global__ void __launch_bounds__(kSelectThreads)
gather_select_kernel(const float* __restrict__ tab,
                     const int32_t* __restrict__ idx,
                     float* __restrict__ out, int c, int t, long long q) {
  extern __shared__ float smem[];
  const int n_tab = c * t;
  for (int i = threadIdx.x; i < n_tab; i += kSelectThreads)
    smem[i] = __ldg(tab + i);
  __syncthreads();
  for (long long i = (long long)blockIdx.x * kSelectThreads + threadIdx.x;
       i < q; i += (long long)gridDim.x * kSelectThreads) {
    for (int ch = 0; ch < c; ++ch)
      out[ch * q + i] = smem[ch * t + __ldg(idx + ch * q + i)];
  }
}

int sm_count(int device, int* sms) {
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     device);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (axis != 0 && axis != 1) return (int)cudaErrorInvalidValue;
  const long long n = s * l;
  if (n <= 0) return 0;
  int sms = 0;
  int e = sm_count(device, &sms);
  if (e != 0) return e;
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

// The most table floats (c * t) one block can hold in shared memory.
int snerf_gather_select_max_floats(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return bytes / (int)sizeof(float);
}

// tab [c, t] f32, idx [c, q] int32 with values in [0, t), out [c, q] f32,
// contiguous, on `device`, c * t * 4 bytes within the opt-in shared
// memory of a block. Returns the cudaError_t of the launch.
int snerf_gather_select(const void* tab, const void* idx, void* out, int c,
                        int t, long long q, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (c <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  if (q <= 0) return 0;
  const size_t smem = (size_t)c * t * sizeof(float);
  err = cudaFuncSetAttribute(gather_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  int e = sm_count(device, &sms);
  if (e != 0) return e;
  // every block copies the table once: as many blocks as fit the SMs
  long long blocks = (q + kSelectThreads - 1) / kSelectThreads;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gather_select_kernel, kSelectThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  gather_select_kernel<<<(unsigned)blocks, kSelectThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), c, t, q);
  return (int)cudaGetLastError();
}

const char* snerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
