// Round-end weight update of the CoCoA gram engine: dw = X^T dalpha as one
// scatter-add of every entry's contribution into its feature's bin.
//
// Replaces the Pallas TPU kernel scatter_add_dw in
// flink_ms_tpu/ops/svm_kernels.py.  For n entries (the C chains x H rows x
// L slots, flattened) with feature idx[e] and contribution contrib[e] =
// val[e] * dalpha[row of e]:
//   out[f] = sum over e with idx[e] == f of contrib[e]
// in f32 (the caller divides by lambda * n).  Pad slots carry contrib 0;
// an index outside [0, d) adds nothing.
//
// What bounds it on an H100: bytes.  idx and contrib are read once (197 MB
// each at the RCV1 shape, 49,315,840 entries), against one add per entry;
// at 3.35 TB/s about 0.12 ms, and the (d,) output adds little.
//
// What the design does about it: the TPU kernel accumulates into a
// VMEM-resident (d,) buffer across sequential grid steps.  Blocks on the
// card run in no order, so the sum across blocks needs atomics.  When the
// whole (d,) accumulator fits a block's opt-in shared memory (227 KB on an
// H100, so d up to about 58,000; RCV1's 47,236 features take 189 KB), each
// block zeroes a private copy in shared memory, folds a grid-stride share of
// the entries into it with shared-memory atomics (coalesced loads of idx
// and contrib, random bins that rarely collide), then adds its non-zero
// bins to out with one global atomic each.  Above that size each entry goes
// to out with a global atomic, which the 50 MB L2 absorbs.  Both branches
// are in this file; the choice follows d and the device's shared memory.
// The sum order, and so the last bits of out, change from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kSharedThreads = 1024;
constexpr int kGlobalThreads = 256;

__global__ void __launch_bounds__(kSharedThreads)
scatter_add_shared_kernel(const int* __restrict__ idx,
                          const float* __restrict__ contrib, long long n,
                          int d, float* __restrict__ out) {
  extern __shared__ float acc[];
  for (int f = threadIdx.x; f < d; f += blockDim.x) acc[f] = 0.f;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int f = idx[e];
    if (f >= 0 && f < d) atomicAdd(&acc[f], contrib[e]);
  }
  __syncthreads();
  for (int f = threadIdx.x; f < d; f += blockDim.x) {
    const float v = acc[f];
    if (v != 0.f) atomicAdd(&out[f], v);
  }
}

__global__ void __launch_bounds__(kGlobalThreads)
scatter_add_global_kernel(const int* __restrict__ idx,
                          const float* __restrict__ contrib, long long n,
                          long long d, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int f = idx[e];
    if (f >= 0 && f < d) atomicAdd(&out[f], contrib[e]);
  }
}

cudaError_t device_limits(int* smem_optin, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(smem_optin,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

// The largest d that the shared-memory branch takes on the current device,
// written to *max_d.  Returns a CUDA error code (0 on success).
extern "C" int scatter_add_shared_max_d(long long* max_d) {
  int smem_optin = 0, sms = 0;
  const cudaError_t e = device_limits(&smem_optin, &sms);
  if (e != cudaSuccess) return (int)e;
  *max_d = smem_optin / (long long)sizeof(float);
  return 0;
}

// C entry: zeroes out and launches on `stream` (a cudaStream_t); returns
// cudaGetLastError() (0 on success).  idx int32 and contrib f32 hold n
// entries; out is f32 (d,).  All arrays are contiguous device memory.
extern "C" int scatter_add_f32(const int* idx, const float* contrib,
                               long long n, long long d, float* out,
                               void* stream) {
  if (n < 0 || d < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 0) return 0;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)d * sizeof(float), s);
  if (e != cudaSuccess || n == 0) return (int)e;
  int smem_optin = 0, sms = 0;
  e = device_limits(&smem_optin, &sms);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = (size_t)d * sizeof(float);
  if (bytes <= (size_t)smem_optin) {
    e = cudaFuncSetAttribute(scatter_add_shared_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_add_shared_kernel, kSharedThreads, bytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // every block zeroes and flushes all d bins, so no more blocks than
    // the entries can keep busy
    const long long want = (n + kSharedThreads - 1) / kSharedThreads;
    const long long cap = (long long)sms * per_sm;
    const int blocks = (int)(want < cap ? want : cap);
    scatter_add_shared_kernel<<<blocks, kSharedThreads, bytes, s>>>(
        idx, contrib, n, (int)d, out);
  } else {
    const long long want = (n + kGlobalThreads - 1) / kGlobalThreads;
    const long long cap = (long long)sms * 16;
    const int blocks = (int)(want < cap ? want : cap);
    scatter_add_global_kernel<<<blocks, kGlobalThreads, 0, s>>>(
        idx, contrib, n, d, out);
  }
  return (int)cudaGetLastError();
}
