// Round-start margins of the CoCoA gram engine: one gather of the weight
// vector fused into each example's row sum.
//
// Replaces the Pallas TPU kernel margin_gather in
// flink_ms_tpu/ops/svm_kernels.py.  For every row r of the blocked sparse
// layout (r runs over the C chains x H rows of each chain, flattened) with
// L padded slots idx[r, :], val[r, :]:
//   out[r] = sum_l w[idx[r, l]] * val[r, l]
// in f32.  Pad slots carry val 0 (and idx 0), so they add nothing; an index
// outside [0, d) reads nothing and adds nothing.
//
// What bounds it on an H100: bytes.  Each of idx and val is read once
// (197 MB each at the RCV1 shape: C 8,192, H 86, L 70), against 2 flops per
// entry; at 3.35 TB/s that is about 0.12 ms, and the 189 KB weight vector
// and the (C, H) output add little.
//
// What the design does about it: the TPU kernel keeps w resident in VMEM
// and feeds the gather straight into the reduction, so the (C, H, L)
// gathered transient never reaches device memory.  Here one warp owns one
// row: its lanes stride over L, so each pass loads 32 consecutive idx and
// val entries (coalesced), w is read through the read-only path and stays
// in the 50 MB L2 (the card's counterpart of "w VMEM-resident"), and the
// row sum ends in a warp-shuffle tree.  Nothing is written but out.  Wider
// loads and several rows per warp for short L are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
margin_gather_kernel(const float* __restrict__ w, long long d,
                     const int* __restrict__ idx,
                     const float* __restrict__ val, long long rows, int L,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int* irow = idx + row * L;
  const float* vrow = val + row * L;
  float acc = 0.f;
  for (int l = lane; l < L; l += 32) {
    const int f = irow[l];
    const float v = vrow[l];
    if (f >= 0 && f < d) acc += __ldg(w + f) * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc;
}

}  // namespace

// C entry: launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError() (0 on success).  w is f32 (d,); idx int32 and val f32
// are (rows, L); out is f32 (rows,).  All arrays are contiguous device
// memory.
extern "C" int margin_gather_f32(const float* w, long long d, const int* idx,
                                 const float* val, long long rows, int L,
                                 float* out, void* stream) {
  if (d < 0 || rows < 0 || L < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows == 0) return 0;
  if (L == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)rows * sizeof(float), s);
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  margin_gather_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
      w, d, idx, val, rows, L, out);
  return (int)cudaGetLastError();
}
