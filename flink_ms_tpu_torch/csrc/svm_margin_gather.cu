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
// gathered transient never reaches device memory.  Here one persistent
// block of 32 warps per SM copies w into shared memory once (when its
// 4 d bytes fit, d up to 58,112; above that w is read through L1 and L2),
// so each gather is a shared-memory load.  The rows are not taken one by
// one: each warp streams a tile of whole rows as the flat (rows x L)
// arrays, 128 entries per line, each lane one 16-byte vector of idx and
// one of val.  A tile holds 128 / gcd(L, 128) rows, so its entries are a
// whole number of lines and every tile starts on the 16-byte grid: L = 70
// costs no ragged pass.  The next line's loads are issued before this
// line's gathers; the loads bypass L1 (streaming, evict-first), so w keeps
// L1 where it is not in shared memory.  The row sums come out of a
// segmented scan over the warp's lanes (the rows are runs of consecutive
// lanes): the lane that holds a row's last entry writes its sum, and a
// row that runs past the line carries over to the next one.  Nothing is
// written but out.  The host's plan (ops/svm_kernels.py margin_plan) sets
// the tile rows, the grid and the block size, which the kernel reads from
// the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace {

constexpr int kLine = 32 * 4;  // a warp's line: one 16-byte vector a lane
constexpr unsigned kFull = 0xffffffffu;

// entries e..e+3 of a tile (those at or past nent read as index -1)
template <bool kVec>
__device__ __forceinline__ void load4(const int* __restrict__ idx,
                                      const float* __restrict__ val,
                                      unsigned e, unsigned nent, int f[4],
                                      float v[4]) {
  if (kVec && e + 4 <= nent) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(idx + e));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(val + e));
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    v[0] = b.x, v[1] = b.y, v[2] = b.z, v[3] = b.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool in = e + q < nent;
    f[q] = in ? __ldcs(idx + e + q) : -1;
    v[q] = in ? __ldcs(val + e + q) : 0.f;
  }
}

// kSharedW: w is copied into shared memory first.  kVec: idx and val start
// on the 16-byte grid, so whole lines load as vectors.  One block of up to
// 1,024 threads per SM.
template <bool kSharedW, bool kVec>
__global__ void __launch_bounds__(1024, 1)
margin_gather_kernel(const float* __restrict__ w, long long d,
                     const int* __restrict__ idx,
                     const float* __restrict__ val, long long rows, int L,
                     int tile_rows, float* __restrict__ out) {
  extern __shared__ float ws[];
  if (kSharedW) {
    for (int i = threadIdx.x; i < d; i += blockDim.x) ws[i] = __ldg(w + i);
    __syncthreads();
  }
  const unsigned lane = threadIdx.x & 31;
  const unsigned uL = (unsigned)L;
  const long long warps = blockDim.x >> 5;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  for (long long t = blockIdx.x * warps + (threadIdx.x >> 5); t < tiles;
       t += gridDim.x * warps) {
    const long long row0 = t * tile_rows;
    const unsigned nrows =
        (unsigned)(rows - row0 < tile_rows ? rows - row0 : tile_rows);
    const unsigned nent = nrows * uL;
    const int lines = (int)((nent + kLine - 1) / kLine);
    const int* ti = idx + row0 * L;
    const float* tv = val + row0 * L;
    float* to = out + row0;
    int carry_row = -1;  // a row that runs on from the previous line
    float carry = 0.f;
    auto load_line = [&](int l, int f[4], float v[4]) {
      load4<kVec>(ti, tv, (unsigned)l * kLine + lane * 4,
                  l < lines ? nent : 0u, f, v);
    };
    int f[4];
    float p[4];
    load_line(0, f, p);
    for (int l = 0; l < lines; ++l) {
      // the next line's loads go out before this line's gathers
      int nf[4];
      float np[4];
      load_line(l + 1, nf, np);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = f[q];
        p[q] = (i >= 0 && i < d) ? (kSharedW ? ws[i] : __ldg(w + i)) * p[q]
                                 : 0.f;
      }
      const unsigned e = (unsigned)l * kLine + lane * 4;
      // the rows of this lane's four entries: rA holds the first, rB the
      // last; rows strictly between them lie wholly inside (L < 4)
      const unsigned rA = e / uL;
      unsigned m = e - rA * uL, r = rA;
      float cur = 0.f, first = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q > 0 && ++m == uL) {
          if (r == rA) first = cur;
          else if (r < nrows) to[r] = cur;
          cur = 0.f, m = 0, ++r;
        }
        cur += p[q];
      }
      const unsigned rB = r;
      if (rB == rA) first = cur;
      if (lane == 0 && (int)rA == carry_row) first += carry;
      // inclusive segmented scan of the part that may run on (key rB)
      float x = rB == rA ? first : cur;
      const unsigned prev_rB = __shfl_up_sync(kFull, rB, 1);
      int head = rA != rB || lane == 0 || prev_rB != rA;
#pragma unroll
      for (unsigned off = 1; off < 32; off <<= 1) {
        const float xo = __shfl_up_sync(kFull, x, off);
        const int ho = __shfl_up_sync(kFull, head, off);
        if (lane >= off) {
          if (!head) x += xo;
          head |= ho;
        }
      }
      // row rA ends inside this lane: its earlier part is the previous
      // lane's run
      const float xprev = __shfl_up_sync(kFull, x, 1);
      if (rA != rB && rA < nrows)
        to[rA] = first + (lane > 0 && prev_rB == rA ? xprev : 0.f);
      // row rB ends with this lane unless the next entry is in it
      const unsigned next_rA = __shfl_down_sync(kFull, rA, 1);
      const bool ends = lane < 31 ? next_rA != rB
                                  : l == lines - 1 || (e + 4) / uL != rB;
      if (ends && rB < nrows) to[rB] = x;
      carry = __shfl_sync(kFull, x, 31);
      carry_row = __shfl_sync(kFull, ends ? -1 : (int)rB, 31);
#pragma unroll
      for (int q = 0; q < 4; ++q) f[q] = nf[q], p[q] = np[q];
    }
  }
}

template <bool kSharedW, bool kVec>
cudaError_t launch(const float* w, long long d, const int* idx,
                   const float* val, long long rows, int L, int tile_rows,
                   int blocks, int threads, float* out, cudaStream_t s) {
  const size_t bytes = kSharedW ? (size_t)d * sizeof(float) : 0;
  if (kSharedW) {
    static size_t granted[kSmemAttrDevices];
    const cudaError_t e = allow_dynamic_smem(
        (const void*)margin_gather_kernel<kSharedW, kVec>, bytes, granted);
    if (e != cudaSuccess) return e;
  }
  margin_gather_kernel<kSharedW, kVec><<<blocks, threads, bytes, s>>>(
      w, d, idx, val, rows, L, tile_rows, out);
  return cudaGetLastError();
}

}  // namespace

// C entry: launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError() (0 on success).  w is f32 (d,); idx int32 and val f32
// are (rows, L); out is f32 (rows,).  The launch is the plan of
// ops/svm_kernels.py margin_plan, taken as given: tile_rows rows per warp
// tile (tile_rows x L a multiple of 128, so every tile starts on the
// 16-byte grid), shared_w 1 to copy w into shared memory (4 d bytes within
// the device's opt-in limit), `blocks` x `threads` the grid.  All arrays
// are contiguous device memory.
extern "C" int margin_gather_f32(const float* w, long long d, const int* idx,
                                 const float* val, long long rows, int L,
                                 int tile_rows, int shared_w, int blocks,
                                 int threads, float* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (rows == 0) return 0;
  if (L == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)rows * sizeof(float), s);
  const bool vec = (((uintptr_t)idx | (uintptr_t)val) & 15) == 0;
  cudaError_t e;
  if (shared_w)
    e = vec ? launch<true, true>(w, d, idx, val, rows, L, tile_rows, blocks,
                                 threads, out, s)
            : launch<true, false>(w, d, idx, val, rows, L, tile_rows, blocks,
                                  threads, out, s);
  else
    e = vec ? launch<false, true>(w, d, idx, val, rows, L, tile_rows, blocks,
                                  threads, out, s)
            : launch<false, false>(w, d, idx, val, rows, L, tile_rows, blocks,
                                   threads, out, s);
  return (int)e;
}
