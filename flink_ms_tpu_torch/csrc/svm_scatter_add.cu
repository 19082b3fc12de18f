// Round-end weight update of the CoCoA gram engine: dw = X^T dalpha as one
// scatter-add of every entry's contribution into its feature's bin.
//
// Replaces the Pallas TPU kernel scatter_add_dw in
// flink_ms_tpu/ops/svm_kernels.py.  For n entries (the C chains x H rows x
// L slots, flattened) with feature idx[e] and value vals[e]:
//   out[f] = sum over e with idx[e] == f of vals[e] * row_scale[e / L]
// in f32 (the caller divides by lambda * n).  With row_scale null each
// entry adds vals[e] itself, which is the TPU kernel's function; the gram
// engine passes the (C, H, L) values and the (C, H) dalpha, and each
// product is the same f32 product that val * dalpha[:, :, None] forms, so
// the (C, H, L) contribution never reaches device memory.  Pad slots carry
// value 0; an index outside [0, d) adds nothing.
//
// What bounds it on an H100: bytes.  idx and vals are read once (197 MB
// each at the RCV1 shape, 49,315,840 entries), against one add per entry;
// at 3.35 TB/s about 0.12 ms, and the (C, H) row_scale and the (d,) output
// add little.
//
// What the design does about it: the TPU kernel accumulates into a
// VMEM-resident (d,) buffer across sequential grid steps.  Blocks on the
// card run in no order, so the sum across blocks needs atomics.  When the
// whole (d,) accumulator fits a block's opt-in shared memory (227 KB on an
// H100, so d up to 58,112; RCV1's 47,236 features take 189 KB), one
// 1,024-thread block per SM zeroes a private copy in shared memory, folds
// a grid-stride share of the entries into it with shared-memory atomics,
// then adds its non-zero bins to out (zeroed first) with one global atomic
// each.  The shared-memory atomics (random bins, one block per SM) and the
// stream must overlap: each thread loads a 16-byte vector of idx and one
// of vals per step (streaming, evict-first), the next step's before this
// step's atomics,
// so 32 KB per SM are in flight while the atomics run; a scalar head and
// tail take the entries off the 16-byte grid.  With a row scale, each
// vector's row comes from one division and then counts on across its four
// entries, and the scale is read through L1.
// Above the shared-memory limit each entry goes to out with a global
// atomic, which the 50 MB L2 absorbs.  Both branches are in this file; the
// host's plan (ops/svm_kernels.py scatter_plan) picks one from d and the
// device's shared memory, and sets the grid and the block size, which the
// kernels read from the launch.  The sum order, and so the last bits of
// out, change from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attr.cuh"

namespace {

// e / L, exact: a double reciprocal, then one correction step
__device__ __forceinline__ long long row_of(long long e, int L, double inv_L) {
  long long r = (long long)((double)e * inv_L);
  if (r * L > e) --r;
  else if ((r + 1) * L <= e) ++r;
  return r;
}

// The entries [0, n) of idx and vals split over G threads (this one is g),
// each handed to add(feature, contribution).  `head` entries come before
// the first 16-byte vector of both arrays (n when their alignments differ:
// then every entry is loaded alone).
template <bool kScaled, class Add>
__device__ __forceinline__ void for_each_entry(
    const int* __restrict__ idx, const float* __restrict__ vals,
    const float* __restrict__ scale, long long n, int L, double inv_L,
    long long head, long long g, long long G, Add add) {
  auto scalar = [&](long long e) {
    float v = __ldcs(vals + e);
    if (kScaled) v *= __ldg(scale + row_of(e, L, inv_L));
    add(__ldcs(idx + e), v);
  };
  for (long long e = g; e < head; e += G) scalar(e);
  const long long nv = (n - head) / 4;
  const int4* iv = reinterpret_cast<const int4*>(idx + head);
  const float4* vv = reinterpret_cast<const float4*>(vals + head);
  auto load = [&](long long v, int4& a, float4& b) {
    if (v < nv) {
      a = __ldcs(iv + v);
      b = __ldcs(vv + v);
    }
  };
  int4 a = make_int4(0, 0, 0, 0);
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  load(g, a, b);
  for (long long v = g; v < nv; v += G) {
    // the next step's vectors are loaded before this step's adds
    int4 na = a;
    float4 nb = b;
    load(v + G, na, nb);
    float c[4] = {b.x, b.y, b.z, b.w};
    if (kScaled) {
      const long long e0 = head + 4 * v;
      long long r = row_of(e0, L, inv_L);
      int m = (int)(e0 - r * L);
      float s = __ldg(scale + r);
      c[0] *= s;
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        if (++m == L) {
          m = 0;
          s = __ldg(scale + ++r);
        }
        c[q] *= s;
      }
    }
    add(a.x, c[0]);
    add(a.y, c[1]);
    add(a.z, c[2]);
    add(a.w, c[3]);
    a = na;
    b = nb;
  }
  for (long long e = head + 4 * nv + g; e < n; e += G) scalar(e);
}

// d bins in shared memory, added to out (zeroed) when the block is done;
// one block of up to 1,024 threads per SM
template <bool kScaled>
__global__ void __launch_bounds__(1024, 1)
scatter_add_shared_kernel(const int* __restrict__ idx,
                          const float* __restrict__ vals,
                          const float* __restrict__ scale, long long n, int L,
                          double inv_L, long long head, int d,
                          float* __restrict__ out) {
  extern __shared__ float acc[];
  for (int f = threadIdx.x; f < d; f += blockDim.x) acc[f] = 0.f;
  __syncthreads();
  for_each_entry<kScaled>(
      idx, vals, scale, n, L, inv_L, head,
      (long long)blockIdx.x * blockDim.x + threadIdx.x,
      (long long)gridDim.x * blockDim.x, [&](int f, float v) {
        if ((unsigned)f < (unsigned)d) atomicAdd(acc + f, v);
      });
  __syncthreads();
  for (int f = threadIdx.x; f < d; f += blockDim.x) {
    const float v = acc[f];
    if (v != 0.f) atomicAdd(out + f, v);
  }
}

template <bool kScaled>
__global__ void scatter_add_global_kernel(const int* __restrict__ idx,
                                          const float* __restrict__ vals,
                                          const float* __restrict__ scale,
                                          long long n, int L, double inv_L,
                                          long long head, long long d,
                                          float* __restrict__ out) {
  for_each_entry<kScaled>(
      idx, vals, scale, n, L, inv_L, head,
      (long long)blockIdx.x * blockDim.x + threadIdx.x,
      (long long)gridDim.x * blockDim.x, [&](int f, float v) {
        if (f >= 0 && f < d) atomicAdd(out + f, v);
      });
}

template <bool kScaled>
cudaError_t launch(const int* idx, const float* vals, const float* scale,
                   long long n, int L, long long d, int shared, int blocks,
                   int threads, float* out, cudaStream_t s) {
  const double inv_L = kScaled ? 1.0 / L : 0.0;
  const uintptr_t ai = (uintptr_t)idx, av = (uintptr_t)vals;
  long long head =
      ((ai ^ av) & 15) ? n : (long long)((16 - (ai & 15)) & 15) / 4;
  if (head > n) head = n;
  if (!shared) {
    scatter_add_global_kernel<kScaled><<<blocks, threads, 0, s>>>(
        idx, vals, scale, n, L, inv_L, head, d, out);
    return cudaGetLastError();
  }
  static size_t granted[kSmemAttrDevices];
  const size_t bytes = (size_t)d * sizeof(float);
  const cudaError_t e = allow_dynamic_smem(
      (const void*)scatter_add_shared_kernel<kScaled>, bytes, granted);
  if (e != cudaSuccess) return e;
  scatter_add_shared_kernel<kScaled><<<blocks, threads, bytes, s>>>(
      idx, vals, scale, n, L, inv_L, head, (int)d, out);
  return cudaGetLastError();
}

}  // namespace

// C entry: zeroes out and launches on `stream` (a cudaStream_t); returns
// cudaGetLastError() (0 on success).  idx int32 and vals f32 hold n
// entries; row_scale is null or f32 (n / L,); out is f32 (d,).  The launch
// is the plan of ops/svm_kernels.py scatter_plan, taken as given: `shared`
// 1 keeps the accumulator in shared memory (4 d bytes within the device's
// opt-in limit), 0 adds into out with global atomics; `blocks` x
// `threads` is the grid.  All arrays are contiguous device memory.
extern "C" int scatter_add_f32(const int* idx, const float* vals,
                               const float* row_scale, long long n, int L,
                               long long d, int shared, int blocks,
                               int threads, float* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (d == 0) return 0;
  const cudaError_t e =
      cudaMemsetAsync(out, 0, (size_t)d * sizeof(float), s);
  if (e != cudaSuccess || n == 0) return (int)e;
  return (int)(row_scale ? launch<true>(idx, vals, row_scale, n, L, d, shared,
                                        blocks, threads, out, s)
                         : launch<false>(idx, vals, nullptr, n, L, d, shared,
                                         blocks, threads, out, s));
}
