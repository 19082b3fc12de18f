// Fused gather + normal-equation assembly for one ALS degree bucket.
//
// Replaces the Pallas TPU kernel fused_bucket_assembly in
// flink_ms_tpu/ops/gather_assembly.py.  For bucket row r (one entity) with
// rating list idx[r, :], val[r, :] over the opposite factor table
// y_all (S, k):
//   explicit: A[r] = sum_w y y^T,            b[r] = sum_w v y
//   implicit: A[r] = sum_w alpha v y y^T,    b[r] = sum_w (1 + alpha v) y
// with y = y_all[idx[r, w]] cast to f32 first (y_all is f32 or bf16; the
// cast from bf16 is exact).  Pads point at the table's zero dummy slot and
// carry v = 0, so they add nothing; the kernel reads whatever row an index
// names (the dummy is an ordinary row) and treats an index outside [0, S)
// as a zero row.  Outputs are f32: A (r, k, k), symmetric, and b (r, k).
//
// What bounds it on an H100: arithmetic.  2 nnz_pad (k^2 + k) flops per
// half-sweep (about 102 GFLOP at 20M ratings and k = 50 before bucket
// padding, 1.5 ms at the card's 67 TFLOP/s of non-tensor f32; the parity
// contract rules out TF32), against the A write (0.42 ms on the ML-20M user
// side) and one read of idx, val and the table.
//
// What the design does about it: the TPU kernel accumulates across
// sequential grid steps; blocks here run in no order, so one block owns one
// bucket row and loops over its whole rating list itself - no atomics, no
// second pass.  In chunks of 32 ratings the block gathers the factor rows
// through L2 (the whole ML-20M item table, 5.3 MB, and user table, 27.7 MB
// f32, fit the 50 MB L2) into shared memory as f32, beside the per-rating
// weights.  Each thread owns 4x4 micro-tiles of the lower triangle of A and
// keeps them in registers across the whole list (one tile per thread at
// k = 50: 91 tiles over 128 threads), so per rating it does two 16-byte
// shared loads for 16 multiply-adds, and the (r, w, k) gather never reaches
// device memory.  At the end the block writes the full symmetric A and b
// once.  Double-buffered gathers (cp.async / TMA) and tensor cores are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;  // ratings staged in shared memory per pass
constexpr int kMaxK = 128;
constexpr int kMaxTilesPerThread = 5;  // (32 * 33 / 2) tiles at k = 128

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int TPT>
__global__ void __launch_bounds__(kThreads)
gather_assembly_kernel(const T* __restrict__ y_all, long long S, int k,
                       const int* __restrict__ idx,
                       const float* __restrict__ val, int w, int implicit,
                       float alpha, float* __restrict__ A,
                       float* __restrict__ b) {
  __shared__ __align__(16) float ys[kChunk][kMaxK];
  __shared__ float wa[kChunk];  // weight of the rating in A
  __shared__ float wb[kChunk];  // weight of the rating in b
  __shared__ long long slot[kChunk];

  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int kp = (k + 3) & ~3;  // k padded to the 4-wide micro-tile
  const int nt = kp / 4;
  const int ntiles = nt * (nt + 1) / 2;

  // This thread's micro-tiles (tp >= tq) of the lower triangle.
  int tp[TPT], tq[TPT];
#pragma unroll
  for (int t = 0; t < TPT; ++t) {
    const int lin = tid + t * kThreads;
    if (lin < ntiles) {
      int p = 0;
      while ((p + 1) * (p + 2) / 2 <= lin) ++p;
      tp[t] = p;
      tq[t] = lin - p * (p + 1) / 2;
    } else {
      tp[t] = -1;
      tq[t] = 0;
    }
  }
  float acc[TPT][4][4];
#pragma unroll
  for (int t = 0; t < TPT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;
  float bacc = 0.f;  // thread tid < k owns b[tid]

  const int* irow = idx + row * w;
  const float* vrow = val + row * w;
  for (int c0 = 0; c0 < w; c0 += kChunk) {
    const int cn = min(kChunk, w - c0);
    if (tid < kChunk) {
      long long s = -1;
      float a_w = 0.f, b_w = 0.f;
      if (tid < cn) {
        const long long sl = irow[c0 + tid];
        const float v = vrow[c0 + tid];
        if (sl >= 0 && sl < S) s = sl;
        if (implicit) {
          a_w = alpha * v;
          b_w = 1.f + alpha * v;
        } else {
          a_w = 1.f;
          b_w = v;
        }
      }
      slot[tid] = s;
      wa[tid] = a_w;
      wb[tid] = b_w;
    }
    __syncthreads();
    for (int e = tid; e < cn * kp; e += kThreads) {
      const int c = e / kp;
      const int col = e - c * kp;
      const long long s = slot[c];
      ys[c][col] = (s >= 0 && col < k) ? to_f32(y_all[s * k + col]) : 0.f;
    }
    __syncthreads();
    // b sums each chunk apart before adding it in: a long sequential f32
    // sum of same-signed terms loses about twice the digits of cuBLAS's
    // blocked one, and the ALS systems amplify that error by their
    // condition number
    float bpart = 0.f;
    for (int c = 0; c < cn; ++c) {
      const float a_w = wa[c];
#pragma unroll
      for (int t = 0; t < TPT; ++t) {
        if (tp[t] >= 0) {
          const float4 yp = *reinterpret_cast<const float4*>(&ys[c][4 * tp[t]]);
          const float4 yq = *reinterpret_cast<const float4*>(&ys[c][4 * tq[t]]);
          const float p[4] = {yp.x * a_w, yp.y * a_w, yp.z * a_w, yp.w * a_w};
          const float q[4] = {yq.x, yq.y, yq.z, yq.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[t][i][j] += p[i] * q[j];
        }
      }
      if (tid < k) bpart += ys[c][tid] * wb[c];
    }
    bacc += bpart;
    __syncthreads();  // the next chunk overwrites ys
  }

  float* Ar = A + row * k * k;
#pragma unroll
  for (int t = 0; t < TPT; ++t) {
    if (tp[t] < 0) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 4 * tp[t] + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 4 * tq[t] + j;
        // a diagonal tile writes its lower half and mirrors it, so A is
        // exactly symmetric
        if (p < k && q < k && q <= p) {
          Ar[p * k + q] = acc[t][i][j];
          Ar[q * k + p] = acc[t][i][j];
        }
      }
    }
  }
  if (tid < k) b[row * k + tid] = bacc;
}

template <typename T>
cudaError_t launch(const void* y_all, long long S, int k, const int* idx,
                   const float* val, long long r, int w, int implicit,
                   float alpha, float* A, float* b, cudaStream_t stream) {
  const int nt = ((k + 3) & ~3) / 4;
  const int tpt = (nt * (nt + 1) / 2 + kThreads - 1) / kThreads;
  const T* y = static_cast<const T*>(y_all);
  const dim3 grid((unsigned)r);
  switch (tpt) {
#define FLINK_MS_CASE(N)                                                    \
  case N:                                                                   \
    gather_assembly_kernel<T, N><<<grid, kThreads, 0, stream>>>(            \
        y, S, k, idx, val, w, implicit, alpha, A, b);                       \
    break;
    FLINK_MS_CASE(1)
    FLINK_MS_CASE(2)
    FLINK_MS_CASE(3)
    FLINK_MS_CASE(4)
    FLINK_MS_CASE(5)
#undef FLINK_MS_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

static_assert(((kMaxK / 4) * (kMaxK / 4 + 1) / 2 + kThreads - 1) / kThreads <=
                  kMaxTilesPerThread,
              "micro-tile dispatch must cover k = kMaxK");

// C entry: launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError() (0 on success).  y_all is f32 (y_bf16 = 0) or bf16
// (y_bf16 = 1), shape (S, k); idx int32 and val f32 are (r, w); A (r, k, k)
// and b (r, k) are f32 outputs.  All arrays are contiguous device memory.
extern "C" int gather_assembly_f32(const void* y_all, int y_bf16, long long S,
                                   int k, const int* idx, const float* val,
                                   long long r, int w, int implicit,
                                   float alpha, float* A, float* b,
                                   void* stream) {
  if (k < 1 || k > kMaxK || w < 0 || r < 0 || r > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (r == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      y_bf16 ? launch<__nv_bfloat16>(y_all, S, k, idx, val, r, w, implicit,
                                     alpha, A, b, s)
             : launch<float>(y_all, S, k, idx, val, r, w, implicit, alpha, A,
                             b, s);
  return (int)e;
}
