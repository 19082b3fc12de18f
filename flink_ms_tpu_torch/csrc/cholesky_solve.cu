// Batched SPD solve x = A^-1 b for n independent k x k systems, one warp
// per system.
//
// Replaces the two Pallas TPU kernels of flink_ms_tpu/ops/cholesky_pallas.py,
// _solve_kernel (lane-major operands) and _solve_kernel_batch_major: they
// compute the same function and differ only in the operand layout the TPU's
// lanes want.  Here both reach this one kernel on batch-major operands:
// A (n, k, k), b (n, k) -> x (n, k), all f32, k in [1, 128].
//
// What bounds it on an H100: the work is memory-bound.  The least traffic
// reads A and b once and writes x once, n (k^2 + 2k) 4 B: 1.41 GB for the
// ML-20M user side (n = 138,494, k = 50), 0.42 ms at 3.35 TB/s, against
// about 0.2 ms of f32 arithmetic (n k^3 / 3 multiply-adds).
//
// What the design does about it: each system is read from device memory
// once, with coalesced 16-byte loads when k*k is a multiple of 4, into
// shared memory, and never leaves it until x is written.  The factorisation
// (right-looking Cholesky by k rank-1 downdates, the same elimination as the
// TPU kernel) and the forward and back substitutions run on that copy.  The
// row stride in shared memory is odd (k | 1), so the 32 lanes, each on its
// own row, hit 32 different banks.  Several warps share a block; at k = 50
// that is 8 warps and 83 KB of dynamic shared memory, set through
// cudaFuncSetAttribute above 48 KB.  The ragged batch tail is masked by n, so
// no identity padding is needed.  The downdate's shared-memory traffic, not
// device memory, limits this simple version: keeping rows in registers and
// using the tensor cores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxK = 128;
constexpr int kMaxWarps = 8;
constexpr size_t kBlockSmemBudget = 96 * 1024;  // two blocks per SM

__host__ __device__ inline int row_stride(int k) { return k | 1; }

__host__ __device__ inline size_t warp_floats(int k) {
  return (size_t)k * row_stride(k) + k;  // the system, then its right side
}

__global__ void cholesky_solve_kernel(const float* __restrict__ A,
                                      const float* __restrict__ b,
                                      float* __restrict__ x, long long n,
                                      int k, int vec4) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const long long sys = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (sys >= n) return;  // whole warps leave; no block-wide barrier follows
  const int ld = row_stride(k);
  float* M = smem + (size_t)warp * warp_floats(k);
  float* r = M + (size_t)k * ld;  // b, overwritten by z, then by x

  const long long kk = (long long)k * k;
  const float* Ag = A + sys * kk;
  if (vec4) {
    const float4* A4 = reinterpret_cast<const float4*>(Ag);
    for (int q = lane; q < (int)(kk >> 2); q += kWarp) {
      const float4 v = A4[q];
      const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = 4 * q + t;
        const int i = e / k;
        M[i * ld + (e - i * k)] = vals[t];
      }
    }
  } else {
    for (int e = lane; e < (int)kk; e += kWarp) {
      const int i = e / k;
      M[i * ld + (e - i * k)] = Ag[e];
    }
  }
  for (int i = lane; i < k; i += kWarp) r[i] = b[sys * k + i];
  __syncwarp();

  // Factor in place: column j of L = column j of M scaled by rsqrt(M[j][j]),
  // then the trailing lower triangle loses the rank-1 product of that column.
  for (int j = 0; j < k; ++j) {
    const float d = rsqrtf(M[j * ld + j]);
    __syncwarp();  // every lane has read the pivot before it is scaled
    for (int i = j + lane; i < k; i += kWarp) M[i * ld + j] *= d;
    __syncwarp();
    for (int i = j + 1 + lane; i < k; i += kWarp) {
      const float lij = M[i * ld + j];
      float* Mi = M + i * ld;
      for (int c = j + 1; c <= i; ++c) Mi[c] -= lij * M[c * ld + j];
    }
    __syncwarp();
  }

  // Forward solve L z = b, one column of L at a time.
  for (int j = 0; j < k; ++j) {
    const float zj = r[j] / M[j * ld + j];
    __syncwarp();
    if (lane == 0) r[j] = zj;
    for (int i = j + 1 + lane; i < k; i += kWarp) r[i] -= M[i * ld + j] * zj;
    __syncwarp();
  }
  // Back solve L^T x = z, folding row j of L into the entries above it.
  for (int j = k - 1; j >= 0; --j) {
    const float xj = r[j] / M[j * ld + j];
    __syncwarp();
    if (lane == 0) r[j] = xj;
    for (int i = lane; i < j; i += kWarp) r[i] -= M[j * ld + i] * xj;
    __syncwarp();
  }
  for (int i = lane; i < k; i += kWarp) x[sys * k + i] = r[i];
}

}  // namespace

// C entry: launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers to
// contiguous f32 arrays; A must be 16-byte aligned for the vector loads.
extern "C" int cholesky_solve_f32(const float* A, const float* b, float* x,
                                  long long n, int k, void* stream) {
  if (k < 1 || k > kMaxK || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const size_t per_warp = warp_floats(k) * sizeof(float);
  int warps = (int)(kBlockSmemBudget / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = (size_t)warps * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cholesky_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec4 = ((k * k) % 4 == 0) && ((uintptr_t)A % 16 == 0);
  const long long blocks = (n + warps - 1) / warps;
  cholesky_solve_kernel<<<(unsigned)blocks, warps * kWarp, smem,
                          (cudaStream_t)stream>>>(A, b, x, n, k, vec4);
  return (int)cudaGetLastError();
}
