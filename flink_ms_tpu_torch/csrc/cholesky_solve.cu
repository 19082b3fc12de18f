// Batched SPD solve x = A^-1 b for n independent k x k systems, one warp
// per system.
//
// Replaces the two Pallas TPU kernels of flink_ms_tpu/ops/cholesky_pallas.py,
// _solve_kernel (lane-major operands) and _solve_kernel_batch_major: they
// compute the same function and differ only in the operand layout the TPU's
// lanes want.  Here both reach this one kernel on batch-major operands:
// A (n, k, k), b (n, k) -> x (n, k), all f32, k in [1, 128].
//
// What bounds it on an H100: memory.  An SPD solve needs A's lower
// triangle, b and x: 0.93 GB of 32-byte sectors on the ML-20M user side
// (n = 138,494, k = 50), 0.28 ms at 3.35 TB/s, against 0.09 ms of f32
// arithmetic (n k^3 / 6 multiply-adds).  The issue slots of the
// elimination, not the bytes, are what a warp per system runs out of.
//
// What the design does about it (k <= 64, the register path):
// - Persistent warps: the grid fills the card once and each warp walks
//   over systems.  A system's lower triangle streams into the warp's
//   shared-memory stage with cp.async, 32 consecutive entries of the
//   triangle per instruction; the upper triangle is never read.  The next
//   system's copy starts as soon as the stage is free.
// - The system lives in registers.  Lane l holds rows l and l + 32, each
//   only as far as the longest row of its block of 32 reaches (k is padded
//   to a multiple of 4, KP, for the 16-byte column loads, one template per
//   KP; the pad is an identity block that is never eliminated).  Step j of the right-looking
//   factorisation puts column j, unscaled, in a shared vector while the
//   pivot is shuffled and inverted, and every lane updates its rows'
//   trailing entries from 16-byte broadcast loads of that vector: all lanes
//   busy, one __syncwarp per step.  The loops over j and the columns are
//   unrolled at compile time, so each step touches only the trailing
//   columns.
// - The forward substitution rides along the factorisation (b is an extra
//   column).  L goes to the stage as it is formed, and the back
//   substitution broadcasts each unknown by one shuffle while every lane
//   folds row j of L into its rows' sums.
// - The ragged batch tail is masked by n: no identity padding of A.
// What still holds it back (PERF.md): the factorisation takes most of the
// time.  Neither shared-memory bandwidth nor the stream of systems limits
// it: starting the next system's copy before the factorisation (L kept
// apart from the stage) measured no faster, the other warps already hide
// the copies.  Left are the issue slots of each block's trailing square,
// padded rows included, and the chain of shuffles, rsqrts and one
// __syncwarp that every two columns wait on.
// Above k = 64 a row no longer fits a lane's registers: a warp then factors
// its system in shared memory (the first design of this kernel), rows on
// lanes and the trailing triangle updated in place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 128;
constexpr int kMaxRegK = 64;        // widest system held in registers
constexpr int kRegWarps = 4;        // warps per block on the register path
constexpr int kSmemLimit = 232448;  // opt-in shared memory of one block

// --- register path: k <= 64 -------------------------------------------------

// Per warp: the stage (KP rows at an odd stride, so lanes reading their
// own rows hit 32 banks; it then holds L for the back solve), two pairs
// of column vectors, and z and 1/L_jj.
__host__ __device__ constexpr int stage_stride(int kp) { return kp + 1; }
__host__ __device__ constexpr int reg_warp_floats(int kp) {
  return kp * stage_stride(kp) + 4 * kp + 2 * kp;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// The lower triangle of system `sys` into the stage, row i at i * (KP+1):
// the triangle's k(k+1)/2 entries in order, 32 consecutive ones per
// instruction across the lanes.
template <int KP>
__device__ __forceinline__ void stage_lower(float* stage, const float* A,
                                            long long sys, int k, int lane) {
  const float* Ag = A + sys * k * k;
  int i = 0, c = lane;  // entry `lane` of the triangle: row i, column c
  while (c > i) c -= ++i;
  for (; i < k;) {
    cp_async4(stage + i * stage_stride(KP) + c, Ag + i * k + c);
    c += kWarp;
    while (c > i && i < k) c -= ++i;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// longest row held by register block r (rows 32r .. 32r+31)
template <int KP>
__host__ __device__ constexpr int row_len(int r) {
  return KP < kWarp * (r + 1) ? KP : kWarp * (r + 1);
}

// four blocks of 128 threads per SM up to KP = 56 (128 registers, a few
// bytes spilled: faster on the card than three blocks without), three above
template <int KP>
__global__ void __launch_bounds__(kRegWarps * kWarp, KP <= 56 ? 4 : 3)
cholesky_reg_kernel(const float* __restrict__ A, const float* __restrict__ b,
                    float* __restrict__ x, long long n, int k) {
  constexpr int R = (KP + kWarp - 1) / kWarp;
  constexpr int SA = stage_stride(KP);
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  float* stage = smem + (size_t)warp * reg_warp_floats(KP);
  float* col = stage + KP * SA;  // two pairs of column vectors of KP floats
  float* zs = col + 4 * KP;
  float* dinv = zs + KP;

  const long long step = (long long)gridDim.x * kRegWarps;
  long long sys = (long long)blockIdx.x * kRegWarps + warp;
  if (sys >= n) return;
  stage_lower<KP>(stage, A, sys, k, lane);

  for (; sys < n; sys += step) {
    float M[R][KP];  // row lane + 32r; entries past row_len<KP>(r) unused
    float rhs[R], xr[R], acc[R];
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + kWarp * r;
      const float* src = stage + (i < KP ? i : 0) * SA;
#pragma unroll
      for (int c = 0; c < row_len<KP>(r); ++c) {
        const float v = src[c];
        // lower triangle as staged; the pad rows are the identity; above
        // the diagonal stays zero
        M[r][c] = i < k ? (c <= i ? v : 0.f) : (c == i ? 1.f : 0.f);
      }
      rhs[r] = i < k ? b[sys * k + i] : 0.f;
      xr[r] = 0.f;
      acc[r] = 0.f;
    }
    __syncwarp();  // every lane has its rows: the stage is free for L

    // Right-looking Cholesky, two columns a step, with the forward
    // substitution L z = b carried along in rhs.  Column j goes to the
    // shared vector unscaled, so its broadcast does not wait on the pivot's
    // shuffle and rsqrt; each lane scales its own factors by 1/pivot
    // instead.  Column j + 1 takes column j's update on the lanes before it
    // is broadcast, so one __syncwarp serves both.  L itself goes to the
    // stage for the back solve.  KP is a multiple of 4, so j + 1 < KP; when
    // k is odd, column k is the pad's identity and changes nothing.
#pragma unroll
    for (int j = 0; j < KP; j += 2) {
      if (j >= k) break;
      const int j1 = j + 1, rj = j / kWarp, rj1 = j1 / kWarp;
      float* cv0 = col + ((j >> 1) & 1) * 2 * KP;
      float* cv1 = cv0 + KP;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + kWarp * r;
        if (j < row_len<KP>(r) && i < KP) cv0[i] = M[r][j];
      }
      const float piv0 = __shfl_sync(kFull, M[rj][j], j % kWarp);
      const float a10 = __shfl_sync(kFull, M[rj1][j], j1 % kWarp);
      const float rhs0 = __shfl_sync(kFull, rhs[rj], j % kWarp);
      const float d0 = rsqrtf(piv0);
      const float z0 = rhs0 * d0;
      float u0[R], u1[R];  // this lane's multipliers M[i][j] / pivot
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + kWarp * r;
        // row_len is even and j is even: j + 1 < row_len when j < row_len
        if (j >= row_len<KP>(r)) continue;  // this block is finished
        const float l = M[r][j] * d0;
        u0[r] = l * d0;
        if (i < KP) stage[i * SA + j] = l;
        if (i > j) rhs[r] = fmaf(-l, z0, rhs[r]);
        M[r][j1] = fmaf(-u0[r], a10, M[r][j1]);
      }
      const float piv1 = __shfl_sync(kFull, M[rj1][j1], j1 % kWarp);
      const float rhs1 = __shfl_sync(kFull, rhs[rj1], j1 % kWarp);
      const float d1 = rsqrtf(piv1);
      const float z1 = rhs1 * d1;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + kWarp * r;
        if (j >= row_len<KP>(r)) continue;
        const float l = M[r][j1] * d1;
        u1[r] = l * d1;
        if (i < KP) {
          cv1[i] = M[r][j1];
          stage[i * SA + j1] = l;
        }
        if (i > j1) rhs[r] = fmaf(-l, z1, rhs[r]);
      }
      if (lane == 0) {
        zs[j] = z0;
        dinv[j] = d0;
        zs[j1] = z1;
        dinv[j1] = d1;
      }
      __syncwarp();
      // trailing update from 16-byte broadcast loads of columns j, j + 1
#pragma unroll
      for (int c4 = (j1 + 1) / 4 * 4; c4 < KP; c4 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(cv0 + c4);
        const float4 w = *reinterpret_cast<const float4*>(cv1 + c4);
        const float vv[4] = {v.x, v.y, v.z, v.w};
        const float ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = c4 + t;
          if (c <= j1) continue;
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (c < row_len<KP>(r) && j < row_len<KP>(r))
              M[r][c] = fmaf(-u1[r], ww[t], fmaf(-u0[r], vv[t], M[r][c]));
        }
      }
    }

    // Back substitution L^T x = z, right-looking on L^T: x_j comes from
    // its row's lane by shuffle, and every lane folds column j of L^T, row
    // j of L as kept in the stage, into its sums.
    __syncwarp();  // the stage holds L
#pragma unroll
    for (int j = KP - 1; j >= 0; --j) {
      if (j >= k) continue;
      const int rj = j / kWarp;
      // acc holds minus the sum of L[i][j] x_i over the rows i > j
      const float own = (zs[j] + acc[rj]) * dinv[j];
      const float xj = __shfl_sync(kFull, own, j % kWarp);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = lane + kWarp * r;
        if (r == rj && lane == j % kWarp) xr[r] = xj;
        if (r <= rj && i < j)
          acc[r] = fmaf(-stage[j * SA + i], xj, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = lane + kWarp * r;
      if (i < k) x[sys * k + i] = xr[r];
    }
    // zs, dinv and the stage are read: the next system may land
    __syncwarp();
    if (sys + step < n) stage_lower<KP>(stage, A, sys + step, k, lane);
  }
}

// --- shared-memory path: 64 < k <= 128 --------------------------------------

constexpr int kSmemMaxWarps = 8;
constexpr size_t kSmemBlockBudget = 96 * 1024;  // two blocks per SM

__host__ __device__ inline int row_stride(int k) { return k | 1; }

__host__ __device__ inline size_t smem_warp_floats(int k) {
  return (size_t)k * row_stride(k) + k;  // the system, then its right side
}

__global__ void cholesky_smem_kernel(const float* __restrict__ A,
                                     const float* __restrict__ b,
                                     float* __restrict__ x, long long n,
                                     int k) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const long long sys = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (sys >= n) return;  // whole warps leave; no block-wide barrier follows
  const int ld = row_stride(k);
  float* M = smem + (size_t)warp * smem_warp_floats(k);
  float* r = M + (size_t)k * ld;  // b, overwritten by z, then by x

  const float* Ag = A + sys * k * k;
  for (int i = 0; i < k; ++i)  // the lower triangle only
    for (int c = lane; c <= i; c += kWarp) M[i * ld + c] = Ag[i * k + c];
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

cudaError_t launch_smem(const float* A, const float* b, float* x, long long n,
                        int k, cudaStream_t stream) {
  const size_t per_warp = smem_warp_floats(k) * sizeof(float);
  int warps = (int)(kSmemBlockBudget / per_warp);
  warps = warps < 1 ? 1 : (warps > kSmemMaxWarps ? kSmemMaxWarps : warps);
  const size_t smem = (size_t)warps * per_warp;
  const cudaError_t e = cudaFuncSetAttribute(
      cholesky_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (n + warps - 1) / warps;
  cholesky_smem_kernel<<<(unsigned)blocks, warps * kWarp, smem, stream>>>(
      A, b, x, n, k);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_reg(const float* A, const float* b, float* x, long long n,
                       int k, cudaStream_t stream) {
  const int smem = kRegWarps * reg_warp_floats(KP) * (int)sizeof(float);
  auto kernel = cholesky_reg_kernel<KP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  // persistent: as many blocks as fit on the card at once, fewer for a
  // small batch
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kRegWarps * kWarp, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (n + kRegWarps - 1) / kRegWarps;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  kernel<<<(unsigned)blocks, kRegWarps * kWarp, smem, stream>>>(A, b, x, n,
                                                                k);
  return cudaGetLastError();
}

}  // namespace

static_assert(kRegWarps * reg_warp_floats(kMaxRegK) * 4 <= kSmemLimit,
              "the register path's stages must fit a block");

// C entry: launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers to
// contiguous f32 arrays, A 4-byte aligned (any row offset of a larger
// batch).  kp is the host's plan (ops/cholesky.py solve_plan): the register
// path at a padded width kp in {4, 8, ..., 64} with k <= kp, or 0 for the
// shared-memory path.
extern "C" int cholesky_solve_f32(const float* A, const float* b, float* x,
                                  long long n, int k, int kp, void* stream) {
  if (k < 1 || k > kMaxK || n < 0 || (uintptr_t)A % 4 ||
      (kp != 0 && (kp % 4 || kp > kMaxRegK || k > kp)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (kp) {
    case 4: return (int)launch_reg<4>(A, b, x, n, k, s);
    case 8: return (int)launch_reg<8>(A, b, x, n, k, s);
    case 12: return (int)launch_reg<12>(A, b, x, n, k, s);
    case 16: return (int)launch_reg<16>(A, b, x, n, k, s);
    case 20: return (int)launch_reg<20>(A, b, x, n, k, s);
    case 24: return (int)launch_reg<24>(A, b, x, n, k, s);
    case 28: return (int)launch_reg<28>(A, b, x, n, k, s);
    case 32: return (int)launch_reg<32>(A, b, x, n, k, s);
    case 36: return (int)launch_reg<36>(A, b, x, n, k, s);
    case 40: return (int)launch_reg<40>(A, b, x, n, k, s);
    case 44: return (int)launch_reg<44>(A, b, x, n, k, s);
    case 48: return (int)launch_reg<48>(A, b, x, n, k, s);
    case 52: return (int)launch_reg<52>(A, b, x, n, k, s);
    case 56: return (int)launch_reg<56>(A, b, x, n, k, s);
    case 60: return (int)launch_reg<60>(A, b, x, n, k, s);
    case 64: return (int)launch_reg<64>(A, b, x, n, k, s);
    default: return (int)launch_smem(A, b, x, n, k, s);
  }
}
