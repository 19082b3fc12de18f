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
// as a zero row.  Outputs are f32: A (r, k, k), exactly symmetric, and
// b (r, k), each at its own row stride (k*k and k floats) from the given
// pointers, so they may be views into a larger system tensor.
//
// What bounds it on an H100: arithmetic.  k(k+1)/2 + k multiply-adds per
// real rating (53 GFLOP on the ML-20M user side at k = 50, 0.79 ms at the
// card's 67 TFLOP/s of non-tensor f32; the parity contract rules out TF32),
// against the A write (1.4 GB, 0.41 ms) and one read of idx, val and the
// table.  Issue slots, not shared-memory bandwidth, are the limit once each
// operand loaded from shared memory feeds enough multiply-adds.
//
// What the design does about it:
// - One group of G threads owns one bucket row (G = 16 at k = 50, two rows
//   per warp; whole warps above k = 50) and loops over the row's whole
//   rating list itself: no atomics, no second pass, and a row's arithmetic
//   does not depend on which rows share its block.  Groups that share a warp
//   step through their chunks in lockstep (as many as the warp's longest
//   row needs) and sync the whole warp, so its lanes never diverge into
//   half-warps that issue apart; a group of whole warps syncs with a named
//   barrier.
// - Each thread keeps one TS x TS register tile of A's lower triangle
//   (TS = 10 at k = 50: 15 tiles on 16 lanes), so one rating costs it two
//   short vector loads of the gathered row from shared memory for TS^2
//   multiply-adds.  The host picks TS in {4, 8, 10} and G for each k
//   (ops/gather_assembly.py assembly_plan), one template per TS.
// - The factor rows are gathered with cp.async into a three-stage ring of
//   8-rating chunks per group, up to two chunks ahead of the one being
//   multiplied, and the chunk's idx and val are read from device memory
//   further ahead; one group barrier per chunk.  Each table row lands in
//   shared memory in the layout the wrapper gave the table, tiles padded to
//   16-byte slots, so a row moves as whole 16-byte pieces (`cp.async.cg`,
//   past L1).  The loads that start a row (the first
//   chunks' idx and val, the tail of its list) go out together.
// - The trailing pads of a row (the same index, v = 0, and a zero table
//   row) are skipped: they add exact zeros.  About a fifth of the padded
//   ratings of the ML-20M buckets are pads.
// - b is summed per 32 ratings before it is added in (the accuracy reason is
//   at the b update below), by the threads that own diagonal tiles.
// - A leaves in bands of TS rows staged in the ring, as 16-byte stores of
//   contiguous memory; each tile and its mirror are placed in the band, so
//   A is exactly symmetric.
// What still holds it back (PERF.md, measured by cutting each part out):
// the multiply-adds, the gather and the A write add up instead of
// overlapping.  All three go through the SM's shared-memory pipe: a lane
// reads 80 bytes of it per rating for 100 multiply-adds, which is about as
// fast as the pipe delivers, and every gathered byte is written there too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

constexpr int kChunk = 8;        // ratings per pipeline stage
constexpr int kStages = 3;       // data ring depth
constexpr int kAhead = kStages - 1;       // chunks in flight while one is used
constexpr int kMetaStages = kStages + 1;  // idx/weight ring depth
constexpr int kBChunk = 32;      // ratings per partial sum of b
constexpr int kMinGroup = 8;     // fewest lanes per bucket row
constexpr int kMetaPer = ceil_div(kChunk, kMinGroup);  // idx per lane
constexpr int kMaxK = 128;
constexpr int kMaxThreads = 256;
constexpr int kSmemLimit = 232448;  // opt-in shared memory per block
static_assert(kBChunk % kChunk == 0, "b partial sums span whole chunks");

// elements per 16-byte aligned tile slot in shared memory
__host__ __device__ constexpr int slot_elems(int ts, int esize) {
  return ceil_div(ts * esize, 16) * 16 / esize;
}
__host__ __device__ inline int row_elems(int k, int ts, int esize) {
  return ceil_div(k, ts) * slot_elems(ts, esize);
}
// one group's shared memory: the data ring, then the slot and weight rings,
// two scratch ints (padded to 16 bytes) and b (padded to 16 bytes)
__host__ __device__ inline int group_smem_bytes(int k, int ts, int esize) {
  return kStages * kChunk * row_elems(k, ts, esize) * esize +
         kMetaStages * kChunk * (8 + 4) + 16 + ceil_div(k, 4) * 16;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// TS consecutive table elements at a 16-byte aligned shared address -> f32
template <int TS>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[TS]) {
#pragma unroll
  for (int i = 0; i + 4 <= TS; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
  if (TS % 4 == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p + TS - 2);
    v[TS - 2] = q.x; v[TS - 1] = q.y;
  }
}

__device__ __forceinline__ void bf16x2(uint32_t u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

template <int TS>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[TS]) {
#pragma unroll
  for (int i = 0; i + 8 <= TS; i += 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p + i);
    bf16x2(q.x, v[i], v[i + 1]);
    bf16x2(q.y, v[i + 2], v[i + 3]);
    bf16x2(q.z, v[i + 4], v[i + 5]);
    bf16x2(q.w, v[i + 6], v[i + 7]);
  }
  constexpr int base = TS / 8 * 8;
  if (TS % 8 >= 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p + base);
    bf16x2(q.x, v[base], v[base + 1]);
    bf16x2(q.y, v[base + 2], v[base + 3]);
  }
  if (TS % 4 == 2) {
    const uint32_t q = *reinterpret_cast<const uint32_t*>(p + TS - 2);
    bf16x2(q, v[TS - 2], v[TS - 1]);
  }
}

// cp.async of 16 bytes from global memory to the shared-memory address d,
// cached in L2 only; a zero source size fills the destination with zeros
// and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t d, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most the newest kAhead - 1 groups are pending
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

struct Params {
  const void* y;  // the table in tile-slot layout
  long long S;
  int k;
  const int* idx;
  const float* val;
  long long r;
  int w;
  float alpha;
  float* A;
  float* b;
  int g;      // threads per bucket row: 8, 16, 32 or a multiple of 32
};

// The lanes of one row's group.  Groups that share a warp step in lockstep
// (the same number of chunks, the warp's longest row's) and sync the whole
// warp, so its lanes stay converged; a group of whole warps syncs with a
// named barrier (ids 1..).
struct Group {
  int g, tg, bar;
  __device__ __forceinline__ void sync() const {
    if (g <= 32)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(g) : "memory");
  }
};

// Copy the table rows of one chunk (cn ratings, their slots in `slots`,
// -1 for a zero row) into a ring stage.  The table is in the stage's own
// tile-slot layout, rows of RS elements at 16-byte multiples, so a row
// moves as whole 16-byte pieces, spread over the group's lanes.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* stage, int RS, const int* slots,
                                           int cn, const T* y,
                                           const Group& G) {
  constexpr int E = 16 / sizeof(T);  // elements per piece
  const uint32_t sh = (uint32_t)__cvta_generic_to_shared(stage);
  const int pieces = RS / E;
  for (int c = 0; c < cn; ++c) {
    const int s = slots[c];
    const T* row = y + (long long)(s >= 0 ? s : 0) * RS;
    for (int q = G.tg; q < pieces; q += G.g)
      cp_async16(sh + (c * RS + q * E) * (int)sizeof(T), row + q * E, s >= 0);
  }
}

// Blocks of TS = 8 and 10 hold at most 128 threads; three blocks of the
// TS = 10 instances fit an SM when they keep to 170 registers.
template <int TS>
__host__ __device__ constexpr int max_threads() {
  return TS == 4 ? kMaxThreads : 128;
}

template <typename T, int TS, bool IMPLICIT>
__global__ void __launch_bounds__(max_threads<TS>(), TS == 10 ? 3 : 1)
assembly_kernel(const Params p) {
  constexpr int SPT = slot_elems(TS, (int)sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = p.k;
  const int RS = ceil_div(k, TS) * SPT;
  const int gi = threadIdx.x / p.g;
  Group G;
  G.g = p.g;
  G.tg = threadIdx.x - gi * p.g;
  G.bar = 1 + gi;
  const long long row = (long long)blockIdx.x * (blockDim.x / p.g) + gi;
  // a group past the last row runs along as an empty row and writes nothing
  const bool live = row < p.r;

  const int data_bytes = kStages * kChunk * RS * (int)sizeof(T);
  unsigned char* base = smem + (size_t)gi * group_smem_bytes(k, TS, sizeof(T));
  T* ring = reinterpret_cast<T*>(base);
  int* slot = reinterpret_cast<int*>(base + data_bytes);
  float2* wt = reinterpret_cast<float2*>(slot + kMetaStages * kChunk);
  int* scr = reinterpret_cast<int*>(wt + kMetaStages * kChunk);
  float* bsum = reinterpret_cast<float*>(scr + 4);  // b, summed per 32
  const T* y = static_cast<const T*>(p.y);
  const int* irow = p.idx + row * p.w;
  const float* vrow = p.val + row * p.w;
  const int w = p.w;

  // This thread's tile (tp >= tq) of the lower triangle, if it has one.
  const int nt = ceil_div(k, TS);
  int tp = 0, tq = 0;
  const bool active = G.tg < nt * (nt + 1) / 2;
  if (active) {
    while ((tp + 1) * (tp + 2) / 2 <= G.tg) ++tp;
    tq = G.tg - tp * (tp + 1) / 2;
  }
  const bool diag = active && tp == tq;

  // The loads that start a row go out together: the tail of the rating
  // list (trailing pads: the last entry's index, v = 0 and a zero table
  // row; skipping them leaves A and b as they are), the last index's table
  // row, and the idx and val of the first kAhead + 2 chunks.
  if (G.tg == 0) {
    scr[0] = -1;
    scr[1] = 0;
  }
  for (int e = G.tg; e < k; e += G.g) bsum[e] = 0.f;
  G.sync();
  int f_slot[kAhead + 2][kMetaPer];
  float f_v[kAhead + 2][kMetaPer];
  auto fetch = [&](int x, int (&fs)[kMetaPer], float (&fv)[kMetaPer]) {
#pragma unroll
    for (int u = 0; u < kMetaPer; ++u) {
      const int c = G.tg + G.g * u;
      const int i = x * kChunk + c;
      const bool ok = live && c < kChunk && i < w;
      fs[u] = ok ? irow[i] : -1;
      fv[u] = ok ? vrow[i] : 0.f;
    }
  };
#pragma unroll
  for (int x = 0; x < kAhead + 2; ++x) fetch(x, f_slot[x], f_v[x]);
  int len = 0;
  if (w > 0) {
    const int last = live ? irow[w - 1] : -1;
    int ci[4];
    float cv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = live ? w - 1 - G.tg - G.g * q : -1;
      ci[q] = j >= 0 ? irow[j] : last;
      cv[q] = j >= 0 ? vrow[j] : 0.f;
    }
    bool nonzero = false;  // the slots' padding is zero
    if (last >= 0 && last < p.S)
      for (int e = G.tg; e < RS; e += G.g)
        nonzero |= to_f32(y[(long long)last * RS + e]) != 0.f;
    int mine = -1;
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      const int j = w - 1 - G.tg - G.g * q;
      if (j >= 0 && (ci[q] != last || cv[q] != 0.f)) mine = j;
    }
    // a tail longer than four strides of the group: scan on
    for (int j = w - 1 - G.tg - 4 * G.g; live && mine < 0 && j >= 0;
         j -= G.g)
      if (irow[j] != last || vrow[j] != 0.f) mine = j;
    if (mine >= 0) atomicMax(&scr[0], mine);
    if (nonzero) atomicOr(&scr[1], 1);
    G.sync();
    len = scr[1] ? w : scr[0] + 1;
  }
  int nch = ceil_div(len, kChunk);
  if (G.g < 32) nch = __reduce_max_sync(0xffffffffu, nch);  // lockstep

  // chunk x's slots (-1: a zero row) and weights in A and in b
  auto publish = [&](int x, const int (&fs)[kMetaPer],
                     const float (&fv)[kMetaPer]) {
    const int ms = x % kMetaStages;
#pragma unroll
    for (int u = 0; u < kMetaPer; ++u) {
      const int c = G.tg + G.g * u;
      if (c >= kChunk) continue;
      const bool ok = x * kChunk + c < len && fs[u] >= 0 && fs[u] < p.S;
      slot[ms * kChunk + c] = ok ? fs[u] : -1;
      wt[ms * kChunk + c] =
          IMPLICIT ? make_float2(p.alpha * fv[u], 1.f + p.alpha * fv[u])
                   : make_float2(1.f, fv[u]);
    }
  };
  auto issue = [&](int x) {
    const int cn = min(kChunk, len - x * kChunk);
    if (cn > 0) {
      T* st = ring + (x % kStages) * kChunk * RS;
      const int* sl = slot + (x % kMetaStages) * kChunk;
      copy_chunk<T>(st, RS, sl, cn, y, G);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int x = 0; x <= kAhead; ++x) publish(x, f_slot[x], f_v[x]);
  G.sync();
  for (int x = 0; x < kAhead; ++x) issue(x);

  float acc[TS][TS];
  float bpart[TS];
#pragma unroll
  for (int i = 0; i < TS; ++i) {
    bpart[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TS; ++j) acc[i][j] = 0.f;
  }
  // a diagonal tile's lanes own b's entries of its rows
  auto fold_b = [&]() {
    if (diag) {
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        if (tp * TS + i < k) bsum[tp * TS + i] += bpart[i];
        bpart[i] = 0.f;
      }
    }
  };

  for (int m = 0; m < nch; ++m) {
    cp_async_wait_ahead();  // this lane's copies of chunk m have landed
    G.sync();             // ... and every lane's; chunk m-1 is consumed
    issue(m + kAhead);
    publish(m + kAhead + 1, f_slot[kAhead + 1], f_v[kAhead + 1]);
    fetch(m + kAhead + 2, f_slot[kAhead + 1], f_v[kAhead + 1]);
    const int cn = min(kChunk, len - m * kChunk);
    const T* st = ring + (m % kStages) * kChunk * RS;
    const float2* wm = wt + (m % kMetaStages) * kChunk;
    if (active) {
      for (int c = 0; c < cn; ++c) {
        const float2 ww = wm[c];
        float yp[TS], yq[TS];
        load_vec<TS>(st + c * RS + tp * SPT, yp);
        load_vec<TS>(st + c * RS + tq * SPT, yq);
#pragma unroll
        for (int i = 0; i < TS; ++i) {
          const float pi = IMPLICIT ? yp[i] * ww.x : yp[i];
#pragma unroll
          for (int j = 0; j < TS; ++j) acc[i][j] = fmaf(pi, yq[j], acc[i][j]);
        }
        if (diag) {
#pragma unroll
          for (int i = 0; i < TS; ++i) bpart[i] = fmaf(yp[i], ww.y, bpart[i]);
        }
      }
    }
    // b sums each 32 ratings apart before adding them in: a long
    // sequential f32 sum of same-signed terms loses about twice the digits
    // of cuBLAS's blocked one, and the ALS systems amplify that error by
    // their condition number
    if ((m + 1) % (kBChunk / kChunk) == 0) fold_b();
  }
  fold_b();

  // A goes out one band of TS rows at a time through the ring, now free:
  // the tiles of the band and the mirrors of the tiles below it land in
  // shared memory, then the band's TS * k contiguous floats leave in
  // 16-byte stores.  A diagonal tile writes its lower half and mirrors it,
  // so A is exactly symmetric.
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  G.sync();
  float* band = reinterpret_cast<float*>(ring);
  float* Ar = p.A + row * k * k;
  const int p0 = tp * TS, q0 = tq * TS;
  for (int bt = 0; bt < nt; ++bt) {
    if (active && tp == bt) {
#pragma unroll
      for (int i = 0; i < TS; ++i)
#pragma unroll
        for (int j = 0; j < TS; ++j)
          if (p0 + i < k && q0 + j < k)
            band[i * k + q0 + j] = (diag && j > i) ? acc[j][i] : acc[i][j];
    }
    if (active && tq == bt && !diag) {
#pragma unroll
      for (int j = 0; j < TS; ++j)
#pragma unroll
        for (int i = 0; i < TS; ++i)
          if (q0 + j < k && p0 + i < k) band[j * k + p0 + i] = acc[i][j];
    }
    G.sync();
    float* dst = Ar + (long long)bt * TS * k;
    const int n = live ? min(TS, k - bt * TS) * k : 0;
    if ((uintptr_t)dst % 16 == 0) {
      const int n4 = n / 4;
      for (int e = G.tg; e < n4; e += G.g)
        reinterpret_cast<float4*>(dst)[e] =
            reinterpret_cast<const float4*>(band)[e];
      for (int e = 4 * n4 + G.tg; e < n; e += G.g) dst[e] = band[e];
    } else {
      for (int e = G.tg; e < n; e += G.g) dst[e] = band[e];
    }
    G.sync();  // the band is read before the next one is written
  }
  for (int e = G.tg; live && e < k; e += G.g) p.b[row * k + e] = bsum[e];
}

template <typename T, int TS, bool IMPLICIT>
cudaError_t launch(const Params& p, int rows_per_block, cudaStream_t stream) {
  const int smem = rows_per_block * group_smem_bytes(p.k, TS, sizeof(T));
  auto kernel = assembly_kernel<T, TS, IMPLICIT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (p.r + rows_per_block - 1) / rows_per_block;
  kernel<<<(unsigned)blocks, rows_per_block * p.g, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool IMPLICIT>
cudaError_t launch_ts(const Params& p, int ts, int rows_per_block,
                      cudaStream_t stream) {
  switch (ts) {
    case 4: return launch<T, 4, IMPLICIT>(p, rows_per_block, stream);
    case 8: return launch<T, 8, IMPLICIT>(p, rows_per_block, stream);
    case 10: return launch<T, 10, IMPLICIT>(p, rows_per_block, stream);
    default: return cudaErrorInvalidValue;
  }
}

// What the host's plan must satisfy (ops/gather_assembly.py assembly_plan
// makes it): every tile has a thread, groups tile warps or whole warps,
// named barriers 1..15 suffice, the slotted table is 16-byte aligned, and
// the shared memory fits.
bool plan_ok(const Params& p, int ts, int rows_per_block, int esize) {
  const int nt = ceil_div(p.k, ts);
  if (ts != 4 && ts != 8 && ts != 10) return false;
  if (rows_per_block * p.g > (ts == 4 ? max_threads<4>() : max_threads<8>()))
    return false;
  if (nt * (nt + 1) / 2 > p.g) return false;
  if (!(p.g == kMinGroup || p.g == 16 || p.g % 32 == 0)) return false;
  if (rows_per_block < 1 || rows_per_block * p.g > kMaxThreads) return false;
  if (p.g > 32 && rows_per_block > 15) return false;
  if ((uintptr_t)p.y % 16) return false;
  return rows_per_block * group_smem_bytes(p.k, ts, esize) <= kSmemLimit;
}

}  // namespace

// C entry: launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError() (0 on success).  y_slots is the f32 (y_bf16 = 0) or
// bf16 (y_bf16 = 1) factor table of S rows of k in the tile-slot layout of
// ts (ops/gather_assembly.py slot_table: each row ceil(k/ts) tiles of ts
// elements, each tile padded with zeros to 16 bytes), 16-byte aligned;
// idx int32 and val f32 are (r, w), contiguous; A (r, k, k) and b (r, k)
// are f32 outputs with contiguous rows (they may start anywhere in a
// larger tensor).  ts, g and rows_per_block are the host's plan for this
// k, checked here.
extern "C" int gather_assembly_f32(const void* y_slots, int y_bf16,
                                   long long S, int k, const int* idx,
                                   const float* val, long long r, int w,
                                   int implicit, float alpha, float* A,
                                   float* b, int ts, int g,
                                   int rows_per_block, void* stream) {
  if (k < 1 || k > kMaxK || w < 0 || r < 0 || S < 0 || S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (r == 0) return 0;
  Params p{y_slots, S, k, idx, val, r, w, alpha, A, b, g};
  const int esize = y_bf16 ? 2 : 4;
  if (!plan_ok(p, ts, rows_per_block, esize) ||
      (r + rows_per_block - 1) / rows_per_block > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (y_bf16)
    e = implicit ? launch_ts<__nv_bfloat16, true>(p, ts, rows_per_block, s)
                 : launch_ts<__nv_bfloat16, false>(p, ts, rows_per_block, s);
  else
    e = implicit ? launch_ts<float, true>(p, ts, rows_per_block, s)
                 : launch_ts<float, false>(p, ts, rows_per_block, s);
  return (int)e;
}
