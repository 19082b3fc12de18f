// tpums shared-memory arena reader — the native half of the zero-copy
// factor store (flink_ms_tpu_torch/serve/arena.py owns the format and the single
// writer; this unit maps the same file read-only and answers lookups with
// per-row seqlock retry, no lock and no syscall on the hot path).
//
// File layout (little-endian; authoritative doc in serve/arena.py):
//   [0:64)  header: "TPMA" | version u32 | capacity u64 | stride u32 |
//           key_cap u32 | count u64 | generation u64 | retired u32 |
//           pad u32 | mutations u64
//   [64:..) capacity slots of ceil8(12 + key_cap + stride) bytes:
//           seq u32 | klen u32 | vlen u32 | key[key_cap] | value[stride]
//
// Seqlock read: s1 = acquire-load(seq); 0 -> probe-chain end; odd -> the
// writer is mid-row (or died there) — bounded retry, then treat the slot
// as holding nothing and keep probing; copy, fence, re-load; s1 != s2 ->
// torn, retry.  A reader therefore NEVER returns a torn value: a SIGKILLed
// writer leaves an odd seq, which reads as key-missing until the respawned
// consumer's journal replay rewrites the row.  The writer is CPython
// storing through mmap on x86 (TSO store order); the acquire loads here
// are the matching read-side discipline.
//
// Growth: the writer builds generation g+1, repoints CURRENT, then flips
// the old header's `retired` flag.  Readers check the flag per lookup
// (one load) and remap through CURRENT; superseded mappings stay mapped
// until tpums_close so in-flight readers on other threads never fault.
//
// Handles dispatch through the public store API (tpums_get/tpums_count/
// tpums_keys_chunk/...) via the tag in tpums_internal.h, which is what
// lets lookup_server.cpp serve GET/MGET/B2 — and build its TOPK/DOT
// indexes — straight from the mmap with zero per-request Python pushes.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <mutex>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "tpums.h"
#include "tpums_internal.h"

namespace {

constexpr uint64_t kHeaderSize = 64;
constexpr uint64_t kSlotHdr = 12;
constexpr int kMaxSeqRetries = 64;

struct Mapping {
  uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t capacity = 0;
  uint32_t stride = 0;
  uint32_t key_cap = 0;
  uint64_t slot_size = 0;
  std::string path;
};

struct ArenaHandle {
  uint32_t tag = kTpumsArenaTag;
  std::string dir;
  std::mutex remap_mu;
  std::atomic<Mapping*> cur{nullptr};
  std::vector<Mapping*> superseded;  // unmapped only at close
  std::atomic<uint64_t> retries{0};
  // writer.stats sidecar (write-plane counters), mapped lazily read-only
  // the first time tpums_arena_write_stats finds the file on disk
  std::atomic<uint8_t*> wstats{nullptr};
};

uint32_t fnv1a(const char* k, uint32_t klen) {
  uint32_t h = 0x811C9DC5u;
  for (uint32_t i = 0; i < klen; ++i) {
    h ^= static_cast<uint8_t>(k[i]);
    h *= 0x01000193u;
  }
  return h;
}

inline uint32_t load_u32_acq(const uint8_t* p) {
  return __atomic_load_n(reinterpret_cast<const uint32_t*>(p),
                         __ATOMIC_ACQUIRE);
}

inline uint64_t load_u64(const uint8_t* p) {
  return __atomic_load_n(reinterpret_cast<const uint64_t*>(p),
                         __ATOMIC_RELAXED);
}

inline uint32_t load_u32_rlx(const uint8_t* p) {
  return __atomic_load_n(reinterpret_cast<const uint32_t*>(p),
                         __ATOMIC_RELAXED);
}

inline void store_u32_rlx(uint8_t* p, uint32_t v) {
  __atomic_store_n(reinterpret_cast<uint32_t*>(p), v, __ATOMIC_RELAXED);
}

inline void store_u32_rel(uint8_t* p, uint32_t v) {
  __atomic_store_n(reinterpret_cast<uint32_t*>(p), v, __ATOMIC_RELEASE);
}

inline void store_u64_rlx(uint8_t* p, uint64_t v) {
  __atomic_store_n(reinterpret_cast<uint64_t*>(p), v, __ATOMIC_RELAXED);
}

// Seqlock payload copies are racy BY DESIGN — the s1/s2 recheck discards
// torn reads, and the odd-seq claim fences torn writes off from readers.
// Plain memcpy is correct under the protocol (x86-TSO plus the seq
// acquire/release pairing), but TSan cannot see the seqlock's logical
// exclusion, so once BOTH the writer (tpums_arena_put_batch / cas) and
// the reader loop are instrumented in one process — exactly what the
// sanitizer gate does — every payload byte would be reported.  Under
// TSan the copies therefore go through per-byte relaxed atomics, which
// TSan models; everywhere else this compiles to memcpy.
#if defined(__SANITIZE_THREAD__)
inline void seqlock_copy(void* dst, const void* src, size_t n) {
  uint8_t* d = static_cast<uint8_t*>(dst);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  for (size_t i = 0; i < n; ++i)
    __atomic_store_n(d + i, __atomic_load_n(s + i, __ATOMIC_RELAXED),
                     __ATOMIC_RELAXED);
}
#else
inline void seqlock_copy(void* dst, const void* src, size_t n) {
  memcpy(dst, src, n);
}
#endif

Mapping* map_file(const std::string& path) {
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < static_cast<off_t>(kHeaderSize)) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                    MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  uint8_t* b = static_cast<uint8_t*>(base);
  if (memcmp(b, "TPMA", 4) != 0) {
    munmap(base, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  Mapping* m = new Mapping();
  m->base = b;
  m->size = static_cast<size_t>(st.st_size);
  memcpy(&m->capacity, b + 8, 8);
  memcpy(&m->stride, b + 16, 4);
  memcpy(&m->key_cap, b + 20, 4);
  m->slot_size = (kSlotHdr + m->key_cap + m->stride + 7) & ~7ull;
  m->path = path;
  if (kHeaderSize + m->capacity * m->slot_size > m->size) {
    munmap(base, m->size);
    delete m;
    return nullptr;
  }
  return m;
}

std::string read_current(const std::string& dir) {
  int fd = ::open((dir + "/CURRENT").c_str(), O_RDONLY);
  if (fd < 0) return "";
  char buf[256];
  ssize_t n = read(fd, buf, sizeof(buf) - 1);
  close(fd);
  if (n <= 0) return "";
  buf[n] = 0;
  std::string name(buf);
  while (!name.empty() && (name.back() == '\n' || name.back() == ' '))
    name.pop_back();
  return name.empty() ? "" : dir + "/" + name;
}

// The live mapping, remapping through CURRENT when the writer retired the
// generation we hold (or nothing was mapped yet — the server can start
// before the consumer's first row lands).
Mapping* live_mapping(ArenaHandle* a) {
  Mapping* m = a->cur.load(std::memory_order_acquire);
  if (m != nullptr && load_u32_acq(m->base + 40) == 0) return m;
  std::lock_guard<std::mutex> g(a->remap_mu);
  m = a->cur.load(std::memory_order_acquire);
  if (m != nullptr && load_u32_acq(m->base + 40) == 0) return m;
  std::string path = read_current(a->dir);
  if (path.empty() || (m != nullptr && path == m->path)) return m;
  Mapping* fresh = map_file(path);
  if (fresh == nullptr) return m;
  if (m != nullptr) a->superseded.push_back(m);
  a->cur.store(fresh, std::memory_order_release);
  return fresh;
}

// Seqlock-copy slot `idx` into key/val.  Returns 1 on a stable row, 0 when
// the slot is empty (chain end for lookups), -1 when it holds nothing
// readable (mid-write/odd-stuck/torn past the retry budget).
int read_slot(ArenaHandle* a, const Mapping* m, uint64_t idx,
              std::string* key, std::string* val) {
  const uint8_t* slot = m->base + kHeaderSize + idx * m->slot_size;
  for (int t = 0; t < kMaxSeqRetries; ++t) {
    uint32_t s1 = load_u32_acq(slot);
    if (s1 == 0) return 0;
    if (s1 & 1) {
      a->retries.fetch_add(1, std::memory_order_relaxed);
      continue;
    }
    uint32_t klen = load_u32_rlx(slot + 4);
    uint32_t vlen = load_u32_rlx(slot + 8);
    if (klen > m->key_cap || vlen > m->stride) {
      a->retries.fetch_add(1, std::memory_order_relaxed);
      continue;  // header torn mid-claim
    }
    key->resize(klen);
    seqlock_copy(key->data(), slot + kSlotHdr, klen);
    val->resize(vlen);
    seqlock_copy(val->data(), slot + kSlotHdr + m->key_cap, vlen);
    std::atomic_thread_fence(std::memory_order_acquire);
    uint32_t s2 = load_u32_acq(slot);
    if (s1 == s2) return 1;
    a->retries.fetch_add(1, std::memory_order_relaxed);
  }
  return -1;
}

// -- write plane -----------------------------------------------------------
// The native half of ArenaModelTable's write path.  A writer handle maps
// ONE generation file read-write (the Python table owns the flock, the
// CURRENT pointer, and growth — it reopens the handle after every
// generation flip), so every byte stored here replicates Arena.put_bytes
// exactly: same claim order, same seq values, same untouched value tails.
// Byte-parity with the Python writer is load-bearing (the fuzz gate diffs
// whole arena files) — change Arena.put_bytes and this together or not
// at all.

// writer.stats sidecar: write-plane counters live OUTSIDE the arena
// header (its 64 bytes are fully spoken for) in a fixed 64-byte file the
// C++ server maps read-only for the METRICS verb.
//   [0:4) "TPWS" | [4:8) version u32 | [8:16) batch_rows u64 |
//   [16:24) batch_ns u64 | [24:32) cas_success u64 | [32:40) cas_retry u64 |
//   [40:48) write_cpu_ns u64 (thread-CPU burned in put_batch/cas_floats —
//   the profiling plane's "native;arena_writer" row; old sidecars read as
//   0 here, which every consumer treats as "no data")
constexpr uint64_t kStatsSize = 64;
constexpr size_t kStatsBatchRows = 8;
constexpr size_t kStatsBatchNs = 16;
constexpr size_t kStatsCasSuccess = 24;
constexpr size_t kStatsCasRetry = 32;
constexpr size_t kStatsWriteCpuNs = 40;

uint8_t* map_stats(const std::string& dir, bool writable) {
  std::string p = dir + "/writer.stats";
  int fd = ::open(p.c_str(), writable ? (O_RDWR | O_CREAT) : O_RDONLY,
                  0644);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 ||
      (st.st_size < static_cast<off_t>(kStatsSize) &&
       (!writable || ftruncate(fd, kStatsSize) != 0))) {
    close(fd);
    return nullptr;
  }
  void* b = mmap(nullptr, kStatsSize,
                 writable ? (PROT_READ | PROT_WRITE) : PROT_READ,
                 MAP_SHARED, fd, 0);
  close(fd);
  if (b == MAP_FAILED) return nullptr;
  uint8_t* u = static_cast<uint8_t*>(b);
  if (memcmp(u, "TPWS", 4) != 0) {
    if (!writable) {  // writer hasn't stamped it yet — retry next call
      munmap(b, kStatsSize);
      return nullptr;
    }
    uint32_t ver = 1;
    memcpy(u, "TPWS", 4);
    memcpy(u + 4, &ver, 4);
  }
  return u;
}

inline void stats_add(uint8_t* stats, size_t off, uint64_t delta) {
  if (stats != nullptr)
    __atomic_fetch_add(reinterpret_cast<uint64_t*>(stats + off), delta,
                       __ATOMIC_RELAXED);
}

// Scope guard accumulating this thread's CPU ns into the sidecar's
// write_cpu_ns counter — the arena writer's contribution to the
// continuous-profiling plane.  The negative-nsec case is safe under the
// same modular-uint64 arithmetic the batch_ns accumulation relies on.
struct WriteCpuSection {
  uint8_t* stats;
  struct timespec c0;
  explicit WriteCpuSection(uint8_t* st) : stats(st) {
    if (stats != nullptr) clock_gettime(CLOCK_THREAD_CPUTIME_ID, &c0);
  }
  ~WriteCpuSection() {
    if (stats == nullptr) return;
    struct timespec c1;
    clock_gettime(CLOCK_THREAD_CPUTIME_ID, &c1);
    stats_add(stats, kStatsWriteCpuNs,
              static_cast<uint64_t>(c1.tv_sec - c0.tv_sec) * 1000000000ull +
                  static_cast<uint64_t>(c1.tv_nsec - c0.tv_nsec));
  }
};

struct ArenaWriter {
  uint32_t tag = kTpumsArenaWriterTag;
  uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t capacity = 0;
  uint32_t stride = 0;
  uint32_t key_cap = 0;
  uint64_t slot_size = 0;
  uint8_t* stats = nullptr;
};

inline ArenaWriter* as_writer(void* h) {
  return (h != nullptr &&
          static_cast<TpumsTaggedHandle*>(h)->tag == kTpumsArenaWriterTag)
             ? static_cast<ArenaWriter*>(h)
             : nullptr;
}

inline void bump_mutations(ArenaWriter* w) {
  store_u64_rlx(w->base + 48, load_u64(w->base + 48) + 1);
}

// Claim store discipline: the odd seq goes in with a relaxed atomic store
// followed by a compiler-only fence — x86-TSO never reorders the
// subsequent payload stores above it at runtime (the same contract the
// CPython writer relies on, documented in serve/arena.py), and the fence
// stops the COMPILER from hoisting them.  The closing even store is
// RELEASE, pairing with the reader's acquire load of seq.
bool put_row(ArenaWriter* w, const char* k, uint32_t klen, const char* v,
             uint32_t vlen) {
  uint64_t cap = w->capacity;
  uint64_t idx = fnv1a(k, klen) % cap;
  for (uint64_t probes = 0; probes < cap; ++probes) {
    uint8_t* slot = w->base + kHeaderSize + idx * w->slot_size;
    uint32_t seq = load_u32_rlx(slot);
    uint32_t cur_klen = load_u32_rlx(slot + 4);
    if (seq == 0 && cur_klen == 0) {
      uint64_t n = load_u64(w->base + 24);
      if (n + 1 > cap - (cap >> 3)) return false;  // caller grows
      store_u32_rlx(slot, 1);
      __atomic_signal_fence(__ATOMIC_SEQ_CST);
      seqlock_copy(slot + kSlotHdr, k, klen);
      seqlock_copy(slot + kSlotHdr + w->key_cap, v, vlen);
      store_u32_rlx(slot + 4, klen);
      store_u32_rlx(slot + 8, vlen);
      store_u32_rel(slot, 2);
      store_u64_rlx(w->base + 24, n + 1);
      bump_mutations(w);
      return true;
    }
    if (cur_klen == klen && memcmp(slot + kSlotHdr, k, klen) == 0) {
      // in-place: key immutable after the claim, only vlen+value move
      store_u32_rlx(slot, seq | 1);
      __atomic_signal_fence(__ATOMIC_SEQ_CST);
      seqlock_copy(slot + kSlotHdr + w->key_cap, v, vlen);
      store_u32_rlx(slot + 8, vlen);
      store_u32_rel(slot, (seq | 1) + 1);
      bump_mutations(w);
      return true;
    }
    if (++idx == cap) idx = 0;
  }
  return false;  // full scan with no home: structurally needs growth
}

}  // namespace

extern "C" {

void* tpums_arena_open(const char* dir) {
  ArenaHandle* a = new ArenaHandle();
  a->dir = dir;
  std::string path = read_current(a->dir);
  if (!path.empty()) {
    Mapping* m = map_file(path);
    if (m != nullptr) a->cur.store(m, std::memory_order_release);
  }
  // a missing CURRENT is not fatal: the handle attaches lazily on first
  // read (server started before the consumer created the table)
  return a;
}

int tpums_arena_refresh(void* h) {
  if (!tpums_is_arena(h)) return -1;
  ArenaHandle* a = static_cast<ArenaHandle*>(h);
  return live_mapping(a) != nullptr ? 0 : -1;
}

uint64_t tpums_arena_read_retries(void* h) {
  if (!tpums_is_arena(h)) return 0;
  return static_cast<ArenaHandle*>(h)->retries.load(
      std::memory_order_relaxed);
}

int tpums_arena_stats(void* h, double* rows, double* capacity,
                      double* resident_bytes, double* retries,
                      double* load_factor) {
  if (!tpums_is_arena(h)) return -1;
  ArenaHandle* a = static_cast<ArenaHandle*>(h);
  Mapping* m = live_mapping(a);
  double r = 0, c = 0, res = 0;
  if (m != nullptr) {
    r = static_cast<double>(load_u64(m->base + 24));
    c = static_cast<double>(m->capacity);
    struct stat st;
    if (stat(m->path.c_str(), &st) == 0)
      res = static_cast<double>(st.st_blocks) * 512.0;
  }
  if (rows) *rows = r;
  if (capacity) *capacity = c;
  if (resident_bytes) *resident_bytes = res;
  if (retries)
    *retries = static_cast<double>(
        a->retries.load(std::memory_order_relaxed));
  if (load_factor) *load_factor = c > 0 ? r / c : 0.0;
  return 0;
}

int tpums_arena_write_stats(void* h, double* batch_rows,
                            double* batch_seconds, double* cas_success,
                            double* cas_retry) {
  if (!tpums_is_arena(h)) return -1;
  ArenaHandle* a = static_cast<ArenaHandle*>(h);
  uint8_t* st = a->wstats.load(std::memory_order_acquire);
  if (st == nullptr) {
    std::lock_guard<std::mutex> g(a->remap_mu);
    st = a->wstats.load(std::memory_order_relaxed);
    if (st == nullptr) {
      st = map_stats(a->dir, /*writable=*/false);
      if (st == nullptr) return -1;  // no native writer yet — retry later
      a->wstats.store(st, std::memory_order_release);
    }
  }
  if (batch_rows)
    *batch_rows = static_cast<double>(load_u64(st + kStatsBatchRows));
  if (batch_seconds)
    *batch_seconds = static_cast<double>(load_u64(st + kStatsBatchNs)) / 1e9;
  if (cas_success)
    *cas_success = static_cast<double>(load_u64(st + kStatsCasSuccess));
  if (cas_retry)
    *cas_retry = static_cast<double>(load_u64(st + kStatsCasRetry));
  return 0;
}

int tpums_arena_write_cpu_seconds(void* h, double* cpu_s) {
  // separate export (not a fifth out-param on tpums_arena_write_stats):
  // that ABI is frozen — Python ctypes bindings and the C++ METRICS
  // splice both load it by signature, and old .so / new caller mixes must
  // keep working during a rolling rebuild
  if (!tpums_is_arena(h)) return -1;
  ArenaHandle* a = static_cast<ArenaHandle*>(h);
  uint8_t* st = a->wstats.load(std::memory_order_acquire);
  if (st == nullptr) {
    std::lock_guard<std::mutex> g(a->remap_mu);
    st = a->wstats.load(std::memory_order_relaxed);
    if (st == nullptr) {
      st = map_stats(a->dir, /*writable=*/false);
      if (st == nullptr) return -1;  // no native writer yet — retry later
      a->wstats.store(st, std::memory_order_release);
    }
  }
  if (cpu_s)
    *cpu_s = static_cast<double>(load_u64(st + kStatsWriteCpuNs)) / 1e9;
  return 0;
}

// -- writer plane exports ---------------------------------------------------

void* tpums_arena_writer_open(const char* path, const char* dir) {
  int fd = ::open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < static_cast<off_t>(kHeaderSize)) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, static_cast<size_t>(st.st_size),
                    PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  uint8_t* b = static_cast<uint8_t*>(base);
  if (memcmp(b, "TPMA", 4) != 0) {
    munmap(base, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  ArenaWriter* w = new ArenaWriter();
  w->base = b;
  w->size = static_cast<size_t>(st.st_size);
  memcpy(&w->capacity, b + 8, 8);
  memcpy(&w->stride, b + 16, 4);
  memcpy(&w->key_cap, b + 20, 4);
  w->slot_size = (kSlotHdr + w->key_cap + w->stride + 7) & ~7ull;
  if (w->capacity == 0 ||
      kHeaderSize + w->capacity * w->slot_size > w->size) {
    munmap(base, w->size);
    delete w;
    return nullptr;
  }
  w->stats = map_stats(dir, /*writable=*/true);  // nullptr tolerated
  return w;
}

void tpums_arena_writer_close(void* h) {
  ArenaWriter* w = as_writer(h);
  if (w == nullptr) return;
  munmap(w->base, w->size);
  if (w->stats != nullptr) munmap(w->stats, kStatsSize);
  delete w;
}

long long tpums_arena_put_batch(void* h, const char* kbuf,
                                uint64_t kbuf_len, const char* vbuf,
                                uint64_t vbuf_len, uint64_t n,
                                uint32_t* max_klen_out,
                                uint32_t* max_vlen_out) {
  ArenaWriter* w = as_writer(h);
  if (w == nullptr || kbuf == nullptr || vbuf == nullptr) return -1;
  WriteCpuSection cpu(w->stats);
  struct timespec t0;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  const char* kp = kbuf;
  const char* kend = kbuf + kbuf_len;
  const char* vp = vbuf;
  const char* vend = vbuf + vbuf_len;
  uint32_t maxk = 0, maxv = 0;
  // Parse kAhead rows ahead of the apply point and prefetch each row's
  // home slot: hash-distributed slots in a multi-hundred-MB mapping miss
  // every cache level, and without the pipeline that miss serializes with
  // the row walk (~one full memory round-trip per row).  Parsing ahead
  // overlaps up to kAhead misses with useful work.
  constexpr uint64_t kAhead = 8;
  struct ParsedRow {
    const char* k;
    const char* v;
    uint32_t klen, vlen;
  };
  ParsedRow ring[kAhead];
  uint64_t parsed = 0, applied = 0;
  for (;;) {
    while (parsed < n && parsed - applied < kAhead) {
      const char* knl = kend;
      const char* vnl = vend;
      if (parsed + 1 < n) {
        knl = static_cast<const char*>(memchr(kp, '\n', kend - kp));
        vnl = static_cast<const char*>(memchr(vp, '\n', vend - vp));
        if (knl == nullptr || vnl == nullptr) return -1;  // malformed blobs
      }
      ParsedRow& p = ring[parsed % kAhead];
      p.k = kp;
      p.klen = static_cast<uint32_t>(knl - kp);
      p.v = vp;
      p.vlen = static_cast<uint32_t>(vnl - vp);
      if (p.klen <= w->key_cap && p.vlen <= w->stride) {
        uint8_t* slot = w->base + kHeaderSize +
                        (fnv1a(p.k, p.klen) % w->capacity) * w->slot_size;
        __builtin_prefetch(slot, 1, 1);
        __builtin_prefetch(slot + kSlotHdr + w->key_cap, 1, 1);
      }
      kp = knl + 1;
      vp = vnl + 1;
      ++parsed;
    }
    if (applied == parsed) break;  // drained (or n == 0)
    ParsedRow& p = ring[applied % kAhead];
    // oversize row or load ceiling: stop HERE and report the applied
    // prefix — the Python caller puts the blocker through its growth
    // path, reopens the writer on the new generation, and resumes
    if (p.klen > w->key_cap || p.vlen > w->stride) break;
    if (!put_row(w, p.k, p.klen, p.v, p.vlen)) break;
    if (p.klen > maxk) maxk = p.klen;
    if (p.vlen > maxv) maxv = p.vlen;
    ++applied;
  }
  struct timespec t1;
  clock_gettime(CLOCK_MONOTONIC, &t1);
  stats_add(w->stats, kStatsBatchRows, applied);
  stats_add(w->stats, kStatsBatchNs,
            static_cast<uint64_t>(t1.tv_sec - t0.tv_sec) * 1000000000ull +
                static_cast<uint64_t>(t1.tv_nsec - t0.tv_nsec));
  if (max_klen_out) *max_klen_out = maxk;
  if (max_vlen_out) *max_vlen_out = maxv;
  return static_cast<long long>(applied);
}

int tpums_arena_cas_floats(void* h, const char* k, uint32_t klen,
                           const char* expect, uint32_t explen,
                           const char* newv, uint32_t newlen) {
  ArenaWriter* w = as_writer(h);
  if (w == nullptr || klen > w->key_cap || newlen > w->stride ||
      explen > w->stride)
    return -1;
  WriteCpuSection cpu(w->stats);
  uint64_t cap = w->capacity;
  uint64_t idx = fnv1a(k, klen) % cap;
  for (uint64_t probes = 0; probes < cap; ++probes) {
    uint8_t* slot = w->base + kHeaderSize + idx * w->slot_size;
    uint32_t seq = load_u32_rlx(slot);
    uint32_t cur_klen = load_u32_rlx(slot + 4);
    if (seq == 0 && cur_klen == 0) return -1;  // chain end: key missing
    if (cur_klen == klen && memcmp(slot + kSlotHdr, k, klen) == 0) {
      uint32_t vlen = load_u32_rlx(slot + 8);
      // an odd seq here is a dead prior writer's abandoned claim — the
      // value bytes are unreadable, so report a mismatch and let the
      // caller's LWW re-put repair the slot to even
      if ((seq & 1) != 0 || vlen != explen ||
          memcmp(slot + kSlotHdr + w->key_cap, expect, explen) != 0) {
        stats_add(w->stats, kStatsCasRetry, 1);
        return 0;
      }
      store_u32_rlx(slot, seq | 1);
      __atomic_signal_fence(__ATOMIC_SEQ_CST);
      seqlock_copy(slot + kSlotHdr + w->key_cap, newv, newlen);
      store_u32_rlx(slot + 8, newlen);
      store_u32_rel(slot, (seq | 1) + 1);
      bump_mutations(w);
      stats_add(w->stats, kStatsCasSuccess, 1);
      return 1;
    }
    if (++idx == cap) idx = 0;
  }
  return -1;
}

}  // extern "C"

// -- dispatch targets (store.cpp routes arena-tagged handles here) ---------

char* tpums_arena_get_impl(void* h, const char* k, uint32_t klen,
                           uint32_t* vlen_out, int* err_out) {
  if (err_out) *err_out = 0;
  ArenaHandle* a = static_cast<ArenaHandle*>(h);
  Mapping* m = live_mapping(a);
  if (m == nullptr || klen > m->key_cap) return nullptr;
  uint64_t idx = fnv1a(k, klen) % m->capacity;
  std::string key, val;
  for (uint64_t probes = 0; probes < m->capacity; ++probes) {
    int rc = read_slot(a, m, idx, &key, &val);
    if (rc == 0) return nullptr;  // empty slot: chain end, key missing
    if (rc == 1 && key.size() == klen && memcmp(key.data(), k, klen) == 0) {
      char* buf = static_cast<char*>(malloc(val.size() ? val.size() : 1));
      if (!buf) {
        if (err_out) *err_out = 1;
        return nullptr;
      }
      memcpy(buf, val.data(), val.size());
      *vlen_out = static_cast<uint32_t>(val.size());
      return buf;
    }
    // rc == -1 (odd-stuck/torn): the slot holds no readable row — keep
    // probing; a repaired duplicate of the dead claim lives further on
    if (++idx == m->capacity) idx = 0;
  }
  return nullptr;
}

uint64_t tpums_arena_count_impl(void* h) {
  ArenaHandle* a = static_cast<ArenaHandle*>(h);
  Mapping* m = live_mapping(a);
  return m == nullptr ? 0 : load_u64(m->base + 24);
}

int tpums_arena_keys_impl(void* h, tpums_key_cb cb, void* ctx) {
  ArenaHandle* a = static_cast<ArenaHandle*>(h);
  Mapping* m = live_mapping(a);
  if (m == nullptr) return 0;
  std::string key, val;
  for (uint64_t idx = 0; idx < m->capacity; ++idx) {
    if (read_slot(a, m, idx, &key, &val) == 1)
      cb(key.data(), static_cast<uint32_t>(key.size()), ctx);
  }
  return 0;
}

uint64_t tpums_arena_keys_chunk_impl(void* h, uint64_t* cursor,
                                     uint64_t max_keys, tpums_key_cb cb,
                                     void* ctx) {
  ArenaHandle* a = static_cast<ArenaHandle*>(h);
  Mapping* m = live_mapping(a);
  if (m == nullptr) {
    return 0;
  }
  uint64_t emitted = 0;
  uint64_t idx = *cursor;
  std::string key, val;
  for (; idx < m->capacity && emitted < max_keys; ++idx) {
    if (read_slot(a, m, idx, &key, &val) == 1) {
      cb(key.data(), static_cast<uint32_t>(key.size()), ctx);
      ++emitted;
    }
  }
  *cursor = idx;
  return emitted;
}

uint64_t tpums_arena_log_bytes_impl(void* h) {
  // The store's log_bytes is its index-version proxy (top-k/DOT builders
  // pair it with count to detect churn).  In-place arena updates move
  // neither count nor file size, so the writer bumps a header mutation
  // counter — report that, preserving "changed bytes == changed state".
  ArenaHandle* a = static_cast<ArenaHandle*>(h);
  Mapping* m = live_mapping(a);
  return m == nullptr ? 0 : load_u64(m->base + 48);
}

uint64_t tpums_arena_live_bytes_impl(void* h) {
  ArenaHandle* a = static_cast<ArenaHandle*>(h);
  Mapping* m = live_mapping(a);
  if (m == nullptr) return 0;
  struct stat st;
  if (stat(m->path.c_str(), &st) != 0) return 0;
  return static_cast<uint64_t>(st.st_blocks) * 512ull;
}

void tpums_arena_close_impl(void* h) {
  ArenaHandle* a = static_cast<ArenaHandle*>(h);
  Mapping* m = a->cur.load(std::memory_order_acquire);
  if (m != nullptr) {
    munmap(m->base, m->size);
    delete m;
  }
  for (Mapping* old : a->superseded) {
    munmap(old->base, old->size);
    delete old;
  }
  uint8_t* st = a->wstats.load(std::memory_order_acquire);
  if (st != nullptr) munmap(st, kStatsSize);
  delete a;
}
