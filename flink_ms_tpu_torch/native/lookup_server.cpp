// Epoll TCP lookup server — the native serving data plane.
//
// TPU-native counterpart of the Flink queryable-state (Netty KvState) server
// answering QueryClientHelper.queryState (QueryClientHelper.java:104-139).
// Speaks the exact line protocol of flink_ms_tpu_torch/serve/server.py so the
// Python query clients work unchanged:
//
//   GET\t<state>\t<key>\n   ->  V\t<value>\n | N\n | E\t<msg>\n
//   MGET\t<state>\t<k1>,<k2>,...\n
//                           ->  M\t<i1>\t<i2>...\n  (per key, in order:
//                               N missing, V<value> found — one round trip
//                               for a whole batch of point lookups)
//   COUNT\t<state>\n        ->  C\t<n>\n  (live key count via tpums_count)
//   PING\n                  ->  PONG\t<job_id>\t<state>\n
//   TOPK\t<state>\t<id>\t<k>\n    ->  V\titem:score;...\n | N\n | E\t...\n
//   TOPKV\t<state>\t<k>\t<f;..>\n ->  V\titem:score;...\n | E\t...\n
//                               (enabled via tpums_server_start2 suffixes;
//                               unconfigured servers answer E for parity
//                               with a Python LookupServer that has no
//                               registered handler)
//
// Top-k scoring (serve/topk.py semantics, ALSPredict.java:74-83's dot
// product run catalog-wide): the catalog is every store key with the item
// suffix (modal payload width wins, malformed rows dropped — the same
// policy as DeviceFactorIndex._snapshot_rows), scored against the query
// vector.  Ranking uses lax.top_k's total order (NaN above +inf) with
// ties to the lower catalog row; the catalog is id-sorted so ties are
// deterministic across rebuilds (the Python plane's tie order is its
// table's insertion order, so tie parity across planes is not promised).
// The index is cached and rebuilt only when the store's (count,
// log_bytes) pair moves — every put/delete/ingest changes log_bytes, so
// a static model pays one scan then serves from the cache.  TOPK/TOPKV
// run on a dedicated worker thread with in-order deferred replies, so
// they never head-of-line-block point lookups on the epoll thread.
//
// One epoll thread, level-triggered, nonblocking sockets; per-connection
// in/out buffers; EPOLLOUT armed only while a response is partially written.
// Store reads go through the public tpums_get API (internally mutex'd), so
// the journal-consumer thread can keep writing while this thread serves.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <locale.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <time.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>

// io_uring is build-gated on the kernel headers (no liburing dependency —
// raw __NR_io_uring_* syscalls) and runtime-gated on a setup probe, so the
// same binary runs on kernels without it (epoll + sendmsg fallback).
#if __has_include(<linux/io_uring.h>)
#include <linux/io_uring.h>
#include <sys/syscall.h>
#define TPUMS_HAVE_URING 1
#endif

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cmath>
#include <memory>
#include <mutex>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <cstdlib>
#include <map>
#include <numeric>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "tpums.h"

namespace {

constexpr size_t kMaxLine = 1u << 20;   // 1 MB request line cap
constexpr size_t kReadChunk = 64 * 1024;
// Slow-reader protection: a client that pipelines requests without draining
// responses gets disconnected once this much response data is buffered.
constexpr size_t kMaxOutBuffer = 16u << 20;
// Fairness on the single epoll thread: after this many chunks the handler
// returns; level-triggered epoll re-delivers EPOLLIN for the remainder.
constexpr int kMaxChunksPerEvent = 16;

// A reply slot filled asynchronously by the top-k worker thread.  The
// worker writes `text` then publishes with ready.store(release); the epoll
// thread consumes slots strictly in FIFO order per connection, so
// pipelined requests keep their reply order even when a slow TOPK sits
// between two instant GETs.
struct PendingReply {
  std::atomic<bool> ready{false};
  std::string text;
  size_t req_bytes = 0;  // queued request payload accounted to the conn
  std::string tid;  // tab-mode echo: raw wire tid appended before the \n
};

// Cap on unconsumed reply slots per connection — a client flooding TOPKs
// without reading responses is a slow reader by another name.
constexpr size_t kMaxPendingReplies = 4096;

// --------------------------------------------------------------------------
// B2 binary batch framing (serve/proto.py is the spec; this decoder is
// byte-parity-tested against it).  A connection starts in tab mode and
// switches after a successful "HELLO\tB2" line; frames then flow both ways:
//   b"B2" varint(body_len) body;  body = varint(count) records...
// Request record: opcode byte + per-verb fields, each varint(len)+utf8.
// Reply record: varint(len) + the tab reply line without its newline.
constexpr size_t kMaxFrameBody = 8u << 20;  // matches proto.MAX_REQUEST_BODY
constexpr int kMaxVarintBytes = 10;

// Opcode table — must stay in lockstep with proto.OPCODES/FIELD_COUNTS.
struct VerbSpec {
  const char* verb;
  int fields;
};
const VerbSpec kVerbByOp[] = {
    {nullptr, 0},   {"GET", 2},   {"MGET", 2},  {"TOPK", 3},  {"TOPKV", 3},
    {"DOT", 3},     {"COUNT", 1}, {"HEALTH", 1}, {"METRICS", 0}, {"PING", 0},
};
constexpr int kMaxOpcode = 9;

// One in-order output unit: either a single tab reply line (count == 1) or
// a whole B2 reply frame spanning `count` pending slots.  A frame is only
// serialized once ALL its slots are ready — the frame header carries the
// total length, so it cannot stream record by record.
struct OutUnit {
  bool frame = false;
  uint32_t count = 1;
};

// Chunked output buffer: replies accumulate as a deque of coalesced
// chunks instead of one string, so the per-wakeup flush can hand the
// WHOLE backlog to one scatter-gather sendmsg (or one io_uring SQE)
// without re-copying, and a partial send consumes from the front in
// place instead of erase()-shifting megabytes.
struct OutBuf {
  std::deque<std::string> q;
  size_t head = 0;   // bytes of q.front() already sent
  size_t bytes = 0;  // total unsent bytes
  static constexpr size_t kCoalesce = 64 * 1024;

  bool empty() const { return bytes == 0; }
  size_t size() const { return bytes; }

  void append(const char* p, size_t n) {
    if (n == 0) return;
    if (q.empty() || q.back().size() + n > kCoalesce) q.emplace_back();
    q.back().append(p, n);
    bytes += n;
  }
  void append(const std::string& s) { append(s.data(), s.size()); }
  void take(std::string&& s) {  // move large blobs in without a copy
    if (s.empty()) return;
    bytes += s.size();
    if (!q.empty() && q.back().size() + s.size() <= kCoalesce) {
      q.back() += s;
    } else {
      q.push_back(std::move(s));
    }
  }
  size_t fill_iov(struct iovec* iov, size_t max_iov) const {
    size_t n = 0;
    size_t skip = head;  // only the front chunk has sent bytes
    for (const std::string& c : q) {
      if (n == max_iov) break;
      iov[n].iov_base = const_cast<char*>(c.data()) + skip;
      iov[n].iov_len = c.size() - skip;
      skip = 0;
      ++n;
    }
    return n;
  }
  void consume(size_t n) {
    bytes -= n;
    while (n > 0) {
      size_t avail = q.front().size() - head;
      if (n < avail) {
        head += n;
        return;
      }
      n -= avail;
      q.pop_front();
      head = 0;
    }
  }
};

struct Conn {
  int fd = -1;
  std::string in;   // bytes read, not yet parsed into complete lines
  OutBuf out;       // response bytes not yet written
  bool dirty = false;  // queued for the end-of-batch flush
  std::deque<std::shared_ptr<PendingReply>> pending;  // in-order reply slots
  std::deque<OutUnit> units;  // groups pending slots into lines/frames
  size_t pending_req_bytes = 0;  // queued TOPK request payload bytes
  bool writable_armed = false;
  bool eof = false;  // client half-closed: answer what's buffered, then close
  bool binary = false;  // negotiated B2: c->in holds frames, not lines
  bool b2_trace = false;  // HELLO tr=1: every request record carries one
                          // extra trailing trace field (possibly empty)
  bool fatal = false;   // corrupt frame: error frame queued, close after flush
};

// Cached catalog index for TOPK/TOPKV: an immutable row-major (n, width)
// snapshot swapped in whole.  All top-k work (including the first build)
// runs on the dedicated worker thread, so the point-lookup hot path on
// the epoll thread never waits on an O(catalog) scan; once a snapshot
// exists, a moved store version kicks ONE further-background rebuild
// while queries keep answering from the current (briefly stale) snapshot —
// the same serve-stale design as serve/topk.py.
struct TopkIndex {
  std::vector<std::string> ids;
  std::vector<float> matrix;
  int width = 0;
  uint64_t ver_count = ~0ull;
  uint64_t ver_bytes = ~0ull;
};

// Merged sparse-weight index for the DOT verb (serve/server.py
// _merged_range_index parity): every store row whose key is an integer
// bucket id and whose payload parses as ``idx:w;...`` contributes its
// pairs; duplicate feature ids resolve last-wins after a stable sort.
// Same immutable-snapshot + serve-stale lifecycle as TopkIndex.
struct DotIndex {
  std::vector<long long> fids;  // ascending
  std::vector<double> ws;       // aligned with fids
  std::unordered_set<long long> buckets;
  uint64_t ver_count = ~0ull;
  uint64_t ver_bytes = ~0ull;
};

// One queued unit of worker-thread work (TOPK/TOPKV/DOT): the raw request
// operands plus the reply slot already enqueued on the owning connection.
// The shared_ptr keeps the slot alive even if the connection closes
// before the work finishes.
struct TopkTask {
  std::shared_ptr<PendingReply> reply;
  std::string verb, state, query_arg, k_s;
  double t0 = 0.0;  // submit time: worker observes latency incl. queue wait
  std::string tid;     // raw wire tid when the request was traced
  double t0_wall = 0.0;  // wall-clock twin of t0, for span records
};

// Per-verb serving stats on the shared log-bucket ladder (obs/metrics.py
// LATENCY_BUCKETS_S, passed in through tpums_server_start3 so the bounds
// are equal by construction, never re-derived in float math here).  The
// METRICS verb renders these as the same one-line JSON snapshot the Python
// registry emits, so obs/scrape.py merges native and Python workers alike.
struct VerbStat {
  std::vector<uint64_t> counts;  // len(bounds) + 1 (+Inf slot)
  double sum = 0.0;
  uint64_t count = 0;
  uint64_t errors = 0;
  // CPU self-time (CLOCK_THREAD_CPUTIME_ID) spent ANSWERING this verb —
  // the native plane's contribution to the continuous-profiling plane
  // (obs/profiler.py): no sampler runs here, the handler sections are
  // measured directly and exported both as
  // tpums_native_self_seconds_total counters (METRICS) and as synthetic
  // "native;<verb>" folded stacks (PROFILE), so fleet profile merges
  // carry C++ cost next to Python samples in the same seconds unit.
  double cpu_s = 0.0;
};

#ifdef TPUMS_HAVE_URING
// Minimal synchronous io_uring submission ring (no liburing): the epoll
// thread stages one IORING_OP_SENDMSG SQE per dirty connection at the end
// of each wakeup, then ONE io_uring_enter(submit=N, min_complete=N)
// replaces N sendmsg syscalls.  Every send carries MSG_DONTWAIT so a full
// socket buffer completes immediately with -EAGAIN (never parks the ring
// in internal poll-retry, which would stall the whole event loop behind
// one slow reader); leftovers fall back to EPOLLOUT re-arming exactly
// like the non-uring path.
struct Uring {
  int ring_fd = -1;
  unsigned entries = 0;
  unsigned* sq_tail = nullptr;
  unsigned* sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  io_uring_sqe* sqes = nullptr;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned* cq_mask = nullptr;
  io_uring_cqe* cqes = nullptr;
  void* sq_ptr = nullptr;
  size_t sq_sz = 0;
  void* cq_ptr = nullptr;  // == sq_ptr under IORING_FEAT_SINGLE_MMAP
  size_t cq_sz = 0;
  void* sqes_ptr = nullptr;
  size_t sqes_sz = 0;
};

bool uring_init(Uring* u, unsigned want_entries) {
  struct io_uring_params p;
  memset(&p, 0, sizeof(p));
  int fd = static_cast<int>(syscall(__NR_io_uring_setup, want_entries, &p));
  if (fd < 0) return false;  // kernel/seccomp says no — fallback path
  u->ring_fd = fd;
  u->entries = p.sq_entries;
  u->sq_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
  u->cq_sz = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
  bool single = (p.features & IORING_FEAT_SINGLE_MMAP) != 0;
  if (single) u->sq_sz = u->cq_sz = std::max(u->sq_sz, u->cq_sz);
  u->sq_ptr = mmap(nullptr, u->sq_sz, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
  if (u->sq_ptr == MAP_FAILED) {
    close(fd);
    u->ring_fd = -1;
    return false;
  }
  u->cq_ptr = u->sq_ptr;
  if (!single) {
    u->cq_ptr = mmap(nullptr, u->cq_sz, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING);
    if (u->cq_ptr == MAP_FAILED) {
      munmap(u->sq_ptr, u->sq_sz);
      close(fd);
      u->ring_fd = -1;
      return false;
    }
  }
  u->sqes_sz = p.sq_entries * sizeof(io_uring_sqe);
  u->sqes_ptr = mmap(nullptr, u->sqes_sz, PROT_READ | PROT_WRITE,
                     MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQES);
  if (u->sqes_ptr == MAP_FAILED) {
    if (!single) munmap(u->cq_ptr, u->cq_sz);
    munmap(u->sq_ptr, u->sq_sz);
    close(fd);
    u->ring_fd = -1;
    return false;
  }
  uint8_t* sqb = static_cast<uint8_t*>(u->sq_ptr);
  u->sq_tail = reinterpret_cast<unsigned*>(sqb + p.sq_off.tail);
  u->sq_mask = reinterpret_cast<unsigned*>(sqb + p.sq_off.ring_mask);
  u->sq_array = reinterpret_cast<unsigned*>(sqb + p.sq_off.array);
  u->sqes = static_cast<io_uring_sqe*>(u->sqes_ptr);
  uint8_t* cqb = static_cast<uint8_t*>(u->cq_ptr);
  u->cq_head = reinterpret_cast<unsigned*>(cqb + p.cq_off.head);
  u->cq_tail = reinterpret_cast<unsigned*>(cqb + p.cq_off.tail);
  u->cq_mask = reinterpret_cast<unsigned*>(cqb + p.cq_off.ring_mask);
  u->cqes = reinterpret_cast<io_uring_cqe*>(cqb + p.cq_off.cqes);
  return true;
}

void uring_destroy(Uring* u) {
  if (u->ring_fd < 0) return;
  munmap(u->sqes_ptr, u->sqes_sz);
  if (u->cq_ptr != u->sq_ptr) munmap(u->cq_ptr, u->cq_sz);
  munmap(u->sq_ptr, u->sq_sz);
  close(u->ring_fd);
  u->ring_fd = -1;
}
#endif  // TPUMS_HAVE_URING

struct ServerState {
  void* store = nullptr;
  std::string state_name;
  std::string job_id;
  std::string topk_item_suffix;  // non-empty = TOPK/TOPKV enabled
  std::string topk_user_suffix;
  std::mutex topk_mu;            // guards topk_cur swaps
  std::shared_ptr<const TopkIndex> topk_cur;
  std::atomic<bool> topk_building{false};
  std::thread topk_builder;      // spawned/reaped on the topk worker thread
                                 // only; final join in tpums_server_stop
  std::mutex dot_mu;             // guards dot_cur swaps
  std::shared_ptr<const DotIndex> dot_cur;
  std::atomic<bool> dot_building{false};
  std::thread dot_builder;       // same lifecycle as topk_builder
  // TOPK/TOPKV execute on a dedicated worker thread so an O(catalog)
  // index build or score can never head-of-line-block the point-lookup
  // hot path on the epoll thread (the Python plane gets the same
  // isolation from its thread-per-connection model)
  std::mutex task_mu;
  std::condition_variable task_cv;
  std::deque<TopkTask> tasks;
  std::thread topk_worker;
  std::atomic<bool> worker_stop{false};
  int listen_fd = -1;
  int epoll_fd = -1;
  int wake_fd = -1;  // eventfd: poked by tpums_server_stop
  int port = 0;
  std::string host_str;  // bind host, echoed in HEALTH's metrics_uri
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> requests{0};
  std::thread loop;
  std::unordered_map<int, Conn> conns;
  // Reply-path syscall accounting (tpums_server_io_stats): the syscall-
  // batching tests compute deltas from these instead of strace, which a
  // restricted host may not allow.  reply_syscalls counts send-side syscalls
  // (sendmsg calls, or io_uring_enter submissions — one per BATCH of
  // dirty connections); recv_calls counts recv() invocations.
  std::atomic<uint64_t> reply_syscalls{0};
  std::atomic<uint64_t> recv_calls{0};
  std::atomic<uint64_t> reply_bytes{0};
  bool uring_on = false;  // runtime probe outcome (TPUMS_URING knob)
  std::vector<int> dirty_fds;  // epoll-thread-only: this batch's flush set
#ifdef TPUMS_HAVE_URING
  Uring uring;
#endif
  // METRICS/HEALTH surface (empty lat_bounds = start2 compat: METRICS
  // answers E\tbad request exactly like a server without the ladder)
  std::vector<double> lat_bounds;
  std::mutex metrics_mu;  // guards verb_stats (epoll + worker threads)
  std::map<std::string, VerbStat> verb_stats;  // ordered => stable JSON
  std::mutex health_mu;
  std::string health_json;  // last report pushed via tpums_server_set_health
  // Tail-forensics span spill (obs/tracing.py JSONL schema): path set via
  // tpums_server_set_trace; every TRACED request (trailing tab ``tid=``
  // field, or the B2 ``tr=1`` per-record trace field) appends ONE
  // server_reply span record.  Untraced requests never touch this.
  std::mutex trace_mu;
  std::string trace_path;  // empty = span spill off
  long long trace_max_bytes = 64ll << 20;
  int trace_keep = 3;
  long long trace_file_bytes = -1;  // -1 = stat on next append
  std::atomic<uint64_t> span_seq{0};
};

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Wall clock for span records: forensics correlates spans ACROSS processes
// by timestamp, so span t0/ts must be system_clock (now_s() is steady_clock
// and only comparable within this process).
double wall_s() {
  return std::chrono::duration<double>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

// Minimal JSON string escape — tids/verbs come off the wire.
void json_escape_into(std::string& out, const std::string& v) {
  for (unsigned char ch : v) {
    if (ch == '"' || ch == '\\') {
      out.push_back('\\');
      out.push_back(static_cast<char>(ch));
    } else if (ch < 0x20) {
      char buf[8];
      snprintf(buf, sizeof buf, "\\u%04x", ch);
      out += buf;
    } else {
      out.push_back(static_cast<char>(ch));
    }
  }
}

// Size-capped keep-K rotation, mirroring obs/tracing._rotate_locked:
// path -> path.1 -> ... -> path.K, oldest dropped.  Caller holds trace_mu.
void trace_rotate_locked(ServerState* s) {
  const std::string& p = s->trace_path;
  if (s->trace_keep == 0) {
    ::remove(p.c_str());
  } else {
    for (int i = s->trace_keep - 1; i >= 1; --i) {
      std::string src = p + "." + std::to_string(i);
      ::rename(src.c_str(), (p + "." + std::to_string(i + 1)).c_str());
    }
    ::rename(p.c_str(), (p + ".1").c_str());
  }
  s->trace_file_bytes = 0;
}

// Append one server_reply span record for a traced request.  The raw wire
// tid may be the ``tid/sid`` composite (obs/tracing.wire_tid): the part
// after the slash is the CLIENT's rpc span id, recorded here as psid so
// forensics parents this server span under the caller's tree.
void trace_spill(ServerState* s, const std::string& raw_tid,
                 const std::string& verb, double t0_wall, double dur_s,
                 double queue_s, double serve_s, bool is_err) {
  std::lock_guard<std::mutex> g(s->trace_mu);
  if (s->trace_path.empty()) return;
  std::string tid = raw_tid, psid;
  size_t slash = raw_tid.find('/');
  if (slash != std::string::npos) {
    tid = raw_tid.substr(0, slash);
    psid = raw_tid.substr(slash + 1);
  }
  // sid: port-salted sequence — unique across the servers a fanned-out
  // trace touches, which is all tree assembly needs
  char sid[24];
  snprintf(sid, sizeof sid, "%04x%06llx",
           static_cast<unsigned>(s->port & 0xffff),
           static_cast<unsigned long long>(
               (s->span_seq.fetch_add(1, std::memory_order_relaxed) + 1) &
               0xffffff));
  char num[48];
  std::string line = "{\"ts\":";
  snprintf(num, sizeof num, "%.6f", wall_s());
  line += num;
  line += ",\"tid\":\"";
  json_escape_into(line, tid);
  line += "\",\"kind\":\"server_reply\",\"plane\":\"native\",\"sid\":\"";
  line += sid;
  line += "\"";
  if (!psid.empty()) {
    line += ",\"psid\":\"";
    json_escape_into(line, psid);
    line += "\"";
  }
  snprintf(num, sizeof num, ",\"t0\":%.6f", t0_wall);
  line += num;
  snprintf(num, sizeof num, ",\"dur_s\":%.9f", dur_s);
  line += num;
  line += ",\"verb\":\"";
  json_escape_into(line, verb);
  line += "\",\"job_id\":\"";
  json_escape_into(line, s->job_id);
  line += "\",\"port\":" + std::to_string(s->port);
  snprintf(num, sizeof num, ",\"lat_s\":%.6f", dur_s);
  line += num;
  snprintf(num, sizeof num, ",\"queue_wait_s\":%.9f", queue_s);
  line += num;
  snprintf(num, sizeof num, ",\"serve_s\":%.9f", serve_s);
  line += num;
  line += is_err ? ",\"ok\":false}\n" : ",\"ok\":true}\n";
  if (s->trace_file_bytes < 0) {
    struct stat st;
    s->trace_file_bytes =
        (stat(s->trace_path.c_str(), &st) == 0) ? st.st_size : 0;
  }
  if (s->trace_file_bytes >= s->trace_max_bytes && s->trace_max_bytes > 0) {
    trace_rotate_locked(s);
  }
  FILE* f = fopen(s->trace_path.c_str(), "a");
  if (!f) return;
  fwrite(line.data(), 1, line.size(), f);
  fclose(f);
  s->trace_file_bytes += static_cast<long long>(line.size());
}

// This thread's consumed CPU seconds (user+sys).  Cost of one
// clock_gettime on the hot path is ~25ns (vDSO) — two calls bracket each
// handler section, well inside the enforced <=3% profiling-overhead bar.
double thread_cpu_s() {
  struct timespec ts;
  if (clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts) != 0) return 0.0;
  return static_cast<double>(ts.tv_sec) + ts.tv_nsec * 1e-9;
}

void observe_verb(ServerState* s, const std::string& verb, double dt,
                  bool is_err, double cpu_s = 0.0) {
  if (s->lat_bounds.empty()) return;
  std::lock_guard<std::mutex> g(s->metrics_mu);
  VerbStat& st = s->verb_stats[verb.empty() ? "?" : verb];
  if (st.counts.empty()) st.counts.assign(s->lat_bounds.size() + 1, 0);
  // bucket index: first bound >= dt (std::lower_bound == bisect_left —
  // the Python Histogram.observe rule, so cross-plane merges line up)
  size_t i = std::lower_bound(s->lat_bounds.begin(), s->lat_bounds.end(),
                              dt) -
             s->lat_bounds.begin();
  st.counts[i] += 1;
  st.sum += dt;
  st.count += 1;
  if (is_err) st.errors += 1;
  if (cpu_s > 0.0) st.cpu_s += cpu_s;
}

bool set_nonblocking(int fd) {
  int flags = fcntl(fd, F_GETFL, 0);
  return flags >= 0 && fcntl(fd, F_SETFL, flags | O_NONBLOCK) == 0;
}

// Unsigned LEB128, appended in place (frame headers and reply records).
void append_varint(std::string& out, uint64_t v) {
  while (true) {
    uint8_t b = v & 0x7F;
    v >>= 7;
    if (v) {
      out.push_back(static_cast<char>(b | 0x80));
    } else {
      out.push_back(static_cast<char>(b));
      return;
    }
  }
}

// 0 = ok (value/pos updated), 1 = need more bytes, 2 = malformed (>10 bytes).
int parse_varint(const char* data, size_t size, size_t* pos, uint64_t* out) {
  uint64_t value = 0;
  int shift = 0;
  for (int i = 0; i < kMaxVarintBytes; ++i) {
    if (*pos + i >= size) return 1;
    uint8_t b = static_cast<uint8_t>(data[*pos + i]);
    value |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *pos += i + 1;
      *out = value;
      return 0;
    }
    shift += 7;
  }
  return 2;
}

// Strict UTF-8 validation with Python codec semantics (rejects overlongs,
// surrogates, > U+10FFFF): binary record fields must decode on the Python
// plane too, so a field Python would refuse is a malformed frame here.
bool utf8_valid(const char* p, size_t n) {
  size_t i = 0;
  while (i < n) {
    unsigned char c = static_cast<unsigned char>(p[i]);
    if (c < 0x80) {
      ++i;
      continue;
    }
    int len;
    uint32_t cp, min_cp;
    if ((c & 0xE0) == 0xC0) {
      len = 2; cp = c & 0x1F; min_cp = 0x80;
    } else if ((c & 0xF0) == 0xE0) {
      len = 3; cp = c & 0x0F; min_cp = 0x800;
    } else if ((c & 0xF8) == 0xF0) {
      len = 4; cp = c & 0x07; min_cp = 0x10000;
    } else {
      return false;
    }
    if (i + static_cast<size_t>(len) > n) return false;
    for (int j = 1; j < len; ++j) {
      unsigned char cc = static_cast<unsigned char>(p[i + j]);
      if ((cc & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (cc & 0x3F);
    }
    if (cp < min_cp || cp > 0x10FFFF || (cp >= 0xD800 && cp <= 0xDFFF))
      return false;
    i += len;
  }
  return true;
}

// json.dumps(..., ensure_ascii=True) string escaping: ASCII passes, the two
// JSON metas escape, controls and non-ASCII become \uXXXX (surrogate pairs
// past the BMP).  Invalid UTF-8 degrades to U+FFFD rather than emitting
// bytes that would break the one-line-JSON contract.
void escape_json_into(std::string& out, const std::string& in) {
  size_t i = 0, n = in.size();
  char tmp[16];
  while (i < n) {
    unsigned char c = static_cast<unsigned char>(in[i]);
    if (c == '"') {
      out += "\\\"";
      ++i;
    } else if (c == '\\') {
      out += "\\\\";
      ++i;
    } else if (c < 0x20) {
      switch (c) {
        case '\n': out += "\\n"; break;
        case '\t': out += "\\t"; break;
        case '\r': out += "\\r"; break;
        case '\b': out += "\\b"; break;
        case '\f': out += "\\f"; break;
        default:
          snprintf(tmp, sizeof(tmp), "\\u%04x", c);
          out += tmp;
      }
      ++i;
    } else if (c < 0x80) {
      out.push_back(static_cast<char>(c));
      ++i;
    } else {
      int len;
      uint32_t cp;
      if ((c & 0xE0) == 0xC0) {
        len = 2; cp = c & 0x1F;
      } else if ((c & 0xF0) == 0xE0) {
        len = 3; cp = c & 0x0F;
      } else if ((c & 0xF8) == 0xF0) {
        len = 4; cp = c & 0x07;
      } else {
        len = 0; cp = 0;
      }
      bool ok = len > 0 && i + static_cast<size_t>(len) <= n;
      for (int j = 1; ok && j < len; ++j) {
        unsigned char cc = static_cast<unsigned char>(in[i + j]);
        if ((cc & 0xC0) != 0x80) ok = false;
        cp = (cp << 6) | (cc & 0x3F);
      }
      if (!ok) {
        out += "\\ufffd";
        ++i;
        continue;
      }
      if (cp >= 0x10000) {
        uint32_t v = cp - 0x10000;
        snprintf(tmp, sizeof(tmp), "\\u%04x\\u%04x",
                 0xD800 + (v >> 10), 0xDC00 + (v & 0x3FF));
      } else {
        snprintf(tmp, sizeof(tmp), "\\u%04x", cp);
      }
      out += tmp;
      i += len;
    }
  }
}

std::string escape_json(const std::string& in) {
  std::string out;
  out.reserve(in.size() + 2);
  escape_json_into(out, in);
  return out;
}

// Split `line` on '\t' into at most `max_parts` pieces (last piece keeps any
// remaining tabs, matching Python's str.split("\t") when the counts line up
// because keys/payloads never contain tabs).
int split_tabs(const std::string& line, std::string* parts, int max_parts) {
  int n = 0;
  size_t start = 0;
  while (n < max_parts - 1) {
    size_t tab = line.find('\t', start);
    if (tab == std::string::npos) break;
    parts[n++] = line.substr(start, tab - start);
    start = tab + 1;
  }
  parts[n++] = line.substr(start);
  return n;
}

bool ends_with(const std::string& str, const std::string& suf) {
  return str.size() >= suf.size() &&
         str.compare(str.size() - suf.size(), suf.size(), suf) == 0;
}

// "C"-locale handle for float parse/format: the embedding process may set
// LC_NUMERIC, which would flip printf/strtod's decimal separator and break
// the wire format; uselocale() scopes the classic locale to this thread
// for the duration of one call.
locale_t c_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  return loc;
}

// Shortest round-trip float formatting matching Python's repr(float(f32)):
// the f32 score widens to double exactly; the shortest decimal is found by
// trying %.*e at increasing precision until strtod round-trips (the
// standard pre-<charconv> idiom — this toolchain's libstdc++ lacks
// floating-point to_chars), then the digits are laid out with Python's
// notation rule: scientific only when |x| >= 1e16 or 0 < |x| < 1e-4, an
// integral fixed result gains the trailing ".0", exponents keep printf's
// sign and >= 2 digits ("1e-06"), exactly like float.__repr__.
std::string format_score_d(double d) {
  if (d != d) return "nan";  // Python repr never signs NaN ("-nan" would
  // leak for the sign-bit-set QNaN that 0*inf produces)
  if (d == HUGE_VAL) return "inf";
  if (d == -HUGE_VAL) return "-inf";
  if (d == 0.0) return std::signbit(d) ? "-0.0" : "0.0";
  char buf[64];
  locale_t old = uselocale(c_locale());
  int p = 0;
  for (; p < 17; ++p) {  // p=16 (17 significant digits) always round-trips
    snprintf(buf, sizeof(buf), "%.*e", p, d);
    if (strtod(buf, nullptr) == d) break;
  }
  uselocale(old);
  // buf is "[-]d[.ddd]e±XX": minimal-precision digits can't end in '0'
  // (the shorter string denotes the same decimal and would have won)
  std::string sci(buf);
  bool neg = sci[0] == '-';
  size_t ms = neg ? 1 : 0;
  size_t epos = sci.find('e');
  std::string digits;
  digits += sci[ms];
  if (sci[ms + 1] == '.') digits += sci.substr(ms + 2, epos - ms - 2);
  int exp10 = atoi(sci.c_str() + epos + 1);
  double a = neg ? -d : d;
  std::string out = neg ? "-" : "";
  if (a >= 1e16 || a < 1e-4) {  // Python's scientific-notation rule
    out += digits.substr(0, 1);
    if (digits.size() > 1) {
      out += ".";
      out += digits.substr(1);
    }
    out += "e";
    out += (exp10 < 0) ? "-" : "+";
    int ae = exp10 < 0 ? -exp10 : exp10;
    snprintf(buf, sizeof(buf), "%02d", ae);
    out += buf;
  } else {
    int len = static_cast<int>(digits.size());
    if (exp10 >= len - 1) {  // integral: pad zeros, add ".0"
      out += digits;
      out.append(static_cast<size_t>(exp10 - (len - 1)), '0');
      out += ".0";
    } else if (exp10 >= 0) {  // decimal point inside the digit run
      out += digits.substr(0, exp10 + 1);
      out += ".";
      out += digits.substr(exp10 + 1);
    } else {  // leading "0.000..." zeros
      out += "0.";
      out.append(static_cast<size_t>(-exp10 - 1), '0');
      out += digits;
    }
  }
  return out;
}

std::string format_score(float f) {
  // the f32 score widens to double exactly, so the double repr rule applies
  return format_score_d(static_cast<double>(f));
}

// Parse one float token with Python float() semantics: outer ASCII
// whitespace stripped, one optional sign, then a general/inf/nan parse via
// strtod under the scoped "C" locale (a non-C LC_NUMERIC set by the
// embedding process would otherwise silently reject '.' decimals).  Hex
// floats and strtod's "nan(char-seq)" payload form are rejected explicitly,
// matching Python.
bool parse_float_token(const char* b, const char* e, double* out) {
  while (b < e && (*b == ' ' || *b == '\t' || *b == '\r' || *b == '\n'))
    ++b;
  while (e > b && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r' ||
                   e[-1] == '\n'))
    --e;
  if (b >= e) return false;
  bool neg = false;
  if (*b == '+' || *b == '-') {
    neg = (*b == '-');
    ++b;
    if (b < e && (*b == '+' || *b == '-')) return false;  // "+-1"
  }
  if (b >= e) return false;
  if (e - b >= 2 && b[0] == '0' && (b[1] == 'x' || b[1] == 'X')) return false;
  for (const char* p = b; p < e; ++p) {
    if (*p == '(') return false;  // strtod "nan(...)" that Python refuses
    if (*p == '\0') return false;  // NUL would truncate the C-string parse
  }
  std::string tok(b, e);
  locale_t old = uselocale(c_locale());
  char* endp = nullptr;
  double v = strtod(tok.c_str(), &endp);
  uselocale(old);
  if (endp != tok.c_str() + tok.size()) return false;
  *out = neg ? -v : v;
  return true;
}

// Parse a ";"-separated payload into doubles, skipping empty tokens (the
// Python parser's `float(t) for t if t`).  Returns false on any token that
// does not fully parse; *bad_tok receives the offender for the error
// message.
bool parse_vector(const std::string& payload, std::vector<double>* out,
                  std::string* bad_tok) {
  out->clear();
  size_t start = 0;
  while (start <= payload.size()) {
    size_t semi = payload.find(';', start);
    size_t end = (semi == std::string::npos) ? payload.size() : semi;
    if (end > start) {
      double v = 0.0;
      if (!parse_float_token(payload.data() + start, payload.data() + end,
                             &v)) {
        if (bad_tok) *bad_tok = payload.substr(start, end - start);
        return false;
      }
      out->push_back(v);
    }
    if (semi == std::string::npos) break;
    start = semi + 1;
  }
  return true;
}

// Build a fresh catalog snapshot from the store.  Width policy mirrors
// DeviceFactorIndex._snapshot_rows: modal separator count wins (ties to
// the smaller width, matching np.bincount().argmax()), rows off the modal
// width or with non-numeric tokens are dropped.  The version pair is read
// BEFORE the scan, so writes landing mid-scan leave the snapshot stale and
// the next query kicks another rebuild (convergent, never lossy).
std::shared_ptr<const TopkIndex> build_topk_index(ServerState* s) {
  auto ix = std::make_shared<TopkIndex>();
  ix->ver_count = tpums_count(s->store);
  ix->ver_bytes = tpums_log_bytes(s->store);

  // chunked enumeration: tpums_keys holds the store mutex for the WHOLE
  // scan, which would stall concurrent point gets for the full catalog
  // walk; the chunked variant bounds each lock hold.  A rehash between
  // chunks can repeat keys — the id-sorted dedup below absorbs that.
  std::vector<std::string> keys;
  uint64_t cursor = 0;
  while (tpums_keys_chunk(
             s->store, &cursor, 8192,
             [](const char* key, uint32_t klen, void* ctx) {
               static_cast<std::vector<std::string>*>(ctx)->emplace_back(
                   key, klen);
             },
             &keys) > 0) {
  }
  std::vector<std::string> ids, payloads;
  std::vector<int> widths;
  std::unordered_map<int, int> hist;
  for (const std::string& key : keys) {
    if (!ends_with(key, s->topk_item_suffix)) continue;
    if (key.rfind("MEAN", 0) == 0) continue;     // cold-start rows
    if (!key.empty() && key[0] == '\x01') continue;  // store-internal keys
    uint32_t vlen = 0;
    int err = 0;
    char* buf = tpums_get(s->store, key.data(),
                          static_cast<uint32_t>(key.size()), &vlen, &err);
    if (!buf) continue;
    std::string payload(buf, vlen);
    tpums_free_buf(buf);
    while (!payload.empty() && payload.back() == ';') payload.pop_back();
    int w = 1 + static_cast<int>(
        std::count(payload.begin(), payload.end(), ';'));
    ids.push_back(key.substr(0, key.size() - s->topk_item_suffix.size()));
    payloads.push_back(std::move(payload));
    widths.push_back(w);
    hist[w] += 1;
  }
  int modal = 0, best = 0;
  for (const auto& kv : hist) {
    if (kv.second > best || (kv.second == best && kv.first < modal)) {
      modal = kv.first;
      best = kv.second;
    }
  }
  ix->width = modal;
  // deterministic catalog order: tpums_keys enumerates the store's hash
  // buckets, which would make exact-score ties nondeterministic across
  // rebuilds — sort by id so tie-breaking is stable (lexicographically
  // smaller id wins; the Python plane's own tie order is its table's
  // insertion-dependent iteration order, so cross-plane tie parity is
  // unattainable either way and only determinism is promised)
  std::vector<uint32_t> order(ids.size());
  std::iota(order.begin(), order.end(), 0u);
  std::sort(order.begin(), order.end(), [&ids](uint32_t a, uint32_t b) {
    return ids[a] < ids[b];
  });
  std::vector<double> row;
  for (uint32_t i : order) {
    if (widths[i] != modal) continue;
    if (!ix->ids.empty() && ix->ids.back() == ids[i]) continue;  // chunk
    // rehash duplicate: id-sorted, so repeats are adjacent — keep first
    if (!parse_vector(payloads[i], &row, nullptr)) continue;
    if (static_cast<int>(row.size()) != modal) continue;
    ix->ids.push_back(std::move(ids[i]));
    for (double v : row) ix->matrix.push_back(static_cast<float>(v));
  }
  return ix;
}

// Current snapshot for a query (runs on the top-k worker thread): build
// inline the first time — only queued top-k work waits, never the epoll
// loop — then serve-stale with at most one background rebuild in flight.
std::shared_ptr<const TopkIndex> get_topk_index(ServerState* s) {
  uint64_t count = tpums_count(s->store);
  uint64_t bytes = tpums_log_bytes(s->store);
  std::shared_ptr<const TopkIndex> cur;
  {
    std::lock_guard<std::mutex> g(s->topk_mu);
    cur = s->topk_cur;
  }
  if (cur && cur->ver_count == count && cur->ver_bytes == bytes) return cur;
  if (!cur) {
    cur = build_topk_index(s);
    std::lock_guard<std::mutex> g(s->topk_mu);
    s->topk_cur = cur;
    return cur;
  }
  bool expected = false;
  if (s->topk_building.compare_exchange_strong(expected, true)) {
    if (s->topk_builder.joinable()) s->topk_builder.join();  // reap done run
    s->topk_builder = std::thread([s]() {
      auto fresh = build_topk_index(s);
      {
        std::lock_guard<std::mutex> g(s->topk_mu);
        s->topk_cur = std::move(fresh);
      }
      s->topk_building.store(false, std::memory_order_release);
    });
  }
  return cur;  // briefly stale while the rebuild runs
}

// ---------------------------------------------------------------------------
// Tile scorers: score `cnt` consecutive catalog rows against the query into
// a small L1-resident buffer.  Multi-versioned at runtime (target
// attributes, no -march build-flag change): the baseline is 4-wide SSE2 via
// the gcc/clang vector extension, the fast path 8-wide AVX2+FMA — the scan
// streams the whole matrix per query, so wider ops mainly buy bandwidth
// saturation.  Accumulation lanewise then one horizontal sum: deterministic
// per version; the cross-plane score contract allows accumulation-order
// round-off (test_native_topkv_semantic_parity_random), and the byte-parity
// fixtures are exact on any grouping.

typedef void (*ScoreTileFn)(const float*, int, const float*, size_t, size_t,
                            float*);

static void score_tile_sse2(const float* m, int w, const float* q,
                            size_t lo, size_t cnt, float* out) {
  typedef float v4sf __attribute__((vector_size(16)));
  for (size_t r = 0; r < cnt; ++r) {
    const float* row = m + (lo + r) * w;
    v4sf vacc = {0.f, 0.f, 0.f, 0.f};
    int j = 0;
    for (; j + 4 <= w; j += 4) {
      v4sf a, b;
      __builtin_memcpy(&a, row + j, sizeof a);
      __builtin_memcpy(&b, q + j, sizeof b);
      vacc += a * b;
    }
    float acc = (vacc[0] + vacc[1]) + (vacc[2] + vacc[3]);
    for (; j < w; ++j) acc += row[j] * q[j];
    out[r] = acc;
  }
}

__attribute__((target("avx2,fma")))
static void score_tile_avx2(const float* m, int w, const float* q,
                            size_t lo, size_t cnt, float* out) {
  typedef float v8sf __attribute__((vector_size(32)));
  for (size_t r = 0; r < cnt; ++r) {
    const float* row = m + (lo + r) * w;
    __builtin_prefetch(row + 16 * w);
    v8sf vacc = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int j = 0;
    for (; j + 8 <= w; j += 8) {
      v8sf a, b;
      __builtin_memcpy(&a, row + j, sizeof a);
      __builtin_memcpy(&b, q + j, sizeof b);
      vacc += a * b;
    }
    float acc = ((vacc[0] + vacc[4]) + (vacc[1] + vacc[5])) +
                ((vacc[2] + vacc[6]) + (vacc[3] + vacc[7]));
    for (; j < w; ++j) acc += row[j] * q[j];
    out[r] = acc;
  }
}

static ScoreTileFn pick_score_tile() {
  __builtin_cpu_init();
  if (__builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma"))
    return score_tile_avx2;
  return score_tile_sse2;
}

// Score the catalog against `query` and format the top-k payload
// ("item:score;..."), or an E line on a shape/parse failure.  Error
// message text matches the Python server's byte-for-byte so clients see
// one protocol regardless of plane.
std::string topk_payload(ServerState* s, const std::string& query_payload,
                         long k) {
  std::shared_ptr<const TopkIndex> ix = get_topk_index(s);
  std::vector<double> q;
  std::string bad;
  if (!parse_vector(query_payload, &q, &bad)) {
    return "E\ttopk failed: could not convert string to float: '" + bad +
           "'\n";
  }
  size_t n = ix->ids.size();
  if (n == 0) return "V\t\n";  // empty index answers an empty payload
  if (static_cast<int>(q.size()) != ix->width) {
    return "E\ttopk failed: query has " + std::to_string(q.size()) +
           " factors, index has " + std::to_string(ix->width) + "\n";
  }
  // f32 accumulation in four independent partial sums: deterministic,
  // SIMD-friendly under -O2 (no FP-reassociation license needed), and
  // closer to the Python plane's f32 matmul than the old per-row double
  // loop; the cross-plane score contract allows accumulation-order
  // round-off (test_native_topkv_semantic_parity_random).
  std::vector<float> qf(q.begin(), q.end());
  const float* m = ix->matrix.data();
  int w = ix->width;
  size_t k_eff = std::min<size_t>(static_cast<size_t>(k), n);
  // total order matching lax.top_k (measured: NaN sorts ABOVE +inf, ties
  // to the lower row index).  A plain `a > b` comparator is not a strict
  // weak ordering once NaN appears (NaN != x is true while NaN > x is
  // false) — UB for partial_sort; this ranking is total for any input.
  auto score_gt = [](float a, float b) {
    bool na = a != a, nb = b != b;
    if (na || nb) return na && !nb;
    return a > b;
  };
  // candidates carry (score, row) so no O(n) score buffer is ever
  // allocated or written — at 1M rows the old scores vector cost a 4 MB
  // zero-init plus 4 MB of stores per query
  typedef std::pair<float, uint32_t> Cand;
  auto cand_lt = [&score_gt](const Cand& a, const Cand& b) {
    if (score_gt(a.first, b.first)) return true;
    if (score_gt(b.first, a.first)) return false;
    return a.second < b.second;  // lax.top_k tie order
  };
  static const ScoreTileFn score_tile = pick_score_tile();
  auto scan_block = [&](size_t lo, size_t hi, std::vector<Cand>* out) {
    const float* qp = qf.data();
    // selection folded into the scan: score a tile into an L1-resident
    // buffer, then admit against a <=k candidate HEAP with a threshold
    // pre-test — one float compare per row on the hot path and O(log k)
    // per admission (a sorted-insert buffer would be O(k) per admission:
    // quadratic for k ~ catalog, which TOPKV explicitly allows, and
    // O(n*k) on an ascending-score catalog).  With cand_lt as the heap's
    // "less", the front is the WEAKEST candidate: the threshold test and
    // evictions read/remove exactly it.  Scanning ascending i means a new
    // candidate always carries the HIGHEST index, so tying the current
    // weakest (ties rank by lower index) never displaces it — strict
    // score_gt is the admission test.
    std::vector<Cand>& best = *out;
    best.clear();
    best.reserve(k_eff + 1);
    constexpr size_t TILE = 512;
    float buf[TILE];
    for (size_t base = lo; base < hi; base += TILE) {
      size_t cnt = std::min(TILE, hi - base);
      score_tile(m, w, qp, base, cnt, buf);
      for (size_t r = 0; r < cnt; ++r) {
        float acc = buf[r];
        if (best.size() == k_eff && !score_gt(acc, best.front().first))
          continue;
        best.push_back(Cand{acc, static_cast<uint32_t>(base + r)});
        std::push_heap(best.begin(), best.end(), cand_lt);
        if (best.size() > k_eff) {
          std::pop_heap(best.begin(), best.end(), cand_lt);
          best.pop_back();
        }
      }
    }
  };
  // O(catalog) scan + selection parallelized over contiguous row blocks
  // (a single-threaded double-accumulation scan was ~5x slower
  // than the Python plane's f32 matmul at 1M rows); small catalogs and
  // single-core hosts stay single-threaded
  unsigned hw = std::thread::hardware_concurrency();
  size_t nthreads = hw ? std::min<size_t>(hw, 8) : 1;
  // threads are spawned per query: give each at least ~128k rows so the
  // create/join cost (~0.1-0.2 ms) stays well under its share of the scan
  nthreads = std::min(nthreads, std::max<size_t>(n / 131072, 1));
  std::vector<std::vector<Cand>> cand(nthreads);
  size_t chunk = (n + nthreads - 1) / nthreads;
  std::vector<std::thread> workers;
  for (size_t t = 1; t < nthreads; ++t) {
    size_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) continue;
    workers.emplace_back(scan_block, lo, hi, &cand[t]);
  }
  scan_block(0, std::min(n, chunk), &cand[0]);
  for (auto& th : workers) th.join();
  std::vector<Cand> order;
  order.reserve(nthreads * k_eff);
  for (const auto& c : cand) order.insert(order.end(), c.begin(), c.end());
  std::partial_sort(order.begin(), order.begin() + k_eff, order.end(),
                    cand_lt);
  std::string reply = "V\t";
  for (size_t i = 0; i < k_eff; ++i) {
    if (i) reply.push_back(';');
    reply += ix->ids[order[i].second];
    reply.push_back(':');
    reply += format_score(order[i].first);
  }
  reply.push_back('\n');
  return reply;
}

std::string handle_topk(ServerState* s, const std::string& verb,
                        const std::string& state,
                        const std::string& query_arg,
                        const std::string& k_s) {
  if (s->topk_item_suffix.empty() || state != s->state_name) {
    return "E\tno topk index for state: " + state + "\n";
  }
  errno = 0;
  char* endp = nullptr;
  long k = strtol(k_s.c_str(), &endp, 10);
  if (k_s.empty() || endp != k_s.c_str() + k_s.size()) {
    return "E\ttopk failed: invalid literal for int() with base 10: '" +
           k_s + "'\n";
  }
  if (k < 1) return "E\tk must be >= 1\n";
  if (verb == "TOPKV") return topk_payload(s, query_arg, k);
  // TOPK: resolve the query entity's factors from the store (key
  // "<id><user_suffix>"), then score like TOPKV
  std::string user_key = query_arg + s->topk_user_suffix;
  uint32_t vlen = 0;
  int err = 0;
  char* buf = tpums_get(s->store, user_key.data(),
                        static_cast<uint32_t>(user_key.size()), &vlen, &err);
  if (!buf) return "N\n";
  std::string payload(buf, vlen);
  tpums_free_buf(buf);
  return topk_payload(s, payload, k);
}

// METRICS verb: the per-verb stats as the exact one-line JSON snapshot
// schema obs/metrics.py emits (snapshot + synthesize_requests +
// snapshot_to_json_line — compact separators, meta last), so scrape_fleet
// merges native and Python workers through the same merge_snapshots path.
// The requests counter series is synthesized from the histogram count, the
// errors counter is materialized per verb (value 0 included, matching the
// Python plane's lazily-created-but-always-exported counter).
std::string metrics_reply(ServerState* s) {
  std::map<std::string, VerbStat> stats;
  {
    std::lock_guard<std::mutex> g(s->metrics_mu);
    stats = s->verb_stats;
  }
  double ts = std::chrono::duration<double>(
                  std::chrono::system_clock::now().time_since_epoch())
                  .count();
  std::string j = "J\t{\"ts\":";
  j += format_score_d(ts);
  j += ",\"enabled\":true,\"counters\":[";
  bool first = true;
  for (const auto& kv : stats) {
    if (!first) j.push_back(',');
    first = false;
    j += "{\"name\":\"tpums_server_errors_total\",\"labels\":{\"verb\":\"";
    escape_json_into(j, kv.first);
    j += "\"},\"value\":" + std::to_string(kv.second.errors) + "}";
  }
  for (const auto& kv : stats) {
    if (!first) j.push_back(',');
    first = false;
    j += "{\"name\":\"tpums_server_requests_total\",\"labels\":{\"verb\":\"";
    escape_json_into(j, kv.first);
    j += "\"},\"value\":" + std::to_string(kv.second.count) + "}";
  }
  // profiling plane: per-verb handler CPU self-time (the same numbers the
  // PROFILE verb folds into "native;<verb>" stacks), as counters so the
  // watch plane can rate() them like any other series
  for (const auto& kv : stats) {
    if (!first) j.push_back(',');
    first = false;
    j += "{\"name\":\"tpums_native_self_seconds_total\",\"labels\":"
         "{\"verb\":\"";
    escape_json_into(j, kv.first);
    j += "\"},\"value\":" + format_score_d(kv.second.cpu_s) + "}";
  }
  // arena-backed server: the shared-store gauges + the lock-free path's
  // retry counter ride the same snapshot (obs/scrape fleet_signals reads
  // them off either plane — the Python writer exports the same names)
  double a_rows, a_cap, a_res, a_retry, a_lf;
  bool is_arena = tpums_arena_stats(s->store, &a_rows, &a_cap, &a_res,
                                    &a_retry, &a_lf) == 0;
  if (is_arena) {
    if (!first) j.push_back(',');
    first = false;
    j += "{\"name\":\"tpums_arena_read_retries_total\",\"labels\":{},"
         "\"value\":" + std::to_string(static_cast<uint64_t>(a_retry)) + "}";
    // write-plane counters from the writer.stats sidecar the native batch
    // writer maintains — absent until a native writer has run, so the
    // splice is conditional per call (the handle re-probes the file)
    double b_rows, b_secs, c_succ, c_retry;
    if (tpums_arena_write_stats(s->store, &b_rows, &b_secs, &c_succ,
                                &c_retry) == 0) {
      j += ",{\"name\":\"tpums_arena_batch_rows_total\",\"labels\":{},"
           "\"value\":" +
           std::to_string(static_cast<uint64_t>(b_rows)) +
           "},{\"name\":\"tpums_arena_batch_put_seconds_total\","
           "\"labels\":{},\"value\":" +
           format_score_d(b_secs) +
           "},{\"name\":\"tpums_arena_cas_success_total\",\"labels\":{},"
           "\"value\":" +
           std::to_string(static_cast<uint64_t>(c_succ)) +
           "},{\"name\":\"tpums_arena_cas_retry_total\",\"labels\":{},"
           "\"value\":" +
           std::to_string(static_cast<uint64_t>(c_retry)) + "}";
    }
    // write-plane CPU self-time (sidecar, CLOCK_THREAD_CPUTIME_ID in the
    // batch/CAS writers) — the arena writer's row in the fleet profile
    double w_cpu;
    if (tpums_arena_write_cpu_seconds(s->store, &w_cpu) == 0 &&
        w_cpu > 0.0) {
      j += ",{\"name\":\"tpums_arena_write_cpu_seconds_total\","
           "\"labels\":{},\"value\":" + format_score_d(w_cpu) + "}";
    }
  }
  j += "],\"gauges\":[";
  if (is_arena) {
    j += "{\"name\":\"tpums_arena_rows\",\"labels\":{},\"value\":" +
         std::to_string(static_cast<uint64_t>(a_rows)) +
         "},{\"name\":\"tpums_arena_resident_bytes\",\"labels\":{},"
         "\"value\":" + std::to_string(static_cast<uint64_t>(a_res)) +
         "},{\"name\":\"tpums_arena_index_load_factor\",\"labels\":{},"
         "\"value\":" + format_score_d(a_lf) + "}";
  }
  j += "],\"histograms\":[";
  std::string le;
  for (double b : s->lat_bounds) {
    if (!le.empty()) le.push_back(',');
    le += format_score_d(b);
  }
  first = true;
  for (const auto& kv : stats) {
    if (!first) j.push_back(',');
    first = false;
    j += "{\"name\":\"tpums_server_latency_seconds\",\"labels\":{\"verb\":\"";
    escape_json_into(j, kv.first);
    j += "\"},\"le\":[" + le + "],\"counts\":[";
    for (size_t i = 0; i < kv.second.counts.size(); ++i) {
      if (i) j.push_back(',');
      j += std::to_string(kv.second.counts[i]);
    }
    j += "],\"sum\":" + format_score_d(kv.second.sum);
    j += ",\"count\":" + std::to_string(kv.second.count) + "}";
  }
  j += "],\"meta\":{\"job_id\":\"";
  escape_json_into(j, s->job_id);
  j += "\",\"port\":" + std::to_string(s->port) +
       ",\"plane\":\"native\"}}\n";
  return j;
}

// PROFILE verb: the native plane's contribution to the continuous
// profiling plane, shipped exactly like METRICS — one "P\t<json>" line in
// the obs/profiler.py profile schema.  No sampler runs in C++: handler
// sections are measured directly (CLOCK_THREAD_CPUTIME_ID bracketing in
// observe_verb), so the "stacks" are synthetic two-segment folds
// "native;<verb>" weighted in CPU seconds, plus "native;arena_writer"
// from the batch writer's sidecar.  merge_profiles sums these next to
// Python sample-seconds — one unit, one associative fold, one fleet
// flamegraph.
std::string profile_reply(ServerState* s) {
  std::map<std::string, VerbStat> stats;
  {
    std::lock_guard<std::mutex> g(s->metrics_mu);
    stats = s->verb_stats;
  }
  double ts = std::chrono::duration<double>(
                  std::chrono::system_clock::now().time_since_epoch())
                  .count();
  std::string j = "P\t{\"ts\":";
  j += format_score_d(ts);
  j += ",\"hz\":0,\"enabled\":true,\"samples\":0,\"wall_s\":0.0,"
       "\"unit\":\"seconds\",\"stacks\":{";
  bool first = true;
  for (const auto& kv : stats) {
    if (kv.second.cpu_s <= 0.0) continue;
    if (!first) j.push_back(',');
    first = false;
    j += "\"native;";
    escape_json_into(j, kv.first);
    j += "\":" + format_score_d(kv.second.cpu_s);
  }
  double w_cpu;
  if (tpums_arena_write_cpu_seconds(s->store, &w_cpu) == 0 && w_cpu > 0.0) {
    if (!first) j.push_back(',');
    first = false;
    j += "\"native;arena_writer\":" + format_score_d(w_cpu);
  }
  j += "},\"meta\":{\"job_id\":\"";
  escape_json_into(j, s->job_id);
  j += "\",\"port\":" + std::to_string(s->port) +
       ",\"plane\":\"native\"}}\n";
  return j;
}

// HEALTH verb: the owning job pushes its liveness report (ServingJob.health
// as a JSON object) through tpums_server_set_health on every heartbeat;
// the reply splices in the two server-owned fields — live key count and
// the metrics_uri — exactly where the Python plane appends them.  With no
// pushed report (bare server, tests) the reply is byte-identical to a bare
// Python LookupServer's always-ready report.
std::string health_reply(ServerState* s) {
  std::string pushed;
  {
    std::lock_guard<std::mutex> g(s->health_mu);
    pushed = s->health_json;
  }
  std::string keys = std::to_string(tpums_count(s->store));
  std::string uri =
      "tpums://" + s->host_str + ":" + std::to_string(s->port) + "/METRICS";
  if (pushed.size() >= 2 && pushed.front() == '{' && pushed.back() == '}') {
    std::string inner = pushed.substr(1, pushed.size() - 2);
    std::string body = "{" + inner + (inner.empty() ? "" : ", ") +
                       "\"keys\": " + keys + ", \"metrics_uri\": \"" +
                       escape_json(uri) + "\"}";
    return "H\t" + body + "\n";
  }
  return "H\t{\"state\": \"" + escape_json(s->state_name) +
         "\", \"ready\": true, \"status\": \"ready\", \"backlog_bytes\": 0, "
         "\"keys\": " + keys + ", \"job_id\": \"" + escape_json(s->job_id) +
         "\", \"topology_group\": null, \"generation\": null, "
         "\"topology_gen\": null, \"metrics_uri\": \"" + escape_json(uri) +
         "\"}\n";
}

// Answer a non-TOPK request from its pre-split parts (submit_line owns the
// single split_tabs pass — the point-lookup hot path is parsed once).
std::string handle_line(ServerState* s, const std::string* parts, int n) {
  s->requests.fetch_add(1, std::memory_order_relaxed);
  if (parts[0] == "PING") {  // Python matches on parts[0] alone
    return "PONG\t" + s->job_id + "\t" + s->state_name + "\n";
  }
  if (parts[0] == "HELLO" &&
      (n == 2 || (n == 3 && parts[2] == "tr=1"))) {
    // protocol negotiation (serve/proto.py HELLO_LINE): the caller flips
    // the connection to binary iff this answers the accept line.  The
    // tr=1 extension (proto.TRACE_EXT) negotiates per-record trace
    // fields; route_parts latches it on the Conn when the flip happens.
    if (parts[1] == "B2") return "HELLO\tB2\n";
    return "E\tunsupported proto: " + parts[1] + "\n";
  }
  if (parts[0] == "HEALTH" && n == 2) {
    if (parts[1] != s->state_name) {
      return "E\tunknown state: " + parts[1] + "\n";
    }
    return health_reply(s);
  }
  if (parts[0] == "METRICS" && n == 1) {
    // start2-compat servers (no bucket ladder) keep the historical
    // E\tbad request so their byte-parity pins hold
    if (s->lat_bounds.empty()) return "E\tbad request\n";
    return metrics_reply(s);
  }
  if (parts[0] == "PROFILE" && n == 1) {
    // profiling-plane scrape; start2-compat servers (no ladder, so no
    // verb stats accumulate) keep the historical E, exactly like METRICS
    if (s->lat_bounds.empty()) return "E\tbad request\n";
    return profile_reply(s);
  }
  if (parts[0] == "COUNT" && n == 2) {
    if (parts[1] != s->state_name) {
      return "E\tunknown state: " + parts[1] + "\n";
    }
    return "C\t" + std::to_string(tpums_count(s->store)) + "\n";
  }
  if (parts[0] == "GET" && n == 3) {
    if (parts[1] != s->state_name) {
      return "E\tunknown state: " + parts[1] + "\n";
    }
    uint32_t vlen = 0;
    int err = 0;
    char* buf = tpums_get(s->store, parts[2].data(),
                          static_cast<uint32_t>(parts[2].size()), &vlen, &err);
    if (!buf) {
      return err ? "E\tstore read failed\n" : "N\n";
    }
    std::string reply;
    reply.reserve(vlen + 3);
    reply.append("V\t").append(buf, vlen).push_back('\n');
    tpums_free_buf(buf);
    return reply;
  }
  if (parts[0] == "MGET" && n == 3) {
    if (parts[1] != s->state_name) {
      return "E\tunknown state: " + parts[1] + "\n";
    }
    std::string reply = "M";
    const std::string& keys = parts[2];
    size_t start = 0;
    while (true) {
      size_t comma = keys.find(',', start);
      size_t len =
          (comma == std::string::npos ? keys.size() : comma) - start;
      uint32_t vlen = 0;
      int err = 0;
      char* buf = tpums_get(s->store, keys.data() + start,
                            static_cast<uint32_t>(len), &vlen, &err);
      if (!buf) {
        reply += err ? "\tE" : "\tN";  // per-key store error stays in-slot so
                                       // the batch framing survives
      } else {
        reply += "\tV";
        reply.append(buf, vlen);
        tpums_free_buf(buf);
      }
      if (comma == std::string::npos) break;
      start = comma + 1;
    }
    reply.push_back('\n');
    return reply;
  }
  // TOPK/TOPKV never reach here — submit_line routes them to the worker
  // thread before handle_line is called
  return "E\tbad request\n";
}

// ---------------------------------------------------------------------------
// DOT verb: server-side sparse dot over range-partitioned rows
// (serve/server.py semantics contract — replies are byte-parity-tested
// on exactly-representable fixtures).

// Parse one integer token with Python int() semantics: surrounding ASCII
// whitespace stripped, full consumption required.
bool parse_int_token(const char* b, const char* e, long long* out) {
  while (b < e && (*b == ' ' || *b == '\t' || *b == '\r' || *b == '\n'))
    ++b;
  while (e > b && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r' ||
                   e[-1] == '\n'))
    --e;
  if (b >= e) return false;
  std::string tok(b, e);
  errno = 0;
  char* endp = nullptr;
  long long v = strtoll(tok.c_str(), &endp, 10);
  if (errno != 0 || endp != tok.c_str() + tok.size()) return false;
  *out = v;
  return true;
}

// Parse "<int>:<float>" pairs out of a ';'-separated payload with the
// Python planes' exact acceptance rules (serve/server.py DOT query parse
// and core/formats parse_svm_range_payload): ALL trailing semicolons are
// stripped, an EMPTY interior segment rejects the whole payload, each
// segment carries exactly one colon, and numbers may be whitespace-padded
// (Python int()/float() strip).  Rows/queries with any malformed token
// are rejected whole.
bool parse_pairs(const std::string& payload,
                 std::vector<std::pair<long long, double>>* out) {
  size_t n = payload.size();
  while (n > 0 && payload[n - 1] == ';') --n;  // rstrip(';') parity
  size_t start = 0;
  while (start < n) {
    size_t semi = payload.find(';', start);
    if (semi == std::string::npos || semi > n) semi = n;
    if (semi == start) return false;  // empty interior segment
    size_t colon = payload.find(':', start);
    if (colon == std::string::npos || colon >= semi) return false;
    // exactly one colon per segment (Python's colon-count check)
    if (payload.find(':', colon + 1) < semi) return false;
    long long fid = 0;
    if (!parse_int_token(payload.c_str() + start,
                         payload.c_str() + colon, &fid)) {
      return false;
    }
    double val = 0.0;
    if (!parse_float_token(payload.c_str() + colon + 1,
                           payload.c_str() + semi, &val)) {
      return false;
    }
    out->emplace_back(fid, val);
    start = semi + 1;
  }
  return true;
}

std::shared_ptr<const DotIndex> build_dot_index(ServerState* s) {
  auto ix = std::make_shared<DotIndex>();
  ix->ver_count = tpums_count(s->store);
  ix->ver_bytes = tpums_log_bytes(s->store);
  std::vector<std::string> keys;
  uint64_t cursor = 0;
  while (tpums_keys_chunk(
             s->store, &cursor, 8192,
             [](const char* key, uint32_t klen, void* ctx) {
               static_cast<std::vector<std::string>*>(ctx)->emplace_back(
                   key, klen);
             },
             &keys) > 0) {
  }
  // rows concatenate in ASCENDING BUCKET order on both planes (the store
  // iterates hash buckets, the Python table dict shards — neither is
  // publish order, so cross-row duplicate-fid last-wins would otherwise
  // resolve differently per plane for identical contents)
  std::vector<std::pair<long long, std::string>> rows;
  for (const std::string& key : keys) {
    if (key.empty() || key[0] == '\x01') continue;  // store-internal
    long long bucket = 0;
    if (!parse_int_token(key.c_str(), key.c_str() + key.size(), &bucket))
      continue;
    uint32_t vlen = 0;
    int err = 0;
    char* buf = tpums_get(s->store, key.data(),
                          static_cast<uint32_t>(key.size()), &vlen, &err);
    if (!buf) continue;
    rows.emplace_back(bucket, std::string(buf, vlen));
    tpums_free_buf(buf);
  }
  std::sort(rows.begin(), rows.end(),
            [](const std::pair<long long, std::string>& a,
               const std::pair<long long, std::string>& b) {
              return a.first < b.first;
            });
  std::vector<std::pair<long long, double>> pairs;
  for (const auto& row : rows) {
    size_t before = pairs.size();
    if (!parse_pairs(row.second, &pairs)) {
      pairs.resize(before);  // not an idx:w;... row (e.g. flat model)
      continue;
    }
    ix->buckets.insert(row.first);
  }
  // ascending by fid, duplicate ids last-wins (stable sort keeps input
  // order within a run of equal ids — sort_dedup_last parity)
  std::stable_sort(pairs.begin(), pairs.end(),
                   [](const std::pair<long long, double>& a,
                      const std::pair<long long, double>& b) {
                     return a.first < b.first;
                   });
  ix->fids.reserve(pairs.size());
  ix->ws.reserve(pairs.size());
  for (size_t i = 0; i < pairs.size(); ++i) {
    if (i + 1 < pairs.size() && pairs[i + 1].first == pairs[i].first)
      continue;
    ix->fids.push_back(pairs[i].first);
    ix->ws.push_back(pairs[i].second);
  }
  return ix;
}

std::shared_ptr<const DotIndex> get_dot_index(ServerState* s) {
  uint64_t count = tpums_count(s->store);
  uint64_t bytes = tpums_log_bytes(s->store);
  std::shared_ptr<const DotIndex> cur;
  {
    std::lock_guard<std::mutex> g(s->dot_mu);
    cur = s->dot_cur;
  }
  if (cur && cur->ver_count == count && cur->ver_bytes == bytes) return cur;
  if (!cur) {  // first build: only queued worker tasks wait
    cur = build_dot_index(s);
    std::lock_guard<std::mutex> g(s->dot_mu);
    s->dot_cur = cur;
    return cur;
  }
  bool expected = false;
  if (s->dot_building.compare_exchange_strong(expected, true)) {
    if (s->dot_builder.joinable()) s->dot_builder.join();
    s->dot_builder = std::thread([s]() {
      auto fresh = build_dot_index(s);
      {
        std::lock_guard<std::mutex> g(s->dot_mu);
        s->dot_cur = std::move(fresh);
      }
      s->dot_building.store(false, std::memory_order_release);
    });
  }
  return cur;  // briefly stale while the rebuild runs
}

std::string handle_dot(ServerState* s, const std::string& state,
                       const std::string& range_s,
                       const std::string& payload) {
  if (state != s->state_name) {
    return "E\tunknown state: " + state + "\n";
  }
  long long range_ = 0;
  if (!parse_int_token(range_s.c_str(), range_s.c_str() + range_s.size(),
                       &range_)) {
    return "E\tdot failed: invalid literal for int() with base 10: '" +
           range_s + "'\n";
  }
  if (range_ < 1) return "E\trange must be >= 1\n";
  std::vector<std::pair<long long, double>> q;
  if (!parse_pairs(payload, &q)) {
    // message parity: the Python plane reports repr(stripped[:40])
    std::string stripped = payload;
    while (!stripped.empty() && stripped.back() == ';') stripped.pop_back();
    return "E\tdot failed: malformed pair in '" +
           stripped.substr(0, 40) + "'\n";
  }
  std::shared_ptr<const DotIndex> ix = get_dot_index(s);
  double acc = 0.0;
  std::set<long long> missing;
  for (const auto& fv : q) {
    auto it = std::lower_bound(ix->fids.begin(), ix->fids.end(), fv.first);
    if (it != ix->fids.end() && *it == fv.first) {
      acc += fv.second * ix->ws[it - ix->fids.begin()];
    } else {
      // floor division, matching Python's // for any sign
      long long b = fv.first / range_;
      if ((fv.first % range_ != 0) && ((fv.first < 0) != (range_ < 0)))
        --b;
      if (!ix->buckets.count(b)) missing.insert(b);
    }
  }
  std::string reply = "D\t" + format_score_d(acc) + "\t";
  bool first = true;
  for (long long b : missing) {
    if (!first) reply.push_back(',');
    reply += std::to_string(b);
    first = false;
  }
  reply.push_back('\n');
  return reply;
}

// Dedicated top-k worker: pops tasks, computes the (possibly O(catalog))
// reply off the epoll thread, publishes it into the connection's reply
// slot, and pokes the event loop via the eventfd to flush.
void topk_worker_loop(ServerState* s) {
  uint64_t one = 1;
  while (true) {
    TopkTask task;
    {
      std::unique_lock<std::mutex> lk(s->task_mu);
      s->task_cv.wait(lk, [s] {
        return s->worker_stop.load(std::memory_order_acquire) ||
               !s->tasks.empty();
      });
      if (s->worker_stop.load(std::memory_order_acquire)) return;
      task = std::move(s->tasks.front());
      s->tasks.pop_front();
    }
    if (task.reply.use_count() > 1) {  // conn still holds its slot — a
      // closed connection's orphaned tasks skip the O(catalog) work
      double t_pop = now_s();
      double c0 = thread_cpu_s();
      task.reply->text =
          task.verb == "DOT"
              ? handle_dot(s, task.state, task.k_s, task.query_arg)
              : handle_topk(s, task.verb, task.state, task.query_arg,
                            task.k_s);
      // latency includes queue wait (t0 is submit time), mirroring the
      // Python plane's deferred-reply observation at resolve time; an
      // orphaned task is never observed — its Python twin (handler thread
      // gone mid-request) never reaches _finish either.  CPU self-time
      // deliberately does NOT include queue wait: it brackets the worker
      // section only, so the profile says what the core burned, not what
      // the queue delayed.
      double t_done = now_s();
      bool is_err =
          !task.reply->text.empty() && task.reply->text[0] == 'E';
      observe_verb(s, task.verb, t_done - task.t0, is_err,
                   thread_cpu_s() - c0);
      if (!task.tid.empty()) {
        // queue wait vs device/serve split is exactly what the slow-vs-
        // fast diff attributes, so spill both
        trace_spill(s, task.tid, task.verb, task.t0_wall,
                    t_done - task.t0, t_pop - task.t0, t_done - t_pop,
                    is_err);
      }
    }
    task.reply->ready.store(true, std::memory_order_release);
    ssize_t wr = write(s->wake_fd, &one, 8);
    (void)wr;
  }
}

// Move every completed output unit at the FRONT of the queue into the
// connection's out buffer (strict FIFO: an unfinished TOPK blocks only
// replies behind it on ITS connection).  A tab-mode unit is one reply
// line; a B2 unit is a whole reply frame and emits only when every record
// in it is ready, because the frame header carries the total length.
void drain_ready_replies(Conn* c) {
  while (!c->units.empty()) {
    const OutUnit& u = c->units.front();
    if (c->pending.size() < u.count) break;  // defensive: never expected
    bool all_ready = true;
    for (uint32_t i = 0; i < u.count && all_ready; ++i) {
      all_ready = c->pending[i]->ready.load(std::memory_order_acquire);
    }
    if (!all_ready) break;
    if (!u.frame) {
      const PendingReply& pr = *c->pending.front();
      if (!pr.tid.empty() && !pr.text.empty() && pr.text.back() == '\n') {
        // deferred tab reply: append the raw tid echo before the newline
        // (inline replies get theirs inserted at route time)
        std::string line;
        line.reserve(pr.text.size() + pr.tid.size() + 6);
        line.append(pr.text, 0, pr.text.size() - 1);
        line += "\ttid=";
        line += pr.tid;
        line.push_back('\n');
        c->out.take(std::move(line));
      } else {
        c->out.append(pr.text);
      }
    } else {
      std::string body;
      append_varint(body, u.count);
      for (uint32_t i = 0; i < u.count; ++i) {
        const std::string& t = c->pending[i]->text;
        size_t len = t.size();
        if (len && t[len - 1] == '\n') --len;  // reply record = line sans \n
        append_varint(body, len);
        body.append(t.data(), len);
      }
      std::string frame;
      frame.reserve(body.size() + 12);
      frame += "B2";
      append_varint(frame, body.size());
      frame += body;
      c->out.take(std::move(frame));
    }
    for (uint32_t i = 0; i < u.count; ++i) {
      c->pending_req_bytes -= c->pending.front()->req_bytes;
      c->pending.pop_front();
    }
    c->units.pop_front();
  }
}

// Route one request's pre-split parts: TOPK verbs are enqueued for the
// worker thread (reply slot keeps pipelined order); everything else
// answers inline.  `src_bytes` is the wire size of the request (line or
// binary record) for the pending-byte cap; `always_slot` (binary records)
// forces even inline replies through the pending queue so the enclosing
// frame unit can group them.  Returns false when the connection must
// close (pending-flood protection).
bool route_parts(ServerState* s, Conn* c, std::string* parts, int n,
                 size_t src_bytes, bool always_slot,
                 const std::string& tid) {
  if ((parts[0] == "TOPK" || parts[0] == "TOPKV" || parts[0] == "DOT") &&
      n == 4) {
    s->requests.fetch_add(1, std::memory_order_relaxed);
    // slot-count AND byte cap: queued tasks copy the request payload, so
    // a flood of max-size TOPKV lines must trip the same slow-reader
    // policy as buffered responses, not grow the heap unboundedly
    if (c->pending.size() >= kMaxPendingReplies ||
        c->pending_req_bytes + src_bytes > kMaxOutBuffer) {
      return false;
    }
    auto reply = std::make_shared<PendingReply>();
    reply->req_bytes = src_bytes;
    // tab replies echo the raw tid back (drain_ready_replies appends it);
    // B2 replies never carry the tid — the client pairs them by order
    if (!always_slot) reply->tid = tid;
    c->pending_req_bytes += src_bytes;
    c->pending.push_back(reply);
    if (!always_slot) c->units.push_back(OutUnit{false, 1});
    // TOPK operands: state, id, k; TOPKV operands: state, k, payload;
    // DOT operands: state, range, payload (range rides the k_s slot)
    TopkTask task{std::move(reply), parts[0], parts[1],
                  parts[0] == "TOPK" ? parts[2] : parts[3],
                  parts[0] == "TOPK" ? parts[3] : parts[2], now_s(),
                  tid, tid.empty() ? 0.0 : wall_s()};
    {
      std::lock_guard<std::mutex> lk(s->task_mu);
      s->tasks.push_back(std::move(task));
    }
    s->task_cv.notify_one();
    return true;
  }
  double t0 = now_s();
  double t0_wall = tid.empty() ? 0.0 : wall_s();
  double c0 = thread_cpu_s();
  std::string text = handle_line(s, parts, n);
  double dt = now_s() - t0;
  bool is_err = !text.empty() && text[0] == 'E';
  observe_verb(s, parts[0], dt, is_err, thread_cpu_s() - c0);
  if (!tid.empty()) {
    trace_spill(s, tid, parts[0], t0_wall, dt, 0.0, dt, is_err);
  }
  if (parts[0] == "HELLO" && !c->binary && text[0] == 'H' && tid.empty()) {
    // negotiation accepted: every byte after this line is a B2 frame and
    // every reply after this line's is a B2 frame.  A HELLO that carried
    // a tid= stamp stays in tab mode (Python-plane parity: parse_hello
    // rejects the tid extension, so the reply is echoed but the framing
    // never flips).
    c->binary = true;
    if (n == 3) c->b2_trace = true;  // handle_line only accepts tr=1 at n==3
  }
  if (!always_slot && !tid.empty() && !text.empty() && text.back() == '\n') {
    text.insert(text.size() - 1, "\ttid=" + tid);
  }
  if (!always_slot && c->pending.empty()) {
    c->out.take(std::move(text));
  } else {
    // an async reply is still in flight ahead of us (or a frame needs the
    // slot): preserve reply order.  Parked reply text counts against the
    // same byte cap as queued TOPK payloads — the slow-reader check only
    // sees c->out, and a client pipelining GETs behind a slow TOPK
    // without reading must not grow the pending queue unboundedly.
    if (c->pending.size() >= kMaxPendingReplies ||
        c->pending_req_bytes + text.size() > kMaxOutBuffer) {
      return false;
    }
    auto slot = std::make_shared<PendingReply>();
    slot->req_bytes = text.size();
    c->pending_req_bytes += text.size();
    slot->text = std::move(text);
    slot->ready.store(true, std::memory_order_release);
    c->pending.push_back(std::move(slot));
    if (!always_slot) c->units.push_back(OutUnit{false, 1});
  }
  return true;
}

bool submit_line(ServerState* s, Conn* c, const std::string& line) {
  // 5 slots: one more than the widest verb, so an over-long request is
  // distinguishable from an exact TOPK (Python splits unbounded; parity
  // demands "TOPK\ta\tb\tc\td" be a bad request, not a TOPK)
  std::string parts[5];
  // trailing ``\ttid=<raw>`` trace stamp (obs/tracing.pop_tid parity:
  // strip it BEFORE the split so a stamped TOPK still parses as n==4);
  // the value never contains a tab, so "last field" == "no tab after"
  size_t tp = line.rfind("\ttid=");
  if (tp != std::string::npos && tp > 0 && tp + 5 < line.size() &&
      line.find('\t', tp + 1) == std::string::npos) {
    std::string tid = line.substr(tp + 5);
    int n = split_tabs(line.substr(0, tp), parts, 5);
    return route_parts(s, c, parts, n, line.size(), false, tid);
  }
  int n = split_tabs(line, parts, 5);
  return route_parts(s, c, parts, n, line.size(), false, std::string());
}

// Queue the structural-corruption reply (one-record error frame, matching
// serve/proto.error_frame) and poison the connection: it serves what is
// already in flight, flushes, then closes.  Never called for per-verb
// semantic errors — those stay in-slot as ordinary E records.
int fatal_frame(Conn* c, const char* reason) {
  auto slot = std::make_shared<PendingReply>();
  slot->text = std::string("E\tbad frame: ") + reason + "\n";
  slot->ready.store(true, std::memory_order_release);
  c->pending.push_back(std::move(slot));
  c->units.push_back(OutUnit{true, 1});
  c->fatal = true;
  c->in.clear();
  return -1;
}

// Parse ONE complete B2 request frame off c->in and dispatch its records
// as a single burst (one reply frame).  Returns 0 = need more bytes,
// 1 = consumed a frame, -1 = poisoned (error frame queued), -2 = hard
// close (pending-flood caps).  Structural corruption poisons the whole
// connection — record boundaries inside a frame depend on every earlier
// record decoding, so there is no trustworthy resync point.
int parse_one_frame(ServerState* s, Conn* c) {
  const std::string& in = c->in;
  if (in.empty()) return 0;
  if (in[0] != 'B') return fatal_frame(c, "bad magic");
  if (in.size() < 2) return 0;
  if (in[1] != '2') return fatal_frame(c, "bad magic");
  size_t pos = 2;
  uint64_t body_len = 0;
  int vr = parse_varint(in.data(), in.size(), &pos, &body_len);
  if (vr == 1) return 0;
  if (vr == 2) return fatal_frame(c, "bad varint");
  if (body_len > kMaxFrameBody) return fatal_frame(c, "frame too large");
  if (in.size() - pos < body_len) return 0;
  size_t end = pos + body_len;
  uint64_t count = 0;
  vr = parse_varint(in.data(), end, &pos, &count);
  if (vr != 0) return fatal_frame(c, "bad body");
  // decode ALL records before dispatching any: a frame either fully
  // parses or is rejected whole (serve/proto.decode_request_frame parity)
  std::vector<std::vector<std::string>> records;
  std::vector<size_t> rec_bytes;
  std::vector<std::string> rec_tids;
  records.reserve(count);
  // tr=1 connections carry ONE extra trailing length-prefixed field per
  // record — the raw trace id, empty for untraced requests (the Python
  // encoder's record_to_parts/record_from_line twin)
  const int extra = c->b2_trace ? 1 : 0;
  for (uint64_t r = 0; r < count; ++r) {
    size_t rec_start = pos;
    if (pos >= end) return fatal_frame(c, "bad body");
    int op = static_cast<uint8_t>(in[pos++]);
    if (op < 1 || op > kMaxOpcode) return fatal_frame(c, "bad body");
    const VerbSpec& spec = kVerbByOp[op];
    std::vector<std::string> parts;
    parts.reserve(spec.fields + 1 + extra);
    parts.emplace_back(spec.verb);
    for (int f = 0; f < spec.fields + extra; ++f) {
      uint64_t flen = 0;
      vr = parse_varint(in.data(), end, &pos, &flen);
      if (vr != 0 || pos + flen > end) return fatal_frame(c, "bad body");
      if (!utf8_valid(in.data() + pos, flen))
        return fatal_frame(c, "bad body");
      parts.emplace_back(in.data() + pos, flen);
      pos += flen;
    }
    std::string rtid;
    if (extra) {
      rtid = std::move(parts.back());
      parts.pop_back();
    }
    rec_tids.push_back(std::move(rtid));
    rec_bytes.push_back(pos - rec_start);
    records.push_back(std::move(parts));
  }
  if (pos != end) return fatal_frame(c, "bad body");
  for (size_t r = 0; r < records.size(); ++r) {
    std::string parts[5];
    int n = static_cast<int>(records[r].size());
    for (int i = 0; i < n; ++i) parts[i] = std::move(records[r][i]);
    if (!route_parts(s, c, parts, n, rec_bytes[r], true, rec_tids[r])) {
      return -2;
    }
  }
  c->units.push_back(
      OutUnit{true, static_cast<uint32_t>(records.size())});
  c->in.erase(0, end);
  return 1;
}

// Answer every complete request buffered in c->in — lines until the
// connection negotiates B2, frames after.  false = close the conn
// (pending-flood protection tripped); a poisoned conn (corrupt frame)
// returns true so its queued error frame still flushes before close.
bool drain_lines(ServerState* s, Conn* c) {
  while (true) {
    if (c->fatal) {
      c->in.clear();
      return true;
    }
    if (!c->binary) {
      size_t start = 0;
      bool ok = true;
      while (ok && !c->binary) {
        size_t nl = c->in.find('\n', start);
        if (nl == std::string::npos) break;
        ok = submit_line(s, c, c->in.substr(start, nl - start));
        start = nl + 1;
      }
      c->in.erase(0, start);
      if (!ok) return false;
      if (!c->binary) return true;  // no more complete lines buffered
      continue;  // HELLO flipped the mode: the remainder is frames
    }
    int r = parse_one_frame(s, c);
    if (r == 0) return true;
    if (r == -1) return true;  // poisoned: error frame queued
    if (r == -2) return false;
  }
}

void arm_writable(ServerState* s, Conn* c, bool want) {
  if (c->writable_armed == want) return;
  epoll_event ev{};
  ev.events = EPOLLIN | (want ? EPOLLOUT : 0u);
  ev.data.fd = c->fd;
  if (epoll_ctl(s->epoll_fd, EPOLL_CTL_MOD, c->fd, &ev) == 0) {
    c->writable_armed = want;
  }
}

void close_conn(ServerState* s, int fd) {
  epoll_ctl(s->epoll_fd, EPOLL_CTL_DEL, fd, nullptr);
  close(fd);
  s->conns.erase(fd);
}

// -- syscall-batched reply flush -------------------------------------------
// Replies are never sent from the parse/handle path: producers mark the
// connection dirty and the END of each epoll batch flushes every dirty
// connection at once — one scatter-gather sendmsg per connection per
// wakeup (the whole backlog in one iovec array), or, when io_uring is
// live, one SQE per connection and ONE io_uring_enter for all of them.
// A 64-GET B2 frame thus costs one reply syscall, not 64; cross-
// connection bursts share the same single enter.

constexpr size_t kMaxFlushIov = 32;  // per-conn scatter width per shot

void mark_dirty(ServerState* s, Conn* c) {
  if (!c->dirty) {
    c->dirty = true;
    s->dirty_fds.push_back(c->fd);
  }
}

// One sendmsg shot for this conn's backlog.  Leftover bytes (partial send
// or EAGAIN) arm EPOLLOUT — the next wakeup re-batches them.  false =
// peer gone.
bool flush_conn_send(ServerState* s, Conn* c) {
  if (c->out.empty()) {
    arm_writable(s, c, false);
    return true;
  }
  struct iovec iov[kMaxFlushIov];
  size_t niov = c->out.fill_iov(iov, kMaxFlushIov);
  struct msghdr mh;
  memset(&mh, 0, sizeof(mh));
  mh.msg_iov = iov;
  mh.msg_iovlen = niov;
  ssize_t w = sendmsg(c->fd, &mh, MSG_NOSIGNAL);
  s->reply_syscalls.fetch_add(1, std::memory_order_relaxed);
  if (w < 0) {
    if (errno == EAGAIN || errno == EWOULDBLOCK) {
      arm_writable(s, c, true);
      return true;
    }
    return false;  // peer gone
  }
  s->reply_bytes.fetch_add(static_cast<uint64_t>(w),
                           std::memory_order_relaxed);
  c->out.consume(static_cast<size_t>(w));
  arm_writable(s, c, !c->out.empty());
  return true;
}

#ifdef TPUMS_HAVE_URING
// Batched path: stage IORING_OP_SENDMSG SQEs for every conn in `cs`, one
// enter per chunk of ring entries.  Failed conns are appended to doomed.
void flush_uring(ServerState* s, std::vector<Conn*>& cs,
                 std::vector<int>* doomed) {
  Uring* u = &s->uring;
  size_t done = 0;
  std::vector<struct msghdr> msgs(cs.size());
  std::vector<std::array<struct iovec, kMaxFlushIov>> iovs(cs.size());
  while (done < cs.size()) {
    size_t n = std::min(cs.size() - done, static_cast<size_t>(u->entries));
    unsigned tail = *u->sq_tail;  // single submitter: plain read is fine
    for (size_t i = 0; i < n; ++i) {
      Conn* c = cs[done + i];
      size_t niov = c->out.fill_iov(iovs[done + i].data(), kMaxFlushIov);
      struct msghdr* mh = &msgs[done + i];
      memset(mh, 0, sizeof(*mh));
      mh->msg_iov = iovs[done + i].data();
      mh->msg_iovlen = niov;
      unsigned idx = (tail + i) & *u->sq_mask;
      io_uring_sqe* sqe = &u->sqes[idx];
      memset(sqe, 0, sizeof(*sqe));
      sqe->opcode = IORING_OP_SENDMSG;
      sqe->fd = c->fd;
      sqe->addr = reinterpret_cast<uint64_t>(mh);
      // MSG_DONTWAIT: complete with -EAGAIN instead of parking in the
      // kernel's poll-retry — one slow reader must not stall the loop
      sqe->msg_flags = MSG_NOSIGNAL | MSG_DONTWAIT;
      sqe->user_data = static_cast<uint64_t>(done + i);
      u->sq_array[idx] = idx;
    }
    __atomic_store_n(u->sq_tail, tail + n, __ATOMIC_RELEASE);
    int r = static_cast<int>(syscall(__NR_io_uring_enter, u->ring_fd,
                                     static_cast<unsigned>(n),
                                     static_cast<unsigned>(n),
                                     IORING_ENTER_GETEVENTS, nullptr, 0));
    s->reply_syscalls.fetch_add(1, std::memory_order_relaxed);
    if (r < 0) {
      // ring wedged (should not happen): degrade to direct sendmsg so
      // replies still flow
      for (size_t i = 0; i < n; ++i) {
        if (!flush_conn_send(s, cs[done + i]))
          doomed->push_back(cs[done + i]->fd);
      }
      done += n;
      continue;
    }
    unsigned chead = __atomic_load_n(u->cq_head, __ATOMIC_RELAXED);
    unsigned ctail = __atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE);
    for (; chead != ctail; ++chead) {
      io_uring_cqe* cqe = &u->cqes[chead & *u->cq_mask];
      size_t ci = static_cast<size_t>(cqe->user_data);
      if (ci >= cs.size()) continue;  // defensive
      Conn* c = cs[ci];
      if (cqe->res >= 0) {
        s->reply_bytes.fetch_add(static_cast<uint64_t>(cqe->res),
                                 std::memory_order_relaxed);
        c->out.consume(static_cast<size_t>(cqe->res));
        arm_writable(s, c, !c->out.empty());
      } else if (cqe->res == -EAGAIN || cqe->res == -EWOULDBLOCK) {
        arm_writable(s, c, true);
      } else {
        doomed->push_back(c->fd);
      }
    }
    __atomic_store_n(u->cq_head, chead, __ATOMIC_RELEASE);
    done += n;
  }
}
#endif  // TPUMS_HAVE_URING

// End-of-batch flush: send every dirty connection's backlog, then run the
// deferred close checks (slow reader, half-closed/poisoned and fully
// answered) that used to piggyback on the per-event flush.
void flush_batch(ServerState* s, std::vector<int>* doomed) {
  if (s->dirty_fds.empty()) return;
  auto is_doomed = [doomed](int fd) {
    return std::find(doomed->begin(), doomed->end(), fd) != doomed->end();
  };
  std::vector<Conn*> flushable;
  std::vector<Conn*> sendable;
  for (int fd : s->dirty_fds) {
    auto it = s->conns.find(fd);
    if (it == s->conns.end()) continue;
    it->second.dirty = false;
    if (is_doomed(fd)) continue;
    flushable.push_back(&it->second);
    if (!it->second.out.empty()) sendable.push_back(&it->second);
  }
  s->dirty_fds.clear();
#ifdef TPUMS_HAVE_URING
  if (s->uring_on && !sendable.empty()) {
    flush_uring(s, sendable, doomed);
  } else
#endif
  {
    for (Conn* c : sendable) {
      if (!flush_conn_send(s, c)) doomed->push_back(c->fd);
    }
  }
  for (Conn* c : flushable) {
    if (is_doomed(c->fd)) continue;
    bool ok = true;
    if (c->out.size() > kMaxOutBuffer) ok = false;  // slow reader
    if (ok && (c->eof || c->fatal) && c->out.empty() && c->pending.empty())
      ok = false;  // half-closed/poisoned and fully answered
    if (!ok) doomed->push_back(c->fd);
  }
}

// Read available bytes, answer every complete request; false = close.
// Replies queue in c->out — the end-of-batch flush_batch sends them.
bool on_readable(ServerState* s, Conn* c) {
  char chunk[kReadChunk];
  for (int chunks = 0; chunks < kMaxChunksPerEvent; ++chunks) {
    ssize_t r = recv(c->fd, chunk, sizeof(chunk), 0);
    s->recv_calls.fetch_add(1, std::memory_order_relaxed);
    if (r > 0) {
      c->in.append(chunk, static_cast<size_t>(r));
      // parse as we go so the cap bounds ONE request line/frame, not a
      // burst of pipelined small requests (binary frames get the bigger
      // frame-body cap; an over-declared length already poisoned the conn)
      if (!drain_lines(s, c)) return false;
      size_t in_cap = c->binary ? kMaxFrameBody + 16 : kMaxLine;
      if (c->in.size() > in_cap) return false;   // oversized request
      if (c->out.size() > kMaxOutBuffer) return false;  // slow reader
      continue;
    }
    if (r == 0) {  // orderly half-close: still answer the buffered requests
      c->eof = true;
      break;
    }
    if (errno == EAGAIN || errno == EWOULDBLOCK) break;
    return false;
  }
  if (!drain_lines(s, c)) return false;
  if (c->eof && !c->in.empty() && !c->binary && !c->fatal) {
    // final line without '\n': readline()-at-EOF answers it, so we do too
    // (tab mode only — a partial binary frame at EOF is dropped silently,
    // matching the Python plane's frame loop)
    bool ok = submit_line(s, c, c->in);
    c->in.clear();
    if (!ok) return false;
  }
  drain_ready_replies(c);
  mark_dirty(s, c);
  return true;
}

void event_loop(ServerState* s) {
  epoll_event events[64];
  // Closes are DEFERRED to the end of each epoll batch: closing an fd
  // mid-batch lets accept() reuse the number within the same batch, and a
  // stale event later in the batch would then hit the brand-new
  // connection.  Keeping doomed fds open (just marked) until the batch
  // ends makes fd reuse impossible while any of its events are pending.
  std::vector<int> doomed;
  auto is_doomed = [&doomed](int fd) {
    return std::find(doomed.begin(), doomed.end(), fd) != doomed.end();
  };
  while (!s->stop.load(std::memory_order_acquire)) {
    int n = epoll_wait(s->epoll_fd, events, 64, -1);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    doomed.clear();
    for (int i = 0; i < n; ++i) {
      int fd = events[i].data.fd;
      uint32_t ev = events[i].events;
      if (fd == s->wake_fd) {
        uint64_t tok;
        ssize_t rd = read(s->wake_fd, &tok, 8);
        (void)rd;
        // the worker finished one or more top-k replies: collect every
        // connection whose pending front is now ready; the end-of-batch
        // flush sends them all in one syscall round
        for (auto& kv : s->conns) {
          if (is_doomed(kv.first)) continue;
          Conn* cc = &kv.second;
          drain_ready_replies(cc);
          mark_dirty(s, cc);
        }
        continue;  // stop flag is checked at the top of the loop
      }
      if (fd == s->listen_fd) {
        while (true) {
          int cfd = accept(s->listen_fd, nullptr, nullptr);
          if (cfd < 0) break;  // EAGAIN or transient error: try next wakeup
          if (!set_nonblocking(cfd)) {
            close(cfd);
            continue;
          }
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          epoll_event cev{};
          cev.events = EPOLLIN;
          cev.data.fd = cfd;
          if (epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, cfd, &cev) != 0) {
            close(cfd);
            continue;
          }
          s->conns[cfd].fd = cfd;
        }
        continue;
      }
      if (is_doomed(fd)) continue;
      auto it = s->conns.find(fd);
      if (it == s->conns.end()) continue;
      Conn* c = &it->second;
      bool ok = true;
      if (ev & EPOLLERR) ok = false;
      if (ok && (ev & EPOLLIN)) ok = on_readable(s, c);
      if (ok && (ev & EPOLLOUT)) mark_dirty(s, c);
      // the half-closed/poisoned close checks run in flush_batch, after
      // this batch's single syscall round has sent what it can
      if (!ok) doomed.push_back(fd);
    }
    flush_batch(s, &doomed);
    for (int fd : doomed) close_conn(s, fd);
  }
  for (auto& kv : s->conns) close(kv.first);
  s->conns.clear();
}

void destroy(ServerState* s) {
  if (s->listen_fd >= 0) close(s->listen_fd);
  if (s->wake_fd >= 0) close(s->wake_fd);
  if (s->epoll_fd >= 0) close(s->epoll_fd);
#ifdef TPUMS_HAVE_URING
  uring_destroy(&s->uring);
#endif
  delete s;
}

}  // namespace

extern "C" {

void* tpums_server_start3(void* store, const char* state_name,
                          const char* job_id, const char* host, int port,
                          const char* topk_item_suffix,
                          const char* topk_user_suffix,
                          const double* latency_bounds, int n_bounds) {
  if (!store || !state_name) return nullptr;
  auto* s = new ServerState();
  s->store = store;
  s->state_name = state_name;
  s->job_id = job_id ? job_id : "local";
  s->topk_item_suffix = topk_item_suffix ? topk_item_suffix : "";
  s->topk_user_suffix = topk_user_suffix ? topk_user_suffix : "";
  s->host_str = (host && *host) ? host : "0.0.0.0";
  // latency bucket ladder: handed over as the exact doubles of
  // obs/metrics.LATENCY_BUCKETS_S — re-deriving the log ladder here would
  // risk float-math drift and merge_snapshots silently skipping the series
  if (latency_bounds && n_bounds > 0) {
    s->lat_bounds.assign(latency_bounds, latency_bounds + n_bounds);
  }

  s->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    destroy(s);
    return nullptr;
  }
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (!host || !*host || strcmp(host, "0.0.0.0") == 0) {
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
  } else if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    destroy(s);
    return nullptr;
  }
  if (bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
          0 ||
      listen(s->listen_fd, 128) != 0 || !set_nonblocking(s->listen_fd)) {
    destroy(s);
    return nullptr;
  }
  sockaddr_in bound{};
  socklen_t blen = sizeof(bound);
  if (getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&bound), &blen) !=
      0) {
    destroy(s);
    return nullptr;
  }
  s->port = ntohs(bound.sin_port);

  s->epoll_fd = epoll_create1(0);
  s->wake_fd = eventfd(0, EFD_NONBLOCK);
  if (s->epoll_fd < 0 || s->wake_fd < 0) {
    destroy(s);
    return nullptr;
  }
  epoll_event lev{};
  lev.events = EPOLLIN;
  lev.data.fd = s->listen_fd;
  epoll_event wev{};
  wev.events = EPOLLIN;
  wev.data.fd = s->wake_fd;
  if (epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->listen_fd, &lev) != 0 ||
      epoll_ctl(s->epoll_fd, EPOLL_CTL_ADD, s->wake_fd, &wev) != 0) {
    destroy(s);
    return nullptr;
  }
  // Reply-path batching backend: io_uring when the build found kernel
  // headers AND the runtime setup probe succeeds (seccomp or an old
  // kernel fail it cleanly), else the epoll + sendmsg scatter-gather
  // fallback.  TPUMS_URING=0 forces the fallback.
  const char* ue = getenv("TPUMS_URING");
  bool want_uring = !(ue && ue[0] == '0' && ue[1] == '\0');
#ifdef TPUMS_HAVE_URING
  if (want_uring) s->uring_on = uring_init(&s->uring, 64);
#else
  (void)want_uring;
#endif
  s->loop = std::thread(event_loop, s);
  s->topk_worker = std::thread(topk_worker_loop, s);
  return s;
}

void* tpums_server_start2(void* store, const char* state_name,
                          const char* job_id, const char* host, int port,
                          const char* topk_item_suffix,
                          const char* topk_user_suffix) {
  return tpums_server_start3(store, state_name, job_id, host, port,
                             topk_item_suffix, topk_user_suffix, nullptr, 0);
}

void* tpums_server_start(void* store, const char* state_name,
                         const char* job_id, const char* host, int port) {
  return tpums_server_start3(store, state_name, job_id, host, port, nullptr,
                             nullptr, nullptr, 0);
}

void tpums_server_set_health(void* srv, const char* health_json) {
  if (!srv) return;
  auto* s = static_cast<ServerState*>(srv);
  std::lock_guard<std::mutex> g(s->health_mu);
  s->health_json = health_json ? health_json : "";
}

void tpums_server_set_trace(void* srv, const char* path,
                            long long max_bytes, int keep) {
  if (!srv) return;
  auto* s = static_cast<ServerState*>(srv);
  std::lock_guard<std::mutex> g(s->trace_mu);
  s->trace_path = path ? path : "";
  if (max_bytes > 0) s->trace_max_bytes = max_bytes;
  if (keep >= 0) s->trace_keep = keep;
  s->trace_file_bytes = -1;  // re-stat: the path may have changed
}

int tpums_server_port(void* srv) {
  return srv ? static_cast<ServerState*>(srv)->port : -1;
}

uint64_t tpums_server_requests(void* srv) {
  return srv ? static_cast<ServerState*>(srv)->requests.load() : 0;
}

int tpums_server_io_stats(void* srv, uint64_t* recv_calls,
                          uint64_t* reply_syscalls, uint64_t* reply_bytes,
                          int* uring_active) {
  if (!srv) return -1;
  auto* s = static_cast<ServerState*>(srv);
  if (recv_calls)
    *recv_calls = s->recv_calls.load(std::memory_order_relaxed);
  if (reply_syscalls)
    *reply_syscalls = s->reply_syscalls.load(std::memory_order_relaxed);
  if (reply_bytes)
    *reply_bytes = s->reply_bytes.load(std::memory_order_relaxed);
  if (uring_active) *uring_active = s->uring_on ? 1 : 0;
  return 0;
}

void tpums_server_stop(void* srv) {
  if (!srv) return;
  auto* s = static_cast<ServerState*>(srv);
  s->stop.store(true, std::memory_order_release);
  uint64_t one = 1;
  ssize_t wr = write(s->wake_fd, &one, 8);
  (void)wr;
  if (s->loop.joinable()) s->loop.join();
  // epoll thread gone -> no new tasks; stop the worker, then reap the
  // last background index build before freeing state they read
  s->worker_stop.store(true, std::memory_order_release);
  s->task_cv.notify_all();
  if (s->topk_worker.joinable()) s->topk_worker.join();
  if (s->topk_builder.joinable()) s->topk_builder.join();
  if (s->dot_builder.joinable()) s->dot_builder.join();
  destroy(s);
}

}  // extern "C"
