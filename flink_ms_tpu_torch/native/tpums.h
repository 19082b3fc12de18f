// Public C API of the native serving components (libtpums.so).
//
// Two units link into the one .so consumed over ctypes by
// flink_ms_tpu_torch/serve/native_store.py:
//   store.cpp         — persistent KV store (rocksdb-parity state backend)
//   lookup_server.cpp — epoll TCP lookup server (Netty-KvState-parity data
//                       plane, QueryClientHelper.java:104-139) serving GETs
//                       straight from the store, no Python on the hot path.
#ifndef TPUMS_H_
#define TPUMS_H_

#include <stdint.h>

extern "C" {

// -- store (store.cpp) ------------------------------------------------------
void* tpums_open(const char* dir);
int tpums_put(void* h, const char* k, uint32_t klen, const char* v,
              uint32_t vlen);
// Returns a malloc'd value buffer (caller frees via tpums_free_buf) or
// nullptr; *err_out is set non-zero on I/O failure (vs. key-not-found).
char* tpums_get(void* h, const char* k, uint32_t klen, uint32_t* vlen_out,
                int* err_out);
void tpums_free_buf(char* p);
int tpums_delete(void* h, const char* k, uint32_t klen);
// Bulk-ingest a journal chunk (complete '\n'-terminated lines).  mode 0 =
// ALS rows "id,T,payload" keyed "id-T"; mode 1 = SVM rows keyed by the
// first comma token (no comma: whole line keys an empty payload — the
// Python parser's semantics).  Malformed ALS rows are counted in
// *errs_out and skipped.  Returns 0, or -1 on write failure.
int tpums_ingest_buf(void* h, const char* buf, uint64_t len, int mode,
                     uint64_t* rows_out, uint64_t* errs_out);
uint64_t tpums_count(void* h);
int tpums_flush(void* h);
typedef void (*tpums_key_cb)(const char* key, uint32_t klen, void* ctx);
int tpums_keys(void* h, tpums_key_cb cb, void* ctx);
// Bounded-lock variant: emits whole hash buckets from *cursor until
// >= max_keys keys, advancing the cursor; returns the count (0 = done).
// A rehash between chunks may skip/repeat keys — convergent consumers only.
uint64_t tpums_keys_chunk(void* h, uint64_t* cursor, uint64_t max_keys,
                          tpums_key_cb cb, void* ctx);
uint64_t tpums_log_bytes(void* h);
uint64_t tpums_live_bytes(void* h);
int tpums_compact(void* h);
void tpums_close(void* h);

// -- shared-memory arena reader (arena.cpp) ---------------------------------
// Opens the per-worker mmap'd factor arena written in place by the Python
// consumer (flink_ms_tpu_torch/serve/arena.py — seqlock-versioned fixed-stride
// slots, open-addressing key index).  The returned handle flows through the
// SAME read API as a store handle (tpums_get / tpums_count / tpums_keys /
// tpums_keys_chunk / tpums_log_bytes / tpums_live_bytes / tpums_close), so
// tpums_server_start* serves GET/MGET/B2 — and builds TOPK/DOT indexes —
// straight from the shared pages with zero per-request pushes.  Mutating
// verbs (put/delete/ingest/compact) fail with -1: the consumer's mmap is
// the one writer.  Torn or writer-abandoned rows (odd seqlock) read as
// key-missing, never as a torn value.  A missing CURRENT is not an error:
// the handle attaches lazily once the writer creates the arena, and
// remaps itself when the writer retires a generation (growth).
void* tpums_arena_open(const char* dir);
// Force a remap check (normally implicit per read); -1 on a non-arena
// handle or when no generation file exists yet.
int tpums_arena_refresh(void* h);
// Cumulative seqlock read retries (torn/odd slots observed) — the lock-free
// path's contention signal, exported as tpums_arena_read_retries_total.
uint64_t tpums_arena_read_retries(void* h);
// Arena gauge snapshot for METRICS; -1 on a non-arena handle (how
// lookup_server.cpp detects it serves an arena).  Any out pointer may be
// null.
int tpums_arena_stats(void* h, double* rows, double* capacity,
                      double* resident_bytes, double* retries,
                      double* load_factor);
// Write-plane counter snapshot from the <dir>/writer.stats sidecar the
// native batch writer maintains (batch rows/seconds, CAS outcomes) — how
// the METRICS verb exports tpums_arena_batch_rows_total and friends
// without a Python push.  -1 on a non-arena handle or before any native
// writer has created the sidecar (the handle re-probes per call).  Any
// out pointer may be null.
int tpums_arena_write_stats(void* h, double* batch_rows,
                            double* batch_seconds, double* cas_success,
                            double* cas_retry);
// Thread-CPU seconds burned inside the native write plane (put_batch +
// cas_floats sections, sidecar offset [40:48)) — the profiling plane's
// "native;arena_writer" row.  Separate export so the frozen
// tpums_arena_write_stats ABI never moves; same -1 semantics.
int tpums_arena_write_cpu_seconds(void* h, double* cpu_s);

// -- shared-memory arena writer (arena.cpp) ---------------------------------
// The native half of ArenaModelTable's write path.  A writer handle maps
// ONE generation file read-write; the Python table keeps the flock, the
// CURRENT pointer, growth/rehash, and the table lock (callers MUST hold
// it — there is exactly one writer), and reopens the handle after every
// generation flip.  Row bytes are parity-exact with Arena.put_bytes:
// same seqlock claim order, same seq values, same untouched value tails.
void* tpums_arena_writer_open(const char* path, const char* dir);
void tpums_arena_writer_close(void* h);
// Upsert a columnar batch: kbuf/vbuf are '\n'-joined key/value bytes
// (n-1 separators; rows may not contain '\n' — the caller guards).  Stops
// EARLY at the first row that would need growth (oversize key/value or
// load-factor ceiling) and returns the applied prefix length; the caller
// grows, reopens, and resumes from there.  Returns -1 on malformed blobs
// or a bad handle.  *max_klen_out/*max_vlen_out (may be null) get the
// largest key/value over the applied prefix, feeding the Python side's
// observed-size growth geometry.
long long tpums_arena_put_batch(void* h, const char* kbuf,
                                uint64_t kbuf_len, const char* vbuf,
                                uint64_t vbuf_len, uint64_t n,
                                uint32_t* max_klen_out,
                                uint32_t* max_vlen_out);
// Compare-and-swap the value bytes of one row in place (seqlock odd/even
// preserved, so concurrent readers never see a torn row).  Returns 1 on
// swap, 0 when the current value differs from `expect` (counted as a CAS
// retry — the caller's LWW re-put is the repair), -1 when the key is
// missing or any length exceeds the arena geometry.
int tpums_arena_cas_floats(void* h, const char* k, uint32_t klen,
                           const char* expect, uint32_t explen,
                           const char* newv, uint32_t newlen);

// -- lookup server (lookup_server.cpp) --------------------------------------
// Starts an epoll event loop on its own thread, serving the line protocol of
// flink_ms_tpu_torch/serve/server.py (GET/MGET/COUNT/PING/TOPK/TOPKV) from the
// given open store handle.  `port` 0 picks an ephemeral port.  Returns a
// server handle or nullptr.  tpums_server_start leaves TOPK/TOPKV
// unconfigured (they answer E, parity with a Python server that has no
// registered handler); tpums_server_start2 additionally takes the catalog
// item-key suffix (e.g. "-I") and the TOPK query-entity suffix (e.g. "-U"),
// enabling catalog-scored top-k straight from the store.
void* tpums_server_start(void* store, const char* state_name,
                         const char* job_id, const char* host, int port);
void* tpums_server_start2(void* store, const char* state_name,
                          const char* job_id, const char* host, int port,
                          const char* topk_item_suffix,
                          const char* topk_user_suffix);
// start3 additionally enables HEALTH/METRICS: `latency_bounds` is the shared
// log-bucket ladder (obs/metrics.LATENCY_BUCKETS_S, handed over as exact
// doubles so cross-plane merge_snapshots bounds compare equal) and turns on
// per-verb request/latency/error accounting; with nullptr/0 the server
// behaves like start2 (METRICS answers E).  All variants speak both the tab
// protocol and the HELLO-negotiated B2 binary batch framing (serve/proto.py).
void* tpums_server_start3(void* store, const char* state_name,
                          const char* job_id, const char* host, int port,
                          const char* topk_item_suffix,
                          const char* topk_user_suffix,
                          const double* latency_bounds, int n_bounds);
// Replace the HEALTH verb's base report with a one-line JSON object (the
// owning job's health dict, pushed on every heartbeat); the server splices
// in the live key count and metrics_uri.  NULL or "" reverts to the
// synthesized always-ready report.
void tpums_server_set_health(void* srv, const char* health_json);
// Enable the tail-forensics span spill: traced requests (tab ``tid=``
// stamp or the B2 ``tr=1`` per-record trace field) append one JSONL
// server_reply span record to `path` (obs/tracing.py event schema), with
// size-capped keep-K rotation (path -> path.1 -> ... -> path.K).
// max_bytes <= 0 keeps the 64 MiB default; keep < 0 keeps the default 3;
// NULL or "" path turns the spill off.
void tpums_server_set_trace(void* srv, const char* path,
                            long long max_bytes, int keep);
int tpums_server_port(void* srv);
uint64_t tpums_server_requests(void* srv);
// Reply-path syscall accounting for the batched socket loop: recv()
// invocations, send-side syscalls (sendmsg calls, or io_uring_enter
// submissions — one per batch of dirty connections), bytes sent, and
// whether the io_uring backend passed its runtime probe (0 = epoll +
// scatter-gather sendmsg fallback; TPUMS_URING=0 forces it).  The
// syscalls-per-frame tests read deltas from here instead of strace.
int tpums_server_io_stats(void* srv, uint64_t* recv_calls,
                          uint64_t* reply_syscalls, uint64_t* reply_bytes,
                          int* uring_active);
// Stops the loop, closes all connections, joins the thread, frees the handle.
void tpums_server_stop(void* srv);

}  // extern "C"

#endif  // TPUMS_H_
