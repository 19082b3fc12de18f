// tpums persistent KV store — the native state backend behind the serving
// layer's `--stateBackend rocksdb` mode (the reference keeps served model
// state in RocksDB via JNI — als-ms/pom.xml:120-123, selected at
// ALSKafkaConsumer.java:55-56).
//
// Design: log-structured (bitcask-style). One append-only data log on disk,
// an in-memory hash index of key -> (offset, length) of the latest value.
// - put: append [klen][vlen][key][value] record, update index
// - get: pread the value at the indexed offset (no seek state, thread-safe)
// - open: sequential scan rebuilds the index; a torn tail (crash mid-append)
//   is truncated — recovery is last-complete-record
// - flush: fsync (the checkpoint barrier)
// - compact: rewrite live records to a fresh log when garbage accumulates
//
// Values can exceed RAM in aggregate; only keys + 12 bytes live in memory.
// Exposed as a C ABI for the Python ctypes binding (no pybind11 in image).

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/file.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include "tpums.h"  // signature check against the shared public API
#include "tpums_internal.h"

namespace {

struct Entry {
  uint64_t offset;  // offset of the value bytes in the log
  uint32_t length;
};

struct Store {
  uint32_t tag = kTpumsStoreTag;  // handle dispatch (tpums_internal.h):
                                  // arena handles share the read API
  std::string dir;
  std::string log_path;
  int fd = -1;
  uint64_t end = 0;        // append position
  uint64_t live_bytes = 0; // bytes of records still referenced
  bool wedged = false;     // unrecoverable write failure: reads-only mode
  std::unordered_map<std::string, Entry> index;
  std::mutex mu;
};

constexpr uint32_t kTombstone = 0xFFFFFFFFu;

bool read_exact(int fd, void* buf, size_t n, uint64_t off) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = pread(fd, p, n, off);
    if (r <= 0) return false;
    p += r;
    off += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_all(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t w = write(fd, p, n);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

constexpr uint64_t kScanFailed = ~0ull;

// Scan the log, rebuilding the index; returns the offset of the first
// incomplete record (the recovery truncation point), or kScanFailed when
// the log length cannot even be determined (distinct from "empty log" —
// returning 0 there would let the caller truncate a healthy store).
uint64_t rebuild_index(Store* s) {
  struct stat st;
  if (fstat(s->fd, &st) != 0) return kScanFailed;
  uint64_t size = static_cast<uint64_t>(st.st_size);
  uint64_t pos = 0;
  std::string key;
  while (pos + 8 <= size) {
    uint32_t hdr[2];
    // both reads below are fully inside [0, size): a failure is a real I/O
    // error (EIO, concurrent truncation), NOT a torn tail — refusing to open
    // beats truncating away committed records after the failure point
    if (!read_exact(s->fd, hdr, 8, pos)) return kScanFailed;
    uint32_t klen = hdr[0], vlen = hdr[1];
    uint64_t vbytes = (vlen == kTombstone) ? 0 : vlen;
    if (klen > (1u << 20) || (vlen != kTombstone && vlen > (1u << 28)))
      break;  // corrupt header
    if (pos + 8 + klen + vbytes > size) break;  // torn tail
    key.resize(klen);
    if (klen && !read_exact(s->fd, &key[0], klen, pos + 8)) return kScanFailed;
    auto it = s->index.find(key);
    if (it != s->index.end()) {
      s->live_bytes -= 8 + key.size() + it->second.length;
      s->index.erase(it);
    }
    if (vlen != kTombstone) {
      s->index[key] = Entry{pos + 8 + klen, vlen};
      s->live_bytes += 8 + klen + vlen;
    }
    pos += 8 + klen + vbytes;
  }
  return pos;
}

constexpr uint32_t kMaxKeyLen = 1u << 20;    // matched by rebuild_index's
constexpr uint32_t kMaxValueLen = 1u << 28;  // corruption heuristics

int append_record(Store* s, const char* k, uint32_t klen, const char* v,
                  uint32_t vlen) {
  // enforce the same limits the recovery scan treats as corruption —
  // otherwise an oversized record would truncate itself and everything
  // after it on the next reopen
  if (klen > kMaxKeyLen || (vlen != kTombstone && vlen > kMaxValueLen))
    return -1;
  if (s->wedged) return -1;
  uint32_t hdr[2] = {klen, vlen};
  uint64_t vbytes = (vlen == kTombstone) ? 0 : vlen;
  if (!write_all(s->fd, hdr, 8) || (klen && !write_all(s->fd, k, klen)) ||
      (vbytes && !write_all(s->fd, v, vbytes))) {
    // partial append (ENOSPC/EIO): roll the file back to the last complete
    // record, otherwise every later record's indexed offset is shifted
    // (the fd is O_APPEND, so retries would land past the partial bytes)
    if (ftruncate(s->fd, static_cast<off_t>(s->end)) != 0) {
      // can't restore the invariant offset==end: refuse further writes,
      // keep serving reads from the already-indexed prefix
      s->wedged = true;
    }
    return -1;
  }
  std::string key(k, klen);
  auto it = s->index.find(key);
  if (it != s->index.end()) {
    s->live_bytes -= 8 + key.size() + it->second.length;
    s->index.erase(it);
  }
  if (vlen != kTombstone) {
    s->index[std::move(key)] = Entry{s->end + 8 + klen, vlen};
    s->live_bytes += 8 + klen + vlen;
  }
  s->end += 8 + klen + vbytes;
  return 0;
}

}  // namespace

extern "C" {

void* tpums_open(const char* dir) {
  Store* s = new Store();
  s->dir = dir;
  ::mkdir(dir, 0777);  // best effort; open below reports real failures
  s->log_path = s->dir + "/data.log";
  s->fd = ::open(s->log_path.c_str(), O_RDWR | O_CREAT | O_APPEND, 0644);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  // single-writer guard: a second process (or a leaked handle) opening the
  // same store would interleave appends and corrupt the log
  if (flock(s->fd, LOCK_EX | LOCK_NB) != 0) {
    close(s->fd);
    delete s;
    return nullptr;
  }
  uint64_t valid = rebuild_index(s);
  struct stat st;
  if (valid == kScanFailed || fstat(s->fd, &st) != 0) {
    // can't tell log length: refuse to open rather than risk truncating a
    // healthy log against garbage st_size
    close(s->fd);
    delete s;
    return nullptr;
  }
  if (valid < static_cast<uint64_t>(st.st_size)) {
    // torn tail from a crash mid-append: truncate to last complete record
    if (ftruncate(s->fd, static_cast<off_t>(valid)) != 0) {
      close(s->fd);
      delete s;
      return nullptr;
    }
  }
  s->end = valid;
  return s;
}

int tpums_put(void* h, const char* k, uint32_t klen, const char* v,
              uint32_t vlen) {
  if (!h || vlen == kTombstone) return -1;
  if (tpums_is_arena(h)) return -1;  // arena rows are written in place by
                                     // the consumer's mmap, never pushed
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return append_record(s, k, klen, v, vlen);
}

int tpums_delete(void* h, const char* k, uint32_t klen) {
  if (!h || tpums_is_arena(h)) return -1;
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return append_record(s, k, klen, nullptr, kTombstone);
}

int tpums_ingest_buf(void* h, const char* buf, uint64_t len, int mode,
                     uint64_t* rows_out, uint64_t* errs_out) {
  // The serving consumer's hot loop, natively: parse journal lines,
  // serialize every record into ONE buffer, and commit it with ONE
  // write() — replaces a per-row Python->ctypes round trip plus three
  // syscalls per record (the measured ingest bottleneck).  Malformed
  // rows (and key/value-limit violations) are counted and skipped, the
  // deliberate skip-and-count policy of the serving loop.
  if (!h || tpums_is_arena(h) || (mode != 0 && mode != 1)) return -1;
  Store* s = static_cast<Store*>(h);
  uint64_t rows = 0, errs = 0;
  std::string key;  // reused across rows (ALS key is id + '-' + type)
  struct Pending {
    uint64_t key_rel;  // key offset within the chunk buffer (no per-row
    uint32_t klen;     // heap copy — the bytes already live in outbuf)
    uint64_t val_rel;  // value offset within the chunk buffer
    uint32_t vlen;
  };
  std::vector<char> outbuf;
  outbuf.reserve(static_cast<size_t>(len) + (len >> 3) + 64);
  std::vector<Pending> pend;
  std::lock_guard<std::mutex> lock(s->mu);
  if (s->wedged) return -1;

  auto emit = [&](const char* k, uint32_t klen, const char* v,
                  uint32_t vlen) {
    if (klen > kMaxKeyLen || vlen > kMaxValueLen) {
      errs++;
      return;
    }
    uint32_t hdr[2] = {klen, vlen};
    const char* hp = reinterpret_cast<const char*>(hdr);
    outbuf.insert(outbuf.end(), hp, hp + 8);
    uint64_t key_rel = outbuf.size();
    outbuf.insert(outbuf.end(), k, k + klen);
    uint64_t val_rel = outbuf.size();
    outbuf.insert(outbuf.end(), v, v + vlen);
    pend.push_back(Pending{key_rel, klen, val_rel, vlen});
    rows++;
  };

  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) break;  // caller sends complete lines; ignore a torn tail
    const char* line = p;
    uint64_t n = static_cast<uint64_t>(nl - p);
    p = nl + 1;
    if (n == 0) continue;  // blank line, same as the Python loop's skip
    const char* c1 = static_cast<const char*>(memchr(line, ',', n));
    if (mode == 0) {
      // "id,T,payload" -> key "id-T", value payload; fewer than two
      // commas is a parse error (Python split(",", 2) raises)
      if (!c1) {
        errs++;
        continue;
      }
      uint64_t rest = n - (c1 + 1 - line);
      const char* c2 =
          static_cast<const char*>(memchr(c1 + 1, ',', rest));
      if (!c2) {
        errs++;
        continue;
      }
      key.assign(line, c1 - line);
      key.push_back('-');
      key.append(c1 + 1, c2 - (c1 + 1));
      const char* val = c2 + 1;
      emit(key.data(), static_cast<uint32_t>(key.size()), val,
           static_cast<uint32_t>(n - (val - line)));
    } else {
      // SVM: key = first comma token; no comma -> whole line, empty value
      const char* val = c1 ? c1 + 1 : line + n;
      emit(line, static_cast<uint32_t>(c1 ? c1 - line : n), val,
           static_cast<uint32_t>(n - (val - line)));
    }
  }

  if (!outbuf.empty()) {
    if (!write_all(s->fd, outbuf.data(), outbuf.size())) {
      // partial chunk append: roll back to the last complete record so
      // indexed offsets stay valid (same invariant as append_record)
      if (ftruncate(s->fd, static_cast<off_t>(s->end)) != 0)
        s->wedged = true;
      return -1;
    }
    uint64_t base = s->end;
    std::string idx_key;  // one buffer reused across the commit loop
    for (const Pending& pr : pend) {
      idx_key.assign(outbuf.data() + pr.key_rel, pr.klen);
      auto it = s->index.find(idx_key);
      if (it != s->index.end()) {
        s->live_bytes -= 8 + idx_key.size() + it->second.length;
        s->index.erase(it);
      }
      s->index[idx_key] = Entry{base + pr.val_rel, pr.vlen};
      s->live_bytes += 8 + idx_key.size() + pr.vlen;
    }
    s->end += outbuf.size();
  }
  if (rows_out) *rows_out = rows;
  if (errs_out) *errs_out = errs;
  return 0;
}

// Returns a malloc'd value buffer (caller frees via tpums_free_buf) or null.
// A null return with *err_out != 0 is an I/O failure on an EXISTING key —
// callers must surface it as an error, not as "key not found".
char* tpums_get(void* h, const char* k, uint32_t klen, uint32_t* vlen_out,
                int* err_out) {
  if (err_out) *err_out = 0;
  if (!h) return nullptr;
  if (tpums_is_arena(h))
    return tpums_arena_get_impl(h, k, klen, vlen_out, err_out);
  Store* s = static_cast<Store*>(h);
  // the pread must stay under the lock: compaction closes/reopens the fd
  // and relocates every offset, so a lock-free read could hit a stale
  // offset in the rewritten log (or a dead fd)
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->index.find(std::string(k, klen));
  if (it == s->index.end()) return nullptr;
  uint64_t off = it->second.offset;
  uint32_t len = it->second.length;
  char* buf = static_cast<char*>(malloc(len ? len : 1));
  if (!buf) {
    if (err_out) *err_out = 1;
    return nullptr;
  }
  if (len && !read_exact(s->fd, buf, len, off)) {
    free(buf);
    if (err_out) *err_out = 1;
    return nullptr;
  }
  *vlen_out = len;
  return buf;
}

void tpums_free_buf(char* p) { free(p); }

uint64_t tpums_count(void* h) {
  if (!h) return 0;
  if (tpums_is_arena(h)) return tpums_arena_count_impl(h);
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->index.size();
}

int tpums_flush(void* h) {
  if (!h) return -1;
  if (tpums_is_arena(h)) return 0;  // read-only mapping: nothing to sync
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return fsync(s->fd) == 0 ? 0 : -1;
}

// Iterate keys only (no value reads) — lets bindings stream large stores:
// collect the (small) key set under the lock, then fetch values lazily.
typedef void (*tpums_key_cb)(const char*, uint32_t, void*);
int tpums_keys(void* h, tpums_key_cb cb, void* ctx) {
  if (!h) return -1;
  if (tpums_is_arena(h)) return tpums_arena_keys_impl(h, cb, ctx);
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  for (const auto& kv : s->index)
    cb(kv.first.data(), static_cast<uint32_t>(kv.first.size()), ctx);
  return 0;
}

// Bounded-lock key enumeration: emits the keys of whole hash buckets
// [*cursor, ...) until at least max_keys have been emitted or the table is
// exhausted, advancing *cursor past the buckets consumed.  Returns the
// number emitted (0 = done).  The lock is held only per chunk, so a large
// catalog scan (e.g. the lookup server's top-k index build) cannot stall
// concurrent gets for the whole enumeration.  A rehash between chunks may
// skip or repeat keys — callers needing an exact snapshot use tpums_keys;
// convergent consumers (version-checked index rebuilds) dedup/retry.
uint64_t tpums_keys_chunk(void* h, uint64_t* cursor, uint64_t max_keys,
                          tpums_key_cb cb, void* ctx) {
  if (!h || !cursor) return 0;
  if (tpums_is_arena(h))
    return tpums_arena_keys_chunk_impl(h, cursor, max_keys, cb, ctx);
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  uint64_t nbuckets = s->index.bucket_count();
  uint64_t emitted = 0;
  uint64_t b = *cursor;
  for (; b < nbuckets && emitted < max_keys; ++b) {
    for (auto it = s->index.begin(b); it != s->index.end(b); ++it) {
      cb(it->first.data(), static_cast<uint32_t>(it->first.size()), ctx);
      ++emitted;
    }
  }
  *cursor = b;
  return emitted;
}

uint64_t tpums_log_bytes(void* h) {
  if (!h) return 0;
  if (tpums_is_arena(h)) return tpums_arena_log_bytes_impl(h);
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->end;
}

uint64_t tpums_live_bytes(void* h) {
  if (!h) return 0;
  if (tpums_is_arena(h)) return tpums_arena_live_bytes_impl(h);
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->live_bytes;
}

// Rewrite only live records into a fresh log (atomic rename), reclaiming
// space from overwritten rows.  Called by the backend when garbage > 50%.
int tpums_compact(void* h) {
  if (!h) return -1;
  if (tpums_is_arena(h)) return -1;
  Store* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  std::string tmp_path = s->log_path + ".compact";
  int out = ::open(tmp_path.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (out < 0) return -1;
  std::unordered_map<std::string, Entry> new_index;
  uint64_t new_end = 0;
  std::vector<char> buf;
  for (const auto& kv : s->index) {
    uint32_t klen = static_cast<uint32_t>(kv.first.size());
    uint32_t vlen = kv.second.length;
    buf.resize(vlen ? vlen : 1);
    if (vlen && !read_exact(s->fd, buf.data(), vlen, kv.second.offset)) {
      close(out);
      unlink(tmp_path.c_str());
      return -1;
    }
    uint32_t hdr[2] = {klen, vlen};
    if (!write_all(out, hdr, 8) || !write_all(out, kv.first.data(), klen) ||
        (vlen && !write_all(out, buf.data(), vlen))) {
      close(out);
      unlink(tmp_path.c_str());
      return -1;
    }
    new_index[kv.first] = Entry{new_end + 8 + klen, vlen};
    new_end += 8 + klen + vlen;
  }
  // Lock the compacted inode and switch it to append mode BEFORE rename
  // makes it visible at log_path: every failure path still leaves the old
  // locked log fully intact, and after rename the store's own `out` fd
  // already holds the writer lock — no window for a second process, and no
  // post-rename failure can desynchronize the in-memory index.
  if (fsync(out) != 0 || flock(out, LOCK_EX | LOCK_NB) != 0 ||
      fcntl(out, F_SETFL, O_APPEND) != 0 ||
      rename(tmp_path.c_str(), s->log_path.c_str()) != 0) {
    close(out);
    unlink(tmp_path.c_str());
    return -1;
  }
  close(s->fd);  // releases the old inode's lock
  s->fd = out;   // file offset sits at new_end, O_APPEND set: puts append
  s->index = std::move(new_index);
  s->end = new_end;
  s->live_bytes = new_end;
  s->wedged = false;  // fresh fd at new_end: the offset invariant holds again
  return 0;
}

void tpums_close(void* h) {
  if (!h) return;
  if (tpums_is_arena(h)) return tpums_arena_close_impl(h);
  Store* s = static_cast<Store*>(h);
  {
    std::lock_guard<std::mutex> lock(s->mu);
    if (s->fd >= 0) {
      fsync(s->fd);
      close(s->fd);
    }
  }
  delete s;
}

}  // extern "C"
