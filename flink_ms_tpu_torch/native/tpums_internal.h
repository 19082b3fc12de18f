// Internal handle-dispatch contract between store.cpp and arena.cpp.
//
// Both tpums_open (log-structured store) and tpums_arena_open (mmap'd
// shared-memory arena, read-only plane) hand out opaque void* handles that
// flow through the SAME public read API (tpums_get/tpums_count/...), so the
// epoll lookup server serves either backing without caring which.  The
// first 4 bytes of every handle are a tag; store.cpp checks it and routes
// arena handles to the arena_* implementations below.
#ifndef TPUMS_INTERNAL_H_
#define TPUMS_INTERNAL_H_

#include <stdint.h>

#include "tpums.h"

constexpr uint32_t kTpumsStoreTag = 0x53544F52u;  // "STOR"
constexpr uint32_t kTpumsArenaTag = 0x4152454Eu;  // "AREN"
// Arena WRITER handles (tpums_arena_writer_open) never dispatch through
// the store read API; the distinct tag keeps a writer handle passed to a
// reader verb (or vice versa) an explicit error instead of a crash.
constexpr uint32_t kTpumsArenaWriterTag = 0x41575254u;  // "AWRT"

struct TpumsTaggedHandle {
  uint32_t tag;
};

inline bool tpums_is_arena(void* h) {
  return h != nullptr &&
         static_cast<TpumsTaggedHandle*>(h)->tag == kTpumsArenaTag;
}

// arena.cpp implementations behind the dispatch (reader-plane subset; the
// arena has exactly one writer — the Python consumer — so every mutating
// verb on an arena handle fails with -1 in store.cpp).
char* tpums_arena_get_impl(void* h, const char* k, uint32_t klen,
                           uint32_t* vlen_out, int* err_out);
uint64_t tpums_arena_count_impl(void* h);
int tpums_arena_keys_impl(void* h, tpums_key_cb cb, void* ctx);
uint64_t tpums_arena_keys_chunk_impl(void* h, uint64_t* cursor,
                                     uint64_t max_keys, tpums_key_cb cb,
                                     void* ctx);
uint64_t tpums_arena_log_bytes_impl(void* h);
uint64_t tpums_arena_live_bytes_impl(void* h);
void tpums_arena_close_impl(void* h);

#endif  // TPUMS_INTERNAL_H_
