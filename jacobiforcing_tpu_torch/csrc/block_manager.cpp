// Native paged-KV block manager with hash-based prefix caching, host C++17.
//
// The port's own copy of native/block_manager.cpp (the JAX package's native
// allocator), built by ops/_build.build_host with the host compiler into
// build/host/ and bound by engine/native_block_manager.py.  It implements the
// host-side page allocator of engine/block_manager.py (reference semantics
// from inference_engine/engine/block_manager.py:23-565): refcounted pages, a
// FIFO free list whose entries keep their content hash for prefix-cache
// revival, and chained XXH64-style hashing over full pages of token ids (the
// reference uses xxhash, block_manager.py:67-91).  Per-prompt hashing and
// allocation is host-path work that the Python interpreter lock serializes;
// this library keeps it native.  Exposed through a C ABI for ctypes.
//
// Semantics mirror the Python class exactly (differential-tested):
//   * allocate_prompt: walk full pages, chain-hash, reuse a cached page only
//     while the hit prefix is contiguous from 0 and (i+1)*P <= n_tokens-1;
//   * pages repurposed from the free list drop their stale hash entry;
//   * deallocate releases in reverse order; zero-ref pages join the FIFO
//     free list keeping their hash (revivable).

#include <cstdint>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

// XXH64-inspired 64-bit streaming hash (constants from the public XXH64
// algorithm; single-lane variant — quality is ample for page identity,
// collisions are verified by token comparison anyway).
constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;

static inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

static uint64_t hash_chain(uint64_t prev, const int32_t* toks, int n) {
  uint64_t h = prev * P1 + P3;
  for (int i = 0; i < n; ++i) {
    h ^= rotl(static_cast<uint64_t>(static_cast<uint32_t>(toks[i])) * P2, 31) * P1;
    h = rotl(h, 27) * P1 + P3;
  }
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

struct Page {
  int ref_count = 0;
  bool has_hash = false;
  uint64_t hash = 0;
  std::vector<int32_t> tokens;  // content backing the hash (collision check)
};

struct BlockManager {
  int page_size;
  std::vector<Page> pages;
  // FIFO free list with lazy deletion: entries carry the page's free-epoch so
  // a stale entry (page revived and re-freed since) is skipped, preserving
  // exact FIFO order parity with the Python OrderedDict implementation.
  std::deque<std::pair<int, uint64_t>> free_list;
  std::vector<uint64_t> free_epoch;
  std::vector<uint8_t> in_free;              // membership flags
  std::unordered_map<uint64_t, int> hash_to_page;
  std::unordered_map<int64_t, std::vector<int>> tables;  // seq_id -> page ids
  long prefix_cache_hits = 0;
  long prefix_cache_queries = 0;

  explicit BlockManager(int num_pages, int psize) : page_size(psize) {
    pages.resize(num_pages);
    in_free.assign(num_pages, 1);
    free_epoch.assign(num_pages, 0);
    for (int i = 0; i < num_pages; ++i) free_list.push_back({i, 0});
  }

  int take_page() {
    while (!free_list.empty()) {
      auto [id, epoch] = free_list.front();
      free_list.pop_front();
      if (!in_free[id] || free_epoch[id] != epoch) continue;  // stale entry
      in_free[id] = 0;
      Page& p = pages[id];
      if (p.has_hash) {
        auto it = hash_to_page.find(p.hash);
        if (it != hash_to_page.end() && it->second == id) hash_to_page.erase(it);
        p.has_hash = false;
        p.tokens.clear();
      }
      p.ref_count = 1;
      return id;
    }
    return -1;
  }

  void release_page(int id) {
    Page& p = pages[id];
    if (--p.ref_count == 0) {
      free_list.push_back({id, ++free_epoch[id]});
      in_free[id] = 1;
    }
  }

  int num_free() const {
    int n = 0;
    for (uint8_t f : in_free) n += f;
    return n;
  }

  // returns cached_len or -1 on out-of-pages (all allocations rolled back)
  int allocate_prompt(int64_t seq_id, const int32_t* toks, int n_tokens, int margin) {
    const int P = page_size;
    int n_pages = (n_tokens + margin + P - 1) / P;
    std::vector<int>& table = tables[seq_id];
    table.clear();
    int cached_len = 0;
    uint64_t prev_hash = 0;
    bool chain_alive = true, have_prev = false;
    for (int i = 0; i < n_pages; ++i) {
      int lo = i * P;
      int len = std::min(n_tokens - lo, P);
      if (len < 0) len = 0;
      bool full = (len == P);
      bool hashed = full && chain_alive;
      uint64_t h = 0;
      int hit = -1;
      if (hashed) {
        h = hash_chain(have_prev ? prev_hash : 0x27220A95ULL, toks + lo, len);
        ++prefix_cache_queries;
        auto it = hash_to_page.find(h);
        if (it != hash_to_page.end() && cached_len == lo &&
            (i + 1) * P <= n_tokens - 1) {
          Page& cand = pages[it->second];
          if (cand.has_hash &&
              cand.tokens.size() == static_cast<size_t>(len) &&
              std::memcmp(cand.tokens.data(), toks + lo, len * 4) == 0) {
            hit = it->second;
          }
        }
      }
      int page_id;
      if (hit >= 0) {
        Page& p = pages[hit];
        if (p.ref_count == 0) in_free[hit] = 0;  // revive from free list
        ++p.ref_count;
        cached_len += P;
        ++prefix_cache_hits;
        page_id = hit;
      } else {
        page_id = take_page();
        if (page_id < 0) {  // roll back
          for (auto it2 = table.rbegin(); it2 != table.rend(); ++it2)
            release_page(*it2);
          table.clear();
          tables.erase(seq_id);
          return -1;
        }
        if (hashed) {
          Page& p = pages[page_id];
          p.has_hash = true;
          p.hash = h;
          p.tokens.assign(toks + lo, toks + lo + len);
          hash_to_page[h] = page_id;
        }
      }
      if (!full) chain_alive = false;
      prev_hash = h;
      have_prev = hashed;
      table.push_back(page_id);
    }
    return cached_len;
  }

  // extend the table until it covers upto_tokens; 1 on success, 0 if OOM
  int ensure_capacity(int64_t seq_id, int upto_tokens) {
    auto& table = tables[seq_id];
    int need = (upto_tokens + page_size - 1) / page_size;
    while (static_cast<int>(table.size()) < need) {
      int id = take_page();
      if (id < 0) return 0;
      table.push_back(id);
    }
    return 1;
  }

  void deallocate(int64_t seq_id) {
    auto it = tables.find(seq_id);
    if (it == tables.end()) return;
    for (auto rit = it->second.rbegin(); rit != it->second.rend(); ++rit)
      release_page(*rit);
    tables.erase(it);
  }

  int get_table(int64_t seq_id, int32_t* out, int cap) const {
    auto it = tables.find(seq_id);
    if (it == tables.end()) return 0;
    int n = static_cast<int>(it->second.size());
    for (int i = 0; i < n && i < cap; ++i) out[i] = it->second[i];
    return n;
  }
};

}  // namespace

extern "C" {

void* jf_bm_create(int num_pages, int page_size) {
  return new BlockManager(num_pages, page_size);
}
void jf_bm_destroy(void* bm) { delete static_cast<BlockManager*>(bm); }
int jf_bm_num_free(void* bm) { return static_cast<BlockManager*>(bm)->num_free(); }
int jf_bm_allocate_prompt(void* bm, int64_t seq_id, const int32_t* toks,
                          int n_tokens, int margin) {
  return static_cast<BlockManager*>(bm)->allocate_prompt(seq_id, toks, n_tokens, margin);
}
int jf_bm_ensure_capacity(void* bm, int64_t seq_id, int upto_tokens) {
  return static_cast<BlockManager*>(bm)->ensure_capacity(seq_id, upto_tokens);
}
void jf_bm_deallocate(void* bm, int64_t seq_id) {
  static_cast<BlockManager*>(bm)->deallocate(seq_id);
}
int jf_bm_get_table(void* bm, int64_t seq_id, int32_t* out, int cap) {
  return static_cast<BlockManager*>(bm)->get_table(seq_id, out, cap);
}
long jf_bm_prefix_hits(void* bm) {
  return static_cast<BlockManager*>(bm)->prefix_cache_hits;
}
long jf_bm_prefix_queries(void* bm) {
  return static_cast<BlockManager*>(bm)->prefix_cache_queries;
}
int jf_bm_ref_count(void* bm, int page_id) {
  return static_cast<BlockManager*>(bm)->pages[page_id].ref_count;
}
// dump live free-list entries in pop order; returns count
int jf_bm_dump_free(void* bm, int32_t* out, int cap) {
  auto* m = static_cast<BlockManager*>(bm);
  int n = 0;
  for (auto& e : m->free_list)
    if (m->in_free[e.first] && m->free_epoch[e.first] == e.second && n < cap)
      out[n++] = e.first;
  return n;
}
// invariant check: ref==0 <=> in_free==1, and every flagged-free page has a
// live deque entry; returns -1 if consistent else the offending page id
int jf_bm_check(void* bm) {
  auto* m = static_cast<BlockManager*>(bm);
  std::vector<uint8_t> has_entry(m->pages.size(), 0);
  for (auto& e : m->free_list)
    if (m->in_free[e.first] && m->free_epoch[e.first] == e.second)
      has_entry[e.first] = 1;
  for (size_t i = 0; i < m->pages.size(); ++i) {
    bool free_flag = m->in_free[i];
    bool ref0 = m->pages[i].ref_count == 0;
    if (free_flag != ref0) return static_cast<int>(i);
    if (free_flag && !has_entry[i]) return static_cast<int>(i) + 1000;
  }
  return -1;
}

}  // extern "C"
