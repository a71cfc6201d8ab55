// Native block manager for the paged-KV runtime of the PyTorch port.
//
// Same observable state machine as the port's Python BlockManager
// (llmc_paged_tpu_torch/kv/manager.py) and the reference allocator
// (block_manager.c): first-free allocation, whole-prompt LRU eviction on
// exhaustion, lru_counter = ++epoch on alloc and on append-touch. Unlike
// the reference it owns no float buffers — page data lives in the card's
// pool; this is pure metadata, exported over a C ABI for ctypes.
//
// Build: ops/_build.build_host("block_manager") → build/torch_kernels/

#include <cstdint>
#include <map>
#include <set>
#include <vector>

namespace {

struct PageMeta {
    int32_t prompt_id = -1;
    int32_t filled = 0;
    int64_t lru_counter = 0;
};

struct Manager {
    int32_t num_pages;
    int32_t page_size;
    int32_t max_seqs;
    int64_t lru_epoch = 0;
    std::vector<PageMeta> pages;
    std::vector<std::vector<int32_t>> tables;  // prompt -> ordered page ids

    Manager(int32_t np, int32_t ps, int32_t ms)
        : num_pages(np), page_size(ps), max_seqs(ms), pages(np), tables(ms) {}
    virtual ~Manager() = default;

    int32_t find_free() const {
        for (int32_t i = 0; i < num_pages; i++)
            if (pages[i].prompt_id == -1) return i;
        return -1;
    }

    int32_t find_lru() const {
        int32_t victim = -1;
        int64_t bound = lru_epoch;
        for (int32_t i = 0; i < num_pages; i++) {
            if (pages[i].prompt_id != -1 && pages[i].lru_counter < bound) {
                bound = pages[i].lru_counter;
                victim = i;
            }
        }
        return victim;
    }

    virtual int32_t num_free() const {
        int32_t n = 0;
        for (const auto& pg : pages)
            if (pg.prompt_id == -1) n++;
        return n;
    }

    virtual void free_prompt(int32_t prompt) {
        if (prompt < 0 || prompt >= max_seqs) return;
        for (int32_t pid : tables[prompt])
            if (pid >= 0) pages[pid] = PageMeta{};
        tables[prompt].clear();
    }

    // Sliding-window reclamation: free pages wholly below start_pos,
    // leaving -1 tombstones so later positions keep their table index
    // (mirrors BlockManager.release_below).
    virtual int32_t release_below(int32_t prompt, int32_t start_pos) {
        if (prompt < 0 || prompt >= max_seqs) return -1;
        auto& t = tables[prompt];
        int32_t limit = start_pos / page_size;
        if (limit > static_cast<int32_t>(t.size()))
            limit = static_cast<int32_t>(t.size());
        int32_t freed = 0;
        for (int32_t j = 0; j < limit; j++) {
            if (t[j] >= 0) {
                pages[t[j]] = PageMeta{};
                t[j] = -1;
                freed++;
            }
        }
        return freed;
    }

    // Roll the write pointer back to new_len tokens, freeing trailing
    // pages that become empty (mirrors BlockManager.truncate_to; used by
    // speculative decode to release over-reserved pages). Returns pages
    // freed, or -1 on invalid prompt/new_len or when new_len lands in a
    // tombstoned (window-reclaimed) page.
    virtual int32_t truncate_to(int32_t prompt, int32_t new_len) {
        if (prompt < 0 || prompt >= max_seqs) return -1;
        auto& t = tables[prompt];
        int32_t cur = 0;
        for (int32_t pid : t)
            cur += pid < 0 ? page_size : pages[pid].filled;
        if (new_len < 0 || new_len > cur) return -1;
        if (new_len == cur) return 0;
        int32_t keep = (new_len + page_size - 1) / page_size;
        if (new_len > 0 && t[keep - 1] < 0) return -1;
        int32_t freed = 0;
        while (static_cast<int32_t>(t.size()) > keep) {
            if (t.back() >= 0) {
                pages[t.back()] = PageMeta{};
                freed++;
            }
            t.pop_back();
        }
        if (new_len > 0)
            pages[t[keep - 1]].filled = new_len - (keep - 1) * page_size;
        return freed;
    }

    // returns page id or -1; *evicted set to the paged-out prompt or -1
    virtual int32_t request_block(int32_t prompt, int32_t* evicted) {
        *evicted = -1;
        if (prompt < 0 || prompt >= max_seqs) return -1;
        int32_t idx = find_free();
        if (idx == -1) {
            int32_t victim = find_lru();
            if (victim != -1) {
                *evicted = pages[victim].prompt_id;
                free_prompt(*evicted);
            }
            idx = find_free();
            if (idx == -1) return -1;
        }
        lru_epoch++;
        pages[idx] = PageMeta{prompt, 0, lru_epoch};
        tables[prompt].push_back(idx);
        return idx;
    }

    int32_t current_block(int32_t prompt) const {
        if (prompt < 0 || prompt >= max_seqs || tables[prompt].empty())
            return -1;
        return tables[prompt].back();
    }
};

// Content-addressed prefix caching (PageConfig.prefix_cache): the native
// twin of kv/manager.PrefixCachingBlockManager — full prompt pages keyed
// by their ENTIRE token prefix (exact content matching, never hash-
// probabilistic), shared across sequences via holder sets, demoted to a
// reclaimable cache when the last holder frees, reclaimed LRU before any
// whole-prompt eviction; eviction restricted to single-holder pages.
// Equivalence-tested against the Python model over randomized op traces
// (tests/test_prefix_cache.py).
struct PrefixManager : Manager {
    using Key = std::vector<int32_t>;          // token prefix through page
    std::vector<std::set<int32_t>> holders;    // page -> holding prompts
    std::vector<Key> keys;                     // page -> key ([] = none)
    std::map<Key, int32_t> cache;              // key -> page id

    PrefixManager(int32_t np, int32_t ps, int32_t ms)
        : Manager(np, ps, ms), holders(np), keys(np) {}

    int32_t find_free_px() const {
        for (int32_t i = 0; i < num_pages; i++)
            if (holders[i].empty() && keys[i].empty()) return i;
        return -1;
    }

    bool reclaim_cached() {
        // deepest chain page first (longest key), LRU among equal depths
        // — mirrors the Python model: head-first reclaim would strand
        // every descendant page while killing the chain's matchability
        int32_t victim = -1;
        int64_t best_depth = -1;
        int64_t best_lru = 0;
        for (int32_t i = 0; i < num_pages; i++) {
            if (holders[i].empty() && !keys[i].empty()) {
                int64_t d = (int64_t)keys[i].size();
                if (d > best_depth ||
                    (d == best_depth && pages[i].lru_counter < best_lru)) {
                    best_depth = d;
                    best_lru = pages[i].lru_counter;
                    victim = i;
                }
            }
        }
        if (victim == -1) return false;
        cache.erase(keys[victim]);
        keys[victim].clear();
        pages[victim] = PageMeta{};
        return true;
    }

    int32_t find_lru_px() const {   // single-holder pages only
        int32_t victim = -1;
        int64_t bound = lru_epoch;
        for (int32_t i = 0; i < num_pages; i++) {
            if (holders[i].size() == 1 && pages[i].lru_counter < bound) {
                bound = pages[i].lru_counter;
                victim = i;
            }
        }
        return victim;
    }

    int32_t num_free() const override {
        int32_t n = 0;
        for (int32_t i = 0; i < num_pages; i++)
            if (holders[i].empty()) n++;
        return n;
    }

    int32_t num_cached() const {
        int32_t n = 0;
        for (int32_t i = 0; i < num_pages; i++)
            if (holders[i].empty() && !keys[i].empty()) n++;
        return n;
    }

    void drop_holder(int32_t pid, int32_t prompt) {
        auto& hs = holders[pid];
        hs.erase(prompt);
        if (hs.empty()) {
            if (!keys[pid].empty()) {
                pages[pid].prompt_id = -1;     // demote to cache
            } else {
                pages[pid] = PageMeta{};
            }
        } else if (pages[pid].prompt_id == prompt) {
            pages[pid].prompt_id = *hs.begin();   // min (set is ordered)
        }
    }

    void free_prompt(int32_t prompt) override {
        if (prompt < 0 || prompt >= max_seqs) return;
        for (int32_t pid : tables[prompt])
            if (pid >= 0) drop_holder(pid, prompt);
        tables[prompt].clear();
    }

    int32_t release_below(int32_t, int32_t) override {
        return -1;   // incompatible with prefix caching (window serving)
    }

    int32_t truncate_to(int32_t prompt, int32_t new_len) override {
        if (prompt < 0 || prompt >= max_seqs) return -1;
        auto& t = tables[prompt];
        int32_t cur = 0;
        for (int32_t pid : t) cur += pages[pid].filled;
        if (new_len < 0 || new_len > cur) return -1;
        if (new_len == cur) return 0;
        int32_t keep = (new_len + page_size - 1) / page_size;
        int32_t new_fill = new_len - (keep - 1) * page_size;
        if (new_len > 0 && new_fill < page_size) {
            int32_t last = t[keep - 1];
            if (holders[last].size() > 1 || !keys[last].empty()) return -1;
        }
        for (int32_t j = keep; j < static_cast<int32_t>(t.size()); j++)
            if (holders[t[j]].size() > 1 || !keys[t[j]].empty()) return -1;
        int32_t freed = 0;
        while (static_cast<int32_t>(t.size()) > keep) {
            holders[t.back()].clear();
            pages[t.back()] = PageMeta{};
            freed++;
            t.pop_back();
        }
        if (new_len > 0) pages[t[keep - 1]].filled = new_fill;
        return freed;
    }

    int32_t request_block(int32_t prompt, int32_t* evicted) override {
        *evicted = -1;
        if (prompt < 0 || prompt >= max_seqs) return -1;
        int32_t idx = find_free_px();
        if (idx == -1 && reclaim_cached()) idx = find_free_px();
        if (idx == -1) {
            int32_t victim = find_lru_px();
            if (victim != -1) {
                *evicted = *holders[victim].begin();
                free_prompt(*evicted);
            }
            if (find_free_px() == -1) reclaim_cached();
            idx = find_free_px();
            if (idx == -1) return -1;
        }
        lru_epoch++;
        pages[idx] = PageMeta{prompt, 0, lru_epoch};
        holders[idx] = {prompt};
        tables[prompt].push_back(idx);
        return idx;
    }

    // longest cached page chain matching the page-aligned prefix of
    // tokens[0..n); page ids into out (≤ cap); returns the match count
    int32_t match_prefix(const int32_t* tokens, int32_t n, int32_t* out,
                         int32_t cap) const {
        Key key;
        int32_t found = 0;
        for (int32_t j = 0; (j + 1) * page_size <= n && found < cap; j++) {
            key.insert(key.end(), tokens + j * page_size,
                       tokens + (j + 1) * page_size);
            auto it = cache.find(key);
            if (it == cache.end()) break;
            out[found++] = it->second;
        }
        return found;
    }

    int32_t adopt(int32_t prompt, const int32_t* page_ids, int32_t n) {
        if (prompt < 0 || prompt >= max_seqs || !tables[prompt].empty())
            return -1;
        for (int32_t i = 0; i < n; i++) {
            int32_t pid = page_ids[i];
            if (pid < 0 || pid >= num_pages || keys[pid].empty() ||
                pages[pid].filled != page_size)
                return -1;
            holders[pid].insert(prompt);
            lru_epoch++;
            pages[pid].lru_counter = lru_epoch;
            if (pages[pid].prompt_id == -1) pages[pid].prompt_id = prompt;
            tables[prompt].push_back(pid);
        }
        return 0;
    }

    int32_t register_prompt(int32_t prompt, const int32_t* tokens,
                            int32_t n) {
        if (prompt < 0 || prompt >= max_seqs) return -1;
        const auto& t = tables[prompt];
        Key key;
        int32_t added = 0;
        for (int32_t j = 0; (j + 1) * page_size <= n; j++) {
            if (j >= static_cast<int32_t>(t.size())) break;
            key.insert(key.end(), tokens + j * page_size,
                       tokens + (j + 1) * page_size);
            int32_t pid = t[j];
            if (!keys[pid].empty()) continue;   // adopted / registered
            if (cache.count(key)) continue;     // same content elsewhere
            keys[pid] = key;
            cache[key] = pid;
            added++;
        }
        return added;
    }
};

}  // namespace

extern "C" {

void* bm_create(int32_t num_pages, int32_t page_size, int32_t max_seqs) {
    return new Manager(num_pages, page_size, max_seqs);
}

void bm_destroy(void* m) { delete static_cast<Manager*>(m); }

int32_t bm_request_block(void* m, int32_t prompt, int32_t* evicted) {
    return static_cast<Manager*>(m)->request_block(prompt, evicted);
}

void bm_free_prompt(void* m, int32_t prompt) {
    static_cast<Manager*>(m)->free_prompt(prompt);
}

int32_t bm_current_block(void* m, int32_t prompt) {
    return static_cast<Manager*>(m)->current_block(prompt);
}

// Reserve n token rows for `prompt`, spanning pages. Fills up to `cap`
// (page, offset, count) segments; evicted prompt ids (≤ cap) into
// `evicted`. Returns segment count, or -1 if the pool was exhausted or the
// requesting prompt evicted itself — the caller must then treat the
// sequence as preempted and bm_free_prompt() it.
int32_t bm_append_tokens(void* m, int32_t prompt, int32_t n,
                         int32_t* seg_pages, int32_t* seg_offsets,
                         int32_t* seg_counts, int32_t cap,
                         int32_t* evicted, int32_t* num_evicted) {
    Manager* mgr = static_cast<Manager*>(m);
    *num_evicted = 0;
    int32_t nsegs = 0;
    int32_t remaining = n;
    while (remaining > 0) {
        int32_t cur = mgr->current_block(prompt);
        if (cur == -1 || mgr->pages[cur].filled >= mgr->page_size) {
            int32_t ev = -1;
            cur = mgr->request_block(prompt, &ev);
            if (ev != -1 && *num_evicted < cap) evicted[(*num_evicted)++] = ev;
            if (cur == -1 || ev == prompt) return -1;
        } else {
            mgr->lru_epoch++;
            mgr->pages[cur].lru_counter = mgr->lru_epoch;
        }
        PageMeta& pg = mgr->pages[cur];
        int32_t take = remaining < mgr->page_size - pg.filled
                           ? remaining
                           : mgr->page_size - pg.filled;
        if (nsegs >= cap) return -1;
        seg_pages[nsegs] = cur;
        seg_offsets[nsegs] = pg.filled;
        seg_counts[nsegs] = take;
        nsegs++;
        pg.filled += take;
        remaining -= take;
    }
    return nsegs;
}

int32_t bm_block_table(void* m, int32_t prompt, int32_t* out, int32_t cap) {
    Manager* mgr = static_cast<Manager*>(m);
    if (prompt < 0 || prompt >= mgr->max_seqs) return -1;
    const auto& t = mgr->tables[prompt];
    int32_t n = static_cast<int32_t>(t.size());
    if (n > cap) return -1;
    for (int32_t i = 0; i < n; i++) out[i] = t[i];
    return n;
}

int32_t bm_seq_len(void* m, int32_t prompt) {
    Manager* mgr = static_cast<Manager*>(m);
    if (prompt < 0 || prompt >= mgr->max_seqs) return -1;
    int32_t total = 0;  // tombstoned pages still count (positions stay absolute)
    for (int32_t pid : mgr->tables[prompt])
        total += pid < 0 ? mgr->page_size : mgr->pages[pid].filled;
    return total;
}

int32_t bm_release_below(void* m, int32_t prompt, int32_t start_pos) {
    return static_cast<Manager*>(m)->release_below(prompt, start_pos);
}

int32_t bm_truncate_to(void* m, int32_t prompt, int32_t new_len) {
    return static_cast<Manager*>(m)->truncate_to(prompt, new_len);
}

int32_t bm_num_free(void* m) {
    return static_cast<Manager*>(m)->num_free();
}

int64_t bm_lru_epoch(void* m) { return static_cast<Manager*>(m)->lru_epoch; }

int32_t bm_page_meta(void* m, int32_t page, int32_t* prompt_id,
                     int32_t* filled, int64_t* lru) {
    Manager* mgr = static_cast<Manager*>(m);
    if (page < 0 || page >= mgr->num_pages) return -1;
    *prompt_id = mgr->pages[page].prompt_id;
    *filled = mgr->pages[page].filled;
    *lru = mgr->pages[page].lru_counter;
    return 0;
}

// ---- prefix-caching manager (all bm_* entry points work on it too, via
// virtual dispatch; these add the sharing surface) ------------------------

void* pm_create(int32_t num_pages, int32_t page_size, int32_t max_seqs) {
    return static_cast<Manager*>(
        new PrefixManager(num_pages, page_size, max_seqs));
}

int32_t pm_match_prefix(void* m, const int32_t* tokens, int32_t n,
                        int32_t* out, int32_t cap) {
    return static_cast<PrefixManager*>(static_cast<Manager*>(m))
        ->match_prefix(tokens, n, out, cap);
}

int32_t pm_adopt(void* m, int32_t prompt, const int32_t* page_ids,
                 int32_t n) {
    return static_cast<PrefixManager*>(static_cast<Manager*>(m))
        ->adopt(prompt, page_ids, n);
}

int32_t pm_register_prompt(void* m, int32_t prompt, const int32_t* tokens,
                           int32_t n) {
    return static_cast<PrefixManager*>(static_cast<Manager*>(m))
        ->register_prompt(prompt, tokens, n);
}

int32_t pm_num_cached(void* m) {
    return static_cast<PrefixManager*>(static_cast<Manager*>(m))
        ->num_cached();
}

// holder prompts of `page` in ascending order (≤ cap); -1 on bad page
int32_t pm_holders(void* m, int32_t page, int32_t* out, int32_t cap) {
    PrefixManager* mgr =
        static_cast<PrefixManager*>(static_cast<Manager*>(m));
    if (page < 0 || page >= mgr->num_pages) return -1;
    int32_t n = 0;
    for (int32_t p : mgr->holders[page]) {
        if (n >= cap) return -1;
        out[n++] = p;
    }
    return n;
}

}  // extern "C"
