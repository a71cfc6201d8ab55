"""L3 host side: the KV block managers (copies of the Python
``BlockManager`` and ``PrefixCachingBlockManager`` of
llmc_paged_tpu/kv/manager.py). Their native C++ twins
(csrc/block_manager.cpp, bound in kv/native.py) keep the same state
machine; ``kv.native.make_block_manager`` picks one of the two.

Page *data* lives in the device pool (kv/layouts.py); this manager hands
out page indices and keeps the metadata state machine:
  * allocation: first free page, scanning ascending by index
  * on pool exhaustion: evict the LRU page's ENTIRE prompt, then rescan;
    the requesting prompt itself can be the victim — the engine avoids
    that
  * LRU: lru_counter = ++lru_epoch on allocation and on each append to
    the current page; victim = least counter among allocated pages,
    scanned ascending with strict '<' against a bound of lru_epoch
  * free_prompt resets the prompt's pages and clears its table
  * append_tokens spans page boundaries, returning (page, slot, count)
    segments for the device writes
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PageMeta:
    """Per-page metadata (KVBlock minus the float buffers,
    block_manager.c:9-15)."""
    prompt_id: int = -1
    filled: int = 0
    lru_counter: int = 0

    @property
    def allocated(self) -> bool:
        return self.prompt_id != -1


def _fill_tombstones(table: List[int], fill: int) -> List[int]:
    """Replace -1 tombstones with the next live page id to their right
    (see BlockManager.block_table_array)."""
    if not any(p < 0 for p in table):
        return table
    out, nxt = [], fill
    for p in reversed(table):
        if p >= 0:
            nxt = p
        out.append(nxt)
    out.reverse()
    return out


def format_state(mgr, prompt_id: int) -> str:
    """The state_dump text of ``mgr`` (any manager with lru_epoch,
    block_table and page_meta): the epoch, then one line a page of the
    prompt's table."""
    table = mgr.block_table(prompt_id)
    lines = [f"Block manager llru {mgr.lru_epoch}",
             f"Prompt {prompt_id} block count: {len(table)}"]
    for pid in table:
        if pid < 0:
            lines.append("Block -1: reclaimed (slid out of window)")
            continue
        _, filled, lru = mgr.page_meta(pid)
        lines.append(f"Block {pid}: filled {filled}, llru {lru}")
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class Segment:
    """One contiguous device write: `count` new token rows into `page`
    starting at slot `offset`."""
    page: int
    offset: int
    count: int


class BlockManager:
    def __init__(self, num_pages: int = 100, page_size: int = 32,
                 max_seqs: int = 100):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.pages: List[PageMeta] = [PageMeta() for _ in range(num_pages)]
        self.tables: Dict[int, List[int]] = {}
        self.lru_epoch = 0

    # -- queries ------------------------------------------------------------

    def block_table(self, prompt_id: int) -> List[int]:
        """Ordered page list for a prompt (collect_kv_blocks role); -1
        marks a page reclaimed by release_below."""
        return list(self.tables.get(prompt_id, []))

    def block_table_array(self, prompt_id: int, pages_per_seq: int,
                          fill: int = 0) -> np.ndarray:
        """Fixed-width int32 row for the kernel; unused entries point at
        page `fill` (never read thanks to length masking). Tombstoned
        entries (pages reclaimed by release_below) are forward-filled with
        the NEXT live page id, as in the JAX package; the kernel never
        reads them (its page walk starts at start // page_size)."""
        table = self.tables.get(prompt_id, [])
        if len(table) > pages_per_seq:
            raise ValueError(f"sequence {prompt_id} holds {len(table)} "
                             f"pages > pages_per_seq {pages_per_seq}")
        row = np.full(pages_per_seq, fill, dtype=np.int32)
        row[: len(table)] = _fill_tombstones(table, fill)
        return row

    def get_current_block(self, prompt_id: int) -> Optional[int]:
        table = self.tables.get(prompt_id)
        return table[-1] if table else None

    def seq_len(self, prompt_id: int) -> int:
        """Logical sequence length INCLUDING reclaimed (tombstoned) pages —
        positions stay absolute so the position→table-index map holds."""
        return sum(self.page_size if p < 0 else self.pages[p].filled
                   for p in self.tables.get(prompt_id, []))

    def num_free(self) -> int:
        return sum(1 for p in self.pages if not p.allocated)

    def page_meta(self, page: int) -> Tuple[int, int, int]:
        """(prompt_id, filled, lru_counter) of one page."""
        pg = self.pages[page]
        return pg.prompt_id, pg.filled, pg.lru_counter

    def state_dump(self, prompt_id: int) -> str:
        """print_state parity (block_manager.c:25-36) for debugging."""
        return format_state(self, prompt_id)

    # -- mutation -----------------------------------------------------------

    def _find_lru(self) -> int:
        victim, bound = -1, self.lru_epoch
        for i, pg in enumerate(self.pages):
            if pg.allocated and pg.lru_counter < bound:
                bound = pg.lru_counter
                victim = i
        return victim

    def _page_out_lru(self) -> List[int]:
        victim = self._find_lru()
        if victim == -1:
            return []
        prompt = self.pages[victim].prompt_id
        self.free_prompt(prompt)
        return [prompt]

    def free_prompt(self, prompt_id: int) -> None:
        for pid in self.tables.get(prompt_id, []):
            if pid >= 0:
                self.pages[pid] = PageMeta()
        self.tables[prompt_id] = []

    def release_below(self, prompt_id: int, start_pos: int) -> int:
        """Sliding-window page reclamation — beyond the reference, whose
        window mode only MASKS slid-out tokens (attention_paged `offset`,
        paged_infer.c:165,190) while their pages stay allocated forever.
        Frees every page of `prompt_id` whose token positions all lie
        below `start_pos`; the table entry becomes a -1 tombstone so later
        positions keep their absolute table index (the kernel never reads
        a wholly-below-window page: its (i+1)*ps > start guard masks it).
        Returns the number of pages freed. start_pos must lie inside the
        live sequence: releasing AT or beyond seq_len would tombstone the
        LAST page too, after which get_current_block returns -1 and an
        append would dereference pages[-1] — another sequence's metadata
        — and scatter into its device page (silent corruption). The
        engine always passes start < seq_len; this guard makes the
        contract explicit instead of implicit."""
        if start_pos >= self.seq_len(prompt_id):
            raise ValueError(
                f"release_below({start_pos}) >= seq_len"
                f" {self.seq_len(prompt_id)} would tombstone the live "
                "tail page")
        table = self.tables.get(prompt_id, [])
        freed = 0
        for j in range(min(start_pos // self.page_size, len(table))):
            if table[j] >= 0:
                self.pages[table[j]] = PageMeta()
                table[j] = -1
                freed += 1
        return freed

    def truncate_to(self, prompt_id: int, new_len: int) -> int:
        """Roll the write pointer back to `new_len` tokens, freeing trailing
        pages that become empty — beyond the reference (which only ever
        grows sequences). Speculative decode reserves pages for the maximum
        possible acceptance ahead of the verify step and rolls back to the
        actual accepted length here; the rolled-back slots may hold stale
        K/V in the device pool, which is never read (attention masks by
        length) and is overwritten by the next append to the same
        coordinates. Returns the number of pages freed. Positions must be
        absolute: truncating into a tombstoned (window-reclaimed) page is
        rejected."""
        table = self.tables.get(prompt_id, [])
        cur = self.seq_len(prompt_id)
        if not (0 <= new_len <= cur):
            raise ValueError(f"truncate_to({new_len}) outside [0, {cur}]")
        if new_len == cur:
            return 0
        keep = -(-new_len // self.page_size)    # pages still (partly) used
        freed = 0
        for j in range(len(table) - 1, keep - 1, -1):
            if table[j] >= 0:
                self.pages[table[j]] = PageMeta()
                freed += 1
            table.pop()
        if new_len > 0:
            last = table[keep - 1]
            if last < 0:
                raise ValueError("truncate_to lands in a reclaimed page")
            self.pages[last].filled = (new_len
                                       - (keep - 1) * self.page_size)
        return freed

    def request_block(self, prompt_id: int) -> Tuple[Optional[int], List[int]]:
        """Allocate one page to `prompt_id`. Returns (page index or None,
        list of prompts evicted to make room)."""
        if not (0 <= prompt_id < self.max_seqs):
            raise ValueError(f"invalid prompt id {prompt_id}")
        evicted: List[int] = []
        idx = next((i for i, p in enumerate(self.pages) if not p.allocated), -1)
        if idx == -1:
            evicted = self._page_out_lru()
            idx = next((i for i, p in enumerate(self.pages) if not p.allocated), -1)
            if idx == -1:
                return None, evicted
        self.lru_epoch += 1
        self.pages[idx] = PageMeta(prompt_id=prompt_id, filled=0,
                                   lru_counter=self.lru_epoch)
        self.tables.setdefault(prompt_id, []).append(idx)
        return idx, evicted

    def append_tokens(self, prompt_id: int, n: int
                      ) -> Tuple[List[Segment], List[int]]:
        """Reserve space for `n` new token rows, allocating pages as needed
        and spanning page boundaries (the reference's missing case,
        paged_infer.c:542-545). Returns (segments to scatter, evicted
        prompts). If the pool is exhausted mid-append or the requesting
        prompt evicts itself, returns ([], evicted) — the caller must treat
        the sequence as preempted and free_prompt() it (the engine's
        preemption path does exactly that). n must be positive: a zero
        append would be indistinguishable from that preemption signal."""
        if n <= 0:
            raise ValueError(f"append_tokens needs n >= 1, got {n} "
                             "(an empty append would read as preemption)")
        segments: List[Segment] = []
        evicted: List[int] = []
        remaining = n
        while remaining > 0:
            cur = self.get_current_block(prompt_id)
            if cur is not None and cur < 0:
                # all pages tombstoned (release_below misuse slipped
                # through): pages[-1] would be another sequence's page
                raise RuntimeError(
                    f"append into prompt {prompt_id} whose table is all "
                    "tombstones — release_below contract violated")
            if cur is None or self.pages[cur].filled >= self.page_size:
                cur, ev = self.request_block(prompt_id)
                evicted.extend(ev)
                if cur is None or prompt_id in ev:
                    # pool exhausted, or we evicted ourselves: caller must
                    # treat this sequence as preempted
                    return [], evicted
            else:
                # LRU touch on append (paged_infer.c:524)
                self.lru_epoch += 1
                self.pages[cur].lru_counter = self.lru_epoch
            pg = self.pages[cur]
            take = min(remaining, self.page_size - pg.filled)
            segments.append(Segment(page=cur, offset=pg.filled, count=take))
            pg.filled += take
            remaining -= take
        return segments, evicted


class PrefixCachingBlockManager(BlockManager):
    """Opt-in extension (PageConfig.prefix_cache) BEYOND the reference:
    content-addressed sharing of FULL prompt pages across sequences.

    A shared page is pure host metadata — two block tables holding the
    same page index — so a repeated prompt prefix (system prompt,
    few-shot header) costs no device work to reuse: no KV copies; only
    the unshared suffix is prefilled (models/gpt2_paged.py
    prefill_suffix_paged attends the cached prefix through the same
    block table, with the multi-query parts kernel).

    State model (page-granular, vLLM-style automatic prefix caching):
      * every page tracks its holder set (sequences whose table contains
        it); `filled`/`lru_counter` keep their base-class meaning
      * a FULL page whose token content is known gets a chain key = the
        ENTIRE token prefix through that page (a tuple) — prefix-dependent
        by construction, so only true PREFIX matches ever share; dict
        lookup compares content on hash collision, so matching is EXACT
        (never probabilistic — host memory for the keys is trivial next
        to the device pool)
      * free_prompt drops one holder; a hashed page with no holders left
        DEMOTES to the cache (contents intact, reclaimable) instead of
        freeing
      * allocation order: truly-free page → reclaim the LRU cached page →
        the reference's LRU whole-prompt eviction, restricted to
        single-holder pages (a shared page is in use by ≥2 live
        sequences; evicting one holder could not free it anyway)
      * release_below (sliding window) is rejected: the engine layer
        forbids combining prefix caching with window serving

    The base state machine is untouched — this class is only used when
    PageConfig.prefix_cache is set. State for state, it equals the JAX
    package's class (tests/test_torch_prefix.py runs both side by
    side)."""

    def __init__(self, num_pages: int = 100, page_size: int = 32,
                 max_seqs: int = 100):
        super().__init__(num_pages, page_size, max_seqs)
        self.holders: List[set] = [set() for _ in range(num_pages)]
        self.hashes: List[Optional[tuple]] = [None] * num_pages
        self.cache: Dict[tuple, int] = {}      # prefix-content key -> page

    # -- content keys ---------------------------------------------------

    def _chain_keys(self, tokens) -> List[tuple]:
        """Content key per FULL page of `tokens`: the whole token prefix
        through that page, as a tuple (page j -> tokens[:(j+1)*ps])."""
        ps = self.page_size
        return [tuple(tokens[:(j + 1) * ps])
                for j in range(len(tokens) // ps)]

    # -- queries --------------------------------------------------------

    def num_free(self) -> int:
        """Pages allocatable on demand: truly free + cached (a cached page
        is reclaimed transparently by request_block)."""
        return sum(1 for i in range(self.num_pages) if not self.holders[i])

    def num_cached(self) -> int:
        return sum(1 for i in range(self.num_pages)
                   if not self.holders[i] and self.hashes[i] is not None)

    def match_prefix(self, tokens) -> List[int]:
        """Longest chain of cached/live pages whose content equals the
        page-aligned prefix of `tokens`. Returns their page ids in order
        (possibly empty). Pure lookup — adopt() takes the refs."""
        out = []
        for h in self._chain_keys(tokens):
            pid = self.cache.get(h)
            if pid is None:
                break
            out.append(pid)
        return out

    # -- sharing --------------------------------------------------------

    def adopt(self, prompt_id: int, page_ids: List[int]) -> None:
        """Map already-resident pages (from match_prefix) into
        `prompt_id`'s table as its prefix. The sequence must be fresh."""
        if not (0 <= prompt_id < self.max_seqs):
            raise ValueError(f"invalid prompt id {prompt_id}")
        if self.tables.get(prompt_id):
            raise ValueError(f"adopt() on non-empty prompt {prompt_id}")
        for pid in page_ids:
            if self.hashes[pid] is None or \
                    self.pages[pid].filled != self.page_size:
                # data-integrity guard, not a debug assert (must hold
                # under python -O): adopting a reclaimed/partial page
                # would shift position accounting and attend garbage KV
                raise ValueError(f"adopt: page {pid} is not a published "
                                 "full prefix page")
            self.holders[pid].add(prompt_id)
            self.lru_epoch += 1
            self.pages[pid].lru_counter = self.lru_epoch
            if self.pages[pid].prompt_id == -1:
                self.pages[pid].prompt_id = prompt_id
            self.tables.setdefault(prompt_id, []).append(pid)

    def register_prompt(self, prompt_id: int, tokens) -> int:
        """Hash `prompt_id`'s pages that are FULLY covered by `tokens`
        (its prompt) and publish them for future match_prefix. Pages whose
        content already exists in the cache under another id are left
        unhashed (first page wins; duplicates free normally). Returns the
        number of pages newly published."""
        table = self.tables.get(prompt_id, [])
        added = 0
        for j, h in enumerate(self._chain_keys(tokens)):
            if j >= len(table):
                break
            pid = table[j]
            if self.hashes[pid] is not None:
                # adopted (same chain ⇒ same hash) or already registered
                continue
            if h in self.cache:
                continue
            self.hashes[pid] = h
            self.cache[h] = pid
            added += 1
        return added

    # -- mutation overrides ----------------------------------------------

    def _find_free(self) -> int:
        return next((i for i in range(self.num_pages)
                     if not self.holders[i] and self.hashes[i] is None), -1)

    def _reclaim_cached(self) -> bool:
        """Drop one cached (holderless, hashed) page back to FREE —
        DEEPEST chain page first (longest content key), LRU among equal
        depths. Head-first (plain LRU) reclaim would be pathological:
        page 0 of a chain always has the lowest counter (adoption touches
        ascending), yet dropping it makes every descendant unreachable by
        match_prefix while still occupying the pool — maximum lost hits,
        minimum freed value. Tail-first keeps the chain's head prefix
        matchable."""
        victim, best = -1, None
        for i in range(self.num_pages):
            if not self.holders[i] and self.hashes[i] is not None:
                rank = (-len(self.hashes[i]), self.pages[i].lru_counter)
                if best is None or rank < best:
                    best = rank
                    victim = i
        if victim == -1:
            return False
        del self.cache[self.hashes[victim]]
        self.hashes[victim] = None
        self.pages[victim] = PageMeta()
        return True

    def _find_lru(self) -> int:
        """LRU victim among SINGLE-holder pages only (shared pages are in
        use by several live sequences; cached pages are reclaimed by
        _reclaim_cached before eviction is ever attempted)."""
        victim, bound = -1, self.lru_epoch
        for i, pg in enumerate(self.pages):
            if len(self.holders[i]) == 1 and pg.lru_counter < bound:
                bound = pg.lru_counter
                victim = i
        return victim

    def _page_out_lru(self) -> List[int]:
        victim = self._find_lru()
        if victim == -1:
            return []
        prompt = min(self.holders[victim])   # single holder by _find_lru
        self.free_prompt(prompt)
        return [prompt]

    def request_block(self, prompt_id: int) -> Tuple[Optional[int], List[int]]:
        if not (0 <= prompt_id < self.max_seqs):
            raise ValueError(f"invalid prompt id {prompt_id}")
        evicted: List[int] = []
        idx = self._find_free()
        if idx == -1 and self._reclaim_cached():
            idx = self._find_free()
        if idx == -1:
            evicted = self._page_out_lru()
            if self._find_free() == -1:
                self._reclaim_cached()   # eviction may demote hashed pages
            idx = self._find_free()
            if idx == -1:
                return None, evicted
        self.lru_epoch += 1
        self.pages[idx] = PageMeta(prompt_id=prompt_id, filled=0,
                                   lru_counter=self.lru_epoch)
        self.holders[idx] = {prompt_id}
        self.tables.setdefault(prompt_id, []).append(idx)
        return idx, evicted

    def _drop_holder(self, pid: int, prompt_id: int) -> None:
        hs = self.holders[pid]
        hs.discard(prompt_id)
        if not hs:
            if self.hashes[pid] is not None:
                # demote to cache: contents stay resident and reusable
                self.pages[pid].prompt_id = -1
            else:
                self.pages[pid] = PageMeta()
        elif self.pages[pid].prompt_id == prompt_id:
            # deterministic choice (min): the JAX package's managers
            # report the same page metas
            self.pages[pid].prompt_id = min(hs)

    def free_prompt(self, prompt_id: int) -> None:
        for pid in self.tables.get(prompt_id, []):
            if pid >= 0:
                self._drop_holder(pid, prompt_id)
        self.tables[prompt_id] = []

    def release_below(self, prompt_id: int, start_pos: int) -> int:
        raise RuntimeError("prefix caching is incompatible with "
                           "sliding-window page reclamation (the engine "
                           "forbids combining them)")

    def truncate_to(self, prompt_id: int, new_len: int) -> int:
        """Same contract as the base class; trailing pages must be
        exclusively held (speculative reservations always are — they are
        appended past the prompt by this sequence alone)."""
        table = self.tables.get(prompt_id, [])
        cur = self.seq_len(prompt_id)
        if not (0 <= new_len <= cur):
            raise ValueError(f"truncate_to({new_len}) outside [0, {cur}]")
        if new_len == cur:
            return 0
        keep = -(-new_len // self.page_size)
        for j in range(keep, len(table)):
            if len(self.holders[table[j]]) > 1 or \
                    self.hashes[table[j]] is not None:
                raise ValueError(
                    f"truncate_to would free shared/cached page {table[j]}")
        new_fill = new_len - (keep - 1) * self.page_size
        if new_len > 0 and new_fill < self.page_size:
            last = table[keep - 1]
            if len(self.holders[last]) > 1 or self.hashes[last] is not None:
                raise ValueError(
                    f"truncate_to would shorten shared/cached page {last}")
        freed = 0
        for j in range(len(table) - 1, keep - 1, -1):
            self.holders[table[j]] = set()
            self.pages[table[j]] = PageMeta()
            freed += 1
            table.pop()
        if new_len > 0:
            self.pages[table[keep - 1]].filled = new_fill
        return freed
