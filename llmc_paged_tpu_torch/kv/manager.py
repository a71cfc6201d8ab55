"""L3 host side: the KV block manager (a copy of the Python
``BlockManager`` of llmc_paged_tpu/kv/manager.py; the prefix-caching
manager and the native C++ twin are not in this slice of the port).

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
