"""ctypes binding of the native (C++) block managers, port of
llmc_paged_tpu/kv/native.py.

csrc/block_manager.cpp holds the C++ twins of kv/manager.py's
BlockManager and PrefixCachingBlockManager: metadata only, the page data
stays in the card's pool. The library builds with the host compiler at
first use, into build/torch_kernels/ (ops/_build.py), never at import.

``make_block_manager`` returns the native manager when the library
builds and loads, else the Python one; both have the same API and the
same state after every operation (tests/test_torch_native.py).

Unlike the JAX binding, arguments and results pass through numpy int32
buffers that each manager keeps and reuses across calls (grown when a
call needs more room), by their addresses: no per-element copy into a
ctypes array, and no allocation on the engine's per-step calls
(append_tokens, block_table_array).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from llmc_paged_tpu_torch.kv.manager import (
    BlockManager,
    PrefixCachingBlockManager,
    Segment,
    _fill_tombstones,
    format_state,
)
from llmc_paged_tpu_torch.ops import _build

_I32, _I64, _P = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
# name: (result, argument types); every pointer is passed as an address
_PROTOTYPES = {
    "bm_create": (_P, [_I32, _I32, _I32]),
    "bm_destroy": (None, [_P]),
    "bm_request_block": (_I32, [_P, _I32, _P]),
    "bm_free_prompt": (None, [_P, _I32]),
    "bm_current_block": (_I32, [_P, _I32]),
    "bm_append_tokens": (_I32, [_P, _I32, _I32, _P, _P, _P, _I32, _P, _P]),
    "bm_block_table": (_I32, [_P, _I32, _P, _I32]),
    "bm_seq_len": (_I32, [_P, _I32]),
    "bm_release_below": (_I32, [_P, _I32, _I32]),
    "bm_truncate_to": (_I32, [_P, _I32, _I32]),
    "bm_num_free": (_I32, [_P]),
    "bm_lru_epoch": (_I64, [_P]),
    "bm_page_meta": (_I32, [_P, _I32, _P, _P, _P]),
    "pm_create": (_P, [_I32, _I32, _I32]),
    "pm_match_prefix": (_I32, [_P, _P, _I32, _P, _I32]),
    "pm_adopt": (_I32, [_P, _I32, _P, _I32]),
    "pm_register_prompt": (_I32, [_P, _I32, _P, _I32]),
    "pm_num_cached": (_I32, [_P]),
    "pm_holders": (_I32, [_P, _I32, _P, _I32]),
}


def load_library() -> ctypes.CDLL:
    """The native manager's library with its prototypes declared, built
    on first use. Raises ImportError when it cannot be built or loaded
    (no compiler, a failed compile, a library that does not load)."""
    try:
        lib = _build.load("block_manager", host=True)
    except (OSError, RuntimeError) as e:
        raise ImportError(f"native block manager unavailable: {e}") from e
    if lib.bm_create.restype is not _P:
        for name, (res, args) in _PROTOTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib


def _addr(a: np.ndarray) -> int:
    return a.ctypes.data


class _Buffer:
    """A reused int32 numpy buffer and its address (``ndarray.ctypes``
    costs microseconds a call, so the address is taken once)."""

    def __init__(self, *shape):
        self.a = np.zeros(shape, np.int32)
        self.p = _addr(self.a)


def _int32(vals) -> np.ndarray:
    return np.ascontiguousarray(vals, dtype=np.int32)


class NativeBlockManager:
    """Same API as kv.manager.BlockManager, backed by the C++ Manager."""

    _create = "bm_create"

    def __init__(self, num_pages: int = 100, page_size: int = 32,
                 max_seqs: int = 100):
        self._lib = load_library()
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_seqs = max_seqs
        self._h = getattr(self._lib, self._create)(num_pages, page_size,
                                                    max_seqs)
        # reused buffers: segments (pages, offsets, counts), evicted ids,
        # small outputs (evicted count, one page's prompt and fill), a
        # block table, one page's LRU counter
        self._grow_segments(4)
        self._small = _Buffer(3)
        self._table = _Buffer(max(1, num_pages))
        self._lru = np.zeros(1, np.int64)

    def _grow_segments(self, cap: int) -> None:
        self._segs = _Buffer(3, cap)
        self._seg_p = [_addr(r) for r in self._segs.a]
        self._evicted = _Buffer(cap)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bm_destroy(self._h)
            self._h = None

    # -- queries ------------------------------------------------------------

    @property
    def lru_epoch(self) -> int:
        return int(self._lib.bm_lru_epoch(self._h))

    def page_meta(self, page: int) -> Tuple[int, int, int]:
        """(prompt_id, filled, lru_counter) of one page."""
        small = self._small
        rc = self._lib.bm_page_meta(self._h, page, small.p, small.p + 4,
                                    _addr(self._lru))
        if rc != 0:
            raise IndexError(f"page {page} outside [0, {self.num_pages})")
        return int(small.a[0]), int(small.a[1]), int(self._lru[0])

    def _table_view(self, prompt_id: int) -> np.ndarray:
        """The prompt's table as a view of the reused buffer. A
        window-reclaimed table can hold more entries than num_pages
        (tombstones keep absolute indices), so the buffer doubles while
        the call reports overflow (-1 for a valid prompt id)."""
        self._check_prompt(prompt_id)
        while True:
            buf = self._table
            n = self._lib.bm_block_table(self._h, prompt_id, buf.p,
                                         buf.a.size)
            if n >= 0:
                return buf.a[:n]
            self._table = _Buffer(2 * buf.a.size)

    def block_table(self, prompt_id: int) -> List[int]:
        """Ordered page list for a prompt; -1 marks a reclaimed page."""
        return self._table_view(prompt_id).tolist()

    def block_table_array(self, prompt_id: int, pages_per_seq: int,
                          fill: int = 0) -> np.ndarray:
        """Fixed-width int32 row for the kernel (see
        BlockManager.block_table_array)."""
        table = self._table_view(prompt_id)
        if table.size > pages_per_seq:
            raise ValueError(f"sequence {prompt_id} holds {table.size} "
                             f"pages > pages_per_seq {pages_per_seq}")
        row = np.full(pages_per_seq, fill, dtype=np.int32)
        # tombstones only ever form a prefix of a table (release_below
        # frees pages [0, start // page_size), truncate_to refuses to land
        # in one), so the first entry tells; a numpy reduction here would
        # cost more than the rest of the call
        if table.size and table[0] < 0:
            row[: table.size] = _fill_tombstones(table.tolist(), fill)
        else:
            row[: table.size] = table
        return row

    def get_current_block(self, prompt_id: int) -> Optional[int]:
        cur = self._lib.bm_current_block(self._h, prompt_id)
        return None if cur == -1 else cur

    def seq_len(self, prompt_id: int) -> int:
        return self._lib.bm_seq_len(self._h, prompt_id)

    def num_free(self) -> int:
        return self._lib.bm_num_free(self._h)

    def state_dump(self, prompt_id: int) -> str:
        """print_state parity (block_manager.c:25-36) for debugging."""
        return format_state(self, prompt_id)

    # -- mutation -----------------------------------------------------------

    def _check_prompt(self, prompt_id: int) -> None:
        if not (0 <= prompt_id < self.max_seqs):
            raise ValueError(f"invalid prompt id {prompt_id}")

    def free_prompt(self, prompt_id: int) -> None:
        self._lib.bm_free_prompt(self._h, prompt_id)

    def release_below(self, prompt_id: int, start_pos: int) -> int:
        if start_pos >= self.seq_len(prompt_id):
            # same contract as the Python manager: releasing at/beyond
            # seq_len would tombstone the live tail page
            raise ValueError(
                f"release_below({start_pos}) >= seq_len"
                f" {self.seq_len(prompt_id)} would tombstone the live "
                "tail page")
        n = self._lib.bm_release_below(self._h, prompt_id, start_pos)
        if n < 0:
            raise ValueError(f"invalid prompt id {prompt_id}")
        return n

    def truncate_to(self, prompt_id: int, new_len: int) -> int:
        n = self._lib.bm_truncate_to(self._h, prompt_id, new_len)
        if n < 0:
            raise ValueError(
                f"truncate_to({new_len}): invalid prompt/length or "
                "reclaimed target page")
        return n

    def request_block(self, prompt_id: int
                      ) -> Tuple[Optional[int], List[int]]:
        self._check_prompt(prompt_id)
        idx = self._lib.bm_request_block(self._h, prompt_id, self._small.p)
        ev = int(self._small.a[0])
        return (None if idx == -1 else idx), ([ev] if ev != -1 else [])

    def append_tokens(self, prompt_id: int, n: int
                      ) -> Tuple[List[Segment], List[int]]:
        """See BlockManager.append_tokens: ([], evicted) means the
        sequence was preempted."""
        self._check_prompt(prompt_id)
        if n <= 0:
            raise ValueError(f"append_tokens needs n >= 1, got {n} "
                             "(an empty append would read as preemption)")
        cap = n // self.page_size + 2
        if cap > self._evicted.a.size:
            self._grow_segments(cap)
        p, o, c = self._seg_p
        nsegs = self._lib.bm_append_tokens(
            self._h, prompt_id, n, p, o, c, cap, self._evicted.p,
            self._small.p)
        nev = int(self._small.a[0])
        evicted = self._evicted.a[:nev].tolist() if nev else []
        if nsegs < 0:
            return [], evicted
        if nsegs == 1:
            return [Segment(*self._segs.a[:, 0].tolist())], evicted
        return [Segment(*seg) for seg in
                self._segs.a[:, :nsegs].T.tolist()], evicted


class NativePrefixCachingBlockManager(NativeBlockManager):
    """Same API as kv.manager.PrefixCachingBlockManager, backed by the
    C++ PrefixManager. The inherited bm_* calls dispatch virtually onto
    the prefix state machine."""

    _create = "pm_create"

    def match_prefix(self, tokens) -> List[int]:
        toks = _int32(tokens)
        out = np.zeros(max(1, toks.size // self.page_size), np.int32)
        n = self._lib.pm_match_prefix(self._h, _addr(toks), toks.size,
                                      _addr(out), out.size)
        return out[:n].tolist()

    def adopt(self, prompt_id: int, page_ids: List[int]) -> None:
        ids = _int32(page_ids)
        if self._lib.pm_adopt(self._h, prompt_id, _addr(ids), ids.size):
            raise ValueError(
                f"adopt({prompt_id}, {list(page_ids)}): invalid prompt, "
                "non-empty table, or non-cached page")

    def register_prompt(self, prompt_id: int, tokens) -> int:
        toks = _int32(tokens)
        n = self._lib.pm_register_prompt(self._h, prompt_id, _addr(toks),
                                         toks.size)
        if n < 0:
            raise ValueError(f"invalid prompt id {prompt_id}")
        return n

    def num_cached(self) -> int:
        return self._lib.pm_num_cached(self._h)

    def holders(self, page: int) -> List[int]:
        out = np.zeros(self.max_seqs, np.int32)
        n = self._lib.pm_holders(self._h, page, _addr(out), out.size)
        if n < 0:
            raise IndexError(f"page {page} outside [0, {self.num_pages})")
        return out[:n].tolist()

    def release_below(self, prompt_id: int, start_pos: int) -> int:
        raise RuntimeError("prefix caching is incompatible with "
                           "sliding-window page reclamation (the engine "
                           "forbids combining them)")

    def truncate_to(self, prompt_id: int, new_len: int) -> int:
        n = self._lib.bm_truncate_to(self._h, prompt_id, new_len)
        if n < 0:
            raise ValueError(
                f"truncate_to({new_len}): invalid prompt/length or "
                "shared/cached target page")
        return n


def make_block_manager(num_pages: int = 100, page_size: int = 32,
                       max_seqs: int = 100, native: Optional[bool] = None,
                       prefix: bool = False):
    """The native C++ manager when its library builds and loads, else the
    Python one. ``native=False`` forces the Python manager; ``native=True``
    raises ImportError instead of falling back. ``prefix=True`` selects
    the prefix-caching state machine (PageConfig.prefix_cache)."""
    py_cls = PrefixCachingBlockManager if prefix else BlockManager
    nat_cls = NativePrefixCachingBlockManager if prefix \
        else NativeBlockManager
    if native is False:
        return py_cls(num_pages, page_size, max_seqs)
    try:
        return nat_cls(num_pages, page_size, max_seqs)
    except ImportError:
        if native:
            raise
        return py_cls(num_pages, page_size, max_seqs)
