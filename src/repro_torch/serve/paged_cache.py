"""Paged KV-cache state for serving: page pool + page table + free stack.

Port of ``repro``'s ``serve/paged_cache.py`` (float pools).  The device
state lives in the cache dict built by ``models/decode.init_paged_cache``;
this class adds the host bookkeeping a scheduler needs — capacity checks,
page accounting, release and prefill insert, and prefix sharing: a slot
ADOPTS another request's pages (``adopt_prefix``), a partial tail page is
FORKED copy-on-write (``fork_page``), and the radix trie
(``serve/prefix_cache.py``) holds an external +1 pin per published page
(``addref`` / ``deref_pages``).  ``check_invariants`` audits refcount
conservation through the ``external_ref`` hook the scheduler sets.
``kv_quant`` ("int8" / "fp8") selects the quantized pool; ``page_bytes``
counts its scale side tensor.  Recurrent positions (Mamba, xLSTM) hold
per-slot state beside the pools: ``used_cache_bytes`` counts it whole, as
the reference's ``_is_page_leaf`` accounting does.  Mutations update the
state in place where the reference donated it to a jit'd entry point.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._common import pytree_nbytes
from repro_torch.models import decode as dec
from repro_torch.models.transformer import ModelConfig


class InvariantViolation(AssertionError):
    """A structural page-pool invariant broke on a live engine."""


class PagedCache:
    """Page pool + page-table state for a fixed-slot serving loop.
    ``debug_invariants=True`` audits the pool after every mutation."""

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int,
                 page_size: int, *, cache_dtype=torch.float32,
                 num_pages: int | None = None,
                 kv_quant: str | None = None, device=None,
                 debug_invariants: bool = False):
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.page_size = page_size
        self.kv_quant = kv_quant
        self.pages_per_seq = dec.pages_per_seq(max_len, page_size)
        self.num_pages = (slots * self.pages_per_seq
                          if num_pages is None else num_pages)
        self.state = dec.init_paged_cache(cfg, slots, max_len, page_size,
                                          cache_dtype,
                                          num_pages=self.num_pages,
                                          quantize=kv_quant, device=device)
        # external refcount provider (the scheduler sets it to the prefix
        # trie's page_refs): pins outside any slot's table that the
        # conservation audit must count
        self.external_ref = None
        self.forks = 0
        self.debug_invariants = debug_invariants
        self.invariant_checks = 0

    # -- invariants ---------------------------------------------------------
    def check_invariants(self) -> None:
        self.invariant_checks += 1
        ext = self.external_ref() if self.external_ref is not None else None
        bad = dec.paged_invariants(self.cfg, self.state, external_ref=ext)
        if bad:
            raise InvariantViolation(
                "paged pool invariants violated:\n  " + "\n  ".join(bad))

    def _maybe_check(self) -> None:
        if self.debug_invariants:
            self.check_invariants()

    # -- capacity -----------------------------------------------------------
    def pages_needed(self, length: int) -> int:
        return -(-max(length, 1) // self.page_size)

    def free_pages(self) -> int:
        return int(self.state["free_top"])

    # -- accounting ---------------------------------------------------------
    def pages_in_use(self) -> int:
        return self.num_pages - self.free_pages()

    def active_tokens(self) -> int:
        return int(self.state["pos"].sum())

    @staticmethod
    def _is_page_leaf(name: str, leaf) -> bool:
        """Pool leaves (rank-5 page pools) and their per-page scale side
        tensors (``scl*``): everything whose axis 1 is the physical page
        axis.  Recurrent states (NamedTuples) are not."""
        return isinstance(leaf, torch.Tensor) and (
            leaf.ndim == 5 or name.startswith("scl"))

    def page_bytes(self) -> int:
        """Bytes of ONE page across every attention layer's pool and, for
        a quantized pool, its scale side tensor."""
        return sum((t.numel() // t.shape[1]) * t.element_size()
                   for name, t in self.state["blocks"].items()
                   if self._is_page_leaf(name, t))

    def used_cache_bytes(self) -> int:
        """Bytes backing live requests: pages in use, the page table, and
        the recurrent state (whole: it does not grow with tokens)."""
        tab = self.state["table"]
        recurrent = sum(pytree_nbytes(leaf)
                        for name, leaf in self.state["blocks"].items()
                        if not self._is_page_leaf(name, leaf))
        return (self.pages_in_use() * self.page_bytes()
                + tab.numel() * tab.element_size() + recurrent)

    def total_cache_bytes(self) -> int:
        return pytree_nbytes(self.state)

    # -- mutation -----------------------------------------------------------
    def release(self, slot: int) -> None:
        self.state = dec.paged_release_slot(self.cfg, self.state, slot)
        self._maybe_check()

    def insert_prefill(self, slot: int, cache_states, length: int,
                       state_len: int | None = None) -> None:
        """Embed prefill states (computed over ``state_len`` tokens,
        ``length`` by default) into the slot's pages."""
        state_len = length if state_len is None else state_len
        n_pg = self.pages_needed(state_len)
        if self.free_pages() < n_pg:
            raise RuntimeError(
                f"page pool exhausted: prompt needs {n_pg} pages, "
                f"{self.free_pages()} free")
        self.state = dec.paged_insert_prefill(self.cfg, self.state, slot,
                                              cache_states, length,
                                              state_len)
        self._maybe_check()

    # -- prefix sharing -------------------------------------------------------
    def _padded_ids(self, page_ids) -> torch.Tensor:
        arr = np.full((self.pages_per_seq,), -1, np.int32)
        arr[:len(page_ids)] = np.asarray(page_ids, np.int32)
        return torch.from_numpy(arr).to(self.state["ref"].device)

    def adopt_prefix(self, slot: int, page_ids) -> None:
        """Point ``slot``'s table row at a run of SHARED pages (each gets
        +1 refcount) and set its position past them.  The pages are
        read-only to this slot: a partial tail must be forked
        (:meth:`fork_page`) before any write."""
        if len(page_ids) > self.pages_per_seq:
            raise ValueError(f"prefix run of {len(page_ids)} pages "
                             f"exceeds pages_per_seq={self.pages_per_seq}")
        self.state = dec.paged_adopt_prefix(self.cfg, self.state, slot,
                                            self._padded_ids(page_ids))
        self._maybe_check()

    def fork_page(self, slot: int, logical_idx: int, src_page: int,
                  pos_to: int) -> None:
        """Copy-on-write fork: pop a fresh page, copy ``src_page``'s beats
        (and scale) into it in every layer's pool, and point ``slot``'s
        ``logical_idx`` entry at the COPY (position set to ``pos_to``).
        The shared source is never written in place."""
        if self.free_pages() < 1:
            raise RuntimeError("page pool exhausted: no free page to "
                               "fork the shared tail into")
        self.state = dec.paged_fork_page(self.cfg, self.state, slot,
                                         logical_idx, src_page,
                                         pos_to=pos_to)
        self.forks += 1
        self._maybe_check()

    def addref(self, page_ids) -> None:
        """External +1 pin per page (the trie publishing pages)."""
        for i in range(0, len(page_ids), self.pages_per_seq):
            self.state = dec.paged_addref(
                self.cfg, self.state,
                self._padded_ids(page_ids[i:i + self.pages_per_seq]))
        self._maybe_check()

    def deref_pages(self, page_ids) -> None:
        """Drop one reference per page; orphans (refcount hits zero) go
        back on the free stack — the trie-eviction release path."""
        for i in range(0, len(page_ids), self.pages_per_seq):
            self.state = dec.paged_deref_pages(
                self.cfg, self.state,
                self._padded_ids(page_ids[i:i + self.pages_per_seq]))
        self._maybe_check()

    def page_refcounts(self) -> np.ndarray:
        """Host copy of the device refcounts (tests / stats)."""
        return self.state["ref"].cpu().numpy()

    def table_row(self, slot: int) -> np.ndarray:
        """Host copy of one slot's page-table row (publish path)."""
        return self.state["table"][slot].cpu().numpy()
