"""Paged KV-cache state for serving: page pool + page table + free stack.

Port of ``repro``'s ``serve/paged_cache.py`` (float pools).  The device
state lives in the cache dict built by ``models/decode.init_paged_cache``;
this class adds the host bookkeeping a scheduler needs — capacity checks,
page accounting, release and prefill insert.  Mutations update the state
in place where the reference donated it to a jit'd entry point.  The
prefill insert, prefix sharing (adopt / fork / addref / deref) and the
quantized pool wait for a later slice (chunked prefill is the
scheduler's only prefill path).
"""
from __future__ import annotations

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
                 num_pages: int | None = None, device=None,
                 debug_invariants: bool = False):
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_seq = dec.pages_per_seq(max_len, page_size)
        self.num_pages = (slots * self.pages_per_seq
                          if num_pages is None else num_pages)
        self.state = dec.init_paged_cache(cfg, slots, max_len, page_size,
                                          cache_dtype,
                                          num_pages=self.num_pages,
                                          device=device)
        self.external_ref = None
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

    def page_bytes(self) -> int:
        """Bytes of ONE page across every attention layer's pool."""
        return sum((t.numel() // t.shape[1]) * t.element_size()
                   for t in self.state["blocks"].values())

    def used_cache_bytes(self) -> int:
        """Bytes backing live requests: pages in use plus the page table."""
        tab = self.state["table"]
        return (self.pages_in_use() * self.page_bytes()
                + tab.numel() * tab.element_size())

    def total_cache_bytes(self) -> int:
        return pytree_nbytes(self.state)

    # -- mutation -----------------------------------------------------------
    def release(self, slot: int) -> None:
        self.state = dec.paged_release_slot(self.cfg, self.state, slot)
        self._maybe_check()
