"""Prefix-sharing radix cache over the paged KV pool (host side).

Port of ``repro``'s ``serve/prefix_cache.py`` (pure Python and numpy; the
port keeps its own copy).  A RADIX TRIE at page granularity: each node is
keyed by exactly ``page_size`` tokens and owns ONE physical page of the
pool whose beats are the KV of those tokens at that depth.  A node's page
is a deterministic function of the token prefix from the root (every
producer runs the same chunked prefill), so adopting it is bit-exact
against recomputing it.

* ADMISSION walks the trie along the prompt's full pages: :meth:`acquire`
  returns the matched page run (the scheduler points the new slot's table
  at it, ``PagedCache.adopt_prefix``, +1 refcount per page) and, when a
  child matches only the first ``m`` tokens of the next page, a
  copy-on-write FORK descriptor: the borrower gets a private copy of that
  page (``PagedCache.fork_page``), so a shared page is never written in
  place.
* PUBLISH: when a prompt finishes prefilling, its full PROMPT pages go
  into the trie (deduplicated against existing nodes) and each newly
  published page takes an external +1 device refcount (``addref``), the
  trie's pin.  Partial tail pages and generated tokens are never
  published.
* RELEASE / EVICTION: releasing a slot only unpins its nodes.  Under page
  pressure the scheduler evicts LRU LEAVES with no pins; each evicted
  node's deref returns exactly one page to the free stack.

``page_refs`` exports the trie's per-page pin counts, so the pool audit
can check refcount conservation: ``ref[p] == (# table entries naming p)
+ (# trie nodes naming p)``.  A quantized page's scale travels with its
page id, so the trie needs nothing for quantized pools.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class _Node:
    """One trie node: ``page_size`` tokens -> one physical page."""
    key: tuple          # exactly page_size tokens (root: empty tuple)
    page: int           # physical page id in the pool (-1 for the root)
    parent: "_Node | None"
    children: dict = dataclasses.field(default_factory=dict)
    users: int = 0      # live slots whose table references this page
    last_used: int = 0  # logical LRU clock


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of an admission walk.

    ``run`` is the matched full-page run (adopt these, in order);
    ``fork_src`` / ``fork_len`` describe a partial tail match — the
    borrower's next page shares its first ``fork_len`` tokens with an
    existing page, so fork a truncated private copy — or (-1, 0) when
    the match ended exactly on a page boundary.  ``matched_tokens`` is
    the total prefix length served from the cache."""
    run: tuple
    fork_src: int
    fork_len: int
    matched_tokens: int


class PrefixCache:
    """Radix cache mapping token prefixes to refcounted page runs."""

    def __init__(self, page_size: int, num_pages: int):
        self.page_size = page_size
        self.num_pages = num_pages
        self.root = _Node(key=(), page=-1, parent=None)
        self._clock = 0
        self._pins: dict[int, list[_Node]] = {}   # slot -> pinned nodes
        self.hits = 0
        self.misses = 0
        self.inserted = 0
        self.evicted = 0
        self.tokens_reused = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- admission walk -----------------------------------------------------
    def acquire(self, slot: int, tokens: Sequence[int]) -> PrefixMatch:
        """Walk the trie along ``tokens`` (the prefill portion of a
        prompt), pinning every matched node under ``slot``.  Full-page
        matches extend ``run``; at the first divergence, the child
        sharing the longest proper prefix of the next page (if any)
        becomes the fork source.  Pins are dropped by :meth:`release`."""
        ps = self.page_size
        node, run, pins = self.root, [], []
        i = 0
        while len(tokens) - i >= ps:
            child = node.children.get(tuple(tokens[i:i + ps]))
            if child is None:
                break
            run.append(child.page)
            child.users += 1
            child.last_used = self._tick()
            pins.append(child)
            node = child
            i += ps
        fork_src, fork_len = -1, 0
        rem = list(tokens[i:i + ps])
        if rem:
            for child in node.children.values():
                m = 0
                for a, b in zip(rem, child.key):
                    if a != b:
                        break
                    m += 1
                if m > fork_len:
                    fork_src, fork_len = child.page, m
        if pins:
            self._pins.setdefault(slot, []).extend(pins)
        matched = i + fork_len
        if matched:
            self.hits += 1
        else:
            self.misses += 1
        self.tokens_reused += matched
        return PrefixMatch(run=tuple(run), fork_src=fork_src,
                           fork_len=fork_len, matched_tokens=matched)

    # -- publish ------------------------------------------------------------
    def publish(self, slot: int, tokens: Sequence[int],
                table_row: np.ndarray) -> list[int]:
        """Insert ``slot``'s full PROMPT pages into the trie after its
        prefill completed.  ``table_row`` maps logical page index ->
        physical page.  Pages already published by another request are
        skipped (the slot keeps its private duplicate — correct, just
        not shared); newly inserted pages are returned so the caller
        can take the trie's device refcount pin (``addref``)."""
        ps = self.page_size
        node, new = self.root, []
        pins = self._pins.setdefault(slot, [])
        for j in range(len(tokens) // ps):
            key = tuple(tokens[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                page = int(table_row[j])
                if page < 0:       # starved prefill: nothing to publish
                    break
                child = _Node(key=key, page=page, parent=node)
                node.children[key] = child
                child.users += 1
                pins.append(child)
                new.append(page)
                self.inserted += 1
            child.last_used = self._tick()
            node = child
        return new

    # -- release / eviction -------------------------------------------------
    def release(self, slot: int) -> None:
        """Unpin every node ``slot`` acquired or published.  Host-side
        only: the slot's own table deref reclaims its references; trie
        pages stay alive under the trie's external pin until evicted."""
        for node in self._pins.pop(slot, []):
            node.users -= 1

    def evict(self, n_pages: int) -> list[int]:
        """Detach up to ``n_pages`` LRU leaves with zero pins and return
        their page ids — the caller MUST ``deref_pages`` them (each
        returns exactly one page to the free stack, because an unpinned
        leaf's only remaining reference is the trie's own)."""
        out: list[int] = []
        while len(out) < n_pages:
            victim = None
            for node in self._iter_nodes():
                if node is self.root or node.children or node.users > 0:
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            del victim.parent.children[victim.key]
            out.append(victim.page)
            self.evicted += 1
        return out

    # -- accounting ---------------------------------------------------------
    def _iter_nodes(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def page_refs(self) -> np.ndarray:
        """Per-page external pin counts (one per trie node) — the
        ``external_ref`` term of the pool's conservation audit."""
        ext = np.zeros((self.num_pages,), np.int64)
        for node in self._iter_nodes():
            if node.page >= 0:
                ext[node.page] += 1
        return ext

    def pages(self) -> int:
        """Pages currently held by the trie."""
        return sum(1 for n in self._iter_nodes() if n.page >= 0)

    def orphan_pages(self) -> int:
        """Trie pages no live slot references (pin count zero) — held
        memory the scheduler's admission math must reserve for, and
        exactly what :meth:`evict` can hand back under pressure."""
        return sum(1 for n in self._iter_nodes()
                   if n.page >= 0 and n.users == 0)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "tokens_reused": self.tokens_reused,
            "pages": self.pages(),
            "inserted": self.inserted,
            "evicted": self.evicted,
        }
