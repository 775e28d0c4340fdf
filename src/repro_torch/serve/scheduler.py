"""Continuous-batching scheduler over the paged KV runtime.

Port of ``repro``'s ``serve/scheduler.py``: admission (free-slot and
reserved-page checks), chunked prefill (``chunk_pages`` page-sized chunks
per ``tick``, through ``paged_prefill_chunk``), the per-step active set
(one ``paged_decode_step`` over all slots with an ``active`` mask),
sampling, preemption-and-restore under page pressure, reclamation
(``finish`` releases the slot's pages), and the step watchdog
(``watchdog``, a :class:`~repro_torch.ft.straggler.StepWatchdog` fed each
decode step's wall time; ``stats`` counts its breaches).  Surfaces kept:
``add_request``, ``step``, ``finish``, ``submit``, ``tick`` and ``stats``.

``kv_quant`` ("int8" / "fp8") serves from the QUANTIZED page pool (per-page
scales, the dequant inside the one fused page gather).  ``prefix_cache=True``
(attention-only stacks, as in the reference) shares prompt-prefix pages
through the radix trie (``serve/prefix_cache.py``): admission ADOPTS the
matched full pages and FORKS a copy-on-write tail when the match ends
mid-page, completed prefills PUBLISH their full prompt pages (the trie's
+1 pin), and under page pressure the trie evicts LRU unpinned leaves
before any slot is preempted; ``stats()["prefix"]`` reports it.

The reference jit-compiles the step and donates the cache; the port runs
eagerly and updates the page pools in place.  Greedy decoding is the
parity target; temperature / top-k sampling draws from one seeded
``torch.Generator`` and is held only to determinism inside the port (JAX
threefry keys are not torch generators).

``guard_nan=True`` turns on the per-slot NaN/Inf logit guard: the sampled
tokens and a finite flag per slot come back to the host in one sync, and a
slot whose logits are not all finite fails alone (``fail_slot``; counted in
``nan_failures``).  ``_taint`` is the chaos harness's hook
(``serve/chaos.py``): a boolean row mask whose rows the next step's logits
carry as NaN, once.  The fleet surface (``load``, ``resident_rids``,
``migrate_queued``, ``adopt``, ``evacuate``, ``latency_samples``) serves the
replica router (``serve/fleet.py``).

Waiting for a later slice (it raises ``NotImplementedError``): speculative
decode (``speculate > 1``).
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import vx
from repro_torch.device import resolve as resolve_device
from repro_torch.models import decode as dec
from repro_torch.models.transformer import ModelConfig, cast_params
from repro_torch.serve.lifecycle import (AdmissionError, AdmissionQueue,
                                         Request, RequestState, summarize)
from repro_torch.serve.paged_cache import PagedCache
from repro_torch.serve.prefix_cache import PrefixCache


def sample_tokens(logits: torch.Tensor, generator: torch.Generator | None,
                  *, temperature: float = 0.0,
                  top_k: int | None = None) -> torch.Tensor:
    """Per-slot sampling.  logits: (B, V).  ``temperature <= 0`` is greedy
    argmax (first maximal index, as ``jnp.argmax``); otherwise categorical
    over ``logits / temperature``, restricted to the top-k logits when
    ``top_k`` is set."""
    lg = logits.float()
    if temperature <= 0.0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    lg = lg / temperature
    if top_k is not None and top_k < lg.shape[-1]:
        kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
        lg = torch.where(lg >= kth, lg, torch.full_like(lg, -torch.inf))
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


class Scheduler:
    """Fixed-slot continuous batching over a shared page pool (see the
    module docstring).  ``device`` follows the port's rule: cuda unless
    the caller passes ``device="cpu"``; ``params`` must live there."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int,
                 max_len: int, page_size: int | None = None,
                 num_pages: int | None = None,
                 cache_dtype=torch.float32, kv_quant: str | None = None,
                 fuse_step: bool = True, temperature: float = 0.0,
                 top_k: int | None = None, seed: int = 0,
                 queue_depth: int | None = None, preemption: bool = True,
                 guard_nan: bool = False, watchdog=None,
                 debug_invariants: bool = False,
                 prefix_cache: bool = False, chunk_pages: int = 1,
                 speculate: int = 1, device=None,
                 clock: Callable[[], float] = time.monotonic):
        if speculate != 1:
            raise NotImplementedError("speculative decode waits for a "
                                      "later slice of the port")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0 (0 = greedy), "
                             f"got {temperature}")
        if top_k is not None and top_k <= 0:
            raise ValueError(f"top_k must be a positive int or None, "
                             f"got {top_k}")
        if chunk_pages < 1:
            raise ValueError(f"chunk_pages must be >= 1, got {chunk_pages}")
        self.device = resolve_device(device)
        self.cfg = cfg
        # cast once: the step's own cast then finds every leaf in place
        self.params = cast_params(params, cfg)
        self.slots, self.max_len = slots, max_len
        page_size = min(page_size or 16, max_len)
        self.cache = PagedCache(cfg, slots, max_len, page_size,
                                cache_dtype=cache_dtype,
                                num_pages=num_pages, kv_quant=kv_quant,
                                device=self.device,
                                debug_invariants=debug_invariants)
        self.temperature, self.top_k = float(temperature), top_k
        self.fuse_step = fuse_step
        vx.warm(2 * cfg.hd, strided=False, fields=(2,),
                policy=cfg.vx_policy)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.chunk_pages = int(chunk_pages)
        self._prefilling: dict[int, int] = {}   # slot -> prefilled tokens
        self.prefill_chunks = 0
        self.decode_steps = 0
        # prefix sharing is sound only when every layer's state lives in
        # the page pool: the trie is gated to attention-only stacks
        self.prefix: PrefixCache | None = None
        if prefix_cache and all(k == "attn" for k in cfg.block_pattern):
            self.prefix = PrefixCache(self.cache.page_size,
                                      self.cache.num_pages)
            self.cache.external_ref = self.prefix.page_refs
        self.active = [False] * slots
        self.tokens: list[list[int]] = [[] for _ in range(slots)]
        self.last_logits = None
        self.clock = clock
        self.watchdog = watchdog
        self.preemption = preemption
        self.guard_nan = guard_nan
        self.queue = AdmissionQueue(
            queue_depth if queue_depth is not None else 4 * slots,
            retry_after_hint=self._retry_after)
        self.requests: dict[int, Request] = {}
        self._slot_req: list[Request | None] = [None] * slots
        # replay cursor: index into tokens[s] of the NEXT input token
        self._fed = [0] * slots
        self._pos = [0] * slots      # host mirror of cache.state["pos"]
        self._taint: np.ndarray | None = None   # chaos NaN-injection hook
        self._newly_terminal: list[Request] = []
        self._step_ewma = 0.0
        self.nan_failures = 0
        self.preemptions = 0
        self._submit_t: dict[int, float] = {}
        self._last_tok_t: dict[int, float] = {}
        self._ttft: list[float] = []
        self._itl: list[float] = []

    # -- admission ----------------------------------------------------------
    def free_slot(self) -> int | None:
        for s in range(self.slots):
            if not self.active[s]:
                return s
        return None

    def _reserved_pages(self) -> int:
        """Pages live requests need for their CURRENT tokens."""
        return sum(self.cache.pages_needed(len(self.tokens[s]))
                   for s in range(self.slots) if self.active[s])

    def _pages_for(self, toks: Sequence[int]) -> int:
        return self.cache.pages_needed(max(len(toks) - 1, 1)) + 1

    def add_request(self, prompt: int | Sequence[int]) -> int:
        """Admit a request immediately and prefill it to completion; the
        last prompt token is fed to the next decode step.  Raises
        :class:`AdmissionError` when no slot or not enough pages."""
        toks = [int(prompt)] if isinstance(prompt, int) else \
            [int(t) for t in prompt]
        if not toks:
            raise ValueError("empty prompt")
        if len(toks) > self.max_len:
            raise ValueError(f"prompt of {len(toks)} tokens exceeds "
                             f"max_len={self.max_len}")
        req = Request(prompt=toks)
        req.arrival_seq = next(self.queue._seq)
        self.requests[req.rid] = req
        self._submit_t[req.rid] = self.clock()
        try:
            return self._admit_into(req, sync=True)
        except AdmissionError as e:
            if not req.terminal:
                req.to(RequestState.FAILED, error=str(e))
            raise

    def _admit_into(self, req: Request, *, sync: bool = False) -> int:
        """Place a QUEUED request into a free slot and start its chunked
        prefill (to completion when ``sync``).  Resume after preemption
        re-runs the same chunks and arms the replay cursor."""
        toks = req.tokens
        slot = self.free_slot()
        if slot is None:
            raise AdmissionError("no free slot",
                                 retry_after=self._retry_after())
        # trie orphans are evictable: under pressure LRU leaves are dropped
        # before refusing
        need = self._pages_for(toks)
        avail = self.cache.num_pages - self._reserved_pages()
        if avail < need:
            avail += self._evict_prefix(need - avail)
        if avail < need:
            raise AdmissionError(
                "page pool exhausted; finish a request or grow num_pages",
                retry_after=self._retry_after())
        req.to(RequestState.PREFILLING)
        self.active[slot] = True
        self.tokens[slot] = list(toks)
        self._fed[slot] = 0
        self._pos[slot] = 0
        self._slot_req[slot] = req
        req.slot = slot
        try:
            self._begin_prefill(slot, req)
            if sync:
                while slot in self._prefilling:
                    if not self._advance_prefill(slot, self.chunk_pages):
                        raise AdmissionError(
                            "page pool exhausted mid-prefill; finish a "
                            "request or grow num_pages",
                            retry_after=self._retry_after())
        except AdmissionError:
            self._release_slot(slot)
            raise
        except Exception as e:       # noqa: BLE001 — typed terminal state
            req.to(RequestState.FAILED, error=f"prefill: {e}")
            self._release_slot(slot)
            raise
        return slot

    # -- chunked prefill ----------------------------------------------------
    def _begin_prefill(self, slot: int, req: Request) -> None:
        """Arm the prefill cursor: serve whatever prefix the trie holds
        (the full-page run adopted; a partial tail forked copy-on-write
        when a free page exists, else recomputed), then leave the rest to
        ``_advance_prefill``."""
        pre = req.prompt[:-1]
        if not pre:
            self._finish_prefill(slot)
            return
        done = 0
        if self.prefix is not None:
            m = self.prefix.acquire(slot, pre)
            if m.run:
                self.cache.adopt_prefix(slot, list(m.run))
                done = len(m.run) * self.cache.page_size
            if m.fork_src >= 0 and self.cache.free_pages() >= 1:
                self.cache.fork_page(slot, len(m.run), m.fork_src,
                                     done + m.fork_len)
                done += m.fork_len
        self._prefilling[slot] = done
        self._pos[slot] = done
        if done >= len(pre):
            self._finish_prefill(slot)

    def _advance_prefill(self, slot: int, chunks: int) -> bool:
        """Run up to ``chunks`` page-sized prefill chunks for ``slot``.
        Returns False when the pool cannot back the next chunk."""
        req = self._slot_req[slot]
        pre = req.prompt[:-1]
        ps = self.cache.page_size
        c = self._prefilling[slot]
        for _ in range(chunks):
            if c >= len(pre):
                break
            n = min(ps, len(pre) - c)
            newp = self.cache.pages_needed(c + n) - \
                (0 if c == 0 else -(-c // ps))
            if self.cache.free_pages() < newp:
                self._evict_prefix(newp - self.cache.free_pages())
            if self.cache.free_pages() < newp:
                return False
            tok = torch.tensor(pre[c:c + n] + [0] * (ps - n),
                               dtype=torch.int32, device=self.device)
            self.cache.state = dec.paged_prefill_chunk(
                self.params, self.cache.state, tok, self.cfg, None,
                slot=slot, count=n)
            self.cache._maybe_check()
            c += n
            self._prefilling[slot] = c
            self._pos[slot] = c
            self.prefill_chunks += 1
        if c >= len(pre):
            self._finish_prefill(slot)
        return True

    def _finish_prefill(self, slot: int) -> None:
        """Publish the prompt's full pages to the trie (newly inserted
        ones take the trie's +1 pin), arm the replay cursor and mark the
        request RUNNING."""
        req = self._slot_req[slot]
        self._prefilling.pop(slot, None)
        pre = req.prompt[:-1]
        if self.prefix is not None and pre:
            new = self.prefix.publish(slot, pre, self.cache.table_row(slot))
            if new:
                self.cache.addref(new)
        self._fed[slot] = len(req.prompt) - 1
        self._pos[slot] = len(req.prompt) - 1
        req.to(RequestState.RUNNING)

    def _evict_prefix(self, n_pages: int) -> int:
        """Drop up to ``n_pages`` LRU unpinned trie leaves; returns how
        many pages that freed (the page-pressure valve that runs before
        any slot is preempted)."""
        if self.prefix is None or n_pages <= 0:
            return 0
        ids = self.prefix.evict(n_pages)
        if ids:
            self.cache.deref_pages(ids)
        return len(ids)

    def _pending_prefill_pages(self) -> int:
        ps = self.cache.page_size
        pend = 0
        for s, c in self._prefilling.items():
            req = self._slot_req[s]
            if req is not None:
                pend += -(-max(len(req.prompt) - 1 - c, 0) // ps)
        for r in self.queue._q:
            pend += -(-max(len(r.prompt) - 1, 0) // ps)
        return pend

    def _retry_after(self) -> float:
        ew = self._step_ewma or 0.0
        return ew * (1.0 + self._pending_prefill_pages()
                     / max(self.chunk_pages, 1))

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: int | None = None, priority: int = 0,
               deadline: float | None = None,
               ttl: float | None = None) -> Request:
        """Queue a typed request for admission by ``tick``.  Malformed
        requests come back already FAILED; a full queue raises
        :class:`AdmissionError`."""
        if ttl is not None:
            deadline = self.clock() + ttl if deadline is None else \
                min(deadline, self.clock() + ttl)
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      priority=priority, deadline=deadline)
        self.requests[req.rid] = req
        self._submit_t[req.rid] = self.clock()
        if not req.prompt:
            req.to(RequestState.FAILED, error="empty prompt")
            return req
        if len(req.prompt) > self.max_len:
            req.to(RequestState.FAILED,
                   error=f"prompt of {len(req.prompt)} tokens exceeds "
                         f"max_len={self.max_len}")
            return req
        if max_new_tokens is not None and max_new_tokens <= 0:
            req.to(RequestState.FAILED,
                   error=f"max_new_tokens must be positive, "
                         f"got {max_new_tokens}")
            return req
        try:
            self.queue.push(req)
        except AdmissionError:
            del self.requests[req.rid]
            raise
        return req

    # -- preemption ---------------------------------------------------------
    def _victim(self, *, below_priority: int | None = None) -> int | None:
        """Lowest priority first, then most pages held, then highest slot."""
        best = None
        for s in range(self.slots):
            req = self._slot_req[s]
            if not self.active[s] or req is None:
                continue
            if below_priority is not None and \
                    req.priority >= below_priority:
                continue
            key = (-req.priority,
                   self.cache.pages_needed(max(len(self.tokens[s]), 1)), s)
            if best is None or key > best[0]:
                best = (key, s)
        return best[1] if best else None

    def preempt(self, slot: int) -> Request:
        """Evict a running or mid-prefill slot and requeue its request
        carrying prompt + generated so far (resume re-prefills the prompt
        and replays the generated tokens)."""
        req = self._slot_req[slot]
        if req is None or not self.active[slot]:
            raise ValueError(f"slot {slot} is not running a request")
        req.tokens = list(self.tokens[slot])
        req.to(RequestState.PREEMPTED)
        req.slot = None
        self._release_slot(slot)
        self.preemptions += 1
        self.queue.push(req, force=True)
        return req

    def fail_slot(self, slot: int, error: str) -> Request | None:
        req = self._slot_req[slot]
        if req is not None and not req.terminal:
            req.tokens = list(self.tokens[slot])
            req.to(RequestState.FAILED, error=error)
            self._newly_terminal.append(req)
        self._release_slot(slot)
        return req

    def _release_slot(self, slot: int) -> None:
        if self.active[slot]:
            self.cache.release(slot)
        if self.prefix is not None:
            self.prefix.release(slot)
        self._prefilling.pop(slot, None)
        self.active[slot] = False
        self.tokens[slot] = []
        self._fed[slot] = 0
        self._pos[slot] = 0
        self._slot_req[slot] = None

    # -- decode -------------------------------------------------------------
    def step(self) -> list[int]:
        """Advance every ACTIVE, fully prefilled slot; others report -1.
        Slots behind their replay cursor feed the next replayed token and
        discard the sampled output until they catch up."""
        t0 = time.perf_counter()
        decoding = [self.active[s] and s not in self._prefilling
                    for s in range(self.slots)]
        cur = torch.tensor([self.tokens[s][self._fed[s]] if decoding[s]
                            else 0 for s in range(self.slots)],
                           dtype=torch.int32, device=self.device)
        act = torch.tensor(decoding, device=self.device)
        logits, self.cache.state = dec.paged_decode_step(
            self.params, self.cache.state, cur, self.cfg, None, active=act,
            fuse=self.fuse_step)
        self.decode_steps += 1
        if self._taint is not None:      # chaos-only NaN injection hook
            mask = torch.as_tensor(self._taint, device=logits.device)[:, None]
            logits = torch.where(mask, torch.nan, logits.float()).to(
                logits.dtype)
            self._taint = None
        self.last_logits = logits
        fin = None
        if self.guard_nan:
            # the finite flags ride with the tokens in the one host sync;
            # a non-finite row is sampled from zeros (its token is dropped)
            ok = torch.isfinite(logits.float()).all(dim=-1)
            nxt = sample_tokens(torch.where(ok[:, None], logits,
                                            torch.zeros_like(logits)),
                                self._gen, temperature=self.temperature,
                                top_k=self.top_k)
            both = torch.stack([nxt, ok.to(torch.int32)]).cpu().numpy()
            nxt, fin = both[0], both[1].astype(bool)
        else:
            nxt = sample_tokens(logits, self._gen,
                                temperature=self.temperature,
                                top_k=self.top_k).cpu().numpy()  # ONE sync
        out = []
        t_now = self.clock()
        seq_cap = self.cache.pages_per_seq * self.cache.page_size
        for s in range(self.slots):
            t = int(nxt[s])
            if not decoding[s]:
                out.append(-1)
                continue
            if fin is not None and not fin[s]:
                self.nan_failures += 1
                self.fail_slot(s, "non-finite logits")
                out.append(-1)
                continue
            if self._pos[s] < seq_cap:
                self._pos[s] += 1
            if self._fed[s] < len(self.tokens[s]) - 1:
                self._fed[s] += 1      # replay: discard the sample
            else:
                self.tokens[s].append(t)
                self._fed[s] += 1
                self._note_tokens(s, t_now)
            out.append(t)
        self.cache._maybe_check()
        dt = time.perf_counter() - t0
        self._step_ewma = dt if self._step_ewma == 0.0 else \
            0.8 * self._step_ewma + 0.2 * dt
        if self.watchdog is not None:
            self.watchdog.observe(dt)
        return out

    def _note_tokens(self, slot: int, t_now: float) -> None:
        req = self._slot_req[slot]
        if req is None:
            return
        last = self._last_tok_t.get(req.rid)
        if last is None:
            t0 = self._submit_t.get(req.rid)
            if t0 is not None:
                self._ttft.append(max(t_now - t0, 0.0))
        else:
            self._itl.append(max(t_now - last, 0.0))
        self._last_tok_t[req.rid] = t_now

    # -- lifecycle pump ------------------------------------------------------
    def tick(self) -> list[Request]:
        """One engine iteration: expire stale queued work, pump admission
        (preempting a lower-priority victim under page pressure), advance
        each mid-prefill slot by ``chunk_pages`` chunks, step the active
        set, retire finished / expired requests.  Returns requests that
        went terminal this tick."""
        done: list[Request] = list(self.queue.expire(self.clock()))
        while True:
            req = self.queue.pop()
            if req is None:
                break
            try:
                self._admit_into(req)
                continue
            except AdmissionError:
                if self.preemption:
                    victim = self._victim(below_priority=req.priority)
                    if victim is not None:
                        self.preempt(victim)
                        try:
                            self._admit_into(req)
                            continue
                        except AdmissionError:
                            pass
                self.queue.push(req, force=True)
                break
        for s in list(self._prefilling):
            if not self.active[s]:
                continue
            if not self._advance_prefill(s, self.chunk_pages):
                if self.preemption:
                    self.preempt(s)
                else:
                    self.fail_slot(s, "page pool exhausted mid-prefill")
        # in-step page-pressure guard: evict trie orphans first (they free
        # pages without killing work), then preempt victims rather than let
        # the device allocator starve a page-boundary crosser
        if self.preemption and any(self.active):
            ps = self.cache.page_size
            n_seq = self.cache.pages_per_seq
            crossers = {s for s in range(self.slots)
                        if self.active[s] and s not in self._prefilling
                        and self._pos[s] % ps == 0
                        and self._pos[s] // ps < n_seq}
            short = len(crossers) - self.cache.free_pages()
            if short > 0:
                self._evict_prefix(short)
            for _ in range(self.slots):
                live = {s for s in crossers if self.active[s]}
                if len(live) <= self.cache.free_pages():
                    break
                victim = self._victim()
                if victim is None or (victim in live and len(live) == 1):
                    break
                self.preempt(victim)
        if any(self.active[s] and s not in self._prefilling
               for s in range(self.slots)):
            self.step()
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is None or not self.active[s]:
                continue
            caught_up = self._fed[s] >= len(self.tokens[s]) - 1
            if req.max_new_tokens is not None and caught_up and \
                    len(self.tokens[s]) - len(req.prompt) >= \
                    req.max_new_tokens:
                req.tokens = list(self.tokens[s])
                req.to(RequestState.FINISHED)
                self._release_slot(s)
                done.append(req)
            elif req.expired(self.clock()):
                req.tokens = list(self.tokens[s])
                req.to(RequestState.TIMED_OUT,
                       error="deadline expired while running")
                self._release_slot(s)
                done.append(req)
        done.extend(self._newly_terminal)
        self._newly_terminal.clear()
        return done

    def drained(self) -> bool:
        return not any(self.active) and len(self.queue) == 0

    # -- fleet surface (serve/fleet.py) -------------------------------------
    def load(self) -> int:
        """Admission-routing load signal: queued + occupying a slot."""
        return len(self.queue) + sum(self.active)

    def resident_rids(self) -> set[int]:
        """rids resident here: waiting in the queue or occupying a slot
        (the fleet audit holds every live request to exactly one
        replica)."""
        out = {r.rid for r in self.queue._q}
        out |= {r.rid for r in self._slot_req if r is not None}
        return out

    def migrate_queued(self) -> list[Request]:
        """Lift every QUEUED request off this replica (the drain of a
        DEGRADED replica); each comes back MIGRATING with the tokens it
        had accumulated."""
        out = self.queue.drain()
        for r in out:
            r.to(RequestState.MIGRATING)
            self.requests.pop(r.rid, None)
        return out

    def adopt(self, req: Request) -> None:
        """Accept a MIGRATING request from another replica: force-queued
        (migration is never dropped by the admission bound) and resumed
        by the next tick through the preemption-resume path."""
        self.requests[req.rid] = req
        self.queue.push(req, force=True)

    def evacuate(self) -> list[Request]:
        """Lift EVERY resident request off this replica (failover when it
        is declared dead): slots carry prompt + generated into MIGRATING,
        queued work follows.  Host bookkeeping only: the pool is never
        touched; the router drops the whole replica at respawn, and the
        target re-prefills the prompt and replays the generated tokens."""
        out: list[Request] = []
        for s in range(self.slots):
            req = self._slot_req[s]
            if req is not None and not req.terminal:
                req.tokens = list(self.tokens[s])
                req.to(RequestState.MIGRATING)   # mid-prefill slots too
                req.slot = None
                out.append(req)
                self.requests.pop(req.rid, None)
            self.active[s] = False
            self.tokens[s] = []
            self._fed[s] = 0
            self._pos[s] = 0
            self._slot_req[s] = None
        self._prefilling.clear()   # cursors die with the replica's pool
        out.extend(self.migrate_queued())
        return out

    def stats(self) -> dict:
        out = summarize(list(self.requests.values()))
        out.update(queue_depth=len(self.queue),
                   queue_rejected=self.queue.rejected,
                   pages_in_use=self.cache.pages_in_use(),
                   free_pages=self.cache.free_pages(),
                   nan_failures=self.nan_failures,
                   invariant_checks=self.cache.invariant_checks,
                   step_ewma_s=self._step_ewma,
                   prefilling=len(self._prefilling),
                   prefill_chunks=self.prefill_chunks,
                   decode_steps=self.decode_steps)
        if self.prefix is not None:
            out["prefix"] = self.prefix.stats()
            out["shared_pages"] = int(
                np.sum(self.cache.page_refcounts() > 1))
        if self.watchdog is not None:
            out["watchdog_breaches"] = self.watchdog.breaches
        out["latency"] = self.latency_stats()
        return out

    def latency_samples(self) -> dict[str, list[float]]:
        """Raw latency samples (seconds); the fleet router concatenates
        them across replicas before taking percentiles."""
        return {"ttft": list(self._ttft), "itl": list(self._itl)}

    def latency_stats(self) -> dict[str, float]:
        """TTFT and inter-token latency p50/p99 (seconds, host clock)."""
        out: dict[str, float] = {}
        for name, xs in (("ttft", self._ttft), ("itl", self._itl)):
            if xs:
                out[f"{name}_p50_s"] = float(np.percentile(xs, 50))
                out[f"{name}_p99_s"] = float(np.percentile(xs, 99))
        return out

    # -- reclamation --------------------------------------------------------
    def finish(self, slot: int) -> list[int]:
        """Release the slot (pages back on the free stack, per-slot state
        cleared).  Finishing an idle slot returns ``[]``."""
        if not self.active[slot]:
            return []
        toks = self.tokens[slot]
        req = self._slot_req[slot]
        if req is not None and not req.terminal:
            req.tokens = list(toks)
            req.to(RequestState.FINISHED)
        self._release_slot(slot)
        return toks
