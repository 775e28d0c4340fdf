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

``speculate=K`` with a ``draft_cfg`` / ``draft_params`` model (greedy only,
an attention-only draft) turns decode into a K-token verify: the draft
proposes K-1 tokens from its own page pool (``_draft_pump``: catch-up
chunks, then batched single steps), the target checks all K in one
``paged_verify_step`` (one fused page gather and one fused split), and
rejected tokens roll back through the page table and ``pos`` only; the
draft pool is then truncated to the committed positions.  The tokens and
the commit counts (and the finite flags, with the guard) come back to the
host in ONE sync per verify step.  ``submit(..., speculate=k)`` sets a
per-request width (clamped to K; 1 opts out), so speculative and plain
slots share one verify call; replay after preemption feeds recorded
tokens through the verify batch as perfect drafts.
``stats()["speculative"]`` reports the acceptance.
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
                 speculate: int = 1, draft_cfg: ModelConfig | None = None,
                 draft_params=None, device=None,
                 clock: Callable[[], float] = time.monotonic):
        if cfg.encoder is not None:
            raise NotImplementedError("paged serving covers decoder-only "
                                      "models")
        # speculation knobs fail loudly here, not at the first verify step
        if speculate < 1:
            raise ValueError(f"speculate must be >= 1, got {speculate}")
        if speculate > 1:
            if draft_cfg is None or draft_params is None:
                raise ValueError("speculate > 1 requires draft_cfg and "
                                 "draft_params (the small draft model)")
            if temperature > 0.0:
                raise ValueError(
                    "speculative decode requires greedy sampling "
                    "(temperature=0): verify accepts a draft iff it equals "
                    "the target argmax — a sampled target has no single "
                    "token to match against")
            if draft_cfg.encoder is not None or \
                    any(k != "attn" for k in draft_cfg.block_pattern):
                raise ValueError(
                    "draft model must be an attention-only decoder: the "
                    "draft cache rolls back rejected tokens via "
                    "paged_truncate (page table + pos only) and recurrent "
                    "draft state cannot be truncated that way")
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
        with torch.no_grad():
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
        # speculative decode: the verify width is fixed (= speculate); each
        # slot's effective width rides in as the n_draft tensor.  The draft
        # runs in its own fully provisioned float page pool.
        self.speculate = int(speculate)
        self.draft_cfg = draft_cfg
        self.draft_params = None
        self.draft_cache: PagedCache | None = None
        if self.speculate > 1:
            with torch.no_grad():
                self.draft_params = cast_params(draft_params, draft_cfg)
            self.draft_cache = PagedCache(
                draft_cfg, slots, max_len, self.cache.page_size,
                cache_dtype=cache_dtype, device=self.device,
                debug_invariants=debug_invariants)
            vx.warm(2 * draft_cfg.hd, strided=False, fields=(2,),
                    policy=draft_cfg.vx_policy)
        self._spec_k = [1] * slots   # per-slot verify width (request K)
        self._dpos = [0] * slots     # draft tokens consumed (host mirror)
        self.spec_steps = 0          # verify steps taken
        self.spec_proposed = 0       # draft tokens proposed to verify
        self.spec_accepted = 0       # draft tokens accepted by verify
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
        """Pages live requests need for their CURRENT tokens, plus the
        K-token worst case of speculative slots: a verify step may append
        ``_spec_k[s]`` tokens before any rollback."""
        return sum(self.cache.pages_needed(len(self.tokens[s])
                                           + self._spec_k[s] - 1)
                   for s in range(self.slots) if self.active[s])

    def _pages_for(self, toks: Sequence[int], k: int = 1) -> int:
        return self.cache.pages_needed(max(len(toks) - 1, 1) + k - 1) + 1

    def _req_k(self, req: Request) -> int:
        """A request's verify width: its ``speculate`` clamped into [1,
        scheduler K]."""
        return max(1, min(int(req.speculate), self.speculate))

    @torch.no_grad()
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
        req = Request(prompt=toks, speculate=self.speculate)
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
        need = self._pages_for(toks, self._req_k(req))
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
        self._spec_k[slot] = self._req_k(req)
        self._dpos[slot] = 0     # the draft catches up lazily in the pump
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
               deadline: float | None = None, ttl: float | None = None,
               speculate: int | None = None) -> Request:
        """Queue a typed request for admission by ``tick``.  Malformed
        requests (``speculate < 1`` included) come back already FAILED; a
        full queue raises :class:`AdmissionError`."""
        if ttl is not None:
            deadline = self.clock() + ttl if deadline is None else \
                min(deadline, self.clock() + ttl)
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      priority=priority, deadline=deadline,
                      speculate=self.speculate if speculate is None
                      else int(speculate))
        self.requests[req.rid] = req
        self._submit_t[req.rid] = self.clock()
        if req.speculate < 1:
            req.to(RequestState.FAILED,
                   error=f"speculate must be >= 1, got {req.speculate}")
            return req
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
            if self.draft_cache is not None:
                self.draft_cache.release(slot)
        if self.prefix is not None:
            self.prefix.release(slot)
        self._prefilling.pop(slot, None)
        self.active[slot] = False
        self.tokens[slot] = []
        self._fed[slot] = 0
        self._pos[slot] = 0
        self._spec_k[slot] = 1
        self._dpos[slot] = 0
        self._slot_req[slot] = None

    # -- decode -------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> list[int]:
        """Advance every ACTIVE, fully prefilled slot; others report -1.
        Slots behind their replay cursor feed the next replayed token and
        discard the sampled output until they catch up.  When any slot
        speculates this step, the whole active set goes through the one
        K-wide verify call instead (``_step_speculative``): plain slots
        ride along at width 1."""
        t0 = time.perf_counter()
        decoding = [self.active[s] and s not in self._prefilling
                    for s in range(self.slots)]
        if self.speculate > 1 and any(
                decoding[s] and self._spec_k[s] > 1
                for s in range(self.slots)):
            out = self._step_speculative(decoding)
        else:
            out = self._step_plain(decoding)
        self.decode_steps += 1
        self.cache._maybe_check()
        dt = time.perf_counter() - t0
        self._step_ewma = dt if self._step_ewma == 0.0 else \
            0.8 * self._step_ewma + 0.2 * dt
        if self.watchdog is not None:
            self.watchdog.observe(dt)
        return out

    def _taint_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The chaos hook: the tainted rows' logits become NaN, once."""
        if self._taint is None:
            return logits
        mask = torch.as_tensor(self._taint, device=logits.device)
        mask = mask.reshape(mask.shape + (1,) * (logits.ndim - 1))
        self._taint = None
        return torch.where(mask, torch.nan, logits.float()).to(logits.dtype)

    def _step_plain(self, decoding: list[bool]) -> list[int]:
        """The single-token decode step."""
        cur = torch.tensor([self.tokens[s][self._fed[s]] if decoding[s]
                            else 0 for s in range(self.slots)],
                           dtype=torch.int32, device=self.device)
        act = torch.tensor(decoding, device=self.device)
        logits, self.cache.state = dec.paged_decode_step(
            self.params, self.cache.state, cur, self.cfg, None, active=act,
            fuse=self.fuse_step)
        logits = self._taint_logits(logits)
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
                self._note_tokens(s, t_now, 1)
            out.append(t)
        return out

    def _step_speculative(self, decoding: list[bool]) -> list[int]:
        """One K-wide verify step over the whole active set.

        Per slot the batch is up to ``_spec_k`` recorded tokens when the
        slot is behind its replay cursor (recorded tokens are perfect
        drafts under greedy decode), else the head token plus ``_spec_k -
        1`` draft tokens from :meth:`_draft_pump`; a width is clamped so
        that a commit never passes ``max_new_tokens``.  A commit ``c``
        advances the cursor or appends exactly the tokens the plain step
        would produce; the verify call has already rolled the rejected
        pages back.  The draft pool is then truncated to the committed
        positions."""
        K = self.speculate
        toks = np.zeros((self.slots, K), np.int32)
        nd = np.ones((self.slots,), np.int32)
        recorded = [0] * self.slots
        need = [0] * self.slots
        for s in range(self.slots):
            if not decoding[s]:
                continue
            k = self._spec_k[s]
            req = self._slot_req[s]
            if req is not None and req.max_new_tokens is not None:
                behind = len(self.tokens[s]) - 1 - self._fed[s]
                done = len(self.tokens[s]) - len(req.prompt)
                rem = max(req.max_new_tokens - done, 0)
                k = max(1, min(k, behind + rem))
            avail = len(self.tokens[s]) - self._fed[s]
            r = min(avail, k)
            toks[s, :r] = self.tokens[s][self._fed[s]:self._fed[s] + r]
            recorded[s] = nd[s] = r
            if r == avail and k > r:
                need[s] = k - r          # top up with draft-model tokens
        if any(need):
            drafts = self._draft_pump(need)
            for s in range(self.slots):
                if need[s]:
                    got = drafts[s]
                    toks[s, recorded[s]:recorded[s] + len(got)] = got
                    nd[s] = recorded[s] + len(got)
        act = torch.tensor(decoding, device=self.device)
        logits, o, commit, self.cache.state = dec.paged_verify_step(
            self.params, self.cache.state,
            torch.from_numpy(toks).to(self.device), self.cfg, None,
            n_draft=torch.from_numpy(nd).to(self.device), active=act,
            fuse=self.fuse_step)
        logits = self._taint_logits(logits)
        self.last_logits = logits[:, 0, :]
        # ONE host sync: the tokens, the commits (and the finite flags)
        parts = [o, commit[:, None]]
        if self.guard_nan:
            parts.append(torch.isfinite(logits.float()).all(dim=-1)
                         .to(torch.int32))
        host = torch.cat(parts, dim=1).cpu().numpy()
        o_np, cm = host[:, :K], host[:, K]
        fin = host[:, K + 1:].astype(bool) if self.guard_nan else None
        out = []
        t_now = self.clock()
        seq_cap = self.cache.pages_per_seq * self.cache.page_size
        drafted = False
        for s in range(self.slots):
            if not decoding[s]:
                out.append(-1)
                continue
            c = max(int(cm[s]), 1)
            if fin is not None and not np.all(fin[s, :c]):
                self.nan_failures += 1
                self.fail_slot(s, "non-finite logits")
                out.append(-1)
                continue
            fresh = 0
            for j in range(c):
                if self._fed[s] < len(self.tokens[s]) - 1:
                    self._fed[s] += 1    # replay: the record has it
                else:
                    self.tokens[s].append(int(o_np[s, j]))
                    self._fed[s] += 1
                    fresh += 1
            self._pos[s] = min(self._pos[s] + c, seq_cap)
            if need[s]:
                drafted = True
                self.spec_proposed += need[s]
                self.spec_accepted += max(0, c - recorded[s])
            if fresh:
                self._note_tokens(s, t_now, fresh)
            out.append(int(o_np[s, c - 1]))
        self.spec_steps += 1
        if drafted:
            # the rejected draft tail rolls back through its page table; a
            # fully accepted step leaves the draft one token behind, which
            # the next pump's catch-up singles cover
            self.draft_cache.state = dec.paged_truncate(
                self.draft_cfg, self.draft_cache.state,
                torch.tensor(self._pos, dtype=torch.int32,
                             device=self.device))
            self.draft_cache._maybe_check()
            for s in range(self.slots):
                self._dpos[s] = min(self._dpos[s], self._pos[s])
        return out

    def _draft_pump(self, need: list[int]) -> list[list[int]]:
        """``need[s]`` draft tokens per slot from the draft model: first
        the draft pool catches up on the slot's recorded tokens (whole
        pages through the chunk prefill, then single steps), then the
        drafts autoregress from the head token.  Single steps are batched
        across slots through one draft step with an active mask."""
        dc = self.draft_cache
        ps = dc.page_size
        for s in range(self.slots):
            if need[s] <= 0:
                continue
            target = len(self.tokens[s]) - 1     # tokens before the head
            while self._dpos[s] % ps == 0 and \
                    target - self._dpos[s] >= ps:
                tok = torch.tensor(
                    self.tokens[s][self._dpos[s]:self._dpos[s] + ps],
                    dtype=torch.int32, device=self.device)
                dc.state = dec.paged_prefill_chunk(
                    self.draft_params, dc.state, tok, self.draft_cfg, None,
                    slot=s, count=ps)
                self._dpos[s] += ps
        drafts: list[list[int]] = [[] for _ in range(self.slots)]
        pend = {s for s in range(self.slots) if need[s] > 0}
        while pend:
            feed = np.zeros((self.slots,), np.int32)
            act = np.zeros((self.slots,), bool)
            for s in pend:
                i = self._dpos[s]
                feed[s] = self.tokens[s][i] if i < len(self.tokens[s]) \
                    else drafts[s][i - len(self.tokens[s])]
                act[s] = True
            lg, dc.state = dec.paged_decode_step(
                self.draft_params, dc.state,
                torch.from_numpy(feed).to(self.device), self.draft_cfg,
                None, active=torch.from_numpy(act).to(self.device),
                fuse=self.fuse_step)
            nxt = torch.argmax(lg.float(), dim=-1).cpu().numpy()
            for s in list(pend):
                keep = self._dpos[s] >= len(self.tokens[s]) - 1
                self._dpos[s] += 1
                if keep:
                    drafts[s].append(int(nxt[s]))
                    if len(drafts[s]) >= need[s]:
                        pend.discard(s)
        dc._maybe_check()
        return drafts

    def _note_tokens(self, slot: int, t_now: float, n: int) -> None:
        """Latency samples for ``n`` tokens appended to ``slot``: TTFT on
        the first, then the gap per token (a K-token commit records
        gap/K)."""
        req = self._slot_req[slot]
        if req is None:
            return
        last = self._last_tok_t.get(req.rid)
        if last is None:
            t0 = self._submit_t.get(req.rid)
            if t0 is not None:
                self._ttft.append(max(t_now - t0, 0.0))
        else:
            self._itl.append(max(t_now - last, 0.0) / n)
        self._last_tok_t[req.rid] = t_now

    # -- lifecycle pump ------------------------------------------------------
    @torch.no_grad()
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

            def _step_new_pages(s: int) -> int:
                # pages this step may allocate for slot s: a plain slot
                # crosses at most one boundary, a speculative slot may
                # append up to _spec_k tokens before rollback
                p = self._pos[s]
                first = -(-p // ps)
                last = min((p + self._spec_k[s] - 1) // ps, n_seq - 1)
                return max(0, last - first + 1)

            crossers = {s: _step_new_pages(s) for s in range(self.slots)
                        if self.active[s] and s not in self._prefilling
                        and _step_new_pages(s) > 0}
            short = sum(crossers.values()) - self.cache.free_pages()
            if short > 0:
                self._evict_prefix(short)
            for _ in range(self.slots):
                live = {s: n for s, n in crossers.items()
                        if self.active[s]}
                if sum(live.values()) <= self.cache.free_pages():
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
            self._spec_k[s] = 1
            self._dpos[s] = 0
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
        if self.speculate > 1:
            out["speculative"] = {
                "k": self.speculate,
                "verify_steps": self.spec_steps,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "acceptance": (self.spec_accepted / self.spec_proposed
                               if self.spec_proposed else 0.0),
            }
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
