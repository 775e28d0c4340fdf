#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (``nvcc``); it builds the port's kernels
from ``src/repro_torch/csrc`` into ``build/`` (one nvcc per source, all
started together) and exits non-zero, with no result line, when there is
no card or no port beside it.

Phases, in order (any failure raises and exits non-zero).  The ranks of
phases 16 and 17 and the CLI runs of phases 7-12, 15c and 19 are
processes of their own (``Background``): the ranks start after phase 6 and run
beside phases 7-14 of this process, the CLIs start after phase 10, three
at a time, beside phases 11-14; then their lines print, the CLIs' in
phase order, then phase 16's and 17's, and phase 15 runs alone.  Every
line of phases 7-14, of the CLIs and of phases 16-17 starts with
``[beside the background]``: its times were taken on a card and host
shared with the background, not alone:

1. the card's ``name, power.limit`` (nvidia-smi), the torch version, and
   the kernels' build time;
2. every kernel against its plain PyTorch version on the card, bit for bit
   (``torch.equal`` on integer views), dtypes float32/bfloat16/int32/int8:
   segment B1/B2 at FIELD 2/3/4/8, widths 256 and 6144, ragged row counts,
   both plan modes (the cost model's pick and the fused Benes plan,
   forced); strided B3/B5 at (stride, offset) (1,0) (2,0) (2,1) (3,1)
   (4,2) (7,5) (16,3) (64,0), windows of 96, 256 and 4096 lanes with the
   largest vl that fits, 7 and 1001 rows, and B4 with 2, 4 and 8 accesses
   of different (stride, offset); then the dynamic-count kernels on the
   same grids (bfloat16 with -0.0 and NaN lanes), each against its plain
   version AND its plan twin: B6/B7 (also at 96 lanes) against B1/B2,
   B8/B9 against B3/B5, the dynamic fused gather (one B8 per access)
   against B4; the device derivation of the dynamic network against
   ``shiftnet.layer_masks``; the source tables that B6, B7, B8 and B9
   derive once per launch (``strided.dynamic_sources``, with the SSN's,
   ``segment.deinterleave_sources`` and ``segment.interleave_sources``)
   against their torch-ops twin ``_common.dyn_sources_plain``, B7's merged
   table (read off B7 on numbered fields) against
   ``segment.interleave_dynamic_table``, and B9's list of occupied lanes
   (``strided.dynamic_merge_list``) against ``_common.merge_pairs``; and
   every kernel wrapper (B1-B14) and the ``vx`` Strided and Segment verbs
   on a transposed view and on a last-dim slice of a wider tensor, against
   the plain version (or the ``ref`` policy) on contiguous copies;
3. timings at the main path's shapes: kernel, plain version, one PyTorch
   library call computing the same function (timed here only, never used
   by the port), and the bound (bytes that must move / 3.35 TB/s).  Each
   timed call is first held bit for bit against its plain version.  B1 and
   B6 run the fused FIELD=2 KV split of qwen3-0.6b's full-width decode KV
   stack ``(28, 4, 512, 8, 256)`` bf16, B2 and B7 a 16-token prefill
   chunk's K/V beat re-pack ``(1, 16, 8, 128)`` x2 bf16 (each also its
   device time alone, in a CUDA graph, beside the library call's, its host
   path split into the ctypes call, the allocations and Python, and its
   time at the stack's bytes, B2 beside B1 and B7 beside B2; B2 and B7 of
   B1's split must give the stack back bit for bit).  The strided kernels run on that KV stack (B4's ``(2,0),
   (2,1)`` split must equal B1's FIELD=2 split bit for bit; B3, B5, B8 and
   B9 at (2,1), vl 128), then over the Fig. 12 sweep of
   benchmarks/bench_strided.py at card size (MLEN 128, vl 64, offset 0,
   stride 2..64, n = 64*stride, 256 MiB windows): B3 (with the bytes of a
   row it stages, only the 16-byte units that hold an output lane, over
   the row's bytes), B5, B8, B9 (with its SSN derivation's own time), and
   B8's derive kernel alone (one derivation per launch) with its share of
   B8's time, and a line ``fig12 s=...`` with B3 beside B8 and its bound,
   B9 and B5 over their bounds and library calls, and B5 / B9. B1 is one
   permuted copy through the table composed from the host plan, B2 one
   interleave copy through the table composed from the host plan, B3 and B4
   one staged copy each through tables composed from the host plan, B5 one
   merge copy through the list composed from the host plan; B6 and B8 a
   derive kernel and a permuted copy, B7 a derive kernel and B2's
   interleave copy, B9 a derive kernel and a merge copy;
4. qwen3-0.6b at full width (28 layers, d_model 1024, vocab 151936, seeded
   random weights) served through the port's ``Scheduler``: 4 requests of
   40-100 prompt tokens, 16 greedy tokens each, under the policies
   ``kernel``, ``ref``, ``kernel_dynamic``, ``kernel_dynamic``, ``ref``,
   ``kernel`` in that order.  The token streams must be equal; ``kernel``
   must launch B1 and B2 and no dynamic kernel, ``kernel_dynamic`` B6 and
   B7 and no plan kernel, ``ref`` none; the fused KV split must launch
   exactly once per decode step (B1 under ``kernel``, B6 under
   ``kernel_dynamic``);
5. the strided path through the port's entry points, under ``kernel``,
   ``ref`` and ``kernel_dynamic`` with every output equal: ``vx.gather`` /
   ``vx.scatter`` with a ``Strided`` spec on the KV stack, ``vx.gather_many``
   with 4 heterogeneous specs, a ``StepScheduler`` group of 4
   ``gather_strided`` requests (exactly one B4 launch under ``kernel``,
   four B8 launches under ``kernel_dynamic``), the runtime-stride bank at
   strides 3, -2 and 11 (outside the bank: the dynamic network; torch ops
   under every policy), and ``lsdo.load_strided_many`` over a 256 MiB
   buffer.  ``ref`` launches no strided kernel; ``kernel`` launches each of
   B3, B4 and B5 and no dynamic kernel; ``kernel_dynamic`` B8 and B9 and no
   plan kernel;
6. the Indexed / Compact path (kernels B10-B14, ``csrc/indexed.cu``):
   B10 (row routing) against its plain version over n 1, 2, 96, 4096 and
   16384 rows, densities 0 / 0.25 / 1, 1/2/4/8-byte rows, both directions
   (n = 1: no layer, no launch); B11-B14 against their plain versions over
   the counts of ``scg.gather_counts`` / ``scatter_counts`` at (96, 3, 1),
   (256, 2, 1), (100, 7, 5), (4095, 64, 0) and (1, 1, 0) and of
   ``compaction_counts`` / ``expansion_counts`` of random masks, and B12
   / B14 against their plan twins B11 / B13, also on random operand
   counts (where B11 must refuse the gather plans with conflicts, as the
   reference does), and B12's and B14's device source tables and unit
   lists (the derive kernel alone, on the GSN and the SSN) against
   ``_common.dyn_sources_plain`` and ``_indexed.staged_units_plain``; on
   the KV stack of phase 5 with the counts of ``gather_counts(256, 2, 1,
   128)`` / ``scatter_counts``, B12 and B11 must equal B3 on lanes [0,
   128) and 0 beyond, and ``where(occ, payload, window)`` of B14 and B13
   must equal B5, and each is timed (library call: ``torch.gather`` with
   the plan's source index plus a ``where``; B12 and B14 beside their
   derivation alone at n = 256 and 4095, a derive kernel that also lists
   the input units holding a source lane, before a staged copy that reads
   only those (B14: and also writes the occupancy); B11 and B13 beside
   the units their host operands list, one staged copy each, B13's with
   the occupancy); the Indexed gather's static-routing arm
   (``vx.gather(Indexed(n, routing=...))``, torch ops: one take through
   the plan's table and a select) must equal B11 and the layer-mask form
   there, and is timed beside that form and the library call; at
   qwen3-moe-30b-a3b's width (d_model
   2048, 128 experts, top-8; 2048- and 512-token chunks, n = 16384 and
   4096 units, one shard of 4-way expert parallelism set) ``vx.compact``
   then ``vx.scatter(Compact)`` must give ``where(mask, rows, 0)`` and the
   compact ids ``nonzero(mask)[:cap]``, and B10 is timed (library call: a
   stable sort of ``~mask``, an index and a ``where``); then the path
   through ``vx`` under ``kernel``, ``ref`` and ``kernel_dynamic`` (line
   ``indexed path: ...``): outputs equal, and per call one B12 for the
   tensor-count Indexed gather, none for the numpy-count one (plan
   stage), one B14 / B13 for the tensor- / numpy-count Indexed scatter,
   one B10 each for ``compact`` and ``scatter(Compact)``, none for the
   compact ids, plus one B11 for the direct ``kernels.shift_gather`` call
   with numpy counts; ``ref`` launches none;
7. dense serving of qwen3-0.6b at full width (weights cast once to bf16):
   (a) ``serve.engine.jit_prefill`` over 4 numpy-seeded prompts of 64
   tokens (one warm-up call, then the timed one), ``cache_from_prefill``
   into 512 bf16 beats, then 16 greedy ``jit_decode_step`` steps with
   ``ServeConfig(step_fusion=True)``, under ``kernel``, ``ref``,
   ``kernel_dynamic``, ``kernel_dynamic``, ``ref``, ``kernel``: the token
   streams must be equal, each prefill must launch B1 and B2 under
   ``kernel`` and B6 and B7 under ``kernel_dynamic`` (and nothing else),
   each decode step exactly one B1 under ``kernel``, one B6 under
   ``kernel_dynamic``, none under ``ref`` (counts zeroed just before the
   prefill and each step, read just after); the prefill ms, the median
   decode step ms and the decode tokens/s are printed with the card's
   line; (b) from empty caches, 8 steps of one numpy-seeded forced token
   stream through ``models.decode.decode_step`` and ``paged_decode_step``,
   each fused and per-access, under ``kernel`` (slots 4, page_size 16):
   every step's logits must equal the fused dense step's bit for bit; (c)
   ``python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 4
   --prompt-len 64 --gen 16 --max-len 512`` in a subprocess must exit 0,
   with every request finished and its tok/s line naming the card;
8. the quantized page pool and prefix sharing through the port's paged
   ``Scheduler`` at full width (weights cast once to bf16; slots 4,
   max_len 512, page_size 16, 16 greedy tokens): (a) ``kv_quant="int8"``,
   then ``"fp8"``, on phase 4's prompts under ``kernel``, ``ref`` and
   ``kernel_dynamic``: streams equal, exactly one fused split per decode
   step (B1, B6, none; B1 / B6 split the float32 dequantized stack),
   tokens/s, the median step, ``used_cache_bytes`` at the peak beside the
   float32 pool's and the page's bytes beside the prediction from the
   geometry (the int8 page must equal it); (b) 8 forced-teacher steps of
   the int8 pool against the float32 pool under ``kernel``: the worst
   logit gap within the reference's bound ``max(0.08, 0.03 *
   |logits|max)``; (c) ``prefix_cache=True, chunk_pages=2`` on staggered
   traffic (4 requests of one 64-token seeded prefix and distinct 24-token
   tails, one tail repeating the first 8 tokens of another's fifth page;
   request 0 alone until its prefill has published), on the float32 pool
   and then the int8 pool, under ``kernel``: streams equal to the same
   traffic with the cache off, trie hits > 0 and at least one fork; the
   trie's stats, the pages shared at the peak and the fork count printed;
   (d) the CLI with ``--kv-dtype int8 --prefix-cache --chunk-pages 2
   --check-invariants`` in a subprocess: exit 0, every request finished;
   (e) B1 timed on the float32 stack ``(28, 4, 512, 8, 256)`` beside its
   bound and its library call (line ``time deinterleave[f32 stack]``);
9. the chaos harness and the replica fleet at full width (weights cast
   once to bf16): (a) ``run_plan`` of ``FaultPlan(ChaosConfig(seed, 6
   requests, 32 steps, 256 ticks))`` over one ``Scheduler`` on the
   reference's chaos geometry (slots 2, max_len 16, page_size 4, 6 pages,
   queue depth 3, NaN guard on, a ``StepWatchdog``, a ``StepClock``):
   seed 0 under ``kernel``, ``ref`` and ``kernel_dynamic`` with reports
   and streams equal, seeds 1-2 under ``kernel``, then seed 0 with
   ``prefix_cache=True, chunk_pages=2, p_evict=0.15`` and at
   ``kv_quant="int8"``; every request terminal, drained under the tick
   cap, the pool audited every tick, one fused split per decode step (B1,
   B6, none); (b) the NaN guard on the reference's traffic: the victim
   alone fails, the neighbour's stream equals its solo stream; (c)
   migration at the serve size (2 replicas of phase 4's geometry, phase
   4's prompts, ``kernel``): the replica holding request 0 killed
   mid-decode, then again once the moved requests have each made a new
   token; streams equal to the uninterrupted 1-replica run, the largest
   logit gap at the shared positions, the recovery of each moved request
   in ticks and ms to its first new token, ``memory_allocated`` before the
   kill and after each respawn (must not grow); (d) fleet chaos,
   ``FleetFaultPlan(FleetChaosConfig(seed=0, replicas=3))`` on the test
   geometry (slots 2, max_len 16, page_size 4, ``StepClock``, hard limit
   30 s, one breach to degrade, guard on) under the three policies:
   reports and streams equal, the audit every tick, every death injected
   (none ``tick crashed``), one fused split in every decode step of every
   replica, dead ones included; (e) whole-run tokens/s of a 3-replica
   fleet without faults on phase 4's prompts beside one scheduler's
   (single, fleet, fleet, single; streams equal); (f) the CLI's fault
   modes at full width in subprocesses (``--chaos 5 ... --prefix-cache``,
   ``--replicas 3 --kill-replica 4``, ``--replicas 3 --chaos 0``,
   ``--replicas 2 --chaos 7 --kv-dtype int8``): exit 0, every request
   terminal, the chaos runs' terminal-state line printed;
10. speculative decode (K = 4) and ``vx.scatter_many`` at full width
   (bf16, phase 4's geometry and prompts, 16 greedy tokens): (a)
   ``models.decode.paged_verify_step`` fed the plain ``paged_decode_step``
   oracle's stream as drafts, then those drafts corrupted (a reject-all
   round; slot 0 rejected exactly on a page boundary, whose page must be
   back on the free stack; rejections in slots 1-3), under ``kernel``,
   ``ref`` and ``kernel_dynamic``: commits and streams equal across the
   policies, ``paged_invariants`` clean every round, the launches of
   every verify step as predicted from the code (one fused split, and per
   layer the (B, K) beat split and re-pack and the GLU split when their
   sizes reach the launch threshold), the committed streams equal to the
   oracle's with K tokens a launch on perfect drafts and 1 on the
   reject-all round, the largest logit gap to the oracle printed; a
   greedy flip prints its position, the plain run's top-2 margin there
   and the gap, and the gate then runs in float32 compute; (b) the
   speculative ``Scheduler`` with two drafts, the target's own weights
   and seed 1's, under the three policies: streams equal to the plain
   scheduler's (in float32 compute after a bf16 flip), the speculative
   stats, the launches of every verify step and draft step as predicted,
   each prefill chunk's launches, whole-run tokens/s beside the plain
   scheduler's; (c) the int8 pool under speculation with the pool audited
   after every mutation: every request finished; (d) ``vx.scatter_many``
   at the KV stack, 28 groups of ``(4, 512, 8, 128)`` x2 bf16: one B2 / B7
   launch a call, equal bit for bit to the plain version and to the
   per-group ``interleave``, timed beside B2 on the same bytes; (e) the
   CLI with ``--speculate 4 --stats`` at full width and CI's speculative
   fleet chaos smoke (``--replicas 3 --chaos 0 --kv-dtype int8
   --speculate 4 --stats``) in subprocesses: exit 0 and a
   ``speculative:`` line;
11. model families at full width through the port's ``Scheduler``
   (seeded random weights cast once to bf16, the router float32; before
   each cell the parameter count and bytes predicted from the config's
   shapes, after init ``param_count`` held against the prediction and
   ``max_memory_allocated`` beside it; every run's wall seconds): (a)
   gemma3-12b, depth cut from 48 to 6 layers (one 5 local : 1 global
   superblock, window 1024; B1 and B6 first held bit for bit on its GLU
   split, 30720 lanes, whose rows the wrappers fold into chunks that fit
   the copy's shared memory), 2 slots, max_len 2048, page_size 16, 2
   numpy-seeded prompts of 1600-1800 tokens, 16 greedy tokens, under
   ``kernel``, ``ref`` and ``kernel_dynamic``: streams equal, in every
   decode step one fused split and the 6 GLU splits that reach the launch
   threshold (B1, B6, none; as ``verify_prediction`` reads
   ``paged_decode_step``), and the dense engine's banded
   prefill and ring-cache decode steps against the paged cache's chunks
   and steps on the same tokens, the largest logit gap within ``max(0.08,
   0.03 * |logits|max)``; (b) starcoder2-3b at its published geometry (30
   layers, GELU MLP, 2 KV heads) on phase 4's traffic (its vocabulary)
   under the three policies with phase 4's gates; (c) qwen3-moe-30b-a3b,
   depth cut from 48 to 4 layers (128 experts, top-8), phase 4's traffic
   under ``kernel``, ``ref``, ``kernel_dynamic`` and ``kernel`` again
   (the two kernel runs' streams equal: the MoE combine is deterministic
   on CUDA), and one MoE layer alone at the decode step's shape (CUDA
   events, host clock, host syncs a call); (d) the CLI with ``--smoke``
   for llava-next-mistral-7b, granite-34b and phi3.5-moe in
   subprocesses: exit 0, every request finished.

12. the recurrent and hybrid models (phase 4's geometry: 4 slots,
   max_len 512, page_size 16, 16 greedy tokens): (a) xlstm-125m uncut
   (12 layers, d_model 768, 167 349 544 parameters, predicted from the
   config's shapes and checked against ``param_count``, with
   ``max_memory_allocated``), bf16, phase 4's traffic in its vocabulary
   under ``kernel``, ``ref`` and ``kernel_dynamic``: streams equal, no
   segment launch in any decode step (a stack without attention, as
   ``verify_prediction`` reads it), ``used_cache_bytes`` 94 717 056 (the
   reference's) after every tick, tokens/s and the median step; then the
   dense ``jit_prefill`` of 4 x 64 tokens and 8 forced dense decode steps
   against paged prefill chunks and steps, in float32 the largest logit
   gap within ``max(0.08, 0.03 * |logits|max)`` (in bf16 printed beside
   how far one ulp of one weight moves the logits: about their own size,
   so no bf16 gate can hold); (b) jamba's Mamba layer alone at
   its published widths (d_model 8192, ed 16384, N 16, conv 4, rank 512;
   one superblock of 8 layers holds 44 701 474 816 parameters, over the
   card): the forward over (2, 1024, 8192) and 16 decode steps from its
   cache in bf16, timed with CUDA events and the host clock, and in
   float32 the forward's final state and conv window against 1024 decode
   steps from zero, each within 1e-4 of its largest magnitude (the bf16
   gap printed); (c) jamba-smoke (float32) through the paged scheduler
   under the three policies with the pool audited at every mutation: B1 /
   B6 and B2 / B7 bit for bit at its shapes first, streams equal, the
   fused split of its attention layer once per decode step (B1, B6,
   none); (d) the CLI for xlstm-125m at full width, jamba with
   ``--smoke``, and xlstm with ``--smoke --replicas 3 --chaos 0``:
   exit 0, every request finished (terminal, for the chaos run).

13. the encoder-decoder through the dense path: (a) whisper-tiny uncut (4
   + 4 layers, d_model 384, 36 479 232 parameters, predicted from the
   config's shapes and checked against ``param_count``, with
   ``max_memory_allocated``), float32 params cast once to bf16; B1 / B6
   and B2 / B7 first held bit for bit in bf16 at its shapes (the
   encoder's split ``(4, 1500, 6, 128)``, the prefill's ``(4, 32, 6,
   128)`` and a step's ``(4, 1, 6, 128)``, the re-packs ``(4, 32, 6, 64)``
   and ``(4, 1, 6, 64)`` x2); numpy-seeded frames ``(4, 1500, 384)`` and 4
   prompts of 32 tokens under ``kernel``, ``ref`` and ``kernel_dynamic``:
   ``encdec.encode`` alone, ``jit_prefill``, ``cache_from_prefill`` into
   64 bf16 beats, ``precompute_enc_kv``, 16 greedy ``jit_decode_step``
   steps, each call timed (CUDA events and the host clock) with the
   counts zeroed just before it and read just after, the (split, pack)
   launches equal to those read off models/encdec.py (per encode (4, 0),
   per prefill (12, 4), per ``enc_kv`` (4, 0), per step (4, 4); none under
   ``ref``); streams equal; the prefill's and steps' logits against a
   teacher-forced ``forward`` over the 48-token sequence within ``max(0.08,
   0.03 * |logits|max)``; (b) the paged ``Scheduler`` and
   ``BatchedServer`` refuse whisper with the reference's message and
   ``python -m repro_torch.launch.serve --arch whisper-tiny`` exits
   non-zero with the reference's text;
14. training on one card, under ``ref`` (the hand-written kernels have no
   backward): (a) qwen3-0.6b at full width (596 049 920 parameters) on
   the ``train_4k`` cell's 4096-token sequences, its global batch of 256
   cut to 4 sequences as 2 microbatches of 2: 3 ``jit_train_step`` steps
   with the default ``AdamWConfig``, with compression ``none`` and then
   ``int8``, each step's loss, grad norm, lr, ms and tokens/s, the
   predicted state bytes beside ``max_memory_allocated`` (split per step
   into the peak up to the AdamW update and the peak within it); each run
   trains its own seeded params (a step updates its state in place); loss
   and grad norm finite, the norm above 0; the reference's smoke gate at
   full width (one SGD step at lr 1e-2 on one microbatch lowers the loss
   along the step, tests/test_smoke_archs.py:43-65); (b) one whisper-tiny step
   (frames ``(2, 1500, 384)``, 64 tokens) with the same gates; (c) the
   flash backward in float32 at ``(1, 4096, 16, 128)`` with 8 KV heads
   causal, the same with a 1024 window, and the encoder's non-causal
   1500 x 1500 (6 heads of 64): ``dq``, ``dk``, ``dv`` within 1e-4 of their
   largest magnitudes against autograd through the plain unchunked
   softmax, the forward's and backward's ms; (d) under ``kernel`` a
   training forward with gradients on raises at the first ``vx`` verb and
   no gradient reaches the params; (e) qwen3-0.6b-smoke in float32: loss
   and gradients on the card within 1e-4 relative of the port's own
   ``device="cpu"`` run.  A script that imports ``chip_smoke``, builds
   ``_common.SOURCES`` and calls ``encdec_train_phase(dev, card)`` runs
   phases 13 and 14 alone;
15. the training launcher's substrate on one card: (a) the data pipeline
   at ``train_4k``'s shape, uncut (``DataConfig(vocab=151936,
   seq_len=4096, global_batch=256)``, the AoS buffer ``(256, 16384)``
   int32): under ``kernel``, ``kernel_dynamic`` and ``ref``,
   ``next_host_aos`` equal to a numpy interleave of the pipeline's fields,
   ``unpack_records`` equal to the fields, ``next_batch(fused=True)``
   equal to ``next_batch(fused=False)`` over 2 steps with equal states,
   the counts zeroed before each call and read after it: one B2 (B7) per
   pack, one B1 (B6) per unpack, one of each per unfused batch, none
   under ``ref`` nor on the fused path; B1 / B6 / B2 / B7 bit for bit
   against their plain versions at int32 with 4 fields at ``(256,
   16384)`` / 4 x ``(256, 4096)`` and at the CLI's ``(4, 2048)`` / 4 x
   ``(4, 512)``; pack and unpack timed (CUDA events, and in a CUDA graph)
   beside their byte bound and the library calls; (b) a checkpoint round
   trip of qwen3-0.6b's full train state (7 152 599 044 B) after one
   ``ref`` train step at (1, 512): ``save(blocking=False)``, ``wait``,
   ``restore`` into a state from another seed, every leaf bit for bit on
   the card; the snapshot, write and restore times and the bytes on disk
   (under ``build/``, deleted after); (c) the training CLI in
   subprocesses: qwen3-0.6b at full width under ``REPRO_TORCH_VX_IMPL=ref``
   (6 steps of 4 x 512 tokens; finite losses, ms per step and tokens/s
   from its lines), its refusal under the default ``kernel`` policy (exit
   non-zero with the kernels' gradient guard), ``--mesh single-pod``
   (exit non-zero: a world of one process cannot hold the (16, 16) mesh,
   ``make_mesh``'s ``ValueError``), and at smoke size a 9-step run with a
   checkpoint every 3 steps and its resume from step 6, whose final
   losses agree within 1e-5 relative; (d) ``core/rcvrf`` on the card
   against the CPU bit for bit over every (block, byte, count) of the
   reference test's spec.  ``launcher_phase(dev, card)`` runs (a), (b)
   and (d) alone, ``cli_cell(card)`` (c).
16. sharded serving, as 4 ranks of one ``gloo`` group spawned with
   ``torch.multiprocessing``, every rank on ``cuda:0`` (one card; NCCL
   refuses two ranks on one GPU), so every collective time is ``gloo``
   through host memory on one card: (16.0) which collectives take CUDA
   tensors, and a 64 MiB ``all_reduce``; (a) the sharded ``vx`` verbs on
   meshes (4,) and (2, 2) under ``kernel``, ``kernel_dynamic`` and
   ``ref``, bit for bit against the same verb run unsharded in one
   process: the segment pair on the KV stack sharded on its sequence
   (B1 / B2, B6 / B7 on each rank's block), the lane-sharded strided
   gather / scatter at n = 4096, vl 512 over the reference's (stride,
   offset) list scaled by 64 from its n = 64 (B3 / B5, B8 / B9), the
   page gather of phase 4's pool sharded on
   its page axis in bf16 and int8 with scales (full, partial, unallocated
   tables), each timed (CUDA events); (b) qwen3-0.6b's paged decode with
   the pool placed as a ``DTensor`` on (4,) (32 of 128 pages a rank):
   phase 4's prompts prefilled replicated, 16 greedy ``paged_decode_step``
   s with ``pool_shard`` under ``kernel`` and ``ref``, logits and streams
   bit for bit against rank 0's replicated step; (c) long-context decode
   (``long_500k``, 524 288 -> 32 768 positions, B 1, len 16384, seeded
   noise) on (2, 2) through ``jit_decode_step(long_context=True)``,
   weights placed by ``serve_param_shardings``: 8 greedy steps fused and
   per-access in bf16 (bit for bit; no collective of a cache-sized
   operand; fused B1 1 a step against 84) with the greedy stream of rank
   0's one-process step (the bf16 logit gap printed beside ``max(0.08,
   0.03 * |logits|max)``, and beside how far one ulp of one weight moves
   rank 0's step-0 bf16 logits), then 4 fused steps in float32 compute,
   within the reference's rtol = atol = 3e-3 of rank 0's one-process step
   with equal streams; (d) qwen3-moe-30b-a3b's MoE layer expert-parallel
   on (2, 2) against rank 0's one-process layer, within 1e-2 *
   max(1, |y|max), after every rank found no unit dropped at its
   ``capacity_slack``.  Each rank's
   launches of the sharded runs join the kernels' line.
   ``sharded_phase(card_line())`` runs it alone.  The decoders' layers
   run tensor-parallel on each rank's model-axis blocks: 16c, 17a, 17d
   and 17e fail if a collective or a packed gather moves a model-axis
   weight (whole or a rank's block), and print their collectives, bytes
   and host seconds beside the earlier gathers' figures.
17. sharded training, in phase 16's spawn (the same 4 ranks on
   ``cuda:0`` under ``gloo``): (17.0) GPipe's hand-off on CUDA tensors,
   ``dist.sharding.ppermute``'s ``all_to_all_single`` with one peer's
   split (point-to-point sends abort here, ``tools/gloo_p2p_probe.py``),
   checked and a 32 MiB one timed; (a)
   qwen3-0.6b ZeRO-1 training at full width and depth on (2, 2) = (data,
   model), 4 x 512 seeded tokens (15c's cut of ``train_4k``), ``ref``:
   2 bf16-compute steps gated as the reference's
   ``check_sharded_train_step`` gates its own, with each step's ms,
   collectives, bytes and host seconds, a rank's param and moment bytes
   and its peak memory; then one float32-compute step against rank 0's
   one-process step on the same state and batch (loss rtol 1e-4, grad
   norm rtol 1e-3, every param within 2 lr, at most 1e-3 of them beyond
   0.1 lr); (b) GPipe on (2, 1, 2) = (pod, data, model), 2 stages, 2
   microbatches, loss and backward: the loss within the reference's
   rtol 2e-3 of rank 0's one-process ``loss_fn``, every rank's stage
   gradient finite and nonzero; (c) 17a's params saved from (2, 2) and
   restored onto (1, 4), bit for bit; (d) the batch-sharded decode on
   (2, 2): ``jit_prefill`` under the mesh, 4 greedy batch-sharded
   ``jit_decode_step`` s under ``kernel`` and ``ref`` (bit for bit; one
   B1 launch a step on every rank under ``kernel``, on its cache block),
   B1 on a rank's block against its plain version, the streams against
   rank 0's one-process steps (a bf16 flip on a near-tie printed with its
   margin and gap, the streams then gated by a float32 arm of prefill
   and steps); (f) whisper-tiny's batch-sharded decode,
   uncut, 4 seeded frame stubs and prompts of 32: 8 greedy steps on
   (2, 2) (head-parallel) and (1, 4) (the ring's and ``enc_kv``'s
   sequence split, the distributed softmax) under ``kernel`` and ``ref``
   (bit for bit; B1 and B2 once per layer a step on every rank under
   ``kernel``), streams equal to rank 0's one-process steps, a
   float32-compute arm within the reference's rtol = atol = 3e-3, then
   its tensor-parallel mesh loss on (2, 2) in float32 against rank 0's
   one process (rtol 1e-4, no model-axis weight gathered); (g) (a)
   jamba's Mamba position alone at its published widths on (1, 4) and
   (2, 2), channel-parallel: the float32 output and every gradient leaf
   of ``sum(y * probe)`` within 1e-4 of rank 0's one-process layer's
   largest entries, a prefill and 4 decode steps on the rank's state
   block likewise, a rank's 1/m of the weight and state bytes, no
   collective of a Mamba weight's shape, the bf16 gap printed, and bf16
   decode steps timed with the row-parallel products as one GEMM with a
   float32 output and with their operands copied to float32; (b)
   xlstm-125m uncut on (2, 2), the mLSTM head-parallel and the sLSTM
   channel-parallel on the rank's weight blocks (1/2 of the cells'
   placed bytes, no collective of a model-axis weight's shape): the
   float32 mesh loss on 4 x 128 tokens within 2e-3 of rank 0's one
   process, its loss and every gradient leaf on 4 x 8 within 2e-3 (over
   more tokens xlstm amplifies the row-parallel sums' ulps past any
   bound), the float64 partition arm (4 x 32 tokens, loss and every
   gradient leaf) within 1e-9,
   8 batch-sharded greedy steps on the rank's block of the state (placed
   as ``cache_specs`` says, 1/4 of the bytes a rank: its batch and its
   heads or channels), float32 logits within 2e-3 and streams equal to
   one process, bf16 streams printed, each step's collectives and bytes
   beside PR 34's;
   (e) last, once the main process has left the card (its
   ``Background.join``): qwen3-moe-30b-a3b expert-parallel ZeRO-1
   training at published widths, 1 of 48 layers, 4 x 256 tokens, on
   (2, 2): a rank's banks resident (half their bytes, no collective of a
   bank's shape), one bf16 step, then one float32 step against rank 0's
   one-process step with its MoE layers as ``expert_parallel_plain``
   computes them (17a's tolerances).  17d's and 17f's launches under
   ``kernel`` (17d's prefill's too) join the kernels' line.
   ``training_phase(card_line())`` runs it alone.
18. the roofline (``repro_torch.roofline``, ``hw.H100_SXM``): phase 14a's
   one-process train step and 17a's mesh step each run once more under
   ``bundle_from_trace`` (FLOPs, bytes, collective bytes), printed over
   the card's peaks beside the measured step and 6ND; and one
   ``python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape
   train_4k`` subprocess (first in the background's CLI queue), which
   must exit 0 and trace at most 5.7e13 FLOPs a rank (1/8 of the count
   before tensor parallelism).
19. the twins of ``examples/*.py`` (``examples_torch/``), each in a
   subprocess on the card under a driver that prints every kernel
   wrapper's launches, queued on the background beside phases 11-14:
   ``quickstart`` (its kernel deinterleave and AoS unpack lines; B1, B2,
   B3 and B5 launched, no other kernel), ``moe_dispatch_demo``
   (``conflict-free routing: True``, ``vx.compact agrees: True``; no
   kernel), ``serve_batch`` (pages after finish all free, as before the
   requests; B1 and B2) and ``train_100m --steps 100`` (finite losses,
   its step-100 checkpoint restored bit for bit, the LEARNING / check
   setup verdict printed; no kernel); their launches join the kernels'
   line.

The line before the last is the kernels' JSON record, fourteen kernels
(launches: the serve runs' for B1/B2 under ``kernel`` and B6/B7 under
``kernel_dynamic``, joined by phase 10's speculative scheduler runs and
``scatter_many`` call, phases 11's and 12's scheduler runs, phase 13's
whisper calls, phase 15a's data-path calls, phase 16's ranks and phase
17d's and 17f's under the same policies, phase 19's twins; the strided path's (and phase 16's) for
B3/B4/B5 under ``kernel`` and B8/B9 under ``kernel_dynamic``, the
indexed path's under ``kernel`` for B10-B14; phases 7 and 8 print their
own launches per prefill and per decode step); the last line is
``{"ok": true, "device": {...}}``.
``--profile`` adds, after phase 4, one
torch.profiler-traced serve run per policy and the operators whose host
and device times differ most between the ``kernel`` and ``ref`` runs,
and after phase 7a the same for one traced dense prefill and its 16
decode steps per policy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
SOURCES = {"deinterleave": "src/repro_torch/csrc/segment.cu",
           "interleave": "src/repro_torch/csrc/segment.cu",
           "gather_strided": "src/repro_torch/csrc/strided.cu",
           "gather_strided_fused": "src/repro_torch/csrc/strided.cu",
           "scatter_strided": "src/repro_torch/csrc/strided.cu",
           "deinterleave_dynamic": "src/repro_torch/csrc/segment.cu",
           "interleave_dynamic": "src/repro_torch/csrc/segment.cu",
           "gather_strided_dynamic": "src/repro_torch/csrc/strided.cu",
           "scatter_strided_dynamic": "src/repro_torch/csrc/strided.cu",
           "route_rows": "src/repro_torch/csrc/indexed.cu",
           "shift_gather_static": "src/repro_torch/csrc/indexed.cu",
           "shift_gather": "src/repro_torch/csrc/indexed.cu",
           "shift_scatter_static": "src/repro_torch/csrc/indexed.cu",
           "shift_scatter": "src/repro_torch/csrc/indexed.cu"}
REPLACES = {"deinterleave": "src/repro/kernels/segment.py:85",
            "interleave": "src/repro/kernels/segment.py:156",
            "gather_strided": "src/repro/kernels/strided.py:27",
            "gather_strided_fused": "src/repro/kernels/strided.py:73",
            "scatter_strided": "src/repro/kernels/strided.py:132",
            "deinterleave_dynamic": "src/repro/kernels/segment.py:93",
            "interleave_dynamic": "src/repro/kernels/segment.py:164",
            "gather_strided_dynamic": "src/repro/kernels/strided.py:33",
            "scatter_strided_dynamic": "src/repro/kernels/strided.py:143",
            "route_rows": "src/repro/kernels/moe_compact.py:32",
            "shift_gather_static": "src/repro/kernels/shift_gather.py:30",
            "shift_gather": "src/repro/kernels/shift_gather.py:22",
            "shift_scatter_static": "src/repro/kernels/shift_scatter.py:20",
            "shift_scatter": "src/repro/kernels/shift_scatter.py:51"}
STRIDED_SO = ((1, 0), (2, 0), (2, 1), (3, 1), (4, 2), (7, 5), (16, 3),
              (64, 0))
HETERO = ((2, 0), (3, 1), (7, 5), (4, 2))
WINDOW_BYTES = 1 << 28      # a Fig. 12 window, and the LSDO buffer: 256 MiB
# (n, stride, offset) of the B11-B14 grid: widths that are not powers of
# two, a 4095-lane network of 12 layers, and one lane (no layer)
INDEXED_GEOM = ((96, 3, 1), (256, 2, 1), (100, 7, 5), (4095, 64, 0),
                (1, 1, 0))
# qwen3-moe-30b-a3b (src/repro/configs/qwen3_moe_30b.py): d_model 2048,
# 128 experts, top-8; one shard of 4-way expert parallelism
MOE_D, MOE_EXPERTS, MOE_TOP_K, MOE_SHARDS = 2048, 128, 8, 4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def int_view(t):
    import torch
    return t.contiguous().view({1: torch.int8, 2: torch.int16,
                                4: torch.int32,
                                8: torch.int64}[t.element_size()])


def same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(int_view(a), int_view(b))


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph, so that a call shorter than its host dispatch is timed on the
    device and not at the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev) -> int:
    import torch
    from repro_torch.core import shiftplan
    from repro_torch.kernels import segment
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def rand(shape, dtype):
        if dtype in (torch.int32, torch.int8):
            return torch.randint(-100, 100, shape, generator=g, device=dev,
                                 dtype=dtype)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int8):
        for fields in (2, 3, 4, 8):
            for rows, width in ((7, 6144), (1001, 256)):
                m = width // fields          # fields=3 at 256 lanes: 255
                n = fields * m
                for mode in ("picked", "fused"):
                    dp = ip = None
                    if mode == "fused":
                        dp = ("fused", (shiftplan.deinterleave_plan(n,
                                                                    fields),))
                        ip = ("fused", (shiftplan.interleave_plan(n,
                                                                  fields),))
                    aos = rand((rows, n), dtype)
                    got = segment.deinterleave(aos, fields, plans=dp)
                    want = segment.deinterleave_plain(aos, fields, plans=dp)
                    torch.cuda.synchronize()
                    soa = [rand((rows, m), dtype) for _ in range(fields)]
                    got_i = segment.interleave(soa, plans=ip)
                    want_i = segment.interleave_plain(soa, plans=ip)
                    torch.cuda.synchronize()
                    where = f"{dtype} fields={fields} n={n} rows={rows} {mode}"
                    if not all(same_bits(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"B1 deinterleave != plain: "
                                             f"{where}")
                    if not same_bits(got_i, want_i):
                        raise AssertionError(f"B2 interleave != plain: "
                                             f"{where}")
                    cases += 1
    return cases


def check_strided(dev) -> int:
    """B3, B4 and B5 against their plain versions over the strided grid."""
    import torch
    from repro_torch.kernels import strided
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)

    def rand(shape, dtype):
        if dtype in (torch.int32, torch.int8):
            return torch.randint(-100, 100, shape, generator=g, device=dev,
                                 dtype=dtype)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int8):
        for n in (96, 256, 4096):
            for rows in (7, 1001):
                where = f"{dtype} n={n} rows={rows}"
                win = rand((rows, n), dtype)
                for s, o in STRIDED_SO:
                    vl = (n - 1 - o) // s + 1       # the largest that fits
                    vals = rand((rows, vl), dtype)
                    got = strided.gather_strided(win, s, o, vl)
                    want = strided.gather_strided_plain(win, s, o, vl)
                    got_s = strided.scatter_strided(win, vals, s, o)
                    want_s = strided.scatter_strided_plain(win, vals, s, o)
                    torch.cuda.synchronize()
                    if not same_bits(got, want):
                        raise AssertionError(f"B3 gather_strided != plain: "
                                             f"{where} ({s}, {o}) vl={vl}")
                    if not same_bits(got_s, want_s):
                        raise AssertionError(f"B5 scatter_strided != plain: "
                                             f"{where} ({s}, {o}) vl={vl}")
                    cases += 1
                for A in (2, 4, 8):
                    pairs = [STRIDED_SO[(a * 3 + A) % len(STRIDED_SO)]
                             for a in range(A)]
                    vl = min((n - 1 - o) // s + 1 for s, o in pairs)
                    wins = rand((A, rows, n), dtype)
                    got = strided.gather_strided_fused(wins, pairs, vl)
                    want = strided.gather_strided_fused_plain(wins, pairs, vl)
                    torch.cuda.synchronize()
                    if not same_bits(got, want):
                        raise AssertionError(f"B4 gather_strided_fused != "
                                             f"plain: {where} {pairs}")
                    cases += 1
    return cases


def check_dynamic(dev) -> int:
    """B6-B9 against their plain versions and their plan twins (B1/B2,
    B3/B5, B4 for the dynamic fused gather), bit for bit, the device
    derivation against ``shiftnet.layer_masks``, and the device source
    tables of B6 and B8 against ``_common.dyn_sources_plain``."""
    import numpy as np
    import torch
    from repro_torch.core import scg, shiftnet
    from repro_torch.kernels import _common, segment, strided
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 6)

    def rand(shape, dtype):
        if dtype in (torch.int32, torch.int8):
            return torch.randint(-100, 100, shape, generator=g, device=dev,
                                 dtype=dtype)
        x = torch.randn(shape, generator=g, device=dev)
        x.view(-1)[::7] = -0.0
        x.view(-1)[3::11] = float("nan")
        return x.to(dtype)

    def held(got, plain, twin, what):
        torch.cuda.synchronize()
        for name, want in (("plain", plain), ("plan twin", twin)):
            want = want if isinstance(want, list) else [want]
            got_l = got if isinstance(got, list) else [got]
            if len(got_l) != len(want) or not all(
                    same_bits(a, b) for a, b in zip(got_l, want)):
                raise AssertionError(f"{what} != {name}")

    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int8):
        for fields in (2, 3, 4, 8):
            for rows, width in ((7, 6144), (1001, 256), (5, 96)):
                m = width // fields
                n = fields * m
                where = f"{dtype} fields={fields} n={n} rows={rows}"
                aos = rand((rows, n), dtype)
                held(segment.deinterleave(aos, fields, fused=False),
                     segment.deinterleave_dynamic_plain(aos, fields),
                     segment.deinterleave(aos, fields), f"B6 {where}")
                soa = [rand((rows, m), dtype) for _ in range(fields)]
                held(segment.interleave(soa, fused=False),
                     segment.interleave_dynamic_plain(soa),
                     segment.interleave(soa), f"B7 {where}")
                cases += 1
        for n in (96, 256, 4096):
            for rows in (7, 1001):
                win = rand((rows, n), dtype)
                for s, o in STRIDED_SO:
                    vl = (n - 1 - o) // s + 1
                    where = f"{dtype} n={n} rows={rows} ({s}, {o}) vl={vl}"
                    held(strided.gather_strided(win, s, o, vl,
                                                compiled=False),
                         strided.gather_strided_dynamic_plain(win, s, o, vl),
                         strided.gather_strided(win, s, o, vl),
                         f"B8 {where}")
                    vals = rand((rows, vl), dtype)
                    held(strided.scatter_strided(win, vals, s, o,
                                                 compiled=False),
                         strided.scatter_strided_dynamic_plain(win, vals, s,
                                                               o),
                         strided.scatter_strided(win, vals, s, o),
                         f"B9 {where}")
                    cases += 1
                pairs = HETERO
                vl = min((n - 1 - o) // s + 1 for s, o in pairs)
                wins = rand((len(pairs), rows, n), dtype)
                got = strided.gather_strided_fused(wins, pairs, vl,
                                                   compiled=False)
                held(got, torch.stack([strided.gather_strided_dynamic_plain(
                    wins[a], s, o, vl) for a, (s, o) in enumerate(pairs)]),
                    strided.gather_strided_fused(wins, pairs, vl),
                    f"B8 x{len(pairs)} {dtype} n={n} rows={rows}")
                cases += 1
    for n, s, o in ((96, 3, 1), (256, 2, 1), (4096, 64, 0), (1, 1, 0)):
        vl = (n - 1 - o) // s + 1
        for gather in (True, False):
            masks, occ = strided.dynamic_masks(n, s, o, vl, gather=gather,
                                               blocks=3, device=dev)
            counts = scg.gather_counts if gather else scg.scatter_counts
            shift, valid = counts(n, s, o, vl)
            want, want_occ = shiftnet.layer_masks(
                shift, valid, toward_zero=gather, lsb_first=gather)
            packed = (_common.pack_bits(want.numpy()).view(np.int32)
                      if want.shape[0] else
                      np.zeros((0, -(-n // 32)), np.int32))
            if not (np.array_equal(masks.cpu().numpy(), packed)
                    and np.array_equal(occ.cpu().numpy(), _common.pack_bits(
                        want_occ.numpy()[None]).view(np.int32)[0])):
                raise AssertionError(f"device derivation != layer_masks: "
                                     f"n={n} ({s}, {o}) gather={gather}")
            cases += 1
    # the source tables B6, B8 and B9 derive once per launch, and B9's list
    # of occupied lanes
    for n in (1, 96, 256, 4096):
        for s, o in STRIDED_SO:
            if o >= n:
                continue
            vl = (n - 1 - o) // s + 1
            for gather in (True, False):
                counts = scg.gather_counts if gather else scg.scatter_counts
                want = _common.dyn_sources_plain(*counts(n, s, o, vl),
                                                 gsn=gather)
                got = strided.dynamic_sources(n, s, o, vl, gather=gather,
                                              device=dev)
                if not torch.equal(got.cpu(), want[:vl] if gather else want):
                    raise AssertionError(f"device source table != twin: "
                                         f"n={n} ({s}, {o}) gather={gather}")
                cases += 1
            table, raw = strided.dynamic_merge_list(n, s, o, vl, device=dev)
            raw = raw.cpu()
            k = int(raw[0])
            if not (torch.equal(table.cpu(), want) and k == vl and
                    torch.equal(raw[1:1 + 2 * k].view(k, 2),
                                _common.merge_pairs(want))):
                raise AssertionError(f"B9 device list != merge_pairs: n={n} "
                                     f"({s}, {o}) vl={vl}")
            cases += 1
    for width in (6144, 256, 96):
        for fields in (2, 3, 4, 8):
            m = width // fields
            n = fields * m
            want = torch.stack([_common.dyn_sources_plain(
                *scg.gather_counts(n, fields, f, m), gsn=True)[:m]
                for f in range(fields)])
            if not torch.equal(segment.deinterleave_sources(
                    n, fields, device=dev).cpu(), want):
                raise AssertionError(f"B6 source tables != twin: n={n} "
                                     f"fields={fields}")
            # B7: the fields' SSN tables, and the merged table its copy
            # composes, read off B7 on fields numbered 1 + f*m + j
            want = torch.stack([_common.dyn_sources_plain(
                *scg.scatter_counts(n, fields, f, m), gsn=False)
                for f in range(fields)])
            ids = [torch.arange(1 + f * m, 1 + (f + 1) * m, device=dev,
                                dtype=torch.int32).expand(3, m).contiguous()
                   for f in range(fields)]
            merged = segment.interleave(ids, fused=False).cpu() - 1
            if not (torch.equal(segment.interleave_sources(
                    n, fields, device=dev).cpu(), want) and torch.equal(
                    merged, torch.from_numpy(segment.interleave_dynamic_table(
                        n, fields)).expand(3, n))):
                raise AssertionError(f"B7 source tables != twin: n={n} "
                                     f"fields={fields}")
            cases += 2
    return cases


def check_views(dev) -> int:
    """Every kernel wrapper (B1-B14) and the ``vx`` Strided and Segment
    verbs on non-contiguous CUDA operands (a transposed view, and the
    first lanes of a tensor 24 lanes wider), held bit for bit against the
    plain version (or the ``ref`` policy) on ``.contiguous()`` copies."""
    import numpy as np
    import torch
    from repro_torch import vx
    from repro_torch.core import scg, shiftnet
    from repro_torch.kernels import (moe_compact, segment, shift_gather,
                                     shift_scatter, strided)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)
    dt, R, n = torch.bfloat16, 300, 256
    vl = n // 2

    def view(kind, shape):
        if kind == "transposed":
            return torch.randn(shape[:-2] + (shape[-1], shape[-2]),
                               generator=g, device=dev).to(dt) \
                .transpose(-1, -2)
        return torch.randn(shape[:-1] + (shape[-1] + 24,), generator=g,
                           device=dev).to(dt)[..., :shape[-1]]

    gs, gv = scg.gather_counts(n, 2, 1, vl)
    ss, sv = scg.scatter_counts(n, 2, 1, vl)
    gplan = shift_gather.host_plan(gs.numpy(), gv.numpy(), gather=True)
    splan = shift_gather.host_plan(ss.numpy(), sv.numpy(), gather=False)
    gs, gv, ss, sv = (t.to(dev) for t in (gs, gv, ss, sv))
    mask = torch.from_numpy(np.random.default_rng(SEED).random(96) < 0.4)
    masks, _ = shiftnet.layer_masks(*scg.compaction_counts(mask),
                                    toward_zero=True, lsb_first=True)
    masks = masks.to(dev)
    keep = (torch.arange(96) < int(mask.sum())).to(dev)
    spec = vx.Strided(n=n, stride=2, offset=1, vl=vl)
    seg = vx.Segment(n=n, fields=2)
    cases = 0
    for kind in ("transposed", "sliced"):
        x, vals, rows = view(kind, (R, n)), view(kind, (R, vl)), \
            view(kind, (96, 64))
        half = [view(kind, (R, vl)) for _ in range(2)]
        wins = view(kind, (2, R, n))
        for t in (x, vals, rows, wins, *half):
            if t.is_contiguous():
                raise AssertionError(f"{kind} view is contiguous")
        xc, valsc, halfc = x.contiguous(), vals.contiguous(), \
            [h.contiguous() for h in half]
        pairs = ((2, 0), (2, 1))
        b13, p13 = shift_scatter.shift_scatter_static(x, splan), \
            shift_scatter.shift_scatter_static_plain(xc, splan)
        b14, p14 = shift_scatter.shift_scatter(x, ss, sv), \
            shift_scatter.shift_scatter_plain(xc, ss, sv)
        checks = [
            ("B1", segment.deinterleave(x, 2),
             segment.deinterleave_plain(xc, 2)),
            ("B6", segment.deinterleave(x, 2, fused=False),
             segment.deinterleave_dynamic_plain(xc, 2)),
            ("B2", segment.interleave(half), segment.interleave_plain(halfc)),
            ("B7", segment.interleave(half, fused=False),
             segment.interleave_dynamic_plain(halfc)),
            ("B3", strided.gather_strided(x, 2, 1, vl),
             strided.gather_strided_plain(xc, 2, 1, vl)),
            ("B4", strided.gather_strided_fused(wins, pairs, vl),
             strided.gather_strided_fused_plain(wins.contiguous(), pairs,
                                                vl)),
            ("B5", strided.scatter_strided(x, vals, 2, 1),
             strided.scatter_strided_plain(xc, valsc, 2, 1)),
            ("B8", strided.gather_strided(x, 2, 1, vl, compiled=False),
             strided.gather_strided_dynamic_plain(xc, 2, 1, vl)),
            ("B9", strided.scatter_strided(x, vals, 2, 1, compiled=False),
             strided.scatter_strided_dynamic_plain(xc, valsc, 2, 1)),
            ("B10", moe_compact.route_rows(rows, masks, keep,
                                           toward_zero=True, lsb_first=True),
             moe_compact.route_rows_plain(rows.contiguous(), masks, keep,
                                          toward_zero=True, lsb_first=True)),
            ("B11", shift_gather.shift_gather_static(x, gplan),
             shift_gather.shift_gather_static_plain(xc, gplan)),
            ("B12", shift_gather.shift_gather(x, gs, gv),
             shift_gather.shift_gather_plain(xc, gs, gv)),
            ("B13", list(b13), list(p13)),
            ("B14", list(b14), list(p14)),
            ("vx.gather(Strided)", vx.gather(spec, x, policy="kernel"),
             vx.gather(spec, xc, policy="ref")),
            ("vx.scatter(Strided)", vx.scatter(spec, x, vals,
                                               policy="kernel"),
             vx.scatter(spec, xc, valsc, policy="ref")),
            ("vx.transpose(Segment) deinterleave",
             vx.transpose(seg, x, policy="kernel"),
             vx.transpose(seg, xc, policy="ref")),
            ("vx.transpose(Segment) interleave",
             vx.transpose(seg, half, policy="kernel"),
             vx.transpose(seg, halfc, policy="ref")),
        ]
        torch.cuda.synchronize()
        for name, got, want in checks:
            got = list(got) if isinstance(got, (list, tuple)) else [got]
            want = list(want) if isinstance(want, (list, tuple)) else [want]
            if len(got) != len(want) or not all(
                    same_bits(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} on a {kind} view != plain on "
                                     f"a contiguous copy")
            cases += 1
    return cases


# ---------------------------------------------------------------------------
# Phase 3: timings at the main path's shapes
# ---------------------------------------------------------------------------

def record(name, run, plain, library, bound_bytes, shape, note="") -> dict:
    """Hold ``run()`` bit for bit against ``plain()``, then time the
    kernel, the plain version and the library call (CUDA events); the
    bound is ``bound_bytes`` over the card's memory rate.  ``note`` ends
    the printed line."""
    import torch
    got, want = run(), plain()
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    torch.cuda.synchronize()
    if len(got) != len(want):
        raise AssertionError(f"{name} {shape}: {len(got)} outputs, plain "
                             f"version has {len(want)}")
    for f, (a, b) in enumerate(zip(got, want)):
        if not same_bits(a, b):
            raise AssertionError(f"{name} {shape}: output {f} differs "
                                 f"from the plain version")
    del got, want
    err = 0.0                       # bit-equal outputs: no error at all
    iters = 20
    ms, plain_ms, lib_ms = (time_ms(f, iters) for f in (run, plain, library))
    bound = bound_bytes / HBM_BYTES_PER_S * 1e3
    print(f"time {name} {shape}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
          f"{bound:.4f} ms (bytes), max_abs_err {err}{note}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound, "max_abs_err": err, "shape": shape}


def gather_bytes(R: int, n: int, vl: int, stride: int, e: int) -> int:
    """Least bytes of a strided gather: the 32-byte sectors its reads must
    touch (the whole window while stride * e <= 32, else one sector per
    element) plus the output written once."""
    read = R * n * e if stride * e <= 32 else R * vl * 32
    return read + R * vl * e


def staged_row_bytes(n: int, stride: int, offset: int, vl: int,
                     e: int) -> int:
    """Bytes of a row that B3 stages: the 16-byte units that hold an
    output lane, or the whole row where those touch every sector
    (``strided.staged_operands``, the unit a 16-byte-aligned window row of
    ``n * e`` bytes takes)."""
    import numpy as np
    from repro_torch.kernels import strided
    src = offset + stride * np.arange(vl)
    return strided.staged_operands(src[None], n, 16 // e, e)["kmax"] * 16


def lane_bytes(R: int, lanes, e: int) -> int:
    """Least bytes that reading ``lanes`` of each of R rows of ``e``-byte
    elements moves: the distinct 32-byte sectors those lanes touch (each
    row starting on a sector)."""
    import numpy as np
    return R * 32 * len(np.unique(np.asarray(lanes).reshape(-1) * e // 32))


def time_kernels(dev, full_cfg, slots: int, max_len: int) -> dict:
    import torch
    from repro_torch.kernels import segment
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    K, hd = full_cfg.n_kv_heads, full_cfg.hd
    out = {}

    # B1 main path: the fused FIELD=2 KV split of one decode step, every
    # layer's gathered pages at once: (NS, slots, max_len, K, 2*hd) bf16
    kv = torch.randn((full_cfg.n_superblocks, slots, max_len, K, 2 * hd),
                     generator=g, device=dev).to(torch.bfloat16)
    R = kv.numel() // (2 * hd)
    out["deinterleave"] = record(
        "deinterleave", lambda: segment.deinterleave(kv, 2),
        lambda: segment.deinterleave_plain(kv, 2),
        lambda: kv.view(R, hd, 2).permute(2, 0, 1).contiguous(),
        2 * kv.numel() * kv.element_size(), list(kv.shape))
    # B6: the same split through the dynamic-count networks (the fused KV
    # split under kernel_dynamic); bound and library call are B1's
    out["deinterleave_dynamic"] = record(
        "deinterleave_dynamic",
        lambda: segment.deinterleave(kv, 2, fused=False),
        lambda: segment.deinterleave_dynamic_plain(kv, 2),
        lambda: kv.view(R, hd, 2).permute(2, 0, 1).contiguous(),
        2 * kv.numel() * kv.element_size(), list(kv.shape))
    # B1 on the prefill GLU split (16 tokens x 2*d_ff), printed only
    gu = torch.randn((1, 16, 2 * full_cfg.d_ff), generator=g,
                     device=dev).to(torch.bfloat16)
    record("deinterleave[glu]", lambda: segment.deinterleave(gu, 2),
           lambda: segment.deinterleave_plain(gu, 2),
           lambda: gu.view(16, full_cfg.d_ff, 2).permute(2, 0, 1)
           .contiguous(), 2 * gu.numel() * gu.element_size(),
           list(gu.shape))
    # B2 main path: the post-RoPE K/V beat re-pack of a 16-token prefill
    # chunk, (1, 16, K, hd) x 2 -> (1, 16, K, 2*hd) bf16
    k = torch.randn((1, 16, K, hd), generator=g,
                    device=dev).to(torch.bfloat16)
    v = torch.randn((1, 16, K, hd), generator=g,
                    device=dev).to(torch.bfloat16)
    out["interleave"] = record(
        "interleave", lambda: segment.interleave([k, v]),
        lambda: segment.interleave_plain([k, v]),
        lambda: torch.stack([k, v], dim=-1).flatten(-2),
        4 * k.numel() * k.element_size(), list(k.shape) + ["x2"])
    # B2's device time alone at that shape, apart from its host path: the
    # calls captured in one CUDA graph
    dev_ms = graph_ms(lambda: segment.interleave([k, v]), 20)
    lib_dev = graph_ms(lambda: torch.stack([k, v], dim=-1).flatten(-2), 20)
    print(f"time interleave device-only {list(k.shape) + ['x2']}: kernel "
          f"{dev_ms:.4f} ms, library {lib_dev:.4f} ms (CUDA graph of 20 "
          f"calls); at the host's launch rate kernel "
          f"{out['interleave']['ms']:.4f} ms, library "
          f"{out['interleave']['library_ms']:.4f} ms")
    host_path(k, v, dynamic=False)
    out["interleave_dynamic"] = record(
        "interleave_dynamic", lambda: segment.interleave([k, v], fused=False),
        lambda: segment.interleave_dynamic_plain([k, v]),
        lambda: torch.stack([k, v], dim=-1).flatten(-2),
        4 * k.numel() * k.element_size(), list(k.shape) + ["x2"])
    # B7's device time alone (derive kernel + interleave copy under PDL)
    dev7 = graph_ms(lambda: segment.interleave([k, v], fused=False), 20)
    print(f"time interleave_dynamic device-only {list(k.shape) + ['x2']}: "
          f"kernel {dev7:.4f} ms (derive kernel + interleave copy), B2 "
          f"{dev_ms:.4f} ms, library {lib_dev:.4f} ms (CUDA graph of 20 "
          f"calls); at the host's launch rate kernel "
          f"{out['interleave_dynamic']['ms']:.4f} ms, library "
          f"{out['interleave_dynamic']['library_ms']:.4f} ms")
    host_path(k, v, dynamic=True)
    # B2 at a decode-step-sized stack (printed only; the main path keeps
    # single-token beats below the launch threshold)
    kb = kv[..., :hd].contiguous()
    vb = kv[..., hd:].contiguous()
    b1 = out["deinterleave"]["ms"]
    stack = record("interleave[stack]", lambda: segment.interleave([kb, vb]),
                   lambda: segment.interleave_plain([kb, vb]),
                   lambda: torch.stack([kb, vb], dim=-1).flatten(-2),
                   4 * kb.numel() * kb.element_size(),
                   list(kb.shape) + ["x2"],
                   f"; B1 on the same bytes {b1:.4f} ms")
    print(f"interleave[stack] / deinterleave (B2 / B1, the same bytes): "
          f"{stack['ms'] / b1:.4f}")
    out["interleave[stack]"] = stack
    # B7 on the same bytes: the derivation at n = 256 under the copy's
    # first tile loads
    stack7 = record("interleave_dynamic[stack]",
                    lambda: segment.interleave([kb, vb], fused=False),
                    lambda: segment.interleave_dynamic_plain([kb, vb]),
                    lambda: torch.stack([kb, vb], dim=-1).flatten(-2),
                    4 * kb.numel() * kb.element_size(),
                    list(kb.shape) + ["x2"],
                    f"; B2 on the same bytes {stack['ms']:.4f} ms")
    print(f"interleave_dynamic[stack] / interleave[stack] (B7 / B2, the same "
          f"bytes): {stack7['ms'] / stack['ms']:.4f}")
    del kb, vb
    split = segment.deinterleave(kv, 2)
    if not (same_bits(segment.interleave(split), kv) and
            same_bits(segment.interleave(split, fused=False), kv)):
        raise AssertionError("B2 or B7 does not invert B1 on the KV stack")
    print(f"B2(B1(kv)) == B7(B1(kv)) == kv on {list(kv.shape)}, bit for bit")
    out.update(time_strided(dev, kv, split))
    del kv
    torch.cuda.empty_cache()
    time_fig12(dev)
    return out


def host_path(k, v, *, dynamic: bool) -> None:
    """Where B2's (or with ``dynamic`` B7's) time at a launch-sized shape
    goes on the host: the wrapper's host-clock time per call over 2000
    back-to-back calls, beside its parts run alone the same way (the
    allocations: the output, and for B7 its tables' workspace; the ctypes
    call of the entry point with the entry's arguments, which holds the
    CUDA launches), and the library call's (printed)."""
    import ctypes
    import torch
    from repro_torch.kernels import _common, segment

    def per_call(fn, iters=2000):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    m = k.shape[-1]
    R = k.numel() // m
    call = (lambda: segment.interleave([k, v], fused=not dynamic))
    out = call()
    if dynamic:
        ent = segment._interleave_dyn_launch(2 * m, 2, k.device)
        table = torch.empty((2, 2 * m), dtype=torch.int32, device=k.device)
        table_ptr = table.data_ptr()

        def allocate():
            k.new_empty(k.shape[:-1] + (2 * m,))
            torch.empty((2, 2 * m), dtype=torch.int32, device=k.device)
    else:
        ent = segment._interleave_launch(2 * m, 2, None, k.device)
        table_ptr = ent["table_ptr"]

        def allocate():
            k.new_empty(k.shape[:-1] + (2 * m,))
    args = (k.element_size(), (ctypes.c_void_p * 2)(k.data_ptr(),
                                                     v.data_ptr()),
            out.data_ptr(), 2, R, m, table_ptr,
            ent["rows"][R, k.element_size()], ent["blocks"],
            _common.cuda_stream(k))
    wrapper = per_call(call)
    launch = per_call(lambda: ent["fn"](*args))
    alloc = per_call(allocate)
    library = per_call(lambda: torch.stack([k, v], dim=-1).flatten(-2))
    name = "interleave_dynamic" if dynamic else "interleave"
    what = ("the ctypes call with its two CUDA launches (derive kernel, "
            "copy)" if dynamic else "the ctypes call with its CUDA launch")
    allocs = ("the output's and the tables' allocations" if dynamic else
              "the output's allocation")
    print(f"host path {name} {list(k.shape) + ['x2']}: wrapper "
          f"{wrapper:.4f} ms a call (host clock, 2000 calls), of which "
          f"{what} {launch:.4f}, {allocs} {alloc:.4f}, the rest (Python: "
          f"checks, launch-entry lookup, pointers, stream) "
          f"{wrapper - launch - alloc:.4f}; library call {library:.4f} ms a "
          f"call")


def time_strided(dev, kv, split) -> dict:
    """B3, B4 and B5 on the decode KV stack, bf16, each beat ``2*hd``
    lanes.  B4 runs the FIELD=2 split as two strided accesses through
    ``vx.gather_many``; it must equal B1's ``split`` bit for bit."""
    import torch
    from repro_torch import vx
    from repro_torch.kernels import strided
    n, e = kv.shape[-1], kv.element_size()
    R = kv.numel() // n
    vl = n // 2
    pairs = ((2, 0), (2, 1))
    both = vx.gather_many([vx.Strided(n=n, stride=s, offset=o, vl=vl)
                           for s, o in pairs], [kv, kv], policy="kernel")
    torch.cuda.synchronize()
    if not all(same_bits(both[f], split[f]) for f in range(2)):
        raise AssertionError("B4 (2,0),(2,1) split != B1 deinterleave")
    print(f"B4 (2,0),(2,1) on {list(kv.shape)} == B1 FIELD=2 split, bit "
          f"for bit")
    del both, split
    out = {}
    wins = torch.stack([kv, kv])
    out["gather_strided_fused"] = record(
        "gather_strided_fused",
        lambda: strided.gather_strided_fused(wins, pairs, vl),
        lambda: strided.gather_strided_fused_plain(wins, pairs, vl),
        lambda: torch.stack([kv[..., o:o + (vl - 1) * s + 1:s]
                             for s, o in pairs]),
        sum(gather_bytes(R, n, vl, s, e) for s, o in pairs),
        ["x2"] + list(kv.shape) + [str(pairs)])
    del wins
    s, o = 2, 1
    out["gather_strided"] = record(
        "gather_strided", lambda: strided.gather_strided(kv, s, o, vl),
        lambda: strided.gather_strided_plain(kv, s, o, vl),
        lambda: kv[..., o:o + (vl - 1) * s + 1:s].contiguous(),
        gather_bytes(R, n, vl, s, e), list(kv.shape) + [str((s, o))])
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 3)
    vals = torch.randn(kv.shape[:-1] + (vl,), generator=g,
                       device=dev).to(kv.dtype)

    def library():
        w = kv.clone()
        w[..., o:o + (vl - 1) * s + 1:s] = vals
        return w

    out["scatter_strided"] = record(
        "scatter_strided", lambda: strided.scatter_strided(kv, vals, s, o),
        lambda: strided.scatter_strided_plain(kv, vals, s, o), library,
        R * (2 * n + vl) * e, list(kv.shape) + [str((s, o)), "v" + str(vl)])
    # B8 / B9: the same two functions through the dynamic-count networks
    out["gather_strided_dynamic"] = record(
        "gather_strided_dynamic",
        lambda: strided.gather_strided(kv, s, o, vl, compiled=False),
        lambda: strided.gather_strided_dynamic_plain(kv, s, o, vl),
        lambda: kv[..., o:o + (vl - 1) * s + 1:s].contiguous(),
        gather_bytes(R, n, vl, s, e), list(kv.shape) + [str((s, o))])
    derive = graph_ms(lambda: strided.dynamic_merge_list(n, s, o, vl,
                                                         device=dev), 20)
    out["scatter_strided_dynamic"] = record(
        "scatter_strided_dynamic",
        lambda: strided.scatter_strided(kv, vals, s, o, compiled=False),
        lambda: strided.scatter_strided_dynamic_plain(kv, vals, s, o),
        library, R * (2 * n + vl) * e,
        list(kv.shape) + [str((s, o)), "v" + str(vl)],
        f"; SSN derivation alone {derive:.4f} ms")
    return out


def time_fig12(dev) -> None:
    """The Fig. 12 sweep of benchmarks/bench_strided.py at card size: MLEN
    128, vl = 64, offset 0, n = 64 * stride, bf16, R = 2**27 / n rows so
    that every window is 256 MiB (:data:`WINDOW_BYTES`).  B3, B5, B8 and
    B9 at each stride (B9's line with its SSN derivation alone: the table
    and the list of occupied lanes, device time in a CUDA graph), and B8's
    derive kernel alone, the one derivation per launch, beside B8's time
    (printed)."""
    import torch
    from repro_torch.kernels import strided
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    vl, e = 64, 2
    for s in (2, 4, 8, 16, 32, 64):
        n = vl * s
        R = WINDOW_BYTES // (n * e)
        win = torch.randn((R, n), generator=g, device=dev).to(torch.bfloat16)
        vals = torch.randn((R, vl), generator=g,
                           device=dev).to(torch.bfloat16)

        def library():
            w = win.clone()
            w[:, 0:(vl - 1) * s + 1:s] = vals
            return w

        staged = staged_row_bytes(n, s, 0, vl, e)
        b3 = record(f"fig12 gather_strided s={s}",
                    lambda: strided.gather_strided(win, s, 0, vl),
                    lambda: strided.gather_strided_plain(win, s, 0, vl),
                    lambda: win[:, 0:(vl - 1) * s + 1:s].contiguous(),
                    gather_bytes(R, n, vl, s, e), [R, n],
                    f"; staged {staged} of {n * e} bytes a row "
                    f"({staged / (n * e):.4f})")
        b5 = record(f"fig12 scatter_strided s={s}",
                    lambda: strided.scatter_strided(win, vals, s, 0),
                    lambda: strided.scatter_strided_plain(win, vals, s, 0),
                    library, R * (2 * n + vl) * e, [R, n])
        dyn = record(f"fig12 gather_strided_dynamic s={s}",
                     lambda: strided.gather_strided(win, s, 0, vl,
                                                    compiled=False),
                     lambda: strided.gather_strided_dynamic_plain(win, s, 0,
                                                                  vl),
                     lambda: win[:, 0:(vl - 1) * s + 1:s].contiguous(),
                     gather_bytes(R, n, vl, s, e), [R, n])
        derive9 = graph_ms(lambda: strided.dynamic_merge_list(
            n, s, 0, vl, device=dev), 20)
        b9 = record(f"fig12 scatter_strided_dynamic s={s}",
                    lambda: strided.scatter_strided(win, vals, s, 0,
                                                    compiled=False),
                    lambda: strided.scatter_strided_dynamic_plain(win, vals,
                                                                  s, 0),
                    library, R * (2 * n + vl) * e, [R, n],
                    f"; SSN derivation alone {derive9:.4f} ms (one block: "
                    f"the {n}-entry table and the list of {vl} occupied "
                    f"lanes; device time, CUDA graph)")
        derive = graph_ms(lambda: strided.dynamic_sources(
            n, s, 0, vl, device=dev), 20)
        print(f"time fig12 derive s={s} [{R}, {n}]: {derive:.4f} ms for "
              f"B8's derive kernel alone (one block: the GSN derivation "
              f"and its {vl}-entry source table, once per launch; device "
              f"time, CUDA graph), {derive / dyn['ms']:.4f} of B8's time")
        print(f"fig12 s={s}: B3 {b3['ms']:.4f} ms, B8 {dyn['ms']:.4f} ms, "
              f"B3/B8 {b3['ms'] / dyn['ms']:.4f}; B3 over its bound "
              f"{b3['ms'] / b3['bound_ms']:.4f}; B9 {b9['ms']:.4f} ms, over "
              f"its bound {b9['ms'] / b9['bound_ms']:.4f}, over its library "
              f"call {b9['ms'] / b9['library_ms']:.4f}; B5 {b5['ms']:.4f} "
              f"ms, over its bound {b5['ms'] / b5['bound_ms']:.4f}, over its "
              f"library call {b5['ms'] / b5['library_ms']:.4f}, B5/B9 "
              f"{b5['ms'] / b9['ms']:.4f}")
        del win, vals
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4: serve qwen3-0.6b at full width through the port
# ---------------------------------------------------------------------------

def serve(dev, cfg, params, impl: str, prompts, gen: int, slots: int,
          max_len: int, page_size: int, profiled: bool = False,
          cache_dtype="bfloat16", stagger: bool = False,
          track_used: bool = False, **sched_kw) -> dict:
    """One serve run under policy ``impl``; with ``profiled`` the run is
    traced by torch.profiler (host and device) and the trace returned.
    ``sched_kw`` go to the Scheduler (``kv_quant``, ``prefix_cache``,
    ``chunk_pages``); with ``stagger`` the first request is submitted
    alone and the others once its prefill has completed (and published
    its prompt pages).  The peak of ``used_cache_bytes`` is read after
    every decode step; with ``track_used`` also after every tick
    (``used_bytes``, from the tick that admits the first request on).
    Those reads are timed apart and left out of the step times and of
    ``wall_s``."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import segment
    from repro_torch.serve.scheduler import Scheduler
    sched = Scheduler(dataclasses.replace(cfg, kernel_impl=impl), params,
                      slots=slots, max_len=max_len, page_size=page_size,
                      cache_dtype=getattr(torch, cache_dtype), device=dev,
                      **sched_kw)
    step_launches, step_ms, step_tokens = [], [], []
    peak = {"used_bytes": 0, "pages": 0, "shared": 0}
    reads = [0.0]               # seconds of cache-byte reads, off the wall
    plain_step = sched.step

    def counted_step():
        torch.cuda.synchronize()
        d0 = (segment.deinterleave.launches,
              segment.deinterleave_dynamic.launches)
        t0 = time.perf_counter()
        out = plain_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_launches.append(
            (segment.deinterleave.launches - d0[0],
             segment.deinterleave_dynamic.launches - d0[1]))
        step_tokens.append(sum(1 for t in out if t >= 0))
        r0 = time.perf_counter()
        if sched.cache.pages_in_use() > peak["pages"]:
            peak.update(pages=sched.cache.pages_in_use(),
                        used_bytes=sched.cache.used_cache_bytes())
        if sched.prefix is not None:
            peak["shared"] = max(peak["shared"], int(
                (sched.cache.page_refcounts() > 1).sum()))
        reads[0] += time.perf_counter() - r0
        return out

    sched.step = counted_step
    reqs = [sched.submit(p, max_new_tokens=gen)
            for p in (prompts[:1] if stagger else prompts)]
    torch.cuda.synchronize()
    tracer = (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext())
    segment.reset_counts()                  # counts from here: main path
    with tracer as prof:
        t0 = time.perf_counter()
        if stagger:
            while reqs[0].state.value in ("queued", "prefilling"):
                sched.tick()
            reqs += [sched.submit(p, max_new_tokens=gen)
                     for p in prompts[1:]]
        used = []
        for _ in range(10 * (gen + max_len)):
            sched.tick()
            if track_used:
                r0 = time.perf_counter()
                used.append(sched.cache.used_cache_bytes())
                reads[0] += time.perf_counter() - r0
            if sched.drained():
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - reads[0]
    launches = {f.__name__: f.launches
                for f in segment.KERNELS + segment.DYNAMIC}
    if not sched.drained():
        raise AssertionError(f"{impl}: the scheduler never drained")
    logits = sched.last_logits
    if logits is None or tuple(logits.shape) != (slots, cfg.vocab) or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{impl}: last logits not finite of shape "
                             f"({slots}, {cfg.vocab})")
    streams = [r.tokens for r in reqs]
    for r in reqs:
        if r.state.value != "finished" or r.generated != gen or \
                not all(0 <= t < cfg.vocab for t in r.tokens):
            raise AssertionError(f"{impl}: request {r.rid} ended "
                                 f"{r.state.value} with {r.generated} tokens")
    stats = sched.stats()
    page_bytes, forks = sched.cache.page_bytes(), sched.cache.forks
    del sched
    torch.cuda.empty_cache()
    return {"streams": streams, "launches": launches,
            "step_launches": step_launches, "step_ms": step_ms,
            "step_tokens": step_tokens,
            "wall_s": wall, "tokens": gen * len(prompts),
            "prefill_chunks": stats["prefill_chunks"],
            "decode_steps": stats["decode_steps"], "prof": prof,
            "peak_used_bytes": peak["used_bytes"],
            "peak_pages": peak["pages"], "page_bytes": page_bytes,
            "prefix": stats.get("prefix"), "peak_shared": peak["shared"],
            "forks": forks, "spec": stats.get("speculative"),
            "invariant_checks": stats["invariant_checks"],
            "used_bytes": used}


# ---------------------------------------------------------------------------
# Phase 5: the strided path through the port's entry points
# ---------------------------------------------------------------------------

def strided_path(dev, kv_shape, impl: str) -> dict:
    """One run of the strided path under policy ``impl``: the strided
    kernels' counts are set to 0 just before it and read just after.
    Returns every output, the launches, and the StepScheduler group's
    launches (B4's and B8's)."""
    import torch
    from repro_torch import vx
    from repro_torch.core import accessfuse, lsdo
    from repro_torch.kernels import strided
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)
    kv = torch.randn(kv_shape, generator=g, device=dev).to(torch.bfloat16)
    n = kv.shape[-1]
    vals = torch.randn(kv.shape[:-1] + (n // 2,), generator=g,
                       device=dev).to(torch.bfloat16)
    N = WINDOW_BYTES // 2
    buf = torch.randn((N,), generator=g, device=dev).to(torch.bfloat16)
    plans = [lsdo.plan_strided(0, 2, 4096, 128),
             lsdo.plan_strided(N // 11, 3, 4096, 128),
             lsdo.plan_strided(N // 2, 4, 2048, 128),
             lsdo.plan_strided(N - 1, -5, 2048, 128)]
    vl4 = min((n - 1 - o) // s + 1 for s, o in HETERO)
    bank = vx.Strided(n=n, stride=vx.BANK, vl=12, offset=128)
    torch.cuda.synchronize()
    strided.reset_counts()                  # counts from here: the path
    outs = {}
    with vx.use(impl):
        spec = vx.Strided(n=n, stride=2, offset=1, vl=n // 2)
        outs["gather"] = vx.gather(spec, kv)
        outs["scatter"] = vx.scatter(spec, kv, vals)
        outs["gather_many"] = vx.gather_many(
            [vx.Strided(n=n, stride=s, offset=o, vl=vl4) for s, o in HETERO],
            [kv] * len(HETERO))
        sched = accessfuse.StepScheduler()
        f0 = (strided.gather_strided_fused.launches,
              strided.gather_strided_dynamic.launches)
        hs = [sched.gather_strided(kv[a], s, o, vl4)
              for a, (s, o) in enumerate(HETERO)]
        sched.flush()
        group = {"gather_strided_fused":
                 strided.gather_strided_fused.launches - f0[0],
                 "gather_strided_dynamic":
                 strided.gather_strided_dynamic.launches - f0[1]}
        outs["step_group"] = torch.stack([h.value for h in hs])
        for st in (3, -2, 11):
            outs[f"bank[{st}]"] = vx.gather(
                bank, kv, stride=torch.tensor(st, device=dev))
        for i, o in enumerate(lsdo.load_strided_many(buf, plans)):
            outs[f"lsdo[{i}]"] = o
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches
                for f in strided.KERNELS + strided.DYNAMIC}
    # the same function by plain indexing, as a yardstick for both runs
    want = {"gather": kv[..., 1::2],
            "gather_many": torch.stack([kv[..., o:o + (vl4 - 1) * s + 1:s]
                                        for s, o in HETERO]),
            "step_group": torch.stack([kv[a][..., o:o + (vl4 - 1) * s + 1:s]
                                       for a, (s, o) in enumerate(HETERO)])}
    want["scatter"] = kv.clone()
    want["scatter"][..., 1::2] = vals
    for st in (3, -2, 11):
        want[f"bank[{st}]"] = kv[..., 128 + st * torch.arange(12, device=dev)]
    for i, p in enumerate(plans):
        idx = p.base + p.stride * torch.arange(p.vl, device=dev)
        want[f"lsdo[{i}]"] = buf[idx]
    for k, w in want.items():
        if not same_bits(outs[k], w.contiguous()):
            raise AssertionError(f"strided path [{impl}] {k}: differs from "
                                 f"plain indexing")
    return {"outs": outs, "launches": launches, "group": group}


# ---------------------------------------------------------------------------
# Phase 6: the Indexed / Compact path (kernels B10-B14)
# ---------------------------------------------------------------------------

def moe_mask(tokens: int, seed: int):
    """The units one shard of 4-way expert parallelism keeps, as
    ``moe_ffn_local``'s ``mine`` (token-major, TOP_K units a token): each
    token picks TOP_K distinct experts of MOE_EXPERTS (numpy-seeded), and a
    unit is set when its expert is one of the shard's first
    MOE_EXPERTS / MOE_SHARDS.  Density about 0.25."""
    import numpy as np
    rng = np.random.default_rng(seed)
    experts = np.argsort(rng.random((tokens, MOE_EXPERTS)),
                         axis=1)[:, :MOE_TOP_K]
    return (experts < MOE_EXPERTS // MOE_SHARDS).reshape(-1)


def moe_capacity(tokens: int) -> int:
    """``models/moe._capacity`` of the reference at slack 2.0."""
    import math
    cap = int(math.ceil(tokens * MOE_TOP_K / MOE_SHARDS * 2.0))
    cap = min(max(cap, 8), tokens * MOE_TOP_K)
    return ((cap + 7) // 8) * 8 if cap % 8 else cap


def check_indexed(dev) -> int:
    """B10 against its plain version over n in (1, 2, 96, 4096, 16384),
    densities 0 / 0.25 / 1 and 1/2/4/8-byte rows, both directions (n = 1:
    no layer, no launch); B11-B14 against their plain versions over the
    counts of ``scg.gather_counts`` / ``scatter_counts`` at several (n,
    stride, offset, vl) and of ``compaction_counts`` / ``expansion_counts``
    of random masks, and B12 / B14 against their plan twins B11 / B13; B12
    and B14 also on random operand counts, with the derive kernel's source
    tables (the GSN's and the SSN's) against ``_common.dyn_sources_plain``
    and the staged copy's operands it composes against
    ``_indexed.staged_units_plain``; there B11 takes the gather plans
    without conflicts and refuses the others (``AssertionError``, as the
    reference's plan body does), before any launch."""
    import numpy as np
    import torch
    from repro_torch.core import scg, shiftnet
    from repro_torch.kernels import (_common, _indexed, moe_compact,
                                     shift_gather, shift_scatter)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 7)

    def rand(shape, dtype):
        if not dtype.is_floating_point:
            return torch.randint(-100, 100, shape, generator=g, device=dev,
                                 dtype=dtype)
        x = torch.randn(shape, generator=g, device=dev)
        x.view(-1)[::7] = -0.0
        x.view(-1)[3::11] = float("nan")
        return x.to(dtype)

    cases = 0
    dtypes = (torch.int8, torch.bfloat16, torch.float32, torch.int64)
    for dtype in dtypes:
        for n in (1, 2, 96, 4096, 16384):
            for density in (0.0, 0.25, 1.0):
                mask = torch.rand(n, generator=g, device=dev) < density
                for d in (3, 40):
                    rows = rand((n, d), dtype)
                    for counts, tz, keep in (
                            (scg.compaction_counts, True,
                             torch.arange(n, device=dev) < mask.sum()),
                            (scg.expansion_counts, False, mask)):
                        where = f"B10 {dtype} n={n} d={d} density={density}"
                        s, v = counts(mask)
                        masks, _ = shiftnet.layer_masks(
                            s, v, toward_zero=tz, lsb_first=tz)
                        before = moe_compact.route_rows.launches
                        if masks.shape[0]:
                            got = moe_compact.route_rows(
                                rows, masks, keep, toward_zero=tz,
                                lsb_first=tz)
                            want = moe_compact.route_rows_plain(
                                rows, masks, keep, toward_zero=tz,
                                lsb_first=tz)
                            launched = 1
                        else:
                            got = moe_compact._route_rows(
                                rows, s, v, keep, toward_zero=tz,
                                lsb_first=tz)
                            want = torch.where(keep[:, None], rows,
                                               torch.zeros_like(rows))
                            launched = 0
                        torch.cuda.synchronize()
                        if moe_compact.route_rows.launches - before != \
                                launched:
                            raise AssertionError(f"{where}: launches")
                        if not same_bits(got, want):
                            raise AssertionError(f"{where} != plain")
                    cases += 1
    for dtype in dtypes:
        for n, st, off in INDEXED_GEOM:
            vl = (n - 1 - off) // st + 1
            for rows in (7, 1001):
                x = rand((rows, n), dtype)
                mask = torch.rand(n, generator=g, device=dev) < 0.4
                gathers = (("gather", scg.gather_counts(n, st, off, vl,
                                                        device=dev)),
                           ("compact", scg.compaction_counts(mask)))
                scatters = (("scatter", scg.scatter_counts(n, st, off, vl,
                                                           device=dev)),
                            ("expand", scg.expansion_counts(mask)))
                for kind, (sh, va) in gathers:
                    where = f"{dtype} n={n} ({st}, {off}) rows={rows} {kind}"
                    hs, hv = sh.cpu().numpy(), va.cpu().numpy()
                    plan = shift_gather.host_plan(hs, hv, gather=True)
                    dyn = shift_gather.shift_gather(x, sh, va)
                    twin = shift_gather.shift_gather(x, hs, hv)
                    torch.cuda.synchronize()
                    if not same_bits(dyn, shift_gather.shift_gather_plain(
                            x, sh, va)):
                        raise AssertionError(f"B12 != plain: {where}")
                    if not same_bits(twin,
                                     shift_gather.shift_gather_static_plain(
                                         x, plan)):
                        raise AssertionError(f"B11 != plain: {where}")
                    if not same_bits(dyn, twin):
                        raise AssertionError(f"B12 != B11: {where}")
                    cases += 1
                for kind, (sh, va) in scatters:
                    where = f"{dtype} n={n} ({st}, {off}) rows={rows} {kind}"
                    hs, hv = sh.cpu().numpy(), va.cpu().numpy()
                    plan = shift_gather.host_plan(hs, hv, gather=False)
                    dp, do = shift_scatter.shift_scatter(x, sh, va)
                    tp, to = shift_scatter.shift_scatter(x, hs, hv)
                    torch.cuda.synchronize()
                    wp, wo = shift_scatter.shift_scatter_plain(x, sh, va)
                    if not (same_bits(dp, wp) and torch.equal(do, wo)):
                        raise AssertionError(f"B14 != plain: {where}")
                    wp, wo = shift_scatter.shift_scatter_static_plain(x, plan)
                    if not (same_bits(tp, wp) and torch.equal(to, wo)):
                        raise AssertionError(f"B13 != plain: {where}")
                    if not (same_bits(dp, tp) and torch.equal(do, to)):
                        raise AssertionError(f"B14 != B13: {where}")
                    cases += 1
    # B12 and B14 on random operand counts (uniform, short, negative and
    # out-of-range shifts; B13 routes their collisions as B14 does), and
    # the derive kernel's tables against their twins
    rng = np.random.default_rng(SEED + 7)
    refused = 0
    for n, _, _ in INDEXED_GEOM:
        for lo, hi, density in ((0, n, 0.5), (0, 8, 0.8), (-n, 2 * n + 1,
                                                            0.6)):
            sh = torch.from_numpy(rng.integers(lo, max(hi, lo + 1), n)
                                  .astype(np.int32))
            va = torch.from_numpy((rng.random(n) < density).astype(np.int32))
            # the derive kernel's table and the staged copy's operands on
            # B12's GSN and B14's SSN, 1/2/4/8-byte lanes
            for gsn, what in ((True, "B12"), (False, "B14")):
                want = _common.dyn_sources_plain(sh, va, gsn=gsn)
                for elem in (1, 2, 4, 8):
                    unit = _common.copy_unit(n * elem, 0)
                    table, pos, units = _indexed.dyn_sources(
                        sh.to(dev), va.to(dev), gsn=gsn, elem=elem,
                        unit=unit)
                    units = units.cpu().numpy()
                    wu, wp = _indexed.staged_units_plain(want.numpy(), n,
                                                         unit // elem, elem)
                    if not (torch.equal(table.cpu(), want) and np.array_equal(
                            pos.cpu().numpy(), wp) and np.array_equal(
                            units[1:1 + units[0]], wu)):
                        raise AssertionError(
                            f"{what} staged units != twin: n={n} elem "
                            f"{elem} shifts in [{lo}, {hi})")
            hs, hv = sh.numpy(), va.numpy()
            gplan = shift_gather.host_plan(hs, hv, gather=True)
            sh, va = sh.to(dev), va.to(dev)
            for dtype in dtypes:
                x = rand((1001, n), dtype)
                dp, do = shift_scatter.shift_scatter(x, sh, va)
                tp, to = shift_scatter.shift_scatter(x, hs, hv)
                wp, wo = shift_scatter.shift_scatter_plain(x, sh, va)
                gd = shift_gather.shift_gather(x, sh, va)
                gw = shift_gather.shift_gather_plain(x, sh, va)
                before = shift_gather.shift_gather_static.launches
                if gplan.conflict:       # refused, as the reference does
                    gt = gd
                    try:
                        shift_gather.shift_gather(x, hs, hv)
                    except AssertionError as err:
                        if "conflicting plan" not in str(err):
                            raise
                    else:
                        raise AssertionError(f"B11 took a conflicting plan: "
                                             f"n={n} shifts in [{lo}, {hi})")
                    if shift_gather.shift_gather_static.launches != before:
                        raise AssertionError("B11 launched on a conflicting "
                                             "plan")
                    refused += 1
                else:
                    gt = shift_gather.shift_gather(x, hs, hv)
                torch.cuda.synchronize()
                if not (same_bits(dp, wp) and torch.equal(do, wo)
                        and same_bits(dp, tp) and torch.equal(do, to)):
                    raise AssertionError(f"B14 != plain / B13: {dtype} n={n} "
                                         f"shifts in [{lo}, {hi})")
                if not (same_bits(gd, gw) and same_bits(gd, gt)):
                    raise AssertionError(f"B12 != plain / B11: {dtype} n={n} "
                                         f"shifts in [{lo}, {hi})")
            cases += 1
    print(f"B11 refused {refused} conflicting gather plans of the random "
          f"operand counts (AssertionError before any launch, as the "
          f"reference's plan body)")
    return cases


def kv_indexed_operands(dev, kv_shape, seed: int) -> dict:
    """The KV stack (bf16, seeded) and the Indexed operands of the (2,1)
    access over its 256-lane beats: the counts of ``scg.gather_counts(n,
    2, 1, n/2)`` / ``scatter_counts`` as tensors on the card and as numpy
    arrays, the n/2 values of the store and the same values zero-padded to
    n lanes (the raw scatter's input)."""
    import torch
    from repro_torch.core import scg
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    kv = torch.randn(kv_shape, generator=g, device=dev).to(torch.bfloat16)
    n = kv.shape[-1]
    st, off, vl = 2, 1, n // 2
    gs, gv = scg.gather_counts(n, st, off, vl, device=dev)
    ss, sv = scg.scatter_counts(n, st, off, vl, device=dev)
    vals = torch.randn(kv.shape[:-1] + (vl,), generator=g,
                       device=dev).to(torch.bfloat16)
    return {"kv": kv, "n": n, "st": st, "off": off, "vl": vl,
            "gs": gs, "gv": gv, "ss": ss, "sv": sv,
            "hgs": gs.cpu().numpy(), "hgv": gv.cpu().numpy(),
            "hss": ss.cpu().numpy(), "hsv": sv.cpu().numpy(), "vals": vals,
            "padded": torch.nn.functional.pad(vals, (0, n - vl))}


def time_routing_arm(kv, gs, gv, hgs, hgv, gplan, library) -> None:
    """The Indexed gather's static-routing arm (``vx.gather(Indexed(n,
    routing=...))``, torch ops under every policy, no kernel) on the KV
    stack: one take through the plan's table and a select.  Held bit for
    bit against B11 and against the layer-mask form (``layer_masks`` +
    ``apply_layer_masks`` + ``where``, every layer of the network), and
    timed beside that form and the library call."""
    import torch
    from repro_torch import vx
    from repro_torch.core import shiftnet
    from repro_torch.kernels import shift_gather
    routing = (tuple(int(s) for s in hgs.reshape(-1)),
               tuple(bool(v) for v in hgv.reshape(-1)))
    ix = vx.Indexed(n=kv.shape[-1], routing=routing)
    masks, occ = shiftnet.layer_masks(gs.to(torch.int32), gv.bool(),
                                      toward_zero=True, lsb_first=True)

    def arm():
        return vx.gather(ix, kv, policy="kernel")

    def layered():
        return torch.where(occ, shiftnet.apply_layer_masks(
            kv, masks, axis=-1, toward_zero=True, lsb_first=True), 0)

    before = [f.launches for f in shift_gather.KERNELS]
    got = arm()
    if [f.launches for f in shift_gather.KERNELS] != before:
        raise AssertionError("the static-routing arm launched a kernel")
    b11 = shift_gather.shift_gather_static(kv, gplan)
    torch.cuda.synchronize()
    if not (same_bits(got, b11) and same_bits(layered(), b11)):
        raise AssertionError("vx.gather(Indexed routing) != B11 / the "
                             "layer-mask form on the KV stack")
    del got, b11
    shape = list(kv.shape) + ["host counts (2,1) vl 128"]
    print(f"time vx.gather[Indexed routing] {shape}: "
          f"{time_ms(arm, 20):.4f} ms (one take through the plan's table "
          f"and a select; torch ops, no launch); layer-mask form "
          f"{time_ms(layered, 10):.4f} ms ({masks.shape[0]} layers and a "
          f"select); library {time_ms(library, 20):.4f} ms; all == B11, "
          f"bit for bit")


def time_indexed(dev, kv_shape) -> dict:
    """B11-B14 on the decode KV stack (bf16, 256-lane beats) with the
    counts of ``scg.gather_counts(256, 2, 1, 128)`` /
    ``scatter_counts(256, 2, 1, 128)``, cross-checked against the strided
    kernels: B12's and B11's lanes [0, 128) equal B3's output and the rest
    are 0; ``where(occ, payload, window)`` of B14 and B13 on the values
    zero-padded to 256 lanes equals B5's output.  Then each is timed
    (``record``); the library call is ``torch.gather`` along the lanes with
    the plan's precomputed source index, plus a ``where``.  Beside them:
    the units of a row B13's host operands list, and the derive kernel
    alone (CUDA graph) on B12's GSN and B14's SSN at n = 256 and 4095,
    with the units it lists."""
    import torch
    from repro_torch.core import scg
    from repro_torch.kernels import (_common, _indexed, shift_gather,
                                     shift_scatter, strided)
    ops = kv_indexed_operands(dev, kv_shape, SEED + 8)
    kv, n, st, off, vl = (ops[k] for k in ("kv", "n", "st", "off", "vl"))
    e = kv.element_size()
    R = kv.numel() // n
    gs, gv, ss, sv, vals, padded = (
        ops[k] for k in ("gs", "gv", "ss", "sv", "vals", "padded"))
    hgs, hgv, hss, hsv = (ops[k] for k in ("hgs", "hgv", "hss", "hsv"))
    b3 = strided.gather_strided(kv, st, off, vl)
    for name, out in (("B12", shift_gather.shift_gather(kv, gs, gv)),
                      ("B11", shift_gather.shift_gather(kv, hgs, hgv))):
        torch.cuda.synchronize()
        if not (same_bits(out[..., :vl].contiguous(), b3)
                and not bool(out[..., vl:].view(torch.int16).any())):
            raise AssertionError(f"{name} on the KV stack != B3 (lanes "
                                 f"[0, {vl})) and 0 (the rest)")
    del b3
    b5 = strided.scatter_strided(kv, vals, st, off)
    for name, (p, occ) in (
            ("B14", shift_scatter.shift_scatter(padded, ss, sv)),
            ("B13", shift_scatter.shift_scatter(padded, hss, hsv))):
        torch.cuda.synchronize()
        if not same_bits(torch.where(occ, p, kv), b5):
            raise AssertionError(f"where(occ, {name}, window) on the KV "
                                 f"stack != B5")
        del p, occ
    del b5
    print(f"indexed on the KV stack {list(kv.shape)}: B12 and B11 lanes "
          f"[0, {vl}) == B3 at ({st}, {off}) and the rest 0; where(occ, "
          f"B14 / B13 payload, window) == B5, bit for bit")
    gplan = shift_gather.host_plan(hgs, hgv, gather=True)
    splan = shift_gather.host_plan(hss, hsv, gather=False)

    def library(x, plan):
        src = torch.from_numpy(plan.source).to(dev).clamp(min=0).expand(
            x.shape)
        keep = torch.from_numpy(plan.valid).to(dev)
        return lambda: torch.where(keep, torch.gather(x, -1, src), 0)

    # least bytes: the input lanes that can reach the output, read once
    # (the gather's valid lanes' sources, the scatter's valid lanes; in
    # 32-byte sectors), the payload written once, and for the scatter one
    # occupancy byte per element; the count operands' few KiB left out
    gather_move = lane_bytes(R, gplan.source.reshape(-1)[
        gplan.valid.reshape(-1).astype(bool)], e) + R * n * e
    scatter_move = lane_bytes(R, hsv.reshape(-1).nonzero()[0], e) \
        + R * n * e + R * n
    shape = list(kv.shape)
    out = {}
    # B11's and B13's staged copies list the units their host plan's table
    # reads: no derivation on the card
    gunit = _common.copy_unit(n * e, kv.data_ptr())
    gst = _indexed.plan_staged(gplan, gunit // e, e)
    out["shift_gather_static"] = record(
        "shift_gather_static",
        lambda: shift_gather.shift_gather_static(kv, gplan),
        lambda: shift_gather.shift_gather_static_plain(kv, gplan),
        library(kv, gplan), gather_move,
        shape + ["host counts (2,1) vl 128"],
        f"; {int(gst['nunits'][0])} of {n * e // gunit} {gunit}-byte units "
        f"of a row listed by the host plan's table (one staged copy, no "
        f"derive kernel)")
    time_routing_arm(kv, gs, gv, hgs, hgv, gplan, library(kv, gplan))
    sunit = _common.copy_unit(n * e, padded.data_ptr())
    st = _indexed.plan_staged(splan, sunit // e, e)
    print(f"shift_scatter_static units: {int(st['nunits'][0])} of "
          f"{n * e // sunit} {sunit}-byte units of a row listed by the host "
          f"plan's table (one staged copy with the occupancy, no derive "
          f"kernel)")
    out["shift_scatter_static"] = record(
        "shift_scatter_static",
        lambda: list(shift_scatter.shift_scatter_static(padded, splan)),
        lambda: list(shift_scatter.shift_scatter_static_plain(padded,
                                                              splan)),
        library(padded, splan), scatter_move,
        shape + ["host counts (2,1) vl 128"])
    # the derive kernel alone (one block: the GSN for B12, the SSN for B14,
    # on the operand counts; the table and the staged copy's unit list for
    # bf16 rows) at the stack's n = 256 and on the 12-layer network at
    # n = 4095
    derive = {}
    for gsn, name, what, counts in (
            (True, "shift_gather", "B12", scg.gather_counts),
            (False, "shift_scatter", "B14", scg.scatter_counts)):
        dsn = (gs, gv) if gsn else (ss, sv)
        for dn, (dss, dsv) in ((n, dsn), (4095, counts(4095, 64, 0, 64,
                                                       device=dev))):
            dss, dsv = dss.to(torch.int32), dsv.to(torch.int32)
            unit = _common.copy_unit(dn * e, 0)
            derive[what, dn] = graph_ms(lambda: _indexed.dyn_sources(
                dss, dsv, gsn=gsn, elem=e, unit=unit), 20)
            listed = int(_indexed.dyn_sources(dss, dsv, gsn=gsn, elem=e,
                                              unit=unit)[2][0])
            print(f"time {name} derive n={dn}: {derive[what, dn]:.4f} ms for "
                  f"{what}'s derive kernel alone (one block: the "
                  f"{'GSN' if gsn else 'SSN'} on the operand counts, the "
                  f"{dn}-entry table and the unit list, {listed} of "
                  f"{dn * e // unit} {unit}-byte units of a row; device "
                  f"time, CUDA graph)")

    def note(what, net):
        return (f"; {net} derivation alone {derive[what, n]:.4f} ms (n = "
                f"{n}), {derive[what, 4095]:.4f} ms (n = 4095)")

    out["shift_gather"] = record(
        "shift_gather", lambda: shift_gather.shift_gather(kv, gs, gv),
        lambda: shift_gather.shift_gather_plain(kv, gs, gv),
        library(kv, gplan), gather_move,
        shape + ["tensor counts (2,1) vl 128"], note("B12", "GSN"))
    out["shift_scatter"] = record(
        "shift_scatter",
        lambda: list(shift_scatter.shift_scatter(padded, ss, sv)),
        lambda: list(shift_scatter.shift_scatter_plain(padded, ss, sv)),
        library(padded, splan), scatter_move,
        shape + ["tensor counts (2,1) vl 128"], note("B14", "SSN"))
    return out


def moe_compact_phase(dev) -> dict:
    """Compact at qwen3-moe-30b-a3b's width (d_model 2048, 128 experts,
    top-8): a 2048-token and a 512-token prefill chunk (n = 16384 and
    4096 routed units of 2048 bf16), the units of one shard of 4-way
    expert parallelism set (:func:`moe_mask`).  ``vx.compact`` then
    ``vx.scatter(Compact)`` must give ``where(mask, rows, 0)``, and the ids
    of ``vx.compact(Compact(n, cap), mask)`` must be
    ``torch.nonzero(mask)[:cap]`` on the set units.  Then B10 is timed at
    n = 16384 in the compact direction (the JSON record) and the expand
    direction (printed); the library call is ``index_select`` of each
    output row's source row (walked through the precomputed masks once)
    plus a ``where``, the kernel's own function.  The entry points
    ``compact_rows`` / ``expand_rows`` (counts, masks and one B10) are also
    timed beside ``kernels/ref.py``'s stable sort, index and ``where``."""
    import torch
    from repro_torch import vx
    from repro_torch.core import scg, shiftnet
    from repro_torch.kernels import moe_compact, ref
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 10)
    out = {}
    for tokens in (2048, 512):
        n = tokens * MOE_TOP_K
        rows = torch.randn((n, MOE_D), generator=g,
                           device=dev).to(torch.bfloat16)
        mask = torch.from_numpy(moe_mask(tokens, SEED + tokens)).to(dev)
        spec = vx.Compact(n=n)
        packed, pv = vx.compact(spec, mask, rows, policy="kernel")
        back = vx.scatter(spec, mask, packed, policy="kernel")
        cap = moe_capacity(tokens)
        ids = vx.compact(vx.Compact(n=n, cap=cap), mask, policy="kernel")
        nz = torch.nonzero(mask)[:cap, 0]
        torch.cuda.synchronize()
        if not same_bits(back, torch.where(mask[:, None], rows,
                                           torch.zeros_like(rows))):
            raise AssertionError(f"MoE n={n}: compact then expand != "
                                 f"where(mask, rows, 0)")
        if ids.shape != (cap,) or not torch.equal(ids[:nz.numel()].long(),
                                                  nz):
            raise AssertionError(f"MoE n={n}: compact ids != nonzero(mask)")
        count = int(mask.sum())
        print(f"moe compact n={n} ({tokens} tokens x top-{MOE_TOP_K}, "
              f"d {MOE_D} bf16): {count} units set (density "
              f"{count / n:.4f}); compact -> expand == where(mask, rows, 0) "
              f"and ids == nonzero(mask)[:{cap}], bit for bit")
        row_bytes = MOE_D * rows.element_size()
        for direction, counts, tz, keep in (
                ("compact", scg.compaction_counts, True, pv),
                ("expand", scg.expansion_counts, False, mask)):
            s, v = counts(mask)
            masks, _ = shiftnet.layer_masks(s, v, toward_zero=tz,
                                            lsb_first=tz)
            x = rows if direction == "compact" else packed
            # the library call of the same function, the masks precomputed:
            # each output row's source row (walked through the masks once,
            # here) by index_select, then a where
            ids = moe_compact.route_rows_plain(
                torch.arange(1, n + 1, device=dev)[:, None], masks,
                torch.ones(n, dtype=torch.bool, device=dev),
                toward_zero=tz, lsb_first=tz)[:, 0] - 1
            src, take = ids.clamp(min=0), (keep & (ids >= 0))[:, None]
            lib = (lambda: torch.where(take, x.index_select(0, src), 0))
            if not same_bits(lib(), moe_compact.route_rows_plain(
                    x, masks, keep, toward_zero=tz, lsb_first=tz)):
                raise AssertionError(f"B10 library call n={n} {direction} "
                                     f"!= the plain version")
            # least bytes: the rows that land in a valid slot read once,
            # every output row written once, the masks and out_valid read
            bound = (count + n) * row_bytes + masks.numel() + n
            r = record(
                f"route_rows[{direction}] n={n}",
                lambda: moe_compact.route_rows(x, masks, keep,
                                               toward_zero=tz, lsb_first=tz),
                lambda: moe_compact.route_rows_plain(
                    x, masks, keep, toward_zero=tz, lsb_first=tz),
                lib, bound, [n, MOE_D, f"density {count / n:.4f}"])
            if tokens == 2048 and direction == "compact":
                out["route_rows"] = r
            # the whole entry point, counts and masks included, beside the
            # library sequence of kernels/ref.py (stable sort, index, where)
            port, lib_e2e = ((lambda: moe_compact.compact_rows(rows, mask),
                              lambda: ref.compact_rows(rows, mask))
                             if direction == "compact" else
                             (lambda: moe_compact.expand_rows(packed, mask),
                              lambda: ref.expand_rows(packed, mask)))
            print(f"time {direction}_rows end to end n={n}: port "
                  f"{time_ms(port, 20):.4f} ms (counts, masks, one B10), "
                  f"library {time_ms(lib_e2e, 20):.4f} ms (kernels/ref.py)")
        del rows, packed, back
        torch.cuda.empty_cache()
    return out


def indexed_path(dev, kv_shape, impl: str) -> dict:
    """One run of the Indexed / Compact path under policy ``impl``: the
    counts of B10-B14 are set to 0 just before it and read just after.
    Through ``vx``: the Indexed gather with tensor counts (B12 under either
    kernel policy) and with numpy counts (the plan stage, no kernel), the
    Indexed scatter with tensor counts (B14) and numpy counts (B13) on the
    KV stack; ``vx.compact`` with rows and ``vx.scatter(Compact)`` (one B10
    each) and the compact ids (no kernel) at the MoE width.  Under a kernel
    policy the run also calls ``kernels.shift_gather.shift_gather`` with
    numpy counts, the entry point that reaches B11 (the reference reaches
    that body only by a direct call).  Returns the outputs, the launches
    of the whole run and of each call."""
    import torch
    from repro_torch import vx
    from repro_torch.kernels import moe_compact, shift_gather, shift_scatter
    ops = kv_indexed_operands(dev, kv_shape, SEED + 9)
    kv, n, st, off, vl = (ops[k] for k in ("kv", "n", "st", "off", "vl"))
    gs, gv, ss, sv, vals, padded = (
        ops[k] for k in ("gs", "gv", "ss", "sv", "vals", "padded"))
    hgs, hgv, hss, hsv = (ops[k] for k in ("hgs", "hgv", "hss", "hsv"))
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 12)
    tokens = 2048
    N = tokens * MOE_TOP_K
    rows = torch.randn((N, MOE_D), generator=g, device=dev).to(torch.bfloat16)
    mask = torch.from_numpy(moe_mask(tokens, SEED + 11)).to(dev)
    cap = moe_capacity(tokens)
    wrappers = (moe_compact.KERNELS + shift_gather.KERNELS
                + shift_scatter.KERNELS)

    def launches():
        return {f.__name__: f.launches for f in wrappers}

    outs, per_call = {}, {}

    def step(name, fn):
        before = launches()
        outs[name] = fn()
        after = launches()
        per_call[name] = {k: after[k] - before[k] for k in after
                          if after[k] != before[k]}

    torch.cuda.synchronize()
    for mod in (moe_compact, shift_gather, shift_scatter):
        mod.reset_counts()                  # counts from here: the path
    with vx.use(impl):
        ix = vx.Indexed(n=n)
        step("gather[tensor]", lambda: vx.gather(ix, kv, shift=gs, valid=gv))
        step("gather[numpy]", lambda: vx.gather(ix, kv, shift=hgs,
                                                valid=hgv))
        step("scatter[tensor]", lambda: vx.scatter(ix, None, padded,
                                                   shift=ss, valid=sv))
        step("scatter[numpy]", lambda: vx.scatter(ix, None, padded,
                                                  shift=hss, valid=hsv))
        step("compact", lambda: vx.compact(vx.Compact(n=N), mask, rows))
        step("expand", lambda: vx.scatter(vx.Compact(n=N), mask,
                                          outs["compact"][0]))
        step("ids", lambda: vx.compact(vx.Compact(n=N, cap=cap), mask))
        if impl != "ref":
            step("shift_gather[numpy]",
                 lambda: shift_gather.shift_gather(kv, hgs, hgv))
    torch.cuda.synchronize()
    total = launches()
    # the same functions by plain indexing, as a yardstick for every run
    gather_want = torch.zeros_like(kv)
    gather_want[..., :vl] = kv[..., off::st]
    scatter_want = kv.clone()
    scatter_want[..., off::st] = vals
    checks = {"gather[tensor]": outs["gather[tensor]"],
              "gather[numpy]": outs["gather[numpy]"]}
    if "shift_gather[numpy]" in outs:
        checks["shift_gather[numpy]"] = outs["shift_gather[numpy]"]
    for k, got in checks.items():
        if not same_bits(got, gather_want):
            raise AssertionError(f"indexed path [{impl}] {k} differs from "
                                 f"plain indexing")
    for k in ("scatter[tensor]", "scatter[numpy]"):
        p, occ = outs[k]
        if not same_bits(torch.where(occ, p, kv), scatter_want):
            raise AssertionError(f"indexed path [{impl}] {k} differs from "
                                 f"plain indexing")
    if not same_bits(outs["expand"], torch.where(mask[:, None], rows,
                                                 torch.zeros_like(rows))):
        raise AssertionError(f"indexed path [{impl}] compact -> expand != "
                             f"where(mask, rows, 0)")
    nz = torch.nonzero(mask)[:cap, 0]
    if not torch.equal(outs["ids"][:nz.numel()].long(), nz):
        raise AssertionError(f"indexed path [{impl}] ids != nonzero(mask)")
    return {"outs": outs, "launches": total, "per_call": per_call}


def indexed_phase(dev, kv_shape, timing: dict) -> dict:
    """Phase 6: B10-B14 against their plain versions (and plan twins),
    the KV-stack cross-checks and times of B11-B14, the MoE-width compact
    round trip and B10's times (``timing`` gains the five records), then
    the Indexed / Compact path under ``kernel``, ``ref`` and
    ``kernel_dynamic``: outputs equal bit for bit, the launches of each
    call as stated in :func:`indexed_path`.  Returns the ``kernel`` run's
    launches."""
    import torch
    t0 = time.perf_counter()
    cases = check_indexed(dev)
    print(f"indexed kernels == plain: {cases} cases (B10 both directions; "
          f"B12 == B11 and B14 == B13 on the same counts, also on random "
          f"operand counts, with B12's and B14's device source tables == "
          f"dyn_sources_plain and their unit lists == staged_units_plain) "
          f"bit-exact ({time.perf_counter() - t0:.1f} s)")
    timing.update(time_indexed(dev, kv_shape))
    torch.cuda.empty_cache()
    timing.update(moe_compact_phase(dev))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    path = {}
    for impl in ("kernel", "ref", "kernel_dynamic"):
        path[impl] = indexed_path(dev, kv_shape, impl)
        torch.cuda.empty_cache()
    ref = path["ref"]
    for impl in ("kernel", "kernel_dynamic"):
        for key, out in path[impl]["outs"].items():
            want = ref["outs"].get(key, path["kernel"]["outs"][key])
            out = out if isinstance(out, tuple) else (out,)
            want = want if isinstance(want, tuple) else (want,)
            if not all(same_bits(a, b) for a, b in zip(out, want)):
                raise AssertionError(f"indexed path: {key} differs between "
                                     f"{impl} and ref")
    if any(ref["launches"].values()):
        raise AssertionError(f"ref policy launched indexed kernels: "
                             f"{ref['launches']}")
    want_calls = {"gather[tensor]": {"shift_gather": 1},
                  "gather[numpy]": {},
                  "scatter[tensor]": {"shift_scatter": 1},
                  "scatter[numpy]": {"shift_scatter_static": 1},
                  "compact": {"route_rows": 1},
                  "expand": {"route_rows": 1},
                  "ids": {},
                  "shift_gather[numpy]": {"shift_gather_static": 1}}
    for impl in ("kernel", "kernel_dynamic"):
        if path[impl]["per_call"] != want_calls:
            raise AssertionError(f"indexed path [{impl}] launches per call: "
                                 f"{path[impl]['per_call']}")
    print(f"indexed path: outputs equal under kernel, ref and kernel_dynamic "
          f"and to plain indexing; launches per call under kernel and "
          f"kernel_dynamic {path['kernel']['per_call']}; whole run kernel "
          f"{path['kernel']['launches']}, kernel_dynamic "
          f"{path['kernel_dynamic']['launches']}, ref {ref['launches']} "
          f"({time.perf_counter() - t0:.1f} s)")
    return path["kernel"]["launches"]


# ---------------------------------------------------------------------------
# Phase 7: dense serving (forward prefill, dense decode) and the serve CLI
# ---------------------------------------------------------------------------

DENSE_PROMPT, DENSE_STEPS, DENSE_MAX_LEN = 64, 16, 512
ORACLE_STEPS = 8
CLI_ARGS = ("--arch", "qwen3-0.6b", "--requests", "4", "--prompt-len", "64",
            "--gen", "16", "--max-len", "512")


def segment_counts() -> dict:
    from repro_torch.kernels import segment
    return {f.__name__: f.launches for f in segment.KERNELS + segment.DYNAMIC}


def dense_serve(dev, cfg, params, impl: str, tokens,
                profiled: bool = False) -> dict:
    """Phase 7a under policy ``impl``: ``jit_prefill`` over ``tokens``
    (one warm-up call, then the timed one), ``cache_from_prefill`` into
    ``DENSE_MAX_LEN`` bf16 beats, then ``DENSE_STEPS`` greedy fused
    ``jit_decode_step`` steps.  The counts are zeroed just before the timed
    prefill and before each step, and read just after.  With ``profiled``
    the timed prefill and the steps are traced by torch.profiler (host and
    device) and the trace returned."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import segment
    from repro_torch.models import decode as dec
    from repro_torch.serve.engine import (ServeConfig, jit_decode_step,
                                          jit_prefill)
    cfg = dataclasses.replace(cfg, kernel_impl=impl)
    prefill = jit_prefill(cfg, None, device=dev)
    step = jit_decode_step(cfg, None, ServeConfig(max_len=DENSE_MAX_LEN,
                                                  step_fusion=True),
                           device=dev)
    prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    tracer = (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext())
    tracer.__enter__()
    wall0 = time.perf_counter()
    segment.reset_counts()
    t0 = time.perf_counter()
    logits, states = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = segment_counts()
    B, S = tokens.shape
    if tuple(logits.shape) != (B, 1, cfg.vocab) or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"dense [{impl}]: prefill logits not finite of "
                             f"shape ({B}, 1, {cfg.vocab})")
    cache = dec.cache_from_prefill(cfg, states, S, DENSE_MAX_LEN,
                                   torch.bfloat16)
    del states
    tok = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)
    stream = [tok]
    step_ms, step_launches = [], []
    for _ in range(DENSE_STEPS):
        torch.cuda.synchronize()
        segment.reset_counts()
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tok)
        tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_launches.append(segment_counts())
        stream.append(tok)
    wall = time.perf_counter() - wall0
    tracer.__exit__(None, None, None)
    if tuple(logits.shape) != (B, cfg.vocab) or \
            not bool(torch.isfinite(logits.float()).all()) or \
            int(cache["len"]) != S + DENSE_STEPS:
        raise AssertionError(f"dense [{impl}]: decode logits not finite of "
                             f"shape ({B}, {cfg.vocab}), or the cache's "
                             f"length is not {S + DENSE_STEPS}")
    del cache
    torch.cuda.empty_cache()
    return {"streams": torch.stack(stream, 1).cpu().tolist(),
            "prefill_ms": prefill_ms, "prefill_launches": prefill_launches,
            "step_ms": step_ms, "step_launches": step_launches,
            "wall_s": wall, "prof": tracer if profiled else None,
            "label": f"dense: 1 prefill of {B}x{S} tokens + {DENSE_STEPS} "
                     f"decode steps"}


def dense_vs_paged(dev, cfg, params, slots: int, page_size: int) -> list:
    """Phase 7b: from empty caches, the same forced token stream for
    ``ORACLE_STEPS`` steps through the dense step and the paged step,
    each fused and per-access, under ``kernel``; every step's logits must
    equal the fused dense step's bit for bit.  Returns, per pair, the
    steps that differed and the largest difference."""
    import numpy as np
    import torch
    from repro_torch.models import decode as dec
    cfg = dataclasses.replace(cfg, kernel_impl="kernel")
    forced = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab, (ORACLE_STEPS, slots)).astype(np.int32)).to(dev)
    caches = {"dense fused": dec.init_cache(cfg, slots, DENSE_MAX_LEN,
                                            torch.bfloat16, device=dev),
              "dense per-access": dec.init_cache(cfg, slots, DENSE_MAX_LEN,
                                                 torch.bfloat16, device=dev),
              "paged fused": dec.init_paged_cache(
                  cfg, slots, DENSE_MAX_LEN, page_size, torch.bfloat16,
                  device=dev),
              "paged per-access": dec.init_paged_cache(
                  cfg, slots, DENSE_MAX_LEN, page_size, torch.bfloat16,
                  device=dev)}
    steps = {"dense fused": lambda c, t: dec.decode_step(
                 params, c, t, cfg, fuse=True),
             "dense per-access": lambda c, t: dec.decode_step(
                 params, c, t, cfg, fuse=False),
             "paged fused": lambda c, t: dec.paged_decode_step(
                 params, c, t, cfg, fuse=True),
             "paged per-access": lambda c, t: dec.paged_decode_step(
                 params, c, t, cfg, fuse=False)}
    diffs = {k: [0, 0.0] for k in steps if k != "dense fused"}
    for t in range(ORACLE_STEPS):
        out = {}
        for name, fn in steps.items():
            out[name], caches[name] = fn(caches[name], forced[t])
        base = out["dense fused"]
        for name in diffs:
            if not same_bits(out[name], base):
                diffs[name][0] += 1
                diffs[name][1] = max(diffs[name][1], float(
                    (out[name].float() - base.float()).abs().max()))
    del caches
    torch.cuda.empty_cache()
    return diffs


def run_cli(card: str, flags=(), base=CLI_ARGS) -> dict:
    """Phase 7c (and 8, with ``flags``): the port's serve CLI at full width
    in a subprocess (phase 11: ``base`` names another arch)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *base, *flags], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"serve CLI exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    lines = out.stdout.splitlines()
    reqs = [ln for ln in lines if ln.startswith("req ")]
    tok_line = [ln for ln in lines if "tok/s on " in ln]
    name = card.split(",")[0].strip()
    if len(reqs) != 4 or not all(" finished " in ln for ln in reqs) or \
            len(tok_line) != 1 or name not in tok_line[0]:
        raise AssertionError(f"serve CLI output: every request must be "
                             f"finished and the tok/s line must name "
                             f"{name}:\n{out.stdout[-3000:]}")
    return {"lines": lines, "wall_s": wall}


#: Subprocess CLI runs at a time beside phases 11-14 (:class:`Background`).
CLI_WORKERS = 3
#: The head of every line printed while the background runs or of it: the
#: times on such a line were taken on a card and host shared with it.
CONTENDED = "[beside the background] "


class _Tagged:
    """A stdout that starts each line with ``tag``."""

    def __init__(self, out, tag: str):
        self.out, self.tag, self.fresh = out, tag, True

    def write(self, text: str) -> int:
        for piece in text.splitlines(keepends=True):
            if self.fresh:
                self.out.write(self.tag)
            self.out.write(piece)
            self.fresh = piece.endswith("\n")
        return len(text)

    def flush(self) -> None:
        self.out.flush()

    def __getattr__(self, name):
        return getattr(self.out, name)


class Background:
    """What this script runs in processes of its own: the CLI runs of
    phases 7-12 and 15c (queued through :func:`cli_runs`) and the spawn of
    ranks of phases 16 and 17.  :meth:`start_spawn` (after phase 6)
    starts the spawn, beside phases 7-14; :meth:`start` (after phase 10)
    the queued CLIs, ``CLI_WORKERS`` at a time, beside phases 11-14; a
    CLI queued later starts when a worker frees.  They share the card and
    the host's cores with this process.  :meth:`join` waits for every
    run, prints each CLI's report in the order queued, then phase 16's
    and 17's lines.  From :meth:`start_spawn` to the end of :meth:`join`
    every line printed starts with :data:`CONTENDED`."""

    def __init__(self):
        self.jobs: list = []          # [report, fn, args, future]
        self.pool = None

    def queue(self, report, fn, *args) -> None:
        future = None if self.pool is None else self.pool.submit(fn, *args)
        self.jobs.append([report, fn, args, future])

    def start_spawn(self) -> None:
        """Start the ranks of phases 16 and 17 (after phase 6, so that
        they run beside phases 7-14); every line from here on is
        tagged."""
        import os
        import tempfile
        from concurrent.futures import ThreadPoolExecutor
        self.t0 = time.perf_counter()
        # 17e waits for this file: the main process writes it when its
        # card work before the join is done (main_idle)
        self.idle = Path(tempfile.mkdtemp(dir=ROOT / "build")) / "idle"
        os.environ[IDLE_ENV] = str(self.idle)
        self.spawner = ThreadPoolExecutor(1)
        self.spawned = self.spawner.submit(timed_spawn16)
        sys.stdout.flush()
        self.stdout, sys.stdout = sys.stdout, _Tagged(sys.stdout, CONTENDED)

    def start(self) -> None:
        """Start the queued CLIs (after phase 10)."""
        from concurrent.futures import ThreadPoolExecutor
        self.t_cli = time.perf_counter()
        self.pool = ThreadPoolExecutor(CLI_WORKERS)
        for job in self.jobs:
            job[3] = self.pool.submit(job[1], *job[2])

    def main_idle(self) -> None:
        """Tell the ranks the main process has left the card (17e)."""
        self.idle.write_text("idle")

    def join(self, card: str) -> dict:
        """Phases 16's and 17's launches, summed over their ranks."""
        import os
        import shutil
        self.main_idle()
        results = [job[3].result() for job in self.jobs]
        spawned = self.spawned.result()
        now = time.perf_counter()
        print(f"background: phases 16-17's {RANKS16} ranks (started after "
              f"phase 6, beside phases 7-14) and {len(self.jobs)} CLI runs "
              f"in subprocesses, {CLI_WORKERS} at a time (started after "
              f"phase 10, beside phases 11-14) on {card}: joined "
              f"{now - self.t0:.1f} s after the ranks started and "
              f"{now - self.t_cli:.1f} s after the CLIs (every CLI's wall "
              f"time below is taken so)")
        for job, r in zip(self.jobs, results):
            job[0](r)
        self.pool.shutdown()
        self.spawner.shutdown()
        os.environ.pop(IDLE_ENV, None)
        shutil.rmtree(self.idle.parent, ignore_errors=True)
        try:
            return sharded_phase(card, spawned)
        finally:
            sys.stdout.flush()
            sys.stdout = self.stdout


#: The script's :class:`Background` while ``main`` runs; None when a phase
#: runs alone (its CLIs then run at once, side by side).
BACKGROUND: Background | None = None


def cli_runs(*jobs) -> None:
    """Each job ``(report, fn, *args)``: ``fn(*args)`` runs a CLI in a
    subprocess, ``report(result)`` checks and prints it.  Queued on
    :data:`BACKGROUND` when there is one; else run now, side by side."""
    if BACKGROUND is not None:
        for report, fn, *args in jobs:
            BACKGROUND.queue(report, fn, *args)
        return
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(fn, *args) for _, fn, *args in jobs]
    for (report, *_), f in zip(jobs, futures):
        report(f.result())


def dense_phase(dev, cfg, card: str, slots: int, page_size: int) -> None:
    """Phase 7: dense serving under ``kernel``, ``ref``,
    ``kernel_dynamic``, ``kernel_dynamic``, ``ref``, ``kernel`` (streams
    equal; prefill launches B1 and B2 or B6 and B7; every decode step
    exactly one fused split, B1 or B6, none under ``ref``), the dense step
    against the paged step, and the CLI."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import cast_params, init_params
    t0 = time.perf_counter()
    params = cast_params(init_params(cfg, SEED, device=dev), cfg)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab, (slots, DENSE_PROMPT)).astype(np.int32)).to(dev)
    # the host clock drifts within a call: phase 4's order puts every
    # policy at the same mean position
    order = ("kernel", "ref", "kernel_dynamic", "kernel_dynamic", "ref",
             "kernel")
    runs = [(impl, dense_serve(dev, cfg, params, impl, tokens))
            for impl in order]
    want_step = {"kernel": "deinterleave",
                 "kernel_dynamic": "deinterleave_dynamic", "ref": None}
    want_prefill = {"kernel": ("deinterleave", "interleave"),
                    "kernel_dynamic": ("deinterleave_dynamic",
                                       "interleave_dynamic"), "ref": ()}
    for impl, r in runs:
        if r["streams"] != runs[0][1]["streams"]:
            raise AssertionError(f"dense [{impl}]: other token streams than "
                                 f"under kernel")
        pre = r["prefill_launches"]
        if any((pre[k] > 0) != (k in want_prefill[impl]) for k in pre):
            raise AssertionError(f"dense [{impl}]: prefill launches {pre}")
        for n in r["step_launches"]:
            want = {k: int(k == want_step[impl]) for k in n}
            if n != want:
                raise AssertionError(f"dense [{impl}]: decode step launches "
                                     f"{n}, want {want}")
        decode_s = sum(r["step_ms"]) / 1e3
        print(f"dense serve[{impl}] {cfg.name} on {card}: prefill "
              f"{slots}x{DENSE_PROMPT} tokens {r['prefill_ms']:.3f} ms "
              f"(launches per prefill {pre}); median decode step "
              f"{statistics.median(r['step_ms']):.3f} ms over "
              f"{DENSE_STEPS} steps; decode tokens/s "
              f"{slots * DENSE_STEPS / decode_s:.2f}; launches per decode "
              f"step {r['step_launches'][0]}")
    print(f"dense streams equal under kernel, ref and kernel_dynamic in "
          f"{len(runs)} runs ({slots} x {DENSE_STEPS + 1} tokens); one fused "
          f"split launch "
          f"in each decode step (B1 under kernel, B6 under kernel_dynamic, "
          f"none under ref) ({time.perf_counter() - t0:.1f} s)")
    if "--profile" in sys.argv[1:]:
        profile_policies({impl: dense_serve(dev, cfg, params, impl, tokens,
                                            profiled=True)
                          for impl in ("kernel", "ref")})
    t0 = time.perf_counter()
    diffs = dense_vs_paged(dev, cfg, params, slots, page_size)
    print(f"dense step vs paged step under kernel, {ORACLE_STEPS} forced "
          f"steps, slots {slots}, page_size {page_size}: steps differing "
          f"from the fused dense step's logits, and the largest difference "
          f"{diffs} ({time.perf_counter() - t0:.1f} s)")
    if any(n for n, _ in diffs.values()):
        raise AssertionError(f"dense step vs paged step: logits differ "
                             f"{diffs}")
    del params
    torch.cuda.empty_cache()

    def report(cli):
        tail = [ln for ln in cli["lines"] if "tok/s on " in ln][0]
        print(f"serve CLI ({' '.join(CLI_ARGS)}): exit 0, every request "
              f"finished, {cli['wall_s']:.1f} s of wall time: {tail}")
    cli_runs((report, run_cli, card))


# ---------------------------------------------------------------------------
# Phase 8: the quantized page pool and prefix sharing
# ---------------------------------------------------------------------------

QUANT_POLICIES = ("kernel", "ref", "kernel_dynamic")
# (B1, B6) launches in each decode step, by policy
SPLIT = {"kernel": (1, 0), "kernel_dynamic": (0, 1), "ref": (0, 0)}
FORCED_STEPS = 8
PREFIX_LEN, TAIL_LEN, FORK_LEN = 64, 24, 8
QUANT_CLI_FLAGS = ("--kv-dtype", "int8", "--prefix-cache", "--chunk-pages",
                   "2", "--check-invariants")


def check_step_launches(name: str, impl: str, r: dict,
                        split: tuple | None = None) -> None:
    """The kernels of ``impl`` launched on the run and no other policy's;
    exactly one fused split per decode step (B1 under ``kernel``, B6 under
    ``kernel_dynamic``, none under ``ref``), or the (B1, B6) of ``split``
    in every decode step."""
    plan = ("deinterleave", "interleave")
    dynamic = ("deinterleave_dynamic", "interleave_dynamic")
    mine, other = {"kernel": (plan, dynamic),
                   "kernel_dynamic": (dynamic, plan),
                   "ref": ((), plan + dynamic)}[impl]
    if any(r["launches"][k] <= 0 for k in mine) or \
            any(r["launches"][k] != 0 for k in other):
        raise AssertionError(f"{name} [{impl}]: launches {r['launches']}")
    split = SPLIT[impl] if split is None else split
    if any(n != split for n in r["step_launches"]):
        raise AssertionError(f"{name} [{impl}]: fused split launches (B1, "
                             f"B6) per decode step {r['step_launches']}")


def forced_quant_gap(dev, cfg, params, slots: int, max_len: int,
                     page_size: int) -> tuple:
    """From empty caches, ``FORCED_STEPS`` steps of the int8 pool and the
    float32 pool on the float32 pool's own greedy tokens (forced teacher),
    fused, under ``kernel``.  Returns the worst logit gap and the
    reference's bound ``max(0.08, 0.03 * |logits|max)`` (tests/
    test_quant_pool.py), from the last step's float32 logits."""
    import numpy as np
    import torch
    from repro_torch.models import decode as dec
    cfg = dataclasses.replace(cfg, kernel_impl="kernel")
    cf = dec.init_paged_cache(cfg, slots, max_len, page_size, torch.float32,
                              device=dev)
    cq = dec.init_paged_cache(cfg, slots, max_len, page_size,
                              quantize="int8", device=dev)
    tok = torch.from_numpy(np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab, slots).astype(np.int32)).to(dev)
    worst = 0.0
    for _ in range(FORCED_STEPS):
        lf, cf = dec.paged_decode_step(params, cf, tok, cfg, fuse=True)
        lq, cq = dec.paged_decode_step(params, cq, tok, cfg, fuse=True)
        lf, lq = lf.float(), lq.float()
        if not bool(torch.isfinite(lq).all()):
            raise AssertionError("int8 pool: logits not finite")
        worst = max(worst, float((lf - lq).abs().max()))
        tok = torch.argmax(lf, dim=-1).to(torch.int32)
    bound = max(0.08, 0.03 * float(lf.abs().max()))
    del cf, cq
    torch.cuda.empty_cache()
    return worst, bound


def prefix_traffic(vocab: int, slots: int) -> list:
    """``slots`` prompts sharing a ``PREFIX_LEN``-token seeded prefix (4
    full pages at page_size 16), each with a distinct ``TAIL_LEN``-token
    tail; request 1's tail repeats the first ``FORK_LEN`` tokens of
    request 0's (its fifth page), so that its admission forks that page."""
    import numpy as np
    rng = np.random.default_rng(SEED + 9)
    prefix = rng.integers(0, vocab, PREFIX_LEN).tolist()
    tails = [rng.integers(0, vocab, TAIL_LEN).tolist() for _ in range(slots)]
    tails[1][:FORK_LEN] = tails[0][:FORK_LEN]
    return [prefix + t for t in tails]


def quant_prefix_phase(dev, cfg, card: str, prompts, gen: int, slots: int,
                       max_len: int, page_size: int, timing: dict) -> None:
    """Phase 8: the quantized pool (int8, fp8) and prefix sharing through
    the port's paged Scheduler at full width, the CLI with both, and B1 on
    the float32 dequantized stack."""
    import torch
    from repro_torch.kernels import segment
    from repro_torch.models.transformer import cast_params, init_params
    from repro_torch.serve.paged_cache import PagedCache
    params = cast_params(init_params(cfg, SEED, device=dev), cfg)
    # the bytes of one page, predicted from the geometry: K * 2D elements
    # of a beat, page_size beats, a float32 scale per head, every layer
    K, D2, NS = cfg.n_kv_heads, 2 * cfg.hd, cfg.n_superblocks
    pred_f32 = NS * page_size * K * D2 * 4
    pred_int8 = NS * (page_size * K * D2 + 4 * K)
    f32 = PagedCache(cfg, slots, max_len, page_size,
                     cache_dtype=torch.float32, device=dev)
    f32_page, f32_table = f32.page_bytes(), f32.state["table"]
    table_bytes = f32_table.numel() * f32_table.element_size()
    del f32
    torch.cuda.empty_cache()
    print(f"quant pool prediction: one page of every layer {pred_int8} B "
          f"int8 (with its scales) against {pred_f32} B float32, ratio "
          f"{pred_int8 / pred_f32:.4f}")
    for kv in ("int8", "fp8"):
        t0 = time.perf_counter()
        runs = [(impl, serve(dev, cfg, params, impl, prompts, gen, slots,
                             max_len, page_size, kv_quant=kv))
                for impl in QUANT_POLICIES]
        for impl, r in runs:
            check_step_launches(f"serve {kv}", impl, r)
            if r["streams"] != runs[0][1]["streams"]:
                raise AssertionError(f"serve {kv} [{impl}]: other token "
                                     f"streams than under kernel")
            decode_s = sum(r["step_ms"]) / 1e3
            f32_used = r["peak_pages"] * f32_page + table_bytes
            print(f"serve {kv}[{impl}] {cfg.name} on {card}: generated "
                  f"tokens/s over the whole run "
                  f"{r['tokens'] / r['wall_s']:.2f} ({r['tokens']} tokens "
                  f"in {r['wall_s']:.3f} s); decode-step tokens/s "
                  f"{sum(r['step_tokens']) / decode_s:.2f}; median decode "
                  f"step {statistics.median(r['step_ms']):.3f} ms over "
                  f"{r['decode_steps']} steps; used_cache_bytes at the "
                  f"peak ({r['peak_pages']} pages) {r['peak_used_bytes']} "
                  f"against the float32 pool's {f32_used}; page "
                  f"{r['page_bytes']} B against {f32_page} B, ratio "
                  f"{r['page_bytes'] / f32_page:.4f} (predicted "
                  f"{pred_int8 / pred_f32:.4f}); launches per decode step "
                  f"{r['step_launches'][0]}; launches {r['launches']}")
        if kv == "int8" and runs[0][1]["page_bytes"] != pred_int8:
            raise AssertionError(f"int8 page bytes "
                                 f"{runs[0][1]['page_bytes']} != predicted "
                                 f"{pred_int8}")
        print(f"serve {kv}: streams equal under kernel, ref and "
              f"kernel_dynamic; one fused split launch in each of "
              f"{len(runs[0][1]['step_launches'])} decode steps "
              f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    worst, bound = forced_quant_gap(dev, cfg, params, slots, max_len,
                                    page_size)
    print(f"int8 pool vs float32 pool, {FORCED_STEPS} forced-teacher steps "
          f"under kernel: worst logit gap {worst:.6f}, bound "
          f"max(0.08, 0.03 * |logits|max) = {bound:.6f} "
          f"({time.perf_counter() - t0:.1f} s)")
    if not worst <= bound:
        raise AssertionError(f"int8 pool: logit gap {worst} over the "
                             f"bound {bound}")
    traffic = prefix_traffic(cfg.vocab, slots)
    for pool in ("float32", "int8"):
        t0 = time.perf_counter()
        kw = dict(cache_dtype="float32", stagger=True, chunk_pages=2,
                  kv_quant=None if pool == "float32" else pool)
        off = serve(dev, cfg, params, "kernel", traffic, gen, slots,
                    max_len, page_size, **kw)
        on = serve(dev, cfg, params, "kernel", traffic, gen, slots, max_len,
                   page_size, prefix_cache=True, **kw)
        for name, r in (("off", off), ("on", on)):
            check_step_launches(f"prefix {name} {pool}", "kernel", r)
        px = on["prefix"]
        print(f"prefix cache [{pool} pool, kernel] on {card}: {slots} "
              f"requests of a {PREFIX_LEN}-token shared prefix + "
              f"{TAIL_LEN}-token tails, staggered, chunk_pages 2: hits "
              f"{px['hits']}, misses {px['misses']}, tokens reused "
              f"{px['tokens_reused']}, trie pages {px['pages']}, pages "
              f"shared (refcount > 1) at the peak {on['peak_shared']}, "
              f"forks {on['forks']}; "
              f"{on['prefill_chunks']} prefill chunks against "
              f"{off['prefill_chunks']} with the cache off; tokens/s over "
              f"the whole run {on['tokens'] / on['wall_s']:.2f} against "
              f"{off['tokens'] / off['wall_s']:.2f}; peak pages "
              f"{on['peak_pages']} against {off['peak_pages']}; streams "
              f"{'equal' if on['streams'] == off['streams'] else 'DIFFER'} "
              f"({time.perf_counter() - t0:.1f} s)")
        if on["streams"] != off["streams"]:
            raise AssertionError(f"prefix cache [{pool}]: streams differ "
                                 f"from the cache off")
        if px["hits"] <= 0 or on["forks"] < 1:
            raise AssertionError(f"prefix cache [{pool}]: {px['hits']} "
                                 f"hits, {on['forks']} forks")
    del params
    torch.cuda.empty_cache()

    def report(cli):
        tail = [ln for ln in cli["lines"] if "tok/s on " in ln][0]
        pline = [ln for ln in cli["lines"] if ln.startswith("prefix cache:")]
        print(f"serve CLI ({' '.join(CLI_ARGS + QUANT_CLI_FLAGS)}): exit 0, "
              f"every request finished, {cli['wall_s']:.1f} s of wall time: "
              f"{tail}; {pline[0] if pline else 'no prefix line'}")
        if not pline:
            raise AssertionError("serve CLI with --prefix-cache printed no "
                                 "prefix cache line")
    cli_runs((report, run_cli, card, QUANT_CLI_FLAGS))
    # B1 on the quantized step's operand: the float32 dequantized stack
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 10)
    kv = torch.randn((NS, slots, max_len, K, D2), generator=g, device=dev)
    R = kv.numel() // D2
    timing["deinterleave[f32 stack]"] = record(
        "deinterleave[f32 stack]", lambda: segment.deinterleave(kv, 2),
        lambda: segment.deinterleave_plain(kv, 2),
        lambda: kv.view(R, D2 // 2, 2).permute(2, 0, 1).contiguous(),
        2 * kv.numel() * kv.element_size(), list(kv.shape),
        f" (float32; {card})")
    del kv
    torch.cuda.empty_cache()
    time_paged_access(dev, cfg, card, slots, max_len, page_size)


def time_paged_access(dev, cfg, card: str, slots: int, max_len: int,
                      page_size: int) -> None:
    """The quantized step's page accesses alone (torch ops, no kernel; CUDA
    events over 20 calls): the one fused page gather of every layer's
    pool through a full table, int8 with its dequant against the bf16
    pool's, each beside its bytes' bound; and one decode beat's
    quantize-on-write into one layer's pool (launch-sized, timed at the
    host's launch rate)."""
    import torch
    from repro_torch import vx
    from repro_torch.kernels import kv_interleaved
    NS, K, D2 = cfg.n_superblocks, cfg.n_kv_heads, 2 * cfg.hd
    n_seq = max_len // page_size
    P = slots * n_seq
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 11)
    shape = (NS, P, page_size, K, D2)
    pools = {"int8": torch.randint(-127, 128, shape, generator=g,
                                   device=dev, dtype=torch.int8),
             "bfloat16": torch.randn(shape, generator=g,
                                     device=dev).to(torch.bfloat16)}
    scl = torch.rand((NS, P, K), generator=g, device=dev)
    table = torch.arange(P, dtype=torch.int32, device=dev).view(slots, n_seq)
    for name, pool in pools.items():
        sc = [scl] if name == "int8" else None
        out = kv_interleaved.gather_paged_kv([pool], table, page_size,
                                             scales=sc)[0]
        moved = pool.numel() * pool.element_size() + \
            out.numel() * out.element_size()
        ms = time_ms(lambda: kv_interleaved.gather_paged_kv(
            [pool], table, page_size, scales=sc), 20)
        print(f"time paged gather[{name} pool] {list(out.shape)} "
              f"{out.dtype}: {ms:.4f} ms, bound "
              f"{moved / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes) ({card})")
        del out
    spec = vx.Paged(page_size=page_size, pages=n_seq, trail=2)
    beat = torch.randn((slots, K, D2), generator=g, device=dev).to(
        torch.bfloat16)
    pos = torch.full((slots,), 37, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: vx.scatter(spec, pools["int8"][0], beat,
                                    table=table, pos=pos, scales=scl[0]), 20)
    print(f"time paged scatter[int8 pool, one decode beat of {slots} "
          f"slots into one layer]: {ms:.4f} ms a call ({card})")
    del pools, scl
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 9: the chaos harness and the replica fleet
# ---------------------------------------------------------------------------

# the reference's chaos geometry (tests/test_chaos.py) and fleet geometry
# (tests/test_fleet.py)
CHAOS_GEOM = dict(slots=2, max_len=16, page_size=4, num_pages=6,
                  queue_depth=3, guard_nan=True)
CHAOS_PLAN = dict(requests=6, steps=32, max_ticks=256)
FLEET_GEOM = dict(slots=2, max_len=16, page_size=4, guard_nan=True,
                  watchdog_hard_limit=30.0, hard_breach_limit=1)
FAULT_CLI = (
    ("--chaos", "5", "--requests", "6", "--gen", "6", "--check-invariants",
     "--prefix-cache", "--chunk-pages", "2"),
    ("--replicas", "3", "--kill-replica", "4", "--requests", "4",
     "--prompt-len", "6", "--gen", "8", "--max-len", "32", "--page-size",
     "4"),
    ("--replicas", "3", "--chaos", "0", "--requests", "6", "--gen", "6",
     "--max-len", "32", "--page-size", "4"),
    ("--replicas", "2", "--chaos", "7", "--requests", "6", "--gen", "6",
     "--max-len", "32", "--page-size", "4", "--kv-dtype", "int8"))


def count_steps(sched, steps: list, on_step=None) -> None:
    """Wrap ``sched.step``: append its fused split launches (B1, B6) to
    ``steps``, then call ``on_step(sched)``."""
    from repro_torch.kernels import segment
    plain = sched.step

    def step():
        d0 = (segment.deinterleave.launches,
              segment.deinterleave_dynamic.launches)
        out = plain()
        steps.append((segment.deinterleave.launches - d0[0],
                      segment.deinterleave_dynamic.launches - d0[1]))
        if on_step is not None:
            on_step(sched)
        return out
    sched.step = step


def counted_fleet(router, steps: list, on_step=None) -> list:
    """Count the steps of every replica the router holds or will spawn:
    a dead replica's steps stay counted.  Returns the list of every
    scheduler the router ran (it grows with each respawn)."""
    spawn = router._spawn
    scheds = [rep.sched for rep in router.replicas]

    def counted_spawn(idx, generation):
        rep = spawn(idx, generation)
        count_steps(rep.sched, steps, on_step)
        scheds.append(rep.sched)
        return rep
    router._spawn = counted_spawn
    for rep in router.replicas:
        count_steps(rep.sched, steps, on_step)
    return scheds


def check_split(name: str, impl: str, steps: list) -> None:
    """Exactly one fused split per decode step: B1 under ``kernel``, B6
    under ``kernel_dynamic``, none under ``ref``."""
    if not steps or any(n != SPLIT[impl] for n in steps):
        raise AssertionError(f"{name} [{impl}]: fused split launches (B1, "
                             f"B6) per decode step {steps}")


def check_typed(name: str, reqs) -> None:
    bad = [(r.rid, r.state.value, r.error) for r in reqs
           if not r.terminal or (r.state.value == "failed" and not r.error)]
    if bad:
        raise AssertionError(f"{name}: requests outside a terminal typed "
                             f"state: {bad}")


def chaos_single(dev, cfg, params, impl: str, seed: int, plan_kw=None,
                 **sched_kw) -> dict:
    """One seeded chaos run over one Scheduler on the chaos geometry; the
    pool audited every tick (``run_plan``)."""
    import torch
    from repro_torch.ft.straggler import StepWatchdog
    from repro_torch.serve.chaos import (ChaosConfig, FaultPlan, StepClock,
                                         run_plan)
    from repro_torch.serve.scheduler import Scheduler
    sched = Scheduler(dataclasses.replace(cfg, kernel_impl=impl), params,
                      watchdog=StepWatchdog(), clock=StepClock(),
                      device=dev, **{**CHAOS_GEOM, **sched_kw})
    steps = []
    count_steps(sched, steps)
    plan = FaultPlan(ChaosConfig(seed=seed, **CHAOS_PLAN, **(plan_kw or {})))
    t0 = time.perf_counter()
    rep = run_plan(sched, plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    name = f"chaos seed {seed} {sched_kw or ''}"
    if rep.ticks >= plan.cfg.max_ticks or not sched.drained():
        raise AssertionError(f"{name} [{impl}]: never drained")
    check_typed(f"{name} [{impl}]", rep.submitted)
    if rep.invariant_checks < rep.ticks:
        raise AssertionError(f"{name} [{impl}]: {rep.invariant_checks} "
                             f"audits over {rep.ticks} ticks")
    check_split(name, impl, steps)
    if len(steps) != sched.decode_steps:
        raise AssertionError(f"{name} [{impl}]: {len(steps)} counted steps, "
                             f"{sched.decode_steps} decode steps")
    return {"report": (rep.ticks, rep.states, rep.preemptions,
                       rep.nan_failures, rep.backpressured),
            "streams": [(r.state.value, r.tokens) for r in rep.submitted],
            "checks": rep.invariant_checks, "steps": len(steps),
            "wall_s": wall, "evicted": (sched.stats().get("prefix") or
                                        {}).get("evicted")}


def nan_isolation(dev, cfg, params) -> dict:
    """The reference's NaN-guard traffic (tests/test_chaos.py): the victim
    alone fails, the neighbour's stream equals its solo stream."""
    import numpy as np
    from repro_torch.serve.scheduler import Scheduler

    def mk():
        return Scheduler(dataclasses.replace(cfg, kernel_impl="kernel"),
                         params, slots=2, max_len=16, page_size=4,
                         guard_nan=True, device=dev)
    solo = mk()
    r_solo = solo.submit([11, 13], max_new_tokens=6)
    while not r_solo.terminal:
        solo.tick()
    chaotic = mk()
    victim = chaotic.submit([2, 4, 6], max_new_tokens=6)
    neighbour = chaotic.submit([11, 13], max_new_tokens=6)
    chaotic.tick()
    taint = np.zeros(2, bool)
    taint[victim.slot] = True
    chaotic._taint = taint
    while not (victim.terminal and neighbour.terminal):
        chaotic.tick()
    chaotic.cache.check_invariants()
    ok = (victim.state.value == "failed" and "non-finite" in victim.error
          and chaotic.nan_failures == 1
          and neighbour.state.value == "finished"
          and neighbour.tokens == r_solo.tokens
          and chaotic.cache.pages_in_use() == 0)
    if not ok:
        raise AssertionError(f"NaN guard: victim {victim.state.value} "
                             f"({victim.error}), nan_failures "
                             f"{chaotic.nan_failures}, neighbour "
                             f"{neighbour.tokens} against solo "
                             f"{r_solo.tokens}")
    return {"victim": victim.error, "neighbour": neighbour.tokens}


def record_logits(rid_index: dict, logits: dict):
    """An ``on_step`` hook: the logits row of each decoding slot, keyed by
    (request, replay cursor)."""
    def on_step(sched):
        for s, req in enumerate(sched._slot_req):
            if req is not None and sched.active[s] and \
                    s not in sched._prefilling:
                logits[(rid_index[req.rid], sched._fed[s])] = \
                    sched.last_logits[s].float().cpu()
    return on_step


def migration_run(dev, cfg, params, prompts, gen: int, slots: int,
                  max_len: int, page_size: int) -> dict:
    """Phase 9's migration at the serve size: the uninterrupted 1-replica
    run, then 2 replicas with the replica holding request 0 killed twice
    (mid-decode, then once its migrated requests have all made a new
    token): streams equal, the logit gap at the shared positions, the
    recovery of each kill, memory_allocated around both respawns."""
    import gc
    import torch
    from repro_torch.kernels import segment
    from repro_torch.serve.fleet import FleetRouter
    kcfg = dataclasses.replace(cfg, kernel_impl="kernel")
    kw = dict(slots=slots, max_len=max_len, page_size=page_size, device=dev)

    def submit(router):
        reqs = [router.submit(p, max_new_tokens=gen) for p in prompts]
        return reqs, {r.rid: i for i, r in enumerate(reqs)}

    one = FleetRouter(kcfg, params, replicas=1, **kw)
    la, steps_a = {}, []
    reqs_a, idx_a = submit(one)
    counted_fleet(one, steps_a, record_logits(idx_a, la))
    while not one.drained():
        one.tick()
        one.audit()
    torch.cuda.synchronize()
    want = [r.tokens for r in reqs_a]
    del one
    gc.collect()
    torch.cuda.empty_cache()

    fl = FleetRouter(kcfg, params, replicas=2, **kw)
    lb, steps_b = {}, []
    reqs, idx = submit(fl)
    scheds = counted_fleet(fl, steps_b, record_logits(idx, lb))
    segment.reset_counts()

    def cur_len(r):
        rep = fl.replicas[r.replica] if r.replica is not None else None
        if rep is not None and rep.alive and r.slot is not None and \
                rep.sched._slot_req[r.slot] is r:
            return len(rep.sched.tokens[r.slot])
        return len(r.tokens)

    kills, mem, pending = [], [], None
    while not fl.drained() and fl.tick_no < 40 * (gen + 8):
        if pending is None and len(kills) < 2 and \
                reqs[0].state.value == "running" and \
                cur_len(reqs[0]) - len(prompts[0]) >= \
                (gen // 2 if not kills else gen - 4):
            torch.cuda.synchronize()
            gc.collect()
            mem.append(torch.cuda.memory_allocated())
            victim = reqs[0].replica
            moved = [r for r in reqs if r.replica == victim
                     and not r.terminal]
            at = {r.rid: cur_len(r) for r in moved}
            fl.kill_replica(victim, reason="phase 9 kill")
            pending = {"tick": fl.tick_no, "t0": time.perf_counter(),
                       "moved": moved, "at": at, "done": {}}
        fl.tick()
        fl.audit()
        if pending is not None:
            if "mem_after" not in pending and \
                    fl.respawns == len(kills) + 1:
                torch.cuda.synchronize()
                gc.collect()
                pending["mem_after"] = torch.cuda.memory_allocated()
            for r in pending["moved"]:
                if r.rid not in pending["done"] and \
                        cur_len(r) > pending["at"][r.rid]:
                    torch.cuda.synchronize()
                    pending["done"][r.rid] = (
                        fl.tick_no - pending["tick"],
                        (time.perf_counter() - pending["t0"]) * 1e3)
            if len(pending["done"]) == len(pending["moved"]) or \
                    all(r.terminal for r in pending["moved"]):
                kills.append(pending)
                mem.append(pending["mem_after"])
                pending = None
    torch.cuda.synchronize()
    b2, chunks = segment.interleave.launches, sum(s.prefill_chunks
                                                  for s in scheds)
    got = [r.tokens for r in reqs]
    if not fl.drained() or len(kills) != 2 or pending is not None:
        raise AssertionError(f"migration: drained {fl.drained()}, "
                             f"{len(kills)} kills recovered")
    check_typed("migration", reqs)
    if got != want:
        raise AssertionError("migration: migrated streams differ from the "
                             "uninterrupted run's")
    for r in kills[0]["moved"] + kills[1]["moved"]:
        if r.migrations < 1:
            raise AssertionError(f"migration: request {r.rid} never moved")
    shared = sorted(set(la) & set(lb))
    gap = max(float((la[k] - lb[k]).abs().max()) for k in shared)
    unequal = sum(1 for k in shared if not torch.equal(la[k], lb[k]))
    if mem[1] > mem[0] or mem[2] > mem[0]:
        raise AssertionError(f"migration: memory_allocated grew across "
                             f"respawns {mem}")
    check_split("migration", "kernel", steps_a)
    check_split("migration", "kernel", steps_b)
    if b2 != cfg.n_superblocks * chunks:
        raise AssertionError(f"migration: {b2} B2 launches over {chunks} "
                             f"prefill chunks")
    return {"kills": kills, "mem": mem, "gap": gap, "unequal": unequal,
            "b2": b2, "chunks": chunks,
            "shared": len(shared), "deaths": fl.deaths,
            "respawns": fl.respawns, "migrated": fl.migrated}


def fleet_chaos(dev, cfg, params, impl: str) -> dict:
    """FleetFaultPlan(FleetChaosConfig(seed=0, replicas=3)) on the test
    geometry, the fleet audit every tick (``run_fleet_plan``)."""
    import torch
    from repro_torch.serve.chaos import (FleetChaosConfig, FleetFaultPlan,
                                         StepClock, run_fleet_plan)
    from repro_torch.serve.fleet import FleetRouter
    router = FleetRouter(dataclasses.replace(cfg, kernel_impl=impl), params,
                         replicas=3, clock=StepClock(), device=dev,
                         **FLEET_GEOM)
    steps = []
    counted_fleet(router, steps)
    plan = FleetFaultPlan(FleetChaosConfig(seed=0, replicas=3))
    t0 = time.perf_counter()
    rep = run_fleet_plan(router, plan)
    torch.cuda.synchronize()            # outside any catch
    wall = time.perf_counter() - t0
    name = f"fleet chaos [{impl}]"
    if rep.ticks >= plan.cfg.max_ticks or not router.drained():
        raise AssertionError(f"{name}: never drained")
    check_typed(name, rep.submitted)
    if rep.audits != rep.ticks:
        raise AssertionError(f"{name}: {rep.audits} audits, {rep.ticks} "
                             f"ticks")
    crashed = [r.death_reason for r in router.replicas
               if (r.death_reason or "").startswith("tick crashed")]
    if crashed or rep.deaths < 1:
        raise AssertionError(f"{name}: deaths {rep.deaths}, crashed "
                             f"{crashed}")
    check_split(name, impl, steps)
    return {"report": (rep.ticks, rep.states, rep.deaths, rep.respawns,
                       rep.migrated, rep.drains, rep.recovered,
                       rep.backpressured, rep.audits),
            "streams": [(r.state.value, r.tokens) for r in rep.submitted],
            "steps": len(steps), "wall_s": wall}


def leaf_ptrs(tree) -> list:
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in leaf_ptrs(v)]
    return [tree.data_ptr()]


def fleet_serve(dev, cfg, params, prompts, gen: int, slots: int,
                max_len: int, page_size: int) -> dict:
    """The serve cell through a 3-replica fleet without faults, under
    ``kernel``: whole-run tokens/s (host clock, prefill included)."""
    import torch
    from repro_torch.serve.fleet import FleetRouter
    router = FleetRouter(dataclasses.replace(cfg, kernel_impl="kernel"),
                         params, replicas=3, slots=slots, max_len=max_len,
                         page_size=page_size, device=dev)
    ptrs = [leaf_ptrs(rep.sched.params) for rep in router.replicas]
    if any(p != leaf_ptrs(params) for p in ptrs):
        raise AssertionError("fleet: replicas hold other weight copies")
    reqs = [router.submit(p, max_new_tokens=gen) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not router.drained():
        router.tick()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_typed("fleet serve", reqs)
    return {"streams": [r.tokens for r in reqs], "wall_s": wall,
            "tokens": sum(r.generated for r in reqs),
            "ticks": router.tick_no,
            "steps": sum(rep.sched.decode_steps for rep in router.replicas),
            "placed": [r.replica for r in reqs]}


def run_fault_cli(card: str, flags, arch: str = "qwen3-0.6b") -> dict:
    """Phase 9's CLI runs at full width in a subprocess: exit 0, every
    request terminal, the chaos runs' terminal-state line printed (phase
    12: ``arch`` names another arch)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", arch, *flags], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    terminal = ("finished", "failed", "timed_out")
    reqs = [ln for ln in lines if ln.startswith("req ")]
    ok = out.returncode == 0
    if "--chaos" in flags:
        ok = ok and any(ln.startswith("every request reached a terminal "
                                      "typed state") for ln in lines)
    else:
        ok = ok and reqs and all(ln.split()[2] in terminal for ln in reqs) \
            and any(ln.startswith("fleet:") and "deaths=1 " in ln
                    for ln in lines)
    if not ok:
        raise AssertionError(f"serve CLI {' '.join(flags)} exited "
                             f"{out.returncode}:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    return {"lines": lines, "wall_s": wall}


def chaos_fleet_phase(dev, cfg, card: str, prompts, gen: int, slots: int,
                      max_len: int, page_size: int) -> None:
    """Phase 9: chaos over one scheduler, the NaN guard, migration at the
    serve size, fleet chaos, the CLI's fault modes, and a fleet's
    throughput beside one scheduler's, qwen3-0.6b at full width in bf16."""
    import torch
    from repro_torch.models.transformer import cast_params, init_params
    t_phase = time.perf_counter()
    params = cast_params(init_params(cfg, SEED, device=dev), cfg)

    t0 = time.perf_counter()
    runs = {impl: chaos_single(dev, cfg, params, impl, 0)
            for impl in ("kernel", "ref", "kernel_dynamic")}
    for impl, r in runs.items():
        if (r["report"], r["streams"]) != (runs["kernel"]["report"],
                                           runs["kernel"]["streams"]):
            raise AssertionError(f"chaos seed 0 [{impl}]: another report or "
                                 f"other streams than under kernel")
    seeds = {s: chaos_single(dev, cfg, params, "kernel", s) for s in (1, 2)}
    extra = {"prefix_cache=True, chunk_pages=2, p_evict=0.15": chaos_single(
                 dev, cfg, params, "kernel", 0, dict(p_evict=0.15),
                 prefix_cache=True, chunk_pages=2),
             "kv_quant=int8": chaos_single(dev, cfg, params, "kernel", 0,
                                           kv_quant="int8")}
    for name, r in [("seed 0, kernel / ref / kernel_dynamic", runs["kernel"])] \
            + [(f"seed {s}, kernel", r) for s, r in seeds.items()] \
            + [(f"seed 0, {k}", r) for k, r in extra.items()]:
        ticks, states, pre, nan, bp = r["report"]
        print(f"chaos [{name}] {cfg.name} on {card}: {ticks} ticks, states "
              f"{states}, preemptions {pre}, nan_failures {nan}, "
              f"backpressured {bp}, invariant checks {r['checks']}, "
              f"{r['steps']} decode steps each with one fused split"
              + (f", trie pages evicted {r['evicted']}"
                 if r["evicted"] is not None else "")
              + f"; {r['wall_s']:.3f} s")
    print(f"chaos: reports and streams equal under kernel, ref and "
          f"kernel_dynamic; every request terminal, drained, the pool "
          f"audited every tick ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    nan = nan_isolation(dev, cfg, params)
    print(f"NaN guard on {card}: the victim failed ({nan['victim']}), "
          f"nan_failures 1, the neighbour's stream equal to its solo stream "
          f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    mig = migration_run(dev, cfg, params, prompts, gen, slots, max_len,
                        page_size)
    for k, kill in enumerate(mig["kills"]):
        rec = ", ".join(f"request {r.rid}: {kill['done'][r.rid][0]} ticks "
                        f"{kill['done'][r.rid][1]:.3f} ms"
                        for r in kill["moved"] if r.rid in kill["done"])
        print(f"migration kill {k + 1} at fleet tick {kill['tick']} on "
              f"{card}: {len(kill['moved'])} requests moved; recovery to "
              f"the first new token on the new replica: {rec}")
    print(f"migration at the serve size (2 replicas, slots {slots}, max_len "
          f"{max_len}, page_size {page_size}, kernel) on {card}: streams "
          f"equal to the uninterrupted 1-replica run; deaths "
          f"{mig['deaths']}, respawns {mig['respawns']}, migrated "
          f"{mig['migrated']}; B2 launches {mig['b2']} over "
          f"{mig['chunks']} prefill chunks, re-prefills included; largest "
          f"logit gap at {mig['shared']} shared "
          f"positions {mig['gap']} ({mig['unequal']} rows not bit-equal); "
          f"memory_allocated before the kill {mig['mem'][0]}, after the "
          f"respawn {mig['mem'][1]}, after a second kill/respawn "
          f"{mig['mem'][2]} ({time.perf_counter() - t0:.1f} s)")
    if mig["unequal"]:
        print("migration: logits differ at shared positions (a finding for "
              "ROADMAP C): streams equal, rows not bit-equal")

    t0 = time.perf_counter()
    fleet = {impl: fleet_chaos(dev, cfg, params, impl)
             for impl in ("kernel", "ref", "kernel_dynamic")}
    for impl, r in fleet.items():
        if (r["report"], r["streams"]) != (fleet["kernel"]["report"],
                                           fleet["kernel"]["streams"]):
            raise AssertionError(f"fleet chaos [{impl}]: another report or "
                                 f"other streams than under kernel")
        (ticks, states, deaths, respawns, migrated, drains, recovered, bp,
         audits) = r["report"]
        print(f"fleet chaos seed 0 [{impl}] {cfg.name} on {card}: {ticks} "
              f"ticks, states {states}, deaths {deaths} (none crashed), "
              f"respawns {respawns}, migrated {migrated}, drains {drains}, "
              f"recovered {recovered}, backpressured {bp}, audits {audits}; "
              f"{r['steps']} decode steps over every replica, each with "
              f"{SPLIT[impl]} (B1, B6) launches; {r['wall_s']:.3f} s")
    print(f"fleet chaos: reports and streams equal under kernel, ref and "
          f"kernel_dynamic ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    order = ("single", "fleet", "fleet", "single")
    thr = []
    for kind in order:
        if kind == "single":
            r = serve(dev, cfg, params, "kernel", prompts, gen, slots,
                      max_len, page_size)
            thr.append((kind, r["tokens"] / r["wall_s"], r["streams"],
                        f"{r['decode_steps']} decode steps"))
        else:
            r = fleet_serve(dev, cfg, params, prompts, gen, slots, max_len,
                            page_size)
            thr.append((kind, r["tokens"] / r["wall_s"], r["streams"],
                        f"{r['steps']} decode steps over {r['ticks']} fleet "
                        f"ticks, requests on replicas {r['placed']}"))
    for kind, tps, streams, what in thr:
        if streams != thr[0][2]:
            raise AssertionError("fleet serve: other streams than the single "
                                 "scheduler's")
        print(f"throughput [{kind}{' of 3 replicas' if kind == 'fleet' else ''}"
              f", kernel] {cfg.name} on {card}: whole-run tokens/s "
              f"{tps:.2f} ({what})")
    single = [t for k, t, _, _ in thr if k == "single"]
    multi = [t for k, t, _, _ in thr if k == "fleet"]
    print(f"throughput: 3-replica fleet / one scheduler "
          f"{statistics.mean(multi) / statistics.mean(single):.4f} "
          f"({time.perf_counter() - t0:.1f} s)")
    del params
    torch.cuda.empty_cache()

    def report(flags):
        def fn(cli):
            tail = [ln for ln in cli["lines"]
                    if ln.startswith(("chaos seed", "fleet chaos seed",
                                      "fleet:"))]
            print(f"serve CLI (--arch qwen3-0.6b {' '.join(flags)}): exit "
                  f"0, every request terminal, {cli['wall_s']:.1f} s of "
                  f"wall time: {tail[0] if tail else ''}")
        return fn
    cli_runs(*[(report(f), run_fault_cli, card, f) for f in FAULT_CLI])
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 10: speculative decode and vx.scatter_many
# ---------------------------------------------------------------------------

SPEC_K = 4
# the drafts: the target's own weights (seed 0), and another draw (seed 1)
DRAFT_SEEDS = (SEED, SEED + 1)
SPEC_POLICIES = ("kernel", "ref", "kernel_dynamic")
SEG_ORDER = ("deinterleave", "interleave", "deinterleave_dynamic",
             "interleave_dynamic")
SPEC_CLI_FLAGS = ("--speculate", "4", "--stats")
SPEC_FAULT_CLI = ("--replicas", "3", "--chaos", "0", "--requests", "6",
                  "--gen", "6", "--max-len", "32", "--page-size", "4",
                  "--kv-dtype", "int8", "--speculate", "4", "--stats")


def seg_delta(before: dict) -> tuple:
    """(B1, B2, B6, B7) launches since ``before`` (a ``segment_counts()``)."""
    now = segment_counts()
    return tuple(now[k] - before[k] for k in SEG_ORDER)


def attn_layers(cfg) -> int:
    """The attention layers of the stack (every layer but a recurrent
    stack's Mamba and xLSTM blocks)."""
    return cfg.n_superblocks * cfg.block_pattern.count("attn")


def glu_layers(cfg) -> int:
    """The layers whose FFN is a fused SwiGLU (not MoE, not the GELU MLP):
    each splits its gate / up rows through B1 / B6."""
    return cfg.n_superblocks * sum(
        1 for i in range(cfg.sb_len) if cfg.pos_has_ffn(i)
        and not cfg.moe_pattern[i] and cfg.mlp == "swiglu" and cfg.fused_glu)


def verify_prediction(cfg, impl: str, slots: int, k: int) -> tuple:
    """(B1, B2, B6, B7) launches of one verify step, read off the code
    (``models/decode.paged_verify_step``): ONE fused split of every
    layer's pre-append pages; per layer the (B, K) beat split and re-pack
    when ``B*K*n_kv*2*hd`` reaches the policy's launch threshold, and in
    each fused SwiGLU layer (not MoE, not the GELU MLP) the GLU split when
    ``B*K*2*d_ff`` does (``Policy.for_elems``).  At ``k=1`` the same
    reading gives ``paged_decode_step``: a draft model's, and phase 11's
    and 12's decode steps (a stack without attention gathers no page and
    splits nothing)."""
    from repro_torch import vx
    if impl == "ref":
        return (0, 0, 0, 0)
    pol = vx.Policy(impl=impl)
    beat = pol.for_elems(slots * k * cfg.n_kv_heads * 2 * cfg.hd).impl
    glu = pol.for_elems(slots * k * 2 * cfg.d_ff).impl
    layers = attn_layers(cfg)
    split = (layers > 0) + layers * (beat != "ref") \
        + glu_layers(cfg) * (glu != "ref")
    pack = layers * (beat != "ref")
    return (split, pack, 0, 0) if impl == "kernel" else (0, 0, split, pack)


class counted_calls:
    """Wrap functions of ``repro_torch.models.decode`` for the length of a
    ``with``: each call appends ``(name, (B1, B2, B6, B7) launches)`` to
    ``log``.  The scheduler reads them through the module, so every
    verify step, draft step and prefill chunk is seen."""

    NAMES = ("paged_verify_step", "paged_decode_step", "paged_prefill_chunk")

    def __init__(self, log: list):
        from repro_torch.models import decode
        self.mod, self.log = decode, log
        self.real = {n: getattr(decode, n) for n in self.NAMES}

    def __enter__(self):
        def wrap(name, fn):
            def inner(*a, **k):
                before = segment_counts()
                out = fn(*a, **k)
                self.log.append((name, seg_delta(before)))
                return out
            return inner
        for n, fn in self.real.items():
            setattr(self.mod, n, wrap(n, fn))
        return self.log

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.mod, n, fn)


def clone_cache(cache: dict) -> dict:
    return {k: ({b: t.clone() for b, t in v.items()} if k == "blocks"
                else v.clone()) for k, v in cache.items()}


def verify_decode_level(dev, cfg, params, impl: str, prompts, gen: int,
                        slots: int, max_len: int, page_size: int,
                        dtype) -> dict:
    """Phase 10a: ``paged_verify_step`` at K = SPEC_K fed the plain
    ``paged_decode_step`` oracle's stream as drafts, then the same drafts
    corrupted: round 0 rejects every draft of every slot; slot 0 is then
    steered onto a page boundary and rejected exactly there (the page the
    verify allocated past it must come back); slots 1-3 reject at drafts
    2, 3 and 1 of rounds 2, 3 and 4.  Every round: ``paged_invariants``
    clean, the launches of the verify step.  Returns the committed
    streams, commits, the oracle's streams, the largest logit gap over
    the committed prefix that agrees with the oracle, and the first
    disagreement with the plain run's top-2 margin there."""
    import numpy as np
    import torch
    from repro_torch.models import decode as dec
    c = dataclasses.replace(cfg, kernel_impl=impl)
    K, ps = SPEC_K, page_size
    base = dec.init_paged_cache(c, slots, max_len, ps, dtype, device=dev)
    for s, p in enumerate(prompts):
        pre = p[:-1]
        for i in range(0, len(pre), ps):
            chunk = pre[i:i + ps]
            tok = torch.tensor(chunk + [0] * (ps - len(chunk)),
                               dtype=torch.int32, device=dev)
            base = dec.paged_prefill_chunk(params, base, tok, c, slot=s,
                                           count=len(chunk))
    heads = [p[-1] for p in prompts]
    oc = clone_cache(base)
    cur = torch.tensor(heads, dtype=torch.int32, device=dev)
    ostream = [[h] for h in heads]
    ologits = [[] for _ in range(slots)]
    for _ in range(gen + K):
        lg, oc = dec.paged_decode_step(params, oc, cur, c)
        cur = torch.argmax(lg.float(), dim=-1).to(torch.int32)
        for s, t in enumerate(cur.tolist()):
            ostream[s].append(t)
            ologits[s].append(lg[s].float())
    del oc
    # the tolerance a verify-plain logit gap is held to: the bound the repo
    # gives a quantized step, max(0.08, 0.03 |logits|max)
    tol = max(0.08, 0.03 * max(float(t.abs().max()) for row in ologits
                               for t in row))
    nd = torch.full((slots,), K, dtype=torch.int32, device=dev)
    runs = {}
    for kind in ("perfect", "corrupted"):
        vc = clone_cache(base)
        stream = [[h] for h in heads]
        commits, launches, boundary = [], [], None
        gap, first = 0.0, None
        rnd = 0
        while min(len(t) for t in stream) <= gen and rnd < 8 * gen:
            toks = np.zeros((slots, K), np.int32)
            bad = set()
            if kind == "corrupted":
                if rnd == 0:
                    bad = {(s, 1) for s in range(slots)}
                else:
                    bad = {(s, j) for r, s, j in ((2, 1, 2), (3, 2, 3),
                                                  (4, 3, 1)) if r == rnd}
                    if boundary is None:
                        pos0 = len(prompts[0]) - 1 + len(stream[0]) - 1
                        d = ps - pos0 % ps
                        if d < K:
                            bad.add((0, d))      # commit d: on the boundary
                            boundary = (rnd, (pos0 + d) // ps)
                        elif min(K, d - 1) < K:
                            bad.add((0, min(K, d - 1)))
            for s in range(slots):
                fed = len(stream[s])
                toks[s, 0] = stream[s][-1]
                for j in range(1, K):
                    i = fed - 1 + j
                    t = ostream[s][i] if i < len(ostream[s]) else 0
                    toks[s, j] = (t + 1) % cfg.vocab if (s, j) in bad else t
            before = segment_counts()
            lg, o, cm, vc = dec.paged_verify_step(
                params, vc, torch.from_numpy(toks).to(dev), c, n_draft=nd)
            launches.append(seg_delta(before))
            host = torch.cat([o, cm[:, None]], dim=1).cpu().numpy()
            commits.append(host[:, K].tolist())
            for s in range(slots):
                for j in range(int(host[s, K])):
                    i = len(stream[s])
                    stream[s].append(int(host[s, j]))
                    if first is None and i < len(ostream[s]):
                        gap = max(gap, float(
                            (lg[s, j].float() - ologits[s][i - 1]).abs()
                            .max()))
                        if stream[s][i] != ostream[s][i]:
                            top2 = torch.topk(ologits[s][i - 1], 2).values
                            first = {"slot": s, "position": i,
                                     "margin": float(top2[0] - top2[1]),
                                     "got": stream[s][i],
                                     "want": ostream[s][i]}
            bad_inv = dec.paged_invariants(c, vc)
            if bad_inv:
                raise AssertionError(f"verify [{impl}, {kind}] round {rnd}: "
                                     f"{bad_inv}")
            if boundary is not None and boundary[0] == rnd:
                pos0 = int(vc["pos"][0])
                if pos0 % ps or int(vc["table"][0, boundary[1]]) != -1:
                    raise AssertionError(f"verify [{impl}]: the page past "
                                         f"the boundary at {pos0} was not "
                                         f"rolled back")
            rnd += 1
        if kind == "corrupted" and boundary is None:
            raise AssertionError("verify: slot 0 never reached a boundary")
        runs[kind] = {"streams": stream, "commits": commits,
                      "launches": launches, "gap": gap, "first": first,
                      "boundary": boundary}
    del base
    torch.cuda.empty_cache()
    return {"runs": runs, "oracle": ostream, "tol": tol}


def check_verify_run(name: str, impl: str, r: dict, gen: int,
                     pred: tuple) -> list:
    """The decode-level checks of one policy's run; returns the flips
    (first disagreements with the oracle) for the caller to judge."""
    flips = []
    for kind, run in r["runs"].items():
        if any(n != pred for n in run["launches"]):
            raise AssertionError(f"{name} [{impl}, {kind}]: launches (B1, "
                                 f"B2, B6, B7) per verify step "
                                 f"{run['launches']}, predicted {pred}")
        if run["first"] is not None:
            flips.append((kind, run["first"], run["gap"]))
            continue
        for s, st in enumerate(run["streams"]):
            if st[:gen + 1] != r["oracle"][s][:gen + 1]:
                raise AssertionError(f"{name} [{impl}, {kind}]: slot {s} "
                                     f"stream differs from the oracle")
        if kind == "perfect" and any(
                n != SPEC_K for row in run["commits"] for n in row):
            raise AssertionError(f"{name} [{impl}]: perfect drafts committed "
                                 f"{run['commits']}, want {SPEC_K} a launch")
        if kind == "corrupted" and run["commits"][0] != [1] * len(
                run["commits"][0]):
            raise AssertionError(f"{name} [{impl}]: the reject-all round "
                                 f"committed {run['commits'][0]}")
    return flips


def spec_serve(dev, cfg, params, draft_params, impl: str, prompts, gen: int,
               slots: int, max_len: int, page_size: int,
               **serve_kw) -> dict:
    """Phase 4's serve run with speculation (K = SPEC_K, a draft of the
    target's arch): adds the launches of every verify step, draft step
    and prefill chunk."""
    log: list = []
    with counted_calls(log):
        r = serve(dev, cfg, params, impl, prompts, gen, slots, max_len,
                  page_size, speculate=SPEC_K,
                  draft_cfg=dataclasses.replace(cfg, kernel_impl=impl),
                  draft_params=draft_params, **serve_kw)
    by = {n: [d for m, d in log if m == n] for n in counted_calls.NAMES}
    r.update(verify=by["paged_verify_step"], draft=by["paged_decode_step"],
             chunks=by["paged_prefill_chunk"])
    return r


def first_divergence(streams, want) -> tuple | None:
    for r, (a, b) in enumerate(zip(streams, want)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return r, i
    return None


def scatter_many_phase(dev, cfg, slots: int, max_len: int, timing: dict,
                       launches: dict) -> None:
    """Phase 10d: ``vx.scatter_many`` at the KV stack, 28 groups of K / V
    ``(4, 512, 8, 128)`` bf16: one launch a call (B2 under ``kernel``, B7
    under ``kernel_dynamic``), equal bit for bit to the plain version and
    to the per-group ``interleave``.  Timed in turns (B2 on the stacked
    fields, the verb under ``kernel``, under ``kernel_dynamic``, then the
    same in reverse), 50 calls each, so that a clock that ramps during the
    window weighs on every one alike."""
    import torch
    from repro_torch import vx
    from repro_torch.kernels import segment
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 10)
    hd = cfg.hd
    shape = (slots, max_len, cfg.n_kv_heads, hd)
    groups = [[torch.randn(shape, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2)] for _ in range(cfg.n_layers)]
    spec = vx.Segment(n=2 * hd, fields=2)
    plain = segment.interleave_plain([torch.stack([grp[f] for grp in groups])
                                      for f in range(2)])
    for impl, fn in (("kernel", "interleave"),
                     ("kernel_dynamic", "interleave_dynamic")):
        before = segment_counts()
        out = vx.scatter_many(spec, groups, policy=impl)
        torch.cuda.synchronize()
        n = seg_delta(before)
        want = (0, 1, 0, 0) if impl == "kernel" else (0, 0, 0, 1)
        launches[fn] += n[SEG_ORDER.index(fn)]
        if n != want:
            raise AssertionError(f"scatter_many [{impl}]: (B1, B2, B6, B7) "
                                 f"launches {n}, want {want}")
        for a, (o, grp) in enumerate(zip(out, groups)):
            if not (same_bits(o, plain[a]) and same_bits(
                    o, vx.transpose(spec, grp, policy=impl))):
                raise AssertionError(f"scatter_many [{impl}]: group {a} "
                                     f"differs from the plain version")
        del out
    stacked = [torch.stack([grp[f] for grp in groups]) for f in range(2)]
    fns = {"B2 on the stacked fields": lambda: segment.interleave(stacked),
           "kernel": lambda: vx.scatter_many(spec, groups, policy="kernel"),
           "kernel_dynamic": lambda: vx.scatter_many(
               spec, groups, policy="kernel_dynamic")}
    order = list(fns) + list(fns)[::-1]
    ms = {k: [] for k in fns}
    for k in order:
        ms[k].append(time_ms(fns[k], 50))
    b2 = timing["interleave[stack]"]
    print(f"time scatter_many {cfg.n_layers} groups of {list(shape)} x2 "
          f"bf16, one launch a call, == plain == per-group interleave bit "
          f"for bit, in turns {order}: "
          + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms"
                      for k, v in ms.items())
          + f"; bound {b2['bound_ms']:.4f} ms (the stack's bytes, without "
          f"the stacking), library {b2['library_ms']:.4f} ms")
    del groups, plain, stacked
    torch.cuda.empty_cache()


def speculative_phase(dev, cfg, card: str, prompts, gen: int, slots: int,
                      max_len: int, page_size: int, timing: dict,
                      launches: dict) -> None:
    """Phase 10: speculative decode at full width (qwen3-0.6b, bf16,
    phase 4's geometry and prompts, 16 greedy tokens), and
    ``vx.scatter_many`` at the KV stack.  ``launches`` gains the verify
    launch sites' counts (the scheduler runs under ``kernel`` for B1 / B2
    and ``kernel_dynamic`` for B6 / B7, both drafts) and scatter_many's."""
    import torch
    from repro_torch.models.transformer import cast_params, init_params
    t_phase = time.perf_counter()
    params = cast_params(init_params(cfg, SEED, device=dev), cfg)
    drafts = {seed: (params if seed == SEED else cast_params(
        init_params(cfg, seed, device=dev), cfg)) for seed in DRAFT_SEEDS}
    preds = {impl: verify_prediction(cfg, impl, slots, SPEC_K)
             for impl in SPEC_POLICIES}
    dpreds = {impl: verify_prediction(cfg, impl, slots, 1)
              for impl in SPEC_POLICIES}
    print(f"verify prediction (from the code): (B1, B2, B6, B7) launches "
          f"per verify step at slots {slots}, K {SPEC_K}: {preds}; per "
          f"draft step: {dpreds}")

    # (a) the decode level, bf16; float32 compute if a greedy flip shows
    t0 = time.perf_counter()
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    gated = []
    for label, c, p, dt in (("bf16", cfg, params, torch.bfloat16),
                            ("float32", f32, None, torch.float32)):
        if p is None:
            p = cast_params(init_params(f32, SEED, device=dev), f32)
        res = {impl: verify_decode_level(dev, c, p, impl, prompts, gen,
                                         slots, max_len, page_size, dt)
               for impl in SPEC_POLICIES}
        for impl, r in res.items():
            for kind in r["runs"]:
                if (r["runs"][kind]["streams"], r["runs"][kind]["commits"]) \
                        != (res["kernel"]["runs"][kind]["streams"],
                            res["kernel"]["runs"][kind]["commits"]):
                    raise AssertionError(f"verify [{label}, {impl}, {kind}]: "
                                         f"other commits than under kernel")
        flips = {impl: check_verify_run(f"verify {label}", impl, r, gen,
                                        preds[impl])
                 for impl, r in res.items()}
        rk = res["kernel"]["runs"]
        print(f"verify [{label}] {cfg.name} on {card}, slots {slots}, K "
              f"{SPEC_K}: commits per round, perfect drafts "
              f"{rk['perfect']['commits']}, corrupted "
              f"{rk['corrupted']['commits']} (page-boundary rejection of "
              f"slot 0 at round {rk['corrupted']['boundary'][0]}, page "
              f"{rk['corrupted']['boundary'][1]} back on the free stack); "
              f"paged_invariants clean every round; equal under kernel, "
              f"ref and kernel_dynamic; largest logit gap to the plain "
              f"step over the committed prefix {rk['perfect']['gap']} / "
              f"{rk['corrupted']['gap']} (tolerance max(0.08, 0.03 * "
              f"|logits|max) = {res['kernel']['tol']}); launches per verify "
              f"step as predicted")
        if not flips["kernel"]:
            print(f"verify [{label}]: committed streams == the plain "
                  f"paged_decode_step oracle's, {SPEC_K} tokens a launch on "
                  f"perfect drafts, 1 on the reject-all round")
            gated.append(label)
            break
        for kind, fl, gap in flips["kernel"]:
            print(f"verify [{label}, {kind}]: greedy flip at slot "
                  f"{fl['slot']} position {fl['position']} (verify "
                  f"{fl['got']}, plain {fl['want']}); the plain run's top-2 "
                  f"margin there {fl['margin']}, the largest verify-plain "
                  f"logit gap over the committed prefix {gap}")
        if label == "float32":
            raise AssertionError("verify: streams differ from the oracle in "
                                 "float32 compute")
    print(f"verify gate held in {gated[0]} compute "
          f"({time.perf_counter() - t0:.1f} s)")

    # (b) the scheduler: both drafts, three policies, beside the plain one
    t0 = time.perf_counter()
    plain = serve(dev, cfg, params, "kernel", prompts, gen, slots, max_len,
                  page_size)
    plain_tps = plain["tokens"] / plain["wall_s"]
    print(f"serve[kernel, plain] {cfg.name} on {card}: whole-run tokens/s "
          f"{plain_tps:.2f} ({plain['decode_steps']} decode steps)")
    spec = {}
    for seed in DRAFT_SEEDS:
        for impl in SPEC_POLICIES:
            r = spec_serve(dev, cfg, params, drafts[seed], impl, prompts,
                           gen, slots, max_len, page_size)
            spec[seed, impl] = r
            pred = preds[impl]
            if any(n != pred for n in r["verify"]):
                raise AssertionError(f"speculative [{impl}, draft seed "
                                     f"{seed}]: launches per verify step "
                                     f"{r['verify']}, predicted {pred}")
            dpred = dpreds[impl]
            if any(n != dpred for n in r["draft"]):
                raise AssertionError(f"speculative [{impl}, draft seed "
                                     f"{seed}]: draft step launches "
                                     f"{sorted(set(r['draft']))}")
            chunk = sorted(set(r["chunks"]))
            print(f"speculative[{impl}, draft seed {seed}] {cfg.name} on "
                  f"{card}: {r['spec']}; {len(r['verify'])} verify steps of "
                  f"{pred} (B1, B2, B6, B7) launches each, as predicted; "
                  f"{len(r['draft'])} draft steps of {dpred}; "
                  f"{len(r['chunks'])} prefill chunks (target and draft) of "
                  f"{chunk}; whole-run tokens/s "
                  f"{r['tokens'] / r['wall_s']:.2f} against the plain "
                  f"scheduler's {plain_tps:.2f} "
                  f"({r['tokens'] / r['wall_s'] / plain_tps:.4f}x)")
    for (seed, impl), r in spec.items():
        if (r["streams"], r["spec"]) != (spec[seed, "kernel"]["streams"],
                                         spec[seed, "kernel"]["spec"]):
            raise AssertionError(f"speculative [{impl}, draft seed {seed}]: "
                                 f"other streams or stats than under kernel")
    for fn, impl in (("deinterleave", "kernel"), ("interleave", "kernel"),
                     ("deinterleave_dynamic", "kernel_dynamic"),
                     ("interleave_dynamic", "kernel_dynamic")):
        launches[fn] += sum(spec[s, impl]["launches"][fn]
                            for s in DRAFT_SEEDS)
    div = {seed: first_divergence(spec[seed, "kernel"]["streams"],
                                  plain["streams"]) for seed in DRAFT_SEEDS}
    if not any(div.values()):
        print(f"speculative: streams == the plain scheduler's under both "
              f"drafts and the three policies, bf16 "
              f"({time.perf_counter() - t0:.1f} s)")
    else:
        print(f"speculative: bf16 streams differ from the plain scheduler's "
              f"at (request, token) {div}; the gate runs in float32 compute")
        pf = cast_params(init_params(f32, SEED, device=dev), f32)
        want = serve(dev, f32, pf, "kernel", prompts, gen, slots, max_len,
                     page_size, cache_dtype="float32")["streams"]
        for seed in DRAFT_SEEDS:
            dp = pf if seed == SEED else cast_params(
                init_params(f32, seed, device=dev), f32)
            for impl in SPEC_POLICIES:
                r = spec_serve(dev, f32, pf, dp, impl, prompts, gen, slots,
                               max_len, page_size, cache_dtype="float32")
                if r["streams"] != want:
                    raise AssertionError(f"speculative float32 [{impl}, "
                                         f"draft seed {seed}]: streams "
                                         f"differ from the plain scheduler's "
                                         f"at {first_divergence(r['streams'], want)}")
                print(f"speculative float32 [{impl}, draft seed {seed}]: "
                      f"streams == the plain float32 scheduler's; "
                      f"{r['spec']}")
        del pf
        torch.cuda.empty_cache()
        print(f"speculative: the gate held in float32 compute "
              f"({time.perf_counter() - t0:.1f} s)")

    # (c) the int8 pool under speculation, the audit after every mutation
    t0 = time.perf_counter()
    q = spec_serve(dev, cfg, params, drafts[SEED + 1], "kernel", prompts,
                   gen, slots, max_len, page_size, kv_quant="int8",
                   debug_invariants=True)
    print(f"speculative int8 [kernel, draft seed {SEED + 1}] {cfg.name} on "
          f"{card}: every request finished, {q['invariant_checks']} "
          f"invariant checks (scale liveness included) all clean; "
          f"{q['spec']} ({time.perf_counter() - t0:.1f} s)")
    del params, drafts
    torch.cuda.empty_cache()

    # (d) vx.scatter_many at the KV stack
    scatter_many_phase(dev, cfg, slots, max_len, timing, launches)

    # (e) the CLI: --speculate 4 --stats, and CI's speculative fleet chaos
    def report_spec(cli):
        line = [ln for ln in cli["lines"] if ln.startswith("speculative:")]
        if not line:
            raise AssertionError("serve CLI --speculate 4: no speculative "
                                 "line")
        tok = [ln for ln in cli["lines"] if "tok/s on " in ln]
        print(f"serve CLI ({' '.join(CLI_ARGS + SPEC_CLI_FLAGS)}): exit 0, "
              f"every request finished, {cli['wall_s']:.1f} s of wall time: "
              f"{tok[0]}; {line[0]}")

    def report_fault(cli):
        line = [ln for ln in cli["lines"]
                if ln.startswith(("speculative:", "fleet chaos seed"))]
        if len(line) != 2:
            raise AssertionError("serve CLI speculative fleet chaos: no "
                                 "speculative or chaos line")
        print(f"serve CLI (--arch qwen3-0.6b {' '.join(SPEC_FAULT_CLI)}): "
              f"exit 0, every request terminal, {cli['wall_s']:.1f} s of "
              f"wall time: {line[0]}; {line[1]}")
    cli_runs((report_spec, run_cli, card, SPEC_CLI_FLAGS),
             (report_fault, run_fault_cli, card, SPEC_FAULT_CLI))
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 11: model families at full width
# ---------------------------------------------------------------------------

FAMILY_POLICIES = ("kernel", "ref", "kernel_dynamic")
GEMMA_LAYERS, MOE_LAYERS = 6, 4       # one 5:1 superblock; 4 of 48
GEMMA_SLOTS, GEMMA_MAX_LEN, GEMMA_PROMPT = 2, 2048, (1600, 1800)
SMOKE_CLI = ("llava-next-mistral-7b", "granite-34b", "phi3.5-moe-42b-a6.6b")
SMOKE_CLI_ARGS = ("--smoke", "--requests", "4", "--prompt-len", "64",
                  "--gen", "16", "--max-len", "512")
MOE_TIME_ITERS = 20


def phase4_prompts(vocab: int, slots: int) -> list:
    """Phase 4's traffic: ``slots`` numpy-seeded prompts of 40-100 tokens
    drawn from ``vocab``."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, int(n)).tolist()
            for n in rng.integers(40, 101, slots)]


def predicted_params(cfg) -> tuple:
    """(parameters, router parameters) from the config's shapes: the
    embedding (and an untied head), the final norm, and per layer the
    norms, the mixer (attention: q, the interleaved kv, o, the qk norms;
    Mamba: in_proj, the conv, x_proj, dt_proj and dt_bias, A_log, D,
    out_proj; mLSTM: up, q / k / v, the i / f gates and forget bias,
    down, the o gate; sLSTM: wx, the block-diagonal r, the forget bias,
    the gated FFN) and the FFN arm (MoE: router and experts; SwiGLU;
    GELU MLP); an encoder config adds its blocks, its final norm and one
    cross-attention with its norm per decoder layer."""
    d, H, K, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    total = cfg.vocab * d * (1 if cfg.tie_embeddings else 2) + d
    router = 0
    for i, kind in enumerate(cfg.block_pattern):
        n = d
        if kind == "attn":
            n += d * H * D + d * 2 * K * D + H * D * d
            n += 2 * D if cfg.qk_norm else 0
        elif kind == "mamba":
            m = cfg.mamba
            ed, N, r = m.ed, m.state_dim, m.rank
            n += (2 * d * ed + (m.conv_width + 1) * ed + ed * (r + 2 * N)
                  + r * ed + ed + ed * N + ed + ed * d)
        elif kind == "mlstm":
            mi, h = cfg.xlstm.m_inner, cfg.xlstm.n_heads
            n += 2 * d * mi + 3 * mi * mi + 2 * mi * h + h + 2 * mi * d
        else:
            h, dh = cfg.xlstm.n_heads, cfg.xlstm.s_head
            f = int(d * cfg.xlstm.s_ffn_factor)
            n += 4 * d * d + h * dh * 4 * dh + d + 3 * d * f
        if cfg.pos_has_ffn(i):
            n += d
            if cfg.moe_pattern[i]:
                E, f = cfg.moe.n_experts, cfg.moe.d_ff
                n += d * E + 3 * E * d * f
                router += d * E * cfg.n_superblocks
            elif cfg.mlp == "swiglu":
                n += 3 * d * cfg.d_ff
            else:
                n += 2 * d * cfg.d_ff
        total += n * cfg.n_superblocks
    if cfg.encoder is not None:
        attn = d * H * D + d * 2 * K * D + H * D * d
        # encoder blocks (ln1, attention, ln2, GELU MLP) and final norm;
        # per decoder layer a cross-attention and its norm
        total += cfg.encoder.n_layers * (2 * d + attn + 2 * d * cfg.d_ff) + d
        total += cfg.n_superblocks * (d + attn)
    return total, router


def family_params(dev, cfg, label: str, published_layers: int):
    """Print the parameter count and bytes predicted from the config's
    shapes, then init (float32) and cast once to bf16 (the router stays
    float32, the same tensor), check ``param_count`` against the
    prediction and print ``max_memory_allocated`` beside it."""
    import gc
    import torch
    from repro_torch.models.transformer import (cast_params, init_params,
                                                param_count)
    n, router = predicted_params(cfg)
    want = 4 * n + 2 * (n - router)
    cut = ("" if cfg.n_layers == published_layers else
           f", depth cut {published_layers} -> {cfg.n_layers} layers")
    print(f"{label}: predicted {n} parameters from the config's shapes "
          f"({4 * n / 1e9:.3f} GB float32 + {2 * (n - router) / 1e9:.3f} GB "
          f"bf16 copy = {want / 1e9:.3f} GB){cut}")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    master = init_params(cfg, SEED, device=dev)
    params = cast_params(master, cfg)
    torch.cuda.synchronize()
    got = param_count(master)
    print(f"{label}: param_count {got} (predicted {n}); "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB ({held / 1e9:.3f} GB held before init) beside the predicted "
          f"{want / 1e9:.3f} GB; init and cast "
          f"{time.perf_counter() - t0:.1f} s")
    if got != n:
        raise AssertionError(f"{label}: param_count {got} != predicted {n}")
    return master, params


def family_runs(dev, card: str, label: str, cfg, params, prompts, gen: int,
                slots: int, max_len: int, page_size: int, order,
                **serve_kw) -> list:
    """Serve runs under each policy of ``order`` (phase 4's ``serve``:
    counts zeroed just before each run, read just after): the kernels of
    the policy and no other launched, in every decode step one fused split
    and the GLU splits that reach the launch threshold (B1 under
    ``kernel``, B6 under ``kernel_dynamic``, as ``verify_prediction`` reads
    ``paged_decode_step``), streams equal across the runs.  ``serve_kw``
    go to ``serve`` (the cache dtype, the scheduler's knobs)."""
    runs = []
    for impl in order:
        r = serve(dev, cfg, params, impl, prompts, gen, slots, max_len,
                  page_size, **serve_kw)
        pred = verify_prediction(cfg, impl, slots, 1)
        check_step_launches(label, impl, r, (pred[0], pred[2]))
        decode_s = sum(r["step_ms"]) / 1e3
        print(f"{label} serve[{impl}] on {card}: generated tokens/s over the "
              f"whole run {r['tokens'] / r['wall_s']:.2f} ({r['tokens']} "
              f"tokens in {r['wall_s']:.3f} s); decode-step tokens/s "
              f"{sum(r['step_tokens']) / decode_s:.2f}; median decode step "
              f"{statistics.median(r['step_ms']):.3f} ms over "
              f"{r['decode_steps']} steps; {r['prefill_chunks']} prefill "
              f"chunks; launches {r['launches']}")
        runs.append((impl, r))
    for impl, r in runs[1:]:
        if r["streams"] != runs[0][1]["streams"]:
            raise AssertionError(f"{label} [{impl}]: other token streams "
                                 f"than the first {runs[0][0]} run")
    pred = verify_prediction(cfg, "kernel", slots, 1)[0]
    print(f"{label}: streams equal under {', '.join(order)}; in each of "
          f"{len(runs[0][1]['step_launches'])} decode steps one fused split "
          f"and {pred - 1} GLU splits, {pred} launches as read off the code "
          f"(B1 under kernel, B6 under kernel_dynamic)")
    return runs


def segment_shapes(cfg, slots: int, max_len: int, page_size: int) -> tuple:
    """(B1 / B6 row shapes, B2 / B7 field shapes) the paged serve path
    hands the segment kernels at this cell, read off ``models/decode``:
    the decode step's fused split of every layer's gathered pages; each
    prefill chunk's split of its ``(1, page_size)`` kv beat, re-pack of the
    post-RoPE k / v and split of its slot's gathered pages; the GLU split
    of a prefill chunk and of a decode step where a layer is a fused
    SwiGLU; the decode step's beat split and re-pack where ``slots`` beats
    reach the launch threshold."""
    from repro_torch import vx
    K, D = cfg.n_kv_heads, cfg.hd
    seq = -(-max_len // page_size) * page_size
    split = [(attn_layers(cfg), slots, seq, K, 2 * D), (1, seq, K, 2 * D),
             (1, page_size, K, 2 * D)]
    pack = [(1, page_size, K, D)]
    if glu_layers(cfg):
        split += [(1, page_size, 2 * cfg.d_ff), (slots, 1, 2 * cfg.d_ff)]
    if vx.Policy(impl="kernel").for_elems(slots * K * 2 * D).impl != "ref":
        split.append((slots, 1, K, 2 * D))
        pack.append((slots, 1, K, D))
    return split, pack


def check_segment_shapes(dev, label: str, cfg, slots: int, max_len: int,
                         page_size: int, dtype: str = "bfloat16",
                         shapes=None, fields: int = 2) -> None:
    """B1 and B6 on every row shape, B2 and B7 on every field shape of
    :func:`segment_shapes` (or of ``shapes``, a (split, pack) pair of
    lists, for a path it does not read), ``fields`` fields (2: K / V or a
    GLU's halves; 4: the data path's AoS records), seeded in ``dtype``
    (the dtype the cell serves in; int32 payloads are integers over the
    whole range from the generator), each against its plain version bit
    for bit and one launch a call (a row too wide for the copy's shared
    memory folded into chunks by the wrappers)."""
    import torch
    from repro_torch.kernels import segment
    g = torch.Generator(dev).manual_seed(SEED + 13)
    tag = {"bfloat16": "bf16", "float32": "float32", "int32": "int32"}[dtype]

    def rand(shape):
        if dtype == "int32":
            return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                                 device=dev, dtype=torch.int32)
        return torch.randn(shape, generator=g, device=dev).to(
            getattr(torch, dtype))

    def once(fn, *args):
        before = fn.launches
        out = fn(*args)
        if fn.launches != before + 1:
            raise AssertionError(f"{label}: {fn.__name__} launched "
                                 f"{fn.launches - before} times in a call")
        return out

    split, pack = shapes or segment_shapes(cfg, slots, max_len, page_size)
    for shape in split:
        x = rand(shape)
        for fn, plain in ((segment.deinterleave, segment.deinterleave_plain),
                          (segment.deinterleave_dynamic,
                           segment.deinterleave_dynamic_plain)):
            if not all(same_bits(a, b) for a, b in zip(once(fn, x, fields),
                                                       plain(x, fields))):
                raise AssertionError(f"{label}: {fn.__name__} at {shape} "
                                     f"{tag} != plain")
        del x
    for shape in pack:
        soa = [rand(shape) for _ in range(fields)]
        for fn, plain in ((segment.interleave, segment.interleave_plain),
                          (segment.interleave_dynamic,
                           segment.interleave_dynamic_plain)):
            if not same_bits(once(fn, soa), plain(soa)):
                raise AssertionError(f"{label}: {fn.__name__} at {shape} "
                                     f"x{fields} {tag} != plain")
    torch.cuda.empty_cache()
    print(f"{label}: B1 and B6 at {', '.join(map(str, split))} {tag} into "
          f"{fields} fields, B2 and B7 at "
          f"{', '.join(f'{s} x{fields}' for s in pack)} {tag} (the path's "
          f"shapes, rows too wide for the copy folded into chunks) == plain "
          f"bit for bit, one launch a call")


def dense_ring_vs_paged(dev, cfg, params, prompt, gen: int, page_size: int,
                        max_len: int) -> tuple:
    """Cell (a)'s oracle under ``kernel``: the dense engine's prefill of
    the whole prompt (``flash_attention``'s banded branch once the prompt
    is longer than window + q_chunk; windowed layers ring-trimmed into the
    dense cache) and ``gen - 1`` dense decode steps, against the paged
    cache's page-sized prefill chunks of the prompt but its last token,
    then paged decode steps fed the prompt's last token and the dense
    greedy stream.  Returns (largest logit gap, largest |logit|)."""
    import torch
    from repro_torch.models import decode as dec
    from repro_torch.serve.engine import jit_prefill
    cfg = dataclasses.replace(cfg, kernel_impl="kernel")
    L = len(prompt)
    logits, states = jit_prefill(cfg, None, device=dev)(
        params, {"tokens": torch.tensor([prompt], dtype=torch.int32)})
    dense = dec.cache_from_prefill(cfg, states, L, max_len, torch.bfloat16)
    del states
    paged = dec.init_paged_cache(cfg, 1, max_len, page_size, torch.bfloat16,
                                 device=dev)
    pre = prompt[:-1]
    for c in range(0, len(pre), page_size):
        n = min(page_size, len(pre) - c)
        paged = dec.paged_prefill_chunk(
            params, paged, torch.tensor(pre[c:c + n] + [0] * (page_size - n),
                                        dtype=torch.int32, device=dev),
            cfg, None, slot=0, count=n)
    dl = logits[:, 0]
    pl, paged = dec.paged_decode_step(
        params, paged, torch.tensor([prompt[-1]], dtype=torch.int32,
                                    device=dev), cfg)
    gap = scale = 0.0
    for step in range(gen):
        gap = max(gap, float((pl.float() - dl.float()).abs().max()))
        scale = max(scale, float(dl.float().abs().max()))
        if step == gen - 1:
            break
        tok = torch.argmax(dl.float(), dim=-1).to(torch.int32)
        dl, dense = dec.decode_step(params, dense, tok, cfg)
        pl, paged = dec.paged_decode_step(params, paged, tok, cfg)
    del dense, paged
    torch.cuda.empty_cache()
    return gap, scale


def moe_layer_time(dev, cfg, params, slots: int) -> dict:
    """One MoE layer alone at the decode step's shape ``(slots, 1,
    d_model)`` bf16: device time over ``MOE_TIME_ITERS`` calls (CUDA
    events; each call holds its host sync), host clock per call, and the
    host syncs one call makes (``torch.cuda.set_sync_debug_mode``)."""
    import warnings
    import torch
    from repro_torch.models import moe
    from repro_torch.models.transformer import superblock
    p = superblock(params["blocks"], 0)["pos0"]["moe"]
    x = torch.randn((slots, 1, cfg.d_model),
                    generator=torch.Generator(dev).manual_seed(SEED + 5),
                    device=dev).to(cfg.cdtype)
    ms = time_ms(lambda: moe.moe_layer(p, x, cfg.moe, None), MOE_TIME_ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MOE_TIME_ITERS):
        moe.moe_layer(p, x, cfg.moe, None)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / MOE_TIME_ITERS
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            moe.moe_layer(p, x, cfg.moe, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return {"ms": ms, "host_ms": host_ms, "syncs": syncs}


def family_phase(dev, card: str, slots: int, max_len: int,
                 page_size: int, gen: int) -> dict:
    """Phase 11: gemma3-12b (windowed, 6 of 48 layers), starcoder2-3b
    (published geometry) and qwen3-moe-30b-a3b (4 of 48 layers) at full
    width through the port's ``Scheduler`` under the three policies, and
    the CLI with ``--smoke`` for llava-next-mistral-7b, granite-34b and
    phi3.5-moe.  Returns the launches of B1 / B2 under ``kernel`` and B6 /
    B7 under ``kernel_dynamic``, summed over the cells' runs."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    t_phase = time.perf_counter()
    launches = dict.fromkeys(("deinterleave", "interleave",
                              "deinterleave_dynamic",
                              "interleave_dynamic"), 0)

    def tally(runs):
        for impl, r in runs:
            for k in launches:
                if (impl == "kernel_dynamic") == k.endswith("_dynamic") \
                        and impl != "ref":
                    launches[k] += r["launches"][k]

    # (a) gemma3-12b, windowed: prompts longer than window + q_chunk
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("gemma3-12b").model,
                              n_layers=GEMMA_LAYERS)
    label = "phase 11a gemma3-12b"
    check_segment_shapes(dev, label, cfg, GEMMA_SLOTS, GEMMA_MAX_LEN,
                         page_size)
    master, params = family_params(dev, cfg, label, 48)
    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(GEMMA_PROMPT[0], GEMMA_PROMPT[1] + 1,
                                     GEMMA_SLOTS)]
    tally(family_runs(dev, card, label, cfg, params, prompts, gen,
                      GEMMA_SLOTS, GEMMA_MAX_LEN, page_size,
                      FAMILY_POLICIES))
    gap, scale = dense_ring_vs_paged(dev, cfg, params, prompts[0], gen,
                                     page_size, GEMMA_MAX_LEN)
    tol = max(0.08, 0.03 * scale)
    window = max(w for w in cfg.window_pattern if w)
    print(f"{label}: dense ring vs paged under kernel, prompt of "
          f"{len(prompts[0])} tokens (window {window}, banded dense "
          f"prefill), {gen} steps: largest logit gap {gap} "
          f"within max(0.08, 0.03 * |logits|max = {scale}) = {tol}; KV "
          f"stack ({cfg.n_layers}, {GEMMA_SLOTS}, {GEMMA_MAX_LEN}, "
          f"{cfg.n_kv_heads}, {2 * cfg.hd}) bf16 "
          f"({time.perf_counter() - t0:.1f} s)")
    if not gap <= tol:
        raise AssertionError(f"{label}: dense ring vs paged gap {gap} > "
                             f"{tol}")
    del master, params
    gc.collect()
    torch.cuda.empty_cache()

    # (b) starcoder2-3b at its published geometry, phase 4's traffic
    t0 = time.perf_counter()
    cfg = get_arch("starcoder2-3b").model
    label = "phase 11b starcoder2-3b"
    check_segment_shapes(dev, label, cfg, slots, max_len, page_size)
    master, params = family_params(dev, cfg, label, 30)
    tally(family_runs(dev, card, label, cfg, params,
                      phase4_prompts(cfg.vocab, slots), gen, slots, max_len,
                      page_size, FAMILY_POLICIES))
    print(f"{label}: KV stack ({cfg.n_layers}, {slots}, {max_len}, "
          f"{cfg.n_kv_heads}, {2 * cfg.hd}) bf16 "
          f"({time.perf_counter() - t0:.1f} s)")
    del master, params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) qwen3-moe-30b-a3b, 4 of 48 layers: two kernel runs equal
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").model,
                              n_layers=MOE_LAYERS)
    label = "phase 11c qwen3-moe-30b-a3b"
    check_segment_shapes(dev, label, cfg, slots, max_len, page_size)
    master, params = family_params(dev, cfg, label, 48)
    tally(family_runs(dev, card, label, cfg, params,
                      phase4_prompts(cfg.vocab, slots), gen, slots, max_len,
                      page_size, FAMILY_POLICIES + ("kernel",)))
    t = moe_layer_time(dev, cfg, params, slots)
    print(f"{label}: one MoE layer alone at the decode step's shape "
          f"({slots}, 1, {cfg.d_model}) bf16, {slots * cfg.moe.top_k} units "
          f"over {cfg.moe.n_experts} experts: {t['ms']:.4f} ms a call (CUDA "
          f"events over {MOE_TIME_ITERS} calls), {t['host_ms']:.4f} ms of "
          f"host clock a call, {t['syncs']} host sync(s) a call on {card}; "
          f"KV stack ({cfg.n_layers}, {slots}, {max_len}, {cfg.n_kv_heads}, "
          f"{2 * cfg.hd}) bf16 ({time.perf_counter() - t0:.1f} s)")
    del master, params
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the CLI with --smoke for the configs with no full-width run
    def report(base):
        def fn(cli):
            tail = [ln for ln in cli["lines"] if "tok/s on " in ln][0]
            print(f"phase 11d serve CLI ({' '.join(base)}): exit 0, every "
                  f"request finished, {cli['wall_s']:.1f} s of wall time: "
                  f"{tail}")
        return fn
    bases = [("--arch", name) + SMOKE_CLI_ARGS for name in SMOKE_CLI]
    cli_runs(*[(report(base), run_cli, card, (), base) for base in bases])
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s; launches under "
          f"kernel / kernel_dynamic {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the recurrent and hybrid models
# ---------------------------------------------------------------------------

RECURRENT_POLICIES = ("kernel", "ref", "kernel_dynamic")
# the reference's numbers (its init_params under jax.eval_shape, its
# PagedCache at 4 slots, max_len 512, page 16), which the config's shapes
# must give
XLSTM_PARAMS, XLSTM_USED_BYTES = 167_349_544, 94_717_056
JAMBA_SUPERBLOCK_PARAMS, MAMBA_LAYER_PARAMS = 44_701_474_816, 420_339_712
MAMBA_BATCH, MAMBA_SEQ, MAMBA_STEPS = 2, 1024, 16
RECURRENT_CLI = (
    ("--arch", "xlstm-125m", "--requests", "4", "--prompt-len", "64",
     "--gen", "16", "--max-len", "512"),
    ("--arch", "jamba-1.5-large-398b") + SMOKE_CLI_ARGS)
RECURRENT_FAULT_CLI = ("--smoke", "--replicas", "3", "--chaos", "0",
                       "--requests", "6", "--gen", "6", "--max-len", "32",
                       "--page-size", "4")


def recurrent_dense_vs_paged(dev, cfg, params, slots: int, page_size: int,
                             max_len: int) -> tuple:
    """The dense path against the paged one under ``kernel``, caches in
    the compute dtype:
    ``jit_prefill`` of ``slots`` x ``DENSE_PROMPT`` numpy-seeded tokens
    against page-sized prefill chunks of each prompt but its last token
    and a paged decode step fed it; then ``FORCED_STEPS`` forced tokens
    through the dense ``jit_decode_step`` and the paged step.  Returns
    (largest logit gap, largest |logit|)."""
    import numpy as np
    import torch
    from repro_torch.models import decode as dec
    from repro_torch.serve.engine import (ServeConfig, jit_decode_step,
                                          jit_prefill)
    cfg = dataclasses.replace(cfg, kernel_impl="kernel")
    rng = np.random.default_rng(SEED + 12)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (slots, DENSE_PROMPT)).astype(np.int32)).to(dev)
    forced = torch.from_numpy(rng.integers(
        0, cfg.vocab, (FORCED_STEPS, slots)).astype(np.int32)).to(dev)
    logits, states = jit_prefill(cfg, None, device=dev)(
        params, {"tokens": tokens})
    dense = dec.cache_from_prefill(cfg, states, DENSE_PROMPT, max_len,
                                   cfg.cdtype)
    step = jit_decode_step(cfg, None, ServeConfig(max_len=max_len),
                           device=dev)
    paged = dec.init_paged_cache(cfg, slots, max_len, page_size, cfg.cdtype,
                                 device=dev)
    for s in range(slots):
        for c in range(0, DENSE_PROMPT - 1, page_size):
            n = min(page_size, DENSE_PROMPT - 1 - c)
            chunk = torch.zeros((page_size,), dtype=torch.int32, device=dev)
            chunk[:n] = tokens[s, c:c + n]
            paged = dec.paged_prefill_chunk(params, paged, chunk, cfg,
                                            slot=s, count=n)
    dl = logits[:, 0]
    pl, paged = dec.paged_decode_step(params, paged, tokens[:, -1], cfg)
    gap = scale = 0.0
    for t in range(FORCED_STEPS + 1):
        gap = max(gap, float((pl.float() - dl.float()).abs().max()))
        scale = max(scale, float(dl.float().abs().max()))
        if t == FORCED_STEPS:
            break
        dl, dense = step(params, dense, forced[t])
        pl, paged = dec.paged_decode_step(params, paged, forced[t], cfg)
    del dense, paged, states
    torch.cuda.empty_cache()
    return gap, scale


def ulp_sensitivity(dev, cfg, params, slots: int) -> float:
    """How far one ulp moves the model: the prefill logits of phase 12a's
    prompts with the first entry of the first block's ``ln1`` nudged up by
    one ulp of the compute dtype, against the unmoved ones."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import jit_prefill
    rng = np.random.default_rng(SEED + 12)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (slots, DENSE_PROMPT)).astype(np.int32)).to(dev)
    prefill = jit_prefill(dataclasses.replace(cfg, kernel_impl="kernel"),
                          None, device=dev)
    base, _ = prefill(params, {"tokens": tokens})
    ln = params["blocks"]["pos0"]["ln1"]
    old = ln[0, 0].clone()
    ln[0, 0] = torch.nextafter(old, torch.full_like(old, float("inf")))
    moved, _ = prefill(params, {"tokens": tokens})
    ln[0, 0] = old
    return float((moved.float() - base.float()).abs().max())


def xlstm_cell(dev, card: str, slots: int, max_len: int, page_size: int,
               gen: int) -> None:
    """Phase 12a: xlstm-125m uncut in bf16 through the paged scheduler
    under the three policies (phase 4's traffic in its vocabulary): equal
    streams, no segment launch in any decode step (as
    ``verify_prediction`` reads a stack without attention),
    ``used_cache_bytes`` flat at the reference's number after every tick;
    then the dense path against the paged one, gated in float32."""
    import gc
    import torch
    from repro_torch.configs.base import get_arch
    cfg = get_arch("xlstm-125m").model
    label = "phase 12a xlstm-125m"
    if predicted_params(cfg)[0] != XLSTM_PARAMS:
        raise AssertionError(f"{label}: the config's shapes give "
                             f"{predicted_params(cfg)[0]} parameters, the "
                             f"reference {XLSTM_PARAMS}")
    master, params = family_params(dev, cfg, label, cfg.n_layers)
    prompts = phase4_prompts(cfg.vocab, slots)
    runs = []
    for impl in RECURRENT_POLICIES:
        r = serve(dev, cfg, params, impl, prompts, gen, slots, max_len,
                  page_size, track_used=True)
        want = verify_prediction(cfg, impl, slots, 1)
        if any(r["launches"].values()) or want != (0, 0, 0, 0) or \
                any(n != (0, 0) for n in r["step_launches"]):
            raise AssertionError(f"{label} [{impl}]: segment launches "
                                 f"{r['launches']}, per decode step "
                                 f"{r['step_launches']}; read off the code "
                                 f"{want}")
        used = sorted(set(r["used_bytes"]))
        if used != [XLSTM_USED_BYTES]:
            raise AssertionError(f"{label} [{impl}]: used_cache_bytes "
                                 f"{used}, want {XLSTM_USED_BYTES} from the "
                                 f"first admission to the end")
        decode_s = sum(r["step_ms"]) / 1e3
        print(f"{label} serve[{impl}] on {card}: generated tokens/s over the "
              f"whole run {r['tokens'] / r['wall_s']:.2f} ({r['tokens']} "
              f"tokens in {r['wall_s']:.3f} s); decode-step tokens/s "
              f"{sum(r['step_tokens']) / decode_s:.2f}; median decode step "
              f"{statistics.median(r['step_ms']):.3f} ms over "
              f"{r['decode_steps']} steps; {r['prefill_chunks']} prefill "
              f"chunks; used_cache_bytes {used[0]} after each of "
              f"{len(r['used_bytes'])} ticks; page_bytes {r['page_bytes']}")
        runs.append((impl, r))
    for impl, r in runs[1:]:
        if r["streams"] != runs[0][1]["streams"]:
            raise AssertionError(f"{label} [{impl}]: other token streams "
                                 f"than the first {runs[0][0]} run")
    print(f"{label}: streams equal under {', '.join(RECURRENT_POLICIES)}; "
          f"0 segment launches in each of "
          f"{len(runs[0][1]['step_launches'])} decode steps, as read off "
          f"the code; used_cache_bytes {XLSTM_USED_BYTES} (the reference's) "
          f"from the first admission to the end")
    # the gate runs in float32: in bf16 one ulp anywhere moves this
    # seeded stack's logits by about their own size (printed below), so
    # the bf16 dense and paged paths are only printed
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gap, scale = recurrent_dense_vs_paged(dev, cfg32, master, slots,
                                          page_size, max_len)
    tol = max(0.08, 0.03 * scale)
    bgap, bscale = recurrent_dense_vs_paged(dev, cfg, params, slots,
                                            page_size, max_len)
    moved = {name: ulp_sensitivity(dev, c, p, slots)
             for name, c, p in (("float32", cfg32, master),
                                ("bf16", cfg, params))}
    print(f"{label}: dense jit_prefill of {slots} x {DENSE_PROMPT} tokens "
          f"and {FORCED_STEPS} forced dense decode steps against paged "
          f"prefill chunks and steps under kernel: float32 largest logit "
          f"gap {gap} within max(0.08, 0.03 * |logits|max = {scale}) = "
          f"{tol}; bf16 gap {bgap} (|logits|max {bscale}); one ulp of one "
          f"ln1 entry moves the prefill logits by {moved['float32']} in "
          f"float32, {moved['bf16']} in bf16 "
          f"({time.perf_counter() - t0:.1f} s)")
    if not gap <= tol:
        raise AssertionError(f"{label}: dense vs paged gap {gap} > {tol}")
    del master, params
    gc.collect()
    torch.cuda.empty_cache()


def mamba_layer_alone(dev, card: str) -> None:
    """Phase 12b: jamba's Mamba layer alone at its published widths, with
    seeded weights: the forward over ``(MAMBA_BATCH, MAMBA_SEQ, d)`` then
    ``MAMBA_STEPS`` decode steps from its cache, in bf16 and timed; in
    float32 the forward's final state and conv window against
    ``MAMBA_SEQ`` decode steps from zero (each within 1e-4 of its largest
    magnitude), and the same gap printed in bf16."""
    import gc
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models import ssm
    label = "phase 12b jamba Mamba layer"
    full = get_arch("jamba-1.5-large-398b").model
    spec = full.mamba
    sb = predicted_params(dataclasses.replace(full, n_layers=full.sb_len))[0]
    print(f"{label}: one jamba superblock of {full.sb_len} layers at "
          f"published widths holds {sb} parameters ({2 * sb / 1e9:.1f} GB "
          f"bf16, {4 * sb / 1e9:.1f} GB float32) over the card's 80 GB: "
          f"jamba is served at its smoke size, its Mamba layer alone at "
          f"published widths")
    if sb != JAMBA_SUPERBLOCK_PARAMS:
        raise AssertionError(f"{label}: superblock {sb} != "
                             f"{JAMBA_SUPERBLOCK_PARAMS}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(dev).manual_seed(SEED + 12)
    p32 = ssm.init_mamba(spec, g, torch.float32, dev)
    n = sum(t.numel() for t in p32.values()) + full.d_model   # with ln1
    if n != MAMBA_LAYER_PARAMS:
        raise AssertionError(f"{label}: {n} parameters, want "
                             f"{MAMBA_LAYER_PARAMS}")
    pb = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    x32 = torch.randn((MAMBA_BATCH, MAMBA_SEQ + MAMBA_STEPS, full.d_model),
                      generator=g, device=dev)
    xb = x32.to(torch.bfloat16)

    def gaps(fwd, steps):
        return tuple(float((a.float() - b.float()).abs().max())
                     / float(b.float().abs().max())
                     for a, b in ((fwd.h, steps.h), (fwd.conv, steps.conv)))

    def from_zero(p, x, dtype):
        c = ssm.init_mamba_cache(MAMBA_BATCH, spec, dtype, dev)
        for t in range(MAMBA_SEQ):
            _, c = ssm.mamba_decode_step(p, x[:, t], c, spec)
        return c

    # bf16: warm once, then the timed forward and decode steps
    ssm.mamba_forward(pb, xb[:, :MAMBA_SEQ], spec, chunk=full.ssm_chunk)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    out, cache = ssm.mamba_forward(pb, xb[:, :MAMBA_SEQ], spec,
                                   chunk=full.ssm_chunk)
    e1.record()
    torch.cuda.synchronize()
    fwd_host = (time.perf_counter() - t0) * 1e3
    fwd_dev = e0.elapsed_time(e1)
    fwd_cache = cache
    t0 = time.perf_counter()
    e0.record()
    for t in range(MAMBA_STEPS):
        y, cache = ssm.mamba_decode_step(pb, xb[:, MAMBA_SEQ + t], cache,
                                         spec)
    e1.record()
    torch.cuda.synchronize()
    step_host = (time.perf_counter() - t0) * 1e3 / MAMBA_STEPS
    step_dev = e0.elapsed_time(e1) / MAMBA_STEPS
    if not (bool(torch.isfinite(out.float()).all())
            and bool(torch.isfinite(y.float()).all())
            and tuple(out.shape) == (MAMBA_BATCH, MAMBA_SEQ, full.d_model)):
        raise AssertionError(f"{label}: bf16 outputs not finite of shape "
                             f"({MAMBA_BATCH}, {MAMBA_SEQ}, {full.d_model})")
    bf_gap = gaps(fwd_cache, from_zero(pb, xb, torch.bfloat16))
    _, c32 = ssm.mamba_forward(p32, x32[:, :MAMBA_SEQ], spec,
                               chunk=full.ssm_chunk)
    f32_gap = gaps(c32, from_zero(p32, x32, torch.float32))
    wbytes = sum(t.numel() * t.element_size() for t in pb.values())
    sbytes = sum(t.numel() * t.element_size() for t in cache)
    print(f"{label} MambaSpec{tuple(spec)} (ed {spec.ed}, rank "
          f"{spec.rank}), {n} parameters with ln1, {wbytes} bytes of bf16 "
          f"weights, {sbytes} bytes of state for {MAMBA_BATCH} rows, on "
          f"{card}: forward over ({MAMBA_BATCH}, {MAMBA_SEQ}, "
          f"{full.d_model}) bf16 {fwd_dev:.3f} ms (CUDA events), "
          f"{fwd_host:.3f} ms (host clock); decode step {step_dev:.4f} ms "
          f"(CUDA events over {MAMBA_STEPS}), {step_host:.4f} ms (host "
          f"clock); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    print(f"{label}: forward's final state against {MAMBA_SEQ} decode "
          f"steps from zero, largest gap over largest magnitude: float32 h "
          f"{f32_gap[0]:.3e}, conv {f32_gap[1]:.3e} (bound 1e-4); bf16 h "
          f"{bf_gap[0]:.3e}, conv {bf_gap[1]:.3e}")
    if not max(f32_gap) <= 1e-4:
        raise AssertionError(f"{label}: float32 forward against steps "
                             f"{f32_gap} > 1e-4")
    del p32, pb, x32, xb, out, cache, fwd_cache, c32
    gc.collect()
    torch.cuda.empty_cache()


def recurrent_phase(dev, card: str, slots: int, max_len: int,
                    page_size: int, gen: int) -> dict:
    """Phase 12: (a) xlstm-125m uncut, (b) jamba's Mamba layer alone at
    published widths, (c) jamba-smoke through the paged path under the
    three policies (float32, its own dtype; B1 / B6 and B2 / B7 held bit
    for bit at its shapes first; the pool audited at every mutation),
    (d) three CLI runs.  Returns the launches of B1 / B2 under ``kernel``
    and B6 / B7 under ``kernel_dynamic`` of (c)'s runs."""
    import gc
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import init_params
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    xlstm_cell(dev, card, slots, max_len, page_size, gen)
    print(f"phase 12a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mamba_layer_alone(dev, card)
    print(f"phase 12b: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cfg = get_arch("jamba-1.5-large-398b").smoke
    label = "phase 12c jamba-smoke"
    dtype = str(cfg.cdtype).removeprefix("torch.")   # float32: the cache's
    check_segment_shapes(dev, label, cfg, slots, max_len, page_size, dtype)
    params = init_params(cfg, SEED, device=dev)
    runs = family_runs(dev, card, label, cfg, params,
                       phase4_prompts(cfg.vocab, slots), gen, slots,
                       max_len, page_size, RECURRENT_POLICIES,
                       cache_dtype=dtype, debug_invariants=True)
    launches = dict.fromkeys(("deinterleave", "interleave",
                              "deinterleave_dynamic", "interleave_dynamic"),
                             0)
    for impl, r in runs:
        if r["invariant_checks"] <= 0:
            raise AssertionError(f"{label} [{impl}]: the pool was never "
                                 f"audited")
        for k in launches:
            if (impl == "kernel_dynamic") == k.endswith("_dynamic") \
                    and impl != "ref":
                launches[k] += r["launches"][k]
    print(f"{label}: pool invariants audited {runs[0][1]['invariant_checks']}"
          f" times a run, all green ({time.perf_counter() - t0:.1f} s)")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    def report(base):
        def fn(cli):
            tail = [ln for ln in cli["lines"] if "tok/s on " in ln][0]
            pages = [ln for ln in cli["lines"] if ln.startswith("pages:")][0]
            print(f"phase 12d serve CLI ({' '.join(base)}): exit 0, every "
                  f"request finished, {cli['wall_s']:.1f} s of wall time: "
                  f"{pages} | {tail}")
        return fn

    def report_fault(cli):
        done = [ln for ln in cli["lines"]
                if ln.startswith("every request")][0]
        print(f"phase 12d serve CLI (--arch xlstm-125m "
              f"{' '.join(RECURRENT_FAULT_CLI)}): exit 0, "
              f"{cli['wall_s']:.1f} s of wall time: {done}")
    cli_runs(*[(report(base), run_cli, card, (), base)
               for base in RECURRENT_CLI],
             (report_fault, run_fault_cli, card, RECURRENT_FAULT_CLI,
              "xlstm-125m"))
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s; launches under "
          f"kernel / kernel_dynamic {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the encoder-decoder (whisper-tiny) through the dense path
# ---------------------------------------------------------------------------

# the reference's count (its init_params under jax.eval_shape), which the
# config's shapes must give
WHISPER_PARAMS = 36_479_232
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_MAX_LEN, WHISPER_STEPS = 4, 32, 64, 16
WHISPER_POLICIES = ("kernel", "ref", "kernel_dynamic")
# the reference's own messages (src/repro/serve/scheduler.py:171-173,
# src/repro/launch/serve.py:262-263)
PAGED_REFUSAL = "paged serving covers decoder-only models"
CLI_REFUSAL = "use whisper example for enc-dec serving"


def timed(fn):
    """(fn(), device ms by CUDA events, host ms) of one synchronized
    call."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def seg_pair(counts: dict, impl: str) -> tuple:
    """(split, pack) launches of ``impl``'s segment kernels (B1 / B2 under
    ``kernel``, B6 / B7 under ``kernel_dynamic``); under ``ref`` every
    segment kernel counts.  Raises when another policy's kernels ran."""
    mine = {"kernel": ("deinterleave", "interleave"),
            "kernel_dynamic": ("deinterleave_dynamic", "interleave_dynamic"),
            "ref": ()}[impl]
    other = [k for k in counts if k not in mine and counts[k]]
    if other:
        raise AssertionError(f"[{impl}] launched {other}: {counts}")
    return tuple(counts[k] for k in mine) if mine else (0, 0)


def whisper_prediction(cfg, impl: str) -> dict:
    """(split, pack) launches per call as read off models/encdec.py:
    ``encode`` splits each encoder layer's kv beat (1 each); the prefill's
    ``forward`` encodes, then per decoder layer splits ``encoder_kv`` and
    ``qkv_project``'s beat and re-packs it (2 and 1); ``precompute_enc_kv``
    encodes and projects without a split; a decode step's ``qkv_project``
    splits and re-packs each layer's beat (1 and 1) and pins its cache
    splits to ``ref``.  None under ``ref``."""
    E, L = cfg.encoder.n_layers, cfg.n_superblocks
    if impl == "ref":
        return dict.fromkeys(("encode", "prefill", "enc_kv", "step"), (0, 0))
    return {"encode": (E, 0), "prefill": (E + 2 * L, L), "enc_kv": (E, 0),
            "step": (L, L)}


def whisper_serve(dev, cfg, params, impl: str, tokens, frames) -> dict:
    """Phase 13a under ``impl``: ``encdec.encode`` alone, ``jit_prefill``
    (one warm-up call, then the timed one), ``cache_from_prefill`` into
    ``WHISPER_MAX_LEN`` bf16 beats, ``precompute_enc_kv`` into the cache,
    then ``WHISPER_STEPS`` greedy ``jit_decode_step`` steps; the counts
    are zeroed just before each call and read just after."""
    import torch
    from repro_torch.kernels import segment
    from repro_torch.models import decode as dec
    from repro_torch.models import encdec
    from repro_torch.serve.engine import (ServeConfig, jit_decode_step,
                                          jit_prefill)
    cfg = dataclasses.replace(cfg, kernel_impl=impl)
    prefill = jit_prefill(cfg, None, device=dev)
    step = jit_decode_step(cfg, None, ServeConfig(max_len=WHISPER_MAX_LEN),
                           device=dev)
    batch = {"tokens": tokens, "audio_frames": frames}
    prefill(params, batch)
    launches, ms, host = {}, {}, {}

    def call(name, fn):
        segment.reset_counts()
        with torch.no_grad():
            out, ms[name], host[name] = timed(fn)
        launches[name] = seg_pair(segment_counts(), impl)
        return out

    call("encode", lambda: encdec.encode(params, frames, cfg))
    logits, states = call("prefill", lambda: prefill(params, batch))
    B, S = tokens.shape
    cache = dec.cache_from_prefill(cfg, states, S, WHISPER_MAX_LEN,
                                   torch.bfloat16)
    del states
    cache["enc_kv"] = call("enc_kv", lambda: encdec.precompute_enc_kv(
        params, frames, cfg)).to(torch.bfloat16)
    tok = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)
    stream, step_logits = [tok], [logits[:, -1].float()]
    step_ms, step_host, step_launches = [], [], []
    for _ in range(WHISPER_STEPS):
        out, cache = call("step", lambda: step(params, cache, tok))
        step_ms.append(ms["step"])
        step_host.append(host["step"])
        step_launches.append(launches["step"])
        tok = torch.argmax(out.float(), dim=-1).to(torch.int32)
        stream.append(tok)
        step_logits.append(out.float())
    if int(cache["len"]) != S + WHISPER_STEPS or not all(
            bool(torch.isfinite(t).all()) for t in step_logits):
        raise AssertionError(f"whisper [{impl}]: decode logits not finite, "
                             f"or the cache's length is not "
                             f"{S + WHISPER_STEPS}")
    del launches["step"]
    return {"streams": torch.stack(stream, 1).cpu().tolist(),
            "stream": torch.stack(stream[:-1], 1),
            "logits": torch.stack(step_logits, 1), "ms": ms, "host": host,
            "launches": launches, "step_ms": step_ms,
            "step_host": step_host, "step_launches": step_launches}


def whisper_cell(dev, card: str) -> dict:
    """Phase 13a: whisper-tiny uncut, float32 params cast once to bf16,
    under the three policies."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models.transformer import forward
    cfg = get_arch("whisper-tiny").model
    label = "phase 13a whisper-tiny"
    if predicted_params(cfg)[0] != WHISPER_PARAMS:
        raise AssertionError(f"{label}: the config's shapes give "
                             f"{predicted_params(cfg)[0]} parameters, the "
                             f"reference {WHISPER_PARAMS}")
    master, params = family_params(dev, cfg, label, cfg.n_layers)
    del master
    K, D, F = cfg.n_kv_heads, cfg.hd, cfg.encoder.context
    Bw, S = WHISPER_BATCH, WHISPER_PROMPT
    check_segment_shapes(dev, label, cfg, Bw, WHISPER_MAX_LEN, 16,
                         shapes=([(Bw, F, K, 2 * D), (Bw, S, K, 2 * D),
                                  (Bw, 1, K, 2 * D)],
                                 [(Bw, S, K, D), (Bw, 1, K, D)]))
    rng = np.random.default_rng(SEED + 13)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (Bw, S)).astype(
        np.int32)).to(dev)
    frames = torch.from_numpy(rng.normal(size=(Bw, F, cfg.d_model)).astype(
        np.float32)).to(dev)
    runs = []
    for impl in WHISPER_POLICIES:
        r = whisper_serve(dev, cfg, params, impl, tokens, frames)
        want = whisper_prediction(cfg, impl)
        got = dict(r["launches"])
        if got != {k: want[k] for k in got} or \
                any(n != want["step"] for n in r["step_launches"]):
            raise AssertionError(f"{label} [{impl}]: launches {got}, per "
                                 f"decode step {r['step_launches']}; read "
                                 f"off the code {want}")
        dec_s = sum(r["step_ms"]) / 1e3
        print(f"{label} serve[{impl}] on {card}: encode of {Bw} x {F} frames "
              f"{r['ms']['encode']:.3f} ms (host {r['host']['encode']:.3f}); "
              f"prefill of {Bw} x {S} tokens {r['ms']['prefill']:.3f} ms "
              f"(host {r['host']['prefill']:.3f}); enc_kv "
              f"{r['ms']['enc_kv']:.3f} ms (host {r['host']['enc_kv']:.3f});"
              f" median decode step {statistics.median(r['step_ms']):.3f} ms"
              f" (host {statistics.median(r['step_host']):.3f}) over "
              f"{WHISPER_STEPS} steps; decode tokens/s "
              f"{Bw * WHISPER_STEPS / dec_s:.2f}; (split, pack) launches per "
              f"encode / prefill / enc_kv / step {got['encode']} / "
              f"{got['prefill']} / {got['enc_kv']} / {want['step']}")
        runs.append((impl, r))
    for impl, r in runs[1:]:
        if r["streams"] != runs[0][1]["streams"]:
            raise AssertionError(f"{label} [{impl}]: other token streams "
                                 f"than the first {runs[0][0]} run")
    kr = runs[0][1]
    kcfg = dataclasses.replace(cfg, kernel_impl="kernel")
    with torch.no_grad():
        full, _, _ = forward(params, {"tokens": torch.cat(
            [tokens, kr["stream"]], 1), "audio_frames": frames}, kcfg)
    teacher = full[:, S - 1:].float()
    gap = float((teacher - kr["logits"]).abs().max())
    scale = float(teacher.abs().max())
    tol = max(0.08, 0.03 * scale)
    print(f"{label}: streams equal under {', '.join(WHISPER_POLICIES)}; "
          f"prefill and {WHISPER_STEPS} decode steps' logits against a "
          f"teacher-forced forward over the {S + WHISPER_STEPS}-token "
          f"sequence under kernel: largest gap {gap} within max(0.08, 0.03 "
          f"* |logits|max = {scale}) = {tol}")
    if not gap <= tol:
        raise AssertionError(f"{label}: decode vs forward gap {gap} > {tol}")
    totals = dict.fromkeys(("deinterleave", "interleave",
                            "deinterleave_dynamic", "interleave_dynamic"), 0)
    for impl, r in runs:
        if impl == "ref":
            continue
        names = (("deinterleave", "interleave") if impl == "kernel" else
                 ("deinterleave_dynamic", "interleave_dynamic"))
        pairs = list(r["launches"].values()) + r["step_launches"]
        for i, k in enumerate(names):
            totals[k] += sum(p[i] for p in pairs)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def whisper_refusals(dev, card: str) -> None:
    """Phase 13b: the paged Scheduler and BatchedServer refuse whisper
    with the reference's message, and the serve CLI exits non-zero with
    the reference's text."""
    import os
    from repro_torch.configs.base import get_arch
    from repro_torch.serve.engine import BatchedServer
    from repro_torch.serve.scheduler import Scheduler
    cfg = get_arch("whisper-tiny").model
    for cls in (Scheduler, BatchedServer):
        try:
            cls(cfg, {}, slots=4, max_len=64, page_size=16, device=dev)
        except NotImplementedError as e:
            if str(e) != PAGED_REFUSAL:
                raise AssertionError(f"{cls.__name__}: {e!r}") from e
        else:
            raise AssertionError(f"{cls.__name__} took whisper-tiny")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", "whisper-tiny"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    if out.returncode == 0 or CLI_REFUSAL not in out.stderr:
        raise AssertionError(f"serve CLI on whisper-tiny exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    print(f"phase 13b whisper-tiny: Scheduler and BatchedServer raise "
          f"NotImplementedError({PAGED_REFUSAL!r}); python -m "
          f"repro_torch.launch.serve --arch whisper-tiny exits "
          f"{out.returncode} with {CLI_REFUSAL!r}")


# ---------------------------------------------------------------------------
# Phase 14: training on one card
# ---------------------------------------------------------------------------

QWEN3_PARAMS = 596_049_920
TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4, 2, 3
SGD_LR = 1e-2                  # tests/test_smoke_archs.py:43-65's step
WHISPER_TRAIN_BATCH, WHISPER_TRAIN_SEQ = 2, 64
FLASH_BWD_CASES = (
    # (label, B, S, H, K, D, causal, window, chunk)
    ("qwen3 causal", 1, 4096, 16, 8, 128, True, None, 512),
    ("windowed 1024", 1, 4096, 16, 8, 128, True, 1024, 512),
    ("encoder", 1, 1500, 6, 6, 64, False, None, 512),
)


def sgd_gate(label: str, cfg, params, batch) -> tuple:
    """The reference's smoke gate (tests/test_smoke_archs.py:43-65): one
    SGD step at ``SGD_LR`` from finite gradients lowers the loss along
    the step (within 1e-3)."""
    import torch
    from repro_torch.kernels._common import tree_leaves
    from repro_torch.models.transformer import loss_fn, tree_map
    from repro_torch.train.step import _loss_and_grads
    loss0, _, grads = _loss_and_grads(params, batch, cfg, None)
    with torch.no_grad():
        gnorm = float(torch.sqrt(sum(torch.sum(g.float() ** 2)
                                     for g in tree_leaves(grads))))
        stepped = tree_map(lambda p, g: p - SGD_LR * g.to(p.dtype), params,
                           grads)
        del grads
        loss1 = float(loss_fn(stepped, batch, cfg)[0])
    del stepped
    loss0 = float(loss0)
    if not (math.isfinite(loss0) and math.isfinite(gnorm) and gnorm > 0
            and loss1 < loss0 + 1e-3):
        raise AssertionError(f"{label}: SGD gate: loss {loss0} -> {loss1} "
                             f"along the step, grad norm {gnorm}")
    return loss0, loss1, gnorm


def train_steps(label: str, card: str, cfg, state, batch, tcfg,
                steps: int) -> dict:
    """``steps`` calls of ``jit_train_step``; per step loss, grad norm,
    lr, ms (host clock around a synchronized step) and tokens/s."""
    import torch
    from repro_torch.train.step import jit_train_step
    step = jit_train_step(cfg, tcfg, None, state, batch)
    tokens = batch["tokens"].numel()
    rows = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(gn) and gn > 0):
            raise AssertionError(f"{label} step {i}: loss {loss}, grad norm "
                                 f"{gn}")
        rows.append((loss, gn, float(m["lr"]), s * 1e3, tokens / s))
    comp = tcfg.compression.kind
    print(f"{label} [compression {comp}, {tcfg.microbatches} microbatches] "
          f"on {card}: " + "; ".join(
              f"step {i}: loss {r[0]:.6f} grad norm {r[1]:.6f} lr {r[2]:.3e} "
              f"{r[3]:.1f} ms {r[4]:.1f} tokens/s"
              for i, r in enumerate(rows)))
    return {"state": state, "rows": rows}


@contextlib.contextmanager
def update_peaks():
    """Splits ``max_memory_allocated`` at each AdamW update of the train
    step: yields a list that gets, per step, the peak up to the update
    (forward, backward, microbatch sums, compression) and the peak within
    it."""
    import torch
    from repro_torch.train import step as train_step
    apply = train_step.apply_updates
    peaks = []

    def probe(*args, **kw):
        before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = apply(*args, **kw)
        peaks.append((before, torch.cuda.max_memory_allocated()))
        torch.cuda.reset_peak_memory_stats()
        return out

    train_step.apply_updates = probe
    try:
        yield peaks
    finally:
        train_step.apply_updates = apply


def qwen3_train_cell(dev, card: str) -> None:
    """Phase 14a: qwen3-0.6b at full width on the train_4k cell's sequence
    (4096 tokens), the global batch of 256 cut to 4 sequences as 2
    microbatches of 2; 3 steps with compression none, then int8; the SGD
    gate; the refusal under ``kernel`` (14d)."""
    import gc
    import torch
    from repro_torch.configs.base import get_arch, shape_by_name, train_batch
    from repro_torch.kernels._common import tree_leaves
    from repro_torch.models.transformer import (init_params, loss_fn,
                                                param_count, tree_map)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import (CompressionConfig,
                                               init_error_state)
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import TrainConfig
    label = "phase 14a qwen3-0.6b train"
    cell = shape_by_name("train_4k")
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").model, kernel_impl="ref")
    n = predicted_params(cfg)[0]
    if n != QWEN3_PARAMS:
        raise AssertionError(f"{label}: the config's shapes give {n}, the "
                             f"reference {QWEN3_PARAMS}")
    print(f"{label}: cell {cell.name} (seq {cell.seq_len}, global batch "
          f"{cell.global_batch} cut to {TRAIN_BATCH} sequences on one card, "
          f"{TRAIN_MICRO} microbatches of {TRAIN_BATCH // TRAIN_MICRO}); "
          f"predicted state: float32 params {4 * n / 1e9:.3f} GB + grads "
          f"{4 * n / 1e9:.3f} + AdamW m, v {8 * n / 1e9:.3f} + bf16 copy "
          f"{2 * n / 1e9:.3f} = {18 * n / 1e9:.3f} GB before activations")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    g = torch.Generator(dev).manual_seed(SEED + 14)
    batch = train_batch(cfg, cell.seq_len, TRAIN_BATCH, specs=False,
                        generator=g, device=dev)
    for kind in ("none", "int8"):
        # a step consumes its state in place: each run trains its own
        # seeded params
        params = init_params(cfg, SEED, device=dev)
        if param_count(params) != n:
            raise AssertionError(f"{label}: param_count "
                                 f"{param_count(params)}")
        tcfg = TrainConfig(optimizer=AdamWConfig(), microbatches=TRAIN_MICRO,
                           compression=CompressionConfig(kind=kind))
        state = init_train_state(params)
        if kind != "none":
            state["grad_error"] = init_error_state(params)
        del params
        with update_peaks() as peaks:
            r = train_steps(label, card, cfg, state, batch, tcfg,
                            TRAIN_STEPS)
        if kind == "none":
            # 18: one more step under bundle_from_trace, against the
            # measured steps' median
            from repro_torch.roofline.analysis import bundle_from_trace
            from repro_torch.train.step import make_train_step
            _, b = bundle_from_trace(make_train_step(cfg, tcfg), r["state"],
                                     batch)
            torch.cuda.synchronize()
            roofline_lines(f"phase 14a qwen3-0.6b train step [bf16 compute, "
                           f"one process, {TRAIN_MICRO} microbatches]",
                           {"flops": b.flops, "bytes": b.bytes_accessed,
                            "coll_bytes": b.coll_bytes},
                           statistics.median(x[3] for x in r["rows"]),
                           batch["tokens"].numel(), "qwen3-0.6b")
        del state, r["state"]
        gc.collect()
        top = max(max(p) for p in peaks)
        print(f"{label} [compression {kind}]: param_count {n}; median step "
              f"{statistics.median(x[3] for x in r['rows']):.1f} ms, "
              f"{statistics.median(x[4] for x in r['rows']):.1f} tokens/s; "
              f"max_memory_allocated {top / 1e9:.3f} GB "
              f"({held / 1e9:.3f} GB held before init); per step, the peak "
              f"up to the update / within it: " + ", ".join(
                  f"{a / 1e9:.3f} / {b / 1e9:.3f}" for a, b in peaks)
              + " GB")
    params = init_params(cfg, SEED, device=dev)
    half = {k: v[:TRAIN_BATCH // TRAIN_MICRO] for k, v in batch.items()}
    l0, l1, gn = sgd_gate(label, cfg, params, half)
    print(f"{label}: SGD gate at lr {SGD_LR} on one microbatch "
          f"({TRAIN_BATCH // TRAIN_MICRO} x {cell.seq_len}): loss {l0} -> "
          f"{l1} along the step, grad norm {gn}")
    # 14d: under kernel the training forward refuses at the first vx verb
    kcfg = dataclasses.replace(cfg, kernel_impl="kernel")
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    small = {k: v[:1, :128] for k, v in batch.items()}
    try:
        loss_fn(leaves, small, kcfg)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        msg = str(e)
    else:
        raise AssertionError(f"{label}: a kernel-policy training forward "
                             f"returned")
    if any(p.grad is not None for p in tree_leaves(leaves)):
        raise AssertionError(f"{label}: gradients reached the params")
    print(f"phase 14d: under kernel, loss_fn with gradients on raised "
          f"RuntimeError at the first vx verb: {msg[:96]}...")
    del params, leaves, batch, half
    gc.collect()
    torch.cuda.empty_cache()


def whisper_train_cell(dev, card: str) -> None:
    """Phase 14b: one whisper-tiny train step at full width, frames of
    (2, 1500, 384) and 64 tokens, with 14a's gates."""
    import gc
    import torch
    from repro_torch.configs.base import get_arch, train_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import TrainConfig
    from repro_torch.models.transformer import init_params
    label = "phase 14b whisper-tiny train"
    cfg = dataclasses.replace(get_arch("whisper-tiny").model,
                              kernel_impl="ref")
    params = init_params(cfg, SEED, device=dev)
    g = torch.Generator(dev).manual_seed(SEED + 15)
    batch = train_batch(cfg, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_BATCH,
                        specs=False, generator=g, device=dev)
    shape = tuple(batch["audio_frames"].shape)
    train_steps(label, card, cfg, init_train_state(params), batch,
                TrainConfig(optimizer=AdamWConfig()), 1)
    params = init_params(cfg, SEED, device=dev)     # the step consumed it
    l0, l1, gn = sgd_gate(label, cfg, params, batch)
    print(f"{label}: frames {shape}, {WHISPER_TRAIN_SEQ} tokens; SGD gate at "
          f"lr {SGD_LR}: loss {l0} -> {l1} along the step, grad norm {gn}")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()


def plain_attention(q, k, v, *, causal: bool, window):
    """Unchunked softmax attention (float32) for autograd to
    differentiate: the flash backward's plain version."""
    import torch
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qt = q.reshape(B, Sq, K, H // K, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qt, k) * D ** -0.5
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qp >= kp)
    if window is not None:
        mask = mask & ((qp - kp) < window)
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def flash_backward_check(dev, card: str) -> None:
    """Phase 14c: the flash backward against autograd through the plain
    attention in float32, each of dq / dk / dv within 1e-4 of its largest
    magnitude; the forward's and backward's ms (CUDA events)."""
    import torch
    from repro_torch.models import attention
    for name, B, S, H, K, D, causal, window, chunk in FLASH_BWD_CASES:
        g = torch.Generator(dev).manual_seed(SEED + S + H)
        q = torch.randn((B, S, H, D), generator=g, device=dev)
        k, v = (torch.randn((B, S, K, D), generator=g, device=dev)
                for _ in range(2))
        dout = torch.randn((B, S, H, D), generator=g, device=dev)
        leaves = [t.requires_grad_() for t in (q, k, v)]
        kw = dict(causal=causal, window=window, q_chunk=chunk,
                  kv_chunk=chunk)
        attention.flash_attention(*leaves, **kw)        # warm-up
        out, fwd_ms, _ = timed(lambda: attention.flash_attention(*leaves,
                                                                  **kw))
        got, bwd_ms, _ = timed(lambda: torch.autograd.grad(out, leaves,
                                                           dout))
        want = torch.autograd.grad(plain_attention(
            *leaves, causal=causal, window=window), leaves, dout)
        errs = [float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(got, want)]
        print(f"phase 14c flash backward [{name}] ({B}, {S}, {H}, {D}), "
              f"{K} KV heads, chunk {chunk}, float32 on {card}: forward "
              f"{fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms; dq / dk / dv "
              f"against autograd through the plain attention: "
              f"{' / '.join(f'{e:.3e}' for e in errs)} of max|grad| "
              f"(bound 1e-4)")
        if max(errs) > 1e-4:
            raise AssertionError(f"phase 14c [{name}]: {errs} > 1e-4")
        del q, k, v, dout, leaves, out, got, want
        torch.cuda.empty_cache()


def card_vs_cpu(dev) -> None:
    """Phase 14e: qwen3-smoke in float32, the port's loss and gradients on
    the card against its own device="cpu" run, within 1e-4 relative."""
    from repro_torch.configs.base import get_arch, train_batch
    from repro_torch.kernels._common import tree_leaves
    from repro_torch.models.transformer import init_params, tree_map
    from repro_torch.train.step import _loss_and_grads
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").smoke, kernel_impl="ref")
    params = init_params(cfg, SEED, device="cpu")
    batch = train_batch(cfg, 64, 2, specs=False, device="cpu")
    cpu = _loss_and_grads(params, batch, cfg, None)
    card = _loss_and_grads(tree_map(lambda t: t.to(dev), params),
                           {k: v.to(dev) for k, v in batch.items()}, cfg,
                           None)
    loss_gap = abs(float(card[0]) - float(cpu[0])) / abs(float(cpu[0]))
    worst = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                for a, b in zip(tree_leaves(card[2]), tree_leaves(cpu[2])))
    print(f"phase 14e qwen3-0.6b-smoke float32: loss on the card "
          f"{float(card[0])} vs the CPU {float(cpu[0])} (relative gap "
          f"{loss_gap:.3e}); worst gradient leaf gap {worst:.3e} of its "
          f"max (bound 1e-4)")
    if loss_gap > 1e-4 or worst > 1e-4:
        raise AssertionError(f"phase 14e: loss gap {loss_gap}, grads "
                             f"{worst}")


def encdec_train_phase(dev, card: str) -> dict:
    """Phases 13 (whisper-tiny serving and its refusals) and 14 (training:
    qwen3-0.6b and whisper-tiny at full width, the flash backward, the
    refusal under ``kernel``, the card against the CPU).  Returns phase
    13's launches of B1 / B2 under ``kernel`` and B6 / B7 under
    ``kernel_dynamic``."""
    t_phase = time.perf_counter()
    launches = whisper_cell(dev, card)
    whisper_refusals(dev, card)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s; launches under "
          f"kernel / kernel_dynamic {launches}")
    t_phase = time.perf_counter()
    qwen3_train_cell(dev, card)
    whisper_train_cell(dev, card)
    flash_backward_check(dev, card)
    card_vs_cpu(dev)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the training launcher's substrate — the AoS data path,
# checkpoints, the CLI, and the RCVRF model
# ---------------------------------------------------------------------------

DATA_VOCAB, DATA_SEQ, DATA_BATCH = 151_936, 4096, 256      # train_4k
CKPT_BATCH, CKPT_SEQ = 1, 512
TRAIN_CLI = ("--arch", "qwen3-0.6b", "--steps", "6", "--batch", "4",
             "--seq", "512", "--lr", "1e-3")
RESUME_CLI = ("--arch", "qwen3-0.6b", "--smoke", "--steps", "9", "--batch",
              "4", "--seq", "64", "--lr", "1e-3", "--ckpt-every", "3")
# the reference CLI's step line (src/repro/launch/train.py:98-102)
TRAIN_STEP_LINE = (r"step +(\d+) loss=(-?\d+\.\d{4}) gnorm=(\d+\.\d{3}) "
                   r"lr=(\d\.\d{2}e[+-]\d{2}) (\d+)ms excluded_hosts=\[\]")
GUARD_TEXT = "no backward"


def data_gate(label: str, impl: str, what: str, got: dict,
              split: int, pack: int) -> None:
    """``got`` must be ``split`` B1 (B6) and ``pack`` B2 (B7) launches
    under ``impl`` and nothing else; none under ``ref``."""
    want = dict.fromkeys(SEG_ORDER, 0)
    if impl != "ref":
        d, i = {"kernel": ("deinterleave", "interleave"),
                "kernel_dynamic": ("deinterleave_dynamic",
                                   "interleave_dynamic")}[impl]
        want[d], want[i] = split, pack
    if got != want:
        raise AssertionError(f"{label} [{impl}] {what}: launches {got}, "
                             f"want {want}")


def data_cell(dev, card: str) -> dict:
    """15a: the data path at train_4k's shape, uncut: the AoS buffer
    ``(256, 16384)`` int32 under ``kernel``, ``kernel_dynamic`` and
    ``ref`` against a numpy interleave of the pipeline's fields, its
    unpack, fused against unfused batches; the launches gated; B1 / B2 /
    B6 / B7 bit for bit against their plain versions at the path's shapes
    and the CLI's; pack and unpack timed.  Returns the launches of the
    main-path runs (pack, unpack and two unfused batches a policy)."""
    import numpy as np
    import torch
    from repro_torch import vx
    from repro_torch.data.aos import FIELDS, WEIGHT_SCALE, unpack_records
    from repro_torch.data.pipeline import DataConfig, SyntheticAoSPipeline
    from repro_torch.kernels import segment
    label = "phase 15a data"
    cfg = DataConfig(vocab=DATA_VOCAB, seq_len=DATA_SEQ,
                     global_batch=DATA_BATCH)
    B, S, n = DATA_BATCH, DATA_SEQ, FIELDS * DATA_SEQ
    toks, labels, weights, docs = SyntheticAoSPipeline(
        cfg, device=dev)._global_fields_np(0)
    wq = np.round(weights * WEIGHT_SCALE).astype(np.int32)
    want = np.stack([toks, labels, wq, docs], -1).reshape(B, n)
    soa = {"tokens": toks, "labels": labels, "doc_id": docs,
           "loss_weight": wq.astype(np.float32) / np.float32(WEIGHT_SCALE)}
    print(f"{label}: DataConfig(vocab={DATA_VOCAB}, seq_len={S}, "
          f"global_batch={B}), the AoS buffer ({B}, {n}) int32 "
          f"({want.nbytes} B); B1 / B6 fold each {n}-lane row into "
          f"{segment._fold(n, FIELDS, 4)} chunks, B2 / B7 into "
          f"{segment._fold(n, FIELDS, 4, interleave=True)}")
    total = dict.fromkeys(SEG_ORDER, 0)
    for impl in ("kernel", "kernel_dynamic", "ref"):
        with vx.use(impl):
            pipe = SyntheticAoSPipeline(cfg, device=dev)
            segment.reset_counts()
            buf = pipe.next_host_aos()
            c_pack = segment_counts()
            data_gate(label, impl, "next_host_aos", c_pack, 0, 1)
            if not (buf.dtype == np.int32 and np.array_equal(buf, want)):
                raise AssertionError(f"{label} [{impl}]: next_host_aos != "
                                     f"the numpy interleave")
            segment.reset_counts()
            out = unpack_records(torch.from_numpy(buf).to(dev))
            c_unpack = segment_counts()
            data_gate(label, impl, "unpack_records", c_unpack, 1, 0)
            for key, w in soa.items():
                got = out[key].cpu().numpy()
                if got.dtype != w.dtype or not np.array_equal(
                        got.view(np.int32), w.view(np.int32)):
                    raise AssertionError(f"{label} [{impl}]: unpacked "
                                         f"{key} != the pipeline's field")
            del out
            fused = SyntheticAoSPipeline(cfg, device=dev)
            unfused = SyntheticAoSPipeline(cfg, device=dev)
            c_steps = dict.fromkeys(SEG_ORDER, 0)
            for _ in range(2):
                segment.reset_counts()
                a = fused.next_batch(fused=True)
                data_gate(label, impl, "next_batch(fused=True)",
                          segment_counts(), 0, 0)
                segment.reset_counts()
                b = unfused.next_batch(fused=False)
                c = segment_counts()
                data_gate(label, impl, "next_batch(fused=False)", c, 1, 1)
                for k in c_steps:
                    c_steps[k] += c[k]
                if sorted(a) != sorted(b) or not all(
                        same_bits(a[k], b[k]) for k in a):
                    raise AssertionError(f"{label} [{impl}]: fused batch != "
                                         f"unfused batch")
            if fused.state_dict() != unfused.state_dict():
                raise AssertionError(f"{label} [{impl}]: pipeline states "
                                     f"{fused.state_dict()} vs "
                                     f"{unfused.state_dict()}")
        for k in total:
            total[k] += c_pack[k] + c_unpack[k] + c_steps[k]
        print(f"{label} [{impl}]: next_host_aos == the numpy interleave bit "
              f"for bit, unpack_records == the fields, next_batch(fused) == "
              f"next_batch(fused=False) over 2 steps with equal states; "
              f"launches per pack / unpack / unfused batch "
              f"{seg_pair(c_pack, impl)} / {seg_pair(c_unpack, impl)} / "
              f"{tuple(x // 2 for x in seg_pair(c_steps, impl))} as (split, "
              f"pack), none on the fused path")
    check_segment_shapes(dev, label, None, 0, 0, 0, dtype="int32",
                         fields=FIELDS, shapes=([(B, n), (4, 4 * 512)],
                                                [(B, S), (4, 512)]))
    fields = [torch.from_numpy(f).to(dev) for f in (toks, labels, wq, docs)]
    aos = torch.from_numpy(want).to(dev)
    for fn, args, plain in (
            (segment.interleave, (fields,), segment.interleave_plain),
            (segment.interleave_dynamic, (fields,),
             segment.interleave_dynamic_plain),
            (segment.deinterleave, (aos, FIELDS),
             segment.deinterleave_plain),
            (segment.deinterleave_dynamic, (aos, FIELDS),
             segment.deinterleave_dynamic_plain)):
        got, ref = fn(*args), plain(*args)
        if not all(same_bits(x, y) for x, y in zip(
                got if isinstance(got, list) else [got],
                ref if isinstance(ref, list) else [ref])):
            raise AssertionError(f"{label}: timed {fn.__name__} != plain")
    bound = 2 * want.nbytes / HBM_BYTES_PER_S * 1e3
    times = {}
    for name, fn in (
            ("B2 interleave", lambda: segment.interleave(fields)),
            ("B7 interleave_dynamic",
             lambda: segment.interleave_dynamic(fields)),
            ("library stack(fields, -1).flatten(-2)",
             lambda: torch.stack(fields, -1).flatten(-2)),
            ("B1 deinterleave", lambda: segment.deinterleave(aos, FIELDS)),
            ("B6 deinterleave_dynamic",
             lambda: segment.deinterleave_dynamic(aos, FIELDS)),
            ("library view(B, S, 4).permute(2, 0, 1).contiguous()",
             lambda: aos.view(B, S, FIELDS).permute(2, 0, 1).contiguous())):
        times[name] = (time_ms(fn, 50), graph_ms(fn, 20))
    plain = {"B2 plain": time_ms(lambda: segment.interleave_plain(fields), 3),
             "B1 plain": time_ms(lambda: segment.deinterleave_plain(
                 aos, FIELDS), 3)}
    print(f"{label} on {card}: pack (4 x ({B}, {S}) int32 -> ({B}, {n})) and "
          f"unpack, ms a call (CUDA events over 50 calls / device alone in a "
          f"CUDA graph of 20), bound {bound:.4f} ms (2 x {want.nbytes} B / "
          f"3.35 TB/s): " + "; ".join(
              f"{k} {a:.4f} / {g:.4f} ({g / bound:.2f}x bound)"
              for k, (a, g) in times.items())
          + "; " + "; ".join(f"{k} {v:.4f}" for k, v in plain.items()))
    del fields, aos
    torch.cuda.empty_cache()
    return total


def checkpoint_cell(dev, card: str) -> None:
    """15b: qwen3-0.6b's full train state (float32 params, AdamW m and v,
    the int32 step) after one ``ref`` train step on a (1, 512) pipeline
    batch: ``save(blocking=False)``, ``wait()``, ``restore`` into a state
    from another seed, every leaf bit for bit on the card; the snapshot,
    write and restore times and the bytes on disk."""
    import gc
    import shutil
    import torch
    from repro_torch import vx
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticAoSPipeline
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.kernels._common import pytree_nbytes, tree_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (TrainConfig, init_full_state,
                                        make_train_step)
    label = "phase 15b checkpoint"
    cfg = dataclasses.replace(get_arch("qwen3-0.6b").model, kernel_impl="ref")
    tcfg = TrainConfig(optimizer=AdamWConfig())
    state = init_full_state(cfg, tcfg, SEED, dev)
    pipe = SyntheticAoSPipeline(DataConfig(vocab=cfg.vocab, seq_len=CKPT_SEQ,
                                           global_batch=CKPT_BATCH),
                                device=dev)
    with vx.use("ref"):
        state, m = make_train_step(cfg, tcfg)(state, pipe.next_batch())
    if int(state["opt"]["step"]) != 1 or not math.isfinite(float(m["loss"])):
        raise AssertionError(f"{label}: the train step: {m}")
    nbytes = pytree_nbytes(state)
    d = ROOT / "build" / "phase15_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    d.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(d.parent).free
    mgr = CheckpointManager(str(d))
    extra = {"step": 1, "pipeline": pipe.state_dict()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, state, extra=extra, blocking=False)
    snap = time.perf_counter() - t0
    mgr.wait()
    write = time.perf_counter() - t0 - snap
    disk = sum(f.stat().st_size for f in (d / "step_00000001").iterdir())
    other = init_full_state(cfg, tcfg, SEED + 1, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, got_extra = mgr.restore(other)
    torch.cuda.synchronize()
    restore = time.perf_counter() - t0
    del other
    pairs = list(zip(tree_leaves(restored), tree_leaves(state)))
    bad = [i for i, (a, b) in enumerate(pairs)
           if a.device != b.device or not same_bits(a, b)]
    if bad or got_extra != extra or len(pairs) != len(tree_leaves(state)):
        raise AssertionError(f"{label}: {len(bad)} of {len(pairs)} leaves "
                             f"differ or sit elsewhere; extra {got_extra}")
    shutil.rmtree(d, ignore_errors=True)
    print(f"{label} qwen3-0.6b train state on {card}: {len(pairs)} leaves, "
          f"{nbytes} B on the card (3 x {QWEN3_PARAMS} float32 + the int32 "
          f"step); snapshot to host memory before save returns "
          f"{snap * 1e3:.1f} ms ({nbytes / snap / 1e9:.2f} GB/s), background "
          f"write {write:.2f} s ({nbytes / write / 1e9:.3f} GB/s; "
          f"{free / 1e9:.1f} GB free before), {disk} B on disk "
          f"({disk - nbytes} B of npz and manifest over the leaves), restore "
          f"into a state from another seed {restore:.2f} s; every leaf bit "
          f"for bit on the card, the pipeline state restored")
    del restored, state, pairs
    gc.collect()
    torch.cuda.empty_cache()


def train_cli(args, impl: str | None = "ref", ok: bool = True) -> dict:
    """``python -m repro_torch.launch.train ARGS`` in a subprocess, with
    ``REPRO_TORCH_VX_IMPL=impl`` (unset for ``None``); raises unless it
    exits 0 (``ok``) or non-zero (not ``ok``)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_TORCH_VX_IMPL", None)
    if impl is not None:
        env["REPRO_TORCH_VX_IMPL"] = impl
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if (out.returncode == 0) != ok:
        raise AssertionError(f"train CLI {' '.join(args)} exited "
                             f"{out.returncode}:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    return {"lines": out.stdout.splitlines(), "stderr": out.stderr,
            "wall_s": wall, "rc": out.returncode}


def parse_train(r: dict) -> tuple:
    """({step: (loss, ms)}, final loss, resumed step or None) of a train
    CLI run's lines; every loss finite."""
    import re
    steps, final, resumed = {}, None, None
    for line in r["lines"]:
        if m := re.fullmatch(TRAIN_STEP_LINE, line):
            steps[int(m[1])] = (float(m[2]), int(m[5]))
        elif line.startswith("done; final loss "):
            final = float(line.split()[-1])
        elif m := re.fullmatch(r"resumed from step (\d+)", line):
            resumed = int(m[1])
    if final is None or not steps or not all(
            math.isfinite(x) for x in [final] + [v[0] for v in
                                                  steps.values()]):
        raise AssertionError(f"train CLI lines: {r['lines']}")
    return steps, final, resumed


def resume_pair() -> tuple:
    """15c (iv): the smoke run A with checkpoints, then B resumed from A's
    step-6 checkpoint; their parsed runs."""
    import shutil
    a_dir, b_dir = ROOT / "build" / "phase15_cli_a", ROOT / "build" / \
        "phase15_cli_b"
    for d in (a_dir, b_dir):
        shutil.rmtree(d, ignore_errors=True)
    a = parse_train(train_cli(RESUME_CLI + ("--ckpt-dir", str(a_dir))))
    shutil.copytree(a_dir, b_dir)
    shutil.rmtree(b_dir / "step_00000009")
    b = parse_train(train_cli(RESUME_CLI + ("--ckpt-dir", str(b_dir),
                                            "--resume")))
    for d in (a_dir, b_dir):
        shutil.rmtree(d, ignore_errors=True)
    return a, b


# ---------------------------------------------------------------------------
# Phase 19: the examples' twins
# ---------------------------------------------------------------------------

#: Phase 19's runs of ``examples_torch/*.py``: (name, arguments).  The
#: first three run whole; ``train_100m`` runs 100 of its 300 default steps
#: (its first checkpoint, written at step 100, is restored and held
#: against the live state bit for bit), at its own batch 8 x 256.
TWINS = (("quickstart", ()), ("moe_dispatch_demo", ()),
         ("serve_batch", ()),
         ("train_100m", ("--steps", "100", "--ckpt",
                         str(ROOT / "build" / "twin_100m_ckpt"))))
#: The kernels each twin must launch (at least once; every other wrapper
#: never): quickstart's ``vx.transpose(Segment)`` and ``unpack_records``
#: (B1), ``pack_records`` (B2), ``vx.gather`` / ``vx.scatter`` on a
#: static ``Strided`` spec (B3, B5); serve_batch's decode steps' fused
#: split (B1) and its prefill's beat packs (B2).  The MoE demo's
#: ``vx.compact`` on a mask and ``gather_network`` run torch ops, and the
#: training twin's fused input path and ``ref`` step launch nothing.
TWIN_KERNELS = {"quickstart": ("deinterleave", "interleave",
                               "gather_strided", "scatter_strided"),
                "moe_dispatch_demo": (), "serve_batch": ("deinterleave",
                                                         "interleave"),
                "train_100m": ()}
#: Whether train_100m's LEARNING verdict is gated: it would be if the
#: reference's ``examples/train_100m.py --steps 100`` printed LEARNING on
#: the CPU, but that script exits before its first step
#: (``jit_train_step(cfg, tcfg, None, ...)`` reads ``None.mesh``), so it
#: prints no verdict, and the twin's is printed, not gated.
TWIN_LEARNING_GATED = False
#: The runs' launches per wrapper, summed by their reports; ``main`` adds
#: them to the kernels' line.
TWIN_LAUNCHES: dict = {}
TWIN_DRIVER = """
import json, runpy, sys
from repro_torch.kernels import (moe_compact, segment, shift_gather,
                                 shift_scatter, strided)
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
ws = (segment.KERNELS + segment.DYNAMIC + strided.KERNELS + strided.DYNAMIC
      + moe_compact.KERNELS + shift_gather.KERNELS + shift_scatter.KERNELS)
print("launches " + json.dumps({f.__name__: f.launches for f in ws}))
"""


def run_twin(name: str, args) -> dict:
    """Phase 19: ``examples_torch/<name>.py`` in a subprocess on the card
    (its default device), under a driver that prints every kernel
    wrapper's launches when the script returns."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", TWIN_DRIVER,
                          str(ROOT / "examples_torch" / f"{name}.py"),
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    return {"name": name, "args": list(args), "rc": out.returncode,
            "wall_s": time.perf_counter() - t0,
            "lines": out.stdout.splitlines(), "err": out.stderr[-3000:]}


def _twin_gates(r: dict, card: str) -> tuple:
    """``(what it printed of its gates, launches)`` of a twin's run; raises
    on a failed gate."""
    import re
    name, lines = r["name"], r["lines"]
    text = "\n".join(lines)
    fail = []
    launches = {}
    if r["rc"] != 0 or not lines or not lines[-1].startswith("launches "):
        raise AssertionError(f"phase 19 {name} exited {r['rc']}:\n"
                             f"{text[-3000:]}\n{r['err']}")
    launches = json.loads(lines[-1][len("launches "):])
    mine = TWIN_KERNELS[name]
    if any(launches[k] <= 0 for k in mine) or \
            any(n != 0 for k, n in launches.items() if k not in mine):
        fail.append(f"launches {launches}, want {mine} and no other")
    seen = []
    if name == "quickstart":
        want = ("kernel deinterleave ok: [0. 2. 4. 6.]",
                "unpacked tokens: [5 6 7 8] labels: [6 7 8 9]")
        seen = [w for w in want if w in text]
        if len(seen) != len(want):
            fail.append(f"missing {set(want) - set(seen)}")
    elif name == "moe_dispatch_demo":
        want = ("conflict-free routing: True", "vx.compact agrees: True")
        seen = [w for w in want if w in lines]
        if len(seen) != len(want):
            fail.append(f"missing {set(want) - set(seen)}")
    elif name == "serve_batch":
        peak = re.search(r"pages in use at peak load: (\d+) of (\d+)", text)
        after = re.search(r"pages after finish: (\d+) in use, (\d+) free",
                          text)
        slots = re.findall(r"^  slot \d+: \[", text, re.M)
        thru = [ln for ln in lines if ln.startswith("throughput:")]
        ok = bool(peak and after) and int(peak.group(1)) > 0 and \
            int(after.group(1)) == 0 and after.group(2) == peak.group(2) \
            and len(slots) == 3 and len(thru) == 1 and \
            card.split(",")[0].strip() in thru[0]
        seen = [peak.group(0) if peak else None,
                after.group(0) if after else None]
        if not ok:
            fail.append("pages after finish must equal pages before (all "
                        "free), three slots, the card named")
    else:
        losses = [float(x) for x in re.findall(r" loss=(\S+) ", text)]
        verdict = re.search(r"^loss (\S+) -> (\S+) \((.*)\)$", text, re.M)
        restored = "checkpoint step 100 restored bit for bit: True" in text
        ok = len(losses) == 5 and all(math.isfinite(x) for x in losses) \
            and verdict is not None and restored and all(
                math.isfinite(float(x)) for x in verdict.groups()[:2])
        if TWIN_LEARNING_GATED and verdict and verdict.group(3) != "LEARNING":
            ok = False
        seen = [verdict.group(0) if verdict else None,
                "checkpoint step 100 restored bit for bit: True"
                if restored else None]
        if not ok:
            fail.append("finite losses, a verdict and the step-100 "
                        "checkpoint restored bit for bit")
    if fail:
        raise AssertionError(f"phase 19 {name}: {'; '.join(fail)}:\n"
                             f"{text[-3000:]}")
    return seen, launches


def report_twin(card: str):
    """Phase 19's report of one twin's run: its gates, lines and
    launches (added to :data:`TWIN_LAUNCHES`)."""
    def report(r: dict) -> None:
        seen, launches = _twin_gates(r, card)
        _add(TWIN_LAUNCHES, launches)
        print(f"phase 19 {r['name']} (python examples_torch/{r['name']}.py "
              f"{' '.join(r['args'])}, a subprocess on {card}): exit 0 in "
              f"{r['wall_s']:.1f} s; gates {seen}; launches "
              f"{ {k: n for k, n in launches.items() if n} }")
        for ln in r["lines"][:-1]:
            print(f"phase 19 {r['name']} | {ln}")
    return report


def twins_phase(card: str) -> None:
    """Phase 19: the four twins of ``examples/*.py`` in subprocesses on the
    card (queued on the background beside phases 11-14)."""
    cli_runs(*[(report_twin(card), run_twin, name, args)
               for name, args in TWINS])


def cli_cell(card: str) -> None:
    """15c: the training CLI in subprocesses (:func:`cli_runs`): (i)
    qwen3-0.6b at full width under ``ref``, the batch cut to 4 x 512
    tokens; (ii) the same under the card's default policy refuses at the
    kernels' gradient guard; (iii) ``--mesh single-pod`` in a world of one
    process raises the production mesh's ``ValueError``; (iv)
    at smoke size, a run and its resume from the step-6 checkpoint end at
    the same loss."""
    label = "phase 15c train CLI"

    def report_train(r):
        steps, final, _ = parse_train(r)
        tokens = 4 * 512
        print(f"{label} ({' '.join(TRAIN_CLI)}; train_4k's global batch 256 "
              f"x 4096 cut to 4 x 512 tokens) under REPRO_TORCH_VX_IMPL=ref "
              f"on {card}: exit 0 in {r['wall_s']:.1f} s; " + "; ".join(
                  f"step {s}: loss {v[0]} {v[1]} ms "
                  f"({tokens / v[1] * 1e3:.1f} tokens/s)"
                  for s, v in sorted(steps.items()))
              + f"; final loss {final}")

    def report_guard(r):
        if GUARD_TEXT not in r["stderr"] or "RuntimeError" not in r["stderr"]:
            raise AssertionError(f"{label}: the default policy's refusal: "
                                 f"{r['stderr'][-2000:]}")
        print(f"{label}: without REPRO_TORCH_VX_IMPL (the card's default "
              f"policy kernel) exit {r['rc']} with the kernels' gradient "
              f"guard: {r['stderr'].strip().splitlines()[-1][:120]}...")

    def report_mesh(r):
        if "needs 256 ranks, the process group has 1" not in r["stderr"] \
                or "ValueError" not in r["stderr"]:
            raise AssertionError(f"{label}: the mesh refusal: "
                                 f"{r['stderr'][-2000:]}")
        print(f"{label}: --mesh single-pod exit {r['rc']}: "
              f"{r['stderr'].strip().splitlines()[-1]}")

    def report_resume(pair):
        a, b = pair
        gap = abs(b[1] - a[1]) / abs(a[1])
        if b[2] != 6 or gap > 1e-5:
            raise AssertionError(f"{label}: resume {b[2]}, final losses "
                                 f"{a[1]} / {b[1]}, A's losses {a[0]}")
        losses = ", ".join(f"step {k} {v[0]}" for k, v in sorted(a[0].items()))
        print(f"{label} resume ({' '.join(RESUME_CLI)}) on {card}: run A "
              f"losses {losses}, final {a[1]}; run B resumed from step "
              f"{b[2]} of A's checkpoints to {b[1]} (relative gap {gap:.3e}, "
              f"bound 1e-5)")

    cli_runs(
        (report_train, train_cli, TRAIN_CLI),
        (report_guard, train_cli,
         TRAIN_CLI[:2] + ("--steps", "1") + TRAIN_CLI[4:], None, False),
        (report_mesh, train_cli,
         TRAIN_CLI[:2] + ("--steps", "1", "--mesh", "single-pod"), "ref",
         False),
        (report_resume, resume_pair))


def rcvrf_cell(dev, card: str) -> None:
    """15d: ``core/rcvrf`` on the card against the same calls on the CPU,
    bit for bit: 32 row writes and reads, then every (block, byte, count)
    of the reference test's spec: a column read, a column write and the
    rows it wrote."""
    import torch
    from repro_torch.core import rcvrf
    label = "phase 15d rcvrf"
    spec = rcvrf.VRFSpec(vlen=256, elen=64, n_regs=32, n_banks=8,
                         elem_bits=8)
    t0 = time.perf_counter()
    vrfs = {d: rcvrf.empty_vrf(spec, device=d) for d in (dev, "cpu")}
    for reg in range(spec.n_regs):
        data = (torch.arange(32) * 3 + 11 * reg).remainder(256).to(
            torch.uint8)
        vrfs = {d: rcvrf.write_row(spec, v, reg, data.to(d))
                for d, v in vrfs.items()}
    full_card, full_cpu = vrfs[dev], vrfs["cpu"]
    if not (same_bits(full_card.cpu(), full_cpu) and all(
            same_bits(rcvrf.read_row(spec, full_card, r).cpu(),
                      rcvrf.read_row(spec, full_cpu, r))
            for r in range(spec.n_regs))):
        raise AssertionError(f"{label}: write_row / read_row differ")
    cases = 0
    for block in range(spec.blocks_per_reg):
        for byte in range(spec.elems_per_block):
            for count in range(1, spec.n_banks + 1):
                col = [rcvrf.read_column(spec, v, 0, block, byte, count)
                       for v in (full_card, full_cpu)]
                vals = torch.arange(count, dtype=torch.uint8) + 100
                wrote = [rcvrf.write_column(spec, v, 0, block, byte,
                                            vals.to(v.device))
                         for v in (full_card, full_cpu)]
                rows = [[rcvrf.read_row(spec, w, i) for i in range(count)]
                        for w in wrote]
                if not (same_bits(col[0].cpu(), col[1])
                        and same_bits(wrote[0].cpu(), wrote[1])
                        and all(same_bits(x.cpu(), y)
                                for x, y in zip(*rows))
                        and all(int(rows[1][i][block * spec.elems_per_block
                                               + byte]) == 100 + i
                                for i in range(count))):
                    raise AssertionError(f"{label}: (block, byte, count) "
                                         f"({block}, {byte}, {count})")
                cases += 1
    print(f"{label} {spec} on {card}: 32 row writes and reads, then "
          f"{cases} (block, byte, count) cases of read_column / write_column "
          f"/ read_row: the card == the CPU bit for bit "
          f"({time.perf_counter() - t0:.1f} s)")


def launcher_phase(dev, card: str) -> dict:
    """Phase 15: 15a, 15b and 15d (15c, the CLI runs, is
    :func:`cli_cell`, which ``main`` queues on the background before phase
    11).  Returns 15a's launches of B1 / B2 under ``kernel`` and B6 / B7
    under ``kernel_dynamic``."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    launches = data_cell(dev, card)
    print(f"phase 15a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    checkpoint_cell(dev, card)
    print(f"phase 15b: {time.perf_counter() - t0:.1f} s")
    rcvrf_cell(dev, card)
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s; launches on the "
          f"data path {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 16: sharded serving, 4 ranks of one gloo group on the one card
# ---------------------------------------------------------------------------

RANKS16 = 4
LONG_SEQ, LONG_LEN = 32768, 16384      # long_500k's 524 288 tokens, cut
#: The reference's (stride, offset) list (tests/_dist_checks.py:283-284),
#: its n = 64 and vl = 8 scaled by 64 to the card's n = 4096, vl = 512, so
#: each access spans several ranks' lanes.
REF_STRIDED = tuple((s, 64 * o) for s, o in (
    (1, 0), (2, 3), (3, 1), (5, 2), (7, 1), (-1, 63), (-2, 50), (-4, 40)))
STRIDED16_N, STRIDED16_VL = 4096, 512
# 16c's greedy steps in bf16 (fused and per-access) and its float32 arm:
# each sharded step moves its collectives through gloo on the host (4
# bf16 steps, cut from 8 to make room for 17g; the first four keep every
# gate)
LONG_STEPS16, F32_STEPS16 = 4, 4
PHASE16_POLICIES = ("kernel", "kernel_dynamic", "ref")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank16(rank: int, world: int, port: int, out_dir: str, run) -> None:
    """One rank of a spawn on ``cuda:0``: joins the ``gloo`` group over
    localhost (every rank shares the one card), runs ``run(rank)``
    (:func:`phases16_17` or :func:`timed17`) and writes its result as
    JSON for the parent."""
    import datetime
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        result = run(rank)
        torch.cuda.synchronize()
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def timed17(rank: int) -> dict:
    """:func:`sharded17` with its wall seconds."""
    t0 = time.perf_counter()
    result = sharded17(rank)
    result["s"] = time.perf_counter() - t0
    return result


def phases16_17(rank: int) -> dict:
    """Phases 16 and 17 on one rank: :func:`sharded16`, then phase 17
    under ``"17"``."""
    result = sharded16(rank)
    result["17"] = timed17(rank)
    return result


def timed_spawn16() -> tuple:
    """(:func:`spawn16`'s results for phases 16 and 17, its wall
    seconds)."""
    t0 = time.perf_counter()
    return spawn16(phases16_17), time.perf_counter() - t0


def spawn16(run) -> list:
    """:func:`rank16` running ``run`` on ``RANKS16`` spawned ranks; their
    results in rank order.
    A rank that fails fails the spawn (and the smoke): the others are
    terminated."""
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        mp.spawn(rank16, args=(RANKS16, _free_port(), d, run),
                 nprocs=RANKS16, join=True)
        return [json.loads((Path(d) / f"rank{r}.json").read_text())
                for r in range(RANKS16)]


def probe16(rank: int) -> dict:
    """16.0: which collectives take CUDA tensors under gloo here, and the
    time of a 64 MiB bf16 ``all_reduce`` (CUDA events around it)."""
    import torch
    import torch.distributed as dist
    world = dist.get_world_size()
    dev = torch.device("cuda")
    x = torch.full((8 * world,), float(rank + 1), device=dev)
    ops = {
        "all_reduce f32": lambda: dist.all_reduce(x.clone()),
        "all_reduce bf16": lambda: dist.all_reduce(
            x.to(torch.bfloat16)),
        "all_reduce int64 MAX": lambda: dist.all_reduce(
            x.to(torch.int64), op=dist.ReduceOp.MAX),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world * world, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8, device=dev), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
    }
    out = {}
    for name, fn in ops.items():
        try:
            fn()
            torch.cuda.synchronize()
            dist.barrier()
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"
    big = torch.ones((32 << 20,), dtype=torch.bfloat16, device=dev)
    dist.barrier()
    ms = time_ms(lambda: dist.all_reduce(big), 5)
    return {"ops": out, "all_reduce_64MiB_ms": ms}


def _launches16() -> dict:
    from repro_torch.kernels import segment, strided
    return {f.__name__: f.launches for f in segment.KERNELS
            + segment.DYNAMIC + strided.KERNELS + strided.DYNAMIC}


def _delta(before: dict) -> dict:
    now = _launches16()
    return {k: now[k] - before[k] for k in now}


def _add(total: dict, more: dict) -> None:
    for k, n in more.items():
        total[k] = total.get(k, 0) + n


def _check_block(name: str, got, want, dim: int, shard) -> None:
    """``got`` (a DTensor sharded on ``dim`` over ``shard``) holds this
    rank's block of ``want`` bit for bit."""
    local = got.to_local()
    n = local.shape[dim]
    if not same_bits(local, want.narrow(dim, shard.index() * n, n)):
        raise AssertionError(f"{name}: the sharded result's block differs "
                             f"from the one-process verb's")


def vx16(dev, rank: int) -> dict:
    """16a: the sharded vx verbs against the same verb run unsharded in
    this process, bit for bit, on meshes (4,) and (2, 2), under each
    policy."""
    import torch
    from repro_torch import vx
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P, Sharding, make_mesh
    g = torch.Generator(device=dev).manual_seed(SEED)
    kv = torch.randn((28, 4, 512, 8, 256), generator=g, device=dev,
                     dtype=torch.bfloat16)
    win = torch.randn((512, 4096), generator=g, device=dev,
                      dtype=torch.bfloat16)
    vals = torch.randn((512, STRIDED16_VL), generator=g, device=dev,
                       dtype=torch.bfloat16)
    pool = torch.randn((28, 128, 16, 8, 256), generator=g, device=dev,
                       dtype=torch.bfloat16)
    qpool = torch.randint(-127, 128, pool.shape, generator=g, device=dev,
                          dtype=torch.int8)
    scales = torch.rand((28, 128, 8), generator=g, device=dev) + 0.01
    perm = torch.randperm(128, generator=g, device=dev).to(torch.int32)
    table = torch.full((4, 32), -1, dtype=torch.int32, device=dev)
    table[0] = perm[:32]                                   # full
    table[1, :10] = perm[32:42]                            # partial
    table[3] = perm[64:96]                                 # slot 2 unset
    seg, pg = vx.Segment(n=256, fields=2), vx.Paged(page_size=16, pages=32,
                                                     trail=2)
    out = {"ms": {}, "launches": {}}
    total = {}
    for mshape, axes in (((4,), ("s",)), ((2, 2), ("a", "b"))):
        mesh = make_mesh(mshape, axes)
        seq = vx.Shard(axes=axes, axis=-3, mesh=mesh)
        lane = vx.Shard(axes=axes, axis=-1, mesh=mesh)
        pages = vx.Shard(axes=axes, axis=-4, mesh=mesh)
        kv_d = sharding.place(kv, Sharding(mesh, P(None, None, axes)))
        win_d = sharding.place(win, Sharding(mesh, P(None, axes)))
        pool_d = sharding.place(pool, Sharding(mesh, P(None, axes)))
        qpool_d = sharding.place(qpool, Sharding(mesh, P(None, axes)))
        scl_d = sharding.place(scales, Sharding(mesh, P(None, axes)))
        tag = str(mshape)
        for impl in PHASE16_POLICIES:
            want_k, want_v = vx.transpose(seg, kv, policy=impl)
            before = _launches16()
            k_d, v_d = vx.transpose(seg, kv_d, policy=impl, shard=seq)
            back = vx.transpose(seg, [k_d, v_d], policy=impl, shard=seq)
            _add(total, _delta(before))
            _check_block(f"{tag} {impl} deinterleave k", k_d, want_k, 2, seq)
            _check_block(f"{tag} {impl} deinterleave v", v_d, want_v, 2, seq)
            _check_block(f"{tag} {impl} interleave", back, kv, 2, seq)
            for s, o in REF_STRIDED:
                spec = vx.Strided(n=STRIDED16_N, stride=s, offset=o,
                                  vl=STRIDED16_VL)
                want_g = vx.gather(spec, win, policy=impl)
                want_s = vx.scatter(spec, win, vals, policy=impl)
                before = _launches16()
                got_g = vx.gather(spec, win_d, policy=impl, shard=lane)
                got_s = vx.scatter(spec, win_d, vals, policy=impl,
                                   shard=lane)
                _add(total, _delta(before))
                if not same_bits(got_g, want_g):
                    raise AssertionError(f"{tag} {impl} gather {s, o}")
                _check_block(f"{tag} {impl} scatter {s, o}", got_s, want_s,
                             1, lane)
            for name, fn in (
                    ("deinterleave", lambda: vx.transpose(
                        seg, kv_d, policy=impl, shard=seq)),
                    ("interleave", lambda: vx.transpose(
                        seg, [k_d, v_d], policy=impl, shard=seq)),
                    ("gather s=3", lambda: vx.gather(
                        vx.Strided(n=STRIDED16_N, stride=3, offset=64,
                                   vl=STRIDED16_VL), win_d,
                        policy=impl, shard=lane)),
                    ("scatter s=3", lambda: vx.scatter(
                        vx.Strided(n=STRIDED16_N, stride=3, offset=64,
                                   vl=STRIDED16_VL), win_d,
                        vals, policy=impl, shard=lane))):
                out["ms"][f"{tag} {impl} {name}"] = time_ms(fn, 5)
            # the page gathers are torch ops under every policy: all
            # three on (4,), ref on (2, 2)
            if mshape != (4,) and impl != "ref":
                continue
            for qname, args, local_args in (
                    ("bf16", (pool,), (pool_d,)),
                    ("int8", (qpool,), (qpool_d,))):
                kw = {"scales": scales} if qname == "int8" else {}
                kwd = {"scales": scl_d} if qname == "int8" else {}
                want = vx.gather(pg, *args, table=table, policy=impl, **kw)
                got = vx.gather(pg, *local_args, table=table, policy=impl,
                                shard=pages, **kwd)
                if not same_bits(got, want):
                    raise AssertionError(f"{tag} {impl} page gather {qname}")
                if impl == "ref" and mshape == (4,):
                    out["ms"][f"{tag} page gather {qname}"] = time_ms(
                        lambda: vx.gather(pg, *local_args, table=table,
                                          shard=pages, **kwd), 1)
                    out["ms"][f"{tag} page gather {qname} one process"] = \
                        time_ms(lambda: vx.gather(pg, *args, table=table,
                                                  **kw), 2)
    out["launches"] = total
    out["pool_bytes"] = [sharding.local_nbytes(pool),
                         sharding.local_nbytes(pool_d)]
    return out


def _clone_cache(cache: dict) -> dict:
    return {k: ({b: v.clone() for b, v in x.items()} if k == "blocks"
                else x.clone()) for k, x in cache.items()}


def paged16(dev, rank: int, params, cfg) -> dict:
    """16b: qwen3-0.6b's paged decode with the pool sharded on (4,):
    phase 4's prompts prefilled replicated, the pool placed as a DTensor
    (each rank keeps 32 of the 128 pages), 16 greedy steps with
    ``pool_shard``; rank 0 also runs the replicated step on a copy, and
    the logits and streams must be equal bit for bit."""
    import torch
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P, ShardCtx, Sharding, make_mesh
    from repro_torch.models import decode as dec
    slots, max_len, page_size, steps = 4, 512, 16, 16
    prompts = phase4_prompts(cfg.vocab, slots)
    mesh = make_mesh((RANKS16,), ("s",))
    ctx = ShardCtx(mesh=mesh, data_axes=(), model_axis=None,
                   seq_axes=("s",))
    pool_shard = ctx.vx_pool_shard(-4)
    out = {"launches": {}}
    for impl in ("kernel", "ref"):
        c = dataclasses.replace(cfg, kernel_impl=impl)
        cache = dec.init_paged_cache(c, slots, max_len, page_size,
                                     torch.bfloat16, device=dev)
        for s, p in enumerate(prompts):
            cache = dec.paged_prefill_chunk(
                params, cache, torch.tensor(p[:-1], device=dev), c, slot=s,
                count=len(p) - 1)
        tok0 = torch.tensor([p[-1] for p in prompts], dtype=torch.int32,
                            device=dev)
        want = []
        if rank == 0:
            rep, tok = _clone_cache(cache), tok0
            for _ in range(steps):
                logits, rep = dec.paged_decode_step(params, rep, tok, c)
                want.append(logits)
                tok = torch.argmax(logits.float(), -1).to(torch.int32)
            del rep
        where = Sharding(mesh, P(None, ("s",)))
        placed = {**cache, "blocks": {k: sharding.place(v, where)
                                      for k, v in cache["blocks"].items()}}
        whole = sharding.local_nbytes(cache["blocks"])
        del cache
        torch.cuda.empty_cache()
        tok, ms, before = tok0, [], _launches16()
        for t in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, placed = dec.paged_decode_step(params, placed, tok, c,
                                                   pool_shard=pool_shard)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if rank == 0 and not same_bits(logits, want[t]):
                raise AssertionError(f"16b {impl}: step {t}'s logits differ "
                                     f"from the replicated step's")
            tok = torch.argmax(logits.float(), -1).to(torch.int32)
        _add(out["launches"], _delta(before))
        out[impl] = {"ms": ms, "pool_bytes": [
            whole, sharding.local_nbytes(placed["blocks"])]}
        del placed
        torch.cuda.empty_cache()
    return out


def _noise_layers(dev, cfg, block):
    """Seeded noise for long-context cache leaf (28, 1, LONG_SEQ, 8, 256),
    made a layer at a time on the card; ``block`` (index, count) keeps
    one sequence block of each layer, None the whole."""
    import torch
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    shape = (1, LONG_SEQ, cfg.n_kv_heads, 2 * cfg.hd)
    layers = []
    for _ in range(cfg.n_superblocks):
        lay = torch.randn(shape, generator=g, device=dev,
                          dtype=torch.bfloat16)
        if block is not None:
            n = LONG_SEQ // block[1]
            lay = lay[:, block[0] * n:(block[0] + 1) * n].clone()
        layers.append(lay)
    return torch.stack(layers)


def _long_oracle(dev, cfg, params, tok0, steps: int) -> tuple:
    """The one-process unsharded long-context step (rank 0): logits
    (float32 copies) and the greedy stream over ``steps`` steps; returns
    them with the cache leaf's bytes."""
    import torch
    from repro_torch.dist import sharding
    from repro_torch.serve.engine import ServeConfig, jit_decode_step
    blocks = {"pos0": _noise_layers(dev, cfg, None)}
    cache = {"len": torch.tensor(LONG_LEN, dtype=torch.int32, device=dev),
             "blocks": blocks}
    step = jit_decode_step(cfg, None, ServeConfig(max_len=LONG_SEQ,
                                                  long_context=True),
                           device=dev)
    logits_all, toks, tok = [], [], tok0
    for _ in range(steps):
        logits, cache = step(params, cache, tok)
        tok = torch.argmax(logits.float(), -1).to(torch.int32)
        logits_all.append(logits.float())
        toks.append(int(tok[0]))
    nbytes = sharding.local_nbytes(blocks)
    del cache, blocks
    torch.cuda.empty_cache()
    return logits_all, toks, nbytes


def _long_sharded(dev, cfg, ctx, placed, tok0, steps: int,
                  fuse: bool) -> dict:
    """``steps`` greedy long-context steps on this rank's sequence block
    of the seeded cache, with the step's collectives, B1 launches, ms and
    peak memory."""
    import torch
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P
    from repro_torch.serve.engine import ServeConfig, jit_decode_step
    shard = ctx.vx_seq_shard(-3)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    local = _noise_layers(dev, cfg, (shard.index(), shard.nshards))
    full_shape = (cfg.n_superblocks, 1, LONG_SEQ, cfg.n_kv_heads,
                  2 * cfg.hd)
    cache = {"len": torch.tensor(LONG_LEN, dtype=torch.int32, device=dev),
             "blocks": {"pos0": sharding.from_local(
                 local, ctx.mesh, P(None, None, shard.axes), full_shape)}}
    del local
    step = jit_decode_step(cfg, ctx, ServeConfig(
        max_len=LONG_SEQ, long_context=True, step_fusion=fuse), device=dev)
    tok, logits_all, toks, ms, b1 = tok0, [], [], [], []
    sharding.LOG.reset()
    before = _launches16()
    for _ in range(steps):
        n0 = _launches16()["deinterleave"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = step(placed, cache, tok)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        b1.append(_launches16()["deinterleave"] - n0)
        tok = torch.argmax(logits.float(), -1).to(torch.int32)
        logits_all.append(logits.float())
        toks.append(int(tok[0]))
    _tp_gate("16c", _model_weight_shapes(placed))
    leaf_like = {(1, LONG_SEQ // d, cfg.n_kv_heads, w)
                 for d in (1, shard.nshards) for w in (cfg.hd, 2 * cfg.hd)}
    leaf_like |= {(cfg.n_superblocks,) + s for s in leaf_like}
    shapes = sharding.LOG.shapes()
    out = {"logits": logits_all, "tokens": toks, "ms": ms, "b1": b1,
           "launches": _delta(before),
           "collectives": sharding.LOG.calls,
           "collective_bytes": sharding.LOG.bytes,
           "collective_s": sharding.LOG.seconds,
           "largest": max(math.prod(sh) for sh in shapes),
           "cache_sized": [list(sh) for sh in shapes if sh in leaf_like],
           "peak": torch.cuda.max_memory_allocated(),
           "local_cache_bytes": sharding.local_nbytes(cache["blocks"])}
    del cache
    return out


def _gap(logits, want) -> tuple:
    """(largest |logit gap|, its bound max(0.08, 0.03 |want|max))."""
    gap = max(float((a - b).abs().max()) for a, b in zip(logits, want))
    mx = max(float(b.abs().max()) for b in want)
    return gap, max(0.08, 0.03 * mx)


def longctx16(dev, rank: int, held: dict, cfg) -> dict:
    """16c: the sequence-sharded long-context decode of qwen3-0.6b at full
    width on (2, 2), B = 1, 32 768 cache positions (long_500k cut), 8
    greedy steps fused and per-access in bf16, then fused in float32
    compute; rank 0 runs the one-process unsharded step first in each
    compute dtype.  ``held["params"]`` (the whole bf16 weights) is dropped
    once placed, so a rank keeps only its blocks."""
    import torch
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import serve_param_shardings
    steps = LONG_STEPS16
    ctx = make_ctx(make_test_mesh((2, 2), ("data", "model")),
                   long_context=True)
    tok0 = torch.tensor([SEED + 11], dtype=torch.int32, device=dev)
    out = {"launches": {}}
    params = held.pop("params")
    if rank == 0:
        want, want_tok, out["leaf_bytes"] = _long_oracle(dev, cfg, params,
                                                         tok0, steps)
        # how far one ulp of one weight moves step 0's bf16 logits, beside
        # the sharded step's bf16 gap there
        ln1 = params["blocks"]["pos0"]["ln1"].clone()
        ln1.view(torch.int16)[0, 0] += 1
        nudged = {**params, "blocks": {**params["blocks"], "pos0": {
            **params["blocks"]["pos0"], "ln1": ln1}}}
        out["ulp_gap"] = _gap(_long_oracle(dev, cfg, nudged, tok0, 1)[0],
                              want[:1])[0]
        del nudged, ln1
    placed = sharding.place_tree(params, serve_param_shardings(params, cfg,
                                                               ctx))
    out["weight_bytes"] = [sharding.local_nbytes(params),
                           sharding.local_nbytes(placed)]
    del params
    runs = {fuse: _long_sharded(dev, cfg, ctx, placed, tok0, steps, fuse)
            for fuse in (True, False)}
    del placed
    fused, per = runs[True], runs[False]
    for t in range(steps):
        if not same_bits(fused["logits"][t], per["logits"][t]):
            raise AssertionError(f"16c: fused and per-access logits differ "
                                 f"at step {t}")
    for r in (fused, per):
        _add(out["launches"], r["launches"])
        if r["cache_sized"]:
            raise AssertionError(f"16c: a collective on a cache-sized "
                                 f"operand: {r['cache_sized']}")
    if 2 * sum(fused["b1"]) > sum(per["b1"]) or min(fused["b1"]) < 1:
        raise AssertionError(f"16c: the launch gate failed: fused B1 "
                             f"{fused['b1']}, per-access {per['b1']}")
    # float32 compute: the same cache, gated at the reference's tolerance
    # (tests/_dist_checks.py:212-214); half the steps, its weights' gathers
    # moving twice the bytes
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    torch.cuda.empty_cache()
    params32 = init_params(cfg32, SEED, device=dev)
    if rank == 0:
        want32, want32_tok, _ = _long_oracle(dev, cfg32, params32, tok0,
                                             F32_STEPS16)
    placed32 = sharding.place_tree(params32, serve_param_shardings(
        params32, cfg32, ctx))
    del params32
    f32 = _long_sharded(dev, cfg32, ctx, placed32, tok0, F32_STEPS16, True)
    del placed32
    _add(out["launches"], f32["launches"])
    if rank == 0:
        out["gap"], out["tol"] = _gap(fused["logits"], want)
        out["gap0"] = _gap(fused["logits"][:1], want[:1])[0]
        if fused["tokens"] != want_tok:
            t = next(i for i, (a, b) in enumerate(zip(fused["tokens"],
                                                      want_tok)) if a != b)
            top = torch.topk(want[t][0], 2).values
            raise AssertionError(
                f"16c bf16: sharded stream {fused['tokens']} vs one process "
                f"{want_tok}; first flip at step {t}: the one process's "
                f"top-2 margin {float(top[0] - top[1]):.6f}, the logit gap "
                f"there {_gap(fused['logits'][t:t + 1], want[t:t + 1])[0]}")
        out["gap32"] = _gap(f32["logits"], want32)[0]
        # the reference's assert_allclose(rtol=3e-3, atol=3e-3), elementwise
        out["excess32"] = max(float(((a - b).abs() - 3e-3 * (1 + b.abs()))
                                    .max()) for a, b in zip(f32["logits"],
                                                            want32))
        if out["excess32"] > 0 or f32["tokens"] != want32_tok:
            raise AssertionError(
                f"16c float32: sharded vs one process: gap {out['gap32']} "
                f"beyond rtol = atol = 3e-3 by {out['excess32']}, streams "
                f"{f32['tokens']} vs {want32_tok}")
    for r in (fused, per, f32):
        del r["logits"]
    out["fused"], out["per"], out["f32"] = fused, per, f32
    return out


def moe16(dev, rank: int) -> dict:
    """16d: qwen3-moe-30b-a3b's MoE layer at its published widths on
    (2, 2) ("data", "model"), 64 experts per model shard, x (4, 512,
    2048) bf16; rank 0 runs the one-process layer."""
    import torch
    from repro_torch.configs.qwen3_moe_30b import config
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P, ShardCtx, Sharding
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    cfg = config()
    spec = cfg.moe
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    params = moe.init_moe(cfg.d_model, spec, g, torch.bfloat16, dev)
    x = torch.randn((4, 512, cfg.d_model), generator=g, device=dev,
                    dtype=torch.bfloat16)
    mesh = make_test_mesh((2, 2), ("data", "model"))
    ctx = ShardCtx(mesh=mesh, data_axes=("data",), model_axis="model")
    out = {}
    if rank == 0:
        want, want_aux = moe.moe_layer(params, x, spec, None)
        out["one_ms"] = time_ms(lambda: moe.moe_layer(params, x, spec,
                                                      None), 3)
    placed = {k: v if k == "router" else sharding.place(
        v, Sharding(mesh, P("model"))) for k, v in params.items()}
    out["expert_bytes"] = [sharding.local_nbytes(params),
                           sharding.local_nbytes(placed)]
    y, aux = moe.moe_layer(placed, x, spec, ctx)
    out["ms"] = time_ms(lambda: moe.moe_layer(placed, x, spec, ctx), 3)
    # this rank's units and the shard's capacity: the drops
    m_sz = ctx.model_size
    my = sharding.axis_index(mesh, "model")
    xl = sharding.local_block(x, mesh, P(("data",))).reshape(-1,
                                                             cfg.d_model)
    probs = torch.softmax((xl @ params["router"].to(xl.dtype)).float(), -1)
    topi = moe._top_k(probs, spec.top_k)[1]
    e_loc = spec.n_experts // m_sz
    mine = int(((topi >= my * e_loc) & (topi < (my + 1) * e_loc)).sum())
    cap = moe._capacity(xl.shape[0], spec.top_k, m_sz, spec.capacity_slack)
    out["units"], out["cap"], out["dropped"] = mine, cap, max(0, mine - cap)
    out["slack"] = spec.capacity_slack
    most = int(sharding.pmax(torch.tensor([float(out["dropped"])],
                                          device=dev),
                             mesh, ("data", "model"))[0])
    if most:
        raise AssertionError(f"16d: a shard dropped {most} units at "
                             f"capacity_slack {spec.capacity_slack}; the "
                             f"one-process layer drops none")
    full = sharding.full_tensor(y)
    if rank == 0:
        err = float((full.float() - want.float()).abs().max())
        mx = float(want.float().abs().max())
        out.update(err=err, max=mx, aux=float(aux), want_aux=float(want_aux))
        if err > 1e-2 * max(1.0, mx) or \
                abs(float(aux) - float(want_aux)) > 0.1 * abs(
                    float(want_aux)):
            raise AssertionError(f"16d: y error {err} (|y|max {mx}), aux "
                                 f"{float(aux)} vs {float(want_aux)}")
    return out


# ---------------------------------------------------------------------------
# Phase 17: sharded training (in phase 16's spawn)
# ---------------------------------------------------------------------------

#: 15c's cut of train_4k (global batch 256 x 4096 tokens): 4 x 512.
TRAIN17_BATCH, TRAIN17_SEQ = 4, 512
#: The float32 arm's depth (qwen3-0.6b has 28 layers).
F32_LAYERS17 = 28
#: The batch-sharded decode: prompt tokens, greedy steps, cache length.
SERVE17_PROMPT, SERVE17_STEPS, SERVE17_MAX_LEN = 64, 4, 512


def probe17(rank: int) -> dict:
    """17.0: GPipe's hand-off on CUDA tensors under gloo:
    ``dist.sharding.ppermute`` (``all_to_all_single`` with every split
    empty but one peer's; ``gloo`` refuses point-to-point sends of CUDA
    tensors here, ``tools/gloo_p2p_probe.py``), checked and a 32 MiB one
    timed."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import make_mesh
    world = dist.get_world_size()
    dev = torch.device("cuda")
    x = torch.full((1024,), float(rank + 1), device=dev)
    src = (rank - 1) % world
    mesh = make_mesh((world,), ("pod",))
    got = sharding.ppermute(x, mesh, "pod", 1)
    torch.cuda.synchronize()
    if float(got[0]) != src + 1:
        raise AssertionError(f"17.0: ppermute gave {float(got[0])} on rank "
                             f"{rank}, want {src + 1}")
    big = torch.ones((16 << 20,), dtype=torch.bfloat16, device=dev)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        sharding.ppermute(big, mesh, "pod", 1)
    torch.cuda.synchronize()
    return {"ppermute_32MiB_ms": (time.perf_counter() - t0) / 3 * 1e3}


def _model_weight_shapes(params) -> set:
    """The shapes a gather of a model-axis weight would move: each
    ``DTensor`` leaf placed on the model axis, whole and a rank's block,
    a superblock's leaf without its stacked dim (a gather moves a
    superblock at a time)."""
    from repro_torch.dist import sharding
    out = set()
    for path, leaf in sharding._leaves_with_path(params):
        if not sharding.is_dtensor(leaf):
            continue
        spec = sharding._norm(sharding.spec_of(leaf), leaf.ndim)
        dims = [d for d, e in enumerate(spec)
                if "model" in sharding._names(e)]
        if not dims:
            continue
        blk = list(leaf.shape)
        blk[dims[0]] //= sharding.axis_size(leaf.device_mesh, "model")
        for sh in (tuple(leaf.shape), tuple(blk)):
            out.add(sh[1:] if path[0] == "blocks" else sh)
    return out


def _tp_gate(tag: str, weights: set) -> None:
    """Tensor parallelism moves activations only: no collective since
    ``LOG`` was reset has a model-axis weight's shape (``weights``), and
    no packed gather rebuilt a weight."""
    from repro_torch.dist import sharding
    hit = sorted(str(s) for s in sharding.LOG.shapes() & weights)
    if hit or sharding.LOG.leaves:
        raise AssertionError(f"{tag}: a model-axis weight gathered: shapes "
                             f"{hit}, packed gathers "
                             f"{dict(sharding.LOG.leaves)}")


def _collectives17() -> dict:
    from repro_torch.dist import sharding
    log = sharding.LOG
    ops: dict = {}
    for (op, shape, _), n in log.counts.items():
        ops[op] = ops.get(op, 0) + n
    return {"calls": log.calls, "bytes": log.bytes, "s": log.seconds,
            "ops": ops}


def _step17(step, state, batch) -> tuple:
    """One train step: (state, metrics as floats, host ms, collectives)."""
    import torch
    from repro_torch.dist import sharding
    sharding.LOG.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return state, {k: float(v) for k, v in m.items()}, ms, _collectives17()


def train17(dev, rank: int) -> dict:
    """17a: ZeRO-1 sharded training of qwen3-0.6b at full width and depth
    on (2, 2) = (data, model), 4 x 512 seeded tokens (15c's cut), under
    ``ref`` (training differentiates no kernel): 2 bf16-compute steps
    gated as the reference's ``check_sharded_train_step`` gates its own
    (finite losses, the second below the first + 0.5, ``wq`` a DTensor
    of which a rank holds 1/2); then a float32-compute step against rank
    0's one-process step on the same state and batch.  Returns the bf16
    state's params for 17c."""
    import torch
    from repro_torch.configs.base import train_batch
    from repro_torch.configs.qwen3_0_6b import config
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.train import state as tstate
    from repro_torch.train import step as tstep
    cfg = dataclasses.replace(config(), kernel_impl="ref")
    ctx = make_ctx(make_test_mesh((2, 2), ("data", "model")))
    batch = train_batch(cfg, TRAIN17_SEQ, TRAIN17_BATCH, specs=False,
                        generator=torch.Generator(dev).manual_seed(SEED + 17),
                        device=dev)
    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, SEED, device=dev)
    whole = sharding.local_nbytes(params)
    state = tstate.init_placed_state(params, ctx)
    del params
    torch.cuda.empty_cache()
    out["param_bytes"] = [whole, sharding.local_nbytes(state["params"])]
    out["moment_bytes"] = [2 * whole, sharding.local_nbytes(
        {"m": state["opt"]["m"], "v": state["opt"]["v"]})]
    step = tstep.make_train_step(cfg, tstep.TrainConfig(), ctx)
    weights = _model_weight_shapes(state["params"])
    out["bf16"] = []
    for _ in range(2):
        state, m, ms, coll = _step17(step, state, batch)
        _tp_gate("17a", weights)
        out["bf16"].append({"loss": m["loss"], "grad_norm": m["grad_norm"],
                            "ms": ms, "collectives": coll})
    # 18: a third bf16 step under bundle_from_trace (its FLOPs, bytes and
    # collective bytes; the step's time is the two measured ones')
    from repro_torch.roofline.analysis import bundle_from_trace
    torch.cuda.synchronize()
    (state, _), b = bundle_from_trace(step, state, batch)
    out["trace"] = {"flops": b.flops, "bytes": b.bytes_accessed,
                    "coll_bytes": b.coll_bytes}
    l1, l2 = (s["loss"] for s in out["bf16"])
    wq = state["params"]["blocks"]["pos0"]["attn"]["wq"]
    if not (math.isfinite(l1) and math.isfinite(l2) and l2 < l1 + 0.5) or \
            not sharding.is_dtensor(wq) or \
            2 * wq.to_local().shape[-1] != wq.shape[-1]:
        raise AssertionError(f"17a bf16: losses {l1}, {l2}; wq "
                             f"{type(wq).__name__}")
    out["peak"] = torch.cuda.max_memory_allocated()
    placed = state["params"]
    del state, step
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                n_layers=F32_LAYERS17)
    params = init_params(cfg32, SEED, device=dev)
    if rank == 0:
        one = tstate.init_train_state(sharding.tree_map(torch.clone, params))
        one, want, ms1, _ = _step17(tstep.make_train_step(
            cfg32, tstep.TrainConfig(), None), one, batch)
        out["f32_one_ms"] = ms1
    state = tstate.init_placed_state(params, ctx)
    del params
    torch.cuda.empty_cache()
    state, m, ms, coll = _step17(tstep.make_train_step(
        cfg32, tstep.TrainConfig(), ctx), state, batch)
    _tp_gate("17a float32", _model_weight_shapes(state["params"]))
    out["f32"] = {"loss": m["loss"], "grad_norm": m["grad_norm"], "ms": ms,
                  "collectives": coll, "lr": m["lr"]}
    # AdamW moves a weight by about lr * sign(g): a gradient entry near 0
    # whose sign the summation order flips moves it by up to 2 lr; past
    # 0.1 lr is such a flip (1e-3 lr is the params' float32 ulp here)
    gap, far, ulp, n = 0.0, 0, 0, 0
    for path, leaf in sharding._leaves_with_path(state["params"]):
        whole_leaf = sharding.full_tensor(leaf)
        if rank == 0:
            ref = one["params"]
            for k in path:
                ref = ref[k]
            d = (whole_leaf - ref).abs()
            gap = max(gap, float(d.max()))
            far += int((d > 0.1 * m["lr"]).sum())
            ulp += int((d > 1e-3 * m["lr"]).sum())
            n += d.numel()
        del whole_leaf
    if rank == 0:
        out["f32"].update(want=want, gap=gap, far=far / n, ulp=ulp / n)
        bad = (abs(m["loss"] - want["loss"]) > 1e-4 * abs(want["loss"])
               or abs(m["grad_norm"] - want["grad_norm"])
               > 1e-3 * want["grad_norm"]
               or gap > 2 * m["lr"] or far > 1e-3 * n)
        del one
        if bad:
            raise AssertionError(f"17a float32: sharded {m} vs one process "
                                 f"{want}; params gap {gap} (lr "
                                 f"{m['lr']}), {far} of {n} beyond "
                                 f"0.1 lr")
    del state
    torch.cuda.empty_cache()
    return out, placed


def pipeline17(dev, rank: int) -> dict:
    """17b: GPipe over the pod axis of (2, 1, 2) = (pod, data, model):
    qwen3-0.6b at full width and depth in two stages of 14 superblocks,
    2 microbatches of 17a's batch, bf16 compute; the loss within the
    reference's rtol 2e-3 of rank 0's one-process ``loss_fn``, the
    gradients through the hand-offs finite and nonzero on every rank,
    their global norm (the stages' shares added) beside the one-process
    one."""
    import torch
    from repro_torch.configs.base import train_batch
    from repro_torch.configs.qwen3_0_6b import config
    from repro_torch.dist import sharding
    from repro_torch.dist.pipeline_par import (PipelineConfig,
                                               pipeline_loss_fn,
                                               reduce_stage_grads)
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train import step as tstep
    cfg = dataclasses.replace(config(), kernel_impl="ref")
    ctx = make_ctx(make_mesh((2, 1, 2), ("pod", "data", "model")))
    pcfg = PipelineConfig(axis="pod", n_microbatches=2)
    batch = train_batch(cfg, TRAIN17_SEQ, TRAIN17_BATCH, specs=False,
                        generator=torch.Generator(dev).manual_seed(SEED + 17),
                        device=dev)
    torch.cuda.empty_cache()
    params = init_params(cfg, SEED, device=dev)
    out = {}
    if rank == 0:
        loss1, _, g1 = tstep._loss_and_grads(params, batch, cfg, None)
        out["one"] = {"loss": float(loss1), "gnorm": float(global_norm(g1))}
        del g1
        torch.cuda.empty_cache()
    sharding.LOG.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, grads = tstep._grads_of(
        lambda p: pipeline_loss_fn(p, batch, cfg, ctx, pcfg), params)
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) * 1e3
    out["collectives"] = _collectives17()
    share = float(global_norm(grads))
    whole = reduce_stage_grads(grads, ctx, pcfg)
    del grads
    out.update(loss=float(loss), share=share,
               gnorm=float(global_norm(whole)))
    del whole, params
    torch.cuda.empty_cache()
    if not (math.isfinite(share) and share > 0
            and math.isfinite(out["gnorm"])):
        raise AssertionError(f"17b: rank {rank}'s stage gradient norm "
                             f"{share}, whole {out['gnorm']}")
    if rank == 0 and abs(out["loss"] - out["one"]["loss"]) > \
            2e-3 * abs(out["one"]["loss"]):
        raise AssertionError(f"17b: pipelined loss {out['loss']} vs one "
                             f"process {out['one']['loss']} (rtol 2e-3)")
    return out


def elastic17(dev, rank: int, placed) -> dict:
    """17c: 17a's trained params (placed on (2, 2), model axis 2) saved
    (their logical arrays, written by rank 0 under ``build/``) and
    restored onto (1, 4) (model axis 4) with ``restore_elastic``: every
    leaf bit for bit, ``wq`` a rank's quarter."""
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.ft import elastic
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_ctx
    d = ROOT / "build" / "ckpt17"
    if rank == 0 and d.exists():
        shutil.rmtree(d)
    dist.barrier()
    mgr = CheckpointManager(str(d))
    t0 = time.perf_counter()
    mgr.save(1, placed, blocking=True)
    dist.barrier()
    out = {"save_s": time.perf_counter() - t0}
    ctx4 = make_ctx(make_mesh((1, 4), ("data", "model")))
    t0 = time.perf_counter()
    restored, _ = elastic.restore_elastic(mgr, placed, ctx4)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    out["disk_bytes"] = sum(f.stat().st_size for f in d.rglob("*")
                            if f.is_file())
    n = 0
    for (path, a), (_, b) in zip(sharding._leaves_with_path(placed),
                                 sharding._leaves_with_path(restored)):
        if not same_bits(sharding.full_tensor(a), sharding.full_tensor(b)):
            raise AssertionError(f"17c: leaf {'/'.join(path)} differs "
                                 f"after the restore onto (1, 4)")
        n += 1
    wq = restored["blocks"]["pos0"]["attn"]["wq"]
    if 4 * wq.to_local().shape[-1] != wq.shape[-1]:
        raise AssertionError(f"17c: wq's block {tuple(wq.to_local().shape)}"
                             f" of {tuple(wq.shape)} on model axis 4")
    out.update(leaves=n, bytes=[sharding.local_nbytes(placed),
                                sharding.local_nbytes(restored)])
    del restored
    dist.barrier()
    if rank == 0:
        shutil.rmtree(d)
    return out


def _greedy17(dev, cfg, ctx, params, toks) -> tuple:
    """``jit_prefill`` of ``toks`` and ``SERVE17_STEPS`` greedy
    ``jit_decode_step`` s on ``ctx`` (None: one process), the cache in
    the compute dtype: (each step's logits, whole, float32; the streams)."""
    import torch
    from repro_torch.dist import sharding
    from repro_torch.models import decode as dec
    from repro_torch.serve.engine import (ServeConfig, jit_decode_step,
                                          jit_prefill)
    logits, states = jit_prefill(cfg, ctx, device=dev)(params,
                                                       {"tokens": toks})
    whole = {k: sharding.full_tensor(v) for k, v in states.items()}
    del states
    cache = dec.cache_from_prefill(cfg, whole, SERVE17_PROMPT,
                                   SERVE17_MAX_LEN, cfg.cdtype)
    step = jit_decode_step(cfg, ctx, ServeConfig(max_len=SERVE17_MAX_LEN),
                           device=dev)
    tok = torch.argmax(sharding.full_tensor(logits)[:, -1].float(), -1).int()
    logs, streams = [], []
    for _ in range(SERVE17_STEPS):
        lg, cache = step(params, cache, tok)
        lg = sharding.full_tensor(lg).float()
        logs.append(lg)
        tok = torch.argmax(lg, -1).int()
        streams.append([int(x) for x in tok])
    return logs, streams


def serve17_f32(dev, rank: int) -> dict:
    """17d's float32 arm (tensor parallelism sums bf16 parts in the mesh
    prefill, so a bf16 greedy stream may flip on a near-tie): the same
    prompts and steps in float32 compute under ``kernel``, the mesh's
    streams gated equal to rank 0's one-process streams, the logit gap
    beside the reference's rtol = atol = 3e-3."""
    import torch
    from repro_torch.configs.qwen3_0_6b import config
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import serve_param_shardings
    cfg = dataclasses.replace(config(), kernel_impl="kernel",
                              compute_dtype="float32")
    ctx = make_ctx(make_test_mesh((2, 2), ("data", "model")))
    g = torch.Generator(dev).manual_seed(SEED + 19)
    toks = torch.randint(0, cfg.vocab, (4, SERVE17_PROMPT), generator=g,
                         device=dev, dtype=torch.int32)
    torch.cuda.empty_cache()
    params = init_params(cfg, SEED, device=dev)
    out = {}
    if rank == 0:
        want, want_streams = _greedy17(dev, cfg, None, params, toks)
    placed = sharding.place_tree(params, serve_param_shardings(params, cfg,
                                                               ctx))
    del params
    torch.cuda.empty_cache()
    got, streams = _greedy17(dev, cfg, ctx, placed, toks)
    if rank == 0:
        out["gap32"] = _gap(got, want)[0]
        out["excess32"] = max(float(((a - b).abs() - 3e-3 * (1 + b.abs()))
                                    .max()) for a, b in zip(got, want))
        out["streams_equal"] = streams == want_streams
        if streams != want_streams or out["excess32"] > 0:
            raise AssertionError(f"17d float32: batch-sharded streams "
                                 f"{streams} vs one process {want_streams}; "
                                 f"logit gap {out['gap32']} beyond rtol = "
                                 f"atol = 3e-3 by {out['excess32']}")
    del placed
    torch.cuda.empty_cache()
    return out


def serve17(dev, rank: int) -> dict:
    """17d: the batch-sharded decode of qwen3-0.6b at full width on (2, 2)
    = (data, model): ``jit_prefill`` under the mesh (each rank 2 of the
    4 seeded 64-token prompts), then 4 greedy batch-sharded
    ``jit_decode_step`` s (a rank's KV heads 4 of 8, attended
    head-parallel) under ``kernel`` and, from the same cache, ``ref``:
    logits bit for bit, one B1 launch a step on every rank under
    ``kernel`` (its cache block, the fused split), none under ``ref``;
    B1 on a rank's cache block against its plain version bit for bit;
    streams equal to rank 0's one-process dense steps, or a flip on a
    near-tie (the one process's top-2 margin within the bf16 tolerance;
    the tensor-parallel prefill sums bf16 parts), whose streams
    :func:`serve17_f32` then gates in float32."""
    import torch
    from repro_torch.configs.qwen3_0_6b import config
    from repro_torch.dist import sharding
    from repro_torch.kernels import segment
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import decode as dec
    from repro_torch.models.transformer import cast_params, init_params
    from repro_torch.serve.engine import (ServeConfig, jit_decode_step,
                                          jit_prefill, serve_param_shardings)
    cfg = dataclasses.replace(config(), kernel_impl="kernel")
    ctx = make_ctx(make_test_mesh((2, 2), ("data", "model")))
    g = torch.Generator(dev).manual_seed(SEED + 19)
    toks = torch.randint(0, cfg.vocab, (4, SERVE17_PROMPT), generator=g,
                         device=dev, dtype=torch.int32)
    torch.cuda.empty_cache()
    params = cast_params(init_params(cfg, SEED, device=dev), cfg)
    out = {"launches": {}}
    scfg = ServeConfig(max_len=SERVE17_MAX_LEN)
    if rank == 0:
        logits, states = jit_prefill(cfg, None, device=dev)(
            params, {"tokens": toks})
        cache = dec.cache_from_prefill(cfg, states, SERVE17_PROMPT,
                                       SERVE17_MAX_LEN, torch.bfloat16)
        step = jit_decode_step(cfg, None, scfg, device=dev)
        tok, want = torch.argmax(logits[:, -1].float(), -1).int(), []
        for _ in range(SERVE17_STEPS):
            logits, cache = step(params, cache, tok)
            want.append(logits.float())
            tok = torch.argmax(logits.float(), -1).int()
        del cache, states
    placed = sharding.place_tree(params, serve_param_shardings(params, cfg,
                                                               ctx))
    del params
    torch.cuda.empty_cache()
    before = _launches16()
    sharding.LOG.reset()
    logits, states = jit_prefill(cfg, ctx, device=dev)(placed,
                                                       {"tokens": toks})
    _tp_gate("17d prefill", _model_weight_shapes(placed))
    out["prefill_collectives"] = _collectives17()
    _add(out["launches"], _delta(before))
    whole = {k: sharding.full_tensor(v) for k, v in states.items()}
    del states
    cache0 = dec.cache_from_prefill(cfg, whole, SERVE17_PROMPT,
                                    SERVE17_MAX_LEN, torch.bfloat16)
    del whole
    tok0 = torch.argmax(sharding.full_tensor(logits)[:, -1].float(),
                        -1).int()
    runs = {}
    for impl in ("kernel", "ref"):
        c = dataclasses.replace(cfg, kernel_impl=impl)
        cache = {"len": cache0["len"].clone(), "blocks": {
            k: v.clone() for k, v in cache0["blocks"].items()}}
        step = jit_decode_step(c, ctx, scfg, device=dev)
        tok, logs, ms, b1 = tok0, [], [], []
        sharding.LOG.reset()
        before = _launches16()
        for _ in range(SERVE17_STEPS):
            n0 = _launches16()["deinterleave"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = step(placed, cache, tok)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            b1.append(_launches16()["deinterleave"] - n0)
            lg = sharding.full_tensor(lg)
            logs.append(lg)
            tok = torch.argmax(lg.float(), -1).int()
        _tp_gate(f"17d [{impl}]", _model_weight_shapes(placed))
        delta = _delta(before)
        if impl == "kernel":
            _add(out["launches"], delta)
        runs[impl] = {"logits": logs, "ms": ms, "b1": b1,
                      "collectives": _collectives17(),
                      "spec": str(sharding.spec_of(cache["blocks"]["pos0"])),
                      "cache": cache}
    k, r = runs["kernel"], runs["ref"]
    for t in range(SERVE17_STEPS):
        if not same_bits(k["logits"][t], r["logits"][t]):
            raise AssertionError(f"17d: kernel and ref logits differ at "
                                 f"step {t}")
    if k["b1"] != [1] * SERVE17_STEPS or any(r["b1"]):
        raise AssertionError(f"17d: B1 launches per step kernel {k['b1']}, "
                             f"ref {r['b1']}")
    block = k["cache"]["blocks"]["pos0"].to_local()
    got = segment.deinterleave(block, 2)
    want_b1 = segment.deinterleave_plain(block, 2)
    if not all(same_bits(a, b) for a, b in zip(got, want_b1)):
        raise AssertionError("17d: B1 on a rank's cache block != plain")
    out["block"] = list(block.shape)
    out["cache_bytes"] = [sharding.local_nbytes(cache0["blocks"]),
                          sharding.local_nbytes(k["cache"]["blocks"])]
    if rank == 0:
        toks_k = [[int(x) for x in torch.argmax(lg.float(), -1)]
                  for lg in k["logits"]]
        toks_1 = [[int(x) for x in torch.argmax(lg, -1)] for lg in want]
        out["gap"], out["tol"] = _gap(k["logits"], want)
        out["flip"] = None
        if toks_k != toks_1:
            # tensor parallelism's prefill sums bf16 parts: a flip on a
            # near-tie (the one process's top-2 margin within the bf16
            # tolerance) moves the streams' gate to the float32 arm
            t, b = next((t, b) for t in range(SERVE17_STEPS)
                        for b in range(len(toks_1[t]))
                        if toks_k[t][b] != toks_1[t][b])
            top = torch.topk(want[t][b].float(), 2).values
            margin = float(top[0] - top[1])
            out["flip"] = {"step": t, "row": b, "margin": margin,
                           "gap": float((k["logits"][t][b].float()
                                         - want[t][b].float()).abs().max())}
            if margin > out["tol"]:
                raise AssertionError(f"17d: batch-sharded stream {toks_k} "
                                     f"vs one process {toks_1}: the flip "
                                     f"{out['flip']} is no near-tie")
    for impl, run in runs.items():
        out[impl] = {"ms": run["ms"], "b1": run["b1"], "spec": run["spec"],
                     "collectives": run["collectives"]}
    del runs, k, r, cache0, placed
    torch.cuda.empty_cache()
    return out


#: 17e's cut of qwen3-moe-30b-a3b (48 layers at published widths) and of
#: train_4k's batch: what fits on the card the 4 ranks share.
MOE17_LAYERS, MOE17_BATCH, MOE17_SEQ = 1, 4, 256
#: 17f: whisper-tiny's batch-sharded decode: meshes and the arm each takes
#: (6 heads split over a model axis of 2, not of 4: the sequence then),
#: greedy steps, float32 steps.
WHISPER17_MESHES = (((2, 2), "heads"), ((1, 4), "sequence"))
WHISPER17_STEPS, WHISPER17_F32_STEPS = 8, 4
#: The file (named in this environment variable) that tells the ranks the
#: main process's card work is done: 17e waits for it (:class:`Background`).
IDLE_ENV = "CHIP_SMOKE_MAIN_IDLE"


def _wait_main_idle(timeout: float = 900.0) -> float:
    """Seconds spent waiting for the main process to leave the card (the
    file ``IDLE_ENV`` names), 0 when no main process runs beside."""
    import os
    path = os.environ.get(IDLE_ENV)
    if not path:
        return 0.0
    t0 = time.perf_counter()
    while not Path(path).exists():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"17e: the main process did not leave the "
                                 f"card within {timeout:.0f} s")
        time.sleep(1.0)
    return time.perf_counter() - t0


def _host_flush() -> int:
    """Returns this process's cached pinned host bytes (``gloo`` stages
    every CUDA collective through pinned blocks, cached per power-of-two
    size), then gives the cached ones back to the system."""
    import torch
    stats = torch.cuda.memory.host_memory_stats()
    held = next((v for k, v in stats.items()
                 if k.startswith("allocated_bytes") and k.endswith("current")),
                -1)
    flush = (getattr(getattr(torch, "accelerator", None), "empty_host_cache",
                     None) or getattr(torch._C, "_host_emptyCache", None))
    if flush is not None:
        flush()
    return held


def _max_rss() -> int:
    """This process's peak resident host memory, bytes."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _bank_bytes(params) -> tuple:
    """(whole, this rank's) bytes of the MoE expert banks of a placed
    params tree."""
    from repro_torch.dist import sharding
    whole = held = 0
    for path, leaf in sharding._leaves_with_path(params):
        if sharding.is_expert_bank("/".join(path), leaf.ndim, 1):
            whole += leaf.numel() * leaf.element_size()
            held += sharding.local_nbytes(leaf)
    return whole, held


def moe17(dev, rank: int) -> dict:
    """17e: expert-parallel ZeRO-1 training of qwen3-moe-30b-a3b at its
    published widths (d 2048, 128 experts top-8, d_ff 768, vocab 151936),
    ``MOE17_LAYERS`` of 48 layers, on (2, 2) = (data, model) under
    ``ref``: a rank keeps its 64 experts of each bank resident (never
    gathered).  Waits for the main process to leave the card.  Rank 0
    first runs the one-process float32 step with the MoE layers as
    ``models/moe.expert_parallel_plain`` (2, 2) computes them (the
    function the mesh computes) and keeps its result on the host; then
    one bf16-compute step and one float32-compute step on the mesh, each
    from the same seeded state, the float32 one against rank 0's with
    17a's tolerances."""
    from unittest import mock
    import torch
    from repro_torch.configs.base import train_batch
    from repro_torch.configs.qwen3_moe_30b import config
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import moe, transformer
    from repro_torch.models.transformer import init_params
    from repro_torch.train import state as tstate
    from repro_torch.train import step as tstep
    out = {"waited_s": _wait_main_idle(), "pinned": [_host_flush()],
           "rss": [_max_rss()]}
    cfg = dataclasses.replace(config(), kernel_impl="ref",
                              n_layers=MOE17_LAYERS)
    ctx = make_test_mesh((2, 2), ("data", "model"))
    ctx = make_ctx(ctx)
    batch = train_batch(cfg, MOE17_SEQ, MOE17_BATCH, specs=False,
                        generator=torch.Generator(dev).manual_seed(SEED + 23),
                        device=dev)
    banks = set()
    E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
    for e in (E, E // 2):
        for sh in ((e, d, f), (e, f, d)):
            banks |= {sh, (cfg.n_superblocks,) + sh}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    torch.cuda.empty_cache()
    if rank == 0:
        one = tstate.init_train_state(init_params(cfg32, SEED, device=dev))
        plain = (lambda p, x, spec, c:
                 moe.expert_parallel_plain(p, x, spec, 2, 2))
        with mock.patch.object(transformer, "moe_layer", plain):
            one, want, ms1, _ = _step17(tstep.make_train_step(
                cfg32, tstep.TrainConfig(), None), one, batch)
        out["one_ms"] = ms1
        want_params = {"/".join(p): x for p, x in
                       sharding._leaves_with_path(one["params"])}
        del one
        torch.cuda.empty_cache()
    for tag, c in (("bf16", cfg), ("f32", cfg32)):
        torch.cuda.reset_peak_memory_stats()
        params = init_params(c, SEED, device=dev)
        state = tstate.init_placed_state(params, ctx)
        del params
        torch.cuda.empty_cache()
        state, m, ms, coll = _step17(tstep.make_train_step(
            c, tstep.TrainConfig(), ctx), state, batch)
        _tp_gate(f"17e [{tag}]", _model_weight_shapes(state["params"]))
        seen = sorted(str(s) for s in sharding.LOG.shapes() & banks)
        whole, held = _bank_bytes(state["params"])
        r = {"loss": m["loss"], "grad_norm": m["grad_norm"], "lr": m["lr"],
             "aux": m.get("aux", float("nan")), "ms": ms,
             "collectives": coll, "banks_in_log": seen,
             "bank_bytes": [whole, held],
             "params_bytes": sharding.local_nbytes(state["params"]),
             "peak": torch.cuda.max_memory_allocated()}
        if seen or 2 * held != whole or not (
                math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"17e [{tag}]: loss {m['loss']}, grad norm "
                                 f"{m['grad_norm']}; expert-bank shapes in "
                                 f"the collectives {seen}; bank bytes held "
                                 f"{held} of {whole}")
        if tag == "f32":
            gap, far, n = 0.0, 0, 0
            for path, leaf in sharding._leaves_with_path(state["params"]):
                whole_leaf = sharding.full_tensor(leaf)
                if rank == 0:
                    dd = (whole_leaf - want_params["/".join(path)]).abs()
                    gap = max(gap, float(dd.max()))
                    far += int((dd > 0.1 * m["lr"]).sum())
                    n += dd.numel()
                del whole_leaf
            if rank == 0:
                r.update(want=want, gap=gap, far=far / n)
                if (abs(m["loss"] - want["loss"]) > 1e-4 * abs(want["loss"])
                        or abs(m["grad_norm"] - want["grad_norm"])
                        > 1e-3 * want["grad_norm"]
                        or gap > 2 * m["lr"] or far > 1e-3 * n):
                    raise AssertionError(
                        f"17e float32: mesh {m} vs one process {want}; "
                        f"params gap {gap} (lr {m['lr']}), {far} of {n} "
                        f"beyond 0.1 lr")
        out[tag] = r
        del state
        torch.cuda.empty_cache()
        out["pinned"].append(_host_flush())
        out["rss"].append(_max_rss())
    return out


def whisper17(dev, rank: int) -> dict:
    """17f: whisper-tiny uncut (bf16 compute), 4 seeded frame stubs and
    prompts of 32 prefilled in one process on every rank, then
    ``WHISPER17_STEPS`` greedy batch-sharded ``jit_decode_step`` s on
    (2, 2) (6 heads over the model axis: head-parallel self- and
    cross-attention) and on (1, 4) (the ring's and ``enc_kv``'s
    sequence over it: the distributed softmax), under ``kernel`` and
    ``ref`` from the same cache: logits bit for bit, (B1, B2) launches a
    step on each rank (``qkv_project``'s split and re-pack of its batch
    block under ``kernel``; none under ``ref``), streams equal to rank
    0's one-process steps; a float32-compute arm of
    ``WHISPER17_F32_STEPS`` steps per mesh against rank 0's one-process
    float32 steps at the reference's rtol = atol = 3e-3.  Last the mesh
    loss on (2, 2), tensor-parallel (the encoder and decoder layers on
    each rank's blocks, no model-axis weight gathered), in float32 on
    ``WHISPER_TRAIN_BATCH`` x ``WHISPER_TRAIN_SEQ`` tokens and their
    frames against rank 0's one-process loss (rtol 1e-4)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import decode as dec
    from repro_torch.models import encdec
    from repro_torch.configs.base import train_batch
    from repro_torch.models import transformer
    from repro_torch.models.transformer import cast_params, init_params
    from repro_torch.serve.engine import (ServeConfig, jit_decode_step,
                                          jit_prefill, serve_param_shardings)
    base = dataclasses.replace(get_arch("whisper-tiny").model,
                               kernel_impl="ref")
    rng = np.random.default_rng(SEED + 21)
    Bw, S, F = WHISPER_BATCH, WHISPER_PROMPT, base.encoder.context
    tokens = torch.from_numpy(rng.integers(0, base.vocab, (Bw, S)).astype(
        np.int32)).to(dev)
    frames = torch.from_numpy(rng.normal(size=(Bw, F, base.d_model)).astype(
        np.float32)).to(dev)
    scfg = ServeConfig(max_len=WHISPER_MAX_LEN)
    master = init_params(base, SEED, device=dev)
    out = {"launches": {}, "meshes": {}}

    def cache0(cfg, params, dtype):
        with torch.no_grad():
            logits, states = jit_prefill(cfg, None, device=dev)(
                params, {"tokens": tokens, "audio_frames": frames})
            cache = dec.cache_from_prefill(cfg, states, S, WHISPER_MAX_LEN,
                                           dtype)
            cache["enc_kv"] = encdec.precompute_enc_kv(
                params, frames, cfg).to(dtype)
        return cache, torch.argmax(logits[:, -1].float(), -1).int()

    def steps(cfg, ctx, params, cache, tok, n):
        cache = sharding.tree_map(torch.clone, cache)
        step = jit_decode_step(cfg, ctx, scfg, device=dev)
        logs, ms, pairs = [], [], []
        sharding.LOG.reset()
        for _ in range(n):
            before = _launches16()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = step(params, cache, tok)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            dl = _delta(before)
            pairs.append([dl["deinterleave"], dl["interleave"]])
            lg = sharding.full_tensor(lg).float()
            logs.append(lg)
            tok = torch.argmax(lg, -1).int()
        specs = [str(sharding.spec_of(leaf)) if sharding.is_dtensor(leaf)
                 else "whole" for leaf in (cache["blocks"]["pos0"],
                                           cache["enc_kv"])]
        return {"logits": logs, "ms": ms, "pairs": pairs, "specs": specs,
                "collectives": _collectives17(),
                "stream": [[int(t) for t in torch.argmax(x, -1)]
                           for x in logs]}

    for tag, compute in (("bf16", "bfloat16"), ("f32", "float32")):
        cfg = dataclasses.replace(base, compute_dtype=compute)
        params = cast_params(master, cfg)
        dtype = torch.bfloat16 if tag == "bf16" else torch.float32
        cache, tok0 = cache0(cfg, params, dtype)
        n = WHISPER17_STEPS if tag == "bf16" else WHISPER17_F32_STEPS
        one = steps(cfg, None, params, cache, tok0, n) if rank == 0 else None
        for shape, arm in WHISPER17_MESHES:
            ctx = make_ctx(make_test_mesh(shape, ("data", "model")))
            key = f"{shape[0]}x{shape[1]}"
            runs = {impl: steps(dataclasses.replace(cfg, kernel_impl=impl),
                                ctx, params, cache, tok0, n)
                    for impl in (("kernel", "ref") if tag == "bf16"
                                 else ("ref",))}
            r = runs["ref"]
            row = out["meshes"].setdefault(key, {"arm": arm})
            if tag == "bf16":
                k = runs["kernel"]
                if not all(same_bits(a, b) for a, b in zip(k["logits"],
                                                           r["logits"])):
                    raise AssertionError(f"17f {key}: kernel and ref logits "
                                         f"differ")
                if any(p != [base.n_layers] * 2 for p in k["pairs"]) or \
                        any(p != [0, 0] for p in r["pairs"]):
                    raise AssertionError(f"17f {key}: (B1, B2) launches per "
                                         f"step kernel {k['pairs']}, ref "
                                         f"{r['pairs']}")
                _add(out["launches"], {"deinterleave": sum(
                    p[0] for p in k["pairs"]), "interleave": sum(
                    p[1] for p in k["pairs"])})
                row.update(kernel_ms=k["ms"], ref_ms=r["ms"],
                           pairs=k["pairs"][0], specs=r["specs"],
                           collectives=k["collectives"])
                if rank == 0 and r["stream"] != one["stream"]:
                    raise AssertionError(f"17f {key}: batch-sharded stream "
                                         f"{r['stream']} vs one process "
                                         f"{one['stream']}")
            elif rank == 0:
                gap = max(float((a - b).abs().max())
                          for a, b in zip(r["logits"], one["logits"]))
                excess = max(float(((a - b).abs() - 3e-3 * (1 + b.abs()))
                                   .max())
                             for a, b in zip(r["logits"], one["logits"]))
                row.update(gap32=gap, excess32=excess,
                           f32_stream=r["stream"] == one["stream"])
                if excess > 0:
                    raise AssertionError(f"17f {key} float32: logit gap "
                                         f"{gap} beyond rtol = atol = 3e-3")
        del params, cache
    # the mesh loss, tensor-parallel, in float32 against one process
    cfg32 = dataclasses.replace(base, compute_dtype="float32")
    ctx = make_ctx(make_test_mesh((2, 2), ("data", "model")))
    batch = train_batch(cfg32, WHISPER_TRAIN_SEQ, WHISPER_TRAIN_BATCH,
                        specs=False,
                        generator=torch.Generator(dev).manual_seed(SEED + 26),
                        device=dev)
    placed = sharding.place_tree(master, serve_param_shardings(master, cfg32,
                                                               ctx))
    with torch.no_grad():
        if rank == 0:
            out["one_loss"] = float(transformer.loss_fn(
                master, batch, cfg32, None)[1]["loss"])
        sharding.LOG.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["loss"] = float(transformer.loss_fn(placed, batch, cfg32,
                                                ctx)[1]["loss"])
        torch.cuda.synchronize()
        out["loss_ms"] = (time.perf_counter() - t0) * 1e3
    out["loss_collectives"] = _collectives17()
    _tp_gate("17f mesh loss", _model_weight_shapes(placed))
    if rank == 0 and not abs(out["loss"] - out["one_loss"]) <= \
            1e-4 * abs(out["one_loss"]):
        raise AssertionError(f"17f: float32 mesh loss {out['loss']} vs one "
                             f"process {out['one_loss']} beyond rtol 1e-4")
    del master, placed
    torch.cuda.empty_cache()
    return out


#: 17g: (a) jamba's Mamba position alone at its published widths, x
#: (MAMBA_BATCH, MAMBA_SEQ, d) as in phase 12b, on these meshes, then a
#: prefill and this many decode steps; (b) xlstm-125m uncut on (2, 2):
#: its mesh loss's batch and sequence, the prompt and the greedy steps.
MAMBA17_MESHES = ((1, 4), (2, 2))
MAMBA17_STEPS = 4
XLSTM17_BATCH, XLSTM17_SEQ, XLSTM17_PROMPT, XLSTM17_STEPS = 4, 128, 16, 8
#: 17g (b)'s bounds: float32 (the xlstm family's 2e-3 of each leaf's
#: largest entry, as the CPU tests hold it) and the float64 arm's (1e-9,
#: stated before its first run).  The float32 gradients are held on the
#: batch's first ``XLSTM17_GRAD_SEQ`` tokens: over more tokens xlstm's
#: stack amplifies the row-parallel sums' ulps past any bound (on the
#: card, full width: 1.2e-3 over 8 tokens, 1.07 over 128), so over all
#: ``XLSTM17_SEQ`` only the loss is held.  The float64 arm runs on the
#: first ``XLSTM17_F64_SEQ``.  PR 34's float32 decode step beside them.
XLSTM17_TOL, XLSTM17_F64_BOUND = 2e-3, 1e-9
XLSTM17_GRAD_SEQ, XLSTM17_F64_SEQ = 8, 32
XLSTM17_PR34_STEP = (5, 516e6)
#: 17g (a)'s float32 bound: the mesh layer's output and each gradient
#: leaf within this fraction of the one-process layer's largest entry.
MAMBA17_TOL = 1e-4


def _rel_gap(a, b) -> float:
    """Largest |a - b| over the largest |b|, in float32."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def mamba17(dev, rank: int) -> dict:
    """17g (a): jamba's Mamba position (ln1 and the Mamba block; its FFN
    left out) alone at its published widths (d 8192, ed 16384, N 16, W 4,
    rank 512), seeded float32 weights placed by the parameter rules (all
    six matrices on ``ed``), x (MAMBA_BATCH, MAMBA_SEQ, d): on each of
    ``MAMBA17_MESHES`` the channel-parallel layer (the residual stream
    sequence-sharded) forward and backward of ``sum(y * probe)``, its
    float32 output and every gradient leaf (summed over the data axis and,
    a replicated leaf's, the model axis) against rank 0's one-process
    layer within ``MAMBA17_TOL`` of the largest entry; a prefill and
    ``MAMBA17_STEPS`` decode steps (``decode._recurrent_position``) on the
    rank's state block, placed as ``cache_specs`` places it, against the
    one process; a rank's weight and state bytes (1/m of the placed
    leaves'); no collective of a Mamba weight's shape; the bf16 forward's
    gap to the one-process bf16 forward printed."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P, RankLocal
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import decode as dec
    from repro_torch.models import layers, transformer
    from repro_torch.models.ssm import MambaCache
    full = get_arch("jamba-1.5-large-398b").model
    cfg = dataclasses.replace(full, n_layers=1, block_pattern=("mamba",),
                              window_pattern=(None,), moe_pattern=(False,),
                              mlp="none", d_ff=0, kernel_impl="ref",
                              compute_dtype="float32")
    B, S, d = MAMBA_BATCH, MAMBA_SEQ, full.d_model
    g = torch.Generator(dev).manual_seed(SEED + 24)
    p32 = transformer._init_pos(cfg, 0, g, dev)
    x = torch.randn((B, S + MAMBA17_STEPS, d), generator=g, device=dev)
    probe = torch.randn((B, S, d), generator=g, device=dev)
    flat = {"/".join(k): v for k, v in sharding._leaves_with_path(p32)}

    def apply(p, xs, rl, mode, c=cfg):
        return transformer._position_apply(p, xs, None, cfg=c, ctx=rl, i=0,
                                           kind="mamba", mode=mode)

    def steps(p, state_leaf, rows, rl, c=cfg, ms=None):
        ys = []
        for t in range(MAMBA17_STEPS):
            xt = x[rows, S + t].to(torch.float32 if c is cfg
                                   else torch.bfloat16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = layers.rms_norm(xt, p["ln1"], c.norm_eps)
            ys.append(xt + dec._recurrent_position(p, h, state_leaf, 0, c,
                                                   "mamba", rl))
            torch.cuda.synchronize()
            if ms is not None:
                ms.append((time.perf_counter() - t0) * 1e3)
        return torch.stack(ys)

    out = {"meshes": {}}
    torch.cuda.empty_cache()
    if rank == 0:
        w = sharding.tree_map(lambda t: t.detach().clone().requires_grad_(),
                              p32)
        with torch.enable_grad():
            y, _, _ = apply(w, x[:, :S], None, "train")
            (y.float() * probe).sum().backward()
        want = {"y": y.detach(), "grads": {
            "/".join(k): t.grad for k, t in sharding._leaves_with_path(w)}}
        del w, y
        with torch.no_grad():
            _, _, st = apply(p32, x[:, :S], None, "prefill")
            leaf = MambaCache(conv=st.conv[None].clone(), h=st.h[None].clone())
            want["steps"] = steps(p32, leaf, slice(0, B), None)
            want["state"] = leaf
            pb = sharding.tree_map(lambda t: t.to(torch.bfloat16), p32)
            cb = dataclasses.replace(cfg, compute_dtype="bfloat16")
            want["y16"] = apply(pb, x[:, :S].to(torch.bfloat16), None,
                                "train", cb)[0]
            del pb
        torch.cuda.empty_cache()
    for shape in MAMBA17_MESHES:
        ctx = make_ctx(make_test_mesh(shape, ("data", "model")))
        mesh, m = ctx.mesh, ctx.model_size
        specs = {k: sharding.param_spec(k, tuple(v.shape), ctx)
                 for k, v in flat.items()}
        local = {k: sharding.local_block(v, mesh, specs[k]).detach().clone()
                 for k, v in flat.items()}
        p = {"ln1": local["ln1"], "mamba": {
            k.split("/")[1]: v for k, v in local.items() if "/" in k}}
        rl = RankLocal(mesh=None, experts=ctx, tp=ctx, seq=S % m == 0)
        xs = P("data", "model" if rl.seq else None)
        xb = sharding.local_block(x[:, :S], mesh, xs)
        pr = sharding.local_block(probe, mesh, xs)
        held = [sum(local[k].numel() * local[k].element_size()
                    for k in local if sharding.is_sharded(specs[k])),
                sum(flat[k].numel() * flat[k].element_size()
                    for k in flat if sharding.is_sharded(specs[k]))]
        weights = set()
        for k, v in flat.items():
            if sharding.is_sharded(specs[k]):
                weights |= {tuple(v.shape), tuple(local[k].shape)}
        for t in (p["ln1"], *p["mamba"].values()):
            t.requires_grad_()
        sharding.LOG.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            y, _, _ = apply(p, xb, rl, "train")
            sharding.global_sum((y.float() * pr).sum(), mesh,
                                ("data", "model")).backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        coll = _collectives17()
        _tp_gate(f"17g (a) {shape}", weights)
        grads = {}
        for k, v in flat.items():
            gl = (p["ln1"] if k == "ln1" else p["mamba"][k.split("/")[1]]
                  ).grad
            placed = sharding.is_sharded(specs[k])
            gl = sharding.psum(gl, mesh, ("data",) if placed
                               else ("data", "model"))
            grads[k] = sharding.full_tensor(sharding.from_local(
                gl, mesh, specs[k], v.shape))
        yw = sharding.full_tensor(sharding.from_local(y.detach(), mesh, xs,
                                                      (B, S, d)))
        with torch.no_grad():
            # bf16: the layer's forward alone
            pb = sharding.tree_map(lambda t: t.detach().to(torch.bfloat16),
                                   p)
            cb = dataclasses.replace(cfg, compute_dtype="bfloat16")
            y16 = sharding.full_tensor(sharding.from_local(
                apply(pb, xb.to(torch.bfloat16), rl, "train", cb)[0], mesh,
                xs, (B, S, d)))
            del pb
            # prefill, then decode steps on the state block as cache_specs
            # places it
            _, _, st = apply(p, xb, rl, "prefill")
            leaf = MambaCache(
                conv=sharding.from_local(st.conv[None].clone(), mesh,
                                         P(None, "data", None, "model")),
                h=sharding.from_local(st.h[None].clone(), mesh,
                                      P(None, "data", "model")))
            state_bytes = [sharding.local_nbytes(leaf),
                           sum(t.numel() * t.element_size() for t in leaf)]
            n = B // shape[0]
            r = sharding.axis_index(mesh, "data")
            rows = slice(r * n, (r + 1) * n)
            sharding.LOG.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys = steps(p, leaf, rows, RankLocal(mesh=None, experts=ctx,
                                               tp=ctx))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / MAMBA17_STEPS
            step_coll = _collectives17()
            _tp_gate(f"17g (a) {shape} decode", weights)
            ys = sharding.all_gather(ys, mesh, "data", 1)
            state = [sharding.full_tensor(t) for t in leaf]
            wide = mamba17_wide(p, xb, rows, rl, cfg, apply, steps)
        row = {"ms": ms, "collectives": coll, "step_ms": step_ms,
               "step_collectives": step_coll, "weight_bytes": held,
               "state_bytes": state_bytes, "wide": wide}
        if held[0] * m != held[1] or \
                state_bytes[0] * m * shape[0] != state_bytes[1]:
            raise AssertionError(f"17g (a) {shape}: a rank holds "
                                 f"{held[0]} of {held[1]} weight bytes, "
                                 f"{state_bytes[0]} of {state_bytes[1]} "
                                 f"state bytes")
        if rank == 0:
            row["y_gap"] = _rel_gap(yw, want["y"])
            row["grad_gap"] = max((_rel_gap(grads[k], want["grads"][k]), k)
                                  for k in grads)
            row["step_gap"] = _rel_gap(ys, want["steps"])
            row["state_gap"] = max(_rel_gap(a, b) for a, b in
                                   zip(state, want["state"]))
            row["bf16_gap"] = _rel_gap(y16, want["y16"])
            worst = max(row["y_gap"], row["grad_gap"][0], row["step_gap"],
                        row["state_gap"])
            if not worst <= MAMBA17_TOL:
                raise AssertionError(f"17g (a) {shape}: float32 gaps {row}"
                                     f" beyond {MAMBA17_TOL}")
        out["meshes"][f"{shape[0]}x{shape[1]}"] = row
        del p, local, y, grads, yw, y16, leaf, st
        torch.cuda.empty_cache()
    if rank == 0:
        del want
    torch.cuda.empty_cache()
    return out


def _copy_wide(a, w):
    """A row-parallel product's operands copied to float32 before the
    product: what ``sharding.wide_matmul`` does for bf16 where torch has
    no ``out_dtype`` GEMM."""
    return a.float() @ w.float()


def mamba17_wide(p, xb, rows, rl, cfg, apply, steps) -> dict:
    """17g (a)'s bf16 decode with and without the weight copies: a bf16
    prefill of the rank's block, then ``MAMBA17_STEPS`` steps each way
    from its state, twice, in the order gemm, copy, gemm, copy (gemm:
    ``sharding.wide_matmul`` as it runs, one GEMM with a float32 output;
    copy: ``_copy_wide`` in its place); the host ms of each step of the
    second run of each way, the largest gap of their outputs, and the
    device ms of ``out_proj``'s product alone at the step's shapes each
    way and as a plain bf16 GEMM (``time_ms``, 50 calls)."""
    import torch
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import P, RankLocal
    from repro_torch.models.ssm import MambaCache
    mesh = rl.tp.mesh
    pb = sharding.tree_map(lambda t: t.detach().to(torch.bfloat16), p)
    cb = dataclasses.replace(cfg, compute_dtype="bfloat16")
    _, _, st = apply(pb, xb.to(torch.bfloat16), rl, "prefill", cb)
    step_rl = RankLocal(mesh=None, experts=rl.experts, tp=rl.tp)
    gemm = sharding.wide_matmul
    out = {"out_dtype": sharding._mm_out_dtype(), "ms": {}, "ys": {}}
    try:
        for way in ("gemm", "copy", "gemm", "copy"):
            sharding.wide_matmul = gemm if way == "gemm" else _copy_wide
            leaf = MambaCache(
                conv=sharding.from_local(st.conv[None].clone(), mesh,
                                         P(None, "data", None, "model")),
                h=sharding.from_local(st.h[None].clone(), mesh,
                                      P(None, "data", "model")))
            ms = []
            out["ys"][way] = steps(pb, leaf, rows, step_rl, cb, ms)
            out["ms"][way] = ms
    finally:
        sharding.wide_matmul = gemm
    out["gap"] = float((out["ys"]["gemm"].float()
                        - out["ys"]["copy"].float()).abs().max())
    del out["ys"]
    w = pb["mamba"]["out_proj"]
    y = torch.randn((xb.shape[0], w.shape[0]), device=w.device,
                    dtype=torch.bfloat16)
    out["product_ms"] = {"gemm": time_ms(lambda: gemm(y, w), 50),
                         "copy": time_ms(lambda: _copy_wide(y, w), 50),
                         "bf16": time_ms(lambda: y @ w, 50)}
    out["product_shape"] = [list(y.shape), list(w.shape)]
    return out


def xlstm17(dev, rank: int) -> dict:
    """17g (b): xlstm-125m uncut on (2, 2), the embedding and head
    vocab-parallel, the mLSTM head-parallel and the sLSTM channel-parallel
    on the rank's blocks of their weights (models/xlstm.py): the float32
    mesh loss on ``XLSTM17_BATCH`` x ``XLSTM17_SEQ`` seeded tokens
    against rank 0's one-process port (``XLSTM17_TOL``, the xlstm
    family's tolerance: a row-parallel sum changes the cells' output by
    an ulp, which xlstm's stack amplifies), the loss and
    every gradient leaf on the first ``XLSTM17_GRAD_SEQ`` tokens at
    ``XLSTM17_TOL`` of its largest entry, and loss and gradients in
    float64 on the first ``XLSTM17_F64_SEQ`` tokens at
    ``XLSTM17_F64_BOUND`` (the partition held where ulps cannot reach;
    the card has no JAX); then a prompt of
    ``XLSTM17_PROMPT`` prefilled in one process on every rank and
    ``XLSTM17_STEPS`` batch-sharded greedy steps on the rank's state
    blocks: the float32 logits gated at ``XLSTM17_TOL`` and the streams
    equal to rank 0's one-process steps, the bf16 streams printed
    (seeded xlstm is chaotic in bf16, ROADMAP C); the cache placed as
    ``cache_specs`` says; a rank's cell-weight and state bytes; no
    collective of a model-axis weight's shape."""
    import torch
    from repro_torch.configs.base import get_arch, train_batch
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import decode as dec
    from repro_torch.models import transformer
    from repro_torch.roofline.analysis import bundle_from_trace
    from repro_torch.serve.engine import (ServeConfig, cache_specs,
                                          jit_decode_step, jit_prefill,
                                          serve_param_shardings)
    cfg = dataclasses.replace(get_arch("xlstm-125m").model,
                              kernel_impl="ref")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    cfg64 = dataclasses.replace(cfg, param_dtype="float64",
                                compute_dtype="float64")
    ctx = make_ctx(make_test_mesh((2, 2), ("data", "model")))
    params = transformer.init_params(cfg, SEED, device=dev)
    where = serve_param_shardings(params, cfg, ctx)
    placed = sharding.place_tree(params, where)
    weights = _model_weight_shapes(placed)
    cells = [leaf for path, leaf in sharding._leaves_with_path(placed)
             if path[-2:-1] in (("xl",), ("slstm",))
             and sharding.is_dtensor(leaf)
             and "model" in sharding.spec_of(leaf)]
    out = {"weight_bytes": [sum(sharding.local_nbytes(t) for t in cells),
                            sum(t.numel() * t.element_size()
                                for t in cells)],
           "cell_leaves": len(cells)}
    if 2 * out["weight_bytes"][0] != out["weight_bytes"][1]:
        raise AssertionError(f"17g (b): a rank holds {out['weight_bytes']} "
                             f"B of the cells' placed weights, not 1/2")
    batch = train_batch(cfg, XLSTM17_SEQ, XLSTM17_BATCH, specs=False,
                        generator=torch.Generator(dev).manual_seed(SEED + 25),
                        device=dev)
    with torch.no_grad():
        if rank == 0:
            out["one_loss"] = float(transformer.loss_fn(
                params, batch, cfg32, None)[1]["loss"])
        sharding.LOG.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["loss"] = float(transformer.loss_fn(placed, batch, cfg32,
                                                ctx)[1]["loss"])
        torch.cuda.synchronize()
        out["loss_ms"] = (time.perf_counter() - t0) * 1e3
        out["loss_collectives"] = _collectives17()
        _tp_gate("17g (b) loss", weights)
    if rank == 0 and not abs(out["loss"] - out["one_loss"]) <= \
            XLSTM17_TOL * abs(out["one_loss"]):
        raise AssertionError(f"17g (b): mesh loss {out['loss']} vs one "
                             f"process {out['one_loss']} beyond rtol "
                             f"{XLSTM17_TOL}")
    for key, n, c, bound in (
            ("grads32", XLSTM17_GRAD_SEQ, cfg32, XLSTM17_TOL),
            ("grads64", XLSTM17_F64_SEQ, cfg64, XLSTM17_F64_BOUND)):
        p = params if c is cfg32 else sharding.tree_map(
            lambda t: t.double(), params)
        pl = placed if c is cfg32 else sharding.place_tree(p, where)
        out[key] = _mesh_grads17(
            f"17g (b) {key}", p, pl, {k: v[:, :n] for k, v in batch.items()},
            c, ctx, rank, _model_weight_shapes(pl), bound)
        del p, pl
    torch.cuda.empty_cache()
    with torch.no_grad():
        prompt = batch["tokens"][:, :XLSTM17_PROMPT]
        max_len = XLSTM17_PROMPT + XLSTM17_STEPS
        scfg = ServeConfig(max_len=max_len)
        for tag, c, dt in (("f32", cfg32, torch.float32),
                           ("bf16", cfg, torch.bfloat16)):
            logits, states = jit_prefill(c, None, device=dev)(
                params, {"tokens": prompt})
            cache0 = dec.cache_from_prefill(c, states, XLSTM17_PROMPT,
                                            max_len, dt)
            tok0 = torch.argmax(logits[:, -1].float(), -1).int()
            runs = {}
            for key, cc in (("one", None), ("mesh", ctx)):
                if key == "one" and rank != 0:
                    continue
                cache = sharding.tree_map(torch.clone, cache0)
                step = jit_decode_step(c, cc, scfg, device=dev)
                tok, stream, ms, lgs = tok0, [], [], []
                sharding.LOG.reset()
                for _ in range(XLSTM17_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lg, cache = step(params if cc is None else placed,
                                     cache, tok)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    lg = sharding.full_tensor(lg).float()
                    lgs.append(lg)
                    tok = torch.argmax(lg, -1).int()
                    stream.append([int(t) for t in tok])
                runs[key] = {"stream": stream, "ms": ms, "logits": lgs,
                             "collectives": _collectives17()}
                # one more step traced: its FLOPs on this rank
                runs[key]["flops"] = bundle_from_trace(
                    step, params if cc is None else placed, cache,
                    tok)[1].flops
                if cc is not None:
                    _tp_gate(f"17g (b) {tag} decode", weights)
                    ok = []
                    sharding.tree_map(lambda a, sp: ok.append(
                        sharding._norm(sharding.spec_of(a)
                                       if sharding.is_dtensor(a)
                                       else sharding.P(), a.ndim)
                        == sharding._norm(sp, a.ndim)), cache,
                        cache_specs(c, ctx, scfg, cache))
                    state = [x for k, v in cache["blocks"].items()
                             for x in sharding._leaves_with_path(v)]
                    runs[key]["placed_ok"] = all(ok)
                    runs[key]["state_bytes"] = [
                        sum(sharding.local_nbytes(t) for _, t in state),
                        sum(t.numel() * t.element_size() for _, t in state)]
                    # the batch over the data axis, the heads or channels
                    # over the model axis: 1/4 of the whole a rank
                    if not all(ok) or 4 * runs[key]["state_bytes"][0] != \
                            runs[key]["state_bytes"][1]:
                        raise AssertionError(f"17g (b) {tag}: cache placed "
                                             f"as cache_specs {all(ok)}, a "
                                             f"rank's state bytes "
                                             f"{runs[key]['state_bytes']}")
            if rank == 0:
                one, mesh = runs["one"], runs["mesh"]
                runs["equal"] = one["stream"] == mesh["stream"]
                # a rank's step against one process's on its batch block
                runs["flops_share"] = mesh["flops"] * ctx.data_size / \
                    one["flops"]
                runs["gap"] = max(_rel_gap(a, b) for a, b in
                                  zip(mesh["logits"], one["logits"]))
                if tag == "f32" and (not runs["equal"]
                                     or runs["gap"] > XLSTM17_TOL):
                    raise AssertionError(
                        f"17g (b) float32: batch-sharded stream "
                        f"{mesh['stream']} vs one process {one['stream']}, "
                        f"logit gap {runs['gap']} (bound {XLSTM17_TOL})")
            for r in runs.values():
                if isinstance(r, dict):
                    r.pop("logits", None)
            out[tag] = runs
    del params, placed
    torch.cuda.empty_cache()
    return out


def _mesh_grads17(tag: str, params, placed, batch, cfg, ctx, rank: int,
                  weights: set, bound: float) -> dict:
    """The mesh loss and its gradients (each leaf summed over the axes its
    placement does not name, as the train step reduces them, gathered
    whole) against rank 0's one-process ``loss`` and gradients: the
    loss's relative gap and each leaf's largest gap over its largest
    entry gated at ``bound``; the forward and backward's host ms and
    collectives."""
    import torch
    from repro_torch.dist import sharding
    from repro_torch.models import transformer
    from repro_torch.train.step import _loss_and_grads
    one = _loss_and_grads(params, batch, cfg, None) if rank == 0 else None
    leaves = sharding.tree_map(
        lambda t: sharding.from_local(t.to_local().detach(), t.device_mesh,
                                      sharding.spec_of(t), t.shape)
        .requires_grad_() if sharding.is_dtensor(t)
        else t.detach().requires_grad_(), placed)
    sharding.LOG.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss, m = transformer.loss_fn(leaves, batch, cfg, ctx)
        loss.backward()
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) * 1e3,
           "collectives": _collectives17(),
           "loss": float(m["loss"].detach())}
    _tp_gate(tag, weights)
    axes = ctx.data_axes + (ctx.model_axis,)
    gaps = {}
    for path, x in sharding._leaves_with_path(leaves):
        g = x.grad
        if sharding.is_dtensor(g):
            named = {a for e in sharding.spec_of(g)
                     for a in sharding._names(e)}
            g = sharding.full_tensor(sharding.from_local(
                sharding.psum(g.to_local(), ctx.mesh,
                              tuple(a for a in axes if a not in named)),
                ctx.mesh, sharding.spec_of(g), g.shape))
        else:
            g = sharding.psum(g, ctx.mesh, axes)
        if rank == 0:
            want = dict(sharding._leaves_with_path(one[2]))[path]
            gaps["/".join(path)] = float(
                (g.double() - want.double()).abs().max()
                / want.double().abs().max().clamp_min(1e-300))
    del leaves
    if rank == 0:
        out["one_loss"] = float(one[1]["loss"])
        out["loss_gap"] = abs(out["loss"] - out["one_loss"]) / abs(
            out["one_loss"])
        worst = max(gaps, key=gaps.get)
        out["grad_gap"], out["grad_worst"] = gaps[worst], worst
        out["leaves"] = len(gaps)
        if out["loss_gap"] > bound or out["grad_gap"] > bound:
            raise AssertionError(f"{tag}: mesh loss {out['loss']} vs one "
                                 f"process {out['one_loss']}, gradient gap "
                                 f"{out['grad_gap']} at {worst} (bound "
                                 f"{bound})")
    torch.cuda.empty_cache()
    return out


def sharded17(rank: int) -> dict:
    """17.0-17g on one rank (the same program on every rank): 17f and 17g
    before 17e, which waits for the main process to leave the card."""
    import torch
    dev = torch.device("cuda")
    res = {"probe": probe17(rank)}
    t0 = time.perf_counter()
    res["17a"], placed = train17(dev, rank)
    res["17a"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["17c"] = elastic17(dev, rank, placed)
    res["17c"]["s"] = time.perf_counter() - t0
    del placed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["17b"] = pipeline17(dev, rank)
    res["17b"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["17d"] = serve17(dev, rank)
    res["17d"]["f32"] = serve17_f32(dev, rank)
    res["17d"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["17f"] = whisper17(dev, rank)
    res["17f"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["17g"] = {"a": mamba17(dev, rank), "b": xlstm17(dev, rank)}
    res["17g"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["17e"] = moe17(dev, rank)
    res["17e"]["s"] = time.perf_counter() - t0
    return res


def _coll_text(c: dict) -> str:
    return (f"{c['calls']} collectives ({', '.join(f'{k} {v}' for k, v in sorted(c['ops'].items()))}), "
            f"{c['bytes']} B, {c['s']:.3f} s of host time")


def train_phase_lines(res: list, where: str) -> dict:
    """Phase 17's lines from every rank's :func:`sharded17` result; its
    launches summed over the ranks."""
    r0 = res[0]
    p = r0["probe"]
    print(f"phase 17.0 GPipe's hand-off on CUDA tensors under gloo "
          f"({where}): all_to_all_single with one peer's split (dist."
          f"sharding.ppermute; point-to-point sends refused, "
          f"tools/gloo_p2p_probe.py): the peer's data, 32 MiB bf16 "
          f"{statistics.median(r['probe']['ppermute_32MiB_ms'] for r in res):.3f}"
          f" ms (median over ranks, host clock)")
    a = r0["17a"]
    for i, s in enumerate(a["bf16"]):
        print(f"phase 17a qwen3-0.6b ZeRO-1 train step {i} [bf16 compute, "
              f"ref] on (2, 2) (data, model) ({where}): {TRAIN17_BATCH} x "
              f"{TRAIN17_SEQ} tokens, full width and depth; loss "
              f"{s['loss']:.6f}, grad norm {s['grad_norm']:.6f}; ms per rank "
              f"{[round(r['17a']['bf16'][i]['ms'], 1) for r in res]} (host "
              f"clock, synchronized); rank 0: {_coll_text(s['collectives'])}"
              f" (before tensor parallelism, the weights gathered whole: "
              f"4.46e9 B in 70; below it: "
              f"{s['collectives']['bytes'] < 4.46e9}); no model-axis weight "
              f"gathered (tensor parallel)")
    print(f"phase 17a gates (the reference's): losses finite, "
          f"{a['bf16'][1]['loss']:.6f} < {a['bf16'][0]['loss']:.6f} + 0.5, "
          f"wq a DTensor a rank holds 1/2 of; a rank's params "
          f"{a['param_bytes'][1]} of {a['param_bytes'][0]} B, its AdamW "
          f"moments (ZeRO-1) {a['moment_bytes'][1]} of "
          f"{a['moment_bytes'][0]} B; peak memory per rank "
          f"{[r['17a']['peak'] for r in res]} B (tensor parallel: the "
          f"residual stream sequence-sharded over the model axis)")
    f = a["f32"]
    print(f"phase 17a float32 compute, {F32_LAYERS17} of 28 layers, one "
          f"step against rank 0's one-process step on the same state and "
          f"batch: loss {f['loss']:.7f} vs {f['want']['loss']:.7f} (rtol "
          f"1e-4), grad norm {f['grad_norm']:.6f} vs "
          f"{f['want']['grad_norm']:.6f} (rtol 1e-3), params largest gap "
          f"{f['gap']:.3e} (bound 2 lr = {2 * f['lr']:.3e}), "
          f"{f['far']:.2e} of entries beyond 0.1 lr (bound 1e-3; beyond "
          f"1e-3 lr, the params' ulp: {f['ulp']:.2e}); ms "
          f"per rank {[round(r['17a']['f32']['ms'], 1) for r in res]} "
          f"against {a['f32_one_ms']:.1f} in one process; rank 0: "
          f"{_coll_text(f['collectives'])} ({a['s']:.1f} s)")
    b = r0["17b"]
    print(f"phase 17b GPipe qwen3-0.6b on (2, 1, 2) (pod, data, model) "
          f"({where}): 2 stages x 14 superblocks, 2 microbatches of "
          f"{TRAIN17_BATCH // 2} x {TRAIN17_SEQ}, bf16 compute, loss and "
          f"backward: loss {b['loss']:.6f} vs one process "
          f"{b['one']['loss']:.6f} (rtol 2e-3); gradient norm, the stages' "
          f"shares added, {b['gnorm']:.6f} vs one process "
          f"{b['one']['gnorm']:.6f}; a rank's stage share "
          f"{[round(r['17b']['share'], 4) for r in res]} (finite, nonzero); "
          f"ms per rank {[round(r['17b']['ms'], 1) for r in res]}; rank 0: "
          f"{_coll_text(b['collectives'])} ({b['s']:.1f} s)")
    c = r0["17c"]
    print(f"phase 17c elastic restore ({where}): 17a's params on (2, 2) "
          f"saved ({c['disk_bytes']} B on disk, {c['save_s']:.2f} s with "
          f"the gathers) and restored onto (1, 4) in {c['restore_s']:.2f} "
          f"s: {c['leaves']} leaves bit for bit, wq a rank's quarter; a "
          f"rank's bytes {c['bytes'][0]} on (2, 2), {c['bytes'][1]} on "
          f"(1, 4) ({c['s']:.1f} s)")
    d = r0["17d"]
    for impl in ("kernel", "ref"):
        print(f"phase 17d qwen3-0.6b batch-sharded decode [{impl}] on (2, 2) "
              f"({where}): 4 x {SERVE17_PROMPT} prompt tokens prefilled "
              f"under the mesh, {SERVE17_STEPS} greedy steps, cache "
              f"{d[impl]['spec']}; B1 launches per step {d[impl]['b1']}; "
              f"median ms per step per rank "
              f"{[round(statistics.median(r['17d'][impl]['ms']), 1) for r in res]}; "
              f"rank 0, {SERVE17_STEPS} steps: "
              f"{_coll_text(d[impl]['collectives'])}; no model-axis weight "
              f"gathered")
    print(f"phase 17d the mesh prefill, rank 0: "
          f"{_coll_text(d['prefill_collectives'])}; no model-axis weight "
          f"gathered")
    flip = ("greedy streams equal to rank 0's one-process dense steps"
            if d["flip"] is None else
            f"a bf16 greedy stream flips on a near-tie at step "
            f"{d['flip']['step']}, row {d['flip']['row']} (the one "
            f"process's top-2 margin {d['flip']['margin']:.6f} within the "
            f"bf16 tolerance, the logit gap there {d['flip']['gap']:.6f}): "
            f"the streams are gated in float32")
    f32 = d["f32"]
    print(f"phase 17d float32 compute [kernel], prefill and "
          f"{SERVE17_STEPS} steps: streams equal to rank 0's one process "
          f"{f32['streams_equal']}, largest logit gap {f32['gap32']:.3e} "
          f"within rtol = atol = 3e-3 (largest |gap| - 3e-3 (1 + |logit|) "
          f"{f32['excess32']:.3e})")
    print(f"phase 17d kernel == ref bit for bit over {SERVE17_STEPS} steps; "
          f"B1 on a rank's cache block {d['block']} == plain bit for bit; "
          f"{flip}, "
          f"largest bf16 logit gap {d['gap']:.6f} beside max(0.08, 0.03 * "
          f"|logits|max) = {d['tol']:.6f} (not gated); KV cache a rank "
          f"holds {d['cache_bytes'][1]} of {d['cache_bytes'][0]} B; "
          f"launches per rank {[r['17d']['launches'] for r in res]} "
          f"({d['s']:.1f} s)")
    f = r0["17f"]
    for key, row in f["meshes"].items():
        print(f"phase 17f whisper-tiny batch-sharded decode on {key} "
              f"({row['arm']}) ({where}): 4 x {WHISPER_PROMPT} prompt tokens "
              f"and 4 x 1500 frame stubs prefilled in one process, "
              f"{WHISPER17_STEPS} greedy steps, ring / enc_kv "
              f"{row['specs'][0]} / {row['specs'][1]}; kernel == ref bit for "
              f"bit, (B1, B2) launches per step and rank {row['pairs']} "
              f"under kernel, none under ref; streams equal to rank 0's "
              f"one-process steps; median ms per step per rank kernel "
              f"{[round(statistics.median(r['17f']['meshes'][key]['kernel_ms']), 1) for r in res]}"
              f", ref "
              f"{[round(statistics.median(r['17f']['meshes'][key]['ref_ms']), 1) for r in res]}"
              f"; rank 0 (kernel): {_coll_text(row['collectives'])}; float32 "
              f"compute, {WHISPER17_F32_STEPS} steps: largest logit gap "
              f"{row['gap32']:.3e} within rtol = atol = 3e-3 (largest |gap| "
              f"- 3e-3 (1 + |logit|) {row['excess32']:.3e}), streams equal "
              f"{row['f32_stream']}")
    print(f"phase 17f mesh loss, tensor-parallel, float32 compute, on (2, "
          f"2) ({where}): {WHISPER_TRAIN_BATCH} x {WHISPER_TRAIN_SEQ} tokens "
          f"and their 1500-frame stubs; loss {f['loss']:.7f} vs rank 0's one "
          f"process {f['one_loss']:.7f} (rtol 1e-4); ms per rank "
          f"{[round(r['17f']['loss_ms'], 1) for r in res]}; rank 0: "
          f"{_coll_text(f['loss_collectives'])}; no model-axis weight "
          f"gathered")
    print(f"phase 17f launches per rank {[r['17f']['launches'] for r in res]}"
          f" ({f['s']:.1f} s)")
    g = r0["17g"]
    for key, row in g["a"]["meshes"].items():
        print(f"phase 17g (a) jamba Mamba position at published widths (d "
              f"8192, ed 16384, N 16, W 4, rank 512) on {key} (data, model) "
              f"({where}): x ({MAMBA_BATCH}, {MAMBA_SEQ}, 8192), "
              f"channel-parallel on ed, float32; forward and backward of "
              f"sum(y * probe): output gap {row['y_gap']:.3e}, largest "
              f"gradient gap {row['grad_gap'][0]:.3e} ({row['grad_gap'][1]})"
              f" over the one-process layer's largest entry (bound "
              f"{MAMBA17_TOL}); ms per rank "
              f"{[round(r['17g']['a']['meshes'][key]['ms'], 1) for r in res]}"
              f"; rank 0: {_coll_text(row['collectives'])}; bf16 forward's "
              f"gap to the one-process bf16 forward {row['bf16_gap']:.3e} "
              f"(not gated)")
        print(f"phase 17g (a) {key}: prefill, then {MAMBA17_STEPS} decode "
              f"steps on the rank's state block (conv / h on ed, as "
              f"cache_specs places them): outputs gap {row['step_gap']:.3e},"
              f" final state gap {row['state_gap']:.3e} (bound "
              f"{MAMBA17_TOL}); ms per step per rank "
              f"{[round(r['17g']['a']['meshes'][key]['step_ms'], 1) for r in res]}"
              f"; rank 0 over the steps: "
              f"{_coll_text(row['step_collectives'])}; a rank holds "
              f"{row['weight_bytes'][0]} of {row['weight_bytes'][1]} B of "
              f"the placed weights, {row['state_bytes'][0]} of "
              f"{row['state_bytes'][1]} B of state; no collective of a "
              f"Mamba weight's shape")
        wd = row["wide"]
        print(f"phase 17g (a) {key} bf16 decode, the row-parallel products "
              f"one GEMM with a float32 output (torch.mm out_dtype: "
              f"{wd['out_dtype']}) vs their operands copied to float32: ms "
              f"per step, rank 0, gemm {[round(t, 2) for t in wd['ms']['gemm']]}"
              f", copy {[round(t, 2) for t in wd['ms']['copy']]}; outputs' "
              f"largest gap {wd['gap']:.3e}; out_proj's product alone "
              f"{wd['product_shape']} device ms gemm "
              f"{wd['product_ms']['gemm']:.4f}, copy "
              f"{wd['product_ms']['copy']:.4f}, plain bf16 "
              f"{wd['product_ms']['bf16']:.4f}")
    b = g["b"]
    print(f"phase 17g (b) xlstm-125m uncut on (2, 2) (data, model) "
          f"({where}), the mLSTM head-parallel and the sLSTM "
          f"channel-parallel on the rank's weight blocks (a rank holds "
          f"{b['weight_bytes'][0]} of {b['weight_bytes'][1]} B of the "
          f"{b['cell_leaves']} placed cell leaves; no model-axis weight in "
          f"a collective), the embedding and head vocab-parallel: float32 "
          f"mesh loss on {XLSTM17_BATCH} x {XLSTM17_SEQ} tokens "
          f"{b['loss']:.7f} vs rank 0's one process {b['one_loss']:.7f} "
          f"(rtol {XLSTM17_TOL:g}); ms per rank "
          f"{[round(r['17g']['b']['loss_ms'], 1) for r in res]}; rank 0: "
          f"{_coll_text(b['loss_collectives'])}")
    for tag, tokens, bound in (
            ("grads32", XLSTM17_GRAD_SEQ, XLSTM17_TOL),
            ("grads64", XLSTM17_F64_SEQ, XLSTM17_F64_BOUND)):
        x = b[tag]
        print(f"phase 17g (b) xlstm-125m "
              f"{'float64' if tag == 'grads64' else 'float32'} mesh loss and "
              f"gradients on {XLSTM17_BATCH} x {tokens} tokens: loss "
              f"{x['loss']:.10f} vs rank 0's one process "
              f"{x['one_loss']:.10f} (gap {x['loss_gap']:.3e}), largest "
              f"gradient gap over its leaf's largest entry "
              f"{x['grad_gap']:.3e} ({x['grad_worst']}, {x['leaves']} "
              f"leaves; bound {bound:g}); forward and backward ms per rank "
              f"{[round(r['17g']['b'][tag]['ms'], 1) for r in res]}; rank 0: "
              f"{_coll_text(x['collectives'])}")
    for tag in ("f32", "bf16"):
        x = b[tag]
        c = x["mesh"]["collectives"]
        print(f"phase 17g (b) [{tag} compute] prompt {XLSTM17_PROMPT} "
              f"prefilled in one process, {XLSTM17_STEPS} batch-sharded "
              f"greedy steps on the rank's state blocks (placed as "
              f"cache_specs says: {x['mesh']['placed_ok']}; a rank holds "
              f"{x['mesh']['state_bytes'][0]} of "
              f"{x['mesh']['state_bytes'][1]} B of state): streams equal to "
              f"rank 0's one process {x['equal']}"
              f"{' (gated)' if tag == 'f32' else ' (printed, not gated)'}, "
              f"largest logit gap over the largest logit {x['gap']:.3e}"
              f"{f' (bound {XLSTM17_TOL:g})' if tag == 'f32' else ''}; "
              f"median ms per step per rank "
              f"{[round(statistics.median(r['17g']['b'][tag]['mesh']['ms']), 1) for r in res]}"
              f" (one process {statistics.median(x['one']['ms']):.1f}); rank "
              f"0 over the steps: {_coll_text(c)}; a step "
              f"{c['calls'] / XLSTM17_STEPS:g} collectives, "
              f"{c['bytes'] / XLSTM17_STEPS:.0f} B (PR 34, the cells' "
              f"weights gathered: {XLSTM17_PR34_STEP[0]}, "
              f"{XLSTM17_PR34_STEP[1]:.0f} B); one more step's FLOPs on "
              f"rank 0 {x['mesh']['flops']:.4e}, one process "
              f"{x['one']['flops']:.4e}: a rank's share of its batch "
              f"block's {x['flops_share']:.4f}")
    print(f"phase 17g: {g['s']:.1f} s")
    e = r0["17e"]
    for tag in ("bf16", "f32"):
        x = e[tag]
        vs = (f"; against rank 0's one process (expert_parallel_plain (2, "
              f"2)): loss {x['want']['loss']:.7f} (rtol 1e-4), grad norm "
              f"{x['want']['grad_norm']:.6f} (rtol 1e-3), params largest gap "
              f"{x['gap']:.3e} (bound 2 lr = {2 * x['lr']:.3e}), "
              f"{x['far']:.2e} of entries beyond 0.1 lr (bound 1e-3); one "
              f"process {e['one_ms']:.1f} ms" if tag == "f32" else "")
        print(f"phase 17e qwen3-moe-30b-a3b expert-parallel ZeRO-1 train step "
              f"[{tag} compute, ref] on (2, 2) (data, model) ({where}, after "
              f"the main process left the card: waited {e['waited_s']:.1f} "
              f"s): published widths (d 2048, 128 experts top-8, d_ff 768, "
              f"vocab 151936), {MOE17_LAYERS} of 48 layers, {MOE17_BATCH} x "
              f"{MOE17_SEQ} tokens; loss {x['loss']:.7f}, grad norm "
              f"{x['grad_norm']:.6f}{vs}; expert-bank bytes a rank holds "
              f"{x['bank_bytes'][1]} of {x['bank_bytes'][0]} (resident, no "
              f"collective or packed gather of a bank's shape), params "
              f"{x['params_bytes']} B; peak memory per rank "
              f"{[r['17e'][tag]['peak'] for r in res]} B; ms per rank "
              f"{[round(r['17e'][tag]['ms'], 1) for r in res]}; rank 0: "
              f"{_coll_text(x['collectives'])}; no model-axis weight "
              f"gathered")
    print(f"phase 17e: {e['s']:.1f} s; pinned host bytes each rank's gloo "
          f"cache held at its start, after the bf16 step, after the float32 "
          f"step (each then given back) "
          f"{[r['17e']['pinned'] for r in res]}; peak resident host bytes "
          f"per rank {[r['17e']['rss'][-1] for r in res]}")
    t = a["trace"]
    ms = statistics.median(s["ms"] for s in a["bf16"])
    roofline_lines("17a qwen3-0.6b ZeRO-1 train step [bf16 compute] on (2, "
                   "2), rank 0", t, ms, TRAIN17_BATCH * TRAIN17_SEQ,
                   "qwen3-0.6b", ranks=len(res))
    launches: dict = {}
    for r in res:
        _add(launches, r["17d"]["launches"])
        _add(launches, r["17f"]["launches"])
    return launches


DRYRUN_ARGS = ("--arch", "qwen3-0.6b", "--shape", "train_4k")


def run_dryrun() -> dict:
    """Phase 18: the port's multi-pod dry run of one cell in a subprocess
    (torch's fake process group at world 256, fake tensors; CPU only)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          *DRYRUN_ARGS, "--out", str(ROOT / "build" /
                                                     "dryrun18")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=900)
    return {"rc": out.returncode, "wall_s": time.perf_counter() - t0,
            "lines": out.stdout.splitlines(), "err": out.stderr[-3000:]}


#: The dry run's count for its cell before tensor parallelism (weights
#: gathered whole, every rank of a model group computing its data
#: block's whole forward), and the bound on it now: 1/8 of it (1/16 the
#: ideal).
DRYRUN_FLOPS_WHOLE, DRYRUN_FLOPS_BOUND = 4.57e14, 5.7e13


def report_dryrun(r: dict) -> None:
    import json
    ok = [ln for ln in r["lines"] if ln.startswith("[ok]")]
    flops = None
    art = ROOT / "build" / "dryrun18" / "qwen3-0.6b__train_4k__16_16.json"
    if art.exists():
        flops = json.loads(art.read_text())["raw"]["flops_per_dev"]
    print(f"phase 18 dry run (python -m repro_torch.launch.dryrun "
          f"{' '.join(DRYRUN_ARGS)}, a subprocess on the host's CPU, fake "
          f"tensors on a fake world of 256): exit {r['rc']} in "
          f"{r['wall_s']:.1f} s; {ok[0] if ok else r['lines'][-3:]}; traced "
          f"FLOPs a rank {flops} (weights gathered whole: "
          f"{DRYRUN_FLOPS_WHOLE:.3e}; bound "
          f"{DRYRUN_FLOPS_BOUND:.2e})")
    if r["rc"] != 0 or len(ok) != 1 or flops is None or \
            flops > DRYRUN_FLOPS_BOUND:
        raise AssertionError(f"phase 18 dry run exited {r['rc']}, FLOPs a "
                             f"rank {flops}:\n"
                             f"{chr(10).join(r['lines'][-20:])}\n{r['err']}")


def roofline_lines(what: str, trace: dict, ms: float, tokens: int,
                   arch: str, ranks: int = 1) -> None:
    """Phase 18: a measured step against its roofline on this card:
    ``bundle_from_trace``'s FLOPs, bytes and collective bytes of one
    traced step (per rank) over the H100's peaks (``hw.H100_SXM``), the
    analytic 6ND over the same peak, and the largest term as a share of
    the measured ``ms``.  ``ranks`` processes share the one card: the
    card's compute is their sum."""
    from repro_torch import hw
    from repro_torch.configs.base import get_arch
    from repro_torch.roofline.analysis import model_flops
    chip = hw.H100_SXM
    mf = model_flops(get_arch(arch).model, tokens=tokens, kind="train")
    terms = {"compute": ranks * trace["flops"] / chip.peak_bf16_flops,
             "memory": ranks * trace["bytes"] / chip.hbm_bandwidth,
             "collective": trace["coll_bytes"] / chip.ici_link_bandwidth}
    top = max(terms, key=terms.get)
    print(f"phase 18 roofline {what} on {card_line()}: model_flops (6ND, N "
          f"active params, D {tokens} tokens) {mf:.4e} = {mf / chip.peak_bf16_flops * 1e3:.3f}"
          f" ms at the {chip.peak_bf16_flops:.3e} FLOP/s bf16 peak; traced "
          f"per rank {trace['flops']:.4e} FLOPs, {trace['bytes']:.4e} B "
          f"accessed, {trace['coll_bytes']:.4e} B of collectives; the "
          f"card's terms ({ranks} rank(s) on it) compute "
          f"{terms['compute'] * 1e3:.3f} ms, memory {terms['memory'] * 1e3:.3f}"
          f" ms, collective {terms['collective'] * 1e3:.3f} ms (one NVLink "
          f"link's {chip.ici_link_bandwidth:.3e} B/s; these ranks' "
          f"collectives are gloo through host memory); measured "
          f"{ms:.1f} ms: the roofline ({top}) is "
          f"{terms[top] * 1e3 / ms:.4f} of it, 6ND "
          f"{mf / chip.peak_bf16_flops * 1e3 / ms:.4f}")


def sharded16(rank: int) -> dict:
    """16a-16d on one rank (the same program on every rank)."""
    import torch
    from repro_torch.configs.qwen3_0_6b import config
    from repro_torch.models.transformer import cast_params, init_params
    dev = torch.device("cuda")
    res = {"probe": probe16(rank)}
    t0 = time.perf_counter()
    res["16a"] = vx16(dev, rank)
    res["16a"]["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    cfg = config()
    params = cast_params(init_params(cfg, SEED, device=dev), cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["16b"] = paged16(dev, rank, params, cfg)
    res["16b"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    held = {"params": params}
    del params
    res["16c"] = longctx16(dev, rank, held, cfg)
    res["16c"]["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["16d"] = moe16(dev, rank)
    res["16d"]["s"] = time.perf_counter() - t0
    return res


def sharded_phase(card: str, spawned=None) -> dict:
    """Phases 16 and 17: 16.0-16d and 17.0-17d in one spawn of 4 ranks,
    or the lines of ``spawned`` (:func:`timed_spawn16`'s, run beside
    phases 7-14).  Returns the launches of every rank's sharded runs,
    summed."""
    res, seconds = spawned or timed_spawn16()
    where = (f"{RANKS16} ranks of one gloo group on cuda:0 of {card}; every "
             f"collective is gloo through host memory on one card (no NCCL, "
             f"no NVLink)" + (", beside phases 7-14 and the CLI runs"
                              if spawned else ""))
    probe = [r["probe"] for r in res]
    print(f"phase 16.0 collectives on CUDA tensors under gloo ({where}): "
          f"{probe[0]['ops']}; all_reduce of 64 MiB bf16 "
          f"{statistics.median(p['all_reduce_64MiB_ms'] for p in probe):.3f}"
          f" ms (median over ranks); the port's path uses all_reduce (psum, "
          f"pmax), all_gather_into_tensor (the weights' superblock "
          f"gathers) and reduce_scatter_tensor (MoE's psum_scatter, "
          f"phase 17's ZeRO-1 gradient reduce)")
    r0 = res[0]
    a = r0["16a"]
    print(f"phase 16a sharded vx verbs ({where}): deinterleave / "
          f"interleave of (28, 4, 512, 8, 256) bf16 sharded on the sequence "
          f"(-3), strided gather / scatter of (512, {STRIDED16_N}) bf16 "
          f"lane-sharded over the reference's {len(REF_STRIDED)} (stride, "
          f"offset) pairs scaled by 64 (vl {STRIDED16_VL}), and the "
          f"page gather of (28, 128, 16, 8, 256) bf16 and int8 pools (full, "
          f"partial, unallocated tables) sharded on the page axis, on meshes "
          f"(4,) and (2, 2) under {', '.join(PHASE16_POLICIES)}: bit for bit "
          f"against the same verb run unsharded in one process on every "
          f"rank; pool bytes a rank holds {a['pool_bytes'][1]} of "
          f"{a['pool_bytes'][0]}; launches per rank "
          f"{[r['16a']['launches'] for r in res]} ({a['s']:.1f} s)")
    for key in a["ms"]:
        print(f"phase 16a time {key}: "
              f"{[round(r['16a']['ms'][key], 4) for r in res]} ms per rank "
              f"(CUDA events; the four ranks share the card)")
    b = r0["16b"]
    for impl in ("kernel", "ref"):
        ms = [statistics.median(r["16b"][impl]["ms"]) for r in res]
        print(f"phase 16b qwen3-0.6b paged decode, pool sharded on (4,) "
              f"[{impl}] ({where}): phase 4's prompts prefilled replicated, "
              f"16 greedy steps with pool_shard: logits and streams equal "
              f"to the replicated step's in one process bit for bit; pool "
              f"bytes a rank holds {b[impl]['pool_bytes'][1]} of "
              f"{b[impl]['pool_bytes'][0]}; median ms per step per rank "
              f"{[round(m, 3) for m in ms]}")
    print(f"phase 16b launches per rank {[r['16b']['launches'] for r in res]}"
          f" ({b['s']:.1f} s)")
    c = r0["16c"]
    for tag in ("fused", "per"):
        print(f"phase 16c qwen3-0.6b long-context decode [{tag}] on (2, 2) "
              f"({where}): B 1, {LONG_SEQ} positions (long_500k's 524288 "
              f"cut), len {LONG_LEN}, {LONG_STEPS16} greedy steps; median ms "
              f"per step "
              f"per rank {[round(statistics.median(r['16c'][tag]['ms']), 3) for r in res]}"
              f"; B1 launches per step {c[tag]['b1']}; collectives per rank "
              f"{[r['16c'][tag]['collectives'] for r in res]} over "
              f"{LONG_STEPS16} steps ({c[tag]['collective_bytes']} B, "
              f"{c[tag]['collective_s']:.3f} s of host time on rank 0; "
              f"before tensor parallelism, the weights gathered whole: 85 "
              f"a step), the "
              f"largest {c[tag]['largest']} elements, none cache-sized, no "
              f"model-axis weight gathered; "
              f"peak memory per rank "
              f"{[r['16c'][tag]['peak'] for r in res]} B; KV cache per rank "
              f"{c[tag]['local_cache_bytes']} B of {c['leaf_bytes']} B")
    f32 = c["f32"]
    print(f"phase 16c float32 compute [fused], {F32_STEPS16} greedy steps: "
          f"median ms per step per rank "
          f"{[round(statistics.median(r['16c']['f32']['ms']), 3) for r in res]}"
          f"; collectives per rank "
          f"{[r['16c']['f32']['collectives'] for r in res]}; peak memory "
          f"per rank {[r['16c']['f32']['peak'] for r in res]} B")
    print(f"phase 16c fused == per-access bit for bit over {LONG_STEPS16} "
          f"steps; "
          f"sharded vs the one-process unsharded step: float32 compute, "
          f"largest logit gap {c['gap32']:.3e} within rtol = atol = 3e-3 "
          f"(the reference's; largest |gap| - 3e-3 (1 + |logit|) "
          f"{c['excess32']:.3e}), streams equal {f32['tokens']}; bf16 "
          f"compute, greedy streams equal over {LONG_STEPS16} steps, "
          f"largest logit gap {c['gap']:.6f} (step 0: {c['gap0']:.6f}) "
          f"beside max(0.08, 0.03 * |logits|max) = {c['tol']:.6f} (not "
          f"gated); one ulp of one ln1 entry moves the one-process step-0 "
          f"logits by {c['ulp_gap']:.6f}; "
          f"weights a rank holds "
          f"{c['weight_bytes'][1]} of {c['weight_bytes'][0]} B "
          f"(serve_param_shardings, model axis 2, gathered a layer at a "
          f"time); launches per rank {[r['16c']['launches'] for r in res]} "
          f"({c['s']:.1f} s)")
    d = r0["16d"]
    print(f"phase 16d qwen3-moe-30b-a3b MoE layer, d 2048, 128 experts "
          f"top-8, d_ff 768, x (4, 512, 2048) bf16 on (2, 2) (data, model) "
          f"({where}): max |y - one process| {d['err']:.6f} within the "
          f"bf16 tolerance 1e-2 * max(1, |y|max) (|y|max {d['max']:.4f}); "
          f"aux {d['aux']:.6f}"
          f" vs {d['want_aux']:.6f} (rtol 0.1); units / capacity / dropped "
          f"per rank {[(r['16d']['units'], r['16d']['cap'], r['16d']['dropped']) for r in res]}"
          f" (capacity_slack {d['slack']}: no rank dropped a unit, checked "
          f"before the comparison); "
          f"expert bytes a rank holds {d['expert_bytes'][1]} of "
          f"{d['expert_bytes'][0]}; ms per call per rank "
          f"{[round(r['16d']['ms'], 3) for r in res]} against "
          f"{d['one_ms']:.3f} in one process ({d['s']:.1f} s)")
    launches = {}
    for r in res:
        for part in ("16a", "16b", "16c"):
            _add(launches, r[part]["launches"])
    print(f"phase 16: {seconds - r0['17']['s']:.1f} s; launches of the "
          f"sharded runs, all ranks {launches}")
    more = train_phase_lines([r["17"] for r in res], where)
    print(f"phase 17: {r0['17']['s']:.1f} s; launches of the batch-sharded "
          f"prefill and kernel decode, all ranks {more}")
    _add(launches, more)
    return launches


def training_phase(card: str) -> dict:
    """Phase 17 alone: :func:`timed17` on ``RANKS16`` spawned ranks, its
    lines.  Returns the launches of its batch-sharded runs, summed."""
    res = spawn16(timed17)
    where = (f"{RANKS16} ranks of one gloo group on cuda:0 of {card}; every "
             f"collective is gloo through host memory on one card (no NCCL, "
             f"no NVLink), phase 17 alone")
    launches = train_phase_lines(res, where)
    print(f"phase 17: {res[0]['s']:.1f} s; launches of the batch-sharded "
          f"prefill and kernel decode, all ranks {launches}")
    return launches


def profile_policies(runs: dict) -> None:
    """``--profile``: where each policy's serve run spends its time, from
    torch.profiler traces of one whole run (prefill and decode) per policy.
    Prints each run's host wall time, device busy time (device events only:
    an operator's row repeats its kernels' time), host time inside
    operators, and kernel launches; then the operators whose host and
    device times differ most between the ``kernel`` and ``ref`` runs."""
    from torch.autograd import DeviceType
    host, device = {}, {}
    for impl, r in runs.items():
        ka = r["prof"].key_averages()
        device[impl] = {e.key: e.self_device_time_total / 1e3 for e in ka
                        if e.device_type == DeviceType.CUDA}
        host[impl] = {e.key: e.self_cpu_time_total / 1e3 for e in ka
                      if e.device_type == DeviceType.CPU}
        wall_ms = r["wall_s"] * 1e3
        dev_ms = sum(device[impl].values())
        op_ms = sum(host[impl].values())
        launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
        what = r.get("label") or (f"{r['prefill_chunks']} prefill chunks "
                                  f"+ {r['decode_steps']} decode steps")
        print(f"profile[{impl}]: {what} in {wall_ms:.3f} ms (host "
              f"clock, traced); device busy {dev_ms:.3f} ms = "
              f"{dev_ms / wall_ms:.4f} of the run; host self time in "
              f"operators {op_ms:.3f} ms, outside them {wall_ms - op_ms:.3f} "
              f"ms; {launches} cudaLaunchKernel")
    for kind, table in (("host", host), ("device", device)):
        k, rf = table["kernel"], table["ref"]
        keys = sorted(set(k) | set(rf),
                      key=lambda x: -abs(k.get(x, 0.0) - rf.get(x, 0.0)))
        for key in keys[:12]:
            a, b = k.get(key, 0.0), rf.get(key, 0.0)
            print(f"  {kind} {key[:72]}: kernel {a:.3f} ms, ref {b:.3f} ms,"
                  f" kernel-ref {a - b:+.3f} ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs.qwen3_0_6b import config
    from repro_torch.kernels import _common, strided
    from repro_torch.models.transformer import init_params

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _common.build_all(_common.SOURCES)
    print(f"build: {', '.join(f'{s}.cu' for s in _common.SOURCES)} (with "
          f"the shared headers route_plan.cuh, route_dyn.cuh and "
          f"perm_copy.cuh) in parallel in "
          f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    cases = check_kernels(dev)
    print(f"kernels == plain: {cases} cases x 2 segment kernels bit-exact "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cases = check_strided(dev)
    print(f"kernels == plain: {cases} strided cases (B3 and B5 together, "
          f"B4 alone) bit-exact ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cases = check_views(dev)
    print(f"kernels on views == plain: {cases} cases (B1-B14 and the vx "
          f"Strided / Segment verbs, each on a transposed view and on a "
          f"last-dim slice of a wider tensor, against contiguous copies) "
          f"bit-exact ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    cases = check_dynamic(dev)
    print(f"dynamic kernels == plain == plan twin: {cases} cases (B6 and B7 "
          f"together, B8 and B9 together, B8 x4 against B4, the derivation "
          f"against layer_masks, B6's, B7's, B8's and B9's device source "
          f"tables against dyn_sources_plain, B7's merged table against "
          f"interleave_dynamic_table, B9's device list against "
          f"merge_pairs) bit-exact ({time.perf_counter() - t0:.1f} s)")

    cfg = config()
    slots, max_len, page_size, gen = 4, 512, 16, 16
    timing = time_kernels(dev, cfg, slots, max_len)

    prompts = phase4_prompts(cfg.vocab, slots)
    params = init_params(cfg, SEED, device=dev)
    # the host clock drifts within a call, and this order puts every
    # policy at the same mean position
    order = ("kernel", "ref", "kernel_dynamic", "kernel_dynamic", "ref",
             "kernel")
    runs = [(impl, serve(dev, cfg, params, impl, prompts, gen, slots,
                         max_len, page_size)) for impl in order]
    for impl, r in runs:
        decode_s = sum(r["step_ms"]) / 1e3
        print(f"serve[{impl}] {cfg.name} on {card}: generated tokens/s over "
              f"the whole run (prefill included) "
              f"{r['tokens'] / r['wall_s']:.2f} ({r['tokens']} tokens in "
              f"{r['wall_s']:.3f} s); decode-step tokens/s "
              f"{sum(r['step_tokens']) / decode_s:.2f} "
              f"({sum(r['step_tokens'])} tokens in {decode_s:.3f} s of "
              f"decode steps); median decode step "
              f"{statistics.median(r['step_ms']):.3f} ms over "
              f"{r['decode_steps']} steps; {r['prefill_chunks']} prefill "
              f"chunks; launches {r['launches']}")
    kr = runs[0][1]
    dr = runs[2][1]
    for impl, r in runs[1:]:
        if r["streams"] != kr["streams"]:
            raise AssertionError(f"{impl} gave other token streams than the "
                                 f"first kernel run")
    plan = ("deinterleave", "interleave")
    dynamic = ("deinterleave_dynamic", "interleave_dynamic")
    for impl, r in runs:
        mine, other, split = {"kernel": (plan, dynamic, (1, 0)),
                              "kernel_dynamic": (dynamic, plan, (0, 1)),
                              "ref": ((), plan + dynamic, None)}[impl]
        if any(r["launches"][k] <= 0 for k in mine):
            raise AssertionError(f"{impl}: a kernel never launched on the "
                                 f"main path: {r['launches']}")
        if any(r["launches"][k] != 0 for k in other):
            raise AssertionError(f"{impl} launched another policy's "
                                 f"kernels: {r['launches']}")
        if split and any(n != split for n in r["step_launches"]):
            raise AssertionError(f"{impl}: fused split launches (B1, B6) per "
                                 f"decode step: {r['step_launches']}")
        first = kr if impl == "kernel" else dr
        if impl != "ref" and r["launches"] != first["launches"]:
            raise AssertionError(f"{impl} runs launched differently: "
                                 f"{r['launches']} vs {first['launches']}")
    print(f"streams equal under kernel, ref and kernel_dynamic; one fused "
          f"split launch in each of {len(kr['step_launches'])} decode steps "
          f"(B1 under kernel, B6 under kernel_dynamic)")
    if "--profile" in sys.argv[1:]:
        profile_policies({impl: serve(dev, cfg, params, impl, prompts, gen,
                                      slots, max_len, page_size,
                                      profiled=True)
                          for impl in ("kernel", "ref")})
    del params
    torch.cuda.empty_cache()

    kv_shape = (cfg.n_superblocks, slots, max_len, cfg.n_kv_heads,
                2 * cfg.hd)
    t0 = time.perf_counter()
    path = {impl: strided_path(dev, kv_shape, impl)
            for impl in ("kernel", "ref", "kernel_dynamic")}
    for impl in ("kernel", "kernel_dynamic"):
        for key, out in path[impl]["outs"].items():
            if not same_bits(out, path["ref"]["outs"][key]):
                raise AssertionError(f"strided path: {key} differs between "
                                     f"{impl} and ref")
    pk, pr, pd = path["kernel"], path["ref"], path["kernel_dynamic"]
    splan = tuple(f.__name__ for f in strided.KERNELS)
    sdyn = tuple(f.__name__ for f in strided.DYNAMIC)
    if max(pr["launches"].values()) != 0 or max(pr["group"].values()) != 0:
        raise AssertionError(f"ref policy launched strided kernels: "
                             f"{pr['launches']}")
    for impl, p, mine, other in (("kernel", pk, splan, sdyn),
                                 ("kernel_dynamic", pd, sdyn, splan)):
        if any(p["launches"][k] <= 0 for k in mine):
            raise AssertionError(f"{impl}: a strided kernel never launched "
                                 f"on the strided path: {p['launches']}")
        if any(p["launches"][k] != 0 for k in other):
            raise AssertionError(f"{impl} launched another policy's strided "
                                 f"kernels: {p['launches']}")
    if pk["group"] != {"gather_strided_fused": 1,
                       "gather_strided_dynamic": 0}:
        raise AssertionError(f"StepScheduler strided group under kernel: "
                             f"{pk['group']}, want one B4 launch")
    if pd["group"] != {"gather_strided_fused": 0,
                       "gather_strided_dynamic": len(HETERO)}:
        raise AssertionError(f"StepScheduler strided group under "
                             f"kernel_dynamic: {pd['group']}, want "
                             f"{len(HETERO)} B8 launches")
    print(f"strided path: {len(pk['outs'])} outputs equal under kernel, ref "
          f"and kernel_dynamic and to plain indexing; launches kernel "
          f"{pk['launches']}, kernel_dynamic {pd['launches']}, ref "
          f"{pr['launches']}; the 4-request StepScheduler group made one B4 "
          f"launch under kernel and {len(HETERO)} B8 launches under "
          f"kernel_dynamic ({time.perf_counter() - t0:.1f} s)")

    ipk = indexed_phase(dev, kv_shape, timing)
    global BACKGROUND
    BACKGROUND = Background()
    BACKGROUND.start_spawn()
    # first in the CLI queue: the longest subprocess (18)
    cli_runs((report_dryrun, run_dryrun))
    twins_phase(card)
    dense_phase(dev, cfg, card, slots, page_size)
    quant_prefix_phase(dev, cfg, card, prompts, gen, slots, max_len,
                       page_size, timing)
    chaos_fleet_phase(dev, cfg, card, prompts, gen, slots, max_len,
                      page_size)

    launches = {k: kr["launches"][k] for k in plan}
    launches.update({k: dr["launches"][k] for k in dynamic})
    speculative_phase(dev, cfg, card, prompts, gen, slots, max_len,
                      page_size, timing, launches)
    cli_cell(card)
    BACKGROUND.start()
    for k, n in family_phase(dev, card, slots, max_len, page_size,
                             gen).items():
        launches[k] += n
    for k, n in recurrent_phase(dev, card, slots, max_len, page_size,
                                gen).items():
        launches[k] += n
    for k, n in encdec_train_phase(dev, card).items():
        launches[k] += n
    sharded = BACKGROUND.join(card)
    for k, n in launcher_phase(dev, card).items():
        launches[k] += n
    launches.update({k: pk["launches"][k] for k in splan})
    launches.update({k: pd["launches"][k] for k in sdyn})
    launches.update(ipk)
    for k, n in sharded.items():
        launches[k] += n
    for k, n in TWIN_LAUNCHES.items():
        launches[k] += n
    print(f"phase 19 launches of the twins, all runs "
          f"{ {k: n for k, n in TWIN_LAUNCHES.items() if n} }")
    kernels = []
    for name in REPLACES:
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
