"""How far the seeded xlstm-125m moves in bf16: the reference beside the
port, with the reference's weights, on the CPU.

Two measures on each side, in bf16 and in float32:

- the one-ulp probe: the prefill logits of 4 x 64 numpy-seeded tokens with
  the first entry of the first block's ``ln1`` moved up by one ulp of the
  compute dtype, against the unmoved ones;
- the dense path against the paged one: the dense prefill of the 4 x 64
  tokens and 8 forced dense decode steps, against page-sized paged prefill
  chunks of each prompt but its last token, a paged decode step fed it and
  the same 8 forced paged steps (max_len 512, page 16, caches in the
  compute dtype).  The largest logit gap and the largest |logit|.

If the reference moves as far as the port under both, the bf16 gap is the
model's own sensitivity and not a fault of the port.  The stack is cut in
depth (``--layers``, default 6: one superblock of 5 mLSTM + 1 sLSTM of the
published 12 layers) to keep this run small; widths are the published
ones.  Prints one JSON line.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_xlstm_bf16_witness.py
"""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_bridge import jax_tree_to_np
from repro.configs import base as jbase
from repro.models import decode as jdec
from repro.models import transformer as jtf
from repro_torch.configs import base
from repro_torch.models import decode as dec
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import ServeConfig, jit_decode_step, jit_prefill

SLOTS, PROMPT, STEPS, MAX_LEN, PAGE = 4, 64, 8, 512, 16


def inputs(vocab: int):
    rng = np.random.default_rng(12)
    return (rng.integers(0, vocab, (SLOTS, PROMPT)).astype(np.int32),
            rng.integers(0, vocab, (STEPS, SLOTS)).astype(np.int32))


def nudged(value: float, dtype: str) -> float:
    """``value`` rounded to ``dtype``, then one ulp of ``dtype`` up."""
    t = torch.tensor(value, dtype=torch.float32).to(getattr(torch, dtype))
    return float(torch.nextafter(t, torch.full_like(t, float("inf"))))


def gap_of(pairs) -> tuple:
    gap = scale = 0.0
    for a, b in pairs:
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        gap = max(gap, float(np.abs(a - b).max()))
        scale = max(scale, float(np.abs(b).max()))
    return gap, scale


def reference(jcfg, jparams, tokens, forced, dtype: str) -> dict:
    jd = jnp.dtype(dtype)
    prefill = jax.jit(lambda p, t: jtf.forward(
        p, {"tokens": t}, jcfg, None, mode="prefill"))
    logits, _, states = prefill(jparams, jnp.asarray(tokens))
    ln = jparams["blocks"]["pos0"]["ln1"]
    moved = dict(jparams, blocks=dict(jparams["blocks"], pos0=dict(
        jparams["blocks"]["pos0"],
        ln1=ln.at[0, 0].set(nudged(float(ln[0, 0]), dtype)))))
    ulp = float(jnp.abs(prefill(moved, jnp.asarray(tokens))[0]
                        .astype(jnp.float32)
                        - logits.astype(jnp.float32)).max())
    dense = jdec.cache_from_prefill(jcfg, states, PROMPT, MAX_LEN, jd)
    step = jax.jit(lambda p, c, t: jdec.decode_step(p, c, t, jcfg, None))
    chunk = jax.jit(lambda p, c, t, s, n: jdec.paged_prefill_chunk(
        p, c, t, jcfg, None, slot=s, count=n))
    pstep = jax.jit(lambda p, c, t: jdec.paged_decode_step(p, c, t, jcfg,
                                                           None))
    paged = jdec.init_paged_cache(jcfg, SLOTS, MAX_LEN, PAGE, jd)
    for s in range(SLOTS):
        for c in range(0, PROMPT - 1, PAGE):
            n = min(PAGE, PROMPT - 1 - c)
            tok = np.zeros((PAGE,), np.int32)
            tok[:n] = tokens[s, c:c + n]
            paged = chunk(jparams, paged, jnp.asarray(tok), s, n)
    dl = logits[:, 0]
    pl, paged = pstep(jparams, paged, jnp.asarray(tokens[:, -1]))
    pairs = [(pl, dl)]
    for t in forced:
        dl, dense = step(jparams, dense, jnp.asarray(t))
        pl, paged = pstep(jparams, paged, jnp.asarray(t))
        pairs.append((pl, dl))
    gap, scale = gap_of(pairs)
    return {"ulp_moves_logits_by": ulp, "dense_vs_paged_gap": gap,
            "logits_absmax": scale}


def port(cfg, params, tokens, forced, dtype: str) -> dict:
    cd = getattr(torch, dtype)
    tokens, forced = torch.from_numpy(tokens), torch.from_numpy(forced)
    prefill = jit_prefill(cfg, None, device="cpu")
    logits, states = prefill(params, {"tokens": tokens})
    ln = params["blocks"]["pos0"]["ln1"]
    old = ln[0, 0].clone()
    ln[0, 0] = nudged(float(old), dtype)
    ulp = float((prefill(params, {"tokens": tokens})[0].float()
                 - logits.float()).abs().max())
    ln[0, 0] = old
    dense = dec.cache_from_prefill(cfg, states, PROMPT, MAX_LEN, cd)
    step = jit_decode_step(cfg, None, ServeConfig(max_len=MAX_LEN),
                           device="cpu")
    paged = dec.init_paged_cache(cfg, SLOTS, MAX_LEN, PAGE, cd,
                                 device="cpu")
    for s in range(SLOTS):
        for c in range(0, PROMPT - 1, PAGE):
            n = min(PAGE, PROMPT - 1 - c)
            tok = torch.zeros((PAGE,), dtype=torch.int32)
            tok[:n] = tokens[s, c:c + n]
            paged = dec.paged_prefill_chunk(params, paged, tok, cfg, slot=s,
                                            count=n)
    dl = logits[:, 0]
    pl, paged = dec.paged_decode_step(params, paged, tokens[:, -1], cfg)
    pairs = [(pl.float().numpy(), dl.float().numpy())]
    for t in forced:
        dl, dense = step(params, dense, t)
        pl, paged = dec.paged_decode_step(params, paged, t, cfg)
        pairs.append((pl.float().numpy(), dl.float().numpy()))
    gap, scale = gap_of(pairs)
    return {"ulp_moves_logits_by": ulp, "dense_vs_paged_gap": gap,
            "logits_absmax": scale}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.manual_seed(args.seed)
    jbase_cfg = jbase.get_arch("xlstm-125m").model
    pbase_cfg = base.get_arch("xlstm-125m").model
    jparams = jtf.init_params(
        dataclasses.replace(jbase_cfg, n_layers=args.layers),
        jax.random.key(args.seed))
    out = {"layers": args.layers, "seed": args.seed}
    for dtype in ("bfloat16", "float32"):
        jcfg = dataclasses.replace(jbase_cfg, n_layers=args.layers,
                                   compute_dtype=dtype, kernel_impl="ref")
        cfg = dataclasses.replace(pbase_cfg, n_layers=args.layers,
                                  compute_dtype=dtype, kernel_impl="ref")
        params = tf.params_from_jax(jax_tree_to_np(jparams), cfg,
                                    device="cpu")
        tokens, forced = inputs(cfg.vocab)
        out[dtype] = {
            "reference": reference(jcfg, jparams, tokens, forced, dtype),
            "port": port(cfg, params, tokens, forced, dtype)}
        print(json.dumps({dtype: out[dtype]}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
