"""Deterministic, checkpointable, host-sharded synthetic data pipeline.

Port of ``repro``'s ``data/pipeline.py``.  Every (step, host) pair maps to
a unique, reproducible slice of the global batch; state is two integers,
so checkpoint/restore and elastic rescale (a different host count on
restart) are exact.  The fields come from numpy's generator on the
reference's ``(seed << 20) + step`` stream, so the port's buffers and
batches equal the reference's bit for bit.

Records flow through the AoS format (``data/aos.py``): the loader packs
the interleaved buffer on the pipeline's device (``vx`` segment store),
the model side unpacks it (segment load), each lowered by the active
``vx.Policy``.  ``next_host_aos`` returns numpy; ``next_batch`` returns
tensors on the device.  ``device`` defaults to the card
(:func:`repro_torch.device.resolve`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import aos
from repro_torch.device import resolve as resolve_device


@dataclasses.dataclass
class PipelineState:
    step: int
    seed: int

    def to_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineState":
        return cls(step=int(d["step"]), seed=int(d["seed"]))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticAoSPipeline:
    """Yields per-host AoS shards of a deterministic global batch."""

    def __init__(self, cfg: DataConfig, *, process_index: int = 0,
                 process_count: int = 1, device=None):
        assert cfg.global_batch % process_count == 0
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.device = resolve_device(device)
        self.state = PipelineState(step=0, seed=cfg.seed)

    @property
    def host_batch(self) -> int:
        return self.cfg.global_batch // self.process_count

    def _global_fields_np(self, step: int):
        """Deterministic SoA fields for ``step`` (numpy host arrays)."""
        cfg = self.cfg
        rng = np.random.default_rng((self.state.seed << 20) + step)
        toks = rng.integers(0, cfg.vocab, (cfg.global_batch, cfg.seq_len),
                            dtype=np.int32)
        labels = np.roll(toks, -1, axis=1)
        weights = np.ones((cfg.global_batch, cfg.seq_len), np.float32)
        weights[:, -1] = 0.0  # no loss on the rolled-around label
        docs = np.full((cfg.global_batch, cfg.seq_len), step, np.int32)
        return toks, labels, weights, docs

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _global_batch_np(self, step: int) -> np.ndarray:
        """The full deterministic AoS global batch for ``step`` (numpy),
        packed on the pipeline's device."""
        fields = self._global_fields_np(step)
        buf = aos.pack_records(*(self._tensor(f) for f in fields))
        return buf.cpu().numpy()

    def next_host_aos(self) -> np.ndarray:
        """(host_batch, 4*S) AoS shard for this host; advances state."""
        full = self._global_batch_np(self.state.step)
        lo = self.process_index * self.host_batch
        shard = full[lo:lo + self.host_batch]
        self.state.step += 1
        return shard

    def next_batch(self, *, fused: bool = True, policy=None) -> dict:
        """SoA batch dict for this host, on the device; advances state.

        ``fused=True`` elides the producer-side segment store and the
        consumer-side segment load of the same step
        (:func:`data.aos.pack_unpack_fused`): no segment op runs, so
        ``policy`` only affects the ``fused=False`` path, which packs the
        global batch (``next_host_aos``) and unpacks this host's shard.
        Both give the same batch bit for bit and the same state."""
        if not fused:
            batch = aos.unpack_records(self._tensor(self.next_host_aos()),
                                       policy=policy)
            batch.pop("doc_id")
            return batch
        fields = self._global_fields_np(self.state.step)
        lo = self.process_index * self.host_batch
        hi = lo + self.host_batch
        self.state.step += 1
        batch = aos.pack_unpack_fused(
            *(self._tensor(f[lo:hi]) for f in fields))
        batch.pop("doc_id")
        return batch

    # -- checkpointing ------------------------------------------------------
    def state_dict(self) -> dict:
        return self.state.to_dict()

    def load_state_dict(self, d: dict) -> None:
        self.state = PipelineState.from_dict(d)
