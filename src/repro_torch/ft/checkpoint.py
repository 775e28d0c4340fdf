"""Atomic, async checkpointing on one device.

Port of ``repro``'s ``ft/checkpoint.py``, in the reference's format, leaf
for leaf, so that each package restores the other's checkpoints.  Layout:
``<dir>/step_<N>/`` holding ``proc<k>.npz`` and ``manifest.json`` (step,
the ``/``-joined leaf paths, shapes, numpy dtype names, and ``extra``,
e.g. the data pipeline's state).  Leaves are ordered as
``jax.tree_util`` flattens a tree: dict keys sorted, sequence items by
index, ``None`` holds no leaf.  Writes go to ``step_<N>.tmp<k>`` and are
renamed only after the manifest's fsync, so a crash mid-save never
corrupts the latest checkpoint.  Saving runs on a background thread;
``wait()`` joins it.

``save`` copies every leaf to host memory before it returns, on the CPU
as on the card: the train step updates its state in place, and a
background write of storage the next step overwrites would tear the
checkpoint.  A bfloat16 leaf is written as the reference writes it (a
2-byte void array, ``bfloat16`` in the manifest), and its restore raises
:class:`CheckpointError` in both packages.  ``restore`` places each leaf
on its template leaf's device, in the dtype it was saved in.  Sharded
placement waits for ``dist`` (item 9h).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import types
from typing import Any

import numpy as np
import torch

from repro_torch.device import refuse_mesh


class CheckpointError(RuntimeError):
    """A checkpoint step dir is torn or corrupted (missing
    ``manifest.json``, truncated ``.npz``, missing arrays), or no intact
    checkpoint exists at all.  Typed so callers can catch restore
    failures without fishing ``JSONDecodeError`` / ``OSError`` /
    ``KeyError`` out of the storage layer."""


def _leaves_with_paths(tree: Any, prefix: tuple = ()) -> list:
    """``[(path keys, leaf)]`` in ``jax.tree_util``'s flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _path(keys: tuple) -> str:
    return "/".join(str(k) for k in keys)


def _host_copy(leaf: Any) -> tuple[np.ndarray, str]:
    """(a numpy copy of ``leaf`` that shares no storage with it, its
    numpy dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _place(arr: np.ndarray, like: Any) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, directory: str, *, process_index: int = 0,
                 keep: int = 3):
        self.dir = directory
        self.process_index = process_index
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, extra: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write asynchronously."""
        arrays, dtypes = {}, {}
        for keys, leaf in _leaves_with_paths(tree):
            p = _path(keys)
            arrays[p], dtypes[p] = _host_copy(leaf)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, arrays, dtypes, extra or {}),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, arrays: dict[str, np.ndarray],
               dtypes: dict[str, str], extra: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + f".tmp{self.process_index}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"proc{self.process_index}.npz"), **arrays)
        manifest = {
            "step": step,
            "paths": sorted(arrays),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": dtypes,
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(
                    tuple(f".tmp{i}" for i in range(1024))):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self, *, intact: bool = False) -> int | None:
        """Newest step by directory listing; ``intact=True`` additionally
        verifies the step dir is readable (manifest parses, this
        process's ``.npz`` loads) and skips torn ones."""
        steps = self.all_steps()
        if not intact:
            return steps[-1] if steps else None
        for s in reversed(steps):
            try:
                self._read_step(s)[1].close()
            except CheckpointError:
                continue
            return s
        return None

    def _read_step(self, step: int) -> tuple[dict, Any]:
        """(manifest, npz) of one step dir; :class:`CheckpointError` on a
        torn or corrupted dir instead of raw ``JSONDecodeError`` /
        ``OSError`` / ``zipfile.BadZipFile``."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            data = np.load(os.path.join(d, f"proc{self.process_index}.npz"))
            # touch the member list now: a truncated zip can open fine
            # and only fail when an array is first read
            data.files  # noqa: B018
        except CheckpointError:
            raise
        except Exception as e:  # noqa: BLE001 — typed storage boundary
            raise CheckpointError(
                f"checkpoint step {step} at {d} is torn or corrupted: "
                f"{type(e).__name__}: {e}") from e
        return manifest, data

    def restore(self, template: Any, *, step: int | None = None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``template``, each leaf on its
        template leaf's device.  ``shardings`` (the elastic path's
        per-leaf placement) waits for ``dist``: anything but ``None`` is
        refused.

        ``step=None`` restores the newest INTACT step: a torn latest dir
        (crash mid-write that survived the atomic-rename discipline, a
        bad disk) falls back to the next-newest step that loads cleanly.
        An explicit ``step`` is restored exactly or raises
        :class:`CheckpointError` — falling back silently from a step the
        caller named would be wrong."""
        if shardings is not None:
            refuse_mesh(types.SimpleNamespace(mesh=shardings))
        if step is not None:
            manifest, data = self._read_step(step)
        else:
            steps = self.all_steps()
            if not steps:
                raise CheckpointError(f"no checkpoint found in {self.dir}")
            last_err: CheckpointError | None = None
            for s in reversed(steps):
                try:
                    manifest, data = self._read_step(s)
                    break
                except CheckpointError as e:
                    last_err = e
            else:
                raise CheckpointError(
                    f"no intact checkpoint in {self.dir} "
                    f"(tried steps {steps})") from last_err
        restored = {}
        try:
            for keys, leaf in _leaves_with_paths(template):
                restored[keys] = _place(data[_path(keys)], leaf)
        except Exception as e:  # noqa: BLE001 — truncated member payload
            raise CheckpointError(
                f"checkpoint step {manifest.get('step', '?')} is torn or "
                f"corrupted: {type(e).__name__}: {e}") from e
        finally:
            data.close()
        return _rebuild(template, restored), manifest["extra"]


def _rebuild(template: Any, restored: dict, prefix: tuple = ()) -> Any:
    """``template``'s structure with each leaf replaced by
    ``restored[path keys]``."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, restored, prefix + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, restored, prefix + (i,))
                              for i, v in enumerate(template))
    return restored[prefix]
