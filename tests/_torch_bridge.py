"""Helpers shared by the port's parity tests (tests/test_torch_*.py): move
arrays between JAX and torch through NumPy, compare bits, and gate the
cases that need a CUDA card."""
from __future__ import annotations

import numpy as np
import pytest
import torch


def to_torch(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def bits(x) -> np.ndarray:
    """Integer view of an array (NumPy, JAX or torch) for bit-exact
    comparison: equal bits, NaN payloads included."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()]).numpy().view(
            {1: np.uint8, 2: np.uint16, 4: np.uint32,
             8: np.uint64}[t.element_size()])
    a = np.ascontiguousarray(np.asarray(x))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def assert_bits_equal(got, want) -> None:
    g, w = bits(got), bits(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_array_equal(g, w)


def jax_tree_to_np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def cuda_device():
    """The card for kernel-against-plain cases; skips without one (decided
    here, at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segment kernels run only there")
    return torch.device("cuda")
