"""Port parity for the shared quantization helpers (``core/quant.py``):
``quantize`` / ``requantize`` / ``dequantize`` / ``scale_for`` /
``roundtrip`` against ``repro.core.quant`` on numpy-seeded inputs, bit for
bit, for int8 and fp8 (float8_e4m3fn), zero scales and extremes included;
the casts float32 <-> fp8 of XLA and torch on random data in both
directions of the rounding and at the subnormal floor; and the port of
``tests/test_quant.py``'s own cases (round-trip bounds, zero-scale
safety, the fp8 gate).  No tolerance: every comparison is of bits, except
the round-trip bound cases, which hold the reference's own bound.  The
compression-delegation case (``optim/compression._int8_roundtrip``) is
ported with the optimizer, in tests/test_torch_train.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import assert_bits_equal, to_torch
from repro.core import quant as jquant
from repro_torch.core import quant

DTYPES = ("int8", "float8_e4m3fn")
JDT = {"int8": jnp.int8, "float8_e4m3fn": jnp.float8_e4m3fn}


def _x(seed, n=4096, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * scale).astype(np.float32)


# --------------------------- name plumbing ----------------------------------

def test_canonical_aliases_and_rejection():
    assert quant.canonical("fp8") == "float8_e4m3fn"
    assert quant.canonical("e5m2") == "float8_e5m2"
    assert quant.canonical("int8") == "int8"
    assert quant.canonical(np.dtype(np.int8)) == "int8"
    assert quant.canonical(torch.int8) == "int8"
    with pytest.raises(ValueError, match="unsupported quantized dtype"):
        quant.canonical("int4")
    assert not quant.supported("int4")
    assert quant.supported("int8")
    assert quant.supported("fp8") == hasattr(torch, "float8_e4m3fn")
    assert quant._QMAX == jquant._QMAX
    assert quant._REL_ERR == jquant._REL_ERR
    assert quant._ALIASES == jquant._ALIASES


def test_qmax_values_and_pool_dtypes():
    assert quant.qmax("int8") == 127.0
    assert quant.qmax("float8_e4m3fn") == 448.0
    assert quant.qmax(torch.int8) == 127.0
    assert quant.qmax(np.int8) == 127.0
    assert quant.pool_dtype("int8") is torch.int8
    assert quant.pool_dtype("fp8") is torch.float8_e4m3fn
    assert float(torch.finfo(quant.pool_dtype("fp8")).max) == 448.0
    for dt in DTYPES + ("float8_e5m2",):
        assert quant.error_bound(dt, 3.0) == jquant.error_bound(dt, 3.0)


# --------------------------- bits against the reference ---------------------

@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("mag", [1e-6, 1.0, 3e3])
def test_quantize_dequantize_match_reference(dt, mag):
    """Per-row scales (one row all zero: scale 0), quantize, dequantize and
    the scale itself, bit for bit."""
    x = _x(1, 8 * 64, mag).reshape(8, 64)
    x[3] = 0.0
    sj = jquant.scale_for(jnp.asarray(x), dt, axis=1, keepdims=True)
    st = quant.scale_for(to_torch(x), dt, axis=1, keepdims=True)
    assert_bits_equal(st, sj)
    qj = jquant.quantize(jnp.asarray(x), sj, dt)
    qt = quant.quantize(to_torch(x), st, dt)
    assert qt.dtype == quant.pool_dtype(dt)
    assert_bits_equal(quant.raw(qt), np.asarray(qj).view(np.uint8)
                      if dt != "int8" else qj)
    assert_bits_equal(quant.dequantize(qt, st),
                      jquant.dequantize(qj, sj))
    assert_bits_equal(quant.roundtrip(to_torch(x), quant.pool_dtype(dt)),
                      jquant.roundtrip(jnp.asarray(x), JDT[dt]))


@pytest.mark.parametrize("dt", DTYPES)
def test_requantize_extremes_and_bf16_match_reference(dt):
    """Clipping past +-qmax, round half to even at .5 steps, -0.0, and a
    bfloat16 operand divided by a float32 scale (the decode step's beat)."""
    qm = quant.qmax(dt)
    y = np.asarray([-1e9, -qm - 1, -qm, -2.5, -0.5, -0.0, 0.0, 0.5, 1.5,
                    2.5, 126.5, qm, qm + 0.25, 1e9], np.float32)
    jr = jquant.requantize(jnp.asarray(y), dt)
    tr = quant.requantize(to_torch(y), dt)
    assert_bits_equal(quant.raw(tr), np.asarray(jr).view(np.uint8)
                      if dt != "int8" else jr)
    xb = jnp.asarray(_x(2, 256, 7.0)).astype(jnp.bfloat16)
    s = jnp.asarray(np.float32(0.03125))
    jq = jquant.quantize(xb, s, dt)
    tq = quant.quantize(to_torch(np.asarray(xb)), to_torch(np.asarray(s)),
                        dt)
    assert_bits_equal(quant.raw(tq), np.asarray(jq).view(np.uint8)
                      if dt != "int8" else jq)


def test_fp8_casts_match_xla_both_ways():
    """float32 -> float8_e4m3fn after the clip to +-448, on random data
    that rounds both ways, exact ties, and the subnormal floor (2**-9 and
    below); and every one of the 256 fp8 codes back to float32 (NaN codes
    compared as NaN)."""
    rng = np.random.default_rng(3)
    mant = rng.integers(0, 1 << 23, 20000)
    ties = ((1 << 23) | (mant & ~((1 << 20) - 1)) | (1 << 19)).astype(
        np.float32) * 2.0 ** -23          # halfway between two e4m3 codes
    x = np.concatenate([
        rng.normal(size=20000).astype(np.float32) * 100,
        rng.uniform(-448, 448, 20000).astype(np.float32),
        (rng.normal(size=20000) * 2.0 ** -8).astype(np.float32),
        (rng.normal(size=20000) * 2.0 ** -11).astype(np.float32),
        ties * rng.choice([-1.0, 1.0], 20000).astype(np.float32),
        np.asarray([2.0 ** -9, 2.0 ** -10, 1.5 * 2.0 ** -10, 3 * 2.0 ** -11,
                    2.0 ** -6, 448.0, -448.0, 0.0, -0.0], np.float32)])
    x = np.clip(x, -448, 448)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(
        np.uint8)
    got = quant.raw(to_torch(x).to(torch.float8_e4m3fn)).numpy()
    np.testing.assert_array_equal(got, want)
    codes = np.arange(256, dtype=np.uint8)
    back_j = np.asarray(jnp.asarray(codes.view(jnp.float8_e4m3fn)).astype(
        jnp.float32))
    back_t = torch.from_numpy(codes).view(torch.float8_e4m3fn).to(
        torch.float32).numpy()
    np.testing.assert_array_equal(back_t, back_j)     # NaN == NaN here


# --------------------------- the reference's own cases ----------------------

@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e3])
def test_roundtrip_error_within_per_dtype_bound(dt, scale):
    x = to_torch(_x(0, 512, scale))
    y = quant.roundtrip(x, quant.pool_dtype(dt))
    bound = quant.error_bound(dt, float(x.abs().max()))
    err = float((x - y).abs().max())
    assert np.isfinite(err)
    assert err <= bound * (1 + 1e-6), (dt, scale, err, bound)


@pytest.mark.parametrize("dt", DTYPES)
def test_roundtrip_extremes_map_exactly(dt):
    x = torch.tensor([-7.5, 0.0, 7.5])
    y = quant.roundtrip(x, quant.pool_dtype(dt))
    np.testing.assert_allclose(y.numpy()[[0, 2]], [-7.5, 7.5], rtol=1e-6)
    assert float(y[1]) == 0.0


@pytest.mark.parametrize("dt", DTYPES)
def test_zero_scale_writes_zero_never_nan(dt):
    z = torch.zeros(8)
    q = quant.quantize(z, torch.tensor(0.0), dt)
    assert not bool(torch.isnan(q.to(torch.float32)).any())
    np.testing.assert_array_equal(
        quant.roundtrip(z, quant.pool_dtype(dt)).numpy(), np.zeros(8))


def test_scale_for_axis_and_eps():
    x = torch.tensor([[1.0, -4.0], [0.0, 0.0]])
    np.testing.assert_allclose(quant.scale_for(x, "int8", axis=1).numpy(),
                               [4.0 / 127.0, 0.0])
    s_eps = quant.scale_for(x, "int8", axis=1, eps=1e-12)
    assert float(s_eps[1]) == pytest.approx(1e-12 / 127.0)
    assert_bits_equal(s_eps, jquant.scale_for(
        jnp.asarray(x.numpy()), "int8", axis=1, eps=1e-12))
