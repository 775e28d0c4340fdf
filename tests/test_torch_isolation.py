"""The port stands alone: importing repro_torch and every submodule pulls
in neither jax nor any module of the reference package, and entry points
follow the device rule (cuda unless the caller asks for the CPU)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), ";".join(bad))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1) if " " in \
        out.stdout.strip() else (out.stdout.strip(), "")
    assert int(count) >= 41
    assert bad == "", f"port imported {bad}"


def test_chip_smoke_imports_no_jax():
    src = (SRC.parent / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "from repro " not in src and "from repro." not in src
    assert "import repro\n" not in src and "import repro." not in src


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.configs.qwen3_0_6b import smoke_config
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import decode
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import BatchedServer, jit_prefill
    from repro_torch.serve.scheduler import Scheduler
    cfg = smoke_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode.init_paged_cache(cfg, 2, 16, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode.init_paged_cache(cfg, 2, 16, 4, quantize="int8")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jit_prefill(cfg, None)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler(cfg, params, slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Scheduler(cfg, params, slots=1, max_len=16, kv_quant="fp8",
                  prefix_cache=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedServer(cfg, params, slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", "qwen3-0.6b", "--smoke", "--requests",
                        "1", "--prompt-len", "4", "--gen", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", "qwen3-0.6b", "--smoke", "--requests",
                        "1", "--prompt-len", "4", "--gen", "2",
                        "--kv-dtype", "int8", "--prefix-cache"])
    from repro_torch.serve.engine import make_fleet
    from repro_torch.serve.fleet import FleetRouter
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetRouter(cfg, params, replicas=2, slots=1, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fleet(cfg, params, replicas=2, slots=1, max_len=16)
    for flags in (["--chaos", "0"], ["--guard-nan"],
                  ["--replicas", "2", "--kill-replica", "2"],
                  ["--replicas", "2", "--chaos", "1"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_cli.main(["--arch", "qwen3-0.6b", "--smoke", "--requests",
                            "2", "--prompt-len", "4", "--gen", "2"] + flags)
