"""The port's training CLI, ``python -m repro_torch.launch.train`` (the
port of tests/test_pipeline_data_integration.py's train cases): a run
that trains to finite losses and checkpoints, and a resume from its
step-6 checkpoint that ends at the straight run's final loss exactly
(the same ``--steps``: the learning-rate schedule depends on it); the
lines match regexes built from the reference CLI's format strings
(src/repro/launch/train.py); a mesh is refused naming item 9h; under
the ``kernel`` policy the first step raises the kernels' gradient guard.
Every batch is fresh uniform tokens, so there is nothing to learn beyond
the marginal and the loss need not fall in nine steps.  Only the resume
pair runs in subprocesses (torch on one thread); the rest calls ``main``
in-process."""
import math
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
         "4", "--seq", "64", "--lr", "1e-3"]
# the reference's format strings, src/repro/launch/train.py:84, 98-102, 111
RESUMED = re.compile(r"resumed from step (\d+)")
STEP = re.compile(r"step +(\d+) loss=(-?\d+\.\d{4}) gnorm=(\d+\.\d{3}) "
                  r"lr=(\d\.\d{2}e[+-]\d{2}) (\d+)ms excluded_hosts=\[\]")
DONE = re.compile(r"done; final loss (-?\d+\.\d+(?:e[+-]\d+)?)")


def _cli(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("REPRO_TORCH_VX_IMPL", None)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                       + SMOKE + args, env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.splitlines()


def _parse(lines):
    """(resumed step or None, {step: (loss, gnorm, lr)}, final loss);
    every line must match one of the reference's formats."""
    resumed, steps, final = None, {}, None
    for line in lines:
        if m := RESUMED.fullmatch(line):
            resumed = int(m[1])
        elif m := STEP.fullmatch(line):
            steps[int(m[1])] = (float(m[2]), float(m[3]), m[4])
        elif m := DONE.fullmatch(line):
            final = float(m[1])
        else:
            raise AssertionError(f"a line in no reference format: {line!r}")
    return resumed, steps, final


def test_train_cli_learns_checkpoints_and_resumes_exactly(tmp_path):
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    a = _parse(_cli(["--steps", "9", "--ckpt-every", "3", "--ckpt-dir",
                     str(a_dir)]))
    assert a[0] is None and sorted(a[1]) == [0, 5, 8]
    assert all(math.isfinite(v[0]) for v in a[1].values()), a
    assert a[2] is not None and abs(a[2] - a[1][8][0]) < 1e-4
    assert sorted(os.listdir(a_dir)) == [f"step_{s:08d}" for s in (3, 6, 9)]

    shutil.copytree(a_dir, b_dir)
    shutil.rmtree(b_dir / "step_00000009")
    b = _parse(_cli(["--steps", "9", "--ckpt-every", "3", "--ckpt-dir",
                     str(b_dir), "--resume"]))
    assert b[0] == 6 and sorted(b[1]) == [8]
    assert b[1][8] == a[1][8]
    assert b[2] == a[2]                         # exactly, on the CPU
    assert sorted(os.listdir(b_dir)) == [f"step_{s:08d}" for s in (3, 6, 9)]


def test_mesh_is_refused_naming_the_dist_slice(monkeypatch):
    """``--mesh`` builds the production mesh, which a world of another
    size than 256 / 512 refuses with ``make_mesh``'s ``ValueError`` (never
    a shrunk mesh); here the process is a world of one."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for mesh, n in (("single-pod", 256), ("multi-pod", 512)):
        monkeypatch.setattr(sys, "argv", ["train"] + SMOKE
                            + ["--steps", "1", "--mesh", mesh])
        with pytest.raises(ValueError, match=f"needs {n} ranks, the "
                                             f"process group has 1"):
            train.main()


def test_kernel_policy_refuses_to_train(monkeypatch, capsys):
    """The kernels' guard fires before their CPU route, so ``--device
    cpu`` shows what the card's default policy does."""
    monkeypatch.setenv("REPRO_TORCH_VX_IMPL", "kernel")
    monkeypatch.setattr(sys, "argv", ["train"] + SMOKE
                        + ["--steps", "1", "--seq", "16"])
    with pytest.raises(RuntimeError, match="no backward"):
        train.main()
    assert "done" not in capsys.readouterr().out


def test_default_device_needs_a_card(monkeypatch):
    if not torch.cuda.is_available():
        monkeypatch.setattr(sys, "argv", ["train", "--arch", "qwen3-0.6b",
                                          "--smoke", "--steps", "1"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main()
