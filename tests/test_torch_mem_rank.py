"""``tools/mem_rank_torch.py``, the twin of ``tools/mem_rank.py``: the
largest tensors of one dry-run cell's traced step on rank 0.

Two subprocesses (a process has one default group), each on torch's
``fake`` group of 256 at qwen3-0.6b's smoke geometry, ``decode_32k``:

* the tool's CLI prints the cell's argument and temporary GiB and its
  ranking lines (``count x dtype[shape] = GiB  ops=[...]``);
* ``launch/dryrun.rank_tensors``' ranking, traced under a
  ``LiveBytes`` that also notes every tensor the step makes: its first
  entry is the trace's largest tensor (dtype, shape and bytes; each
  tensor of that size is an entry), every
  entry at or above the threshold, none below, largest first, and its
  counts add up to the tensors at or above the threshold; the first line
  the CLI prints names that tensor.
"""
import os
import re
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
THRESHOLD_GIB = 0.0001
DRIVER = """
import json, sys, warnings
warnings.filterwarnings("ignore", category=FutureWarning)
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun


class Noting(dryrun.LiveBytes):
    def __init__(self, threshold):
        super().__init__(threshold)
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if all(r.alias_info is None for r in func._schema.returns):
            self.made += [(t.numel() * t.element_size(), str(t.dtype),
                           list(t.shape)) for t in dryrun._tensors(out)
                          if t.device.type != "meta"]
        return out


seen = []
orig = dryrun.LiveBytes
dryrun.LiveBytes = lambda threshold=None: seen.append(Noting(threshold)) \\
    or seen[-1]
with dryrun.fake_world(256):
    r = dryrun.rank_tensors("qwen3-0.6b", "decode_32k", int(float(
        sys.argv[1]) * 2**30), cfg_override=get_arch("qwen3-0.6b").smoke)
print(json.dumps({
    "ranking": [[str(dt), list(sh), n, c, ops]
                for dt, sh, n, c, ops in r["ranking"]],
    "made": seen[0].made, "arguments": r["arguments"], "temp": r["temp"]}))
"""


def _run(args) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, *args], env=env, capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, (r.stdout[-3000:], r.stderr[-3000:])
    return r.stdout


def test_mem_rank_ranks_the_traces_largest_tensors():
    import json
    got = json.loads(_run(["-c", DRIVER, str(THRESHOLD_GIB)]).splitlines()[-1])
    rows, made = got["ranking"], got["made"]
    threshold = int(THRESHOLD_GIB * 2**30)
    assert rows and got["arguments"] > 0 and got["temp"] > 0
    big = max(n for n, _, _ in made)
    largest = {(d, tuple(s)) for n, d, s in made if n == big}
    assert rows[0][2] == big and (rows[0][0], tuple(rows[0][1])) in largest
    assert largest <= {(r[0], tuple(r[1])) for r in rows if r[2] == big}
    assert [r[2] for r in rows] == sorted((r[2] for r in rows), reverse=True)
    assert all(r[2] >= threshold and r[4] for r in rows)
    assert sum(r[3] for r in rows) == sum(n >= threshold for n, _, _ in made)
    cli = _run([os.path.join("tools", "mem_rank_torch.py"), "qwen3-0.6b",
                "decode_32k", str(THRESHOLD_GIB), "--smoke"]).splitlines()
    assert re.fullmatch(r"args=\d+\.\d\dG temp=\d+\.\d\dG", cli[0]), cli[0]
    first = re.fullmatch(r" *(\d+)x (\w+)\[([\d,]*)\] = \d+\.\d\dG  "
                         r"ops=\[.*\]", cli[1])
    assert first, cli[1]
    assert int(first.group(1)) == rows[0][3]
    assert [int(x) for x in first.group(3).split(",")] == rows[0][1]
    assert 1 < len(cli) <= 21
