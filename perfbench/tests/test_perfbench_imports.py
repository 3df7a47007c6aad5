"""Nothing the benchmark runs loads JAX or the JAX package: a run of the
tiny cell in a fresh process, then its ``sys.modules`` by top-level
name."""

import json
import subprocess
import sys

from perfbench.tests.conftest import REPO

CODE = """
import json, sys, time, torch
from pathlib import Path
torch.set_num_threads(2)
sys.path.insert(0, {repo!r})
import perfbench.calibrate
from perfbench import run
from perfbench.cells import resolve
from perfbench.tests.conftest import write_tiny_root
root = Path({root!r})
name = write_tiny_root(root)
result = run.measure(resolve(name, root), 3, 0.0, False, torch.device("cpu"),
                     time.perf_counter())
print(json.dumps({{"found": run.forbidden_modules(),
                  "torch_port": "mmnn_sts_torch.train.loop" in sys.modules}}))
"""


def test_a_run_loads_no_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", CODE.format(repo=str(REPO),
                                            root=str(tmp_path))],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"found": [], "torch_port": True}


def test_forbidden_names_are_compared_whole():
    from perfbench import run

    sys.modules.setdefault("mmnn_sts_tpu_like", sys)
    try:
        assert "mmnn_sts_tpu_like" not in run.forbidden_modules()
    finally:
        del sys.modules["mmnn_sts_tpu_like"]
