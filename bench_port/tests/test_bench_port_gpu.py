"""On the card: one short run of each cell through ``run.py`` prints the
contract's last line with ``correct`` true.  Run there with
``python -m pytest -q -m gpu bench_port/tests``; skips without a card."""
import json
import subprocess
import sys

import pytest

from bench_port.harness import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload", name,
         "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] and last["device"]["platform"] == "gpu"
    assert list(last)[-1] == "checks"
