"""The benchmark on the card: one short run of the failure cell through
the command the checks use.  Marked ``gpu``; it decides inside the test
whether a card is there and skips without one."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.gpu
def test_recover_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "mistral-7b.recover", "--seed", "271828",
                        "--seconds", "3", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
