"""One short cell on the card, as the driver runs it: a fresh process from
the repository's root.  Skips without a card (decided inside the test)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import harness


@pytest.mark.cuda
def test_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "nyt.job",
                          "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=600,
                         env=dict(os.environ))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert res.stderr.strip().splitlines()[-1].startswith("check ")
