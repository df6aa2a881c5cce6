"""The harness takes a new configuration, traffic mix and metric as new
files: a copy of the benchmark gains one of each, with entries in its
BENCHMARK.json, and runs them with no other edit."""
import json
import os
import shutil
import subprocess
import sys

from perfbench import harness

RUN = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import harness
t = time.perf_counter()
spec, bench = harness.prepare(["--workload", "tiny.hashjob", "--seed", "4294967311",
                               "--seconds", "0.2", "--trace", "0"], t, device="cpu")
out = harness.execute(spec, bench)
print(json.dumps(out))
"""


def test_new_files_run_without_edits(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(harness.PERFBENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.BENCHMARK, root / "BENCHMARK.json")
    cfg = json.loads((harness.PERFBENCH / "configs" / "nyt.json").read_text())
    cfg.update(name="tiny", terms=40_000, vocab_size=5_000)
    (root / "perfbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (root / "perfbench" / "traffic" / "hashjob.json").write_text(json.dumps(
        {"driver": "job", "method": "suffix_sigma", "combine_route": "hash",
         "warm_jobs": 1, "trace_jobs": 1}))
    (root / "perfbench" / "metrics" / "jobs_done.py").write_text(
        'SOURCE = "host_clock"\n\n\ndef value(record):\n    return len(record["steps"])\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "a tiny test corpus", "reduced": ["terms"],
                            "file": "perfbench/configs/tiny.json", "why": "test"})
    spec["workloads"].append({"name": "tiny.hashjob", "config": "tiny", "traffic": "hashjob",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["tiny.hashjob"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = RUN.format(root=str(root), src=str(harness.ROOT / "src"))
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["metrics"]["jobs_done"]["value"] >= 1
    # the cell reports what applies to it: setup_s and its own metric
    assert set(out["metrics"]) == {"setup_s", "jobs_done"}
