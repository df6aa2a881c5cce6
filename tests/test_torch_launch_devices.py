"""The port's driver CLIs on several ranks against ``repro``'s on a host mesh.

``--devices 3`` runs 3 gloo ranks on the CPU and must print and count as
``repro``'s CLI on a 3-device host mesh (a fresh process, since JAX fixes
its device count at start): the job, the mesh waves (``--wave-tokens``),
and the streaming driver with waves and without; ``--serve --devices 2``
serves from one device, as ``repro``'s does.  The port's CLIs run in this
process (``main(argv)``), ``repro``'s multi-device runs and the frontend
run ``python -m`` as a user would.  The helpers are
``test_torch_launch.py``'s.
"""
import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

pytest.importorskip("jax")      # a GPU host without JAX skips this file

from repro_torch.launch import ngram, serve_ngrams  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from test_torch_launch import ROOT, _obs_clean, instruments, job_lines  # noqa: E402,F401


def run_repro_devices(module: str, argv: list, tmp_path, n: int = 3):
    """``repro``'s CLI on an ``n``-device host mesh, as a fresh process (the
    device count is fixed before JAX starts)."""
    m = tmp_path / "repro.jsonl"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", module, *argv, "--devices", str(n),
                           "--metrics", str(m)], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout, report.read_jsonl(str(m))[-1]


def run_port_devices(mod, argv: list, tmp_path, capfd, n: int = 3):
    """The port's CLI on ``n`` gloo ranks on the CPU, in this process (rank
    0 prints from its own process: ``capfd`` reads the shared stdout)."""
    m = tmp_path / "port.jsonl"
    mod.main(argv + ["--devices", str(n), "--device", "cpu", "--metrics", str(m)])
    return capfd.readouterr().out, report.read_jsonl(str(m))[-1]


@pytest.mark.parametrize("method", ["suffix_sigma", "apriori_scan"])
def test_ngram_devices_prints_and_counts_as_repro(method, tmp_path, capfd):
    flags = ["--method", method, "--tokens", "20000", "--sigma", "4", "--tau", "3",
             "--top", "15"]
    out, rec = run_port_devices(ngram, flags, tmp_path, capfd)
    jout, jrec = run_repro_devices("repro.launch.ngram", flags, tmp_path)
    assert "mesh: 3 ranks on cpu, backend gloo" in out
    assert job_lines(out) == job_lines(jout)
    assert sum(ln.startswith("  cf=") for ln in job_lines(out)) == 15
    assert "'capacity'" in out if method == "suffix_sigma" else "'jobs': 4" in out
    assert instruments(rec) == instruments(jrec)
    assert report.validate_metrics(rec["metrics"]) == []


def test_serve_ngrams_devices_counts_as_repro(tmp_path, capfd):
    """The sharded micro-batch driver: the job line, the serve lines and
    every ``job.*`` and ``serve.*`` counter equal ``repro``'s, and each
    histogram counts as many batches."""
    flags = ["--tokens", "20000", "--queries", "1500", "--batch-sizes", "64,512",
             "--compress"]
    out, rec = run_port_devices(serve_ngrams, flags, tmp_path, capfd)
    jout, jrec = run_repro_devices("repro.launch.serve_ngrams", flags, tmp_path)
    prefixes = ("job.", "serve.")
    assert instruments(rec, prefixes) == instruments(jrec, prefixes)
    assert instruments(rec, prefixes)["serve.batches"] > 0
    for name, h in jrec["metrics"]["histograms"].items():
        assert rec["metrics"]["histograms"][name]["count"] == h["count"], name
    head = lambda o: [ln.split(" in ")[0] for ln in o.splitlines() if ln.startswith("job:")]
    assert head(out) == head(jout) and len(head(out)) == 1
    assert [ln.split(" qps")[0] for ln in out.splitlines() if ln.startswith("serve_")] == \
        [f"serve_{m} batch={b:>5}" for m in ("lookup", "topk") for b in (64, 512)]


def test_ngram_devices_wave_tokens_prints_and_counts_as_repro(tmp_path, capfd):
    """The mesh waves through the CLI: the tiered fold with the fold thread
    (``repro``'s without it, whose ``retries`` do not depend on thread
    timing) prints and counts as ``repro``'s on 3 devices."""
    flags = ["--method", "apriori_scan", "--tokens", "20000", "--sigma", "4", "--tau", "3",
             "--top", "15", "--wave-tokens", "6000", "--accumulator", "tiered"]
    out, rec = run_port_devices(ngram, flags, tmp_path, capfd)
    jout, jrec = run_repro_devices("repro.launch.ngram", flags + ["--no-overlap"], tmp_path)
    assert "mesh: 3 ranks on cpu, backend gloo" in out
    assert job_lines(out) == job_lines(jout)
    assert sum(ln.startswith("  cf=") for ln in job_lines(out)) == 15
    assert instruments(rec) == instruments(jrec)
    assert instruments(rec)["job.waves"] == 4 and instruments(rec)["job.fold_rows"] > 0
    assert report.validate_metrics(rec["metrics"]) == []


@pytest.mark.parametrize("waves", [["--wave-tokens", "8192"], []], ids=["waves", "job"])
def test_serve_ngrams_streaming_devices_counts_as_repro(waves, tmp_path, capfd):
    """The streaming driver on 3 ranks: the ingest lines, the final index
    and every ``job.*``, ``gen.*``, ``cache.*`` and ``serve.*`` counter and
    row gauge equal ``repro``'s on 3 devices."""
    flags = ["--streaming", "--compress", "--tokens", "40000", "--queries", "4000",
             *waves]
    out, rec = run_port_devices(serve_ngrams, flags, tmp_path, capfd)
    jout, jrec = run_repro_devices("repro.launch.serve_ngrams", flags + ["--no-overlap"],
                                   tmp_path)
    assert "mesh: 3 ranks on cpu, backend gloo" in out
    prefixes = ("job.", "gen.", "cache.", "serve.")
    got, want = instruments(rec, prefixes), instruments(jrec, prefixes)
    assert got.keys() == want.keys()
    for k, v in got.items():
        if "bytes" not in k:
            assert v == want[k], k
    assert got["gen.merges"] >= 1
    assert got["job.waves"] > 4 if waves else got["job.jobs"] == 5
    lines = lambda o: [ln.split(" in ")[0] for ln in o.splitlines()
                       if ln.startswith("ingest[")]
    assert len(lines(out)) == 4 and lines(out) == lines(jout)
    final = [ln for ln in out.splitlines() if ln.startswith("final:")]
    jfinal = [ln for ln in jout.splitlines() if ln.startswith("final:")]
    assert len(final) == 1 and final[0].split(", ")[:3] == jfinal[0].split(", ")[:3]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_devices_serves_from_one_device():
    """``--serve --devices 2`` builds its service on one device, as
    ``repro``'s does: it answers ``/healthz``, and its topology is one
    generational index, not a sharded one."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_ngrams", "--serve",
         f"127.0.0.1:{port}", "--devices", "2", "--device", "cpu", "--tokens", "3000",
         "--sigma", "3", "--tau", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "serving on" not in line:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, proc.stderr.read()[-3000:]
            assert time.monotonic() < deadline
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read()) == {"status": "ok"}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/system/topology",
                                    timeout=30) as r:
            topo = json.loads(r.read())
        assert topo["index"]["kind"] == "generational"
        assert topo["devices"]["backend"] in ("cpu", "cuda")
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
