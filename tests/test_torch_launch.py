"""The port's driver CLIs against ``repro``'s on CPU.

``repro_torch.launch.ngram`` and ``repro_torch.launch.serve_ngrams`` run with
``--device cpu`` on 20k-60k synthetic tokens beside ``repro.launch.ngram`` and
``repro.launch.serve_ngrams`` on the same flags: the printed n-gram count,
counters and top grams must be equal, and so must every ``job.*`` counter of
the ``--metrics`` file (and, for the streaming driver, every ``gen.*`` and
``cache.*`` counter).  ``--wave-tokens`` must print what the monolithic run
prints.  Each CLI runs in this process (``main(argv)``; ``repro``'s reads
``sys.argv``).  The ``--devices`` cases are in
``test_torch_launch_devices.py``, so that a parallel run spreads the two
files over its workers.
"""
import sys
from pathlib import Path

import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import repro.launch.ngram as jngram
import repro.launch.serve_ngrams as jserve
import repro.obs.metrics as jmetrics
import repro.obs.trace as jtrace
import repro_torch.obs.metrics as metrics
import repro_torch.obs.trace as trace
from repro_torch.launch import ngram, serve_ngrams
from repro_torch.obs import report

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _obs_clean():
    """The CLIs install a registry and a tracer; put the null ones back."""
    yield
    for mod in (metrics, jmetrics):
        mod.set_registry(None)
    trace.disable_tracing()
    jtrace.disable_tracing()


def run_port(mod, argv, tmp_path, capsys, name="port"):
    m = tmp_path / f"{name}.jsonl"
    mod.main(argv + ["--device", "cpu", "--metrics", str(m)])
    return capsys.readouterr().out, report.read_jsonl(str(m))[-1]


def run_repro(mod, argv, tmp_path, capsys, monkeypatch, name="repro"):
    m = tmp_path / f"{name}.jsonl"
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv + ["--metrics", str(m)])
    mod.main()
    return capsys.readouterr().out, report.read_jsonl(str(m))[-1]


def job_lines(out: str) -> list[str]:
    """What a job run prints, without its wall time: the n-gram count, the
    counters and the top grams."""
    keep = []
    for line in out.splitlines():
        if line.startswith("method="):
            keep.append(line.split(" in ")[0])
        elif line.startswith(("counters:", "  cf=", "document splitting")):
            keep.append(line)
    return keep


def instruments(rec: dict, prefixes=("job.",)) -> dict:
    m = rec["metrics"]
    return {k: v for sect in ("counters", "gauges") for k, v in m[sect].items()
            if k.startswith(prefixes)}


@pytest.mark.parametrize("flags", [
    ["--method", "suffix_sigma", "--tokens", "40000", "--sigma", "5", "--tau", "4"],
    ["--method", "naive", "--tokens", "20000", "--sigma", "3", "--tau", "3"],
    ["--method", "apriori_scan", "--tokens", "20000", "--sigma", "4", "--tau", "5"],
    ["--method", "apriori_index", "--tokens", "20000", "--sigma", "4", "--tau", "5",
     "--profile", "cw"],
    ["--tokens", "30000", "--sigma", "4", "--tau", "3", "--filter", "closed", "--top", "20"],
    ["--tokens", "30000", "--sigma", "3", "--tau", "3", "--split-docs"],
    ["--tokens", "20000", "--sigma", "3", "--tau", "2", "--series"],
], ids=["suffix_sigma", "naive", "apriori_scan", "apriori_index_cw", "closed",
        "split_docs", "series"])
def test_ngram_cli_prints_and_counts_as_repro(flags, tmp_path, capsys, monkeypatch):
    out, rec = run_port(ngram, flags, tmp_path, capsys)
    jout, jrec = run_repro(jngram, flags, tmp_path, capsys, monkeypatch)
    assert job_lines(out) == job_lines(jout)
    assert sum(ln.startswith("  cf=") for ln in job_lines(out)) >= 10
    assert instruments(rec) == instruments(jrec)
    assert instruments(rec)["job.jobs"] >= 1
    assert report.validate_metrics(rec["metrics"]) == []
    assert rec["driver"] == "ngram" and rec["env"]["torch_version"] == torch.__version__


@pytest.mark.parametrize("wave_flags", [
    ["--wave-tokens", "7000"],
    ["--wave-tokens", "5000", "--accumulator", "tiered", "--merge-route", "kway"],
    ["--wave-tokens", "9000", "--accumulator", "pairwise", "--merge-route", "sort",
     "--no-overlap"],
])
def test_ngram_wave_tokens_prints_the_monolithic_run(wave_flags, tmp_path, capsys,
                                                     monkeypatch):
    """Waves print the monolithic job's n-grams, and count as ``repro``'s
    waves do (on ``repro``'s default merge route)."""
    flags = ["--tokens", "40000", "--sigma", "4", "--tau", "3", "--top", "25"]
    mono, _ = run_port(ngram, flags, tmp_path, capsys, name="mono")
    out, rec = run_port(ngram, flags + wave_flags, tmp_path, capsys)
    grams = lambda o: [ln for ln in job_lines(o) if not ln.startswith("counters:")]
    assert grams(out) == grams(mono)
    jflags = flags + wave_flags
    if "--merge-route" in jflags:
        i = jflags.index("--merge-route")
        del jflags[i:i + 2]
    jout, jrec = run_repro(jngram, jflags, tmp_path, capsys, monkeypatch)
    assert job_lines(out) == job_lines(jout)
    assert instruments(rec) == instruments(jrec)
    assert instruments(rec)["job.waves"] > 1


def test_serve_ngrams_streaming_counts_as_repro(tmp_path, capsys, monkeypatch):
    """The generational driver with compressed rungs and wave ingest: every
    job, generational-index, decode and cache counter, and every row gauge,
    equals ``repro``'s; the byte gauges of flat rungs are the port's own."""
    flags = ["--streaming", "--compress", "--tokens", "40000", "--wave-tokens", "8192",
             "--queries", "4000"]
    out, rec = run_port(serve_ngrams, flags, tmp_path, capsys)
    jout, jrec = run_repro(jserve, flags, tmp_path, capsys, monkeypatch)
    prefixes = ("job.", "gen.", "cache.", "merge.", "compress.")
    got, want = instruments(rec, prefixes), instruments(jrec, prefixes)
    assert got.keys() == want.keys()
    for k, v in got.items():
        if "bytes" not in k:
            assert v == want[k], k
    assert got["job.waves"] > 4 and got["gen.merges"] >= 1
    assert rec["metrics"]["gauges"]["serve.inflight"] == 0
    hist = rec["metrics"]["histograms"]["serve.lookup_seconds"]
    assert hist["count"] == jrec["metrics"]["histograms"]["serve.lookup_seconds"]["count"]
    lines = lambda o: [ln.split(" in ")[0] for ln in o.splitlines()
                       if ln.startswith("ingest[")]
    assert len(lines(out)) == 4 and lines(out) == lines(jout)
    final = [ln for ln in out.splitlines() if ln.startswith("final:")][0]
    jfinal = [ln for ln in jout.splitlines() if ln.startswith("final:")][0]
    assert final.split(", ")[:3] == jfinal.split(", ")[:3]     # gen, segments, rows


def test_serve_ngrams_microbatch_counts_as_repro(tmp_path, capsys, monkeypatch):
    flags = ["--tokens", "30000", "--queries", "1500", "--batch-sizes", "64,512",
             "--compress"]
    out, rec = run_port(serve_ngrams, flags, tmp_path, capsys)
    jout, jrec = run_repro(jserve, flags, tmp_path, capsys, monkeypatch)
    assert instruments(rec) == instruments(jrec)
    assert sorted(rec["metrics"]["histograms"]) == ["drive.lookup_seconds",
                                                    "drive.topk_seconds"]
    for name, h in rec["metrics"]["histograms"].items():
        assert h["count"] == jrec["metrics"]["histograms"][name]["count"]
    head = lambda o: [ln.split(" in ")[0] for ln in o.splitlines() if ln.startswith("job:")]
    assert head(out) == head(jout)
    assert [ln.split(" qps")[0] for ln in out.splitlines() if ln.startswith("serve_")] == \
        [f"serve_{m} batch={b:>5}" for m in ("lookup", "topk") for b in (64, 512)]
