"""BENCHMARK.json against the benchmark's contract: keys, names, units,
files, and one metric module a metric that agrees with its entry."""
import json
import re

import pytest

from cells import spec
from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
S = spec()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(S) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert S["command"] == ["python3", "perfbench/run.py"]
    assert S["paths"] == ["perfbench"]
    assert isinstance(S["run_seconds"], int) and 1 <= S["run_seconds"] <= 51
    assert len(harness.BENCHMARK.read_bytes()) <= 64 * 1024


def test_check_budget_fits():
    cells = len(S["workloads"])
    assert (2 + 14 * 24) * (S["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert cells <= 24


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_lines(kind):
    names = [e["name"] for e in S[kind]]
    assert len(names) == len(set(names))
    for e in S[kind]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_configs():
    for c in S["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and _line(c["source"]) and _line(c["why"])
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in data and key in data["reduced"]
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    files = [c["file"] for c in S["configs"]]
    assert len(files) == len(set(files))


def test_workloads():
    configs = {c["name"] for c in S["configs"]}
    pairs = set()
    for w in S["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
        assert (harness.PERFBENCH / "traffic" / f"{w['traffic']}.json").exists()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(S["workloads"])
    used = {w["config"] for w in S["workloads"]}
    assert used == configs
    four = sum(w["chips"] == 4 for w in S["workloads"])
    assert four <= max(1, len(S["workloads"]) // 4)


def test_end_to_end():
    names = [m["name"] for m in S["end_to_end"]]
    assert "setup_s" in names
    for m in S["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert harness.load_metric("metrics", m["name"]).SOURCE == m["source"]


def test_per_layer():
    e2e = {m["name"] for m in S["end_to_end"]}
    cells = {w["name"] for w in S["workloads"]}
    layers = {}
    for m in S["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and m["moves"] in e2e and _line(m["layer"])
        mod = harness.load_metric("layer_metrics", m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        for cell in m.get("workloads", []):
            assert cell in cells
            moved = next(x for x in S["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_cell_reports_enough():
    for w in S["workloads"]:
        e2e, per = harness.cell_metrics(S, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per, w["name"]


def test_paths_hold_only_the_benchmark():
    import subprocess
    tracked = subprocess.run(["git", "ls-files", "perfbench"], cwd=harness.ROOT,
                             capture_output=True, text=True).stdout.split()
    for path in tracked:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path), path
