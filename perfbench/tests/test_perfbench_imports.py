"""Neither JAX nor the JAX package is loaded by a run, and the reference
loads nothing of the program.  Top-level module names are compared whole:
``repro_torch`` starts with ``repro`` and is not it."""
import ast
import json
import os
import subprocess
import sys

from perfbench import harness

ROOT = str(harness.ROOT)
SRC = os.path.join(ROOT, "src")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_reference_sources_import_only_torch_and_numpy():
    ref = harness.PERFBENCH / "reference"
    for path in ref.glob("*.py"):
        assert set(_imports(path)) <= {"__future__", "numpy", "torch"}, path


def test_no_source_of_the_benchmark_imports_jax_or_repro():
    for path in harness.PERFBENCH.rglob("*.py"):
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path


def _modules_after(code):
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        f"import sys, json; sys.path[:0] = [{ROOT!r}, {SRC!r}]\n"
        "import torch\nfrom perfbench.reference import ngrams\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not {"repro_torch", "repro", "jax", "jaxlib", "flax"} & set(mods)


def test_a_run_loads_no_jax_and_no_repro():
    mods = _modules_after(
        f"import sys, json; sys.path[:0] = [{ROOT!r}, {SRC!r}, {str(harness.PERFBENCH / 'tests')!r}]\n"
        "from cells import run_cell\nfrom perfbench import harness\n"
        "out, _ = run_cell('nyt.job', seconds=0.1)\nassert out['correct']\n"
        "print(json.dumps(harness.forbidden_modules() + ['repro_torch' in sys.modules]))")
    assert mods == [True]


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("repro_torch_lookalike_for_test", sys)
    try:
        found = harness.forbidden_modules()
        assert "repro_torch_lookalike_for_test" not in found
        assert all(m.split(".")[0] in harness.FORBIDDEN for m in found)
    finally:
        sys.modules.pop("repro_torch_lookalike_for_test", None)


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    res = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
                          "--workload", "nyt.job", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout.strip() == ""
    bare = tmp_path / "bare"
    bare.mkdir()
    import shutil
    shutil.copytree(harness.PERFBENCH, bare / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.BENCHMARK, bare / "BENCHMARK.json")
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "nyt.job",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=bare, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
