"""The port's six examples against ``repro``'s, on the CPU.

Each ``repro_torch.examples.<name>`` runs with ``--device cpu`` beside
``examples/<name>.py`` (run as a script, in this process); their printed
lines must be equal once the times are masked.  ``ngram_language_model``
runs at flags small enough for the CPU (``LM_FLAGS``), yet with enough steps
that both packages' own assert that the loss falls holds; its weights are
the port's own draw, so its losses are masked too and every other line is
held equal.
"""
import contextlib
import importlib
import io
import re
import runpy
import sys
from pathlib import Path

import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

from repro_torch.examples import NAMES

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LM_FLAGS = ["--steps", "8", "--tokens", "20000", "--batch", "2", "--seq", "32"]
#: seconds ("in 1.5s", "2.7s)") and rates ("48 tok/s") vary run to run
TIMES = re.compile(r"\d[\d,]*(\.\d+)?(?=s\b)|\d[\d,]* tok/s")
LOSSES = re.compile(r"loss \d+\.\d+( -> \d+\.\d+)?")


def repro_lines(name: str, argv: list) -> list[str]:
    """``examples/<name>.py`` run as a script (its ``__main__``)."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [str(ROOT / "examples" / f"{name}.py"), *argv]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue().splitlines()


def port_lines(name: str, argv: list) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        importlib.import_module(f"repro_torch.examples.{name}").main(
            [*argv, "--device", "cpu"])
    return out.getvalue().splitlines()


def masked(lines: list[str], losses: bool = False) -> list[str]:
    lines = [TIMES.sub("<t>", ln) for ln in lines]
    return [LOSSES.sub("loss <l>", ln) for ln in lines] if losses else lines


@pytest.mark.parametrize("name", [n for n in NAMES if n != "ngram_language_model"])
def test_example_prints_repros_lines(name):
    got, want = port_lines(name, []), repro_lines(name, [])
    assert len(want) > 3
    assert masked(got) == masked(want)


def test_ngram_language_model_prints_repros_lines_and_its_loss_falls(tmp_path):
    flags = [*LM_FLAGS, "--ckpt-dir"]
    got = port_lines("ngram_language_model", [*flags, str(tmp_path / "port")])
    want = repro_lines("ngram_language_model", [*flags, str(tmp_path / "repro")])
    assert masked(got, losses=True) == masked(want, losses=True)
    first, last = map(float, re.search(r"done: loss (\S+) -> (\S+),", got[-1]).groups())
    assert last < first
    assert sum(ln.startswith("  step ") for ln in got) == 9
