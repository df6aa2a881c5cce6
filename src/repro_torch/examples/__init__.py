"""The port's six examples (port of ``repro``'s ``examples/``), each run as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

``quickstart``, ``query_serving``, ``streaming_ingest``, ``out_of_core``,
``text_analytics`` and ``ngram_language_model``.  Each keeps ``repro``'s
constants, seeds, printed lines and asserts, and runs on the card; without a
card it raises unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device

NAMES = ("quickstart", "query_serving", "streaming_ingest", "out_of_core",
         "text_analytics", "ngram_language_model")


def parse_args(ap: argparse.ArgumentParser, argv=None) -> tuple[argparse.Namespace,
                                                                  torch.device]:
    """``ap``'s arguments with the port's ``--device`` flag, and the device
    they name: the card unless ``--device cpu`` (no card raises)."""
    ap.add_argument("--device", default=None, choices=["cpu"],
                    help="device to run on: the card unless cpu is given")
    args = ap.parse_args(argv)
    return args, resolve_device(args.device)
