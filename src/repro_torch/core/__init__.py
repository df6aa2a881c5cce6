"""The paper's contribution on PyTorch: n-gram statistics jobs.

``run_job`` dispatches on ``NGramConfig.method``; the port runs SUFFIX-sigma
so far, and refuses the other methods until their slices land.
"""
from __future__ import annotations

from . import oracle, suffix_sigma
from .stats import NGramConfig, NGramStats

METHODS = {"suffix_sigma": suffix_sigma.run}


def run_job(tokens, cfg: NGramConfig, *, device=None) -> NGramStats:
    """Run the job ``cfg`` over a PAD-separated token stream.

    Runs on the card unless ``device`` says otherwise; with no card and no
    ``device`` it raises rather than running on the CPU.
    """
    try:
        fn = METHODS[cfg.method]
    except KeyError:
        raise NotImplementedError(
            f"method {cfg.method!r} is not ported to repro_torch; options: "
            f"{sorted(METHODS)}") from None
    return fn(tokens, cfg, device=device)


__all__ = ["NGramConfig", "NGramStats", "run_job", "METHODS", "oracle",
           "suffix_sigma"]
