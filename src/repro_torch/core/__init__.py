"""The paper's contribution on PyTorch: n-gram statistics jobs.

``run_job`` dispatches on ``NGramConfig.method`` over the paper's four
methods, each a single-device job; the multi-device jobs wait for a later
slice.
"""
from __future__ import annotations

from . import apriori_index, apriori_scan, naive, oracle, suffix_sigma
from .stats import NGramConfig, NGramStats

METHODS = {
    "suffix_sigma": suffix_sigma.run,
    "naive": naive.run,
    "apriori_scan": apriori_scan.run,
    "apriori_index": apriori_index.run,
}

# method name -> its JobPlan (a function of cfg), which the executor runs
PLANS = {
    "suffix_sigma": suffix_sigma.plan,
    "naive": naive.plan,
    "apriori_scan": apriori_scan.plan,
    "apriori_index": apriori_index.plan,
}


def run_job(tokens, cfg: NGramConfig, *, device=None) -> NGramStats:
    """Run the job ``cfg`` over a PAD-separated token stream.

    Runs on the card unless ``device`` says otherwise; with no card and no
    ``device`` it raises rather than running on the CPU.
    """
    try:
        fn = METHODS[cfg.method]
    except KeyError:
        raise ValueError(f"unknown method {cfg.method!r}; "
                         f"options: {sorted(METHODS)}") from None
    return fn(tokens, cfg, device=device)


__all__ = ["NGramConfig", "NGramStats", "run_job", "METHODS", "PLANS", "oracle",
           "suffix_sigma", "naive", "apriori_scan", "apriori_index"]
