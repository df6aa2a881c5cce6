"""The paper's contribution on PyTorch: n-gram statistics jobs.

``run_job`` dispatches on ``NGramConfig.method`` over the paper's four
methods, on one device or across the ranks of a ``mesh``
(:class:`~repro_torch.launch.mesh.DataMesh`); SUFFIX-sigma also counts
per-bucket time series (``bucket_ids=``).  ``extensions`` filters a job's
output to its maximal or closed n-grams and ``aggregations`` counts beyond
occurrences (document frequencies, postings).
"""
from __future__ import annotations

from . import (aggregations, apriori_index, apriori_scan, extensions, naive,
               oracle, suffix_sigma)
from .extensions import filter_stats as extensions_filter
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


def run_job(tokens, cfg: NGramConfig, mesh=None, *, device=None,
            **kw) -> NGramStats:
    """Run the job ``cfg`` over a PAD-separated token stream.

    ``mesh``: a :class:`~repro_torch.launch.mesh.DataMesh` of P > 1 ranks
    runs the method's distributed job; every rank calls ``run_job`` with
    the same arguments and gets the same output.  ``kw`` goes to the
    method's ``run``: SUFFIX-sigma takes ``bucket_ids`` (a time-series
    bucket a position); the other methods take none and raise
    ``TypeError``, as in ``repro``.  Runs on the card unless ``device``
    says otherwise; with no card and no ``device`` it raises rather than
    running on the CPU.
    """
    try:
        fn = METHODS[cfg.method]
    except KeyError:
        raise ValueError(f"unknown method {cfg.method!r}; "
                         f"options: {sorted(METHODS)}") from None
    return fn(tokens, cfg, mesh=mesh, device=device, **kw)


__all__ = ["NGramConfig", "NGramStats", "run_job", "METHODS", "PLANS", "oracle",
           "suffix_sigma", "naive", "apriori_scan", "apriori_index",
           "extensions", "extensions_filter", "aggregations"]
