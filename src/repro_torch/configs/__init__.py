"""Importing this package registers the port's architectures into the arch
registry (``configs.base``): the five LM archs of ``repro``.

``repro``'s other registered archs are not ported yet, and
:data:`NOT_PORTED` names them with their family: the GNN (gin-tu), the four
recsys models (bst, autoint, two-tower-retrieval, xdeepfm) and the paper's
own n-gram workload as a dry-run cell (ngram-suffix-sigma).
"""
from . import base
from . import (deepseek_moe_16b, llama3_2_1b, minicpm3_4b,  # noqa: F401
               mixtral_8x7b, phi3_medium_14b)
from .base import all_archs, all_cells, get

NOT_PORTED = {
    "gin-tu": "gnn", "bst": "recsys", "autoint": "recsys",
    "two-tower-retrieval": "recsys", "xdeepfm": "recsys",
    "ngram-suffix-sigma": "ngram",
}

__all__ = ["base", "get", "all_archs", "all_cells", "NOT_PORTED"]
