"""Importing this package registers the port's architectures into the arch
registry (``configs.base``): the ten archs ``repro`` is assigned
(:data:`ASSIGNED`): five LMs, the GNN and four recsys models; and the
paper's own n-gram workload as the 11th, a dry-run cell
(ngram-suffix-sigma).  :data:`NOT_PORTED` names the archs of ``repro`` the
port lacks: none.
"""
from . import base
from . import (autoint, bst, deepseek_moe_16b, gin_tu, llama3_2_1b,  # noqa: F401
               minicpm3_4b, mixtral_8x7b, paper, phi3_medium_14b,
               two_tower_retrieval, xdeepfm)
from .base import all_archs, all_cells, get

ASSIGNED = [
    "deepseek-moe-16b", "mixtral-8x7b", "minicpm3-4b", "phi3-medium-14b",
    "llama3.2-1b", "gin-tu", "bst", "autoint", "two-tower-retrieval", "xdeepfm",
]

NOT_PORTED: dict[str, str] = {}

__all__ = ["base", "get", "all_archs", "all_cells", "ASSIGNED", "NOT_PORTED"]
