"""The model stack (port of ``repro.models``): ``layers``, ``moe`` and
``transformer`` for the LMs, ``recsys`` and ``gnn``."""
from . import gnn, layers, moe, recsys, transformer

__all__ = ["gnn", "layers", "moe", "recsys", "transformer"]
