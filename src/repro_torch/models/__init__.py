"""The LM model stack (port of ``repro.models``'s LM half): ``layers``,
``moe`` and ``transformer``.  ``repro``'s ``gnn`` and ``recsys`` models
are not ported yet."""
from . import layers, moe, transformer

__all__ = ["layers", "moe", "transformer"]
