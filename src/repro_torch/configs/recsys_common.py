"""Shared shapes of the four recsys architectures (port of
``repro.configs.recsys_common``'s ``SHAPES``).

serve_* shapes are a pure forward (no optimizer state); retrieval_cand
scores one query against 1M candidates (batched dot / full item-tower sweep
-- never a loop).  ``repro``'s ``make_recsys_cell`` builds a dry-run cell on
a TPU mesh and is not ported (``ROADMAP.md``, the dry-run question)."""
from __future__ import annotations

from .base import ShapeDef

SHAPES = {
    "train_batch": ShapeDef("train_batch", "train", {"batch": 65_536}),
    "serve_p99": ShapeDef("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeDef("serve_bulk", "serve", {"batch": 262_144}),
    "retrieval_cand": ShapeDef("retrieval_cand", "serve",
                               {"batch": 1, "n_candidates": 1_000_000}),
}
