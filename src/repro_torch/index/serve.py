"""Serving-side index description (the single-device part of
``repro.index.serve``).

:func:`describe_topology` reports how queries route to data, for the
frontend's ``/v1/system/topology``: the generational segment stack (newest
first, with stable level ids so clients can diff generations), or one
frozen index.  The sharded index and its ``serve`` path wait for the
multi-device slice, and with them the sharded kinds of this description.

Every number is read on the host: row counts from the generational index's
host ledger (:attr:`GenerationalIndex.level_rows`) and bytes from tensor
shapes, so a transport thread that asks never waits on the device and never
builds a level's query artifact.  A level no query has read yet therefore
reports its bare segment's bytes, where ``repro`` would build the artifact
first.
"""
from __future__ import annotations

from .merge import GenerationalIndex

__all__ = ["describe_topology"]


def describe_topology(index_like) -> dict:
    """JSON-able segment map of a :class:`GenerationalIndex` (kind
    ``"generational"``) or of one flat or compressed index (kind
    ``"index"``)."""
    if isinstance(index_like, GenerationalIndex):
        levels = index_like.levels
        return {
            "kind": "generational",
            "generation": int(index_like.generation),
            "n_segments": int(index_like.n_segments),
            "n_rows": int(index_like.n_rows),
            "nbytes": int(index_like.nbytes),
            "compress": bool(index_like.compress),
            "segments": [{"level_id": int(lid), "rows": int(rows),
                          "nbytes": int(ix.nbytes)}
                         for lid, rows, ix in zip(index_like.level_ids,
                                                  index_like.level_rows, levels)],
        }
    # single frozen index (flat or compressed): one segment, no routing
    return {"kind": "index", "rows": int(index_like.n_rows),
            "nbytes": int(index_like.nbytes)}
