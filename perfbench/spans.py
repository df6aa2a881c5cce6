"""Reading the program's spans (``repro_torch.obs.trace`` events: name,
``ts`` and ``dur`` in microseconds) job by job."""
from __future__ import annotations

__all__ = ["per_root"]


def per_root(spans: list, root: str, children: tuple[str, ...]) -> list[tuple[float, float]]:
    """(root's milliseconds, milliseconds of the named spans inside it) for
    every span named ``root``, in the order they started."""
    roots = sorted((e for e in spans if e["name"] == root), key=lambda e: e["ts"])
    kids = sorted((e for e in spans if e["name"] in children), key=lambda e: e["ts"])
    out = []
    for r in roots:
        lo, hi = r["ts"], r["ts"] + r["dur"]
        inside = sum(e["dur"] for e in kids if lo <= e["ts"] and e["ts"] + e["dur"] <= hi)
        out.append((r["dur"] / 1e3, inside / 1e3))
    return out
