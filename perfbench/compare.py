"""The comparisons that decide ``correct``: host numpy, exact.

Each comparison returns plain counts of what differs.  Every limit is 0,
because every output is an integer count or a row of term ids.
"""
from __future__ import annotations

import numpy as np

__all__ = ["row_keys", "compare_rows", "canonical", "union_rows", "Checks"]


def row_keys(grams: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """One opaque, comparable key a row: its length and its terms."""
    g = np.ascontiguousarray(np.concatenate(
        [np.asarray(lengths, np.int32)[:, None], np.asarray(grams, np.int32)], axis=1))
    return g.view(np.dtype((np.void, g.dtype.itemsize * g.shape[1]))).ravel()


def compare_rows(want, got) -> dict:
    """(grams, lengths, counts) of the reference against the program's.

    Returns ``missing`` (reference rows the program lacks), ``extra`` (rows
    the program has beyond the reference, repeats included), ``counts``
    (shared rows whose count differs) and ``order`` (1 if every row and count
    agrees but not in the reference's order, else 0).
    """
    wg, wl, wc = want
    gg, gl, gc = got
    if (np.asarray(gg).shape[1:] == np.asarray(wg).shape[1:]
            and np.array_equal(wg, gg) and np.array_equal(wl, gl)
            and np.array_equal(np.asarray(wc, np.int64), np.asarray(gc, np.int64))):
        return {"missing": 0, "extra": 0, "counts": 0, "order": 0}
    kw, kg = row_keys(wg, wl), row_keys(gg, gl)
    uniq_g = np.unique(kg)
    _, iw, ig = np.intersect1d(kw, kg, assume_unique=False, return_indices=True)
    missing = int(len(kw) - len(iw))
    extra = int(len(kg) - len(iw))
    wrong = int(np.count_nonzero(np.asarray(wc, np.int64)[iw] != np.asarray(gc, np.int64)[ig]))
    if len(uniq_g) != len(kg):
        wrong = max(wrong, 1)
    order = int(missing == 0 and extra == 0 and wrong == 0)
    return {"missing": missing, "extra": extra, "counts": wrong, "order": order}


def _order(grams: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    sigma = grams.shape[1]
    return np.lexsort(tuple(grams[:, i] for i in range(sigma - 1, -1, -1)) + (lengths,))


def canonical(grams, lengths, counts):
    """The rows put in canonical order (length, then terms lexicographic),
    repeats kept."""
    grams, lengths = np.asarray(grams, np.int32), np.asarray(lengths, np.int32)
    order = _order(grams, lengths)
    return grams[order], lengths[order], np.asarray(counts, np.int64)[order]


def union_rows(parts, sigma: int):
    """Rows summed over several (grams, lengths, counts) parts, in canonical
    order (length, then terms lexicographic)."""
    grams = np.concatenate([np.asarray(p[0], np.int32).reshape(-1, sigma) for p in parts]) \
        if parts else np.zeros((0, sigma), np.int32)
    lengths = np.concatenate([np.asarray(p[1], np.int32) for p in parts]) \
        if parts else np.zeros(0, np.int32)
    counts = np.concatenate([np.asarray(p[2], np.int64) for p in parts]) \
        if parts else np.zeros(0, np.int64)
    if lengths.size == 0:
        return grams, lengths, counts
    grams, lengths, counts = canonical(grams, lengths, counts)
    new = np.ones(lengths.size, bool)
    new[1:] = (grams[1:] != grams[:-1]).any(axis=1) | (lengths[1:] != lengths[:-1])
    starts = np.flatnonzero(new)
    return grams[starts], lengths[starts], np.add.reduceat(counts, starts)


class Checks:
    """The numbers a run compares, each with its limit, in the order added."""

    def __init__(self):
        self.items: dict[str, dict] = {}

    def add(self, name: str, value, limit) -> None:
        self.items[name] = {"value": value, "limit": limit}

    @property
    def ok(self) -> bool:
        return all(v["value"] <= v["limit"] for v in self.items.values())

    def lines(self) -> list[str]:
        return [f"check {k} {v['value']} limit {v['limit']}" for k, v in self.items.items()]
