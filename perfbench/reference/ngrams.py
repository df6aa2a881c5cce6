"""Plain PyTorch reference of the n-gram counts the benchmark checks.

Nothing here imports the program under test.  Every count is worked out
again from the token stream that the benchmark made.  An n-gram is a run of
n non-PAD terms inside one segment (a delta of a stream; the whole corpus
for a job).  Its cf is the number of positions it starts at.

The method refines groups one length at a time.  Each position that starts
a length-n gram gets that gram's group id.  Group ids are ranks among the
distinct length-n grams in lexicographic order.  The id at length n + 1 is
the rank of the pair (id at length n, term n + 1).  A job keeps only the
groups with cf >= tau at each length.  By the APRIORI principle no gram
with an infrequent prefix can be frequent, so pruning loses nothing.

``count_dtype`` stores the counts in another type before they are
reported.  The benchmark's control uses it to store them in a 16-bit float.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["gram_levels", "job_counts", "StreamReference"]


def _stored(counts: torch.Tensor, count_dtype) -> torch.Tensor:
    """``counts`` (int64) as they read back after being kept in ``count_dtype``."""
    if count_dtype is None or count_dtype == torch.int64:
        return counts
    return counts.to(count_dtype).to(torch.int64)


def gram_levels(tok: torch.Tensor, sigma: int, *, tau: int = 1,
                seg: torch.Tensor | None = None):
    """Yield ``(n, pos, gid, cnt)`` for n = 1..sigma.

    ``pos`` [M] holds the positions that start a length-n gram.  With
    ``tau > 1`` only grams with cf >= tau are kept.  ``gid`` [M] gives each
    position its gram's rank in lexicographic order among the distinct
    length-n grams.  ``cnt`` is the cf of each rank.  ``tok`` is int64 with
    PAD = 0.  ``seg``, where given, is a segment id per position, and no gram
    crosses from one segment into another.
    """
    n_pos = tok.shape[0]
    base = int(tok.max()) + 1 if n_pos else 1
    pos = (tok != 0).nonzero().squeeze(1)
    key = tok[pos]
    gid = None
    for n in range(1, sigma + 1):
        if n > 1:
            nxt = pos + (n - 1)
            ok = nxt < n_pos
            pos, prev, nxt = pos[ok], gid[ok], nxt[ok]
            term = tok[nxt]
            ok = term != 0
            if seg is not None:
                ok &= seg[nxt] == seg[pos]
            pos, key = pos[ok], prev[ok] * base + term[ok]
        if pos.numel() == 0:
            return
        _, gid, cnt = torch.unique(key, return_inverse=True, return_counts=True)
        if tau > 1:
            keep = cnt[gid] >= tau
            pos, gid = pos[keep], gid[keep]
        yield n, pos, gid, cnt


def _first_position(gid: torch.Tensor, pos: torch.Tensor, n_groups: int) -> torch.Tensor:
    """The smallest position of each group id (``n_positions`` where none)."""
    first = torch.full((n_groups,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                       device=pos.device)
    return first.scatter_reduce_(0, gid, pos, reduce="amin", include_self=True)


def _gram_rows(tok: torch.Tensor, start: torch.Tensor, n: int, sigma: int) -> torch.Tensor:
    """[R, sigma] int32 rows: the n terms from each start, zero-padded."""
    rows = torch.zeros((start.shape[0], sigma), dtype=torch.int32, device=tok.device)
    if start.numel():
        rows[:, :n] = tok[start[:, None] + torch.arange(n, device=tok.device)[None, :]].to(
            torch.int32)
    return rows


def job_counts(tokens: torch.Tensor, sigma: int, tau: int, *, count_dtype=None):
    """Every gram of length <= sigma with cf >= tau, in canonical order
    (length, then terms lexicographic).  Returns host numpy
    (grams [R, sigma] int32, lengths [R] int32, counts [R] int64)."""
    tok = tokens.to(torch.int64)
    grams, lengths, counts = [], [], []
    for n, pos, gid, cnt in gram_levels(tok, sigma, tau=tau):
        kept = (cnt >= tau).nonzero().squeeze(1)
        if kept.numel() == 0:
            break
        first = _first_position(gid, pos, cnt.shape[0])
        grams.append(_gram_rows(tok, first[kept], n, sigma).cpu())
        lengths.append(torch.full((kept.shape[0],), n, dtype=torch.int32))
        counts.append(_stored(cnt[kept].to(torch.int64), count_dtype).cpu())
    if not grams:
        return (np.zeros((0, sigma), np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.int64))
    return (torch.cat(grams).numpy(), torch.cat(lengths).numpy(),
            torch.cat(counts).numpy())


class StreamReference:
    """The answers a streaming index owes after each of ``n_deltas`` deltas.

    ``tokens`` [N] is cut into deltas of ``delta_len`` positions.  Each
    delta is counted alone, as a job over it would count it, and keeps the
    grams with cf >= tau in it.  The index after delta d holds, for every
    gram, the sum of its kept counts over deltas 0..d.  ``queries`` lists
    the query rows ``(grams [R, sigma], lengths [R])`` whose answers are
    asked.  Each row is appended to the stream behind a PAD, so that a
    query gram gets the same group id as the corpus grams it equals.
    """

    def __init__(self, tokens: torch.Tensor, *, sigma: int, tau: int, n_deltas: int,
                 delta_len: int, queries: list, count_dtype=None):
        dev = tokens.device
        self.sigma, self.n_deltas = sigma, n_deltas
        n_corpus = tokens.shape[0]
        rows = torch.cat([g.to(device=dev, dtype=torch.int64) * (
            torch.arange(sigma, device=dev)[None, :] < ln.to(dev)[:, None])
            for g, ln in queries])
        self._starts, at = [], n_corpus + 1
        for g, _ in queries:
            self._starts.append(at + torch.arange(g.shape[0], device=dev) * (sigma + 1))
            at += g.shape[0] * (sigma + 1)
        self._lengths = [ln.to(device=dev, dtype=torch.int64) for _, ln in queries]
        tail = torch.cat([rows, rows.new_zeros((rows.shape[0], 1))], 1).view(-1)
        tok = torch.cat([tokens.to(torch.int64), tokens.new_zeros(1, dtype=torch.int64), tail])
        seg = torch.arange(tok.shape[0], device=dev) // delta_len
        seg[n_corpus:] = n_deltas                 # the queries: never counted
        self.tok = tok
        d1 = n_deltas + 1
        self._d1 = d1
        #: per length n: group id of every position (-1: no gram), the kept
        #: (group, delta) keys in order, their counts' prefix sums, and each
        #: group's first corpus position, prefix group and last term
        self.gid, self.fkey, self.fcs, self.fcnt = {}, {}, {}, {}
        self.first, self.parent, self.last = {}, {}, {}
        prev_full = None
        for n, pos, gid, cnt in gram_levels(tok, sigma, seg=seg):
            full = torch.full((tok.shape[0],), -1, dtype=torch.int64, device=dev)
            full[pos] = gid
            self.gid[n] = full
            in_corpus = pos < n_corpus
            cpos, cgid = pos[in_corpus], gid[in_corpus]
            key, c = torch.unique(cgid * d1 + seg[cpos], return_counts=True)
            keep = c >= tau
            key, c = key[keep], _stored(c[keep].to(torch.int64), count_dtype)
            self.fkey[n], self.fcnt[n] = key, c
            self.fcs[n] = torch.cat([c.new_zeros(1), torch.cumsum(c, 0)])
            self.first[n] = _first_position(cgid, cpos, cnt.shape[0])
            if n > 1:
                self.parent[n] = torch.zeros(cnt.shape[0], dtype=torch.int64,
                                             device=dev).scatter_(0, gid, prev_full[pos])
                self.last[n] = torch.zeros(cnt.shape[0], dtype=torch.int64,
                                           device=dev).scatter_(0, gid, tok[pos + n - 1])
            prev_full = full

    def _query_gid(self, block: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(group id at its own length, length) of each row of query block ``block``."""
        start, length = self._starts[block], self._lengths[block]
        gid = torch.full_like(start, -1)
        for n, full in self.gid.items():
            at = length == n
            gid[at] = full[start[at]]
        return gid, length

    def lookups(self, block: int, d: int) -> np.ndarray:
        """cf [R] int64 of query block ``block``'s grams after delta ``d``."""
        gid, length = self._query_gid(block)
        out = torch.zeros_like(gid)
        for n in self.fkey:
            at = ((length == n) & (gid >= 0)).nonzero().squeeze(1)
            if at.numel() == 0 or self.fkey[n].numel() == 0:
                continue
            q = gid[at] * self._d1
            lo = torch.searchsorted(self.fkey[n], q)
            hi = torch.searchsorted(self.fkey[n], q + d, right=True)
            out[at] = self.fcs[n][hi] - self.fcs[n][lo]
        return out.cpu().numpy()

    def _kept_groups(self, n: int, d: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(group ids, cf) of the length-n grams the index holds after delta d."""
        key, c = self.fkey[n], self.fcnt[n]
        sel = key % self._d1 <= d
        g = key[sel] // self._d1
        if g.numel() == 0:
            return g, c[sel]
        uniq, inv = torch.unique_consecutive(g, return_inverse=True)
        return uniq, torch.zeros(uniq.shape[0], dtype=torch.int64,
                                 device=g.device).index_add_(0, inv, c[sel])

    def continuations(self, block: int, d: int, k: int) -> np.ndarray:
        """[R, 2 + 2k] int64 rows (distinct | total | k terms | k cfs) of the
        prefixes of query block ``block`` after delta ``d``: the grams one
        term longer that the index holds, ranked by cf descending and then by
        the next term ascending."""
        gid, length = self._query_gid(block)
        out = torch.zeros((gid.shape[0], 2 + 2 * k), dtype=torch.int64, device=gid.device)
        for m in range(1, self.sigma):
            at = ((length == m) & (gid >= 0)).nonzero().squeeze(1)
            if at.numel() == 0 or (m + 1) not in self.fkey:
                continue
            g, cf = self._kept_groups(m + 1, d)
            if g.numel() == 0:
                continue
            parent, last = self.parent[m + 1][g], self.last[m + 1][g]
            order = torch.argsort(last, stable=True)
            order = order[torch.argsort(-cf[order], stable=True)]
            order = order[torch.argsort(parent[order], stable=True)]
            parent, last, cf = parent[order], last[order], cf[order]
            cs = torch.cat([cf.new_zeros(1), torch.cumsum(cf, 0)])
            q = gid[at]
            lo = torch.searchsorted(parent, q)
            hi = torch.searchsorted(parent, q, right=True)
            idx = lo[:, None] + torch.arange(k, device=q.device)[None, :]
            inside = idx < hi[:, None]
            safe = idx.clamp(max=parent.shape[0] - 1)
            out[at, 0] = hi - lo
            out[at, 1] = cs[hi] - cs[lo]
            out[at, 2:2 + k] = torch.where(inside, last[safe], 0)
            out[at, 2 + k:] = torch.where(inside, cf[safe], 0)
        return out.cpu().numpy()

    def index(self, d: int):
        """Every row the index holds after delta ``d``, in canonical order:
        host numpy (grams [R, sigma] int32, lengths [R] int32, counts [R] int64)."""
        grams, lengths, counts = [], [], []
        for n in self.fkey:
            g, cf = self._kept_groups(n, d)
            grams.append(_gram_rows(self.tok, self.first[n][g], n, self.sigma).cpu())
            lengths.append(torch.full((g.shape[0],), n, dtype=torch.int32))
            counts.append(cf.cpu())
        if not grams:
            return (np.zeros((0, self.sigma), np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.int64))
        return (torch.cat(grams).numpy(), torch.cat(lengths).numpy(),
                torch.cat(counts).numpy())
