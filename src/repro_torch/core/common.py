"""Shared machinery of the baseline methods (NAIVE, APRIORI-SCAN, APRIORI-INDEX)
(port of ``repro.core.common``).

All three count *whole grams* (full-row equality runs after the sort), unlike
SUFFIX-sigma, which counts every prefix of every suffix.  The helpers here
emit k-gram records, count them exactly (with optional position payloads,
which APRIORI-INDEX joins on), and keep the APRIORI dictionary: a sorted
array of gram hashes probed by binary search.

The emit runs no ``[N, sigma]`` window tensor.  The ``suffix_pack`` kernel
packs each position's sigma-truncated, PAD-masked suffix into lanes; the
k-gram at position ``p`` is those lanes AND ``prefix_lane_masks[k]``, and it
exists exactly when term slot ``k - 1`` of the lanes is not PAD.

The multi-device helpers serve all four methods' jobs on a
:class:`~repro_torch.launch.mesh.DataMesh`: :func:`shard_rows` takes this
rank's row of the padded ``[P, n_local]`` split, :func:`halo` brings the next
rank's first tokens (``repro``'s ``ppermute`` i -> i - 1; zero on the last
rank), and :func:`gather_stats` merges every rank's reducer output as
``repro`` merges the rows of its sharded output: ``NGramStats`` of each
part in rank order, the counters on the first.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import U32, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce.shuffle import fold_hash as gram_hash
from repro_torch.pipeline import stages

__all__ = ["as_tokens", "run_single_device", "suffix_lanes", "prefix_masks",
           "term_present", "kgram_records", "membership_hashes", "member",
           "count_exact_grams", "gram_hash", "shard_rows", "halo",
           "shard_with_halo", "pair_capacity", "gather_stats"]


def as_tokens(tokens, device) -> torch.Tensor:
    """``tokens`` as a 1-D int32 tensor on ``device`` (see
    :func:`repro_torch.resolve_device`: the card unless told otherwise)."""
    device = resolve_device(device)
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(tokens, np.int32), device=device)


def run_single_device(tokens, cfg, plan, *, device=None, bucket_ids=None):
    """Run ``plan`` over the whole corpus on one device: every method's
    ``run`` without a mesh (or on a mesh of one device).  ``tokens``: 1-D,
    PAD(0)-separated documents; ``bucket_ids``: a time-series bucket a
    position (SUFFIX-sigma only).

    Runs on the card unless ``device`` says otherwise (see
    :func:`repro_torch.resolve_device`).
    """
    from repro_torch.pipeline.executor import run_plan
    return run_plan(as_tokens(tokens, device), cfg, bucket_ids=bucket_ids,
                    plan=plan)


# ------------------------------------------------------------- across ranks
def shard_rows(values, mesh) -> tuple[np.ndarray | torch.Tensor, int]:
    """(this rank's row of ``values`` split as ``[P, n_local]``, zero-padded
    at the end; ``n_local``).  Only that row is read."""
    n = len(values)
    n_local = -(-n // mesh.size)
    lo = min(mesh.rank * n_local, n)
    own = values[lo:lo + n_local]
    pad = n_local - len(own)
    if isinstance(own, torch.Tensor):
        return torch.cat([own, own.new_zeros(pad)]) if pad else own, n_local
    own = np.asarray(own)
    # a copy: the caller may hand a read-only (memory-mapped) corpus
    return (np.pad(own, (0, pad)) if pad else own.copy()), n_local


def halo(head: torch.Tensor, mesh) -> torch.Tensor:
    """The next rank's ``head`` (every rank's is the same length), zero on
    the last rank: ``repro``'s ``ppermute`` i -> i - 1 with the last rank's
    halo zeroed, as one gather of the small heads."""
    if mesh.rank == mesh.size - 1:
        mesh.all_gather(head)                   # every rank takes part
        return torch.zeros_like(head)
    return mesh.all_gather(head)[mesh.rank + 1]


def shard_with_halo(tokens, sigma: int, mesh, device) -> tuple[torch.Tensor, int]:
    """(this rank's tokens and the next rank's first sigma - 1 as its halo,
    ``n_local``): the window each rank's map emits over; positions past
    ``n_local`` belong to the neighbour."""
    own, n_local = shard_rows(tokens, mesh)
    tok = as_tokens(own, device)
    if sigma == 1:
        return tok, n_local
    return torch.cat([tok, halo(tok[:sigma - 1], mesh)]), n_local


def pair_capacity(cfg, n_local: int, mesh, records_a_position: int = 1) -> int:
    """The first capacity of each (source, destination) pair of a job's
    shuffle, as ``repro`` sizes it: ``capacity_factor`` times a rank's
    records spread evenly over the ranks, at least 8."""
    return max(8, int(cfg.capacity_factor * n_local * records_a_position
                      / mesh.size) + 1)


def gather_stats(dense, tau: int, mesh, counters: dict | None = None):
    """Every rank's reducer output (terms, flags, counts), kept at ``tau``,
    merged on every rank: ``NGramStats`` of rank 0's part (with
    ``counters``), then each other rank's, concatenated in rank order."""
    from repro_torch.core.stats import NGramStats
    from repro_torch.pipeline.executor import materialize
    part = materialize(dense, tau)
    out = None
    for p, (g, ln, c) in enumerate(mesh.all_gather_object(
            (part.grams, part.lengths, part.counts))):
        st = NGramStats(g, ln, c, dict(counters or {}) if p == 0 else {})
        out = st if out is None else out.merged_with(st)
    return out


def suffix_lanes(tokens: torch.Tensor, sigma: int, vocab_size: int) -> torch.Tensor:
    """Packed sigma-truncated suffix lanes [N, n_lanes] int64 of every position."""
    return kops.suffix_pack(tokens, sigma=sigma, vocab_size=vocab_size)


@functools.lru_cache(maxsize=None)
def _mask_tables(sigma: int, vocab_size: int, device: torch.device):
    """(prefix masks [sigma + 1, n_lanes], the lane of each term slot
    [sigma], the slot's bits in it [sigma]) as int64 on ``device``, and the
    last two as numpy.  Made once per (sigma, vocab, device): a copy from
    the host waits for the card, and a wave's dispatch makes none."""
    masks = packing.prefix_lane_masks(sigma, vocab_size).astype(np.int64)
    field = masks[1:] ^ masks[:-1]            # [sigma, n_lanes]: slot l's bits
    lane = field.argmax(axis=1)               # the one lane each slot lies in
    bits = field[np.arange(sigma), lane]
    return (torch.as_tensor(masks, device=device),
            torch.as_tensor(lane, device=device),
            torch.as_tensor(bits, device=device), lane, bits)


def prefix_masks(sigma: int, vocab_size: int, device) -> torch.Tensor:
    """``prefix_lane_masks`` [sigma + 1, n_lanes] as int64 on ``device`` (a
    shared tensor: read it, never write it): ``lanes & masks[l]`` packs the
    length-``l`` prefix."""
    return _mask_tables(sigma, vocab_size, torch.device(device))[0]


def term_present(lanes: torch.Tensor, sigma: int, vocab_size: int,
                 slot: int | None = None) -> torch.Tensor:
    """Whether term slot ``l`` (0-based) of each lane row holds a term.

    ``slot``: one slot -> bool [N]; None -> every slot, bool [N, sigma].
    Suffix lanes are PAD-masked, so slot ``l`` holds a term exactly when the
    position's suffix is longer than ``l``.
    """
    _, lane_t, bits_t, lane, bits = _mask_tables(sigma, vocab_size, lanes.device)
    if slot is not None:
        return (lanes[:, int(lane[slot])] & int(bits[slot])) != 0
    return (lanes[:, lane_t] & bits_t) != 0


def kgram_records(tokens: torch.Tensor, k: int, sigma: int, vocab_size: int,
                  weight_mask: torch.Tensor | None = None,
                  with_positions: bool = False, *,
                  lanes: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Records for the k-grams starting at every position (sigma-lane packing).

    Returns (records [N, n_lanes + 1 (+ 1)] int64 = lanes | weight | (pos),
    valid [N] bool).  ``weight_mask``: optional bool [N] further restricting
    which positions emit; invalid rows have zero lanes and weight and, with
    positions, keep their own position.  ``lanes``: the tokens' suffix lanes
    when the caller has them already (one ``suffix_pack`` launch a round).
    """
    if lanes is None:
        lanes = suffix_lanes(tokens, sigma, vocab_size)
    n, n_l = lanes.shape
    valid = term_present(lanes, sigma, vocab_size, k - 1)
    if weight_mask is not None:
        valid &= weight_mask
    records = torch.empty((n, n_l + 1 + int(with_positions)), dtype=torch.int64,
                          device=lanes.device)
    torch.bitwise_and(lanes, prefix_masks(sigma, vocab_size, lanes.device)[k],
                      out=records[:, :n_l])
    records[:, :n_l] *= valid[:, None]
    records[:, n_l] = valid
    if with_positions:
        records[:, n_l + 1] = torch.arange(n, device=lanes.device)
    return records, valid


def membership_hashes(lanes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Sorted hash set (uint32 values, int64) of the valid grams -- the APRIORI
    dictionary; invalid rows hash to ``0xFFFFFFFF``.

    Hash collisions only ever *weaken pruning* (extra candidates), never drop
    a frequent gram: the round's exact count filters them again.
    """
    h = torch.where(valid, gram_hash(lanes), U32)
    return torch.sort(h).values


def member(sorted_hashes: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Whether each query hash lies in ``sorted_hashes`` (binary search)."""
    idx = torch.searchsorted(sorted_hashes, queries)
    idx = idx.clamp_(max=sorted_hashes.shape[0] - 1)
    return sorted_hashes[idx] == queries


def count_exact_grams(records: torch.Tensor, *, sigma: int, vocab_size: int,
                      with_positions: bool = False,
                      n_positions: int | None = None):
    """Sort + count identical grams in ``records`` = [N, lanes | weight | (pos)]:
    ``stages.sort_stage`` then ``stages.reduce_exact``."""
    rec = stages.sort_stage(records, n_keys=packing.n_lanes(sigma, vocab_size))
    return stages.reduce_exact(rec, sigma=sigma, vocab_size=vocab_size,
                               with_positions=with_positions,
                               n_positions=n_positions)
