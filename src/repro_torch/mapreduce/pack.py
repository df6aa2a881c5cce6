"""Vocab-adaptive bit packing of term-id lanes (port of ``repro.mapreduce.pack``).

Several term ids pack into each 32-bit lane, most significant first, so that
ascending lexicographic order of the packed lanes is ascending lexicographic
order of the term sequences (PAD = 0 sorts before every real term).  Lanes are
``torch.int64`` holding the uint32 value (see the package docstring); the
arithmetic masks with ``U32`` so that even out-of-range ids wrap exactly as
the uint32 packer of ``repro`` does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import U32

PAD_ID = 0  # reserved: sorts first, marks end-of-document / end-of-suffix


def bits_for_vocab(vocab_size: int) -> int:
    """Bits per term id (ids are 1..vocab_size, 0 is PAD)."""
    if vocab_size < 1:
        raise ValueError(f"vocab_size must be >= 1, got {vocab_size}")
    return max(1, math.ceil(math.log2(vocab_size + 1)))


def terms_per_lane(vocab_size: int) -> int:
    return max(1, 32 // bits_for_vocab(vocab_size))


def n_lanes(sigma: int, vocab_size: int) -> int:
    return (sigma + terms_per_lane(vocab_size) - 1) // terms_per_lane(vocab_size)


def _shifts(vocab_size: int, device) -> torch.Tensor:
    bits = bits_for_vocab(vocab_size)
    per = terms_per_lane(vocab_size)
    return torch.arange(per - 1, -1, -1, device=device) * bits


def pack_terms(terms: torch.Tensor, *, vocab_size: int) -> torch.Tensor:
    """Pack ``terms`` [..., sigma] (PAD=0) into int64 lanes [..., n_lanes].

    Earlier terms occupy more-significant bits, so lane-major ascending order
    is lexicographic term order.
    """
    sigma = terms.shape[-1]
    per = terms_per_lane(vocab_size)
    lanes = n_lanes(sigma, vocab_size)
    t = terms.to(torch.int64) & U32
    if lanes * per != sigma:
        t = torch.nn.functional.pad(t, (0, lanes * per - sigma))
    t = t.reshape(t.shape[:-1] + (lanes, per))
    return ((t << _shifts(vocab_size, t.device)) & U32).sum(dim=-1) & U32


def pack_terms_np(terms: np.ndarray, *, vocab_size: int) -> np.ndarray:
    """Host numpy mirror of :func:`pack_terms` -> uint32 lanes."""
    sigma = terms.shape[-1]
    bits = bits_for_vocab(vocab_size)
    per = terms_per_lane(vocab_size)
    lanes = n_lanes(sigma, vocab_size)
    pad_to = lanes * per
    t = terms.astype(np.uint32)
    if pad_to != sigma:
        pad_width = [(0, 0)] * (t.ndim - 1) + [(0, pad_to - sigma)]
        t = np.pad(t, pad_width)
    t = t.reshape(t.shape[:-1] + (lanes, per))
    shifts = np.arange(per - 1, -1, -1, dtype=np.uint32) * np.uint32(bits)
    return (t << shifts).sum(axis=-1, dtype=np.uint32)


def prefix_lane_masks(sigma: int, vocab_size: int) -> np.ndarray:
    """AND-masks [sigma + 1, n_lanes] uint32 reducing packed lanes to prefixes.

    ``lanes & masks[l]`` zeroes the bit field of every term slot past the
    first ``l``, which equals ``pack_terms`` of the length-``l`` prefix.
    """
    bits = bits_for_vocab(vocab_size)
    per = terms_per_lane(vocab_size)
    lanes = n_lanes(sigma, vocab_size)
    field = (1 << bits) - 1
    masks = np.zeros((sigma + 1, lanes), np.uint32)
    for l in range(sigma + 1):
        for j in range(lanes):
            m = 0
            for i in range(per):
                if j * per + i < l:
                    m |= field << ((per - 1 - i) * bits)
            masks[l, j] = np.uint32(m & U32)
    return masks


def unpack_terms(lanes_arr: torch.Tensor, *, vocab_size: int,
                 sigma: int) -> torch.Tensor:
    """Inverse of :func:`pack_terms` -> int32 [..., sigma]."""
    bits = bits_for_vocab(vocab_size)
    mask = (1 << bits) - 1 if bits < 32 else U32
    t = (lanes_arr[..., None] >> _shifts(vocab_size, lanes_arr.device)) & mask
    t = t.reshape(t.shape[:-2] + (t.shape[-2] * t.shape[-1],))
    # uint32 -> int32 reinterpretation, as ``astype(int32)`` does in repro
    return t[..., :sigma].to(torch.int32)


def lead_term(lane0: torch.Tensor, *, vocab_size: int) -> torch.Tensor:
    """First (most significant) term id of lane 0 -- the shuffle/serving key."""
    shift = (terms_per_lane(vocab_size) - 1) * bits_for_vocab(vocab_size)
    return (lane0 & U32) >> shift


def record_width(sigma: int, vocab_size: int, n_meta: int = 0) -> int:
    """Lanes per shuffle record: packed suffix + weight lane + meta lanes."""
    return n_lanes(sigma, vocab_size) + 1 + n_meta


def record_bytes(sigma: int, vocab_size: int, n_meta: int = 0) -> int:
    """MAP_OUTPUT_BYTES per record: 4 bytes per lane, as the paper counts."""
    return 4 * record_width(sigma, vocab_size, n_meta)
