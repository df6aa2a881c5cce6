"""Fixed-width bit streams over uint32 words (port of ``repro.kernels.bitpack``).

A stream stores n values of a common ``width`` (<= 32 bits) back to back,
LSB-first: bit b of the stream lives in word ``b >> 5`` at in-word position
``b & 31``, and value i occupies stream bits [i*width, (i+1)*width).  Packing
is host numpy at build time (:func:`pack_bits`, uint32 words); the port keeps
the words as ``torch.int32`` tensors holding the uint32 bit pattern, so a
stream's bytes equal ``repro``'s.  :func:`extract_bits` reads them in torch:
each fetched word is widened to int64 and masked with ``U32`` before any
shift, because torch's int32 ``>>`` sign-extends.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import U32


def words_for(n_values: int, width: int) -> int:
    return -(-(n_values * width) // 32)


def pack_bits(values: np.ndarray, width: int,
              n_words: int | None = None) -> np.ndarray:
    """Pack ``values`` (uint, each < 2**width) into a uint32 word stream.

    ``n_words`` pads the stream with zero words that no real index addresses.
    """
    values = np.asarray(values, np.uint64)
    n = values.shape[0]
    if width < 0 or width > 32:
        raise ValueError(f"width must be in [0, 32], got {width}")
    if width and n and int(values.max()) >> width:
        raise ValueError(f"value {int(values.max())} overflows width {width}")
    if n * width >= 1 << 32:
        # bit positions are uint32 in extract_bits and in the decode kernels;
        # past 2^32 bits they would wrap and read garbage silently
        raise ValueError(f"stream of {n}x{width} bits exceeds the uint32 "
                         "bit-address space; shard the index instead")
    need = words_for(n, width)
    nw = need if n_words is None else n_words
    if nw < need:
        raise ValueError(f"n_words={nw} < required {need}")
    words = np.zeros((nw,), np.uint32)
    if width == 0 or n == 0:
        return words
    bitpos = np.arange(n, dtype=np.uint64) * np.uint64(width)
    # each value straddles at most two words: scatter the in-word part, then
    # the spill into the next word where the shifted value carries past bit 31
    w = (bitpos >> np.uint64(5)).astype(np.int64)
    shifted = values << (bitpos & np.uint64(31))
    np.bitwise_or.at(words, w,
                     (shifted & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    spill = shifted >> np.uint64(32)
    lanes = np.nonzero(spill)[0]
    if lanes.size:
        np.bitwise_or.at(words, w[lanes] + 1, spill[lanes].astype(np.uint32))
    return words


def as_words(words: np.ndarray, device) -> torch.Tensor:
    """A uint32 numpy word array as the port's int32 bit-pattern tensor."""
    words = np.require(words, np.uint32, ["C_CONTIGUOUS", "WRITEABLE"])
    return torch.as_tensor(words.view(np.int32), device=device)


def words_u32(words: torch.Tensor) -> np.ndarray:
    """The uint32 numpy view of a stream tensor (inverse of :func:`as_words`)."""
    return words.cpu().numpy().view(np.uint32)


def fetch_u32(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Words at ``idx`` (already in range) as int64 uint32 values."""
    return words[idx].to(torch.int64) & U32


def extract_bits(words: torch.Tensor, idx: torch.Tensor, width: int) -> torch.Tensor:
    """Values [*idx.shape] int64 (uint32 range) at stream positions ``idx``.

    Out-of-range or negative positions read garbage but never fault: the
    position wraps as a uint32, and both word fetches are clamped into the
    stream, exactly as ``repro`` clamps them.
    """
    if width == 0 or words.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=torch.int64, device=words.device)
    nw = words.shape[0]
    bitp = ((idx.to(torch.int64) & U32) * width) & U32
    w_lo = (bitp >> 5).clamp(0, nw - 1)
    w_hi = (w_lo + 1).clamp(0, nw - 1)
    sh = bitp & 31
    lo = fetch_u32(words, w_lo) >> sh
    # (32 - sh) & 31 keeps the shift in range; the sh == 0 lane is masked
    hi = torch.where(sh > 0, (fetch_u32(words, w_hi) << ((32 - sh) & 31)) & U32, 0)
    return (lo | hi) & ((1 << width) - 1)
