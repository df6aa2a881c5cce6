"""Fixed-width bit streams over uint32 words (port of ``repro.kernels.bitpack``).

A stream stores n values of a common ``width`` (<= 32 bits) back to back,
LSB-first: bit b of the stream lives in word ``b >> 5`` at in-word position
``b & 31``, and value i occupies stream bits [i*width, (i+1)*width).  Packing
runs in torch on the values' device (:func:`pack_words`); the port keeps
the words as ``torch.int32`` tensors holding the uint32 bit pattern, so a
stream's bytes equal ``repro``'s.  :func:`extract_bits` reads them in torch:
each fetched word is widened to int64 and masked with ``U32`` before any
shift, because torch's int32 ``>>`` sign-extends.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import U32, u32_words


def words_for(n_values: int, width: int) -> int:
    return -(-(n_values * width) // 32)


def pack_words(values: torch.Tensor, width: int,
               n_words: int | None = None) -> torch.Tensor:
    """Pack ``values`` (integers in ``[0, 2**width)``) into a word stream on
    their device: an int32 tensor of the uint32 words.

    ``n_words`` pads the stream with zero words that no real index addresses.
    The fields of a stream never overlap, so each word is the sum of the
    value bits that land in it: two ``index_add_`` passes (the in-word part,
    then the spill into the next word where a value carries past bit 31)
    build it with integer adds, the same on the card and the host.
    """
    values = values.reshape(-1).to(torch.int64)
    n = values.shape[0]
    if width < 0 or width > 32:
        raise ValueError(f"width must be in [0, 32], got {width}")
    if n and int(values.min()) < 0:
        raise ValueError(f"negative value {int(values.min())} in a bit stream")
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
    words = torch.zeros(nw + 1, dtype=torch.int64, device=values.device)
    if width and n:
        bitpos = torch.arange(n, dtype=torch.int64, device=values.device) * width
        w = bitpos >> 5
        shifted = values << (bitpos & 31)           # < 2**63: width + 31 bits
        words.index_add_(0, w, shifted & U32)
        words.index_add_(0, w + 1, shifted >> 32)   # zero past the last word
    return u32_words(words[:nw], values.device)


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
