"""Public wrappers of the hand-written CUDA kernels (mirrors ``repro.kernels.ops``).

Each wrapper dispatches on the device of its input: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain PyTorch version in
``kernels.ref``.  There is no flag and no fallback from one to the other.
``launches[name]`` counts the kernel launches of each wrapper, so a run can
show that its main path went through the kernels.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.mapreduce import pack as packing
from . import ref

#: kernel name -> launches on CUDA tensors since the last ``launches.clear()``
launches: collections.Counter = collections.Counter()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected a {ndim}-d {dtype} tensor, got "
                        f"{t.dim()}-d {t.dtype}")


def _launch(name: str, device: torch.device, *args) -> None:
    from . import build
    fn = build.entries()[name]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    launches[name] += 1


def suffix_pack(tokens: torch.Tensor, *, sigma: int,
                vocab_size: int) -> torch.Tensor:
    """Packed sigma-truncated suffix lanes [N, n_lanes] int64 of a token stream."""
    if not tokens.is_cuda:
        return ref.suffix_pack_ref(tokens, sigma=sigma, vocab_size=vocab_size)
    _check(tokens, "suffix_pack tokens", torch.int32, 1)
    tokens = tokens.contiguous()
    n = tokens.shape[0]
    n_l = packing.n_lanes(sigma, vocab_size)
    out = torch.empty((n, n_l), dtype=torch.int64, device=tokens.device)
    if n:
        _launch("suffix_pack", tokens.device, tokens.data_ptr(), n, sigma,
                packing.bits_for_vocab(vocab_size),
                packing.terms_per_lane(vocab_size), n_l, out.data_ptr())
    return out


def hash_partition(keys: torch.Tensor, valid: torch.Tensor, *,
                   n_parts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(partition ids [N] int32, n_parts for invalid rows; histogram [n_parts] int32)."""
    if not keys.is_cuda:
        return ref.hash_partition_ref(keys, valid, n_parts)
    _check(keys, "hash_partition keys", torch.int64, 1)
    _check(valid, "hash_partition valid", torch.bool, 1)
    if valid.shape != keys.shape or not valid.is_cuda:
        raise ValueError("hash_partition: valid must be a CUDA tensor shaped like keys")
    if not 1 <= n_parts <= 12288:           # histogram bins in 48 KB of shared memory
        raise ValueError(f"hash_partition: n_parts {n_parts} outside [1, 12288]")
    keys, valid = keys.contiguous(), valid.contiguous()
    n = keys.shape[0]
    part = torch.empty((n,), dtype=torch.int32, device=keys.device)
    hist = torch.zeros((n_parts,), dtype=torch.int32, device=keys.device)
    if n:
        # a grid-stride pass: 8 blocks per SM keep every SM busy, and each
        # block adds its shared-memory histogram to the global one once
        sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
        _launch("hash_partition", keys.device, keys.data_ptr(), valid.data_ptr(),
                n, n_parts, part.data_ptr(), hist.data_ptr(), 8 * sms)
    return part, hist


def lcp_boundary(sorted_terms: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lcp [N] int32, flags [N, L] bool) of a lexicographically sorted matrix."""
    if not sorted_terms.is_cuda:
        return ref.lcp_boundary_ref(sorted_terms)
    _check(sorted_terms, "lcp_boundary terms", torch.int32, 2)
    sorted_terms = sorted_terms.contiguous()
    n, length = sorted_terms.shape
    lcp = torch.empty((n,), dtype=torch.int32, device=sorted_terms.device)
    flags = torch.empty((n, length), dtype=torch.bool, device=sorted_terms.device)
    if n:
        _launch("lcp_boundary", sorted_terms.device, sorted_terms.data_ptr(), n,
                length, lcp.data_ptr(), flags.data_ptr())
    return lcp, flags


def bsearch(lanes: torch.Tensor, queries: torch.Tensor, lo: torch.Tensor,
            hi: torch.Tensor, *, upper: bool = False,
            steps: int | None = None) -> torch.Tensor:
    """Positions [Q] int32 of the lower (or, with ``upper``, upper) bound of each
    query [Q, L] among sorted rows ``lanes`` [R, L], within [lo, hi).

    ``lanes`` may be a row-strided view (its last dimension contiguous).
    """
    if steps is None:
        steps = ref.search_steps(lanes.shape[0])
    if not lanes.is_cuda:
        return ref.bsearch_ref(lanes, queries, lo, hi, upper=upper, steps=steps)
    _check(lanes, "bsearch lanes", torch.int64, 2)
    _check(queries, "bsearch queries", torch.int64, 2)
    if queries.shape[1] != lanes.shape[1]:
        raise ValueError(f"bsearch: {queries.shape[1]} query lanes vs "
                         f"{lanes.shape[1]} index lanes")
    if lanes.stride(1) != 1:
        lanes = lanes.contiguous()
    queries = queries.contiguous()
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    n_q = queries.shape[0]
    pos = torch.empty((n_q,), dtype=torch.int32, device=queries.device)
    if n_q:
        _launch("bsearch", lanes.device, lanes.data_ptr(), lanes.stride(0),
                lanes.shape[1], queries.data_ptr(), n_q, lo.data_ptr(),
                hi.data_ptr(), steps, int(upper), pos.data_ptr())
    return pos
