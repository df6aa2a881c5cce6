"""Public wrappers of the hand-written CUDA kernels (mirrors ``repro.kernels.ops``).

Each wrapper dispatches on the device of its input: a CUDA tensor launches
the kernel (or raises), a CPU tensor runs the plain PyTorch version in
``kernels.ref``.  There is no flag and no fallback from one to the other.
``launches[name]`` counts the kernel launches of each wrapper, so a run can
show that its main path went through the kernels.

The main path's three kernels (``suffix_pack``, ``hash_partition``,
``lcp_boundary``) launch through ``torch.library`` custom ops whose fake
implementation writes nothing: on the fake tensors of the dry run
(``launch.dryrun``) each is one op of its inputs and outputs, and nothing
launches.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.mapreduce import pack as packing
from . import build, ref

#: kernel name -> launches on CUDA tensors since the last ``launches.clear()``
launches: collections.Counter = collections.Counter()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected a {ndim}-d {dtype} tensor, got "
                        f"{t.dim()}-d {t.dtype}")


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` on the current stream of ``device``: the C entry
    point takes the raw stream handle last.  The device context is entered
    only when ``device`` is not already the current one."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(name, device, *args)
    err = build.entries()[name](*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    launches[name] += 1


@torch.library.custom_op("repro_torch::suffix_pack", mutates_args=("out",))
def _suffix_pack_op(tokens: torch.Tensor, out: torch.Tensor, meta: torch.Tensor | None,
                    sigma: int, vocab_size: int, n_l: int, weight: bool) -> None:
    _launch("suffix_pack", tokens.device, tokens.data_ptr(), tokens.shape[0], sigma,
            packing.bits_for_vocab(vocab_size), packing.terms_per_lane(vocab_size),
            n_l, out.data_ptr(), int(weight), None if meta is None else meta.data_ptr())


@_suffix_pack_op.register_fake
def _(tokens, out, meta, sigma, vocab_size, n_l, weight) -> None:
    return None


@torch.library.custom_op("repro_torch::hash_partition", mutates_args=("part", "hist"))
def _hash_partition_op(keys: torch.Tensor, valid: torch.Tensor, part: torch.Tensor,
                       hist: torch.Tensor) -> None:
    # a grid-stride pass: 8 blocks per SM keep every SM busy, and each block
    # adds its shared-memory histogram to the global one once
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    _launch("hash_partition", keys.device, keys.data_ptr(), valid.data_ptr(),
            keys.shape[0], hist.shape[0], part.data_ptr(), hist.data_ptr(), 8 * sms)


@_hash_partition_op.register_fake
def _(keys, valid, part, hist) -> None:
    return None


@torch.library.custom_op("repro_torch::lcp_boundary", mutates_args=("lcp", "flags"))
def _lcp_boundary_op(terms: torch.Tensor, lcp: torch.Tensor, flags: torch.Tensor) -> None:
    n, length = terms.shape
    _launch("lcp_boundary", terms.device, terms.data_ptr(), n, length,
            _lcp_tile_rows(length), lcp.data_ptr(), flags.data_ptr())


@_lcp_boundary_op.register_fake
def _(terms, lcp, flags) -> None:
    return None


def suffix_pack(tokens: torch.Tensor, *, sigma: int, vocab_size: int,
                out: torch.Tensor | None = None,
                meta: torch.Tensor | None = None) -> torch.Tensor:
    """Packed sigma-truncated suffix lanes [N, n_lanes] int64 of a token stream.

    With ``out``, a contiguous [N, n_lanes + 1] int64 tensor on the tokens'
    device, the map's records are written there in one pass and returned:
    the lanes, then the weight, 1 for a real token and 0 for PAD.  With
    ``meta`` too, an int32 [N] vector on that device (uint32 words, such as
    time-series bucket ids), ``out`` is [N, n_lanes + 2] and each row ends
    with its position's meta word as a uint32 value, in the same pass.  Any
    sigma >= 1 (as ``NGramConfig`` takes).
    """
    n_l = packing.n_lanes(sigma, vocab_size)
    n = tokens.shape[0]
    if meta is not None:
        if out is None:
            raise ValueError("suffix_pack: meta is a records column; pass out too")
        _check(meta, "suffix_pack meta", torch.int32, 1)
        if meta.shape[0] != n or meta.device != tokens.device:
            raise ValueError(f"suffix_pack: meta must be a [{n}] vector on the tokens' device")
    if out is not None:
        cols = n_l + 1 + (meta is not None)
        _check(out, "suffix_pack out", torch.int64, 2)
        if out.shape != (n, cols) or out.device != tokens.device \
                or not out.is_contiguous():
            raise ValueError(f"suffix_pack: out must be a contiguous [{n}, "
                             f"{cols}] tensor on the tokens' device")
    if not tokens.is_cuda:
        return ref.suffix_pack_ref(tokens, sigma=sigma, vocab_size=vocab_size,
                                   out=out, meta=meta)
    _check(tokens, "suffix_pack tokens", torch.int32, 1)
    tokens = tokens.contiguous()
    weight = out is not None
    if out is None:
        out = torch.empty((n, n_l), dtype=torch.int64, device=tokens.device)
    if meta is not None:
        meta = meta.contiguous()
    if n:
        _suffix_pack_op(tokens, out, meta, sigma, vocab_size, n_l, weight)
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
        _hash_partition_op(keys, valid, part, hist)
    return part, hist


#: lcp_boundary: terms a tile of rows holds (32 KiB of int32); the shortest
#: and the longest row that get a tile.  Rows of up to 5 terms take one
#: thread a row: a warp's rows span at most 640 bytes of terms there, and
#: that kernel runs as near its bound as a tile does (on the H100, PERF.md);
#: 16 rows of 3,072 terms fill 192 KiB of shared memory
LCP_TILE_TERMS = 8192
LCP_MIN_TILED_LENGTH = 6
LCP_MAX_TILED_LENGTH = 3072


def _lcp_tile_rows(length: int) -> int:
    """Rows a block of the ``lcp_boundary`` kernel stages for rows of
    ``length`` terms: a multiple of 16, about ``LCP_TILE_TERMS`` terms and
    their lcp words; 0 (one thread a row, the generic instance) outside
    ``LCP_MIN_TILED_LENGTH`` to ``LCP_MAX_TILED_LENGTH``."""
    if not LCP_MIN_TILED_LENGTH <= length <= LCP_MAX_TILED_LENGTH:
        return 0
    return max(16, LCP_TILE_TERMS // (length + 1) // 16 * 16)


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
        _lcp_boundary_op(sorted_terms, lcp, flags)
    return lcp, flags


def bsearch(lanes: torch.Tensor, queries: torch.Tensor, lo: torch.Tensor,
            hi: torch.Tensor, *, upper: bool = False,
            steps: int | None = None) -> torch.Tensor:
    """Positions [Q] int32 of the lower (or, with ``upper``, upper) bound of each
    query [Q, L] among sorted rows ``lanes`` [R, L], within [lo, hi)
    (0 <= lo <= hi <= R), after exactly ``steps`` halving trips.

    ``lanes`` may be a row-strided view (its last dimension contiguous).
    ``lo`` and ``hi`` are int32 or int64 tensors of one dtype, read as given.
    """
    if steps is None:
        steps = ref.search_steps(lanes.shape[0])
    if not lanes.is_cuda:
        return ref.bsearch_ref(lanes, queries, lo, hi, upper=upper, steps=steps)
    _check(lanes, "bsearch lanes", torch.int64, 2)
    _check(queries, "bsearch queries", torch.int64, 2)
    n_q = queries.shape[0]
    if queries.shape[1] != lanes.shape[1]:
        raise ValueError(f"bsearch: {queries.shape[1]} query lanes vs "
                         f"{lanes.shape[1]} index lanes")
    if lo.dtype != hi.dtype or lo.dtype not in (torch.int32, torch.int64) \
            or lo.shape != (n_q,) or hi.shape != (n_q,):
        raise TypeError("bsearch: lo and hi must be [Q] tensors, both int32 or "
                        f"both int64 (got {lo.dtype} {tuple(lo.shape)}, "
                        f"{hi.dtype} {tuple(hi.shape)})")
    if lanes.stride(1) != 1:
        lanes = lanes.contiguous()
    queries, lo, hi = queries.contiguous(), lo.contiguous(), hi.contiguous()
    pos = torch.empty((n_q,), dtype=torch.int32, device=queries.device)
    if n_q:
        _launch("bsearch", lanes.device, lanes.data_ptr(), lanes.stride(0),
                lanes.shape[0], lanes.shape[1], queries.data_ptr(), n_q,
                lo.data_ptr(), hi.data_ptr(), lo.element_size(), steps,
                int(upper), pos.data_ptr())
    return pos


def _records_layout(keys: torch.Tensor, weights: torch.Tensor) -> bool:
    """Whether ``keys`` [N, K] and ``weights`` [N] are the columns of one
    contiguous [N, K + 1] int64 matrix, keys first, as
    ``suffix_sigma.make_records`` lays the job's records out, with K <= 4 and
    a 16-byte aligned base: the layout of the tiled ``hash_combine``."""
    k = keys.shape[1]
    return (1 <= k <= 4 and keys.stride() == (k + 1, 1)
            and weights.stride(0) == k + 1
            and weights.data_ptr() == keys.data_ptr() + 8 * k
            and keys.data_ptr() % 16 == 0)


def hash_combine(keys: torch.Tensor, weights: torch.Tensor, *,
                 block: int = 256, out: torch.Tensor | None = None) -> torch.Tensor:
    """Redistributed weights [N] int64 of the block-local hash-slot combiner
    (``block`` rows per block, ``2 * block`` slots).

    ``keys`` may be a row-strided view (its last dimension contiguous) and
    ``weights`` a strided vector.  With ``out``, an int64 [N] vector on the
    keys' device, the weights are written there and ``out`` is returned;
    ``out`` may be ``weights`` itself (the records' weight column: the
    combiner then rewrites the records in place), and shares no other memory
    with the inputs.  The records layout (``_records_layout``) takes the tiled
    kernel, any other layout the generic one.
    """
    n = keys.shape[0]
    if out is not None:
        _check(out, "hash_combine out", torch.int64, 1)
        if out.shape[0] != n or out.device != keys.device:
            raise ValueError(f"hash_combine: out must be a [{n}] vector on the keys' device")
        same = out.untyped_storage().data_ptr()
        if (same in (keys.untyped_storage().data_ptr(), weights.untyped_storage().data_ptr())
                and (out.data_ptr() != weights.data_ptr()
                     or (n > 1 and out.stride(0) != weights.stride(0)))):
            raise ValueError("hash_combine: out may alias the weights, and nothing else "
                             "of the inputs")
    if not keys.is_cuda:
        return ref.hash_combine_ref(keys, weights, block=block, out=out)
    _check(keys, "hash_combine keys", torch.int64, 2)
    _check(weights, "hash_combine weights", torch.int64, 1)
    if weights.shape[0] != n or not weights.is_cuda:
        raise ValueError("hash_combine: weights must be a CUDA tensor, one per key row")
    if block not in (32, 64, 128, 256, 512, 1024):
        raise ValueError(f"hash_combine: block {block} is not a power of two in [32, 1024]")
    if keys.stride(1) != 1:
        keys = keys.contiguous()
    if out is None:
        out = torch.empty((n,), dtype=torch.int64, device=keys.device)
    if n:
        _launch("hash_combine", keys.device, keys.data_ptr(), keys.stride(0),
                weights.data_ptr(), weights.stride(0), n, keys.shape[1], block,
                out.data_ptr(), out.stride(0), int(_records_layout(keys, weights)))
    return out


def merge_path(a_keys: torch.Tensor, b_keys: torch.Tensor, a_vals: torch.Tensor,
               b_vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable merge of two sorted key matrices [M, K], [N, K] int64 (uint32
    values) -> (keys [M+N, K], vals [M+N]); A rows first on ties.  K <= 5
    takes the tiled kernel, wider keys the generic one."""
    m, n = a_keys.shape[0], b_keys.shape[0]
    if m == 0:
        return b_keys, b_vals
    if n == 0:
        return a_keys, a_vals
    if not a_keys.is_cuda:
        return ref.merge_path_ref(a_keys, b_keys, a_vals, b_vals)
    for t, what, nd in ((a_keys, "a_keys", 2), (b_keys, "b_keys", 2),
                        (a_vals, "a_vals", 1), (b_vals, "b_vals", 1)):
        _check(t, f"merge_path {what}", torch.int64, nd)
        if not t.is_cuda:
            raise ValueError(f"merge_path: {what} is not a CUDA tensor")
    if b_keys.shape[1] != a_keys.shape[1] or a_vals.shape[0] != m \
            or b_vals.shape[0] != n:
        raise ValueError("merge_path: runs disagree in width or value count")
    a_keys, b_keys = a_keys.contiguous(), b_keys.contiguous()
    a_vals, b_vals = a_vals.contiguous(), b_vals.contiguous()
    k = a_keys.shape[1]
    keys = a_keys.new_empty((m + n, k))
    vals = a_vals.new_empty((m + n,))
    _launch("merge_path", a_keys.device, a_keys.data_ptr(), b_keys.data_ptr(),
            a_vals.data_ptr(), b_vals.data_ptr(), m, n, k,
            ref.search_steps(min(m, n) + 1), keys.data_ptr(), vals.data_ptr())
    return keys, vals


def _check_streams(what: str, lcps, payload, block_base, sec_starts, blk) -> None:
    for t, name in ((lcps, "lcps"), (payload, "payload"),
                    (block_base, "block_base"), (sec_starts, "sec_starts"),
                    (blk, "blk")):
        _check(t, f"{what} {name}", torch.int32, 1)
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not a contiguous CUDA tensor")
    if lcps.shape[0] == 0 or payload.shape[0] == 0:
        raise ValueError(f"{what}: empty lcp or payload stream")
    if not 1 <= sec_starts.shape[0] - 1 <= 256:
        raise ValueError(f"{what}: sigma {sec_starts.shape[0] - 1} outside [1, 256]")


def _check_block_out(out: torch.Tensor, vocab_size: int | None, blk: torch.Tensor,
                     *, sigma: int, block_size: int) -> None:
    """``out`` of ``block_expand``: an int64 [n, n_lanes] view on the block ids'
    device, last dimension contiguous, rows not overlapping, n <= B * block_size."""
    if vocab_size is None:
        raise ValueError("block_expand: out needs vocab_size to pack the lanes")
    _check(out, "block_expand out", torch.int64, 2)
    n_l = packing.n_lanes(sigma, vocab_size)
    n, width = out.shape
    if width != n_l or n > blk.shape[0] * block_size or out.device != blk.device \
            or (n_l > 1 and out.stride(1) != 1) or (n > 1 and out.stride(0) < n_l):
        raise ValueError(f"block_expand: out must be an [n <= {blk.shape[0] * block_size}, "
                         f"{n_l}] view on the block ids' device with a contiguous "
                         "last dimension")


def block_expand(lcps: torch.Tensor, payload: torch.Tensor,
                 block_base: torch.Tensor, sec_starts: torch.Tensor,
                 blk: torch.Tensor, *, term_bits: int, lcp_width: int,
                 block_size: int, len_off: int, out: torch.Tensor | None = None,
                 vocab_size: int | None = None) -> torch.Tensor:
    """Decoded term rows [B, block_size, sigma] int32 of the front-coded blocks
    ``blk`` (streams: int32 tensors holding uint32 words).

    With ``out`` (and ``vocab_size``), the rows are packed as ``pack_terms``
    packs them and written into ``out``, an int64 [n, n_lanes] row-strided
    view with n <= B * block_size: row i of the decoded blocks goes to
    ``out[i]``, rows from n on are not written, and ``out`` is returned.
    """
    sigma = sec_starts.shape[0] - 1
    if out is not None:
        _check_block_out(out, vocab_size, blk, sigma=sigma, block_size=block_size)
    elif vocab_size is not None:
        raise ValueError("block_expand: vocab_size packs into out; pass both or neither")
    if not blk.is_cuda:
        return ref.block_expand_ref(lcps, payload, block_base, sec_starts, blk,
                                    term_bits=term_bits, lcp_width=lcp_width,
                                    block_size=block_size, len_off=len_off,
                                    out=out, vocab_size=vocab_size)
    _check_streams("block_expand", lcps, payload, block_base, sec_starts, blk)
    blk = blk.contiguous()
    if out is None:
        out = torch.empty((blk.shape[0], block_size, sigma), dtype=torch.int32,
                          device=blk.device)
        n_rows, stride, bits = blk.shape[0] * block_size, sigma, 0
    else:
        n_rows, stride = out.shape[0], out.stride(0)
        bits = packing.bits_for_vocab(vocab_size)
    if n_rows:
        _launch("block_expand", blk.device, lcps.data_ptr(), lcps.shape[0],
                payload.data_ptr(), payload.shape[0], block_base.data_ptr(),
                sec_starts.data_ptr(), blk.data_ptr(), blk.shape[0], sigma,
                term_bits, lcp_width, block_size, len_off, out.data_ptr(),
                n_rows, stride, bits)
    return out


def block_decode(lcps: torch.Tensor, payload: torch.Tensor,
                 block_base: torch.Tensor, sec_starts: torch.Tensor,
                 blk: torch.Tensor, q_terms: torch.Tensor, q_len: torch.Tensor,
                 *, term_bits: int, lcp_width: int, block_size: int,
                 len_off: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(cnt_lt [Q], cnt_eq [Q]) int32: rows of each query's candidate block
    ``blk`` whose (row_len, terms) key sorts below / equal to the query's."""
    if not blk.is_cuda:
        return ref.block_decode_ref(lcps, payload, block_base, sec_starts, blk,
                                    q_terms, q_len, term_bits=term_bits,
                                    lcp_width=lcp_width, block_size=block_size,
                                    len_off=len_off)
    _check_streams("block_decode", lcps, payload, block_base, sec_starts, blk)
    _check(q_terms, "block_decode q_terms", torch.int32, 2)
    _check(q_len, "block_decode q_len", torch.int32, 1)
    sigma = sec_starts.shape[0] - 1
    n_q = blk.shape[0]
    if q_terms.shape != (n_q, sigma) or q_len.shape != (n_q,):
        raise ValueError("block_decode: q_terms must be [Q, sigma] and q_len [Q]")
    blk, q_terms, q_len = blk.contiguous(), q_terms.contiguous(), q_len.contiguous()
    cnt_lt = torch.empty((n_q,), dtype=torch.int32, device=blk.device)
    cnt_eq = torch.empty_like(cnt_lt)
    if n_q:
        _launch("block_decode", blk.device, lcps.data_ptr(), lcps.shape[0],
                payload.data_ptr(), payload.shape[0], block_base.data_ptr(),
                sec_starts.data_ptr(), blk.data_ptr(), q_terms.data_ptr(),
                q_len.data_ptr(), n_q, sigma, term_bits, lcp_width, block_size,
                len_off, cnt_lt.data_ptr(), cnt_eq.data_ptr())
    return cnt_lt, cnt_eq
