"""Containers for n-gram statistics jobs and their outputs (port of
``repro.core.stats``).

``NGramStats`` mirrors what a Hadoop job leaves in HDFS (the (n-gram, cf)
pairs) plus the counters the paper reports for every experiment.  It is host
numpy, as in ``repro``.  The port's ``NGramConfig`` has no ``use_kernels``:
the device of the data decides -- the kernels run on a CUDA tensor, their
plain versions on a CPU tensor.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Any vocab with >= 17 id bits packs one term per 32-bit lane; this is the
# canonical "packing off" value ``NGramConfig.lane_vocab`` resolves to.
UNPACKED_VOCAB = 1 << 30


@dataclass(frozen=True)
class NGramConfig:
    """Problem statement of the paper (SSIII): report every n-gram s with
    cf(s) >= tau and |s| <= sigma.

    Token-id convention (reserved id 0): term ids are ``1..vocab_size``;
    **id 0 is the PAD / document separator** and is never counted as a term.
    :meth:`validate_tokens` enforces the representable range.
    """

    sigma: int
    tau: int
    vocab_size: int
    method: str = "suffix_sigma"
    # --- implementation knobs -------------------------------------------------
    capacity_factor: float = 1.25   # shuffle buffer head-room per (src, dst) pair
    combine: bool = True            # map-side pre-aggregation (Hadoop combiner)
    combine_route: str = "sort"     # "sort" (run-merge) | "hash" (slot kernel)
    pack: bool = True               # bit-pack term lanes (SSV sequence encoding)
    # Explicit override of the vocabulary the lane packer sees (>0 wins); 0
    # derives it per ``pack``: ``vocab_size`` when packing, else
    # ``UNPACKED_VOCAB`` (one term per 32-bit sort lane).
    pack_vocab: int = 0
    split_docs: bool = True         # split documents at infrequent terms (SSV)
    apriori_index_k: int = 4        # K of APRIORI-INDEX (paper's calibrated value)
    n_buckets: int = 0              # >0: aggregate per-bucket time series (SSVI-B)

    def __post_init__(self):
        if self.sigma < 1:
            raise ValueError("sigma must be >= 1")
        if self.tau < 1:
            raise ValueError("tau must be >= 1")
        if self.combine_route not in ("sort", "hash"):
            raise ValueError(f"unknown combine_route {self.combine_route!r}")
        if self.pack_vocab and not self.pack_vocab >= self.vocab_size:
            # a packer vocab below vocab_size would overlap term bit fields
            # and silently fabricate grams
            raise ValueError(
                f"pack_vocab {self.pack_vocab} must be 0 (derive) or >= "
                f"vocab_size {self.vocab_size}")

    @property
    def lane_vocab(self) -> int:
        """Effective vocabulary for lane packing (see ``pack_vocab``)."""
        if self.pack_vocab:
            return self.pack_vocab
        return self.vocab_size if self.pack else max(self.vocab_size,
                                                     UNPACKED_VOCAB)

    def validate_tokens(self, tokens) -> None:
        """Refuse a corpus whose ids lie outside ``[0, vocab_size]``: an id past
        ``vocab_size`` overflows its packed lane field and fabricates grams, a
        negative id wraps through the uint32 lanes."""
        t = np.asarray(tokens)
        if t.size == 0:
            return
        lo, hi = int(t.min()), int(t.max())
        if lo < 0 or hi > self.vocab_size:
            raise ValueError(
                f"token ids must lie in [0, {self.vocab_size}] (0 is the "
                "reserved PAD/document separator and is never counted as a "
                f"term; remap a tokenizer that uses 0 for a real word); got "
                f"ids in [{lo}, {hi}]")


@dataclass
class NGramStats:
    """Dense job output.

    grams   : [R, sigma] int32, right-padded with PAD(0)
    lengths : [R] int32
    counts  : [R] int64 collection frequencies, or [R, B] int64 per-bucket
              series (a job with ``n_buckets = B``, SSVI-B)
    counters: exact shuffle/record accounting per phase
    """

    grams: np.ndarray
    lengths: np.ndarray
    counts: np.ndarray
    counters: dict[str, float] = field(default_factory=dict)

    def __len__(self) -> int:
        return int(self.grams.shape[0])

    def to_dict(self) -> dict[tuple[int, ...], int]:
        out: dict[tuple[int, ...], int] = {}
        for g, l, c in zip(self.grams, self.lengths, self.counts):
            key = tuple(int(x) for x in g[: int(l)])
            val = int(c.sum()) if np.ndim(c) else int(c)
            prev = out.get(key)
            out[key] = val if prev is None else prev + val
        return out

    def to_series_dict(self) -> dict[tuple[int, ...], np.ndarray]:
        """gram -> its [B] per-bucket counts, of a job run with n_buckets > 0."""
        if self.counts.ndim != 2:
            raise ValueError("to_series_dict: the job was not run with n_buckets > 0")
        return {
            tuple(int(x) for x in g[: int(l)]): c.copy()
            for g, l, c in zip(self.grams, self.lengths, self.counts)
        }

    @staticmethod
    def from_dense(sorted_terms: np.ndarray, flags: np.ndarray, counts: np.ndarray,
                   tau: int, counters: dict[str, float] | None = None) -> "NGramStats":
        """Extract (gram, count) rows from the dense reducer output.

        sorted_terms: [N, sigma]; flags: [N, sigma] boundary flags; counts:
        [N, sigma] run totals at boundary positions, or [N, sigma, B]
        per-bucket totals, kept where their sum reaches ``tau``.
        """
        total = counts.sum(axis=-1) if counts.ndim == 3 else counts
        keep = flags & (total >= tau)
        rows, lens0 = np.nonzero(keep)
        sigma = sorted_terms.shape[1]
        lengths = (lens0 + 1).astype(np.int32)
        keep_pos = np.arange(sigma, dtype=np.int32)[None, :] < lengths[:, None]
        grams = sorted_terms[rows].astype(np.int32) * keep_pos
        cvals = counts[rows, lens0].astype(np.int64)
        return NGramStats(grams, lengths, cvals, dict(counters or {}))

    def merged_with(self, other: "NGramStats") -> "NGramStats":
        counters = dict(self.counters)
        for k, v in other.counters.items():
            counters[k] = counters.get(k, 0) + v
        return NGramStats(
            np.concatenate([self.grams, other.grams], axis=0),
            np.concatenate([self.lengths, other.lengths], axis=0),
            np.concatenate([self.counts, other.counts], axis=0),
            counters,
        )


def add_counters(dst: dict[str, float], **kv: float) -> dict[str, float]:
    for k, v in kv.items():
        dst[k] = dst.get(k, 0) + float(v)
    return dst
