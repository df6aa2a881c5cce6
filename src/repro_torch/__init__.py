"""PyTorch/CUDA port of the n-gram MapReduce system (``repro``), for the H100.

The port mirrors ``repro``'s module names so each counterpart is easy to
find, and imports only torch, numpy and the standard library -- never JAX and
never a ``repro`` module.  Its first slice is the main path: token stream ->
SUFFIX-sigma job -> ``NGramStats`` in canonical order -> flat ``NGramIndex``
-> batched ``lookup`` and top-k ``continuations``.  The second is streaming
ingest: ``serve.StreamingNGramService`` runs each document batch through the
job (hash combiner included) into a ``GenerationalIndex`` whose merged rungs
freeze to the compressed layout, and answers queries across its rungs.  The
third brings the paper's other three methods (NAIVE, APRIORI-SCAN,
APRIORI-INDEX), so ``core.run_job`` runs all four on one device.  The
wave engine (``WaveExecutor``, exported here) streams a host-resident
corpus through the card in fixed-size waves and folds them into the
monolithic job's output, so a corpus larger than one job can hold on the
card still runs.  The serving tier (``serve``: batcher, admission,
``QueryFrontend``, HTTP/SSE), observability (``obs``: metrics registry,
reports, tracer) and the driver CLIs (``launch.ngram``,
``launch.serve_ngrams``) sit on top, as in ``repro``.  Beside the n-gram
path, ``repro``'s LM serving: the arch registry (``configs``: the five LM
archs), the model stack (``models.{layers,moe,transformer}``: GQA, MLA,
sliding windows, MoE; prefill and cached decode) and ``launch.serve``.

Lane representation.  ``repro`` keeps packed term lanes, record weights,
hash values and index counts as ``uint32``.  torch has no ``>>``, ``<``,
``%`` or ``index_add_`` on ``uint32``, so the port keeps every such value as
``torch.int64`` holding the uint32 value in ``[0, 2**32)``: every op the
path needs works on CPU and CUDA, signed int64 comparison is the unsigned
order, and uint32 wraparound is reproduced by masking with ``U32`` after each
shift or multiply.  Consequences the code handles explicitly:

  * the index pad row ``SENTINEL = 0xFFFFFFFF`` is a large positive int64 and
    sorts after every real row, as the uint32 all-ones row does;
  * the continuation view's count key is ``U32 - cf`` (``~cf`` in uint32);
  * ``shuffle_bytes`` still counts 4 bytes per lane: it is the paper's
    MAP_OUTPUT_BYTES, not the port's storage width.

Stream representation.  The compressed index's packed bit streams (lcp,
payload, counts, next terms, head keys, block bases, Elias-Fano low/high/rank
words) are ``torch.int32`` tensors holding the uint32 bit pattern, not int64:
at rest they take exactly ``repro``'s bytes, which the compression contract
is about.  Plain code widens a fetched word to int64 and masks it with
``U32`` before any shift (torch's int32 ``>>`` sign-extends); the CUDA
kernels read the words as ``uint32_t`` (``kernels.bitpack``).

Devices.  Entry points (``core.run_job``, ``index.build_index``,
``index.compress_index``, ``index.GenerationalIndex``,
``serve.StreamingNGramService``, ``models.transformer.init_params``) run
on the card unless the caller passes ``device="cpu"``; with no card and no
device given they raise.  Each kernel
wrapper in ``kernels.ops`` launches its CUDA kernel on a CUDA tensor and runs
the plain PyTorch version on a CPU tensor.
"""
from __future__ import annotations

import numpy as np
import torch

U32 = 0xFFFFFFFF


def u32_words(values, device) -> torch.Tensor:
    """``values`` (an array or a tensor of integers) read as uint32, as
    ``repro``'s ``astype(uint32)`` reads them (a negative value wraps), held
    as an int32 tensor of the same bit patterns on ``device``: the word
    vectors the kernels take."""
    if isinstance(values, torch.Tensor):
        words = values.to(device=device, dtype=torch.int64) & U32
        return torch.where(words > 0x7FFFFFFF, words - (1 << 32), words).to(torch.int32)
    return torch.as_tensor(np.asarray(values).astype(np.uint32).view(np.int32),
                           device=device)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the card.

    Refuses to fall back to the CPU: with no ``device`` argument and no CUDA
    card, the caller gets an error, not a silent CPU run.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch entry points run on the GPU by "
            "default; pass device='cpu' to run on the host")
    return torch.device("cuda")


from repro_torch.pipeline import (DoubleBufferedDriver, WaveExecutor,  # noqa: E402
                                  WavePartial)

__all__ = ["U32", "u32_words", "resolve_device", "WaveExecutor", "WavePartial",
           "DoubleBufferedDriver"]
