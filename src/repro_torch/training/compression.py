"""Gradient compression for the slow data-parallel hop: int8 all-reduce with
per-tensor scales and stochastic rounding (port of
``repro.training.compression``).

Quantizing the cross-pod all-reduce 4x (fp32 -> int8) moves the collective's
roofline term down proportionally.  Stochastic rounding keeps the
quantization unbiased (E[q] = g), which is what makes compressed SGD
converge.

``repro`` runs these inside ``shard_map`` over a mesh axis; the port calls
them on every rank of a ``launch.mesh.DataMesh``, whose collectives stand
for ``psum`` (an int32 ``all_reduce`` of the int8 codes: exact up to 2^23
ranks) and ``pmax`` (a max-reduce of the scales).  The rounding noise comes
from an explicit ``torch.Generator``, one a rank: it cannot equal
``jax.random``'s, so the two packages agree in their properties (within a
quantization step of the mean, unbiased over seeds), not in their bits.
"""
from __future__ import annotations

import torch

from .tree import like, tensors


def _quantize(g: torch.Tensor, generator: torch.Generator):
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    scaled = g / scale
    noise = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                       device=g.device) - 0.5
    q = torch.clamp(torch.round(scaled + noise), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(tree, mesh, generator: torch.Generator):
    """Unbiased int8 all-reduce-mean of a gradient tree over ``mesh``."""
    out = []
    for g in tensors(tree):
        q, scale = _quantize(g.to(torch.float32), generator)
        acc = mesh.all_reduce(q.to(torch.int32))
        # every rank contributed with its own scale; decode with the max
        # (scales are near-identical across ranks for averaged grads)
        s_all = mesh.all_reduce(scale.reshape(1), op="max")[0]
        out.append(acc.to(torch.float32) * s_all / mesh.size)
    return like(tree, out)


def compressed_psum_exact_scale(tree, mesh, generator: torch.Generator):
    """Variant with a scale-normalized reduce: each rank requantizes its
    codes at the shared reference scale ``s_ref = max(scale)`` before the
    int32 sum, so each source decodes at its own scale (dequantize-then-
    reduce semantics at int8 wire cost plus one scalar max-reduce)."""
    out = []
    for g in tensors(tree):
        q, scale = _quantize(g.to(torch.float32), generator)
        s_ref = mesh.all_reduce(scale.reshape(1), op="max")[0]
        q2 = torch.clamp(torch.round(q.to(torch.float32) * (scale / s_ref)),
                         -127, 127).to(torch.int32)
        acc = mesh.all_reduce(q2)
        out.append(acc.to(torch.float32) * s_ref / mesh.size)
    return like(tree, out)
