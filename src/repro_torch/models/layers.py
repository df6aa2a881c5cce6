"""Shared neural layers (port of ``repro.models.layers``): norms, RoPE,
attention variants (GQA / SWA / MLA's non-absorbed form) and SwiGLU, as
plain functions of tensors.

Each function takes ``repro``'s dtype steps one for one, so that the port and
``repro`` compute the same function: scores and softmax in float32, the
probabilities cast back to the value dtype, RoPE's angle table cast to the
activations' dtype before the rotation, and masks filled with ``NEG_INF``
(a finite -1e30, not ``-inf``).  Attention stays plain ``torch.einsum``: no
library attention kernel, which would change the numbers.

``q_chunk`` splits the queries of a long prefill into chunks, each with an
exact softmax over every key, bounding the live score block at
``[B, H, q_chunk, T]``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import has_region

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_freqs(d_head: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, d] (or [..., S, d]); positions: [..., S] integers.

    The half-split rotation: the first half of each head pairs with the
    second.  The angle table is computed in float32 and cast to ``x.dtype``
    before the rotation, as ``repro`` does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)                  # [d/2]
    ang = positions[..., None].float() * freqs                     # [..., S, d/2]
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int | None) -> torch.Tensor:
    m = k_pos[None, :] <= q_pos[:, None]                 # causal
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window    # sliding window
    return m


def _repeat_kv(k: torch.Tensor, g: int) -> torch.Tensor:
    """KV heads repeated up to the query heads: head ``h`` reads kv head
    ``h // g`` (``jnp.repeat`` along the head axis)."""
    return k.repeat_interleave(g, dim=2) if g > 1 else k


@has_region
def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_positions: torch.Tensor, k_positions: torch.Tensor,
                  window: int | None = None, q_chunk: int = 0) -> torch.Tensor:
    """Grouped-query attention.  q: [B, S, H, d]; k, v: [B, T, KV, d] with
    H % KV == 0 (MLA's value dim may differ from the key dim).  Returns
    [B, S, H, dv].  ``q_chunk > 0`` runs the queries in chunks of that many,
    which must divide S."""
    s, h, d = q.shape[1], q.shape[2], q.shape[3]
    g = h // k.shape[2]
    k = _repeat_kv(k, g)                   # [B, T, H, d]
    v = _repeat_kv(v, g)
    scale = d ** -0.5

    def block(qc, qpos_c):
        scores = torch.einsum("bshd,bthd->bhst", qc, k).float() * scale
        m = _mask(qpos_c, k_positions, window)
        scores = torch.where(m[None, None], scores, NEG_INF)
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhst,bthd->bshd", p, v)

    if q_chunk and s > q_chunk:
        if s % q_chunk:
            raise ValueError(f"q_chunk {q_chunk} does not divide {s} queries")
        return torch.cat([block(q[:, i:i + q_chunk], q_positions[i:i + q_chunk])
                          for i in range(0, s, q_chunk)], dim=1)
    return block(q, q_positions)


@has_region
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, *,
                     valid: torch.Tensor) -> torch.Tensor:
    """One-token decode against a cache.  q: [B, H, d]; caches: [B, T, KV, d];
    valid: [T] or [B, T] bool marking live cache slots.  Returns [B, H, d]."""
    h, d = q.shape[1], q.shape[2]
    g = h // k_cache.shape[2]
    k_cache = _repeat_kv(k_cache, g)
    v_cache = _repeat_kv(v_cache, g)
    scores = torch.einsum("bhd,bthd->bht", q, k_cache).float() * d ** -0.5
    v_mask = valid if valid.dim() == 2 else valid[None]
    scores = torch.where(v_mask[:, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return torch.einsum("bht,bthd->bhd", p, v_cache)


@has_region
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    gate = F.silu(torch.matmul(x, w_gate))
    return torch.matmul(gate * torch.matmul(x, w_up), w_down)


def cross_entropy_loss(x_final: torch.Tensor, lm_head: torch.Tensor,
                       labels: torch.Tensor, n_chunks: int = 4) -> torch.Tensor:
    """Chunked softmax cross entropy: never holds [B, S, V] in one piece.
    x_final: [B, S, d]; lm_head: [d, V]; labels: [B, S] integers."""
    b, s, _ = x_final.shape
    n_chunks = max(1, min(n_chunks, s))
    while s % n_chunks:
        n_chunks -= 1
    cs = s // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=x_final.device)
    for i in range(n_chunks):
        xc = x_final[:, i * cs:(i + 1) * cs]
        lc = labels[:, i * cs:(i + 1) * cs].long()
        total = total + _chunk_nll(xc, lm_head, lc)
    return total / (b * s)


@has_region
def _chunk_nll(x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """One chunk's summed negative log-likelihood."""
    logits = torch.matmul(x, lm_head).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum(logz - gold)


@has_region
def lookup_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: rows of a [V, d] table."""
    return table[ids]


@has_region
def head_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``x @ head`` [B, d] x [d, V] -> float32 logits."""
    return torch.matmul(x, head).float()
