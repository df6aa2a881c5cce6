"""Arch registry (port of ``repro.configs.base``): every architecture the
port runs, by name, with its full and reduced configs and its input shapes,
and the analytic model FLOPs of an LM step.

``repro``'s cell construction (``build_lm_cell``, ``lm_param_pspecs``,
``cache_pspecs``, ``_lm_layer_probe``) lowers and compiles each
(arch x shape) pair on a TPU production mesh for its dry run.  It is not
ported, and ``ArchDef`` carries no ``build_cell``, until the dry-run
question in ``ROADMAP.md`` is decided.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

_REGISTRY: dict[str, "ArchDef"] = {}


@dataclass
class ShapeDef:
    name: str
    kind: str                      # train | prefill | decode | forward | serve
    dims: dict[str, int]
    skip_reason: str | None = None


@dataclass
class ArchDef:
    name: str
    family: str                    # lm | gnn | recsys | ngram
    make: Callable[[], Any]                    # full config object
    make_reduced: Callable[[], Any]            # CPU-smoke config object
    shapes: dict[str, ShapeDef]
    notes: str = ""


def register(arch: ArchDef) -> ArchDef:
    _REGISTRY[arch.name] = arch
    return arch


def get(name: str) -> ArchDef:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> list[str]:
    return sorted(_REGISTRY)


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in all_archs() for s in _REGISTRY[a].shapes]


def lm_model_flops(cfg, kind: str, batch: int, seq: int, cache: int = 0) -> float:
    """Analytic MODEL_FLOPS: 6ND train / 2ND serve (+ attention terms)."""
    a = cfg.attn
    if a.kind == "gqa":
        attn_p = cfg.d_model * (a.n_heads + 2 * a.n_kv) * a.d_head \
                 + a.n_heads * a.d_head * cfg.d_model
    else:
        attn_p = (cfg.d_model * a.q_lora + a.q_lora * a.n_heads * (a.d_nope + a.d_rope)
                  + cfg.d_model * a.kv_lora
                  + a.kv_lora * a.n_heads * (a.d_nope + a.d_v)
                  + cfg.d_model * a.d_rope + a.n_heads * a.d_v * cfg.d_model)
    if cfg.moe is not None:
        m = cfg.moe
        ffn_p = m.top_k * 3 * cfg.d_model * m.d_ff_expert
        if m.n_shared:
            ffn_p += 3 * cfg.d_model * m.d_ff_shared_total
        ffn_p += cfg.d_model * m.n_experts
    else:
        ffn_p = 3 * cfg.d_model * cfg.d_ff
    n_active = cfg.n_layers * (attn_p + ffn_p) + 2 * cfg.vocab_size * cfg.d_model
    tokens = batch * seq
    if kind == "train":
        dense = 6 * n_active * tokens
        # causal attention: fwd 4*H*dh*S^2/2 per layer per sequence; x3 for bwd
        win = min(seq, a.window) if a.window else seq
        attn = 12 * cfg.n_layers * a.n_heads * a.d_head * batch * seq * win / 2
        return dense + attn
    if kind == "prefill":
        win = min(seq, a.window) if a.window else seq
        return (2 * n_active * tokens
                + 4 * cfg.n_layers * a.n_heads * a.d_head * batch * seq * win / 2)
    if kind == "decode":
        return (2 * n_active * batch
                + 4 * cfg.n_layers * a.n_heads * a.d_head * batch * cache)
    raise ValueError(kind)
