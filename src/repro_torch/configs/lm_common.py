"""Shared shape set and registration helper for the five LM architectures."""
from __future__ import annotations

from .base import ArchDef, ShapeDef, build_lm_cell, register

FULL_ATTN_SKIP = ("long_500k needs sub-quadratic attention; this arch is pure "
                  "full-attention (see DESIGN.md SSArch-applicability)")


def lm_shapes(long_ok: bool) -> dict[str, ShapeDef]:
    return {
        "train_4k": ShapeDef("train_4k", "train",
                             {"seq_len": 4096, "global_batch": 256}),
        "prefill_32k": ShapeDef("prefill_32k", "prefill",
                                {"seq_len": 32768, "global_batch": 32}),
        "decode_32k": ShapeDef("decode_32k", "decode",
                               {"seq_len": 32768, "global_batch": 128}),
        "long_500k": ShapeDef("long_500k", "decode",
                              {"seq_len": 524288, "global_batch": 1},
                              skip_reason=None if long_ok else FULL_ATTN_SKIP),
    }


def register_lm(name: str, full_cfg, reduced_cfg, long_ok: bool, notes: str = ""):
    def build(arch_cfg, shape, mesh):
        return build_lm_cell(arch_cfg, shape, mesh)

    return register(ArchDef(
        name=name, family="lm",
        make=lambda: full_cfg,
        make_reduced=lambda: reduced_cfg,
        shapes=lm_shapes(long_ok),
        build_cell=build,
        notes=notes,
    ))
