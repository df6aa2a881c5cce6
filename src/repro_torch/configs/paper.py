"""The paper's own workload as an 11th selectable arch: ``--arch
ngram-suffix-sigma`` (port of ``repro.configs.paper``).

Shapes mirror Table I of the paper (NYT / ClueWeb09-B token counts) plus the
two use-cases of SSVII-D.  A MapReduce job has no model axis: the cell
re-views the same devices as a flat 1-D mesh (R = 256 / 512 reducers),
which is exactly the paper's reducer-count knob.  Each device runs
``core.suffix_sigma.distributed_block`` on its row of tokens: the map emit,
the combine, the shuffle at a fixed capacity, the sort and the reduce.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .base import P, ArchDef, Cell, ShapeDef, TensorSpec, axis_sizes, register

SHAPES = {
    # language-model use case: sigma=5, low tau (SSVII-D a), NYT token scale
    "nyt_lm": ShapeDef("nyt_lm", "mapreduce",
                       {"n_tokens": 1_049_440_645, "vocab": 345_827, "sigma": 5}),
    # analytics use case: sigma=100 (SSVII-D b); CW 25% sample scale
    "cw_analytics": ShapeDef("cw_analytics", "mapreduce",
                             {"n_tokens": 21_404_321_682 // 4, "vocab": 979_935,
                              "sigma": 100}),
    # two-phase sigma split of the same workload: suffix-sigma at
    # sigma_head=16 + the wide pass on the survivors
    "cw_analytics_split": ShapeDef("cw_analytics_split", "mapreduce",
                                   {"n_tokens": 21_404_321_682 // 4,
                                    "vocab": 979_935, "sigma": 100,
                                    "sigma_head": 16, "survivor_frac": 1 / 64}),
}


def flat_mesh(mesh):
    """``mesh``'s devices as one axis of reducers, ``shards``."""
    from repro_torch.launch.mesh import flatten_mesh
    return flatten_mesh(mesh, "shards")


def _job(cfg, fmesh, capacity: int):
    """The job of one row [1, n_local] of tokens a device, as ``repro``'s
    ``build_distributed_job``: (terms, flags, counts, stats), each [P, ...]."""
    from repro_torch.core.suffix_sigma import distributed_block
    from repro_torch.launch.mesh import mesh_axes, shard_map

    axes = mesh_axes(fmesh, ("shards",))

    def local(tok, _bkt):
        return tuple(t[None] for t in distributed_block(tok[0], cfg, axes, capacity))
    return shard_map(local, fmesh, (P("shards", None), P()), (P("shards"),) * 4)


def build_cell(cfg_factory, shape: ShapeDef, mesh) -> Cell:
    from repro_torch.core.stats import NGramConfig
    from repro_torch.mapreduce import pack as packing

    d = shape.dims
    fmesh = flat_mesh(mesh)
    n_parts = axis_sizes(fmesh)["shards"]
    cfg = NGramConfig(sigma=d["sigma"], tau=100, vocab_size=d["vocab"])
    n_local = -(-d["n_tokens"] // n_parts)
    n_local = -(-n_local // 8) * 8
    capacity = max(8, int(cfg.capacity_factor * n_local / n_parts) + 1)
    tokens_sds = TensorSpec((n_parts, n_local), torch.int32)
    dummy_bkt = TensorSpec((1, 1), torch.uint32)
    n_l = packing.n_lanes(cfg.sigma, cfg.vocab_size)
    rec_bytes = packing.record_bytes(cfg.sigma, cfg.vocab_size)
    # sort-dominated job: "useful work" ~ key comparisons N * log2(n_local) * lanes
    comp = d["n_tokens"] * max(1.0, math.log2(max(n_local, 2))) * n_l

    if "sigma_head" in d:
        # two-phase: narrow job on the full stream + wide job on the survivors
        cfg_a = dataclasses.replace(cfg, sigma=d["sigma_head"])
        cap_a = max(8, int(cfg.capacity_factor * n_local / n_parts) + 1)
        n_local_b = max(64, int(n_local * d["survivor_frac"]))
        n_local_b = -(-n_local_b // 8) * 8
        cap_b = max(8, int(cfg.capacity_factor * n_local_b / n_parts) + 1)
        job_a, job_b = _job(cfg_a, fmesh, cap_a), _job(cfg, fmesh, cap_b)
        surv_sds = TensorSpec((n_parts, n_local_b), torch.int32)

        def two_phase(tokens_p, surv_p, bkt):
            return job_a(tokens_p, bkt), job_b(surv_p, bkt)

        n_l_a = packing.n_lanes(d["sigma_head"], cfg.vocab_size)
        comp2 = (d["n_tokens"] * max(1.0, math.log2(max(n_local, 2))) * n_l_a
                 + d["n_tokens"] * d["survivor_frac"]
                 * max(1.0, math.log2(max(n_local_b, 2))) * n_l)
        return Cell("ngram-suffix-sigma", shape.name, "mapreduce", two_phase,
                    (tokens_sds, surv_sds, dummy_bkt),
                    (P("shards", None), P("shards", None), P()),
                    model_flops=float(comp2), mesh=fmesh,
                    notes=f"two-phase sigma {d['sigma_head']}+{d['sigma']}, "
                          f"caps {cap_a}/{cap_b}")

    return Cell("ngram-suffix-sigma", shape.name, "mapreduce", _job(cfg, fmesh, capacity),
                (tokens_sds, dummy_bkt), (P("shards", None), P()),
                model_flops=float(comp), mesh=fmesh,
                notes=f"R={n_parts} reducers, record={rec_bytes}B, cap={capacity}")


register(ArchDef(
    name="ngram-suffix-sigma", family="ngram",
    make=lambda: None, make_reduced=lambda: None,
    shapes=SHAPES, build_cell=build_cell,
    notes="the paper's contribution itself, as a dry-runnable workload",
))
