"""gin-tu [arXiv:1810.00826]: 5-layer GIN, d_hidden 64, sum aggregator,
learnable eps.  Four graph regimes; message passing = a gather and an
``index_add_`` over the edge index (``models.gnn``).

Sharding (the dry-run cell): nodes and edges over the batch axes, padded to
``max(dp, 16) * 16`` so the counts divide on both meshes; the model
replicated (it is tiny); message passing dst-partitioned
(``gnn.loss_fn_dst_partitioned``: one all-gather of the node features a
layer)."""
from __future__ import annotations

import torch

from repro_torch.models.gnn import GINConfig
from .base import (P, ArchDef, Cell, ShapeDef, TensorSpec, axis_sizes, dp_axes, dp_spec,
                   opt_pspecs, register, replicated, specs_of)

SHAPES = {
    # Cora: full-batch node classification
    "full_graph_sm": ShapeDef("full_graph_sm", "train",
                              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
                               "n_classes": 7}),
    # Reddit with layer sampling, fanout 15-10 from 1024 seeds
    "minibatch_lg": ShapeDef("minibatch_lg", "train",
                             {"n_nodes": 232_965, "n_edges": 114_615_892,
                              "batch_nodes": 1024, "fanout": (15, 10),
                              "d_feat": 602, "n_classes": 41}),
    # ogbn-products full batch
    "ogb_products": ShapeDef("ogb_products", "train",
                             {"n_nodes": 2_449_029, "n_edges": 61_859_140,
                              "d_feat": 100, "n_classes": 47}),
    # batched small molecules
    "molecule": ShapeDef("molecule", "train",
                         {"n_nodes": 30, "n_edges": 64, "batch": 128,
                          "d_feat": 16, "n_classes": 2}),
}


def sampled_sizes(dims) -> tuple[int, int]:
    """(n_sub_nodes, n_sub_edges) of the layer-sampled subgraph."""
    n = dims["batch_nodes"]
    nodes, edges = n, 0
    frontier = n
    for fo in dims["fanout"]:
        edges += frontier * fo
        frontier *= fo
        nodes += frontier
    return nodes, edges


def cell_sizes(shape: ShapeDef) -> tuple[int, int]:
    """(n_nodes, n_edges) one step of ``shape`` trains on, before padding."""
    d = shape.dims
    if shape.name == "minibatch_lg":
        return sampled_sizes(d)
    if shape.name == "molecule":
        return d["n_nodes"] * d["batch"], d["n_edges"] * d["batch"]
    return d["n_nodes"], d["n_edges"]


def cell_config(shape: ShapeDef) -> GINConfig:
    """The model ``repro``'s ``build_cell`` trains on ``shape``: 5 layers of
    width 64, node features sent in bf16."""
    d = shape.dims
    return GINConfig("gin-tu", n_layers=5, d_hidden=64, d_feat=d["d_feat"],
                     n_classes=d["n_classes"], comm_dtype=torch.bfloat16)


def model_flops(shape: ShapeDef) -> float:
    """MODEL_FLOPS of a train step: per layer 2*E*F gather-sum + 2*N*(F*H + H*H)
    MLPs, the head, x3 train."""
    n_nodes, n_edges = cell_sizes(shape)
    cfg = cell_config(shape)
    f, h = shape.dims["d_feat"], cfg.d_hidden
    fl = 0
    fin = f
    for _ in range(cfg.n_layers):
        fl += 2 * n_edges * fin + 2 * n_nodes * (fin * h + h * h)
        fin = h
    return float(3 * (fl + 2 * n_nodes * h * shape.dims["n_classes"]))


def _pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def build_cell(cfg_factory, shape: ShapeDef, mesh) -> Cell:
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models import gnn
    from repro_torch.training.optimizer import OptimizerConfig, init_state
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import tensors

    sizes = axis_sizes(mesh)
    mult = 1
    for a in dp_axes(mesh):
        mult *= sizes[a]
    mult = max(mult, 16) * 16  # divisible on both meshes
    n_nodes, n_edges = cell_sizes(shape)
    n_nodes_p, n_edges_p = _pad_to(n_nodes, mult), _pad_to(n_edges, mult)
    d = shape.dims
    cfg = cell_config(shape)
    meta = gnn.init_params(cfg, "meta").tree()
    params_sh, opt_sh = specs_of(meta), specs_of(init_state(meta))
    batch_sds = {
        "features": TensorSpec((n_nodes_p, d["d_feat"]), torch.float32),
        "edge_src": TensorSpec((n_edges_p,), torch.int32),
        "edge_dst": TensorSpec((n_edges_p,), torch.int32),
        "edge_mask": TensorSpec((n_edges_p,), torch.bool),
        "labels": TensorSpec((n_nodes_p,), torch.int32),
        "label_mask": TensorSpec((n_nodes_p,), torch.bool),
    }
    dp = dp_spec(mesh)
    bspec = {"features": P(dp, None), "edge_src": P(dp), "edge_dst": P(dp),
             "edge_mask": P(dp), "labels": P(dp), "label_mask": P(dp)}
    pspec = replicated(params_sh)  # tiny model: replicated
    rows = mesh_axes(mesh, dp_axes(mesh))

    def step(params, opt_state, batch):
        for t in tensors(params):
            t.requires_grad_(True)
        return make_train_step(lambda p, b: gnn.loss_fn_dst_partitioned(p, b, cfg, rows),
                               OptimizerConfig())(params, opt_state, batch)
    return Cell("gin-tu", shape.name, "train", step, (params_sh, opt_sh, batch_sds),
                (pspec, opt_pspecs(pspec), bspec), donate_argnums=(0, 1),
                model_flops=model_flops(shape),
                notes=f"padded nodes {n_nodes}->{n_nodes_p} edges {n_edges}->{n_edges_p}")


register(ArchDef(
    name="gin-tu", family="gnn",
    make=lambda: GINConfig("gin-tu", 5, 64, 1433, 7),
    make_reduced=lambda: GINConfig("gin-tu-smoke", 2, 8, 8, 3),
    shapes=SHAPES, build_cell=build_cell,
    notes="paper technique inapplicable to the model itself; shares the "
          "segment-reduce substrate (DESIGN.md SSArch-applicability)",
))
