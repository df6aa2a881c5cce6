"""Rank functions of ``test_torch_gnn.py``'s spawned gloo ranks.

Every spawned rank imports the module of the function it runs; this one
imports no JAX, unlike the test file.
"""
import torch

from repro_torch.models import gnn
from repro_torch.training import train_loop
from repro_torch.training.tree import tree_to_numpy


def dst_partitioned_rank(mesh, tree, batch, cfgs):
    """For each config: the global loss and its gradient in every parameter
    (all-reduced), as this rank sees them."""
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for cfg in cfgs:
        model = gnn.params_from_numpy(tree, cfg, device=mesh.device).requires_grad_(True)
        loss, aux, grads = train_loop.value_and_grad(
            lambda p, x: gnn.loss_fn_dst_partitioned(p, x, cfg, mesh),
            gnn.param_tree(model), b)
        out.append((float(loss), float(aux["ce"]), tree_to_numpy(grads)))
    return out
