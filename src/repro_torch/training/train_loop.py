"""Train-step factories: plain and microbatch-accumulated (port of
``repro.training.train_loop``).

A step is ``step(params, opt_state, batch) -> (params, opt_state,
metrics)``, with ``loss_fn(params, batch) -> (loss, metrics)`` as in
``repro``.  ``params`` is a tree of the tensors the loss reads (for an LM,
``models.transformer.param_tree(model)``, once the model requires grad);
the gradient is taken with ``torch.autograd.grad`` over its tensors, as
``jax.value_and_grad`` takes it over ``repro``'s pytree, and the update is
applied in place (``optimizer.apply_updates``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.launch.mesh import has_region

from .optimizer import OptimizerConfig, apply_updates, init_state
from .tree import Stacked, like, named_leaves, tensors


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, grads): ``loss_fn``'s value, its metrics (detached)
    and the gradient of the loss in every tensor of ``params`` (a tree
    shaped as ``params``; a tensor the loss does not reach gets zeros)."""
    leaves = tensors(params)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _placed_as(g, p)
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            like(params, grads))


@has_region
def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient as its parameter lies (a layout only: ``launch.regions``)."""
    return g


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig):
    """loss_fn(params, batch) -> (loss, metrics): the loss's backward, then
    one AdamW update."""

    def step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, opt_metrics = apply_updates(params, grads, opt_state,
                                                       opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return step


@has_region
def _microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of a batch tensor: its rows in ``n``
    blocks, in order."""
    m = x.shape[0] // n
    return x[i * m:(i + 1) * m]


def make_train_step_accum(loss_fn: Callable, opt_cfg: OptimizerConfig,
                          n_micro: int):
    """Gradient accumulation over ``n_micro`` microbatches (the batch dim
    split in order), summed in float32, then averaged.

    ``repro`` has two of these: a ``lax.scan`` over the microbatches and a
    statically unrolled loop with an optimization barrier, so that XLA frees
    each microbatch's activations before the next starts.  Eager PyTorch
    runs each microbatch's forward and backward before the next begins, so
    one loop has the unrolled variant's memory property by construction and
    computes what both compute: :func:`make_train_step_accum_unrolled` is
    this function.
    """

    def step(params, opt_state, batch):
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in tensors(params)]
        loss_sum = None
        for i in range(n_micro):
            mb = {k: _microbatch(x, i, n_micro) for k, x in batch.items()}
            loss, _, grads = value_and_grad(loss_fn, params, mb)
            torch._foreach_add_(acc, [g.to(torch.float32) for g in tensors(grads)])
            del grads
            loss_sum = loss.to(torch.float32) if loss_sum is None else loss_sum + loss
        torch._foreach_div_(acc, n_micro)
        params, opt_state, opt_metrics = apply_updates(params, like(params, acc),
                                                       opt_state, opt_cfg)
        return params, opt_state, {"loss": loss_sum / n_micro, **opt_metrics}

    return step


make_train_step_accum_unrolled = make_train_step_accum


def eval_shape_state(init_params_fn: Callable, opt_cfg: OptimizerConfig):
    """(params, opt_state) as trees of ``meta`` tensors: their shapes and
    dtypes, with nothing allocated -- the dry run's input.
    ``init_params_fn()`` builds the parameter tree on the ``meta`` device,
    e.g. ``lambda: param_tree(init_params(cfg, "meta"))``."""
    params = init_params_fn()
    for name, leaf in named_leaves(params):
        for t in (leaf if isinstance(leaf, Stacked) else (leaf,)):
            if t.device.type != "meta":
                raise ValueError(f"{name} lies on {t.device}: init_params_fn must "
                                 "build on the meta device")
    return params, init_state(params)
