"""Parameter and state trees of the port's training code.

``repro`` keeps parameters, gradients and optimizer moments as JAX pytrees:
nested dicts whose layer leaves are stacked ``[L, ...]``.  The port keeps
each layer's tensors apart (``models.transformer`` holds one ``nn.Module``
a layer), so its trees are nested dicts (or lists) of tensors in which a
:class:`Stacked` stands for one ``[L, ...]`` leaf: a tuple of the layers'
tensors, in layer order.  Leaf names join the dict keys (and list indices)
with ``/``, as ``repro``'s checkpoint names its leaves, so the two
packages' trees name the same leaves alike (``params/layers/wq``).
"""
from __future__ import annotations

from typing import Callable, Iterator

import torch
from torch import nn


class Stacked(tuple):
    """The per-layer tensors of one ``[L, ...]`` leaf, in layer order."""

    @property
    def shape(self) -> tuple:
        return (len(self),) + tuple(self[0].shape)

    @property
    def dtype(self):
        return self[0].dtype


def _is_node(tree) -> bool:
    """A container of the tree, not a leaf (a :class:`Stacked` is a leaf)."""
    return isinstance(tree, (dict, list)) or (isinstance(tree, tuple)
                                              and not isinstance(tree, Stacked))


def named_leaves(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(name, leaf) in key order of each dict; a :class:`Stacked` is one leaf."""
    if not _is_node(tree):
        yield prefix, tree
        return
    for key, sub in tree.items() if isinstance(tree, dict) else enumerate(tree):
        yield from named_leaves(sub, f"{prefix}/{key}" if prefix else str(key))


def map_leaves(fn: Callable, tree):
    """``tree`` with each leaf replaced by ``fn(leaf)`` (a :class:`Stacked`
    is one leaf)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if _is_node(tree):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def tensors(tree) -> list[torch.Tensor]:
    """Every tensor of ``tree`` in leaf order, each :class:`Stacked` spread
    into its layers' tensors."""
    out = []
    for _, leaf in named_leaves(tree):
        out.extend(leaf if isinstance(leaf, Stacked) else (leaf,))
    return out


def like(tree, flat: list):
    """A tree shaped as ``tree`` over ``flat`` (in :func:`tensors` order):
    the inverse of :func:`tensors`."""
    it = iter(flat)

    def take(leaf):
        if isinstance(leaf, Stacked):
            return Stacked(next(it) for _ in leaf)
        return next(it)

    out = map_leaves(take, tree)
    if next(it, None) is not None:
        raise ValueError("more tensors than the tree has leaves")
    return out


class TreeModule(nn.Module):
    """An ``nn.Module`` that holds a tree of tensors (dicts, lists and
    tuples, as ``repro``'s pytree of a model's parameters) as its
    parameters, each registered under its leaf name and sharing the
    tensor's storage.  The parameters are frozen (a trainer calls
    ``requires_grad_(True)``); :meth:`tree` gives them back in the tree's
    shape, the tensors themselves, whatever ``.to()`` has made of them."""

    def __init__(self, cfg, tree):
        super().__init__()
        self.cfg = cfg
        names = []
        for name, t in named_leaves(tree):
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
            names.append(name)
        self._skeleton = like(tree, names)

    def tree(self):
        return map_leaves(lambda name: self._parameters[name], self._skeleton)

    @property
    def device(self) -> torch.device:
        return next(iter(self._parameters.values())).device


def tree_to_numpy(tree):
    """A tree of tensors as float32 numpy arrays (a bf16 leaf widens
    exactly), in the same shape."""
    return map_leaves(lambda t: t.detach().float().cpu().numpy(), tree)
