"""AdamW with warmup + cosine schedule and global-norm clipping (port of
``repro.training.optimizer``).

``repro``'s formula, step for step: moments are float32 whatever the
parameter dtype, and the update is taken in float32 and cast back -- the
standard mixed-precision recipe.  ``torch.optim.AdamW`` computes another
function (its bias correction and ``eps`` sit elsewhere), so the port
writes ``repro``'s with ``torch._foreach_*`` ops over bounded pieces of the
flattened tensors.

The port updates in place: :func:`apply_updates` writes the new parameters
into the parameter tensors and the new moments into the state's, and
returns the same trees (``repro``'s launcher donates both to its jitted
step, to the same effect).  Trees are those of :mod:`.tree`: the state is
``{"m": tree, "v": tree, "step": int32 scalar}`` with ``repro``'s leaf
names.  Every number stays on the parameters' device: no step reads the
card back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.launch.mesh import has_region

from .tree import like, tensors

# elements a foreach update takes at once: its float32 temporaries (a few
# of this size) stay near half a GiB however large a leaf is
UPDATE_CHUNK = 1 << 25


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def schedule(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup, then cosine decay
    to ``min_lr_frac`` of the peak; float32 on the step's device."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_frac
                         + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> dict:
    """Zero float32 moments shaped as ``params`` and step 0, on the
    parameters' device (``meta`` parameters give ``meta`` state)."""
    flat = tensors(params)

    def zeros():
        return like(params, [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                             for t in flat])

    device = flat[0].device if flat else torch.device("cpu")
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (each taken as the square of its float32 norm, which reads a bf16 leaf
    without a float32 copy of it)."""
    return torch.sqrt(sum(torch.square(torch.linalg.vector_norm(g, dtype=torch.float32))
                          for g in tensors(tree)))


@has_region
def _pieces(columns: list[list[torch.Tensor]], chunk: int):
    """Aligned flat views of the tensors in ``columns`` (one list per role,
    the same shapes row by row), grouped so that a group holds at most
    ``chunk`` elements, a tensor past ``chunk`` cut into slices.  Each is
    a ``view`` (which raises on a tensor that is not contiguous): the
    update writes through them."""
    group, size = [[] for _ in columns], 0
    for row in zip(*columns):
        flat = [t.view(-1) for t in row]
        n = flat[0].numel()
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            if size and size + hi - lo > chunk:
                yield group
                group, size = [[] for _ in columns], 0
            for col, t in zip(group, flat):
                col.append(t[lo:hi])
            size += hi - lo
    if size:
        yield group


@has_region
def _copy_pieces(dst: list[torch.Tensor], src: list[torch.Tensor]) -> None:
    torch._foreach_copy_(dst, src)


def apply_updates(params, grads, state: dict, cfg: OptimizerConfig):
    """One AdamW step -> (params, state, {"lr", "grad_norm"}).

    ``grads`` is shaped as ``params`` (any float dtype).  The parameters and
    the moments are updated in place; the returned trees are the same
    objects, with the state's step advanced.
    """
    step = state["step"] + 1
    lr = schedule(step, cfg)
    gn = global_norm(grads)
    scale = torch.minimum(torch.ones_like(gn),
                          cfg.grad_clip / torch.maximum(gn, torch.full_like(gn, 1e-9)))
    stepf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    # params and moments are written through views, and a gradient is only
    # read: one that is not contiguous is read from a copy
    ps, ms, vs = tensors(params), tensors(state["m"]), tensors(state["v"])
    gs = [g.contiguous() for g in tensors(grads)]
    with torch.no_grad():
        for p, g, m, v in _pieces([ps, gs, ms, vs], UPDATE_CHUNK):
            g = torch._foreach_mul([x.to(torch.float32) for x in g], scale)
            torch._foreach_mul_(m, cfg.b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
            sq = torch._foreach_mul(g, g)
            del g
            torch._foreach_mul_(sq, 1 - cfg.b2)
            torch._foreach_mul_(v, cfg.b2)
            torch._foreach_add_(v, sq)
            del sq
            denom = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, cfg.eps)
            delta = torch._foreach_div(m, bc1)
            torch._foreach_div_(delta, denom)
            del denom
            p32 = [x.to(torch.float32) for x in p]
            torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
            torch._foreach_mul_(delta, lr)
            _copy_pieces(p, torch._foreach_sub(p32, delta))
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"lr": lr, "grad_norm": gn}

