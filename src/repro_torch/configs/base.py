"""Arch registry and cell builder (port of ``repro.configs.base``): every
architecture the port runs, by name, with its full and reduced configs and
its input shapes; and, for the dry run (``launch.dryrun``), every
(architecture x input shape) pair as a :class:`Cell` on a production mesh.

Sharding policy (``repro``'s, one place, applied per arch):
  * LM params: FSDP over `data` (d_model dim), TP over `model` (head / ff /
    vocab dims).  KV projections are replicated over `model` when n_kv does
    not divide the axis.
  * MoE experts: the expert dim over `model` (EP), or each expert's d_ff
    (ffTP) when the experts are fewer than the axis.
  * Batch: over ('pod', 'data').
  * GNN: nodes + edges over the batch axes; the model replicated.
  * RecSys: embedding tables row-sharded over `model`.

Non-divisible dims fall back to replication (:func:`shard_if`), so every
cell builds on both the 16x16 and the 2x16x16 mesh.  A spec is the port's
:class:`P` (a tuple of axis names, None or tuples of names); :func:`named`
maps a tree of specs to DTensor placements on a ``DeviceMesh``.  A cell's
arguments are trees of :class:`TensorSpec` (shape and dtype), which the dry
run materialises as DTensors of fake tensors.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.launch.mesh import P, placements

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
    build_cell: Callable[..., "Cell"] | None = None   # (arch_cfg, shape, mesh) -> Cell
    notes: str = ""


@dataclass(frozen=True)
class TensorSpec:
    """A global tensor's shape and dtype (``jax.ShapeDtypeStruct``);
    ``layers``: a layer leaf ``[L, ...]``, held as one tensor a layer."""
    shape: tuple
    dtype: torch.dtype
    layers: bool = False


@dataclass
class Cell:
    """Everything the dry run needs for one (arch x shape x mesh).

    ``step_fn(*args)`` runs the step on the arguments, trees shaped as
    ``args`` (of :class:`TensorSpec`) whose leaves ``launch.dryrun`` makes
    DTensors placed by ``in_specs`` (trees of :class:`P`; a layer leaf,
    ``[L, ...]`` in ``args``, is one tensor a layer).  ``at_depth(layers,
    micro)``, where set, is the same cell cut to that many layers and
    microbatches (of the cell's own microbatch size): the dry run's probe
    traces it at one and two of each and extrapolates to ``depth``."""
    arch: str
    shape: str
    kind: str
    step_fn: Callable
    args: tuple
    in_specs: tuple
    donate_argnums: tuple = ()
    model_flops: float = 0.0
    notes: str = ""
    depth: tuple = (1, 1)                      # (layers, microbatches)
    at_depth: Callable[[int, int], "Cell"] | None = None
    mesh: Any = None                           # the specs' mesh, if not the cell's own


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


# ------------------------------------------------------------------ shard helpers
def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def dp_spec(mesh):
    """The batch entry of a spec: ('pod', 'data') on a multi-pod mesh, else
    'data'."""
    dp = dp_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def shard_if(mesh, dim_size: int, axis) -> str | tuple | None:
    """The axis entry if ``dim_size`` divides by the axes' extent, else None
    (replicate)."""
    sizes = axis_sizes(mesh)
    names = axis if isinstance(axis, tuple) else (axis,)
    extent = 1
    for n in names:
        if n not in sizes:
            return None
        extent *= sizes[n]
    if dim_size % extent != 0:
        return None
    return axis


def _map_specs(fn, tree):
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return tree


def named(mesh, spec_tree):
    """The DTensor placements of every spec of ``spec_tree`` on ``mesh``."""
    return _map_specs(lambda s: placements(mesh, s), spec_tree)


def shard_shape(mesh, spec: P, shape: tuple) -> tuple:
    """A device's shard of a ``shape`` tensor placed by ``spec``
    (``NamedSharding.shard_shape``: each split dimension rounded up)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                out[d] = -(-out[d] // sizes[name])
    return tuple(out)


def cell_leaves(cell) -> list:
    """(name, :class:`TensorSpec`, :class:`P`) of every argument leaf of
    ``cell``, named ``<arg>/<key>/...`` as ``repro``'s pytree paths."""
    out = []

    def walk(tree, spec, name):
        if isinstance(tree, TensorSpec):
            out.append((name, tree, spec))
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, spec[k], f"{name}/{k}")
        else:
            for i, (v, s) in enumerate(zip(tree, spec)):
                walk(v, s, f"{name}/{i}")
    for i, (a, s) in enumerate(zip(cell.args, cell.in_specs)):
        walk(a, s, str(i))
    return out


def specs_of(tree):
    """``tree`` with each tensor (or a layer leaf) as its :class:`TensorSpec`."""
    from repro_torch.training.tree import Stacked, map_leaves
    return map_leaves(lambda t: TensorSpec(tuple(t.shape), t.dtype,
                                           isinstance(t, Stacked)), tree)


def replicated(tree):
    """A spec tree of ``P()`` shaped as ``tree``."""
    from repro_torch.training.tree import map_leaves
    return map_leaves(lambda _: P(), tree)


# ----------------------------------------------------------- LM sharding + specs
def lm_param_pspecs(cfg, mesh):
    """Spec tree matching ``transformer.param_tree`` (layer leaves ``[L, ...]``)."""
    a = cfg.attn
    dshard = shard_if(mesh, cfg.d_model, "data")
    tp_q = shard_if(mesh, a.h_eff * a.d_head, "model")
    tp_kv = shard_if(mesh, a.kv_eff, "model") and "model"  # replicate if kv % tp

    if a.kind == "gqa":
        attn = {
            "wq": P(None, dshard, tp_q),
            "wk": P(None, dshard, "model" if tp_kv else None),
            "wv": P(None, dshard, "model" if tp_kv else None),
            "wo": P(None, tp_q, dshard),
        }
    else:
        qd = a.h_eff * (a.d_nope + a.d_rope)
        od = a.h_eff * a.d_v
        attn = {
            "wdq": P(None, dshard, None),
            "wuq": P(None, None, shard_if(mesh, qd, "model")),
            "wdkv": P(None, dshard, None),
            "wukv": P(None, None, shard_if(mesh, a.h_eff * (a.d_nope + a.d_v),
                                           "model")),
            "wkr": P(None, dshard, None),
            "wo": P(None, shard_if(mesh, od, "model"), dshard),
        }
    if cfg.moe is not None:
        # the layouts of moe_ffn_sharded's regions (EP when E divides tp, else
        # per-expert ff TP), the d_model dim FSDP-sharded over `data` besides
        m = cfg.moe
        ep = shard_if(mesh, m.n_experts, "model")
        if ep:
            ffn = {"router": P(None, None, None),
                   "wg": P(None, ep, dshard, None),
                   "wu": P(None, ep, dshard, None),
                   "wo": P(None, ep, None, dshard)}
        else:
            ff_ax = shard_if(mesh, m.d_ff_expert, "model")
            ffn = {"router": P(None, None, None),
                   "wg": P(None, None, dshard, ff_ax),
                   "wu": P(None, None, dshard, ff_ax),
                   "wo": P(None, None, ff_ax, dshard)}
        if m.n_shared:
            ffs = m.d_ff_shared_total
            ffn.update({"sg": P(None, None, shard_if(mesh, ffs, "model")),
                        "su": P(None, None, shard_if(mesh, ffs, "model")),
                        "so": P(None, shard_if(mesh, ffs, "model"), None)})
    else:
        ffn = {"wg": P(None, dshard, shard_if(mesh, cfg.d_ff, "model")),
               "wu": P(None, dshard, shard_if(mesh, cfg.d_ff, "model")),
               "wo": P(None, shard_if(mesh, cfg.d_ff, "model"), dshard)}
    layers = {"ln1": P(None, None), "ln2": P(None, None), "ffn": ffn}
    layers.update(attn)
    return {
        "embed": P(shard_if(mesh, cfg.vocab_size, "model"), dshard),
        "layers": layers,
        "final_norm": P(None),
        "lm_head": P(dshard, shard_if(mesh, cfg.vocab_size, "model")),
    }


def layer_pspecs(full_pspecs):
    """The layer specs without their leading L axis (one layer's tensors)."""
    return _map_specs(lambda s: P(*s[1:]), full_pspecs["layers"])


def opt_pspecs(param_pspecs):
    return {"m": param_pspecs, "v": param_pspecs, "step": P()}


def lm_batch_pspec(mesh, batch: int):
    dp = dp_axes(mesh)
    b = shard_if(mesh, batch, dp if len(dp) > 1 else dp[0])
    return P(b, None)


def cache_pspecs(cfg, mesh, batch: int, t: int):
    """Decode-cache sharding: batch over DP if divisible, else cache length
    over `data` (context-parallel decode), else replicate."""
    a = cfg.attn
    dp = dp_spec(mesh)
    b_ax = shard_if(mesh, batch, dp)
    t_ax = None if b_ax else shard_if(mesh, t, "data")
    if a.kind == "mla":
        return {"ckv": P(None, b_ax, t_ax, None), "kr": P(None, b_ax, t_ax, None)}
    kv_ax = shard_if(mesh, a.kv_eff, "model") and "model"
    return {"k": P(None, b_ax, t_ax, kv_ax, None),
            "v": P(None, b_ax, t_ax, kv_ax, None)}


# ------------------------------------------------------------------- LM cells
def _lm_train_step(cfg, n_micro: int, accumulate: bool):
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import make_train_step, make_train_step_accum

    def step(params, opt_state, batch):
        model = tf.from_param_tree(params, cfg).requires_grad_(True)

        def loss(_, bt):
            return tf.loss_fn(model, bt)
        if accumulate:
            fn = make_train_step_accum(loss, OptimizerConfig(), n_micro)
        else:
            fn = make_train_step(loss, OptimizerConfig())
        return fn(tf.param_tree(model), opt_state, batch)

    return step


def build_lm_cell(cfg, shape: ShapeDef, mesh, depth: tuple | None = None) -> Cell:
    """``repro``'s LM cell: params FSDP x TP, head padding where the heads
    do not divide the model axis, ``n_micro`` from the 2 GiB carry rule.
    ``depth`` (layers, microbatches run, ``n_micro``) cuts it for the probe:
    ``cfg.n_layers`` layers, that many microbatches of ``b / n_micro`` rows."""
    from repro_torch.launch.mesh import DeviceGrid
    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import init_state

    b = shape.dims["global_batch"]
    s = shape.dims["seq_len"]
    sizes = axis_sizes(mesh)
    dp = dp_spec(mesh)
    act_axes = shard_if(mesh, b, dp)     # None when batch can't shard (e.g. B=1)
    cfg = dataclasses.replace(cfg, shard_activations=act_axes)
    # transparent head padding when n_heads doesn't divide the tensor axis
    tp_size = sizes.get("model", 1)
    a = cfg.attn
    if a.n_heads % tp_size:
        g = a.n_heads // a.n_kv
        step_h = math.lcm(tp_size, g)
        h_pad = -(-a.n_heads // step_h) * step_h
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(a, pad_heads_to=h_pad))
    full_layers = cfg.n_layers
    pspecs = lm_param_pspecs(cfg, mesh)
    meta = tf.param_tree(tf.init_params(cfg, "meta"))
    params_sh = specs_of(meta)
    grid_cfg = cfg
    if cfg.moe is not None:              # distributed MoE: the sort dispatch's regions
        grid_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, mesh=DeviceGrid.of(mesh, act_axes), dp_axes="data" if act_axes else None))

    def cut(layers: int, micro: int, n_micro: int):
        return build_lm_cell(dataclasses.replace(cfg, n_layers=layers), shape, mesh,
                             depth=(layers, micro, n_micro))

    if shape.kind == "train":
        dp_size = math.prod(sizes[a] for a in dp_axes(mesh))
        carry_bytes = (b // max(dp_size, 1)) * s * cfg.d_model * 2 * full_layers
        n_micro = 1
        while (carry_bytes / n_micro > 2 * 2 ** 30 and n_micro < 8
               and (b // (n_micro * 2)) % dp_size == 0):
            n_micro *= 2
        micro = n_micro
        if depth is not None:
            _, micro, n_micro = depth
        rows = b // n_micro * micro
        batch_sds = {"tokens": TensorSpec((rows, s), torch.int32),
                     "labels": TensorSpec((rows, s), torch.int32)}
        bspec = {"tokens": lm_batch_pspec(mesh, b), "labels": lm_batch_pspec(mesh, b)}
        return Cell(cfg.name, shape.name, "train",
                    _lm_train_step(grid_cfg, micro, n_micro > 1),
                    (params_sh, specs_of(init_state(meta)), batch_sds),
                    (pspecs, opt_pspecs(pspecs), bspec), donate_argnums=(0, 1),
                    model_flops=lm_model_flops(cfg, "train", b, s),
                    notes=f"n_micro={n_micro}", depth=(full_layers, micro),
                    at_depth=None if depth else
                    (lambda layers, m: cut(layers, m, n_micro)))

    at_depth = None if depth else (lambda layers, m: cut(layers, 1, 1))
    if shape.kind == "prefill":
        def prefill(params, toks):
            return tf.prefill(tf.from_param_tree(params, grid_cfg), toks, max_seq=s)
        return Cell(cfg.name, shape.name, "prefill", prefill,
                    (params_sh, TensorSpec((b, s), torch.int32)),
                    (pspecs, lm_batch_pspec(mesh, b)),
                    model_flops=lm_model_flops(cfg, "prefill", b, s),
                    depth=(full_layers, 1), at_depth=at_depth)

    # decode: one new token against a cache of seq_len
    t = tf.cache_len(cfg, s)
    cache_sh = specs_of(tf.init_cache(cfg, b, s, device="meta"))

    def decode(params, cache, tok):
        return tf.decode_step(tf.from_param_tree(params, grid_cfg), cache, tok, s - 1)
    tok_spec = P(shard_if(mesh, b, dp_spec(mesh)))
    return Cell(cfg.name, shape.name, "decode", decode,
                (params_sh, cache_sh, TensorSpec((b,), torch.int32)),
                (pspecs, cache_pspecs(cfg, mesh, b, t), tok_spec), donate_argnums=(1,),
                model_flops=lm_model_flops(cfg, "decode", b, s, cache=t),
                depth=(full_layers, 1), at_depth=at_depth)
