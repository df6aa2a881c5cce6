"""The dry run's regions on real gloo ranks (imported by each rank of
``tests/test_torch_dryrun.py`` and ``tests/test_torch_regions.py``; no JAX
here, as every rank imports this module)."""
import dataclasses

import numpy as np
import torch


def distributed_block_rank(mesh, tokens: np.ndarray, sigma: int, vocab: int,
                           capacity: int) -> list:
    """This rank's ``suffix_sigma.distributed_block`` of its row of
    ``tokens`` [P, n_local], over a ``DeviceMesh`` of the world's ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import NGramConfig
    from repro_torch.core.suffix_sigma import distributed_block
    from repro_torch.launch.mesh import MeshAxes

    dmesh = init_device_mesh("cpu", (mesh.size,), mesh_dim_names=("shards",))
    axes = MeshAxes(dmesh, ("shards",))
    cfg = NGramConfig(sigma=sigma, tau=1, vocab_size=vocab)
    out = distributed_block(torch.from_numpy(tokens[mesh.rank]), cfg, axes, capacity)
    return [t.numpy() for t in out]


# ------------------------------------------------- the regions on 2 x 2 ranks
def _whole(t):
    from repro_torch.launch.mesh import is_dtensor
    return (t.full_tensor() if is_dtensor(t) else t).detach().numpy().copy()


def _run(fn, inputs: list, specs: list, mesh, grad: bool):
    """``fn(*inputs)`` on DTensors placed by ``specs`` (None: as it is) under
    the regions, and on the plain tensors: each one's output and, with
    ``grad``, the gradients of ``sum(output * w)`` in its inputs (w fixed
    by a seed), as whole arrays."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import regions
    from repro_torch.launch.mesh import placements

    def once(distributed: bool):
        args = []
        for t, s in zip(inputs, specs):
            t = t.clone()
            if distributed and s is not None:
                t = distribute_tensor(t, mesh, placements(mesh, s))
            if grad and t.is_floating_point():
                t.requires_grad_(True)
            args.append(t)
        with implicit_replication(), regions.installed():
            out = fn(*args)
            outs = list(out) if isinstance(out, tuple) else [out]
            whole = [o.full_tensor() if hasattr(o, "full_tensor") else o for o in outs]
            res = [_whole(o) for o in whole]
            if grad:
                g = torch.Generator().manual_seed(99)
                loss = sum((o * torch.randn(o.shape, generator=g)).sum() for o in whole
                           if o.is_floating_point())
                wrt = [a for a in args if a.requires_grad]
                res += [_whole(x) for x in torch.autograd.grad(loss, wrt)]
        return res
    return once(True), once(False)


def _function_cases(mesh) -> dict:
    from repro_torch.launch.mesh import P
    from repro_torch.models import layers, recsys

    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    def ids(high, *shape):
        return torch.randint(0, high, shape, generator=g, dtype=torch.int32)

    pos = torch.arange(8, dtype=torch.int32)

    def attention(window=None, q_chunk=0):
        def fn(q, k, v):
            return layers.gqa_attention(q, k, v, q_positions=pos, k_positions=pos,
                                        window=window, q_chunk=q_chunk)
        return fn

    def decode(valid):
        def fn(q, k, v):
            return layers.decode_attention(q, k, v, valid=valid)
        return fn

    qs = P("data", None, "model", None)
    kv_whole = P("data", None, None, None)
    valid = torch.arange(8) < 6
    cases = {
        # K/V heads split with the query heads; K/V whole, shared (MQA)
        "attention_kv_split": (attention(), [r(4, 8, 4, 8), r(4, 8, 2, 8), r(4, 8, 2, 8)],
                               [qs, qs, qs], True),
        "attention_kv_shared": (attention(), [r(4, 8, 4, 8), r(4, 8, 1, 8), r(4, 8, 1, 8)],
                                [qs, kv_whole, kv_whole], True),
        # 3 K/V heads for 6 query heads on 2 devices: each device's share
        # starts inside a K/V head's group
        "attention_kv_uneven": (attention(), [r(4, 8, 6, 8), r(4, 8, 3, 8), r(4, 8, 3, 8)],
                                [qs, kv_whole, kv_whole], True),
        "attention_window_chunks": (attention(3, 4), [r(4, 8, 4, 8), r(4, 8, 2, 8),
                                                      r(4, 8, 2, 8)], [qs, qs, qs], True),
        # one row: the cache's slots over `data` (context parallel)
        "decode_context_parallel": (decode(valid), [r(1, 4, 8), r(1, 8, 2, 8), r(1, 8, 2, 8)],
                                    [P(None, "model", None), P(None, "data", "model", None),
                                     P(None, "data", "model", None)], False),
        "decode_context_parallel_kv_shared": (
            decode(valid), [r(1, 4, 8), r(1, 8, 1, 8), r(1, 8, 1, 8)],
            [P(None, "model", None), P(None, "data", None, None),
             P(None, "data", None, None)], False),
        "decode_rows": (decode(valid), [r(4, 4, 8), r(4, 8, 2, 8), r(4, 8, 2, 8)],
                        [P("data", "model", None), P("data", None, "model", None),
                         P("data", None, "model", None)], False),
        "swiglu": (layers.swiglu, [r(4, 8, 16), r(16, 32), r(16, 32), r(32, 16)],
                   [P("data", None, None), P("data", "model"), P("data", "model"),
                    P("model", "data")], True),
        "cross_entropy": (lambda x, w, lab: layers.cross_entropy_loss(x, w, lab, 2),
                          [r(4, 8, 16), r(16, 64), ids(64, 4, 8)],
                          [P("data", None, None), P("data", "model"), P("data", None)], True),
        "lookup_rows": (layers.lookup_rows, [r(32, 16), ids(32, 4, 8)],
                        [P("model", "data"), P("data", None)], True),
        "head_logits": (layers.head_logits, [r(4, 16), r(16, 64)],
                        [P("data", None), P("data", "model")], True),
        "embedding_lookup": (recsys.embedding_lookup, [r(32, 8), ids(32, 4, 3)],
                             [P("model", None), P("data", None)], True),
        "per_field": (recsys._per_field, [r(3, 32, 8), ids(32, 4, 3)],
                      [P(None, "model", None), P("data", None)], True),
        "in_batch_softmax": (lambda u, i: recsys._in_batch_softmax(u, i, 0.05),
                             [r(8, 16), r(8, 16)], [P("data", None), P("data", None)], True),
    }
    return {k: _run(fn, xs, ss, mesh, grad) for k, (fn, xs, ss, grad) in cases.items()}


def _moe_cases(mesh) -> dict:
    """``moe_ffn_sharded`` on a ``DeviceGrid`` of the layout, experts over
    ``model`` (EP, 4 experts + 2 shared) or each expert's d_ff over it
    (ffTP, 3 experts), against ``moe_ffn`` with the whole weights on each
    data row (each row sizes its capacity on its own tokens): y, the rows'
    mean aux, and their gradients."""
    from repro_torch.launch.mesh import DeviceGrid, P, is_dtensor
    from repro_torch.models import moe as tm

    grid = DeviceGrid.of(mesh, "data")
    out = {}
    for name, (experts, shared) in {"moe_expert_parallel": (4, 2),
                                    "moe_ff_parallel": (3, 0)}.items():
        plain = tm.MoEConfig(experts, 2, 32, n_shared=shared, d_ff_shared=24 if shared else 0,
                             capacity_factor=1.25, dispatch="sort")
        gridded = dataclasses.replace(plain, mesh=grid, dp_axes="data")
        g = torch.Generator().manual_seed(4)
        params = tm.init_moe_params(16, plain, torch.float32, lambda shape, dtype:
                                    torch.randn(shape, generator=g, dtype=dtype))
        keys = list(params)

        def fn(x, *vals, plain=plain, gridded=gridded, keys=keys):
            p = dict(zip(keys, vals))
            if is_dtensor(x):
                return tm.moe_ffn_sharded(x, p, gridded)
            ys, auxes = zip(*[tm.moe_ffn(r, p, plain) for r in x.chunk(2)])
            return torch.cat(ys), torch.stack(auxes).mean()
        x = torch.randn(4, 8, 16, generator=g)
        specs = [P("data", None, None)] + [P(*([None] * v.dim())) for v in params.values()]
        out[name] = _run(fn, [x, *params.values()], specs, mesh, True)
    return out


def _adamw_case(mesh):
    """Two AdamW updates of DTensors (FSDP x TP, row-sharded and replicated
    leaves) against the plain updates."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import regions
    from repro_torch.launch.mesh import P, placements
    from repro_torch.training.optimizer import OptimizerConfig, apply_updates, init_state

    g = torch.Generator().manual_seed(1)
    shapes = {"w": (16, 8), "b": (8,), "e": (32, 4)}
    specs = {"w": P("data", "model"), "b": P(None), "e": P("model", None)}
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    cfg = OptimizerConfig(warmup_steps=1)

    def once(distributed: bool):
        def place(t, s):
            t = t.clone()
            return distribute_tensor(t, mesh, placements(mesh, s)) if distributed else t
        p = {k: place(v, specs[k]) for k, v in params.items()}
        gr = {k: place(v, specs[k]) for k, v in grads.items()}
        zero = init_state(params)
        state = {"m": {k: place(v, specs[k]) for k, v in zero["m"].items()},
                 "v": {k: place(v, specs[k]) for k, v in zero["v"].items()},
                 "step": place(zero["step"], P())}
        with implicit_replication(), regions.installed():
            for _ in range(2):
                p, state, info = apply_updates(p, gr, state, cfg)
        leaves = [p[k] for k in shapes] + [state["m"][k] for k in shapes] + \
            [state["v"][k] for k in shapes] + [info["grad_norm"]]
        return [_whole(t) for t in leaves]
    return once(True), once(False)


def _lm_cell_cases(mesh) -> dict:
    """A reduced LM's train, prefill and decode cells run for real on the
    2 x 2 layout, against the same step on plain tensors."""
    from repro_torch import configs
    from repro_torch.configs import base
    from repro_torch.launch import dryrun

    llama = configs.get("llama3.2-1b").make_reduced()
    mqa = dataclasses.replace(llama, attn=dataclasses.replace(llama.attn, n_kv=1))
    uneven = dataclasses.replace(llama, attn=dataclasses.replace(llama.attn, n_heads=6, n_kv=3))
    odd = dataclasses.replace(llama, attn=dataclasses.replace(llama.attn, n_heads=3, n_kv=3))
    train = base.ShapeDef("t", "train", {"seq_len": 8, "global_batch": 4})
    prefill = base.ShapeDef("p", "prefill", {"seq_len": 8, "global_batch": 4})
    decode_one = base.ShapeDef("d", "decode", {"seq_len": 8, "global_batch": 1})
    decode = base.ShapeDef("d", "decode", {"seq_len": 8, "global_batch": 4})
    cases = {
        "lm_train_two_micro": (llama, train, (llama.n_layers, 2, 2)),
        "lm_train_kv_shared": (mqa, train, None),
        "lm_train_kv_uneven": (uneven, train, None),
        "lm_train_padded_heads": (odd, train, None),
        "lm_prefill": (llama, prefill, None),
        "lm_decode_rows": (llama, decode, None),
        "lm_decode_context_parallel": (llama, decode_one, None),
    }
    out = {}
    for name, (cfg, shape, depth) in cases.items():
        cell = base.build_lm_cell(cfg, shape, mesh, depth=depth)
        out[name] = _cell_run(cell, mesh, cfg.vocab_size, dryrun)
    return out


def _cell_run(cell, mesh, vocab: int, dryrun):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import regions
    from repro_torch.launch.mesh import placements
    from repro_torch.training.tree import Stacked

    g = torch.Generator().manual_seed(3)
    globals_ = []

    def make(leaf, spec):
        if leaf.dtype.is_floating_point:
            t = torch.randn(leaf.shape, generator=g, dtype=torch.float32).mul_(0.1)
            t = t.to(leaf.dtype)
        else:
            t = torch.randint(0, vocab, leaf.shape, generator=g).to(leaf.dtype)
        globals_.append(t)
        return (leaf, spec, t)

    trees = [dryrun._zip_map(make, a, s) for a, s in zip(cell.args, cell.in_specs)]
    # the optimizer state starts at zero, as init_state makes it
    state = cell.args[1] if cell.kind == "train" else None

    def build(tree, distributed: bool, zero: bool):
        def one(item):
            leaf, spec, t = item
            t = torch.zeros_like(t) if zero else t.clone()
            if not distributed:
                return Stacked(t.unbind(0)) if leaf.layers else t
            if leaf.layers:
                inner = placements(mesh, type(spec)(*spec[1:]))
                return Stacked(distribute_tensor(x.contiguous(), mesh, inner)
                               for x in t.unbind(0))
            return distribute_tensor(t, mesh, placements(mesh, spec))
        return _map_items(one, tree)

    def once(distributed: bool):
        args = [build(t, distributed, zero=(state is not None and i == 1))
                for i, t in enumerate(trees)]
        with implicit_replication(), regions.installed():
            out = cell.step_fn(*args)
        return [_whole(t) for t in dryrun._tensors(out)]
    return once(True), once(False)


def _map_items(fn, tree):
    if isinstance(tree, tuple) and len(tree) == 3 and isinstance(tree[2], torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_items(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_items(fn, v) for v in tree)
    return tree


def regions_rank(mesh) -> dict:
    """Every case on a 2 x 2 (data, model) ``DeviceMesh`` of the 4 ranks:
    ``{case: (DTensor run, plain run)}``, each a list of whole arrays."""
    from torch.distributed.device_mesh import init_device_mesh

    dmesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = _function_cases(dmesh)
    out.update(_moe_cases(dmesh))
    out["adamw"] = _adamw_case(dmesh)
    out.update(_lm_cell_cases(dmesh))
    return out
