"""The port's GIN and graph helpers against ``repro``'s on the CPU.

Weights come from ``repro``'s ``init_params`` (each ``eps`` then set apart
from 0, so ``(1 + eps) h`` is exercised) and cross over through
``gnn.params_from_numpy``; graphs come from the helpers, which the port
copies bit for bit.  Tolerances, and why:

  * the graph helpers: equal;
  * logits within rtol = atol = 1e-5 and the loss within 1e-5 relative:
    the same float32 ops, the sums inside each matmul, softmax and
    scatter in another order;
  * each gradient leaf: max abs error over the leaf's max abs <= 1e-4
    (``GRAD_TOL``), as for the LMs.

With ``comm_dtype`` bf16 the forward is ``repro``'s (``h`` rounded before
the gather, the sum in float32), but the backward is not: ``repro``'s
transpose of the gather adds the edges' bf16 gradients in bf16, one
rounding an edge, which on a skewed graph moves a leaf's gradient by
several percent; the port adds them in float64 and rounds once, so the
card and the CPU agree.  Its gradients are held against ``repro``'s loss
with that one transpose summed in float32 and rounded once
(:func:`j_take_f32_sum`; float32 and float64 sums differ by float32
rounding).

Covered: ``random_graph``, ``batched_molecules``, ``partition_edges_by_dst``,
``CSRNeighborTable`` and ``sample_subgraph``; GIN's forward, loss and every
gradient with and without each mask, in float32 and bf16; ``repro``'s
sampled-subgraph batch; one train step; the parameter layout;
``loss_fn_dst_partitioned`` on 4 gloo ranks against ``repro``'s 4-device
host mesh and one-device ``loss_fn``; and gin-tu's cell sizes and model
FLOPs against ``repro``'s ``build_cell``.
"""
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.configs import gin_tu as jgin_tu
from repro.data import graph as jgraph
from repro.models import gnn as jg
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro.training.checkpoint import _leaf_paths
from repro_torch import configs
from repro_torch.configs import gin_tu
from repro_torch.data import graph
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import gnn as G
from repro_torch.training import optimizer, train_loop
from repro_torch.training.tree import named_leaves
from test_distributed import run_with_devices
from test_torch_training import (GRAD_TOL, OPT, assert_leaves_close, port_leaves,
                                 rel, repro_leaves, update_tol)
from torch_gnn_ranks import dst_partitioned_rank

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads would only take cores from the other
# workers' tests.
torch.set_num_threads(1)

FWD_TOL = 1e-5
COMM = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def configs_of(comm="f32", **kw):
    kw = dict(name="t", n_layers=3, d_hidden=16, d_feat=8, n_classes=4) | kw
    jdt, tdt = COMM[comm]
    return jg.GINConfig(**kw, comm_dtype=jdt), G.GINConfig(**kw, comm_dtype=tdt)


def carried(jcfg, cfg, seed=0):
    """repro's params (each eps set to 0.1 * (layer + 1)) and the port's
    trainable model with the same weights."""
    jparams = jax.jit(jg.init_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    for i, pl in enumerate(jparams["layers"]):
        pl["eps"] = jnp.float32(0.1 * (i + 1))
    model = G.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jparams, model.requires_grad_(True)


def graph_batch(n_nodes=200, n_edges=1500, d_feat=8, n_classes=4, masks="both", seed=0):
    g = jgraph.random_graph(n_nodes, n_edges, d_feat, n_classes, seed=seed)
    rng = np.random.default_rng(seed + 1)
    b = {"features": g.features, "edge_src": g.edge_index[0],
         "edge_dst": g.edge_index[1], "labels": g.labels}
    if masks in ("edge", "both"):
        b["edge_mask"] = rng.random(n_edges) < 0.8
    if masks in ("label", "both"):
        b["label_mask"] = rng.random(n_nodes) < 0.5
    return b


def both(b):
    return ({k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


# ----------------------------------------------------- repro, one transpose apart
@jax.custom_vjp
def j_take_f32_sum(h, src, comm_like):
    """``jnp.take(h.astype(comm), src).astype(h.dtype)`` whose transpose adds
    the edges' gradients, rounded to the comm dtype, in float32 and rounds
    the sum once (the port's backward, but for its float64 sum)."""
    return jnp.take(h.astype(comm_like.dtype), src, axis=0).astype(h.dtype)


def _take_fwd(h, src, comm_like):
    return j_take_f32_sum(h, src, comm_like), (h.shape[0], src, comm_like)


def _take_bwd(res, g):
    n, src, comm_like = res
    acc = jax.ops.segment_sum(g.astype(comm_like.dtype).astype(jnp.float32), src,
                              num_segments=n)
    return acc.astype(comm_like.dtype).astype(g.dtype), None, None


j_take_f32_sum.defvjp(_take_fwd, _take_bwd)


def j_loss_f32_sum(params, batch, cfg):
    """``repro``'s ``gnn.loss_fn``, op for op, with the gather of
    :func:`j_take_f32_sum`."""
    h = batch["features"].astype(cfg.dtype)
    n = h.shape[0]
    em = batch.get("edge_mask")
    w = em.astype(cfg.dtype)[:, None] if em is not None else None
    like = jnp.zeros((), cfg.comm_dtype)
    for pl in params["layers"]:
        msg = j_take_f32_sum(h, batch["edge_src"], like)
        if w is not None:
            msg = msg * w
        agg = jax.ops.segment_sum(msg, batch["edge_dst"], num_segments=n)
        z = (1.0 + pl["eps"]).astype(cfg.dtype) * h + agg
        z = jax.nn.relu(jnp.einsum("nf,fh->nh", z, pl["w1"]) + pl["b1"])
        h = jax.nn.relu(jnp.einsum("nh,hk->nk", z, pl["w2"]) + pl["b2"])
    logits = jnp.einsum("nh,hc->nc", h, params["head"]).astype(jnp.float32)
    nll = jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
        logits, batch["labels"][:, None], 1)[:, 0]
    mask = batch.get("label_mask")
    if mask is None:
        return jnp.mean(nll)
    return jnp.sum(jnp.where(mask, nll, 0.0)) / jnp.maximum(jnp.sum(mask), 1)


# ---------------------------------------------------------------- graph data
def test_graph_helpers_equal_repro():
    def equal(got, want):
        for k in vars(want):
            a, b = getattr(got, k), getattr(want, k)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                assert a == b, k

    for args in ((100, 700, 5, 3, 0), (2708, 10556, 16, 7, 4), (1, 3, 2, 2, 1)):
        g, jgr = graph.random_graph(*args), jgraph.random_graph(*args)
        equal(g, jgr)
        assert g.n_edges == jgr.n_edges
        for n_parts, pad in ((1, 1.2), (3, 1.2), (4, 4.0), (4, 0.5)):   # 0.5 overflows
            for a, b in zip(graph.partition_edges_by_dst(g, n_parts, pad),
                            jgraph.partition_edges_by_dst(jgr, n_parts, pad)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    equal(graph.batched_molecules(5, 30, 64, 16, seed=2),
          jgraph.batched_molecules(5, 30, 64, 16, seed=2))
    g, jgr = graph.random_graph(300, 2000, 8, 3, seed=1), jgraph.random_graph(300, 2000, 8, 3,
                                                                            seed=1)
    t, jt = graph.CSRNeighborTable(g), jgraph.CSRNeighborTable(jgr)
    np.testing.assert_array_equal(t.sorted_src, jt.sorted_src)
    np.testing.assert_array_equal(t.indptr, jt.indptr)
    nodes = np.arange(0, 300, 7)
    for a, b in zip(t.sample(nodes, 5, np.random.default_rng(3)),
                    jt.sample(nodes, 5, np.random.default_rng(3))):
        np.testing.assert_array_equal(a, b)
    equal(graph.sample_subgraph(g, t, np.arange(16), (5, 3), seed=2),
          jgraph.sample_subgraph(jgr, jt, np.arange(16), (5, 3), seed=2))


# ---------------------------------------------------------------- the model
J_VG = {}


def repro_value_and_grad(jcfg, f32_sum=False):
    key = (jcfg, f32_sum)
    if key not in J_VG:
        loss = (lambda p, b: (j_loss_f32_sum(p, b, jcfg), {})) if f32_sum else \
            (lambda p, b: jg.loss_fn(p, b, jcfg))
        J_VG[key] = jax.jit(jax.value_and_grad(loss, has_aux=True))
    return J_VG[key]


@pytest.mark.parametrize("masks", ["none", "edge", "label", "both"])
@pytest.mark.parametrize("comm", ["f32", "bf16"])
def test_gin_forward_loss_and_gradients_match_repro(comm, masks):
    jcfg, cfg = configs_of(comm)
    jparams, model = carried(jcfg, cfg)
    tb, jb = both(graph_batch(masks=masks))
    with torch.no_grad():
        logits = G.forward(G.param_tree(model), tb["features"], tb["edge_src"],
                           tb["edge_dst"], tb.get("edge_mask"), 200, cfg)
        np.testing.assert_allclose(model(tb).numpy(), logits.numpy())
    jlogits = jg.forward(jparams, jb["features"], jb["edge_src"], jb["edge_dst"],
                         jb.get("edge_mask"), 200, jcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=FWD_TOL,
                               atol=FWD_TOL)
    loss, aux, grads = train_loop.value_and_grad(lambda p, b: G.loss_fn(p, b, cfg),
                                                 G.param_tree(model), tb)
    (jloss, jaux), _ = repro_value_and_grad(jcfg)(jparams, jb)
    assert rel(loss, jloss) <= FWD_TOL and aux.keys() == jaux.keys()
    # float32: repro's own gradient; bf16: repro's with the transpose the port takes
    (floss, _), fgrads = repro_value_and_grad(jcfg, f32_sum=comm == "bf16")(jparams, jb)
    assert rel(floss, jloss) <= FWD_TOL
    assert_leaves_close(port_leaves(grads), repro_leaves(fgrads))


def test_gin_on_repros_sampled_subgraph_batch():
    """``repro``'s ``test_gin_neighbor_sampler_step`` batch: the REDUCED
    config on a fanout 5-3 sample from 16 seeds, labels padded."""
    jcfg = jconfigs.get("gin-tu").make_reduced()
    cfg = configs.get("gin-tu").make_reduced()
    g = graph.random_graph(300, 2000, cfg.d_feat, cfg.n_classes, seed=1)
    sub = graph.sample_subgraph(g, graph.CSRNeighborTable(g), np.arange(16), (5, 3), seed=2)
    n_sub = sub.features.shape[0]
    assert n_sub == 16 + 16 * 5 + 16 * 5 * 3
    tb, jb = both({"features": sub.features, "edge_src": sub.edge_src,
                   "edge_dst": sub.edge_dst, "edge_mask": sub.edge_mask,
                   "labels": np.pad(sub.labels, (0, n_sub - sub.n_seeds)),
                   "label_mask": np.arange(n_sub) < sub.n_seeds})
    jparams, model = carried(jcfg, cfg)
    (jloss, _), jgrads = repro_value_and_grad(jcfg)(jparams, jb)
    loss, _, grads = train_loop.value_and_grad(lambda p, b: G.loss_fn(p, b, cfg),
                                               G.param_tree(model), tb)
    assert np.isfinite(float(loss)) and rel(loss, jloss) <= FWD_TOL
    assert_leaves_close(port_leaves(grads), repro_leaves(jgrads))


def test_gin_train_step_matches_repro():
    jcfg, cfg = configs_of("f32")
    jparams, model = carried(jcfg, cfg, seed=1)
    tb, jb = both(graph_batch(seed=5))
    params = G.param_tree(model)
    step = train_loop.make_train_step(lambda p, b: G.loss_fn(p, b, cfg),
                                      optimizer.OptimizerConfig(**OPT))
    params, state, m = step(params, optimizer.init_state(params), tb)
    jstep = jax.jit(jloop.make_train_step(lambda p, b: jg.loss_fn(p, b, jcfg),
                                          jopt.OptimizerConfig(**OPT)))
    jparams, jstate, jm = jstep(jparams, jopt.init_state(jparams), jb)
    for k in ("loss", "grad_norm", "lr"):
        assert rel(m[k], jm[k]) <= GRAD_TOL, k
    assert_leaves_close(port_leaves(state["m"]), repro_leaves(jstate["m"]))
    update_tol(float(m["lr"]))(port_leaves(params), repro_leaves(jparams))
    assert state["m"]["layers"][0]["eps"].dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_layout_and_float32_eps(dtype):
    jcfg = jg.GINConfig("gin-tu", 5, 64, 1433, 7)
    cfg = G.GINConfig("gin-tu", 5, 64, 1433, 7, dtype=dtype)
    model = G.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
    want = {n: tuple(v.shape) for n, v in _leaf_paths(jax.eval_shape(
        lambda: jg.init_params(jax.random.PRNGKey(0), jcfg)))}
    got = {n: tuple(t.shape) for n, t in named_leaves(G.param_tree(model))}
    assert got == want
    for n, t in named_leaves(G.param_tree(model)):
        assert t.dtype == (torch.float32 if n.endswith("eps") else dtype), n
    back = G.params_from_numpy(G.params_to_numpy(model), cfg, device="cpu")
    for (n, a), (_, b) in zip(named_leaves(G.param_tree(model)),
                              named_leaves(G.param_tree(back))):
        assert a.dtype == b.dtype and torch.equal(a, b), n


# ------------------------------------------------------------ across ranks
MESH_SCRIPT = """
    import json, numpy as np, jax, jax.numpy as jnp
    from repro.models import gnn
    from repro.data import graph as gdata
    mesh = jax.make_mesh((4,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
    cfg = gnn.GINConfig("t", n_layers=3, d_hidden=16, d_feat=8, n_classes=4,
                        comm_dtype=jnp.float32)
    g = gdata.random_graph(64, 400, 8, 4, seed=0)
    params = gnn.init_params(jax.random.PRNGKey(0), cfg)
    src, dst, emask = gdata.partition_edges_by_dst(g, 4, pad_factor=4.0)
    lmask = np.arange(64) % 3 != 0
    batch = {"features": jnp.asarray(g.features), "edge_src": jnp.asarray(src),
             "edge_dst": jnp.asarray(dst), "edge_mask": jnp.asarray(emask),
             "labels": jnp.asarray(g.labels), "label_mask": jnp.asarray(lmask)}
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: gnn.loss_fn_dst_partitioned(
            p, b, cfg, mesh, "data")[0]))(params, batch)
    from repro.training.checkpoint import _leaf_paths
    np.savez(OUT, loss=np.float32(loss),
             **{n.replace("/", "__"): np.asarray(x) for n, x in _leaf_paths(grads)})
    print("OK")
"""


def test_dst_partitioned_on_four_gloo_ranks_matches_repro_mesh_and_loss_fn():
    """``repro``'s ``test_gnn_dst_partitioned_matches_local`` graph (64 nodes,
    400 edges, padded per part to 4x the mean, a third of the labels masked):
    the port on 4 gloo ranks against ``repro``'s 4-device host mesh and
    against one-device ``loss_fn`` (loss and every all-reduced gradient, in
    ``repro``'s and the port's), in float32; in bf16 against the port's
    one-device ``loss_fn`` and ``repro``'s loss."""
    g = graph.random_graph(64, 400, 8, 4, seed=0)
    src, dst, emask = graph.partition_edges_by_dst(g, 4, pad_factor=4.0)
    assert not emask.all()              # in-range padding reaches the scatter
    batch = {"features": g.features, "edge_src": src, "edge_dst": dst,
             "edge_mask": emask, "labels": g.labels,
             "label_mask": np.arange(64) % 3 != 0}
    jcfg, cfg = configs_of("f32")
    jcfg16, cfg16 = configs_of("bf16")
    jparams = jg.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "mesh.npz"
        assert "OK" in run_with_devices(f"    OUT = {str(out)!r}" + MESH_SCRIPT, n=4)
        mesh = dict(np.load(out))
    mesh_loss = float(mesh.pop("loss"))
    mesh_grads = {n.replace("__", "/"): v.astype(np.float64) for n, v in mesh.items()}
    ranks = spawn_ranks(4, dst_partitioned_rank, tree, batch, [cfg, cfg16], device="cpu")
    tb, jb = both(batch)
    (jloss, _), jgrads = repro_value_and_grad(jcfg)(jparams, jb)
    assert rel(mesh_loss, jloss) <= FWD_TOL
    assert_leaves_close(mesh_grads, repro_leaves(jgrads))
    (jloss16, _), _ = repro_value_and_grad(jcfg16)(jparams, jb)
    for c in (cfg, cfg16):
        model = G.params_from_numpy(tree, c, device="cpu").requires_grad_(True)
        loss, _, grads = train_loop.value_and_grad(lambda p, b: G.loss_fn(p, b, c),
                                                   G.param_tree(model), tb)
        for rank_out in ranks:
            r_loss, r_ce, r_grads = rank_out[0 if c is cfg else 1]
            assert r_loss == r_ce
            assert rel(r_loss, loss) <= FWD_TOL
            assert rel(r_loss, jloss if c is cfg else jloss16) <= FWD_TOL
            got = {n: np.asarray(v, np.float64) for n, v in named_leaves(r_grads)}
            assert_leaves_close(got, port_leaves(grads))
            if c is cfg:
                assert_leaves_close(got, repro_leaves(jgrads))
                assert_leaves_close(got, mesh_grads)
    # every rank holds the same gradient
    for rank_out in ranks[1:]:
        for (_, a), (_, b) in zip(named_leaves(rank_out[0][2]), named_leaves(ranks[0][0][2])):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ configs
def test_cell_sizes_and_model_flops_equal_repros_build_cell():
    from repro.configs.gin_tu import build_cell
    mesh = jax.make_mesh((1,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
    for name, shape in gin_tu.SHAPES.items():
        cell = build_cell(None, jgin_tu.SHAPES[name], mesh)
        assert gin_tu.model_flops(shape) == cell.model_flops, name
        n, e = gin_tu.cell_sizes(shape)
        assert cell.notes.startswith(f"padded nodes {n}->") and f" edges {e}->" in cell.notes
    assert gin_tu.sampled_sizes(gin_tu.SHAPES["minibatch_lg"].dims) == \
        jgin_tu.sampled_sizes(jgin_tu.SHAPES["minibatch_lg"].dims)
    cfg = gin_tu.cell_config(gin_tu.SHAPES["ogb_products"])
    assert (cfg.n_layers, cfg.d_hidden, cfg.d_feat, cfg.n_classes, cfg.comm_dtype) == \
        (5, 64, 100, 47, torch.bfloat16)
