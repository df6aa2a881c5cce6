"""The port's recsys models against ``repro.models.recsys`` on the CPU, and
the arch registry of all ten assigned archs.

Weights come from ``repro``'s ``*_init`` and cross over through
``recsys.params_from_numpy``; batches come from the generators, which the
port copies bit for bit; so both packages compute the same function in
float32.  Tolerances, and why:

  * the generators and ``embedding_bag``'s sum and max: equal; its mean
    (a sum over a count) within 1e-6 relative;
  * a forward within rtol = atol = 1e-5: the same float32 ops, where the
    sums inside each matmul and softmax run in another order (about 1e-6
    relative here);
  * a loss and each gradient leaf: max abs error over the leaf's max abs
    <= 1e-4 (``GRAD_TOL``), as for the LMs;
  * one ``make_train_step``: the loss, the gradient norm and every
    first-moment leaf within ``GRAD_TOL``, every parameter within 1e-6 of
    its leaf's scale but for the rare entries whose gradient sign a
    rounding flips (``test_torch_training.update_tol``).

Covered: the three generators, ``embedding_bag`` in its three modes with an
empty bag, each ``REDUCED`` arch's forward, loss, every gradient leaf
(the embedding tables' dense gradients included) and one train step, BST's
forward with ``labels=None``, ``twotower_score_candidates``, the FLOP
functions, the parameter layouts of the ``FULL`` configs, the registry
field by field, ``ASSIGNED`` and its 40 cells.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.configs import autoint as jautoint, bst as jbst
from repro.configs import two_tower_retrieval as jtt, xdeepfm as jxdeepfm
from repro.data import recsys as jdata
from repro.models import recsys as jr
from repro.training import optimizer as jopt
from repro.training.checkpoint import _leaf_paths
from repro.training import train_loop as jloop
from repro_torch import configs
from repro_torch.configs import autoint, bst, two_tower_retrieval, xdeepfm
from repro_torch.data import recsys as data
from repro_torch.models import recsys as R
from repro_torch.training import optimizer, train_loop
from repro_torch.training.tree import named_leaves
from test_torch_models import assert_same_config
from test_torch_training import (GRAD_TOL, OPT, assert_leaves_close, port_leaves,
                                 rel, repro_leaves, update_tol)

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads would only take cores from the other
# workers' tests.
torch.set_num_threads(1)

FWD_TOL = 1e-5
BATCH = 16
RECSYS = ["bst", "autoint", "two-tower-retrieval", "xdeepfm"]
# arch -> (function prefix, generator of its batches)
ARCHS = {
    "bst": ("bst", lambda c, m: m.BehaviorSeqGen(c.item_vocab, c.seq_len, seed=3)),
    "autoint": ("autoint", lambda c, m: m.CTRBatchGen((c.field_vocab,) * c.n_sparse,
                                                      seed=3)),
    "two-tower-retrieval": ("twotower",
                            lambda c, m: m.RetrievalGen(c.item_vocab, c.user_feat, seed=3)),
    "xdeepfm": ("xdeepfm", lambda c, m: m.CTRBatchGen((c.field_vocab,) * c.n_sparse,
                                                      seed=3)),
}
FORWARD = {"bst": "bst_forward", "autoint": "autoint_forward",
           "two-tower-retrieval": "twotower_embed", "xdeepfm": "xdeepfm_forward"}


def reduced(arch):
    return jconfigs.get(arch).make_reduced(), configs.get(arch).make_reduced()


def carried(arch, seed=0):
    """(repro's params, the port's trainable model with the same weights,
    both configs)."""
    jcfg, cfg = reduced(arch)
    prefix = ARCHS[arch][0]
    jparams = jax.jit(getattr(jr, f"{prefix}_init"), static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    model = R.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jparams, model.requires_grad_(True), jcfg, cfg


def batch_of(arch, jcfg, step=0, batch=BATCH):
    b = ARCHS[arch][1](jcfg, data).batch_at(step, batch)
    return ({k: torch.from_numpy(v) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


def close(got, want, tol=FWD_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("gen", ["ctr", "seq", "retrieval"])
def test_generators_equal_repro(gen):
    make = {"ctr": lambda m, s: m.CTRBatchGen((7, 1000, 1_000_000), n_dense=5, seed=s),
            "seq": lambda m, s: m.BehaviorSeqGen(4_000_000, 20, seed=s),
            "retrieval": lambda m, s: m.RetrievalGen(10_000_000, 32, seed=s)}[gen]
    for seed, step, batch in ((0, 0, 1), (0, 5, 64), (7, 123, 33)):
        got, want = make(data, seed).batch_at(step, batch), make(jdata, seed).batch_at(step, batch)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------ substrate
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_repro(mode):
    """Bag 2 of 5 is empty: 0 under sum and mean, -inf under max."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, 40).astype(np.int32)
    seg = np.sort(rng.choice([0, 1, 3, 4], 40)).astype(np.int32)
    got = R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          torch.from_numpy(seg), 5, mode)
    want = np.asarray(jr.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                       jnp.asarray(seg), 5, mode))
    if mode == "max":
        assert np.isneginf(want[2]).all()
    else:
        assert (want[2] == 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6 if mode == "mean" else 0,
                               atol=0)
    with pytest.raises(ValueError):
        R.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        torch.from_numpy(seg), 5, "prod")


def test_lookup_mlp_and_bce_match_repro():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((30, 4)).astype(np.float32)
    ids = rng.integers(0, 30, (3, 5)).astype(np.int32)
    close(R.embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids)),
          jr.embedding_lookup(jnp.asarray(table), jnp.asarray(ids)), 0)
    layers = [(rng.standard_normal((4, 8)).astype(np.float32),
               rng.standard_normal(8).astype(np.float32)),
              (rng.standard_normal((8, 2)).astype(np.float32),
               rng.standard_normal(2).astype(np.float32))]
    x = rng.standard_normal((6, 4)).astype(np.float32)
    for final_act in (False, True):
        close(R.mlp(torch.from_numpy(x), [tuple(map(torch.from_numpy, p)) for p in layers],
                    final_act=final_act),
              jr.mlp(jnp.asarray(x), [tuple(map(jnp.asarray, p)) for p in layers],
                     final_act=final_act))
    logits = (rng.standard_normal(64) * 30).astype(np.float32)
    labels = (rng.random(64) < 0.3).astype(np.float32)
    close(R.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels)),
          jr.bce_loss(jnp.asarray(logits), jnp.asarray(labels)))


# ------------------------------------------------------------ the archs
@pytest.mark.parametrize("arch", RECSYS)
def test_reduced_forward_matches_repro(arch):
    jparams, model, jcfg, cfg = carried(arch)
    tb, jb = batch_of(arch, jcfg)
    with torch.no_grad():
        got = getattr(R, FORWARD[arch])(R.param_tree(model), tb, cfg)
    want = getattr(jr, FORWARD[arch])(jparams, jb, jcfg)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape and g.dtype == torch.float32
        close(g, w)
    if arch != "two-tower-retrieval":
        with torch.no_grad():
            close(model(tb), want)


J_VG = {}


def repro_value_and_grad(arch, jcfg):
    if arch not in J_VG:
        loss = getattr(jr, f"{ARCHS[arch][0]}_loss")
        J_VG[arch] = jax.jit(jax.value_and_grad(lambda p, b: loss(p, b, jcfg),
                                                has_aux=True))
    return J_VG[arch]


@pytest.mark.parametrize("arch", RECSYS)
def test_reduced_loss_and_every_gradient_match_repro(arch):
    jparams, model, jcfg, cfg = carried(arch)
    tb, jb = batch_of(arch, jcfg, step=1)
    if "labels" in tb:        # a few positives, so the BCE gradient is not all one sign
        tb["labels"][::3] = 1.0
        jb["labels"] = jnp.asarray(tb["labels"].numpy())
    loss_fn = getattr(R, f"{ARCHS[arch][0]}_loss")
    (jloss, jaux), jgrads = repro_value_and_grad(arch, jcfg)(jparams, jb)
    loss, aux, grads = train_loop.value_and_grad(lambda p, b: loss_fn(p, b, cfg),
                                                 R.param_tree(model), tb)
    assert rel(loss, jloss) <= GRAD_TOL
    assert aux.keys() == jaux.keys()
    got, want = port_leaves(grads), repro_leaves(jgrads)
    assert_leaves_close(got, want)
    # the tables' gradients are dense: rows no id touched are 0, others are not
    table = "item_embed" if "item_embed" in want else "tables"
    assert (want[table] == 0).any() and (want[table] != 0).any()
    np.testing.assert_array_equal(got[table] == 0, want[table] == 0)


@pytest.mark.parametrize("arch", RECSYS)
def test_train_step_matches_repro(arch):
    jparams, model, jcfg, cfg = carried(arch, seed=1)
    tb, jb = batch_of(arch, jcfg, step=2)
    loss_fn = getattr(R, f"{ARCHS[arch][0]}_loss")
    jloss_fn = getattr(jr, f"{ARCHS[arch][0]}_loss")
    params = R.param_tree(model)
    params_by_name = dict(named_leaves(params))
    step = train_loop.make_train_step(lambda p, b: loss_fn(p, b, cfg),
                                      optimizer.OptimizerConfig(**OPT))
    params, state, m = step(params, optimizer.init_state(params), tb)
    jstep = jax.jit(jloop.make_train_step(lambda p, b: jloss_fn(p, b, jcfg),
                                          jopt.OptimizerConfig(**OPT)))
    jparams, jstate, jm = jstep(jparams, jopt.init_state(jparams), jb)
    for k in ("loss", "grad_norm", "lr"):
        assert rel(m[k], jm[k]) <= GRAD_TOL, k
    assert int(state["step"]) == int(jstate["step"]) == 1
    assert_leaves_close(port_leaves(state["m"]), repro_leaves(jstate["m"]))
    update_tol(float(m["lr"]))(port_leaves(params), repro_leaves(jparams))
    # the update wrote into the model's own tensors
    assert R.params_to_numpy(model).keys() == R.param_tree(model).keys()
    for name, t in named_leaves(R.param_tree(model)):
        assert t is params_by_name[name]


def test_bst_forward_without_labels_and_twotower_candidates():
    """BST as ``repro``'s retrieval_cand cell calls it (``labels=None``), and
    two-tower's candidate scoring of one query against 64 ids."""
    jparams, model, jcfg, cfg = carried("bst")
    tb, jb = batch_of("bst", jcfg)
    tb["labels"], jb["labels"] = None, None
    with torch.no_grad():
        close(R.bst_forward(R.param_tree(model), tb, cfg), jr.bst_forward(jparams, jb, jcfg))
    jparams, model, jcfg, cfg = carried("two-tower-retrieval")
    rng = np.random.default_rng(4)
    b = {"user": rng.standard_normal((1, cfg.user_feat)).astype(np.float32),
         "candidates": rng.integers(0, cfg.item_vocab, 64).astype(np.int32)}
    with torch.no_grad():
        got = R.twotower_score_candidates(R.param_tree(model),
                                          {k: torch.from_numpy(v) for k, v in b.items()}, cfg)
    want = jr.twotower_score_candidates(jparams, {k: jnp.asarray(v) for k, v in b.items()},
                                        jcfg)
    assert got.shape == (1, 64)
    close(got, want)


def test_unit_norm_clips_the_norm_not_its_square():
    """A zero tower output stays 0 (its norm clipped to 1e-6); a row of norm
    1e-5 is scaled to norm 1, where clipping the square at 1e-6 would not."""
    x = torch.tensor([[0.0, 0.0], [6e-6, 8e-6]])
    got = R._unit(x)
    assert torch.equal(got[0], torch.zeros(2))
    torch.testing.assert_close(got[1], torch.tensor([0.6, 0.8]))


@pytest.mark.parametrize("arch", RECSYS)
def test_full_init_has_repro_layout(arch):
    """The FULL config's tree, names, shapes and dtypes, on the meta device."""
    jcfg, cfg = jconfigs.get(arch).make(), configs.get(arch).make()
    prefix = ARCHS[arch][0]
    jtree = jax.eval_shape(lambda: getattr(jr, f"{prefix}_init")(jax.random.PRNGKey(0), jcfg))
    model = getattr(R, f"{prefix}_init")(cfg, "meta")
    got = {n: (tuple(t.shape), t.dtype) for n, t in named_leaves(R.param_tree(model))}
    want = {n: (tuple(v.shape), torch.float32) for n, v in _leaf_paths(jtree)}
    assert got == want


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("cfgs", ["FULL", "REDUCED"])
def test_flop_functions_equal_repro(cfgs):
    for port, rep in ((bst, jbst), (autoint, jautoint), (xdeepfm, jxdeepfm)):
        for b in (1, 512, 65_536, 262_144):
            assert port._flops(getattr(port, cfgs), b) == rep._flops(getattr(rep, cfgs), b)
    cfg, jcfg = getattr(two_tower_retrieval, cfgs), getattr(jtt, cfgs)
    for n in (1, 512, 1_000_000):
        for d_in in (cfg.user_feat, cfg.embed_dim):
            assert two_tower_retrieval._tower_flops(cfg, n, d_in) == \
                jtt._tower_flops(jcfg, n, d_in)
        assert two_tower_retrieval._flops(cfg, n) == float(
            jtt._tower_flops(jcfg, n, jcfg.user_feat)
            + jtt._tower_flops(jcfg, n, jcfg.embed_dim) + 2 * n * n * jcfg.tower_dims[-1])
        assert two_tower_retrieval._retrieval_flops(cfg, n) == float(
            jtt._tower_flops(jcfg, n, jcfg.embed_dim) + 2 * n * jcfg.tower_dims[-1])


DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def assert_same_fields(cfg, jcfg):
    """A recsys or GNN config equals ``repro``'s field by field (dtypes
    mapped to torch's)."""
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
    for f in dataclasses.fields(jcfg):
        want = getattr(jcfg, f.name)
        want = DTYPES.get(want, want) if not isinstance(want, (int, str, tuple)) else want
        assert getattr(cfg, f.name) == want, f.name


@pytest.mark.parametrize("arch", jconfigs.ASSIGNED)
def test_registry_matches_repro_field_by_field(arch):
    ad, jad = configs.get(arch), jconfigs.get(arch)
    assert (ad.name, ad.family, ad.notes) == (jad.name, jad.family, jad.notes)
    same = assert_same_config if ad.family == "lm" else assert_same_fields
    same(ad.make(), jad.make())
    same(ad.make_reduced(), jad.make_reduced())
    assert ad.shapes.keys() == jad.shapes.keys()
    for name, shape in ad.shapes.items():
        js = jad.shapes[name]
        assert (shape.name, shape.kind, shape.dims, shape.skip_reason) == \
            (js.name, js.kind, js.dims, js.skip_reason)


def test_assigned_and_the_40_cells_enumerate():
    """``repro``'s ``test_all_40_cells_enumerate`` on the port's registry,
    which holds the paper's n-gram job as its 11th arch, as ``repro``'s."""
    assert configs.ASSIGNED == jconfigs.ASSIGNED
    assert set(configs.all_archs()) == set(configs.ASSIGNED) | {"ngram-suffix-sigma"}
    assert configs.all_archs() == jconfigs.all_archs()
    assert configs.all_cells() == jconfigs.all_cells()
    cells = [(a, s) for a in configs.ASSIGNED for s in configs.get(a).shapes]
    assert len(cells) == 40
    skips = [c for a, s in cells
             if (c := configs.get(a).shapes[s].skip_reason) is not None]
    assert len(skips) == 4  # the documented full-attention long_500k skips
    assert configs.NOT_PORTED == {}
