"""The port's LM training against ``repro.training`` on the CPU.

Weights are drawn by the port's ``init_params`` and cross over through
``params_to_numpy`` (into ``repro``'s tree) and ``params_from_numpy`` (into
the model that trains), batches come from the same seeded loaders, so both packages compute the same function in float32.
Tolerances, and why:

  * the optimizer (``schedule``, ``apply_updates``, clipping) on the same
    numpy inputs: 1e-6 relative -- the same float32 ops in the same order,
    where only ``pow``, ``cos`` and the sums inside the global norm may
    round apart;
  * a loss and each gradient leaf: max abs error over the leaf's max abs
    <= 1e-4 (``GRAD_TOL``) -- the sums inside each matmul and softmax run in
    another order (about 1e-6 relative here);
  * after an AdamW update, each parameter leaf within ``update_tol``: Adam
    divides by ``sqrt(v) + eps``, so where a gradient entry sits near 0 a
    rounding of 1e-7 flips its sign and moves that parameter by up to
    ``2 * lr``; the moments, linear in the gradient, are held as gradients;
  * 10-step trajectories: the loss within ``TRAJ_RTOL`` = 1e-3 relative a
    step, since those flips compound over steps;
  * within the port (remat on and off, recovery, checkpoints): bit-equal.

Covered: the five ``REDUCED`` archs' loss and gradients (MoE router and aux
loss, MLA, the window), remat, both accumulation names, 10-step trajectories of a dense arch
and a windowed MoE arch, the
loader, ``eval_shape_state`` of the full configs, ``repro``'s own training
tests, checkpoints across the packages both ways (float32) and ``repro``'s
bf16 leaves, ``compressed_psum`` on 3 gloo ranks, and the CLI.
"""
import contextlib
import dataclasses
import io
import os
import re
import tempfile
from functools import partial

import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.data import loader as jloader
from repro.models import transformer as jt
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch import configs
from repro_torch.data import loader
from repro_torch.launch import train as ltrain
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import transformer as tt
from repro_torch.training import optimizer, train_loop
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault_tolerance import (FailureInjector, StragglerDetector,
                                                  run_with_recovery)
from repro_torch.training.tree import Stacked, named_leaves
from test_torch_models import LM_ARCHS, port_cfg
from torch_training_ranks import psum_rank

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads would only take cores from the other
# workers' tests.
torch.set_num_threads(1)

GRAD_TOL = 1e-4
OPT_RTOL = 1e-6
TRAJ_RTOL = 1e-3
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=50)
TINY = dict(name="tiny", n_layers=2, d_model=32, vocab_size=97, d_ff=64)


def jax_tiny():
    return jt.LMConfig(**TINY, attn=jt.AttentionConfig("gqa", 4, 2, 8),
                       dtype=jnp.float32, remat=False)


def reduced(arch):
    jcfg = jconfigs.get(arch).make_reduced()
    return jcfg, configs.get(arch).make_reduced()


def carried(jcfg, seed=0):
    """The same float32 weights in both packages: drawn by the port's
    ``init_params``, taken to ``repro``'s tree by ``params_to_numpy`` and
    back into a fresh model by ``params_from_numpy`` (trainable)."""
    cfg = port_cfg(jcfg)
    tree = tt.params_to_numpy(tt.init_params(cfg, "cpu",
                                             torch.Generator().manual_seed(seed)))
    model = tt.params_from_numpy(tree, cfg, device="cpu")
    return jax.tree.map(jnp.asarray, tree), model.requires_grad_(True)


def batch_of(cfg, step=0, batch=4, seq=16):
    b = loader.SyntheticLMLoader(cfg.vocab_size, seq, batch).batch_at(step)
    return {k: torch.from_numpy(v) for k, v in b.items()}, \
        {k: jnp.asarray(v) for k, v in b.items()}


def port_leaves(tree) -> dict:
    """name -> float64 numpy of a port tree (Stacked leaves stacked)."""
    return {n: (torch.stack(tuple(v)) if isinstance(v, Stacked) else v)
            .detach().double().numpy() for n, v in named_leaves(tree)}


def repro_leaves(tree) -> dict:
    return {n: np.asarray(v, np.float64) for n, v in jckpt._leaf_paths(tree)}


def assert_leaves_close(got: dict, want: dict, tol=GRAD_TOL):
    assert got.keys() == want.keys()
    for name in want:
        scale = max(np.abs(want[name]).max(), 1e-30)
        err = np.abs(got[name] - want[name]).max() / scale
        assert err <= tol, (name, err)


def update_tol(lr):
    """A parameter after one AdamW update: 1e-6 of its leaf's scale, plus
    2 * lr for an entry whose gradient sign rounding flipped."""
    def check(got: dict, want: dict):
        assert got.keys() == want.keys()
        for name in want:
            err = np.abs(got[name] - want[name])
            assert err.max() <= 1e-6 * np.abs(want[name]).max() + 2 * lr, name
            # a flip is rare: nearly every entry holds to the tight bound
            assert (err > 1e-6 * np.abs(want[name]).max() + 1e-6 * lr).mean() < 1e-3, name
    return check


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ------------------------------------------------------------------ optimizer
def test_schedule_matches_repro():
    for cfg in (optimizer.OptimizerConfig(**OPT), optimizer.OptimizerConfig()):
        jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
        for s in (0, 1, 2, 3, 25, 49, 50, 60, 99, 100, 101, 5_000, 10_000, 20_000):
            got = optimizer.schedule(torch.tensor(s, dtype=torch.int32), cfg)
            want = jopt.schedule(jnp.int32(s), jcfg)
            assert got.dtype == torch.float32
            assert rel(got, want) <= OPT_RTOL or float(want) == float(got) == 0.0


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_apply_updates_and_clipping_match_repro(clip):
    """Three updates of mixed float32 / bfloat16-valued leaves, one stacked
    leaf; with clip 1.0 the norm (about 30) is clipped, with 1e3 it is not."""
    rng = np.random.default_rng(3)
    cfg = optimizer.OptimizerConfig(**OPT, grad_clip=clip)
    jcfg = jopt.OptimizerConfig(**OPT, grad_clip=clip)

    def draw(scale=1.0):
        return {"a": rng.standard_normal((5, 7)).astype(np.float32) * scale,
                "b": {"c": rng.standard_normal(3).astype(np.float32) * scale,
                      "d": rng.standard_normal((2, 4, 3)).astype(np.float32) * scale}}

    def port(tree):   # "d" as a Stacked leaf of its two layers
        return {"a": torch.tensor(tree["a"]),
                "b": {"c": torch.tensor(tree["b"]["c"]),
                      "d": Stacked(torch.tensor(x) for x in tree["b"]["d"])}}

    p0 = draw()
    params, jparams = port(p0), jax.tree.map(jnp.asarray, p0)
    state, jstate = optimizer.init_state(params), jopt.init_state(jparams)
    assert state["step"].dtype == torch.int32
    a0, m_d0 = params["a"], state["m"]["b"]["d"][0]
    for _ in range(3):
        g = draw(scale=10.0)
        params, state, m = optimizer.apply_updates(params, port(g), state, cfg)
        jparams, jstate, jm = jopt.apply_updates(jparams, jax.tree.map(jnp.asarray, g),
                                                 jstate, jcfg)
        assert rel(m["grad_norm"], jm["grad_norm"]) <= OPT_RTOL
        assert rel(m["lr"], jm["lr"]) <= OPT_RTOL
        assert int(state["step"]) == int(jstate["step"])
        for got, want in ((params, jparams), (state["m"], jstate["m"]),
                          (state["v"], jstate["v"])):
            got, want = port_leaves(got), repro_leaves(want)
            for name in want:
                np.testing.assert_allclose(got[name], want[name], rtol=OPT_RTOL,
                                           atol=OPT_RTOL * np.abs(want[name]).max())
    # the port's in-place update hands back the same tensors
    assert params["a"] is a0 and state["m"]["b"]["d"][0] is m_d0


def test_grad_clipping_as_repro():
    p, g = {"w": torch.ones(4)}, {"w": torch.full((4,), 100.0)}
    _, _, m = optimizer.apply_updates(p, g, optimizer.init_state(p),
                                      optimizer.OptimizerConfig(**OPT))
    assert float(m["grad_norm"]) == pytest.approx(200.0)


# --------------------------------------------------------- loss and gradients
J_VG = {}


def repro_value_and_grad(jcfg):
    if jcfg not in J_VG:
        J_VG[jcfg] = jax.jit(jax.value_and_grad(
            lambda p, b: jt.loss_fn(p, b, jcfg), has_aux=True))
    return J_VG[jcfg]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_every_gradient_match_repro(arch):
    jcfg, cfg = reduced(arch)
    jparams, model = carried(jcfg)
    tb, jb = batch_of(cfg)
    (jloss, jaux), jgrads = repro_value_and_grad(jcfg)(jparams, jb)
    loss, aux, grads = train_loop.value_and_grad(
        lambda p, b: tt.loss_fn(model, b), tt.param_tree(model), tb)
    assert rel(loss, jloss) <= GRAD_TOL
    for k in ("ce", "aux"):
        assert abs(float(aux[k]) - float(jaux[k])) <= GRAD_TOL * max(abs(float(jaux[k])), 1)
    assert_leaves_close(port_leaves(grads), repro_leaves(jgrads))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b", "minicpm3-4b"])
def test_remat_gives_bit_equal_gradients(arch):
    _, cfg = reduced(arch)
    model = tt.init_params(cfg, "cpu", torch.Generator().manual_seed(0)).requires_grad_(True)
    tb, _ = batch_of(cfg)
    out = []
    for remat in (False, True):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        out.append(train_loop.value_and_grad(lambda p, b: tt.loss_fn(model, b),
                                             tt.param_tree(model), tb))
    (l0, _, g0), (l1, _, g1) = out
    assert torch.equal(l0, l1)
    g0, g1 = port_leaves(g0), port_leaves(g1)
    for name in g0:
        np.testing.assert_array_equal(g0[name], g1[name], err_msg=name)


def test_remat_recomputes_in_the_backward():
    """With remat a block keeps only its inputs for the backward: fewer
    tensors saved than without it."""
    _, cfg = reduced("llama3.2-1b")
    model = tt.init_params(cfg, "cpu", torch.Generator().manual_seed(0)).requires_grad_(True)
    tb, _ = batch_of(cfg)
    saved = []
    for remat in (False, True):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        n = [0]

        def pack(t):
            n[0] += 1
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tt.loss_fn(model, tb)
        saved.append(n[0])
    assert saved[1] < saved[0] / 2, saved


def test_accumulation_matches_full_batch_and_repro():
    jcfg, cfg = reduced("llama3.2-1b")
    tb, jb = batch_of(cfg)
    opt = optimizer.OptimizerConfig(**OPT)
    jo = jopt.OptimizerConfig(**OPT)
    _, model = carried(jcfg)
    _, _, full = train_loop.value_and_grad(lambda p, b: tt.loss_fn(model, b),
                                           tt.param_tree(model), tb)
    # n_micro = 2 of a dense arch: the microbatches' mean gradient is the
    # full batch's; the first update's moment m is 0.1 of it, clipped
    for name in ("make_train_step_accum", "make_train_step_accum_unrolled"):
        jparams, model = carried(jcfg)
        params = tt.param_tree(model)
        step = getattr(train_loop, name)(lambda p, b: tt.loss_fn(model, b), opt, 2)
        params, state, m = step(params, optimizer.init_state(params), tb)
        jstep = jax.jit(getattr(jloop, name)(lambda p, b: jt.loss_fn(p, b, jcfg), jo, 2))
        jparams, jstate, jm = jstep(jparams, jopt.init_state(jparams), jb)
        assert rel(m["loss"], jm["loss"]) <= GRAD_TOL
        assert rel(m["grad_norm"], jm["grad_norm"]) <= GRAD_TOL
        assert_leaves_close(port_leaves(state["m"]), repro_leaves(jstate["m"]))
        clip = min(1.0, opt.grad_clip / float(m["grad_norm"]))
        assert_leaves_close({k: v * 10 / clip for k, v in port_leaves(state["m"]).items()},
                            port_leaves(full))
        update_tol(float(m["lr"]))(port_leaves(params), repro_leaves(jparams))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b"])
def test_ten_step_trajectories_match_repro(arch):
    jcfg, cfg = reduced(arch)
    jparams, model = carried(jcfg)
    params = tt.param_tree(model)
    state = optimizer.init_state(params)
    step = train_loop.make_train_step(lambda p, b: tt.loss_fn(model, b),
                                      optimizer.OptimizerConfig(**OPT))
    # repro's make_train_step is value_and_grad, then apply_updates: built
    # here of the gradient program the test above compiled
    jupdate = jax.jit(partial(jopt.apply_updates, cfg=jopt.OptimizerConfig(**OPT)))

    def jstep(p, o, b):
        (loss, aux), grads = repro_value_and_grad(jcfg)(p, b)
        p, o, om = jupdate(p, grads, o)
        return p, o, {"loss": loss, **om}
    jstate = jopt.init_state(jparams)
    losses, jlosses = [], []
    for i in range(10):
        tb, jb = batch_of(cfg, step=i % 3)
        params, state, m = step(params, state, tb)
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=TRAJ_RTOL)
    assert losses[-1] < losses[0]


# ---------------------------------------------------------- loader and shapes
def test_loader_batches_equal_repro():
    rng = np.random.default_rng(5)
    stream = rng.integers(1, 300, 5_000).astype(np.int32)
    for step in (0, 1, 7, 1_000):
        a = loader.LMBatchLoader(stream, 32, 6, seed=3).batch_at(step)
        b = jloader.LMBatchLoader(stream, 32, 6, seed=3).batch_at(step)
        c = loader.SyntheticLMLoader(512, 16, 4, seed=2).batch_at(step)
        d = jloader.SyntheticLMLoader(512, 16, 4, seed=2).batch_at(step)
        for x, y in ((a, b), (c, d)):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype == np.int32
                np.testing.assert_array_equal(x[k], y[k])
    it = iter(loader.LMBatchLoader(stream, 8, 2))
    np.testing.assert_array_equal(next(it)["tokens"],
                                  jloader.LMBatchLoader(stream, 8, 2).batch_at(0)["tokens"])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_eval_shape_state_matches_repro_at_full_size(arch):
    """Shapes and dtypes of the full config's params and optimizer state,
    allocating nothing (meta tensors; ``jax.eval_shape``)."""
    jcfg, cfg = jconfigs.get(arch).make(), configs.get(arch).make()
    opt = optimizer.OptimizerConfig()
    params, state = train_loop.eval_shape_state(
        lambda: tt.param_tree(tt.init_params(cfg, "meta")), opt)
    jparams, jstate = jloop.eval_shape_state(
        lambda: jt.init_params(jax.random.PRNGKey(0), jcfg), jopt.OptimizerConfig())
    got = {n: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for n, v in named_leaves({"params": params, "opt": state})}
    want = {n: (tuple(v.shape), str(v.dtype))
            for n, v in jckpt._leaf_paths({"params": jparams, "opt": jstate})}
    assert got == want
    with pytest.raises(ValueError, match="meta device"):
        train_loop.eval_shape_state(lambda: {"w": torch.zeros(2)}, opt)


# --------------------------------------------- repro's own training tests
def tiny_state(seed=0):
    cfg = port_cfg(jax_tiny())
    model = tt.init_params(cfg, "cpu", torch.Generator().manual_seed(seed))
    model.requires_grad_(True)
    params = tt.param_tree(model)
    return model, {"params": params, "opt": optimizer.init_state(params)}


def tiny_batch(step=0):
    return batch_of(port_cfg(jax_tiny()), step)[0]


def test_loss_decreases_tiny():
    model, state = tiny_state()
    step = train_loop.make_train_step(lambda p, b: tt.loss_fn(model, b),
                                      optimizer.OptimizerConfig(**OPT))
    params, opt = state["params"], state["opt"]
    losses = []
    for i in range(25):
        params, opt, m = step(params, opt, tiny_batch(i % 3))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_checkpoint_roundtrip_and_atomicity():
    _, state = tiny_state()
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, async_save=False)
        ck.save(3, state, extras={"next_step": 3})
        assert ck.latest_step() == 3
        _, target = tiny_state(seed=1)
        restored, extras = ck.restore(3, target)
        assert extras["next_step"] == 3
        got, want = port_leaves(restored), port_leaves(state)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
        # restored in place into the target's tensors
        assert restored["params"]["embed"] is target["params"]["embed"]
        # no stray temp dirs after commit
        assert not [p for p in os.listdir(d) if p.startswith(".tmp")]
        kinds = [e["kind"] for e in ck.events]
        assert kinds == ["save", "restore"] and ck.events[0]["bytes"] > 0


def test_checkpoint_gc_keeps_latest():
    _, state = tiny_state()
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=2, async_save=False)
        for s in (1, 2, 3, 4):
            ck.save(s, {"p": state["params"]["final_norm"]})
        assert sorted(ck.all_steps()) == [3, 4]


def test_async_save_copies_before_training_goes_on():
    _, state = tiny_state()
    want = port_leaves(state)
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        ck.save(1, state)
        with torch.no_grad():
            state["params"]["embed"].add_(1.0)     # training goes on in place
        ck.wait()
        restored, _ = ck.restore(1, tiny_state(seed=2)[1])
        np.testing.assert_array_equal(port_leaves(restored)["params/embed"],
                                      want["params/embed"])


def recovery_run(d, injector=None, n_steps=20):
    model, state = tiny_state()
    step = train_loop.make_train_step(lambda p, b: tt.loss_fn(model, b),
                                      optimizer.OptimizerConfig(**OPT))

    def sfn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    return run_with_recovery(
        n_steps=n_steps, step_fn=sfn, state=state, batch_fn=tiny_batch,
        ckpt=CheckpointManager(d, async_save=False), ckpt_every=5, injector=injector)


def test_recovery_bit_determinism():
    with tempfile.TemporaryDirectory() as d:
        a, _, r_a = recovery_run(d + "/a", FailureInjector({7, 13}))
        b, _, r_b = recovery_run(d + "/b")
    assert r_a == 2 and r_b == 0
    got, want = port_leaves(a), port_leaves(b)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_recovery_right_after_an_async_save_restores_it(monkeypatch):
    """A failure while an asynchronous save is still being written: the
    recovery waits for it to commit and restores it (``repro``'s reads
    ``LATEST`` without waiting and replays from step 0 on the state it
    has); the run ends bit-equal to an uninterrupted one."""
    import time as time_mod

    from repro_torch.training import checkpoint as ckpt_mod
    real = ckpt_mod._save_leaf

    def slow(path, arr, dtype):
        time_mod.sleep(0.01)
        real(path, arr, dtype)
    monkeypatch.setattr(ckpt_mod, "_save_leaf", slow)
    model, state = tiny_state()
    step = train_loop.make_train_step(lambda p, b: tt.loss_fn(model, b),
                                      optimizer.OptimizerConfig(**OPT))

    def sfn(state, batch):
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        a, hist, retries = run_with_recovery(
            n_steps=8, step_fn=sfn, state=state, batch_fn=tiny_batch, ckpt=ck,
            ckpt_every=5, injector=FailureInjector({5}))
        assert [e["kind"] for e in ck.events] == ["save", "restore"]
        assert retries == 1 and len(hist) == 8
        with tempfile.TemporaryDirectory() as d2:
            b, _, _ = recovery_run(d2, n_steps=8)
    got, want = port_leaves(a), port_leaves(b)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_straggler_detector():
    det = StragglerDetector(alpha=0.5, threshold=2.0)
    for _ in range(5):
        det.observe(0, 0.1)
    assert det.observe(6, 1.0)          # 10x slower -> flagged
    assert len(det.events) == 1


def test_failure_exhaustion_raises():
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError):
            run_with_recovery(
                n_steps=5,
                step_fn=lambda s, b: (_ for _ in ()).throw(RuntimeError("boom")),
                state={}, batch_fn=lambda s: None,
                ckpt=CheckpointManager(d, async_save=False), max_retries=2)


def test_elastic_remesh_restores_onto_the_mesh_device():
    """``make_mesh_fn`` returns the new ``DataMesh``; the latest checkpoint
    comes back onto its device and the step is made for that mesh."""
    from repro_torch.launch.mesh import DataMesh
    from repro_torch.training.fault_tolerance import elastic_remesh
    _, state = tiny_state()
    target = tiny_state(seed=1)[1]
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, async_save=False)
        ck.save(2, state)
        mesh = DataMesh(rank=0, size=1, device=torch.device("cpu"), backend="gloo")
        step, restored, got_mesh = elastic_remesh(
            lambda m: ("step on", m.size), lambda: mesh, target, ck)
    assert step == ("step on", 1) and got_mesh is mesh
    got, want = port_leaves(restored), port_leaves(state)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    # new tensors on the mesh's device, not the target's written in place
    assert restored["params"]["embed"] is not target["params"]["embed"]


# --------------------------------------------------- checkpoints across packages
def test_repro_checkpoint_restores_in_the_port_and_back():
    model, _ = tiny_state()
    jparams = jax.tree.map(jnp.asarray, tt.params_to_numpy(model))
    # a state as after a few steps: moments of both signs, step 3
    jstate = {"params": jparams, "opt": {
        "m": jax.tree.map(lambda p: p * -0.5, jparams),
        "v": jax.tree.map(jnp.square, jparams), "step": jnp.int32(3)}}
    params = tt.param_tree(model)
    target = {"params": params, "opt": optimizer.init_state(params)}
    with tempfile.TemporaryDirectory() as d:
        jckpt.CheckpointManager(d + "/j", async_save=False).save(
            4, jstate, extras={"next_step": 4})
        restored, extras = CheckpointManager(d + "/j").restore(4, target)
        assert extras == {"next_step": 4}
        got, want = port_leaves(restored), repro_leaves(jstate)
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert restored["opt"]["step"].dtype == torch.int32
        # the model computes with what was restored
        back_np = tt.params_to_numpy(model)
        for name, v in repro_leaves(jparams).items():
            np.testing.assert_array_equal(dict(jckpt._leaf_paths(back_np))[name], v)
        # and back: the port writes, repro restores the same bits
        CheckpointManager(d + "/t", async_save=False).save(5, restored)
        back, _ = jckpt.CheckpointManager(d + "/t").restore(5, jstate)
        for name, v in repro_leaves(back).items():
            np.testing.assert_array_equal(v, want[name], err_msg=name)
        for f in sorted(os.listdir(d + "/j/step_00000004")):
            assert os.path.exists(f"{d}/t/step_00000005/{f}"), f


def test_repro_bf16_checkpoint_restores_bit_exact():
    """``repro`` writes a bf16 leaf as '<V2' bytes that its own restore
    cannot cast back; the port views the bits as bfloat16."""
    w = jnp.arange(-3, 9, dtype=jnp.bfloat16).reshape(3, 4) / 7
    with tempfile.TemporaryDirectory() as d:
        jckpt.CheckpointManager(d + "/j", async_save=False).save(1, {"w": w, "n": jnp.ones(2)})
        restored, _ = CheckpointManager(d + "/j").restore(
            1, {"w": torch.zeros(3, 4, dtype=torch.bfloat16), "n": torch.zeros(2)})
        assert restored["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(restored["w"].view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
        # a meta target gets a new tensor of the checkpoint's dtype
        fresh, _ = CheckpointManager(d + "/j").restore(
            1, {"w": torch.empty(3, 4, device="meta"), "n": torch.empty(2, device="meta")},
            device="cpu")
        assert torch.equal(fresh["w"], restored["w"])
        # the port writes the same bytes and the same manifest dtype
        CheckpointManager(d + "/t", async_save=False).save(1, restored)
        for f in ("w.s0.npy", "n.s0.npy"):
            with open(f"{d}/j/step_00000001/{f}", "rb") as a, \
                    open(f"{d}/t/step_00000001/{f}", "rb") as b:
                assert a.read() == b.read(), f


# ------------------------------------------------------------------ compression
def test_compressed_psum_on_three_gloo_ranks():
    rng = np.random.default_rng(0)
    n, n_seeds = 3, 40
    g = rng.standard_normal((n, 256)).astype(np.float32)
    g[:, 0] = 4.0              # one max |g| on every rank: a common scale
    outs = spawn_ranks(n, psum_rank, g, n_seeds, device="cpu")
    for r in range(1, n):      # every rank holds the same result
        for k in outs[0]:
            np.testing.assert_array_equal(np.stack(outs[r][k]), np.stack(outs[0][k]))
    true, step = g.mean(0), 4.0 / 127
    for k in ("exact", "max"):
        runs = np.stack(outs[0][k])
        # each rank's stochastic rounding errs by under one step
        assert np.abs(runs - true).max() < step + 1e-6, k
        # unbiased: the mean over seeds nears the exact mean
        assert np.abs(runs.mean(0) - true).max() < 3 * step / np.sqrt(n_seeds), k


# -------------------------------------------------------------------------- CLI
def test_train_cli_reduced_on_cpu_loss_falls():
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(out):
        ltrain.main(["--reduced", "--steps", "20", "--device", "cpu",
                     "--ckpt-dir", d, "--ckpt-every", "8", "--log-every", "5"])
        assert sorted(os.listdir(d)) == ["LATEST", "step_00000008", "step_00000016"]
    lines = out.getvalue().splitlines()
    assert lines[0] == "arch=llama3.2-1b-smoke params=0.1M steps=20"
    steps = [re.fullmatch(r"  step +(\d+)  loss (\d+\.\d{4})", ln) for ln in lines[1:5]]
    assert [int(m[1]) for m in steps] == [0, 5, 10, 15]
    final = re.fullmatch(r"final loss (\d+\.\d{4}) \(from (\d+\.\d{4})\); [0-9.]+s, "
                         r"0 restarts, \d+ stragglers", lines[5])
    assert final and float(final[1]) < float(final[2]) == float(steps[0][2])


def test_train_cli_refuses_non_lm_archs():
    with pytest.raises(SystemExit, match="drives LM archs"):
        ltrain.main(["--arch", "gin-tu", "--device", "cpu"])
