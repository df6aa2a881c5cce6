"""The port's sharded MoE on a (data, model) grid of gloo ranks against
``repro``'s ``moe_ffn_sharded`` on a host mesh, on the CPU.

One spawn of 8 ranks (``torch_moe_ranks.sharded_rank``, a 2 x 4 grid) and
one ``repro`` process with 8 XLA host devices (a 2 x 4 ``("data",
"model")`` mesh) run side by side on the same numpy inputs:

  * the MoE of ``repro``'s ``test_moe_sharded_matches_local`` (d 16, d_ff
    32, top-2) with 8 experts and 4 experts + 2 shared (EP: each model rank
    owns E / 4 experts) and 2 experts (ffTP: every rank holds every expert at
    d_ff / 4), each at capacity factor E (no claim drops) and 1.25;
  * each MoE arch's REDUCED transformer with ``moe.mesh`` set, through
    ``loss_fn``;
  * the grid's shape and its groups' members, and the 1-D fallback.

Tolerance: a value and every gradient leaf within 1e-4 of the leaf's max abs
(``TOL``): float32 sums in another order (gloo's all-reduce, XLA's psum).
Each rank's y is its data row's; the one-device references run
``moe_ffn(dispatch="sort")`` and ``loss_fn`` row by row, since each row
sizes its capacity on its own tokens (at 1.25 claims drop per row).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

from repro_torch import configs
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.training import train_loop
from repro_torch.training.tree import Stacked, map_leaves, named_leaves
from torch_moe_ranks import GRID_MODELS, MODEL, moe_cfg, sharded_rank

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
N_RANKS = 8
ROWS = N_RANKS // MODEL
MOE_CASES = [(8, 0, 8.0), (4, 2, 4.0), (2, 0, 2.0), (8, 0, 1.25), (4, 2, 1.25), (2, 0, 1.25)]
MOE_IDS = [f"E{e}-shared{s}-cf{cf}" for e, s, cf in MOE_CASES]
LM_ARCHS = ["mixtral-8x7b", "deepseek-moe-16b"]
D_MODEL = 16

REPRO_SCRIPT = """
import dataclasses, pickle, sys
import numpy as np
import repro                                  # JAX shims before make_mesh
import jax, jax.numpy as jnp
import repro.configs as jconfigs
from repro.models import moe as jm, transformer as jt

IN, OUT = sys.argv[1:3]
inp = pickle.load(open(IN, "rb"))
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
x = jnp.asarray(inp["x"])
out = {"moe": [], "lm": []}
for (ne, ns, cf), params in zip(inp["moe_cases"], inp["moe_params"]):
    cfg = jm.MoEConfig(ne, 2, 32, n_shared=ns, d_ff_shared=24, capacity_factor=cf,
                       mesh=mesh, dp_axes="data")

    def f(p, xx, with_aux):
        y, aux = jm.moe_ffn_sharded(xx, p, cfg)
        return jnp.sum(y * y) + (aux if with_aux else 0.0), (y, aux)

    with mesh:
        (_, (y, aux)), g = jax.jit(jax.value_and_grad(
            lambda p, xx: f(p, xx, True), argnums=(0, 1), has_aux=True))(params, x)
        g0 = jax.jit(jax.grad(lambda p, xx: f(p, xx, False)[0], argnums=(0, 1)))(params, x)
    out["moe"].append({"y": np.asarray(y), "aux": float(aux),
                       "grads": {**jax.tree.map(np.asarray, g[0]), "x": np.asarray(g[1])},
                       "grads_yy": {**jax.tree.map(np.asarray, g0[0]), "x": np.asarray(g0[1])}})
for arch, tree, batch in inp["lm"]:
    jcfg = jconfigs.get(arch).make_reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, mesh=mesh,
                                                             dp_axes="data"))
    with mesh:
        (loss, metrics), g = jax.jit(jax.value_and_grad(
            lambda p, b: jt.loss_fn(p, b, jcfg), has_aux=True))(tree, batch)
    out["lm"].append({"loss": float(loss), "ce": float(metrics["ce"]),
                      "aux": float(metrics["aux"]), "grads": jax.tree.map(np.asarray, g)})
pickle.dump(out, open(OUT, "wb"))
"""


def err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def moe_inputs():
    rng = np.random.default_rng(0)
    params = []
    for e, s, _ in MOE_CASES:
        drawn = tm.init_moe_params(D_MODEL, moe_cfg(e, s, 1.0), torch.float32,
                                   lambda shape, dtype: torch.from_numpy(
                                       rng.standard_normal(shape).astype(np.float32)))
        params.append({k: v.numpy() for k, v in drawn.items()})
    return params, rng.standard_normal((4, 8, D_MODEL)).astype(np.float32)


def lm_inputs():
    out = []
    for i, arch in enumerate(LM_ARCHS):
        cfg = configs.get(arch).make_reduced()
        model = tt.init_params(cfg, "cpu", torch.Generator().manual_seed(i))
        tokens = np.random.default_rng(10 + i).integers(0, cfg.vocab_size, (4, 8))
        out.append((arch, tt.params_to_numpy(model),
                    {"tokens": tokens.astype(np.int32),
                     "labels": np.roll(tokens, -1, axis=1).astype(np.int32)}))
    return out


@pytest.fixture(scope="module")
def runs():
    """The port's 8 ranks and ``repro``'s 8-device process, side by side."""
    moe_params, x = moe_inputs()
    lm = lm_inputs()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_RANKS}")
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = Path(tmp) / "in.pkl", Path(tmp) / "out.pkl"
        inp.write_bytes(pickle.dumps({"moe_cases": MOE_CASES, "moe_params": moe_params,
                                      "x": x, "lm": lm}))
        proc = subprocess.Popen([sys.executable, "-c", REPRO_SCRIPT, str(inp), str(out)],
                                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            ranks = spawn_ranks(N_RANKS, sharded_rank, MOE_CASES, moe_params, x,
                                lm, device="cpu")
            _, stderr = proc.communicate(timeout=400)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, stderr[-3000:]
        repro = pickle.loads(out.read_bytes())
    return {"ranks": ranks, "repro": repro, "moe_params": moe_params, "x": x, "lm": lm}


def place(rank: int) -> tuple[int, int]:
    """(data row, model index) of world rank ``rank``."""
    return divmod(rank, MODEL)


def part(name, leaf, cfg, m):
    return tm.shard_leaf(name, leaf, cfg, MODEL, m) if name != "x" else leaf


# ------------------------------------------------------------------- grid
def test_grid_shape_groups_and_the_1d_fallback(runs):
    for rank, out in enumerate(runs["ranks"]):
        for model, got in zip(GRID_MODELS, out["grid"]):
            if model <= 1 or N_RANKS % model:
                assert got == ("1-D", True, {"data": N_RANKS}), (model, got)
                continue
            i, m = divmod(rank, model)
            assert got == ({"data": N_RANKS // model, "model": model}, N_RANKS, i, m,
                           list(range(i * model, (i + 1) * model)),
                           list(range(m, N_RANKS, model))), (model, got)
    assert all(out["comm_bytes"] > 0 for out in runs["ranks"])


# -------------------------------------------------------------------- MoE
def one_device_rows(params, x, case, with_aux: bool):
    """``moe_ffn(dispatch="sort")`` with the whole weights, row by row: y,
    the rows' mean aux, and the gradient of sum(y * y) (+ that aux)."""
    cfg = moe_cfg(*case)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    xx = torch.from_numpy(x).requires_grad_(True)
    ys, auxes = zip(*[tm.moe_ffn(r, p, cfg) for r in xx.chunk(ROWS)])
    y, aux = torch.cat(ys), torch.stack(auxes).mean()
    loss = (y * y).sum() + (aux if with_aux else 0.0)
    grads = torch.autograd.grad(loss, [*p.values(), xx])
    return y.detach().numpy(), float(aux.detach()), {k: g.numpy() for k, g in zip([*p, "x"], grads)}


def assert_rank_grads(got: dict, want: dict, case, rank: int):
    i, m = place(rank)
    cfg = moe_cfg(*case, mesh=None)
    b = want["x"].shape[0] // ROWS
    for k, g in got.items():
        w = part(k, want[k], cfg, m)
        if k == "x":
            w = w[i * b:(i + 1) * b]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert err(g, w) <= TOL, (k, rank, err(g, w))


@pytest.mark.parametrize("c", range(len(MOE_CASES)), ids=MOE_IDS)
def test_moe_y_and_aux_equal_repro_and_one_device_rows(runs, c):
    """Each rank's y is its row's block of ``repro``'s y and of the
    one-device sort path's on that row; aux is ``repro``'s ``pmean``, the
    mean of the rows' auxes."""
    want = runs["repro"]["moe"][c]
    y1, aux1, _ = one_device_rows(runs["moe_params"][c], runs["x"], MOE_CASES[c], True)
    b = want["y"].shape[0] // ROWS
    for rank, out in enumerate(runs["ranks"]):
        i, _ = place(rank)
        got = out["moe"][c]
        assert err(got["y"], want["y"][i * b:(i + 1) * b]) <= TOL
        assert err(got["y"], y1[i * b:(i + 1) * b]) <= TOL
        assert err(got["aux"], want["aux"]) <= TOL and err(got["aux"], aux1) <= TOL


@pytest.mark.parametrize("c", range(len(MOE_CASES)), ids=MOE_IDS)
def test_moe_gradients_with_aux_equal_repro(runs, c):
    """The gradient of sum(y * y) + aux in each rank's part equals
    ``jax.grad`` through ``repro``'s ``moe_ffn_sharded``, and the
    one-device rows' (whose aux is the rows' mean, ``repro``'s ``pmean``)."""
    _, _, one = one_device_rows(runs["moe_params"][c], runs["x"], MOE_CASES[c], True)
    for rank, out in enumerate(runs["ranks"]):
        assert_rank_grads(out["moe"][c]["grads"], runs["repro"]["moe"][c]["grads"],
                          MOE_CASES[c], rank)
        assert_rank_grads(out["moe"][c]["grads"], one, MOE_CASES[c], rank)


@pytest.mark.parametrize("c", range(len(MOE_CASES)), ids=MOE_IDS)
def test_moe_gradients_of_sum_y2_equal_one_device_rows_and_repro(runs, c):
    _, _, one = one_device_rows(runs["moe_params"][c], runs["x"], MOE_CASES[c], False)
    for rank, out in enumerate(runs["ranks"]):
        assert_rank_grads(out["moe"][c]["grads_yy"], one, MOE_CASES[c], rank)
        assert_rank_grads(out["moe"][c]["grads_yy"], runs["repro"]["moe"][c]["grads_yy"],
                          MOE_CASES[c], rank)


def test_capacity_e_keeps_every_claim_and_125_drops_some():
    """At capacity factor E no claim drops; over the 1.25 cases some do, so
    the comparisons above cover the dropped claims too.  8 and 4 experts
    split over the 4 model ranks (EP), 2 do not (ffTP)."""
    params, x = moe_inputs()
    dropped_125 = 0
    for (e, s, cf), p in zip(MOE_CASES, params):
        cfg = moe_cfg(e, s, cf)
        assert tm.expert_parallel(cfg, MODEL) == (e % MODEL == 0)
        dropped = 0
        for row in torch.from_numpy(x).reshape(ROWS, -1, D_MODEL):
            ids, _, _ = tm.router_topk(row, torch.from_numpy(p["router"]), cfg)
            dropped += int((tm.claim_positions(ids, e) >= cfg.capacity(row.shape[0])).sum())
        if cf == e:
            assert dropped == 0, (e, s, cf, dropped)
        else:
            dropped_125 += dropped
    assert dropped_125 > 0


# ------------------------------------------------------------- transformer
def lm_cfg(arch: str):
    return configs.get(arch).make_reduced()


def one_device_lm_rows(arch, tree, batch):
    """The port's one-device model, row by row: the mean loss and the mean
    gradient of the rows' losses."""
    model = tt.params_from_numpy(tree, lm_cfg(arch), device="cpu").requires_grad_(True)
    losses, grads = [], []
    for i in range(ROWS):
        b = {k: torch.from_numpy(v[i * 2:(i + 1) * 2]) for k, v in batch.items()}
        loss, _, g = train_loop.value_and_grad(lambda p, x: tt.loss_fn(model, x),
                                               tt.param_tree(model), b)
        losses.append(float(loss))
        grads.append(map_leaves(lambda t: (torch.stack(tuple(t)) if isinstance(t, Stacked)
                                           else t).numpy(), g))
    leaves = [dict(named_leaves(g)) for g in grads]
    return float(np.mean(losses)), {n: np.mean([lv[n] for lv in leaves], axis=0)
                                    for n in leaves[0]}


@pytest.mark.parametrize("a", range(len(LM_ARCHS)), ids=LM_ARCHS)
def test_transformer_on_the_grid_equals_repro_and_one_device_rows(runs, a):
    """``loss_fn`` with ``cfg.moe.mesh`` on the 2 x 4 grid: the loss, its ce
    and aux, and every gradient leaf of each rank's parameters (the MoE
    leaves its part) equal ``repro``'s ``loss_fn`` with ``moe.mesh`` on the
    host mesh, and the port's one-device model run row by row."""
    arch, tree, batch = runs["lm"][a]
    want = runs["repro"]["lm"][a]
    one_loss, one_grads = one_device_lm_rows(arch, tree, batch)
    assert err(one_loss, want["loss"]) <= TOL
    jgrads = dict(named_leaves(want["grads"]))
    moe = lm_cfg(arch).moe
    for rank, out in enumerate(runs["ranks"]):
        _, m = place(rank)
        got = out["lm"][a]
        assert err(got["loss"], want["loss"]) <= TOL and err(got["ce"], want["ce"]) <= TOL
        assert err(got["aux"], want["aux"]) <= TOL
        for name, g in named_leaves(got["grads"]):
            leaf = name.rsplit("/", 1)[-1]
            for ref in (jgrads[name], one_grads[name]):
                w = ref
                if "/ffn/" in name:
                    w = np.stack([tm.shard_leaf(leaf, r, moe, MODEL, m) for r in ref])
                assert g.shape == w.shape, (name, g.shape, w.shape)
                assert err(g, w) <= TOL, (arch, rank, name, err(g, w))


def test_moe_config_carries_repros_mesh_fields():
    names = [f.name for f in dataclasses.fields(tm.MoEConfig)]
    assert names[-3:] == ["mesh", "dp_axes", "tp_axis"]
    assert tm.MoEConfig(4, 2, 8).tp_axis == "model"
    with pytest.raises(ValueError, match="does not split"):
        tm.shard_leaf("wg", np.zeros((2, 4, 6)), tm.MoEConfig(2, 2, 6), 4, 0)
