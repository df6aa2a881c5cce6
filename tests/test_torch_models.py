"""The port's LM stack against ``repro``'s on the CPU, in float32.

Inputs come from a numpy seed; model weights come from ``repro``'s
``init_params`` and cross over through ``params_from_numpy``, so both
packages compute the same function (the MoE-level cases draw their experts
from the numpy seed, in the layout both packages share).  Every
floating-point output is held to ``rtol = atol = 1e-4``: both sides compute
in float32 with the same dtype steps, and what differs is the order of the
sums inside each matmul and softmax (about 1e-6 relative here), so 1e-4
leaves room for that and for nothing a wrong cache slot, mask or head
mapping would give.  Integer outputs (expert ids, dispatch slots, claim
places) are equal.

Covered: every function of ``models/layers.py`` (``window`` and
``q_chunk > 0`` too); the MoE router, capacity, both dispatches and
``moe_ffn`` with shared experts and with a capacity factor low enough that
claims drop; each of the five ``REDUCED`` archs through ``forward``,
``loss_fn``, ``prefill`` (cache and logits) and 6 decode steps (mixtral's
window of 8 wraps the ring, minicpm3's decode is MLA's absorbed form); GQA
and MLA with padded heads; the registry field by field; and
``python -m repro_torch.launch.serve``.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
import repro.launch.serve as jserve
from repro.models import layers as jl, moe as jm, transformer as jt
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.launch import serve
from repro_torch.models import layers as tl, moe as tm, transformer as tt

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads would only take cores from the other
# workers' tests.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RTOL = ATOL = 1e-4
LM_ARCHS = ["llama3.2-1b", "mixtral-8x7b", "deepseek-moe-16b", "minicpm3-4b",
            "phi3-medium-14b"]
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def port_moe(jcfg) -> tm.MoEConfig:
    names = [f.name for f in dataclasses.fields(tm.MoEConfig)]
    return tm.MoEConfig(**{n: getattr(jcfg, n) for n in names})


def port_cfg(jcfg) -> tt.LMConfig:
    """``repro``'s LMConfig as the port's (mesh-only fields left out)."""
    attn = tt.AttentionConfig(**dataclasses.asdict(jcfg.attn))
    names = [f.name for f in dataclasses.fields(tt.LMConfig)
             if f.name not in ("attn", "moe", "dtype")]
    return tt.LMConfig(attn=attn, moe=port_moe(jcfg.moe) if jcfg.moe else None,
                       dtype=DTYPES[jcfg.dtype],
                       **{n: getattr(jcfg, n) for n in names})


# repro's entry points, compiled once per config (eager JAX would retrace
# each layer scan on every call)
J_INIT = jax.jit(jt.init_params, static_argnums=1)
J_PREFILL = jax.jit(jt.prefill, static_argnums=(2, 3))
J_DECODE = jax.jit(jt.decode_step, static_argnums=4)
J_MOE = jax.jit(jm.moe_ffn, static_argnums=2)


@partial(jax.jit, static_argnums=(2, 3))
def j_forward_loss_prefill(params, batch, cfg, max_seq):
    """``forward``, ``loss_fn`` and ``prefill`` of one batch in one program."""
    return (jt.forward(params, batch["tokens"], cfg), jt.loss_fn(params, batch, cfg),
            jt.prefill(params, batch["tokens"], cfg, max_seq))


def jax_model(jcfg, seed: int = 0):
    params = J_INIT(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return params, tt.params_from_numpy(tree, port_cfg(jcfg), device="cpu")


# ------------------------------------------------------------------ layers.py
def test_rms_norm_and_rope_match_repro():
    rng = np.random.default_rng(0)
    x, scale = rand(rng, 2, 5, 32), rand(rng, 32)
    close(tl.rms_norm(t(x), t(scale), 1e-5), jl.rms_norm(x, scale, 1e-5))
    assert tl.NEG_INF == jl.NEG_INF == -1e30
    for d, theta in ((16, 10_000.0), (64, 500_000.0)):
        close(tl.rope_freqs(d, theta), jl.rope_freqs(d, theta))
    # [B, S, H, d]; and [B, 1, d] at one position, as MLA's decode ropes its
    # shared key
    for shape, pos in (((2, 5, 4, 16), np.arange(3, 8)), ((2, 1, 8), np.asarray([9]))):
        x, pos = rand(rng, *shape), pos.astype(np.int32)
        close(tl.apply_rope(t(x), t(pos), 1000.0), jl.apply_rope(x, pos, 1000.0))


@pytest.mark.parametrize("window", [None, 3])
def test_mask_matches_repro(window):
    q, k = np.arange(4, 10), np.arange(10)
    np.testing.assert_array_equal(tl._mask(t(q), t(k), window).numpy(),
                                  np.asarray(jl._mask(q, k, window)))


@pytest.mark.parametrize("window,q_chunk", [(None, 0), (None, 4), (5, 0), (5, 4)])
@pytest.mark.parametrize("h,kv,dv", [(4, 4, 16), (4, 2, 16), (6, 2, 8)])
def test_gqa_attention_matches_repro(window, q_chunk, h, kv, dv):
    rng = np.random.default_rng(h * 10 + kv + dv)
    b, s, d = 2, 12, 16
    q, k, v = rand(rng, b, s, h, d), rand(rng, b, s, kv, d), rand(rng, b, s, kv, dv)
    pos = np.arange(s, dtype=np.int32)
    got = tl.gqa_attention(t(q), t(k), t(v), q_positions=t(pos), k_positions=t(pos),
                           window=window, q_chunk=q_chunk)
    want = jl.gqa_attention(q, k, v, q_positions=pos, k_positions=pos,
                            window=window, q_chunk=q_chunk)
    assert got.shape == (b, s, h, dv)
    close(got, want)


def test_gqa_head_mapping_is_repeat_interleave():
    """Head h reads kv head h // g: with one kv head of zeros and one of
    ones as values, the first half of the heads reads 0 and the second 1."""
    b, s, h, d = 1, 3, 4, 2
    q = torch.zeros(b, s, h, d)
    k = torch.zeros(b, s, 2, d)
    v = torch.stack([torch.zeros(b, s, d), torch.ones(b, s, d)], dim=2)
    pos = torch.arange(s)
    out = tl.gqa_attention(q, k, v, q_positions=pos, k_positions=pos)
    assert out[0, :, :2].abs().max() == 0 and (out[0, :, 2:] == 1).all()


def test_q_chunk_must_divide_the_queries():
    x = torch.zeros(1, 6, 2, 4)
    pos = torch.arange(6)
    with pytest.raises(ValueError, match="q_chunk"):
        tl.gqa_attention(x, x, x, q_positions=pos, k_positions=pos, q_chunk=4)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)])
def test_decode_attention_matches_repro(per_row, h, kv):
    rng = np.random.default_rng(7 + h + kv)
    b, tt_, d = 3, 9, 16
    q, kc, vc = rand(rng, b, h, d), rand(rng, b, tt_, kv, d), rand(rng, b, tt_, kv, d)
    valid = rng.random((b, tt_) if per_row else tt_) < 0.6
    valid[..., 0] = True
    close(tl.decode_attention(t(q), t(kc), t(vc), valid=t(valid)),
          jl.decode_attention(q, kc, vc, valid=valid))


@pytest.mark.parametrize("s,n_chunks", [(8, 4), (6, 4), (5, 8), (7, 1)])
def test_swiglu_and_cross_entropy_match_repro(s, n_chunks):
    rng = np.random.default_rng(s)
    x = rand(rng, 2, s, 16)
    wg, wu, wo = rand(rng, 16, 24), rand(rng, 16, 24), rand(rng, 24, 16)
    close(tl.swiglu(t(x), t(wg), t(wu), t(wo)), jl.swiglu(x, wg, wu, wo))
    head = rand(rng, 16, 40)
    labels = rng.integers(0, 40, (2, s)).astype(np.int32)
    close(tl.cross_entropy_loss(t(x), t(head), t(labels), n_chunks),
          jl.cross_entropy_loss(x, head, labels, n_chunks))


# --------------------------------------------------------------------- moe.py
def test_capacity_matches_repro():
    for e, k, cf in ((8, 2, 1.25), (64, 6, 1.25), (4, 2, 2.0), (8, 2, 0.3)):
        jc = jm.MoEConfig(n_experts=e, top_k=k, d_ff_expert=8, capacity_factor=cf)
        for tokens in (1, 4, 7, 24, 128, 252, 1000):
            assert port_moe(jc).capacity(tokens) == jc.capacity(tokens)


def moe_case(dispatch: str, cf: float, n_shared: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    jc = jm.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, n_shared=n_shared,
                      d_ff_shared=24 if n_shared == 1 else 0, capacity_factor=cf,
                      dispatch=dispatch)
    # repro's layout and scales (held by test_init_params_and_cache_have_repro_layout),
    # drawn from the numpy seed
    params = tm.init_moe_params(32, port_moe(jc), torch.float32,
                                lambda shape, dtype: t(rand(rng, *shape)).to(dtype))
    return rng, jc, {k: v.numpy() for k, v in params.items()}


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_router_and_dispatches_match_repro(cf):
    """Expert ids, gates, logits, the aux loss, each claim's place, and both
    dispatches' tensors; at cf 0.5 claims drop (checked)."""
    rng, jc, params = moe_case("einsum", cf, 0, seed=3)
    x = rand(rng, 40, 32)
    ids, gates, logits = tm.router_topk(t(x), t(params["router"]), port_moe(jc))
    jids, jgates, jlogits = jm.router_topk(x, params["router"], jc)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    close(gates, jgates)
    close(logits, jlogits)
    close(tm.load_balance_loss(logits, ids, 8), jm.load_balance_loss(jlogits, jids, 8))
    cap = jc.capacity(40)
    dropped = (tm.claim_positions(ids, 8) >= cap).sum().item()
    assert (dropped > 0) == (cf < 1), dropped
    disp, comb = tm._dispatch_einsum(t(x), ids, gates, port_moe(jc), cap)
    jdisp, jcomb = jm._dispatch_einsum(x, jids, jgates, jc, cap)
    close(disp, jdisp)
    close(comb, jcomb)
    slot_token, slot_gate = tm._dispatch_indices(40, ids, gates, port_moe(jc), cap)
    jtok, jgate = jm._dispatch_indices(40, jids, jgates, jc, cap)
    np.testing.assert_array_equal(slot_token.numpy(), np.asarray(jtok))
    close(slot_gate, jgate)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("cf,n_shared", [(2.0, 0), (2.0, 2), (0.5, 1), (0.5, 0)])
def test_moe_ffn_matches_repro(dispatch, cf, n_shared):
    rng, jc, params = moe_case(dispatch, cf, n_shared, seed=int(cf * 4) + n_shared)
    x = rand(rng, 2, 10, 32)
    y, aux = tm.moe_ffn(t(x), {k: t(v) for k, v in params.items()}, port_moe(jc))
    jy, jaux = J_MOE(x, params, jc)
    close(y, jy)
    close(aux, jaux)
    other = dataclasses.replace(port_moe(jc), dispatch="sort" if dispatch == "einsum"
                                else "einsum")
    close(tm.moe_ffn(t(x), {k: t(v) for k, v in params.items()}, other)[0], jy)


def test_moe_rejects_an_unknown_dispatch():
    _, jc, params = moe_case("einsum", 2.0, 0)
    cfg = dataclasses.replace(port_moe(jc), dispatch="ragged")
    with pytest.raises(ValueError, match="dispatch"):
        tm.moe_ffn(torch.zeros(1, 2, 32), {k: t(v) for k, v in params.items()}, cfg)


# ------------------------------------------------------------- transformer.py
def check_lm(jcfg, batch: int = 2, prompt: int = 12, steps: int = 6, seed: int = 0):
    """forward, loss_fn, prefill (cache and logits) and ``steps`` decode
    steps of the port against ``repro`` on the same weights and tokens."""
    params, model = jax_model(jcfg, seed)
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(1, jcfg.vocab_size, (batch, prompt + steps)).astype(np.int32)
    prompts = toks[:, :prompt]
    batch_ = {"tokens": prompts, "labels": np.roll(prompts, -1, 1)}
    max_seq = prompt + steps
    (jx, jaux, _), (jloss, jparts), (jcache, jlogits) = j_forward_loss_prefill(
        params, batch_, jcfg, max_seq)
    with torch.inference_mode():
        x, aux, _ = tt.forward(model, t(prompts))
        close(x, jx)
        close(aux, jaux)
        loss, parts = tt.loss_fn(model, {k: t(v) for k, v in batch_.items()})
        close(loss, jloss)
        close(parts["ce"], jparts["ce"])
        cache, logits = tt.prefill(model, t(prompts), max_seq=max_seq)
        close(logits, jlogits)
        assert cache.keys() == jcache.keys()
        for k in cache:
            close(cache[k], jcache[k])
        for i in range(steps):
            pos = prompt + i
            logits, cache = tt.decode_step(model, cache, t(toks[:, pos]), pos)
            jlogits, jcache = J_DECODE(params, jcache, toks[:, pos], jnp.int32(pos),
                                       jcfg)
            close(logits, jlogits)
        for k in cache:
            close(cache[k], jcache[k])
    return model


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_reduced_arch_matches_repro(arch):
    """Prefill 2x12 and 6 decode steps: llama, phi3 and deepseek pad a
    linear cache of 18; mixtral's window of 8 rolls the prompt into the ring
    and its decode wraps it; minicpm3 decodes in MLA's latent space."""
    check_lm(jconfigs.get(arch).make_reduced())


def test_short_prompt_fills_a_window_ring_then_wraps():
    """A prompt shorter than mixtral's window pads the ring (S < T), and the
    decode steps then run past the window and wrap."""
    check_lm(jconfigs.get("mixtral-8x7b").make_reduced(), prompt=5, steps=7)


def test_linear_cache_saturates_at_its_last_slot():
    """Without a window, a decode past max_seq writes the last slot
    (``min(pos, t - 1)``), as ``repro``'s does."""
    jcfg = jconfigs.get("llama3.2-1b").make_reduced()
    params, model = jax_model(jcfg, seed=3)
    toks = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    with torch.inference_mode():
        cache, _ = tt.prefill(model, t(toks), max_seq=4)
        jcache, _ = J_PREFILL(params, toks, jcfg, 4)
        for pos in (4, 5):
            logits, cache = tt.decode_step(model, cache, t(toks[:, 0]), pos)
            jlogits, jcache = J_DECODE(params, jcache, toks[:, 0], jnp.int32(pos), jcfg)
            close(logits, jlogits)


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_padded_heads_match_repro_and_the_unpadded_model(kind):
    """``pad_heads_to`` adds heads whose outputs are masked to zero: the
    port equals ``repro`` on the padded config, and the padded model's
    logits equal the unpadded one's when the real heads' weights agree."""
    base_cfg = jconfigs.get("llama3.2-1b" if kind == "gqa" else "minicpm3-4b").make_reduced()
    jcfg = dataclasses.replace(base_cfg, attn=dataclasses.replace(base_cfg.attn,
                                                                  pad_heads_to=6))
    assert jcfg.attn.h_eff == 6 and jcfg.attn.head_mask_needed
    padded = check_lm(jcfg, steps=3)
    a = base_cfg.attn
    per_head = ({"wq": a.d_head, "wk": a.d_head, "wv": a.d_head, "wo": a.d_head}
                if kind == "gqa" else
                {"wuq": a.d_nope + a.d_rope, "wukv": a.d_nope + a.d_v, "wo": a.d_v})
    tree = {"embed": padded.embed, "final_norm": padded.final_norm,
            "lm_head": padded.lm_head, "layers": {}}
    for name in ("ln1", "ln2") + tuple(n for n, _ in padded.layers[0].attn.named_parameters()):
        stacked = torch.stack([getattr(blk, name) if name in ("ln1", "ln2")
                               else getattr(blk.attn, name) for blk in padded.layers])
        if name in per_head:                 # the real heads' slice of a padded weight
            heads = a.n_kv if name in ("wk", "wv") else a.n_heads
            axis = 1 if name == "wo" else 2
            stacked = stacked.narrow(axis, 0, heads * per_head[name])
        tree["layers"][name] = stacked
    tree["layers"]["ffn"] = {n: torch.stack([getattr(blk.ffn, n) for blk in padded.layers])
                             for n, _ in padded.layers[0].ffn.named_parameters()}
    unpadded = tt.params_from_numpy(jax.tree.map(lambda v: v.numpy(), tree),
                                    port_cfg(base_cfg), device="cpu")
    toks = torch.as_tensor(np.random.default_rng(5).integers(1, 512, (2, 9)))
    logits = []
    with torch.inference_mode():
        for model in (padded, unpadded):
            cache, first = tt.prefill(model, toks[:, :8], max_seq=9)
            logits.append((first, tt.decode_step(model, cache, toks[:, 8], 8)[0]))
    for got, want in zip(*logits):
        close(got, want.numpy())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_and_cache_have_repro_layout(arch):
    """The port's own ``init_params`` gives every parameter ``repro``'s shape
    and dtype; ``init_cache`` gives ``repro``'s cache shapes."""
    jcfg = jconfigs.get(arch).make_reduced()
    _, crossed = jax_model(jcfg)
    own = tt.init_params(port_cfg(jcfg), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    a = {n: (p.shape, p.dtype) for n, p in crossed.named_parameters()}
    b = {n: (p.shape, p.dtype) for n, p in own.named_parameters()}
    assert a == b
    assert own.layers[0].ffn.wg.std().item() > 0
    cache = tt.init_cache(port_cfg(jcfg), 3, 20, device="cpu")
    jcache = jt.init_cache(jcfg, 3, 20)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}


# ----------------------------------------------------------------- registry
def assert_same_config(cfg, jcfg):
    assert port_cfg(jcfg) == cfg
    # shard_activations annotates a TPU mesh and scan_layers chooses how
    # repro compiles its layers: neither changes what a forward computes.
    # remat is compared: the port recomputes each block in its backward too.
    compile_only = {"shard_activations", "scan_layers"}
    assert {f.name for f in dataclasses.fields(jcfg)} - compile_only == \
        {f.name for f in dataclasses.fields(cfg)}
    if jcfg.moe is not None:
        # the port's MoEConfig carries repro's mesh fields (moe_ffn_sharded)
        assert [f.name for f in dataclasses.fields(jcfg.moe)] == \
            [f.name for f in dataclasses.fields(cfg.moe)]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_registry_matches_repro_field_by_field(arch):
    ad, jad = configs.get(arch), jconfigs.get(arch)
    assert (ad.name, ad.family, ad.notes) == (jad.name, jad.family, jad.notes)
    assert_same_config(ad.make(), jad.make())
    assert_same_config(ad.make_reduced(), jad.make_reduced())
    assert ad.shapes.keys() == jad.shapes.keys()
    for name, shape in ad.shapes.items():
        js = jad.shapes[name]
        assert (shape.name, shape.kind, shape.dims, shape.skip_reason) == \
            (js.name, js.kind, js.dims, js.skip_reason)
    for cfg, jcfg in ((ad.make(), jad.make()), (ad.make_reduced(), jad.make_reduced())):
        for kind, b, s, c in (("train", 256, 4096, 0), ("prefill", 32, 32768, 0),
                              ("decode", 128, 32768, 32768), ("prefill", 4, 32, 0)):
            assert base.lm_model_flops(cfg, kind, b, s, c) == \
                jconfigs.base.lm_model_flops(jcfg, kind, b, s, c)


def test_registry_holds_the_lm_archs_and_names_the_rest():
    """The LM archs are ``repro``'s, with their cells; every other arch
    ``repro`` registers is the port's too, of the same family, or named in
    ``NOT_PORTED`` with its family."""
    lm = sorted(a for a in jconfigs.all_archs() if jconfigs.get(a).family == "lm")
    assert sorted(a for a in configs.all_archs()
                  if configs.get(a).family == "lm") == lm == sorted(LM_ARCHS)
    assert [c for c in configs.all_cells() if c[0] in lm] == \
        [c for c in jconfigs.all_cells() if c[0] in lm]
    rest = {a: jconfigs.get(a).family for a in jconfigs.all_archs() if a not in lm}
    ported = {a: configs.get(a).family for a in configs.all_archs() if a not in lm}
    assert ported.keys().isdisjoint(configs.NOT_PORTED)
    assert ported | configs.NOT_PORTED == rest
    for arch in configs.NOT_PORTED:
        with pytest.raises(KeyError, match="unknown arch"):
            configs.get(arch)
    with pytest.raises(ValueError):
        base.lm_model_flops(configs.get("llama3.2-1b").make(), "serve", 1, 1)


# ------------------------------------------------------------ launch/serve.py
def start_cli(*args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)


def test_serve_cli_prints_repros_lines(capsys, monkeypatch):
    """``--reduced --device cpu`` as a user runs it: ``repro``'s two lines,
    with the batch, prompt and step counts of the flags."""
    flags = ["--arch", "phi3-medium-14b", "--reduced", "--batch", "3", "--prompt-len", "10",
             "--decode-steps", "12"]
    proc = start_cli(*flags, "--device", "cpu")     # runs while repro's does
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    jlines = capsys.readouterr().out.splitlines()
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    lines = out.splitlines()
    # the same lines but for the times and the ids (each package draws its
    # own weights)
    pattern = re.compile(r"prefill 3x10 in [0-9.]+ms; decode 11 steps @ [0-9.]+ tok/s")
    assert len(lines) == len(jlines) == 2
    assert pattern.fullmatch(lines[0]) and pattern.fullmatch(jlines[0])
    ids, jids = (json.loads(ln.split("sample generation ids: ")[1])
                 for ln in (lines[1], jlines[1]))
    assert len(ids) == len(jids) == 12 and all(0 <= i < 512 for i in ids)


def test_serve_refuses_a_non_lm_arch_and_runs_on_the_card_by_default(monkeypatch):
    """A non-LM arch exits with ``repro``'s message, whether the port
    registers it (the GNN and the recsys archs) or not (the n-gram cell)."""
    non_lm = [a for a in jconfigs.all_archs() if jconfigs.get(a).family != "lm"]
    assert {jconfigs.get(a).family for a in non_lm} == {"gnn", "recsys", "ngram"}
    for arch in non_lm:
        with pytest.raises(SystemExit, match="serve.py drives LM archs"):
            serve.main(["--arch", arch, "--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
        with pytest.raises(SystemExit, match="serve.py drives LM archs"):
            jserve.main()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced"])


def test_generate_is_prefill_then_greedy_decode():
    """``generate`` keeps each step's logits; its tokens are their argmax,
    and each decode step's logits equal a prefill of the same tokens."""
    cfg = configs.get("minicpm3-4b").make_reduced()
    model = tt.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    prompts = serve.draw_prompts(cfg, 2, 7)
    gen = serve.generate(model, prompts, 5)
    assert gen.tokens.shape == (2, 5) and len(gen.logits) == 5
    for i, logits in enumerate(gen.logits):
        assert torch.equal(gen.tokens[:, i], logits.argmax(-1))
    with torch.inference_mode():
        seq = torch.cat([prompts, gen.tokens[:, :3]], 1)
        _, ref = tt.prefill(model, seq, max_seq=seq.shape[1])
    close(gen.logits[3], ref.numpy())
