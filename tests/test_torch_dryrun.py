"""The dry run (``repro_torch.launch.dryrun``) against ``repro``'s.

Every (arch x shape) cell on the 16x16 and 2x16x16 layouts equals
``repro``'s ``build_cell`` on a ``jax.sharding.AbstractMesh``: kind, notes,
model FLOPs, donated arguments, and each argument leaf's name, global
shape, dtype, spec and shard shape.  The n-gram cells read the devices of
a real mesh, so ``repro``'s are built in a process with 512 XLA host
devices; the argument bytes a device of reduced cells are held against
``repro``'s compiled ``memory_analysis`` on 8 host devices, and the
n-gram cells' region on 2 gloo ranks against ``repro``'s job on 2 of them.
The probe's composition equals a full trace; a prefill cell's FLOPs equal
a count by hand; the roofline's formulas hold on set counts.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

jax = pytest.importorskip("jax")

import repro  # noqa: E402,F401  (installs repro's JAX shims)
from jax.sharding import AbstractMesh  # noqa: E402
from repro import configs as jconfigs  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import fake_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s) for a in jconfigs.ASSIGNED for s in jconfigs.get(a).shapes]
NGRAM = list(jconfigs.get("ngram-suffix-sigma").shapes)


def _dtype(d) -> str:
    return str(d).split(".")[-1]


def _spec(s) -> tuple:
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in s)


def port_record(cell, mesh) -> dict:
    """What the comparison reads of a port cell."""
    m = mesh if cell.mesh is None else cell.mesh
    return {"kind": cell.kind, "notes": cell.notes, "model_flops": cell.model_flops,
            "donate": tuple(cell.donate_argnums),
            "leaves": {name: (tuple(leaf.shape), _dtype(leaf.dtype), _spec(spec),
                              tuple(base.shard_shape(m, spec, leaf.shape)))
                       for name, leaf, spec in base.cell_leaves(cell)}}


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def repro_record(cell) -> dict:
    """The same of a ``repro`` cell."""
    args = jax.tree_util.tree_flatten_with_path(cell.args)[0]
    shard = jax.tree_util.tree_leaves(cell.in_shardings)
    return {"kind": cell.kind, "notes": cell.notes, "model_flops": cell.model_flops,
            "donate": tuple(cell.donate_argnums),
            "leaves": {"/".join(_key(k) for k in path):
                       (tuple(a.shape), _dtype(a.dtype), _spec(sh.spec),
                        tuple(sh.shard_shape(a.shape)))
                       for (path, a), sh in zip(args, shard)}}


@pytest.fixture(scope="module")
def port_cells():
    """Every assigned cell of the port on both fake layouts, and the n-gram
    cells (one fake group at a time)."""
    out = {}
    for name, (shape, names) in MESHES.items():
        with fake_mesh(shape, names, "cpu") as mesh:
            for arch, sname in CELLS + [("ngram-suffix-sigma", s) for s in NGRAM]:
                ad = configs.get(arch)
                out[name, arch, sname] = port_record(
                    ad.build_cell(ad.make(), ad.shapes[sname], mesh), mesh)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_equals_repro(port_cells, mesh_name, arch, shape):
    shape_t, names = MESHES[mesh_name]
    jad = jconfigs.get(arch)
    jcell = jad.build_cell(jad.make(), jad.shapes[shape], AbstractMesh(shape_t, names))
    assert port_cells[mesh_name, arch, shape] == repro_record(jcell)


# ----------------------------------------------------- repro in subprocesses
NGRAM_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    sys.path.insert(0, sys.argv[1])
    import jax
    from repro import configs
    from repro.launch.mesh import make_production_mesh
    sys.path.insert(0, sys.argv[2])
    from test_torch_dryrun import repro_record
    ad = configs.get("ngram-suffix-sigma")
    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for s in ad.shapes:
            rec = repro_record(ad.build_cell(None, ad.shapes[s], mesh))
            out["2x16x16" if multi else "16x16", s] = rec
    print(json.dumps([[list(k), v] for k, v in out.items()]))
""")

# argument bytes: reduced cells compiled on 8 host devices
ARG_CASES = [("llama3.2-1b", "train_4k"), ("mixtral-8x7b", "train_4k"),
             ("bst", "train_batch"), ("gin-tu", "full_graph_sm")]
ARG_MESHES = {"2x4": ((2, 4), ("data", "model")),
              "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}

ARGS_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[1])
    import jax
    import repro
    from repro import configs
    from repro.configs import bst
    bst.FULL = bst.REDUCED
    cases = json.loads(sys.argv[2])
    meshes = json.loads(sys.argv[3])
    out = []
    for mname, (shape, names) in meshes.items():
        mesh = jax.make_mesh(tuple(shape), tuple(names),
                             axis_types=(jax.sharding.AxisType.Auto,) * len(names))
        for arch, sname in cases:
            ad = configs.get(arch)
            cell = ad.build_cell(ad.make_reduced(), ad.shapes[sname], mesh)
            with mesh:
                c = jax.jit(cell.step_fn, in_shardings=cell.in_shardings,
                            out_shardings=cell.out_shardings,
                            donate_argnums=cell.donate_argnums
                            ).lower(*cell.args).compile()
            out.append([mname, arch, sname,
                        int(c.memory_analysis().argument_size_in_bytes)])
    # the n-gram job's body on 2 of the devices, at a capacity that overflows
    import numpy as np
    import jax.numpy as jnp
    from repro.core.stats import NGramConfig
    from repro.core.suffix_sigma import build_distributed_job
    tokens = np.asarray(json.loads(sys.argv[4]), np.int32)
    sigma, vocab, cap = json.loads(sys.argv[5])
    m2 = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("shards",))
    job = jax.jit(build_distributed_job(NGramConfig(sigma=sigma, tau=1, vocab_size=vocab),
                                        m2, "shards", cap))
    res = [np.asarray(r).tolist() for r in job(tokens, jnp.zeros((1, 1), jnp.uint32))]
    print(json.dumps(out))
    print(json.dumps(res))
""")

# the n-gram region: 2 ranks' rows, sigma, vocab and a capacity they overflow
JOB_TOKENS = [[int(t) for t in row] for row in
              __import__("numpy").random.default_rng(0).integers(0, 12, (2, 64))]
JOB_ARGS = (3, 12, 16)


def _start(script: str, *args: str) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", script, str(ROOT / "src"), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)


def _read(proc: subprocess.Popen, lines: int = 1):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    got = [json.loads(line) for line in out.strip().splitlines()[-lines:]]
    return got[0] if lines == 1 else got


@pytest.fixture(scope="module")
def repro_runs():
    """Both ``repro`` processes, started together."""
    ngram = _start(NGRAM_SCRIPT, str(ROOT / "tests"))
    args = _start(ARGS_SCRIPT, json.dumps(ARG_CASES), json.dumps(ARG_MESHES),
                  json.dumps(JOB_TOKENS), json.dumps(JOB_ARGS))
    arg_bytes, job = _read(args, lines=2)
    return {"ngram": {tuple(k): v for k, v in _read(ngram)},
            "args": {tuple(r[:3]): r[3] for r in arg_bytes}, "job": job}


def _json_round_trip(rec: dict) -> dict:
    return json.loads(json.dumps(rec))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape", NGRAM)
def test_ngram_cell_equals_repro(port_cells, repro_runs, mesh_name, shape):
    port = _json_round_trip(port_cells[mesh_name, "ngram-suffix-sigma", shape])
    assert port == repro_runs["ngram"][mesh_name, shape]


def test_nyt_lm_notes():
    with fake_mesh((16, 16), ("data", "model"), "cpu") as mesh:
        ad = configs.get("ngram-suffix-sigma")
        cell = ad.build_cell(None, ad.shapes["nyt_lm"], mesh)
    assert cell.notes == "R=256 reducers, record=24B, cap=20017"


@pytest.mark.parametrize("mesh_name", list(ARG_MESHES))
@pytest.mark.parametrize("arch,shape", ARG_CASES)
def test_argument_bytes_equal_repro_compiled(repro_runs, monkeypatch, mesh_name, arch, shape):
    """The argument bytes a device, exact from the shard shapes, equal
    ``repro``'s compiled ``memory_analysis`` (reduced configs, 8 devices).
    No shard of these cells is uneven, so XLA pads none."""
    monkeypatch.setattr(configs.bst, "FULL", configs.bst.REDUCED)
    shape_t, names = ARG_MESHES[mesh_name]
    with fake_mesh(shape_t, names, "cpu") as mesh:
        ad = configs.get(arch)
        cell = ad.build_cell(ad.make_reduced(), ad.shapes[shape], mesh)
        for _, leaf, spec in base.cell_leaves(cell):      # every shard even
            parts = [math.prod(dict(zip(names, shape_t))[a] for a in
                               (e if isinstance(e, tuple) else (e,)) if a is not None)
                     for e in spec]
            assert all(n % p == 0 for n, p in zip(leaf.shape, parts)), leaf
        ours = dryrun.argument_bytes(cell, mesh)
    assert ours == repro_runs["args"][mesh_name, arch, shape]


def test_ngram_region_equals_repro_job_on_two_ranks(repro_runs):
    """``suffix_sigma.distributed_block``, the n-gram cells' region, on 2
    gloo ranks (a ``DeviceMesh`` over them) equals ``repro``'s
    ``build_distributed_job`` on 2 host devices: terms, flags, counts and
    the stats row (map and shuffle records, overflow) of each rank, at a
    capacity both overflow."""
    import numpy as np
    from repro_torch.launch.mesh import spawn_ranks
    from torch_dryrun_ranks import distributed_block_rank
    ranks = spawn_ranks(2, distributed_block_rank, np.asarray(JOB_TOKENS, np.int32),
                        *JOB_ARGS, device="cpu")
    for i, want in enumerate(repro_runs["job"]):
        got = np.stack([r[i] for r in ranks])
        np.testing.assert_array_equal(got, np.asarray(want, dtype=got.dtype))
    assert all(r[3][2] > 0 for r in ranks)          # both ranks overflowed


# ------------------------------------------------------------------ traces
def _reduced(arch: str, layers: int):
    import dataclasses
    return dataclasses.replace(configs.get(arch).make_reduced(), n_layers=layers)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b"])
def test_probe_composes_to_the_full_trace(arch):
    """Four traces of at most two layers and two microbatches, composed,
    equal a trace at 4 layers and 2 microbatches exactly."""
    shape = base.ShapeDef("train", "train", {"seq_len": 16, "global_batch": 16})
    with fake_mesh((2, 2), ("data", "model"), "cpu") as mesh:
        def at(layers, micro):
            return base.build_lm_cell(_reduced(arch, layers), shape, mesh,
                                      depth=(layers, micro, 2))
        full = dryrun.trace(at(4, 2), mesh, "cpu")
        composed = dryrun.probe(at, 4, 2, mesh, "cpu")
    for key in ("flops", "bytes", "collectives"):
        assert composed[key] == full[key], key
    assert full["flops"] > 0 and full["collectives"]["reduce-scatter"] > 0


def test_prefill_flops_equal_a_count_by_hand():
    """A dense prefill with every dimension divisible (no replicated
    compute): the FLOPs a device times the devices are the step's matmul
    FLOPs counted by hand."""
    from repro_torch.models.transformer import AttentionConfig, LMConfig
    cfg = LMConfig(name="t", n_layers=2, d_model=64, vocab_size=256, d_ff=128,
                   attn=AttentionConfig("gqa", n_heads=4, n_kv=2, d_head=16),
                   dtype=torch.float32, remat=False)
    b, s = 8, 32
    shape = base.ShapeDef("prefill", "prefill", {"seq_len": s, "global_batch": b})
    with fake_mesh((2, 2), ("data", "model"), "cpu") as mesh:
        cell = base.build_lm_cell(cfg, shape, mesh)
        counts = dryrun.measure(cell, mesh, "cpu")
    a, d = cfg.attn, cfg.d_model
    per_layer = (2 * b * s * d * (a.n_heads + 2 * a.n_kv) * a.d_head   # q, k, v
                 + 2 * b * s * a.n_heads * a.d_head * d                # o
                 + 2 * 2 * b * a.n_heads * s * s * a.d_head           # scores, p @ v
                 + 3 * 2 * b * s * d * cfg.d_ff)                       # SwiGLU
    by_hand = cfg.n_layers * per_layer + 2 * b * d * cfg.vocab_size   # last-token head
    assert counts["flops"] * 4 == by_hand


def test_roofline_on_set_counts():
    from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32
    counts = {"flops": 2 * PEAK_FLOPS_BF16, "bytes": 3 * HBM_BW,
              "collectives": {"all-gather": LINK_BW, "all-reduce": 0.5 * LINK_BW,
                              "count": 7}}
    r = roofline.analyze(counts, chips=4, model_flops=4 * PEAK_FLOPS_BF16)
    assert (r.compute_s, r.memory_s, r.collective_s) == (2.0, 3.0, 1.5)
    assert r.bottleneck == "memory" and r.step_time_s == 3.0
    assert r.useful_fraction == 0.5
    assert r.roofline_fraction == pytest.approx(4 / 12)
    d = r.to_dict()
    assert d["collective_detail"] == {"all-gather": LINK_BW, "all-reduce": 0.5 * LINK_BW,
                                      "reduce-scatter": 0, "all-to-all": 0,
                                      "collective-permute": 0, "count": 7}
    r2 = roofline.analyze(dict(counts, flops=10 * PEAK_FLOPS_BF16), chips=4)
    assert r2.bottleneck == "compute" and r2.roofline_fraction == 0.0
    r3 = roofline.analyze(dict(counts, flops=0, bytes=0), chips=4)
    assert r3.bottleneck == "collective" and r3.useful_fraction == 0.0
    # a float32 cell (recsys, GIN: TF32 off) is held to the float32 peak
    r4 = roofline.analyze(dict(counts, flops=4 * PEAK_FLOPS_F32), chips=4,
                          model_flops=4 * PEAK_FLOPS_F32, dtype=torch.float32)
    assert r4.compute_s == 4.0 and r4.bottleneck == "compute"
    assert r4.roofline_fraction == pytest.approx(4 / 16)


def test_compute_dtype_of_the_cells():
    """The roofline's peak follows the dtype a cell's matmuls run in: bf16
    for an LM, float32 for the recsys archs and GIN."""
    with fake_mesh((2, 2), ("data", "model"), "cpu") as mesh:
        for arch, shape, want in [("llama3.2-1b", "train_4k", torch.bfloat16),
                                  ("bst", "train_batch", torch.float32),
                                  ("gin-tu", "molecule", torch.float32)]:
            ad = configs.get(arch)
            cell = ad.build_cell(ad.make(), ad.shapes[shape], mesh)
            assert dryrun.compute_dtype(cell) == want, arch


def test_records_keep_repro_keys(tmp_path):
    """The CLI's records: ``repro``'s keys, ``trace_s`` for its lower and
    compile times; a cached record is read back, not traced again."""
    argv = ["--arch", "gin-tu", "--shape", "molecule", "--mesh", "single",
            "--device", "cpu", "--out", str(tmp_path)]
    dryrun.main(argv)
    rec = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert set(rec) == {"arch", "shape", "mesh", "trace_s", "memory", "roofline",
                        "status", "kind", "notes"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "code_bytes"}
    assert set(rec["roofline"]) == {
        "flops_per_chip", "bytes_per_chip", "collective_bytes_per_chip", "chips",
        "model_flops", "compute_s", "memory_s", "collective_s", "bottleneck",
        "step_time_s", "useful_fraction", "roofline_fraction", "collective_detail"}
    assert rec["status"] == "ok" and rec["roofline"]["chips"] == 256
    dryrun.main(argv)
    assert json.loads(next(tmp_path.glob("*.json")).read_text()) == rec


def test_refuses_cpu_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--all", "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())
