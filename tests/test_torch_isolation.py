"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback.

Each import check runs in a fresh interpreter where ``import jax`` fails
(``sys.modules["jax"] = None``), so a stray import anywhere in the port or in
``chip_smoke.py`` breaks it.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

NO_JAX = "import sys\nsys.modules['jax'] = None\n"
NO_REPRO = textwrap.dedent("""
    bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                 and (m in ('repro', 'jax') or m.startswith(('repro.', 'jax.'))))
    assert not bad, bad
""")


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_every_port_module_imports_without_jax_or_repro():
    out = _run(NO_JAX + textwrap.dedent("""
        import importlib, pkgutil
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                       'repro_torch.')]
        for name in names:
            importlib.import_module(name)
        print(len(names))
    """) + NO_REPRO)
    assert int(out) >= 20


def test_chip_smoke_imports_without_jax_or_repro():
    _run(NO_JAX + f"sys.path.insert(0, {str(ROOT)!r})\nimport chip_smoke\n"
         + "assert callable(chip_smoke.main)\n" + NO_REPRO)


def test_entry_points_refuse_cpu_without_a_device(monkeypatch):
    """Without a card and without ``device``, the entry points raise instead
    of running on the CPU."""
    from repro_torch.core import NGramConfig, run_job
    from repro_torch.index import build_index, index_from_arrays
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    toks = np.asarray([1, 2, 0, 2, 1], np.int32)
    cfg = NGramConfig(sigma=2, tau=1, vocab_size=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_job(toks, cfg)
    stats = run_job(toks, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_index(stats, vocab_size=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        index_from_arrays({}, sigma=2, vocab_size=3, fanout_shift=0, n_fanout=5)


def test_streaming_entry_points_refuse_cpu_without_a_device(monkeypatch):
    """``GenerationalIndex``, ``StreamingNGramService``, ``compress_index`` and
    ``build_compressed_index`` run on the card by default and raise without
    one; given ``device="cpu"`` they run on the host."""
    from repro_torch.core import NGramConfig, run_job
    from repro_torch.index import (GenerationalIndex, build_compressed_index,
                                   build_index, compress_index,
                                   compressed_index_from_arrays)
    from repro_torch.serve import StreamingNGramService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    toks = np.asarray([1, 2, 0, 2, 1], np.int32)
    cfg = NGramConfig(sigma=2, tau=1, vocab_size=3, combine_route="hash")
    stats = run_job(toks, cfg, device="cpu")
    idx = build_index(stats, vocab_size=3, device="cpu")
    for call in (lambda: GenerationalIndex(sigma=2, vocab_size=3),
                 lambda: StreamingNGramService(cfg, compress=True, route="merge"),
                 lambda: compress_index(idx),
                 lambda: build_compressed_index(stats, vocab_size=3),
                 lambda: compressed_index_from_arrays({}, {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    svc = StreamingNGramService(cfg, compress=True, route="merge", device="cpu")
    svc.ingest(toks)
    assert svc.lookup(np.asarray([[1, 2]], np.int32), np.asarray([2])).tolist() == [1]
    assert compress_index(idx, device="cpu").n_rows == idx.n_rows


def test_extension_entry_points_refuse_cpu_without_a_device(monkeypatch):
    """The series job, ``filter_stats``, the aggregations and ``sigma_split``
    run on the card by default and raise without one; given
    ``device="cpu"`` they run on the host."""
    from repro_torch.core import (NGramConfig, aggregations, extensions_filter,
                                  run_job, suffix_sigma)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    toks = np.asarray([1, 2, 0, 2, 1, 2, 0, 1, 2], np.int32)
    years = np.asarray([0, 0, 0, 1, 1, 1, 1, 2, 2], np.int32)
    cfg = NGramConfig(sigma=2, tau=1, vocab_size=3)
    series = NGramConfig(sigma=2, tau=1, vocab_size=3, n_buckets=3)
    stats = run_job(toks, cfg, device="cpu")
    calls = (lambda **kw: run_job(toks, series, bucket_ids=years, **kw),
             lambda **kw: extensions_filter(stats, "max", **kw),
             lambda **kw: aggregations.document_frequencies(toks, cfg, **kw),
             lambda **kw: aggregations.df_suffix_lengths(toks, cfg, **kw),
             lambda **kw: aggregations.postings(toks, cfg, **kw),
             lambda **kw: suffix_sigma.sigma_split(toks, cfg, 1, **kw))
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    assert run_job(toks, series, bucket_ids=years, device="cpu").to_series_dict()[(1, 2)] \
        .tolist() == [1, 1, 1]


def test_wave_engine_runs_without_jax_or_repro():
    """The wave engine's imports made at run time (the accumulators, the
    collect, the stats route, the service's wave ingest and pipelined
    lookups) load nothing of JAX or ``repro`` either."""
    _run(NO_JAX + textwrap.dedent("""
        import numpy as np
        from repro_torch import WaveExecutor
        from repro_torch.core import NGramConfig
        from repro_torch.serve import StreamingNGramService
        toks = np.asarray([1, 2, 3, 0, 2, 3, 1, 2, 3, 1], np.int32)
        for method in ('suffix_sigma', 'apriori_scan'):
            for acc in ('defer', 'tiered', 'pairwise'):
                cfg = NGramConfig(sigma=3, tau=1, vocab_size=3, method=method)
                out = WaveExecutor(cfg, wave_tokens=3, accumulator=acc,
                                   device='cpu').run(toks)
                assert out.to_dict()[(1, 2, 3)] == 2
        cfg = NGramConfig(sigma=3, tau=1, vocab_size=3, pack=False)
        assert WaveExecutor(cfg, wave_tokens=4, device='cpu').run(toks).to_dict()[(2, 3)] == 3
        gen, reports = WaveExecutor(cfg, wave_tokens=4, device='cpu').run_streaming(
            toks, compress=True)
        assert len(reports) == 3
        svc = StreamingNGramService(cfg, wave_tokens=4, device='cpu')
        svc.ingest(toks)
        g = np.asarray([[1, 2, 3], [2, 3, 0]], np.int32)
        ln = np.asarray([3, 2], np.int32)
        assert [a.tolist() for a in svc.lookup_pipelined([(g, ln)] * 3)] == [[2, 3]] * 3
    """) + NO_REPRO)


def test_wave_engine_refuses_cpu_without_a_device(monkeypatch):
    """``WaveExecutor`` and the service's wave ingest run on the card by
    default and raise without one; given ``device="cpu"`` they run."""
    from repro_torch.core import NGramConfig
    from repro_torch.pipeline import WaveExecutor
    from repro_torch.serve import StreamingNGramService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = NGramConfig(sigma=2, tau=1, vocab_size=3)
    for call in (lambda: WaveExecutor(cfg, wave_tokens=2),
                 lambda: StreamingNGramService(cfg, wave_tokens=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    toks = np.asarray([1, 2, 0, 2, 1], np.int32)
    assert WaveExecutor(cfg, wave_tokens=2, device="cpu").run(toks).to_dict() == \
        {(1,): 2, (2,): 2, (1, 2): 1, (2, 1): 1}


def test_serving_tier_and_clis_run_without_jax_or_repro():
    """The frontend, its HTTP transport, the metrics and trace exports and
    both CLIs load nothing of JAX or ``repro``, at import or at run time."""
    _run(NO_JAX + textwrap.dedent("""
        import http.client, json, tempfile, os
        import numpy as np
        from repro_torch.core import NGramConfig
        from repro_torch.obs import metrics, report, trace
        from repro_torch.serve import QueryFrontend, StreamingNGramService, serve_http
        from repro_torch.launch import ngram, serve_ngrams
        reg = metrics.MetricsRegistry()
        metrics.set_registry(reg)
        tracer = trace.enable_tracing()
        toks = np.asarray([1, 2, 3, 0, 2, 3, 1, 2, 3, 1], np.int32)
        svc = StreamingNGramService(NGramConfig(sigma=3, tau=1, vocab_size=3),
                                    compress=True, device='cpu')
        svc.ingest(toks)
        with QueryFrontend(svc, deadline_s=0.001) as fe:
            srv = serve_http(fe, '127.0.0.1', 0, block=False)
            conn = http.client.HTTPConnection(*srv.server_address, timeout=30)
            conn.request('POST', '/v1/lookup', body=json.dumps({'gram': [1, 2, 3]}))
            assert json.loads(conn.getresponse().read())['count'] == 2
            conn.close()
            assert fe.topology()['index']['kind'] == 'generational'
            srv.shutdown()
            srv.server_close()
        trace.disable_tracing()
        assert report.validate_metrics(reg.snapshot()) == []
        assert report.validate_trace(tracer.export()) == []
        assert report.environment_metadata()['device_kind'] in ('cuda', 'cpu')
        metrics.set_registry(None)
        d = tempfile.mkdtemp()
        ngram.main(['--tokens', '3000', '--sigma', '3', '--tau', '2', '--device', 'cpu',
                    '--wave-tokens', '1000', '--metrics', os.path.join(d, 'a.jsonl')])
        serve_ngrams.main(['--tokens', '3000', '--queries', '200', '--batch-sizes', '64',
                           '--device', 'cpu', '--trace', os.path.join(d, 't.json')])
    """) + NO_REPRO)


def test_clis_refuse_cpu_without_a_device(monkeypatch):
    """Without a card and without ``--device cpu`` the CLIs raise instead of
    running on the host."""
    from repro_torch.launch import ngram, serve_ngrams
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (ngram.main, serve_ngrams.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--tokens", "2000", "--sigma", "2", "--tau", "2"])


def test_ranks_run_without_jax_or_repro(tmp_path):
    """``launch/mesh.py`` and a 2-rank job, sharded index, mesh waves and
    streaming service, through ``ngram --devices 2`` (with and without
    ``--wave-tokens``), ``serve_ngrams --streaming --devices 2`` and
    ``spawn_ranks``: every rank is a fresh process, so ``jax`` is blocked by
    a package on the path that fails to import."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text(
        "raise ImportError('jax is blocked here')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT / 'src'}")
    code = textwrap.dedent("""
        import sys
        from repro_torch.launch import mesh, ngram, serve_ngrams
        from repro_torch.index import (build_sharded_index, serve_queries,  # noqa: F401
                                       shard_generational)
        ngram.main(['--devices', '2', '--device', 'cpu', '--tokens', '3000',
                    '--sigma', '3', '--tau', '2'])
        ngram.main(['--devices', '2', '--device', 'cpu', '--tokens', '3000',
                    '--sigma', '3', '--tau', '2', '--wave-tokens', '1000',
                    '--accumulator', 'tiered'])
        serve_ngrams.main(['--devices', '2', '--device', 'cpu', '--tokens', '3000',
                           '--streaming', '--wave-tokens', '1000', '--queries', '400'])
        print(mesh.spawn_ranks(2, mesh.DataMesh.max_int, 7, device='cpu'))
    """) + NO_REPRO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("mesh: 2 ranks on cpu, backend gloo") == 3
    assert "'capacity'" in proc.stdout and "'waves': 4" in proc.stdout
    assert "ingest[3]" in proc.stdout and proc.stdout.strip().endswith("[7, 7]")


def test_ranks_refuse_cpu_without_a_device(monkeypatch):
    """On a mesh, the jobs, the sharded index, the mesh waves, the service
    and ``spawn_ranks`` run on the card by default and raise without one,
    before any collective."""
    from repro_torch.core import NGramConfig, run_job
    from repro_torch.index import build_sharded_index
    from repro_torch.launch.mesh import DataMesh, spawn_ranks
    from repro_torch.pipeline import WaveExecutor
    from repro_torch.serve import StreamingNGramService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = DataMesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    toks = np.asarray([1, 2, 0, 2, 1], np.int32)
    stats = run_job(toks, NGramConfig(sigma=2, tau=1, vocab_size=3), device="cpu")
    for method in ("suffix_sigma", "naive", "apriori_scan", "apriori_index"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_job(toks, NGramConfig(sigma=2, tau=1, vocab_size=3, method=method),
                    mesh=mesh)
    cfg = NGramConfig(sigma=2, tau=1, vocab_size=3)
    for call in (lambda: build_sharded_index(stats, vocab_size=3, mesh=mesh),
                 lambda: WaveExecutor(cfg, wave_tokens=4, mesh=mesh),
                 lambda: StreamingNGramService(cfg, wave_tokens=4, mesh=mesh),
                 lambda: spawn_ranks(2, DataMesh.max_int, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_lm_training_runs_without_jax_or_repro():
    """The training modules, the train CLI and a run with a failure and a
    restore load nothing of JAX or ``repro`` at run time either."""
    _run(NO_JAX + textwrap.dedent("""
        import contextlib, io, tempfile
        from repro_torch import configs
        from repro_torch.launch import train
        from repro_torch.training.fault_tolerance import FailureInjector
        cfg = configs.get('llama3.2-1b').make_reduced()
        with tempfile.TemporaryDirectory() as d:
            run = train.train(cfg, steps=4, batch=2, seq=8, ckpt_dir=d, ckpt_every=2,
                              device='cpu', injector=FailureInjector({3}))
            assert run.retries == 1 and len(run.history) == 5
        with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
            train.main(['--reduced', '--steps', '2', '--device', 'cpu', '--ckpt-dir', d])
    """) + NO_REPRO)


def test_training_entry_points_refuse_cpu_without_a_device(monkeypatch, tmp_path):
    """``launch.train.train``, its CLI and a restore onto new tensors run on
    the card by default and raise without one; given ``device="cpu"`` they
    run."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf
    from repro_torch.training.checkpoint import CheckpointManager
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("llama3.2-1b").make_reduced()
    ck = CheckpointManager(tmp_path / "ck", async_save=False)
    ck.save(1, {"w": torch.ones(3)})
    for call in (lambda: train.train(cfg, steps=1, ckpt_dir=str(tmp_path / "a")),
                 lambda: train.main(["--reduced", "--steps", "1",
                                     "--ckpt-dir", str(tmp_path / "b")]),
                 lambda: tf.init_params(cfg),
                 lambda: ck.restore(1, {"w": torch.empty(3, device="meta")})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ck.restore(1, {"w": torch.empty(3, device="meta")}, device="cpu")[0]["w"].sum() == 3
    run = train.train(cfg, steps=1, batch=2, seq=8, ckpt_dir=str(tmp_path / "c"),
                      device="cpu")
    assert len(run.history) == 1


def test_recsys_and_gnn_run_without_jax_or_repro(tmp_path):
    """The recsys and GNN models, their generators and configs, a train step
    of each reduced arch, and GIN's dst-partitioned loss on 2 gloo ranks:
    every rank is a fresh process, so ``jax`` is blocked by a package on the
    path that fails to import."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text(
        "raise ImportError('jax is blocked here')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT / 'src'}")
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT / 'tests')!r})
        import torch
        from repro_torch import configs
        from repro_torch.data import graph, recsys as rdata
        from repro_torch.launch.mesh import spawn_ranks
        from repro_torch.models import gnn, recsys
        from repro_torch.training import optimizer, train_loop
        from repro_torch.training.tree import tree_to_numpy
        from torch_gnn_ranks import dst_partitioned_rank
        gens = {{'bst': lambda c: rdata.BehaviorSeqGen(c.item_vocab, c.seq_len),
                'two-tower-retrieval': lambda c: rdata.RetrievalGen(c.item_vocab,
                                                                    c.user_feat)}}
        for arch in ('bst', 'autoint', 'two-tower-retrieval', 'xdeepfm'):
            cfg = configs.get(arch).make_reduced()
            gen = gens.get(arch, lambda c: rdata.CTRBatchGen((c.field_vocab,) * c.n_sparse))
            b = {{k: torch.from_numpy(v) for k, v in gen(cfg).batch_at(0, 8).items()}}
            model = recsys.init_params(cfg, 'cpu').requires_grad_(True)
            p = recsys.param_tree(model)
            step = train_loop.make_train_step(lambda p, x: recsys.loss_fn(p, x, cfg),
                                              optimizer.OptimizerConfig())
            assert torch.isfinite(step(p, optimizer.init_state(p), b)[2]['loss'])
        cfg = configs.get('gin-tu').make_reduced()
        g = graph.random_graph(40, 160, cfg.d_feat, cfg.n_classes, seed=0)
        src, dst, mask = graph.partition_edges_by_dst(g, 2)
        batch = dict(features=g.features, edge_src=src, edge_dst=dst, edge_mask=mask,
                     labels=g.labels, label_mask=g.labels >= 0)
        model = gnn.init_params(cfg, 'cpu')
        out = spawn_ranks(2, dst_partitioned_rank, tree_to_numpy(gnn.param_tree(model)),
                          batch, [cfg], device='cpu')
        one = gnn.loss_fn(gnn.param_tree(model),
                          {{k: torch.from_numpy(v) for k, v in batch.items()}}, cfg)[0]
        assert abs(out[0][0][0] - float(one)) <= 1e-5 * float(one), (out[0][0][0], one)
    """) + NO_REPRO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_recsys_and_gnn_entry_points_refuse_cpu_without_a_device(monkeypatch):
    """Every ``*_init``, GIN's ``init_params`` and both ``params_from_numpy``
    run on the card by default and raise without one; given ``device="cpu"``
    they run."""
    from repro_torch import configs
    from repro_torch.models import gnn, recsys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gin = configs.get("gin-tu").make_reduced()
    calls = [lambda: gnn.init_params(gin),
             lambda: gnn.params_from_numpy(
                 gnn.params_to_numpy(gnn.init_params(gin, "cpu")), gin)]
    for arch in ("bst", "autoint", "two-tower-retrieval", "xdeepfm"):
        cfg = configs.get(arch).make_reduced()
        init = {"bst": recsys.bst_init, "autoint": recsys.autoint_init,
                "two-tower-retrieval": recsys.twotower_init,
                "xdeepfm": recsys.xdeepfm_init}[arch]
        calls += [lambda init=init, cfg=cfg: init(cfg),
                  lambda cfg=cfg: recsys.init_params(cfg),
                  lambda cfg=cfg: recsys.params_from_numpy(
                      recsys.params_to_numpy(recsys.init_params(cfg, "cpu")), cfg)]
        assert recsys.init_params(cfg, "cpu").device.type == "cpu"
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert gnn.init_params(gin, "cpu").device.type == "cpu"


def test_examples_and_the_grid_run_without_jax_or_repro(tmp_path):
    """Every example imports, and three of them run, with ``jax`` blocked by a
    package on the path that fails to import; so does the sharded MoE on a
    2 x 2 grid of 4 gloo ranks, each a fresh process."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text(
        "raise ImportError('jax is blocked here')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT / 'src'}")
    code = textwrap.dedent(f"""
        import contextlib, importlib, io, sys
        sys.path.insert(0, {str(ROOT / 'tests')!r})
        import numpy as np, torch
        from repro_torch.examples import NAMES
        from repro_torch.launch.mesh import spawn_ranks
        from repro_torch.models import moe
        from torch_moe_ranks import grid_moe_rank, moe_cfg
        mods = {{n: importlib.import_module('repro_torch.examples.' + n) for n in NAMES}}
        for name in ('quickstart', 'query_serving', 'streaming_ingest'):
            with contextlib.redirect_stdout(io.StringIO()) as out:
                mods[name].main(['--device', 'cpu'])
            assert len(out.getvalue().splitlines()) > 3, name
        rng = np.random.default_rng(0)
        params = {{k: v.numpy() for k, v in moe.init_moe_params(
            8, moe_cfg(4, 2, 4.0), torch.float32,
            lambda s, d: torch.from_numpy(rng.standard_normal(s).astype(np.float32))).items()}}
        x = rng.standard_normal((2, 4, 8)).astype(np.float32)
        out = spawn_ranks(4, grid_moe_rank, 2, (4, 2, 4.0), params, x, device='cpu')
        assert [o['y'].shape for o in out] == [(1, 4, 8)] * 4
        assert len({{o['aux'] for o in out}}) == 1
    """) + NO_REPRO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


@pytest.mark.parametrize("name", ["quickstart", "query_serving", "streaming_ingest",
                                  "out_of_core", "text_analytics", "ngram_language_model"])
def test_examples_refuse_cpu_without_a_device(monkeypatch, name):
    """Without a card and without ``--device cpu`` each example raises
    before it does any work."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
