"""Each cell's traffic against the plain reference, at a tiny size on the CPU:
sound runs come out correct; the control and the planted faults do not."""
import numpy as np
import pytest
import torch

from cells import cell_inputs, run_cell, spec
from perfbench import corpus
from perfbench.control import control_checks
from perfbench.queries import draw_grams
from perfbench.reference.ngrams import job_counts

CELLS = [w["name"] for w in spec()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out, bench = run_cell(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert all(v["limit"] == 0 for v in out["checks"].values())
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell, config, traffic = cell_inputs(name, terms=200_000 if "stream" not in name else 131_072)
    bench = control_checks(cell, config, traffic, 11, torch.device("cpu"))
    assert not bench.checks.ok, bench.checks.items


def _half_batch(orig):
    def run_job(tokens, cfg, mesh=None, **kw):
        return orig(tokens[: tokens.shape[0] // 2], cfg, mesh, **kw)
    return run_job


def _altered(orig):
    def run_job(tokens, cfg, mesh=None, **kw):
        st = orig(tokens, cfg, mesh, **kw)
        st.counts = st.counts.copy()
        st.counts[len(st.counts) // 2] += 1
        return st
    return run_job


@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith(".job")])
@pytest.mark.parametrize("fault", [_half_batch, _altered], ids=["half_batch", "answer_altered"])
def test_job_fault_is_caught(monkeypatch, name, fault):
    from repro_torch import core
    monkeypatch.setattr(core, "run_job", fault(core.run_job))
    out, _ = run_cell(name)
    assert not out["correct"]
    assert out["failed"] == out["attempted"]


def _stream_fault(kind):
    from repro_torch.serve.service import StreamingNGramService
    ingest, lookup = StreamingNGramService.ingest, StreamingNGramService.lookup

    def unchanged(self, tokens):
        return {"job_s": 0.0, "ingest_s": 0.0, "ingested_rows": 0}

    def half(self, tokens):
        return ingest(self, tokens[: tokens.shape[0] // 2])

    def altered(self, grams, lengths):
        out = lookup(self, grams, lengths).copy()
        out[0] += 1
        return out
    return {"state_unchanged": ("ingest", unchanged), "half_batch": ("ingest", half),
            "answer_altered": ("lookup", altered)}[kind]


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch", "answer_altered"])
def test_stream_fault_is_caught(monkeypatch, kind):
    from repro_torch.serve.service import StreamingNGramService
    attr, fn = _stream_fault(kind)
    monkeypatch.setattr(StreamingNGramService, attr, fn)
    out, _ = run_cell("nyt.stream")
    assert not out["correct"]


def test_reference_counts_by_hand():
    tok = torch.tensor([1, 2, 1, 2, 0, 1, 2, 3, 0, 2, 1, 2])
    grams, lengths, counts = job_counts(tok, 3, 2)
    rows = {tuple(g[:n]): int(c) for g, n, c in zip(grams, lengths, counts)}
    assert rows == {(1,): 4, (2,): 5, (1, 2): 4, (2, 1): 2, (2, 1, 2): 2}
    assert list(lengths) == sorted(lengths)


def test_corpus_is_seeded_and_sized():
    _, config, _ = cell_inputs("nyt.job", terms=50_000)
    a = corpus.make_corpus(config, 2**31 + 99, "cpu")
    b = corpus.make_corpus(config, 2**31 + 99, "cpu")
    c = corpus.make_corpus(config, 5, "cpu")
    assert a.shape == (50_000,) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) == 0 and int(a.max()) <= config["vocab_size"]
    pads = (a == 0).nonzero().squeeze(1).numpy()
    mean_len = np.diff(pads).mean() - 1
    assert 12 < mean_len < 30


def test_query_draw_hits_real_grams():
    _, config, _ = cell_inputs("nyt.job", terms=30_000)
    tok = corpus.make_corpus(config, 3, "cpu")
    g, ln = draw_grams(tok, 500, width=5, min_len=1, max_len=5, miss_frac=0.0,
                       vocab_size=config["vocab_size"], gen=corpus.generator(4, "cpu"))
    text = tok.numpy().tolist()
    for row, n in list(zip(g.numpy(), ln.numpy()))[:50]:
        assert 1 <= n <= 5 and (row[n:] == 0).all() and (row[:n] != 0).all()
        want = row[:n].tolist()
        assert any(text[i:i + n] == want for i in range(len(text) - n + 1))
