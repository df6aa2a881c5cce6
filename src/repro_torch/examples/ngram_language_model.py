"""End-to-end driver: the paper's use case (a) -- n-gram statistics feeding
language-model training -- then train a ~100M-param LM for a few hundred
steps (port of ``examples/ngram_language_model.py``).

Pipeline (all on one device):
  1. synthesize a Zipf corpus (NYT profile) and run SUFFIX-sigma (sigma=5) to get
     collection frequencies -- the statistics a count-based LM / tokenizer needs;
  2. use the unigram statistics to build the frequency-ordered vocabulary (SSV
     sequence encoding) and to drop infrequent-term positions (document splits);
  3. train a ~100M-parameter llama-style model on the encoded stream with the
     production training loop (checkpointing + recovery + straggler log).

    PYTHONPATH=src python -m repro_torch.examples.ngram_language_model --steps 300

``repro``'s flags; the weights come from the port's ``init_params`` (a
``torch.Generator`` seeded 0 on the device), so the losses are not
``repro``'s, while every other line is.  The default checkpoint directory is
the port's own (under the temporary directory), so it never resumes a
``repro`` run.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import NGramConfig, run_job
from repro_torch.data import corpus as corpus_mod
from repro_torch.data.loader import LMBatchLoader
from repro_torch.examples import parse_args
from repro_torch.models import transformer as tt
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault_tolerance import StragglerDetector, run_with_recovery
from repro_torch.training.optimizer import OptimizerConfig, init_state
from repro_torch.training.train_loop import make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tokens", type=int, default=400_000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ngram_lm_ckpt"))
    args, dev = parse_args(ap, argv)

    # ---- 1. corpus + n-gram statistics (the paper's job) -------------------
    prof = corpus_mod.CorpusProfile("lm", 8192, 1.15, 24, 10)
    stream = corpus_mod.zipf_corpus(args.tokens, prof, seed=0, duplicate_frac=0.02)
    t0 = time.time()
    stats = run_job(stream, NGramConfig(sigma=5, tau=10, vocab_size=prof.vocab_size),
                    device=dev)
    print(f"SUFFIX-sigma: {len(stats)} n-grams (tau=10, sigma=5) "
          f"in {time.time()-t0:.1f}s; counters="
          f"{({k: int(v) for k, v in stats.counters.items()})}")

    # ---- 2. frequency-ordered vocab from the unigram stats ----------------
    d = stats.to_dict()
    uni = sorted(((g[0], c) for g, c in d.items() if len(g) == 1),
                 key=lambda kv: -kv[1])
    remap = np.zeros(prof.vocab_size + 1, np.int32)
    for new_id, (old_id, _) in enumerate(uni, start=2):
        remap[old_id] = new_id
    vocab_size = len(uni) + 2                      # + PAD-replacement + unk
    encoded = remap[stream]
    encoded = np.where(encoded == 0, 1, encoded)   # infrequent/separator -> unk
    print(f"vocabulary: {vocab_size} frequent terms "
          f"(dropped {prof.vocab_size - len(uni)} infrequent)")

    # ---- 3. ~100M-param LM training ----------------------------------------
    cfg = tt.LMConfig("ngram-lm-100m", n_layers=8, d_model=768, vocab_size=vocab_size,
                      d_ff=3072, attn=tt.AttentionConfig("gqa", 12, 4, 64),
                      dtype=torch.float32, remat=False, loss_chunks=4)
    model = tt.init_params(cfg, dev, torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params/1e6:.1f}M params")

    opt_cfg = OptimizerConfig(peak_lr=3e-4, warmup_steps=20, decay_steps=args.steps)
    model.requires_grad_(True)
    params = tt.param_tree(model)
    raw_step = make_train_step(lambda p, b: tt.loss_fn(model, b), opt_cfg)
    loader = LMBatchLoader(encoded, args.seq, args.batch, seed=0)

    def step_fn(state, batch):
        p, o, m = raw_step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    ckpt = CheckpointManager(args.ckpt_dir)
    straggler = StragglerDetector()
    t0 = time.time()
    state, history, retries = run_with_recovery(
        n_steps=args.steps, step_fn=step_fn,
        state={"params": params, "opt": init_state(params)},
        batch_fn=lambda s: {k: torch.as_tensor(v, device=dev)
                            for k, v in loader.batch_at(s).items()},
        ckpt=ckpt, ckpt_every=100, straggler=straggler)
    losses = [float(h["loss"]) for h in history]
    for i in list(range(0, len(losses), max(1, len(losses) // 10))) + [-1]:
        print(f"  step {i if i >= 0 else len(losses)-1:5d}  loss {losses[i]:.4f}")
    tok_s = args.steps * args.batch * args.seq / (time.time() - t0)
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"{tok_s:,.0f} tok/s, {retries} restarts")
    assert losses[-1] < losses[0], "training must reduce loss"


if __name__ == "__main__":
    main()
