"""End-to-end LM training entry point (port of ``repro.launch.train``), with
checkpointing, recovery and straggler detection.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 200 --reduced --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

``--reduced`` uses the arch's smoke config; omit it to train the full
config.  It runs on the card; ``--device cpu`` runs it on the host instead,
and without a card and without ``--device cpu`` it raises.  The loop is the
production path: the synthetic Zipf corpus -> deterministic loader ->
``run_with_recovery`` over atomic checkpoints, retrying a failed step from
the last one, with a straggler log.  The default checkpoint directory is
the port's own, so it never resumes a ``repro`` run.  The model starts from
the port's ``init_params`` (seed 0 on the device).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.data import corpus as corpus_mod
from repro_torch.data.loader import LMBatchLoader
from repro_torch.models import transformer as tf
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.fault_tolerance import (FailureInjector, StragglerDetector,
                                                  run_with_recovery)
from repro_torch.training.optimizer import OptimizerConfig, init_state
from repro_torch.training.train_loop import make_train_step


@dataclass
class TrainRun:
    """What :func:`train` produced: the model and the final state
    (``{"params", "opt"}``, the model's own tensors), each completed step's
    metrics, the restarts, the straggler detector, the wall seconds of each
    step run (replayed steps too; each ends in a synchronise of the card),
    the whole run's seconds and the checkpoint manager (its ``events``)."""
    model: tf.Transformer
    state: dict
    history: list
    retries: int
    straggler: StragglerDetector
    step_s: list
    seconds: float
    ckpt: CheckpointManager

    @property
    def losses(self) -> list[float]:
        return [float(h["loss"]) for h in self.history]


def train_corpus(cfg: tf.LMConfig, n_tokens: int) -> np.ndarray:
    """``repro``'s training stream: a Zipf corpus over the vocabulary (seed
    0), its separators made a real token."""
    prof = corpus_mod.CorpusProfile("train", cfg.vocab_size - 1, 1.1, 24, 12)
    stream = corpus_mod.zipf_corpus(n_tokens, prof, seed=0)
    return np.where(stream == 0, 1, stream)


def train(cfg: tf.LMConfig, *, steps: int = 100, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, corpus_tokens: int = 200_000,
          ckpt_dir: str = "/tmp/repro_torch_ckpt", ckpt_every: int = 25,
          device=None, injector: FailureInjector | None = None) -> TrainRun:
    """Train ``cfg`` from the port's seed-0 init for ``steps`` steps through
    ``run_with_recovery`` (resuming from ``ckpt_dir``'s latest checkpoint if
    it has one), on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    loader = LMBatchLoader(train_corpus(cfg, corpus_tokens), seq, batch, seed=0)
    # warmup over a tenth of the run (at most 100 steps), decay to its end
    opt_cfg = OptimizerConfig(peak_lr=lr, warmup_steps=min(100, steps // 10 + 1),
                              decay_steps=steps)
    model = tf.init_params(cfg, dev, torch.Generator(dev).manual_seed(0))
    model.requires_grad_(True)
    params = tf.param_tree(model)
    raw_step = make_train_step(lambda p, b: tf.loss_fn(model, b), opt_cfg)
    step_s = []

    def step_fn(state, batch):
        t0 = time.perf_counter()
        p, o, m = raw_step(state["params"], state["opt"], batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        return {"params": p, "opt": o}, m

    def batch_fn(step):
        return {k: torch.as_tensor(v, device=dev) for k, v in loader.batch_at(step).items()}

    ckpt = CheckpointManager(ckpt_dir)
    straggler = StragglerDetector()
    t0 = time.perf_counter()
    state, history, retries = run_with_recovery(
        n_steps=steps, step_fn=step_fn,
        state={"params": params, "opt": init_state(params)},
        batch_fn=batch_fn, ckpt=ckpt, ckpt_every=ckpt_every,
        injector=injector, straggler=straggler)
    return TrainRun(model, state, history, retries, straggler, step_s,
                    time.perf_counter() - t0, ckpt)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--corpus-tokens", type=int, default=200_000)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, choices=["cpu"],
                    help="device to train on: the card unless cpu is given")
    args = ap.parse_args(argv)

    family = configs.NOT_PORTED.get(args.arch) or configs.get(args.arch).family
    if family != "lm":
        raise SystemExit("train.py drives LM archs; see examples/ for gnn/recsys")
    ad = configs.get(args.arch)
    cfg = ad.make_reduced() if args.reduced else ad.make()
    dev = resolve_device(args.device)
    n_params = sum(p.numel() for p in
                   tf.init_params(cfg, "meta").parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={args.steps}")

    run = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                corpus_tokens=args.corpus_tokens, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, device=dev)
    losses = run.losses
    for i in range(0, len(losses), args.log_every):
        print(f"  step {i:5d}  loss {losses[i]:.4f}")
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f}); "
          f"{run.seconds:.1f}s, {run.retries} restarts, "
          f"{len(run.straggler.events)} stragglers")


if __name__ == "__main__":
    main()
