"""LM serving CLI (port of ``repro.launch.serve``): prefill a batch of
prompts, then batched greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --reduced --batch 4 --prompt-len 32 --decode-steps 32

The model runs from random weights (seed 0) and the prompts are drawn from
a seeded generator (seed 1), as ``repro``'s CLI does with
``jax.random``.  It runs on the card; ``--device cpu`` runs it on the host
instead, and without a card and without ``--device cpu`` it raises.  The
times are host seconds around work that ends in a synchronise of the card;
the first prefill includes the card's first-call costs, as ``repro``'s
includes its compile.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from repro_torch import configs, resolve_device
from repro_torch.models import transformer as tf


@dataclass
class Generation:
    """What :func:`generate` produced: ``tokens`` [B, decode_steps] (the
    prefill's greedy token, then one a decode step), the float32 logits of
    the prefill's last position and of each decode step, and the host
    seconds of the prefill and of the decode loop."""
    tokens: torch.Tensor
    logits: list
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model: tf.Transformer, prompts: torch.Tensor, decode_steps: int) -> Generation:
    """Prefill ``prompts`` [B, S], then ``decode_steps - 1`` greedy decode
    steps against a cache of ``S + decode_steps`` positions."""
    dev = model.device
    prompts = prompts.to(dev)
    prompt_len = prompts.shape[1]
    max_seq = prompt_len + decode_steps
    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = tf.prefill(model, prompts, max_seq=max_seq)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens, all_logits = [torch.argmax(logits, -1)], [logits]
    t0 = time.perf_counter()
    for i in range(decode_steps - 1):
        logits, cache = tf.decode_step(model, cache, out_tokens[-1], prompt_len + i)
        out_tokens.append(torch.argmax(logits, -1))
        all_logits.append(logits)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return Generation(torch.stack(out_tokens, 1), all_logits, t_prefill, t_decode)


def draw_prompts(cfg: tf.LMConfig, batch: int, prompt_len: int) -> torch.Tensor:
    """The CLI's prompts: ids in [1, vocab) from a generator seeded 1, drawn
    on the host so that every device serves the same prompts."""
    g = torch.Generator().manual_seed(1)
    return torch.randint(1, cfg.vocab_size, (batch, prompt_len), generator=g)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--device", default=None, choices=["cpu"],
                    help="device to serve on: the card unless cpu is given")
    args = ap.parse_args(argv)

    family = configs.NOT_PORTED.get(args.arch) or configs.get(args.arch).family
    if family != "lm":
        raise SystemExit("serve.py drives LM archs")
    ad = configs.get(args.arch)
    cfg = ad.make_reduced() if args.reduced else ad.make()
    dev = resolve_device(args.device)

    model = tf.init_params(cfg, dev, torch.Generator(dev).manual_seed(0))
    gen = generate(model, draw_prompts(cfg, args.batch, args.prompt_len),
                   args.decode_steps)

    ids = gen.tokens.cpu().numpy()
    tok_s = args.batch * (args.decode_steps - 1) / max(gen.decode_s, 1e-9)
    print(f"prefill {args.batch}x{args.prompt_len} in {gen.prefill_s*1e3:.1f}ms; "
          f"decode {args.decode_steps-1} steps @ {tok_s:.1f} tok/s")
    print("sample generation ids:", ids[0][:16].tolist())


if __name__ == "__main__":
    main()
