#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every result.

    python3 chip_smoke.py            # from the repository root, on a CUDA host

Phases (any failure raises, and the script exits non-zero without its last
line):

  1. build    -- compile the eight CUDA kernels from ``src/repro_torch/kernels/csrc``;
  2. oracle   -- the paper's running example and ~50k NYT-profile tokens
                 through ``run_job`` of each of the four methods (APRIORI-INDEX
                 with K = 2 on the larger corpus, so its posting-list join
                 runs), then ``build_index`` -> ``lookup`` / ``continuations``
                 on the card, against the pure-Python oracle; and the
                 extensions: the 21-bucket series job, document frequencies
                 and postings on the 50k corpus, maximal and closed grams of
                 a 6k-token job;
  3. main path -- 2**25 NYT-profile terms, sigma=5, tau=10: the job, the index,
                 2**16 point lookups (half hits, half misses or malformed) and
                 2**14 top-8 continuation queries, each checked exactly; the
                 launch counters of the job's and the flat index's kernels
                 must move during this phase;
  6. methods  -- the same corpus and sigma, tau through NAIVE, APRIORI-SCAN
                 and APRIORI-INDEX (K = 4, the paper's value): each method's
                 job cold and warm, its counters and peak memory (the paper's
                 comparison of the methods, Figs. 4-5); each output must equal
                 phase 3's SUFFIX-sigma output exactly, NAIVE's map records
                 the closed form of its analysis, APRIORI-SCAN's at most
                 NAIVE's in at most sigma jobs, and the ``suffix_pack`` and
                 ``hash_partition`` launch counters must move;
  5. streaming -- the same corpus through ``StreamingNGramService`` (hash
                 combiner, compressed rungs, and the default merge-path
                 compaction route): a 60 %
                 base, then 4 deltas; after each ingest 2**16 lookups and
                 2**14 top-8 continuations checked exactly against the union
                 of the per-batch job outputs, and a repeated batch served
                 wholly from the cache; then ``compact_all``, whose single rung
                 must equal a compressed index built directly from the union.
                 Every one of the eight kernels' launch counters must move;
  7. extensions -- phase 3's corpus with a year bucket a document (the
                 same stream: the year draw takes no randomness) through the
                 series job (``n_buckets=21``, sort route cold and 3 warm, and
                 the hash route): its rows are phase 3's, every series sums to
                 phase 3's count, map_records equal, shuffle_records at least
                 phase 3's, shuffle_bytes a record of n_lanes + 2 words;
                 ``filter_stats`` max and closed of phase 3's output, each
                 equal to the same call on the CPU, maximal within closed;
                 ``document_frequencies`` equal to ``df_suffix_lengths``, df
                 <= cf on phase 3's grams; ``sigma_split`` (sigma 40, tau 10,
                 head 16) equal to the whole sigma-40 job; ``postings`` at
                 2**20 terms marginalizing to cf.  Each prints cold and warm
                 seconds, peak memory, device busy and idle share, and its
                 launches; ``suffix_pack``, ``hash_partition``,
                 ``lcp_boundary`` and ``hash_combine`` must launch;
  4. kernels  -- after phase 7, as it needs phase 5's shapes: each CUDA
                 kernel against its plain PyTorch version on the card, at
                 the shapes the main paths gave it and on edge cases (exact
                 equality), with its time a call (``ms``), its own device
                 time from torch.profiler (``kernel_ms``), the device time
                 of one call queued behind a spin between two CUDA events
                 (``queued_ms``, no profiler), the plain version's time
                 and the least time the card could take (``bound_ms``, from
                 the uint32 values' bytes; ``bound_ms_as_stored`` from the
                 int64 lanes the port keeps them in).  ``launches`` is the count on the path whose
                 shapes the row was timed at; ``launches_by_path`` has every
                 path's (main, methods, stream, ext, waves, frontend).
                 ``bsearch`` also gets its latency floor (``floor_ms``): the
                 round trips of its longest query times one dependent L2
                 load, plus an empty kernel, both measured here by
                 ``scripts/latency_probe.cu`` (built beside the kernels).
                 ``hash_combine`` runs in place, as the combine stage calls
                 it; the stage itself (every kernel one
                 ``stages.combine_hash`` call launches) gets its own line.
                 ``suffix_pack`` and ``hash_partition`` are also measured at
                 the shapes phase 6 gives them (``methods_shape``: the lanes
                 alone, and NAIVE's keys, one a record), and ``suffix_pack``,
                 ``hash_combine`` and ``lcp_boundary`` at phase 7's
                 (``ext_shape``: bucketed records [N, 5], the generic
                 combiner on lanes | bucket keys, the sigma-40 terms), and
                 ``lcp_boundary`` at ``sigma_split``'s phase A
                 (``split_shape``: the sigma-16 terms).  After phase 8:
                 ``merge_path`` at the 2**27 fold's largest merge and its
                 widest, both runs past 2**26 rows (``fold_shape``,
                 ``fold_widest_shape``);
  8. waves    -- the wave engine (``WaveExecutor``) on phase 3's corpus:
                 SUFFIX-sigma in one wave and in waves of 2**25, 2**23 and
                 2**21 positions, the tiered and pairwise folds, the sort
                 route, the hash combiner, the fold without its thread, and
                 NAIVE, APRIORI-SCAN and APRIORI-INDEX in waves of 2**23,
                 each equal to phase 3's output (SUFFIX-sigma's map_records
                 too), each with warm seconds (median of 3), peak memory and
                 device busy and idle share; ``run_streaming(compress=True)``
                 at tau 1, whose 2**16 lookups and 2**14 continuations must
                 equal a flat index of the monolithic tau = 1 job's rows and
                 whose ``compact_all`` rung must equal
                 ``compress_index(build_index(...))`` of them; the service
                 with ``wave_tokens`` on phase 5's batches, answering as
                 phase 5's service, and ``lookup_pipelined`` over 8 batches
                 as ``lookup``.  Then 2**27 terms: SUFFIX-sigma in waves of
                 2**24 and NAIVE in waves of 2**23 must equal the monolithic
                 SUFFIX-sigma job there, the SUFFIX-sigma wave run peaking
                 below it, whose fold's widest and largest merges phase 4
                 then times.  Device busy time is the union of the kernel
                 and copy intervals over every stream.  Every one of the
                 eight kernels must launch from the wave entry points
                 (``WaveExecutor.run`` and ``run_streaming``, the queries and
                 ``compact_all`` on its index, the wave service); the
                 references' launches are not counted;
  9. frontend -- the serving tier, after phase 8, with a metrics registry
                 and the tracer on: a fresh ``StreamingNGramService`` at
                 phase 5's configuration fed phase 5's batches (its rungs
                 compressed and flat), behind ``QueryFrontend`` (2 ms
                 deadline) and ``serve_http`` on localhost.  16 client
                 threads in a closed loop send 2**16 lookups in
                 ``/v1/lookup`` bodies of 64 grams (phase 5's draw: half
                 hits, half misses or malformed), 2**12 ``/v1/topk`` at
                 k = 8 (a quarter repeating the one before, in flight) and
                 64 ``/v1/complete`` SSE streams of 8 steps; every answer
                 must equal the union's (lookups, top-k) and the greedy
                 oracle of direct ``svc.continuations`` calls on a cold
                 cache and of the host (SSE).  Then a burst of 512 cold
                 top-k at batch priority on 256 clients against a second
                 frontend with ``queue_budget=64``: some must get 503, every
                 admitted answer must be exact.  The registry and trace
                 must validate, with ``serve.request`` / ``serve.flush``
                 spans and the ``frontend.*``, ``gen.*``, ``cache.*`` and
                 ``job.*`` instruments; ``bsearch`` and ``block_decode``
                 must launch from the queries and every kernel of the path
                 from the phase.  Then ``python -m
                 repro_torch.launch.ngram`` at phase 3's configuration (its
                 ``job.*`` counters must equal phase 3's) and ``python -m
                 repro_torch.launch.serve_ngrams --streaming --compress``
                 at 2**23 terms in waves of 2**21, side by side, each with
                 a valid ``--metrics`` file.  ``frontend:`` lines give
                 requests/s, lookups/s, client latency by endpoint, the
                 batches and their fill, coalesced, shed, the cache hit
                 rate, peak device memory and launches by kernel.

  10. ranks   -- the multi-rank batch path, last (after phase 9): 4 ranks spawned
                 on the one card over gloo (each collective staged through
                 pinned host memory), each reading only its own rows of
                 phase 3's corpus (a memory-mapped file).  The four methods
                 at phase 3's configuration (K = 4): a cold run and warm
                 runs (3, or 1 where the cold run took over 8 s), each
                 output equal to phase 3's single-device stats and every
                 rank's equal, map_records equal to the single-device jobs';
                 ``ranks:`` lines give capacity, retries, shuffle_records,
                 the bytes a rank sent and its seconds in collectives, each
                 rank's peak device memory, and the single-device warm time
                 beside the multi-rank one.  Then the sharded index from
                 phase 3's stats, flat and compressed (block size 4), on 4
                 ranks: phase 3's 2**16 lookups and 2**14 continuation
                 prefixes at k = 8 plus 64 length-0 prefixes, in batches of
                 4,096, equal to the single-device index's; and the flat
                 sharded index on 1 rank under NCCL (``all_to_all_single``
                 on device tensors), equal too.  The streaming path across
                 the same 4 ranks: (a) the mesh waves (``WaveExecutor(mesh=)``)
                 of SUFFIX-sigma, with the fold thread and without, and of
                 APRIORI-SCAN at phase 3's corpus and configuration in phase
                 8's waves of 2**23, each output equal to phase 3's (and so
                 phase 6's), map_records to phase 3's (SUFFIX-sigma) or
                 phase 8's (APRIORI-SCAN at tau 1 inside a wave), jobs,
                 waves and fold_rows to phase 8's; (b) phase 5's service
                 (hash combiner, compressed rungs, block size 4) with
                 ``mesh=`` and waves of 2**23, fed phase 5's base and 4
                 deltas, and (c) after each ingest ``shard_generational``
                 of its index with ``prev``, builds and reuses printed; the
                 service's 2**16 lookups and 2**14 + 64 continuations (in
                 batches of 4,096, rank by rank) and the sharded
                 generational index's (batches of 4,096) equal to phase 5's
                 service.  All eight kernels must launch in the ranks, which
                 count their own launches; the kernel rows'
                 ``launches_by_path`` gets ``ranks``.  Last, gloo's own
                 reduce-scatter against
                 ``DataMesh``'s (an all-to-all of the blocks and a local
                 sum) at APRIORI-INDEX's totals, in turns.  Gloo ranks on
                 one card measure correctness and host staging, not NVLink
                 scaling.
  11. lm      -- LM serving, last, after freeing the earlier phases' tensors
                 (it runs no kernel of the port: every op is PyTorch's own).
                 (a) Each of the five LM archs' REDUCED config in float32,
                 the same seeded weights on the card and on the CPU: prefill
                 2x12 and 6 decode steps of fixed tokens (mixtral's window of
                 8 wraps its ring), every logit within 1e-4 of the CPU's,
                 TF32 off.  (b) ``python -m repro_torch.launch.serve --arch
                 llama3.2-1b`` at repro's defaults (batch 4, prompt 32, 32
                 steps) as a subprocess, its two lines parsed, its ids equal
                 to the in-process run's.  (b, c) Each arch at full width in
                 bf16 (mixtral at 16 of its 32 layers, the one cut: all 32
                 exceed the card), through ``serve.generate`` cold (as the
                 CLI runs it) and warm: finite logits; at decode steps 0, 15
                 and 30, each sequence's logits within 0.25 (max abs) and
                 0.05 (rms relative) of the last-position logits of a
                 prefill of the same tokens.  A MoE sequence routed
                 otherwise (a near tie moved by bf16 rounding) or short of a
                 claim (prefill and decode have other capacities) in the
                 serving run or the prefill is excused from that and
                 counted, and every MoE sequence is held to both limits
                 against a prefill routed as the serving run was.  The same
                 rule must then catch a planted cache fault (each decode
                 step's token masked from its own cache slot, the served
                 tokens fed again) at every checked step.
                 ``lm:`` lines give prefill ms (cold and warm) and its share
                 of the dense bf16 peak (``lm_model_flops``), decode ms a
                 step and tokens/s, the bytes a step must read and that time
                 at 3.35 TB/s, and peak memory over what was held before.
  12. train   -- LM training, after phase 11 (it runs no kernel of the port
                 either).  (a) Each LM arch's REDUCED config in float32, the
                 same seeded weights on the card and on the CPU: one
                 ``make_train_step`` on a 4x16 batch; loss, gradient norm,
                 every gradient and first-moment leaf within 1e-4 of the
                 CPU's (of the leaf's max abs), every updated parameter by
                 Adam's rule (``train_reduced_on_card``), TF32 off.  (b)
                 llama3.2-1b at full width and depth in bf16 with remat,
                 through ``launch.train.train`` at repro's CLI defaults
                 (batch 8, seq 128, its Zipf corpus): 10 steps, the loss at
                 step 9 below step 0's.  (c) 3 steps with remat off.  (d) In
                 a process of its own under deterministic algorithms
                 (``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts): the
                 first step's gradients bit-equal with and without remat,
                 and a 10-step run checkpointing every 6 steps with a
                 failure injected at step 8 (one save of params and moments,
                 about 15 GB, and one restore, in ``build/phase12``, checked
                 for free space first and removed after) whose final params,
                 moments and step are bit-equal to an uninterrupted run's.
                 ``train:`` lines give warm step ms and tokens/s, the share
                 of the dense bf16 peak (``lm_model_flops``), peak GiB
                 against weights + grads + moments, remat off beside on,
                 save and restore seconds with the bytes, and the
                 deterministic step beside the plain one.
  13. recsys  -- the recsys and GNN archs, after phase 12 (no kernel of the
                 port on this path either: gathers, ``index_add_`` and
                 matmuls), float32 as ``repro``'s configs, TF32 off.  (a)
                 Each of bst, autoint, two-tower-retrieval, xdeepfm and
                 gin-tu at its REDUCED config, the same seeded weights on the
                 card and on the CPU: one ``make_train_step``; the loss,
                 every gradient and every first-moment leaf within 1e-4 of
                 the CPU's (of the leaf's max abs).  (b) Each at full width
                 (gin-tu as ``repro``'s build_cell builds it: 5 layers of
                 width 64, node features bf16 on the wire, at full_graph_sm,
                 Cora's shape): one loss and gradient at batch 512 on the
                 card against the same weights copied to the host CPU, with
                 the same rule.  (c) Warm runs on the card (median of 3):
                 each recsys arch's train step at train_batch (65,536, or
                 the largest power of two below it that fits the card; the
                 cut is printed), serve_p99 (512) and, for two-tower and
                 BST, retrieval_cand (one query against 1,000,000
                 candidates); gin-tu's train step at full_graph_sm,
                 ogb_products (full batch), molecule (128 graphs) and
                 minibatch_lg (1,024 seeds, fanout 15-10, sampled from a
                 Reddit-sized random graph).  The ogb_products and Reddit-
                 sized graphs are made by two processes of their own
                 (``--graph-child DIR NAME``, logs in ``build/phase13``)
                 while the card runs the rest; their making is timed apart.
                 Each prints ms, samples/s or edges/s and the share of the
                 67 TFLOP/s float32 peak by the ported FLOP functions.  (d)
                 ``gnn.loss_fn_dst_partitioned`` at full_graph_sm on 4 gloo
                 ranks sharing the card and at ogb_products on 1 NCCL rank
                 started beside them:
                 each loss within 1e-5, each all-reduced gradient within
                 1e-4, of the one-device ``loss_fn``.  ``recsys:`` and
                 ``gnn:`` lines.
  14. moe     -- the sharded MoE and the examples, after phase 13, float32,
                 TF32 off.  One spawn of 4 gloo ranks sharing the card:
                 (a) mixtral-8x7b and deepseek-moe-16b at full width, depth
                 cut to 1 layer (the one cut), on a 2 x 2 (data, model) grid
                 (``launch.mesh.grid_mesh``; ``cfg.moe.mesh`` set, so every
                 MoE layer runs ``moe_ffn_sharded``) at batch 8 x 128 and
                 each arch's capacity factor 1.25: each rank draws the whole
                 model leaf by leaf from seed 0 and keeps its part; its MoE
                 layer's y on its data row (a seeded x) within 1e-4 of
                 one-device ``moe_ffn(sort)`` on that row with the whole
                 weights, aux of the rows' mean; one loss and gradient (cold,
                 then warm) within 1e-4 of the one-device model run row by
                 row (every leaf, the MoE leaves the rank's part; the
                 references two ranks at a time).  (b) ffTP: 2 experts at
                 the CPU test's width on a 1 x 4 grid, y, aux and gradient
                 against the one-device sort path.  (c) The port's six
                 examples in one process on the card (``--examples-child``;
                 ``ngram_language_model`` at 40 steps, the one cut), their
                 asserts kept, the five n-gram examples' lines equal to a CPU
                 run's (started beside (a)) once times are masked; the
                 kernels they launch count under the ``examples`` path.
                 ``moe:`` and ``examples:`` lines (ms a step sharded and on
                 one device, bytes a rank sent, collective seconds, peak a
                 rank, dropped claims).
  15. dryrun  -- the dry run, last.  (a) ``python -m
                 repro_torch.launch.dryrun --all --include-ngram``, one
                 process a layout (16x16, 2x16x16), started with the script
                 beside everything else (records and logs in
                 ``build/phase15``): one line a cell (bottleneck, step ms,
                 roofline fraction, argument + temp GiB a device against
                 80 GiB); 86 records, 0 failed, the 8 documented skips.
                 (b) Phase 12's llama3.2-1b step (batch 8 x 128), phase
                 13's BST train_batch and GIN at Cora, each a cell on a
                 (1, 1) layout, traced and then run for real on the card:
                 the traced argument bytes equal the real tensors' and the
                 traced FLOPs equal ``FlopCounterMode`` on the real step,
                 exactly; the traced peak within 0.5-2x of that run's
                 ``max_memory_allocated`` and of the peak phase 12 or 13
                 read of the port's own step (BST's where phase 13 ran it
                 at train_batch).  (c) nyt_lm's job as rank 0 of 256 on the
                 fake group for real on the card (4,099,384 tokens, vocab
                 345,827, sigma 5): the main path's three kernels launch
                 (the ``dryrun`` path of the kernels line), its peak beside
                 the dry run's; the fake exchange returns shapes, not
                 answers, so no answer is checked.  ``dryrun:`` lines.

Phase 3's corpus, phase 7's corpus with years and phase 8's 2**27-term
corpus are made by a process of their own (``--corpus-child``, log in
``build/corpora``) from the start of phase 1, beside the build and the
card's work.

The last lines are one JSON object describing each kernel, the card's name and
power limit from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.  The
script needs one card; without CUDA it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import gc
import hashlib
import ctypes
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import NGramConfig, oracle, run_job  # noqa: E402
from repro_torch.core import aggregations, extensions_filter, naive, suffix_sigma  # noqa: E402
from repro_torch.core.stats import NGramStats  # noqa: E402
from repro_torch.data import corpus  # noqa: E402
from repro_torch.index import build_index, continuations, lookup  # noqa: E402
from repro_torch.index import (CompressedNGramIndex, build_compressed_index,  # noqa: E402
                               compress_index)
from repro_torch.index import compress as index_compress  # noqa: E402
from repro_torch.index import merge as index_merge  # noqa: E402
from repro_torch.index import query as index_query  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.mesh import grid_mesh, spawn_ranks  # noqa: E402
from repro_torch.launch.mesh import (HBM_BW, HBM_PER_CHIP, PEAK_FLOPS_BF16,  # noqa: E402
                                     PEAK_FLOPS_F32, fake_mesh, mesh_axes)
from repro_torch.launch import dryrun, regions  # noqa: E402
from repro_torch.configs import base as cell_base  # noqa: E402
from repro_torch.configs import paper as paper_configs  # noqa: E402
from repro_torch.mapreduce import pack  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.pipeline import WaveExecutor, plan_for, stages  # noqa: E402
from repro_torch.pipeline import executor as pipeline_executor  # noqa: E402
from repro_torch.serve import StreamingNGramService  # noqa: E402
from repro_torch import configs as lm_configs  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.data import loader as lm_loader  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.training import fault_tolerance as lm_fault  # noqa: E402
from repro_torch.training import optimizer as lm_optimizer  # noqa: E402
from repro_torch.training import train_loop as lm_train_loop  # noqa: E402
from repro_torch.training import tree as lm_tree  # noqa: E402
from repro_torch.training.tree import Stacked, named_leaves  # noqa: E402
from repro_torch.configs import autoint as autoint_configs  # noqa: E402
from repro_torch.configs import bst as bst_configs  # noqa: E402
from repro_torch.configs import gin_tu  # noqa: E402
from repro_torch.configs import recsys_common as recsys_configs  # noqa: E402
from repro_torch.configs import two_tower_retrieval as two_tower_configs  # noqa: E402
from repro_torch.configs import xdeepfm as xdeepfm_configs  # noqa: E402
from repro_torch.data import graph  # noqa: E402
from repro_torch.data import recsys as recsys_data  # noqa: E402
from repro_torch.models import gnn, recsys  # noqa: E402

# H100 SXM peaks, from the one hardware model (launch/mesh.py: NVIDIA data
# sheet, at the 700 W limit): HBM bandwidth, and the 32-bit non-tensor rate,
# the table's figure for the scalar integer work these kernels do
HBM_BYTES_PER_S = HBM_BW
SCALAR_OPS_PER_S = PEAK_FLOPS_F32

MAIN_TERMS = 1 << 25
SIGMA, TAU = 5, 10
#: phase 6: the paper's three other methods, and APRIORI-INDEX's K (its value)
METHODS = ("naive", "apriori_scan", "apriori_index")
APRIORI_INDEX_K = 4
N_LOOKUPS, N_PREFIXES, TOP_K = 1 << 16, 1 << 14, 8
#: phase 7: the paper's extensions.  The deployment of repro's
#: ``ngram --series --filter`` (src/repro/launch/ngram.py: a year bucket a
#: document, the NYT span 1987-2007 as 21 buckets), and the text-analytics
#: case of benchmarks/paper_figures.py (sigma 40, tau 10) for the sigma split
N_BUCKETS = 21
SPLIT_SIGMA, SPLIT_TAU, SPLIT_HEAD, SPLIT_FRAC = 40, 10, 16, 1 / 64
POSTINGS_TERMS = 1 << 20
#: the kernels of the extensions' path, which phase 7 drives
EXT_KERNELS = ("suffix_pack", "hash_partition", "lcp_boundary", "hash_combine")

KERNELS = {
    "suffix_pack": "src/repro/kernels/suffix_pack.py:60",
    "hash_partition": "src/repro/kernels/hash_partition.py:49",
    "lcp_boundary": "src/repro/kernels/lcp_boundary.py:51",
    "bsearch": "src/repro/kernels/bsearch.py:84",
    "hash_combine": "src/repro/kernels/hash_combine.py:91",
    "merge_path": "src/repro/kernels/merge_path.py:109",
    "block_expand": "src/repro/kernels/block_expand.py:104",
    "block_decode": "src/repro/kernels/block_decode.py:129",
}
#: the floor probes of the bsearch row: an L2 pointer chase and an empty kernel
PROBE_SRC = Path(__file__).resolve().parent / "scripts" / "latency_probe.cu"
#: the kernels of the job and the flat index, which phase 3 drives
MAIN_KERNELS = ("suffix_pack", "hash_partition", "lcp_boundary", "bsearch")
#: the kernels of the whole-gram methods' jobs, which phase 6 drives
METHOD_KERNELS = ("suffix_pack", "hash_partition")
N_DELTAS = 4
#: phase 10: ranks spawned on the card, the query batch, the length-0
#: prefixes, and the kernels the ranks' path runs
N_RANKS = 4
RANK_BATCH = 4096
N_EMPTY = 64
RANK_KERNELS = ("suffix_pack", "hash_partition", "lcp_boundary", "hash_combine",
                "merge_path", "block_expand", "bsearch", "block_decode")
#: phase 10's mesh waves: phase 8's middle wave size
RANK_WAVE = 1 << 23
PHASE10_DIR = Path(__file__).resolve().parent / "build" / "phase10"
#: phase 11: LM serving.  repro's launch/serve.py defaults (batch 4, prompt
#: 32, 32 decode steps); the five LM archs at full width, mixtral at 16 of
#: its 32 layers (all 32 are about 93 GB in bf16, more than the card holds)
LM_ARCHS = ("llama3.2-1b", "mixtral-8x7b", "deepseek-moe-16b", "minicpm3-4b",
            "phi3-medium-14b")
LM_LAYERS = {"mixtral-8x7b": 16}
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 32, 32
#: the decode steps held against a prefill of the same tokens (first, middle, last)
LM_CHECKED = (0, 15, 30)
#: warm runs after the cold one; the median's times are reported
LM_WARM = 3
#: (a) reduced configs in float32, card against the CPU: prefill 2x12, 6 steps
LM_SMALL_PROMPT, LM_SMALL_STEPS = 12, 6
LM_F32_TOL = 1e-4
#: H100 SXM dense bf16 peak (launch/mesh.py's hardware model)
BF16_FLOPS_PER_S = PEAK_FLOPS_BF16
#: (b, c) a decode step's logits against a prefill of the same tokens, in
#: bf16: max abs error and rms error over the prefill's rms (PERF.md section
#: 6 gives the sound readings and the planted fault's that each sits between)
LM_BF16_ATOL = 0.25
LM_BF16_REL = 0.05
#: phase 12: LM training at repro's launch/train.py defaults (batch 8, seq
#: 128, its Zipf corpus of 200,000 tokens): llama3.2-1b at full width and
#: depth in bf16 with remat, 10 steps; 3 with remat off
TRAIN_ARCH = "llama3.2-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_CORPUS_TOKENS = 8, 128, 200_000
TRAIN_STEPS = 10
TRAIN_REMAT_OFF_STEPS = 3
#: the recovery check: a checkpoint every 6 steps, a failure at step 8 (one
#: save, one restore)
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 6, 8
#: (a) reduced configs in float32, one train step on the card against the CPU
TRAIN_OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=50)
TRAIN_F32_TOL = 1e-4
PHASE12_DIR = Path(__file__).resolve().parent / "build" / "phase12"
#: phase 13: the recsys and GNN archs, float32 as repro's configs
RG_ARCHS = ("bst", "autoint", "two-tower-retrieval", "xdeepfm", "gin-tu")
#: (c) the largest model first: each is freed after its runs, so BST's
#: retrieval_cand (1M rows of attention) has the card to itself
RG_TIMED_ORDER = ("two-tower-retrieval", "xdeepfm", "autoint", "bst")
#: (b) full width: loss and gradient on the card against the host CPU
RG_CHECK_BATCH = 512
RG_F32_TOL = 1e-4
#: (c) warm runs after the cold one; their median is reported
RG_WARM = 3
#: H100 SXM dense float32 peak without tensor cores (launch/mesh.py's
#: hardware model); TF32 stays off
F32_FLOPS_PER_S = PEAK_FLOPS_F32
#: (d) GIN's dst-partitioned loss: gloo ranks sharing the card at
#: full_graph_sm; its loss against the one-device loss_fn's
RG_GLOO_RANKS = 4
RG_DIST_LOSS_TOL = 1e-5
PHASE13_DIR = Path(__file__).resolve().parent / "build" / "phase13"
#: phase 15: the dry run's records and logs, the two processes (one a
#: layout) that write them, and the cells they must give
PHASE15_DIR = Path(__file__).resolve().parent / "build" / "phase15"
DRYRUN_MESHES = ("single", "multi")
DRYRUN_CELLS, DRYRUN_SKIPS = 86, 8
#: (b) a dry run's peak over the card's for the same step, within this band
DRYRUN_PEAK_BAND = (0.5, 2.0)
#: (c) the paper's NYT cell, rank 0 of 256: its row of tokens and its job
NYT = paper_configs.SHAPES["nyt_lm"].dims
NYT_RANKS = 256


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def reset_peak() -> None:
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def device_peak() -> int:
    """Peak bytes allocated on the card since the last :func:`reset_peak`."""
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0


def wall_times(fn, sync, reps: int) -> list[float]:
    """Host seconds of each of ``reps`` calls of ``fn``, each ended by ``sync``."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append(time.perf_counter() - t0)
    return out


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_launches(fn, reps: int) -> dict[str, list[float]]:
    """Device microseconds of every kernel launch that ``reps`` calls of
    ``fn`` make (after a warm-up), by kernel name: torch.profiler's CUDA
    activity, so the wrapper's host time is left out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, list[float]] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
    return out


def kernel_ms(fn, kernel: str, reps: int = 10) -> float:
    """Mean device milliseconds of one launch of the ``__global__`` function
    ``kernel`` as ``fn`` makes it, by :func:`device_launches` over ``reps``
    calls.  The profiler can miss the first launches of its window: the mean
    is over the launches it saw, and None if it saw fewer than half, three
    times."""
    name = re.compile(rf"\b{kernel}\b")
    for _ in range(3):
        hits = [us for ev_name, times in device_launches(fn, reps).items()
                if name.search(ev_name) for us in times]
        if 2 * len(hits) >= reps:
            return sum(hits) / 1e3 / len(hits)
    print(f"kernel_ms: the profiler saw {len(hits)} launches of {kernel} in "
          f"{reps} calls, three times: not measured")
    return None


def queued_ms(fn, reps: int = 10, spin_cycles: int = 10_000_000) -> float:
    """Mean device milliseconds of one call of ``fn``, without the profiler:
    each call is enqueued behind a spin of ``spin_cycles`` clocks (about 5 ms
    at the H100's boost clock), between two CUDA events, so the events
    bracket the call's device work and not the host's launch of it."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def start_nvcc(source: Path, lib: Path, defines=()) -> subprocess.Popen:
    """Start compiling ``source`` (with ``-D`` each of ``defines``) into the
    shared library ``lib``, with the flags of ``kernels/build.py``."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, *(f"-D{d}" for d in defines),
         "-o", str(lib), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_nvcc(proc: subprocess.Popen, lib: Path) -> ctypes.CDLL:
    report = proc.communicate()[0]
    check(proc.returncode == 0, f"nvcc built {lib.name}:\n{report}")
    return ctypes.CDLL(str(lib))


def bsearch_levels() -> int:
    """D, the levels of the halving tree per round trip, as csrc/bsearch.cu
    is built."""
    src = (kbuild.CSRC / "bsearch.cu").read_text()
    return int(re.search(r"#define BSEARCH_LEVELS (\d+)", src).group(1))


def latency_floor(probe: ctypes.CDLL, n_words: int, dev) -> tuple:
    """(one dependent load round trip in us, an empty kernel's device ms), by
    ``scripts/latency_probe.cu``: one thread chasing a random cycle of
    ``n_words`` int64s (as large as the searched index, so it sits in L2),
    timed at two lengths; and a launch of nothing.  None where the profiler
    saw too few launches."""
    probe.chase_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_void_p, ctypes.c_void_p]
    probe.empty_launch.argtypes = [ctypes.c_void_p]
    perm = torch.randperm(n_words, device=dev)
    nxt = torch.empty(n_words, dtype=torch.int64, device=dev)
    nxt[perm] = perm.roll(-1)
    out = torch.empty(1, dtype=torch.int64, device=dev)

    def launch(err):
        check(err == 0, f"latency probe launched (cudaError {err})")

    def chase(hops):
        return lambda: launch(probe.chase_launch(nxt.data_ptr(), hops, out.data_ptr(),
                                                 torch.cuda.current_stream().cuda_stream))
    short, long_ = 1_000, 11_000
    t_short, t_long = (kernel_ms(chase(h), "chase_kernel") for h in (short, long_))
    l2_us = None if None in (t_short, t_long) else (t_long - t_short) * 1e3 / (long_ - short)
    empty = kernel_ms(lambda: launch(probe.empty_launch(torch.cuda.current_stream().cuda_stream)),
                      "empty_kernel", reps=50)
    return l2_us, empty


def max_abs_err(got, want) -> int:
    """Largest absolute difference over all outputs; shapes must agree."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(len(got) == len(want), "output count")
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def grams_matrix(gram_tuples, sigma):
    g = np.zeros((len(gram_tuples), sigma), np.int32)
    ln = np.zeros(len(gram_tuples), np.int32)
    for i, t in enumerate(gram_tuples):
        g[i, : len(t)] = t
        ln[i] = len(t)
    return g, ln


def row_keys(lengths: np.ndarray, grams: np.ndarray) -> np.ndarray:
    """[R] byte keys of (length | grams) rows whose order is the numeric order
    (big-endian, values >= 0), for exact host-side matching."""
    rows = np.concatenate([lengths[:, None], grams], axis=1).astype(">i4")
    return np.ascontiguousarray(rows).view(np.dtype((np.void, 4 * rows.shape[1])))[:, 0]


# --------------------------------------------------------------------- phase 2
def phase_oracle(dev) -> None:
    """Small corpora end to end on ``dev`` against the pure-Python oracle."""
    paper = np.asarray([1, 3, 2, 3, 3, 0, 2, 1, 3, 2, 3, 0, 3, 2, 1, 3, 2], np.int32)
    small = corpus.zipf_corpus(50_000, corpus.NYT, seed=1, duplicate_frac=0.05)
    for toks, sigma, tau, vocab, k_index in ((paper, 3, 3, 3, 4),
                                             (small, 4, 4, corpus.NYT.vocab_size, 2)):
        exp = oracle.ngram_counts(toks, sigma, tau)
        for method in METHODS:
            got = run_job(toks, NGramConfig(sigma=sigma, tau=tau, vocab_size=vocab,
                                            method=method, apriori_index_k=k_index),
                          device=dev)
            check(got.to_dict() == exp, f"{method} job == oracle ({len(exp)} grams)")
        stats = run_job(toks, NGramConfig(sigma=sigma, tau=tau, vocab_size=vocab),
                        device=dev)
        check(stats.to_dict() == exp, f"suffix_sigma job == oracle ({len(exp)} grams)")
        idx = build_index(stats, vocab_size=vocab, device=dev)
        grams = sorted(exp)
        g, ln = grams_matrix(grams, sigma)
        got = lookup(idx, g, ln).cpu().numpy()
        check(np.array_equal(got, [exp[t] for t in grams]), "lookup == oracle")
        rng = np.random.default_rng(2)
        pool = [t[:-1] for t in grams if len(t) >= 2]
        prefixes = [()] + [pool[i] for i in rng.choice(len(pool), 40)]
        pg, pl = grams_matrix(prefixes, sigma)
        nd, total, terms, counts = (x.cpu().numpy() for x in
                                    continuations(idx, pg, pl, k=4))
        for i, p in enumerate(prefixes):
            ext = {t[-1]: c for t, c in exp.items()
                   if len(t) == len(p) + 1 and t[:len(p)] == p}
            check(nd[i] == len(ext) and total[i] == sum(ext.values()),
                  f"continuation mass of {p}")
            check([int(c) for c in counts[i] if c] ==
                  sorted(ext.values(), reverse=True)[:4], f"top-4 of {p}")
            check(all(ext[int(t)] == int(c) for t, c in zip(terms[i], counts[i]) if c),
                  f"top-4 pairs of {p}")
        print(f"oracle: {len(toks)} tokens sigma={sigma} tau={tau}: "
              f"{len(exp)} grams; the four methods' jobs (APRIORI-INDEX K={k_index}), "
              "lookups and continuations equal the oracle")
    # the extensions: the 50k corpus with a year bucket a document (the same
    # stream) for the series, df and postings; 6k tokens for the maximal and
    # closed grams, whose oracle compares every pair of grams
    toks, years = corpus.zipf_corpus(50_000, corpus.NYT, seed=1, duplicate_frac=0.05,
                                     with_years=True)
    sigma, tau, vocab = 4, 4, corpus.NYT.vocab_size
    cfg = NGramConfig(sigma=sigma, tau=tau, vocab_size=vocab)
    got = run_job(toks, dataclasses.replace(cfg, n_buckets=N_BUCKETS), bucket_ids=years,
                  device=dev).to_series_dict()
    exp = oracle.ngram_series(toks, years, sigma, tau, N_BUCKETS)
    check(got.keys() == exp.keys() and all(np.array_equal(got[g], c) for g, c in exp.items()),
          f"series job == oracle ({len(exp)} grams x {N_BUCKETS} buckets)")
    exp = oracle.ngram_document_frequencies(toks, sigma, tau)
    check(aggregations.document_frequencies(toks, cfg, device=dev).to_dict() == exp
          and aggregations.df_suffix_lengths(toks, cfg, device=dev).to_dict() == exp,
          f"document frequencies (one job, and a job a length) == oracle ({len(exp)} grams)")
    exp = oracle.ngram_postings(toks, sigma, tau)
    check(aggregations.postings(toks, cfg, device=dev) == exp,
          f"postings == oracle ({len(exp)} grams)")
    small = corpus.zipf_corpus(6_000, corpus.NYT, seed=2, duplicate_frac=0.1)
    stats = run_job(small, cfg, device=dev)
    exp = oracle.ngram_counts(small, sigma, tau)
    check(stats.to_dict() == exp, "6k-token job == oracle")
    for mode, want in (("max", oracle.maximal_ngrams(exp)), ("closed", oracle.closed_ngrams(exp))):
        check(extensions_filter(stats, mode, device=dev).to_dict() == want,
              f"filter_stats {mode} == oracle ({len(want)} of {len(exp)} grams)")
    print(f"oracle: extensions on {len(toks)} tokens (sigma={sigma}, tau={tau}): the "
          f"{N_BUCKETS}-bucket series, document frequencies and postings; on "
          f"{len(small)} tokens the maximal and closed grams: all equal the oracle")


# --------------------------------------------------------------------- phase 3
def lookup_batch(stats, rng, n: int, vocab: int):
    """Half hits sampled from the job output, half misses or malformed."""
    sigma = stats.grams.shape[1]
    n_hit = n // 2
    rows = rng.integers(0, len(stats), n_hit)
    g_hit, l_hit = stats.grams[rows], stats.lengths[rows]
    l_miss = rng.integers(1, sigma + 1, n - n_hit).astype(np.int32)
    g_miss = rng.integers(1, vocab + 1, (n - n_hit, sigma)).astype(np.int32)
    g_miss *= np.arange(sigma)[None, :] < l_miss[:, None]
    bad = rng.random(n - n_hit) < 0.25             # malformed quarter of misses
    kind = rng.integers(0, 4, n - n_hit)
    l_miss[bad & (kind == 0)] = 0                               # empty gram
    l_miss[bad & (kind == 1)] = sigma + 1                       # too long
    g_miss[bad & (kind == 2), 0] = vocab + 1                    # out of vocab
    g_miss[bad & (kind == 3), 0] = -7                           # negative id
    g = np.concatenate([g_hit, g_miss]).astype(np.int32)
    ln = np.concatenate([l_hit, l_miss]).astype(np.int32)
    return g, ln, rows


def expected_lookups(stats, g, ln, vocab: int) -> np.ndarray:
    """Exact host answers: the stats' count of each well-formed query, else 0."""
    sigma = g.shape[1]
    in_len = np.arange(sigma)[None, :] < ln[:, None]
    ok = ((ln >= 1) & (ln <= sigma)
          & np.all(np.where(in_len, (g >= 1) & (g <= vocab), True), axis=1))
    keys = row_keys(stats.lengths, stats.grams)          # canonical order: sorted
    q = row_keys(np.where(ok, ln, 0), np.where(in_len & ok[:, None], g, 0))
    pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    found = ok & (keys[pos] == q)
    return np.where(found, stats.counts[pos], 0)


def check_continuations(stats, idx, pg, pl, out) -> None:
    """n_distinct and total against the stats grouped by prefix; each top-k
    (term, cf) pair against a point lookup of prefix + term."""
    nd, total, terms, counts = (x.cpu().numpy() for x in out)
    sigma = stats.grams.shape[1]
    parent = stats.grams * (np.arange(sigma)[None, :] < (stats.lengths - 1)[:, None])
    pkeys = row_keys(stats.lengths, parent)
    uniq, inv, n_per = np.unique(pkeys, return_inverse=True, return_counts=True)
    mass = np.bincount(inv.reshape(-1), weights=stats.counts, minlength=len(uniq))
    q = row_keys(pl + 1, pg)
    pos = np.minimum(np.searchsorted(uniq, q), len(uniq) - 1)
    found = uniq[pos] == q
    check(np.array_equal(nd, np.where(found, n_per[pos], 0)), "continuation n_distinct")
    check(np.array_equal(total, np.where(found, mass[pos], 0).astype(np.int64)),
          "continuation total mass")
    check(np.all(np.diff(counts, axis=1) <= 0), "top-k counts descending")
    check(np.array_equal((counts > 0).sum(axis=1), np.minimum(nd, terms.shape[1])),
          "top-k fill")
    qi, kj = np.nonzero(counts > 0)
    g = pg[qi].copy()
    g[np.arange(len(qi)), pl[qi]] = terms[qi, kj]
    got = lookup(idx, g, pl[qi] + 1).cpu().numpy()
    check(np.array_equal(got, counts[qi, kj]), "top-k pairs == point lookups")


def busy_union_ms(prof) -> float:
    """Milliseconds in which the card ran at least one kernel or copy: the
    union of the device events' [start, end) intervals over every stream
    (a sum counts the time twice where streams overlap)."""
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, covered = 0.0, float("-inf")
    for start, end in spans:
        if end > covered:
            busy_us += end - max(start, covered)
            covered = end
    return busy_us / 1e3


def profile_call(fn, label: str, what: str = "job") -> tuple[float, float]:
    """One more call of ``fn`` under ``torch.profiler``: device time by
    kernel, and the share of the wall time the card sat idle (no kernel or
    copy on any stream, :func:`busy_union_ms`); lines start with ``label``.
    Returns (wall ms, device busy ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy_ms = busy_union_ms(prof)
    print(f"{label}: {what} under torch.profiler {wall_ms:.1f} ms wall, device busy "
          f"{busy_ms:.1f} ms (kernels and copies summed over streams "
          f"{sum(by_name.values()):.1f} ms), idle share {1 - busy_ms / wall_ms:.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"{label}:   device {ms:9.3f} ms  {name[:90]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    for ev in host:
        print(f"{label}:   host {ev.self_cpu_time_total / 1e3:9.3f} ms self  "
              f"{ev.key[:60]} x{ev.count}")
    return wall_ms, busy_ms


def profile_job(tokens, cfg, dev, label: str = "profile") -> None:
    """One more run of the job under ``torch.profiler`` (:func:`profile_call`)."""
    if tokens.is_cuda:
        profile_call(lambda: run_job(tokens, cfg, device=dev), label)


def phase_main_path(dev, n_terms: int = MAIN_TERMS, corpora=None) -> dict:
    """The full-width slice through the entry points a user calls; the
    corpus from ``corpora`` (:class:`CorpusProcess`) if given."""
    vocab = corpus.NYT.vocab_size
    t0 = time.perf_counter()
    if corpora is not None and n_terms == MAIN_TERMS:
        st = corpora.wait("main")
        toks, made = st["toks"], (f"made in {float(st['gen_s']):.1f} s by the corpus "
                                  f"process (waited for {st['waited_s']:.1f} s)")
        del st
    else:
        toks = corpus.zipf_corpus(n_terms, corpus.NYT, seed=0, duplicate_frac=0.02)
        made = f"made in {time.perf_counter() - t0:.1f} s"
    tokens = torch.as_tensor(toks, device=dev)
    print(f"main: corpus of {n_terms} NYT-profile terms, {toks.size} positions "
          f"with PAD separators, {made}")
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab)
    sync = torch.cuda.synchronize if tokens.is_cuda else (lambda: None)
    if tokens.is_cuda:
        torch.cuda.reset_peak_memory_stats()
    sync()

    ops.launches.clear()
    t0 = time.perf_counter()
    stats = run_job(tokens, cfg, device=dev)            # cold: allocator grows
    job_cold_s = time.perf_counter() - t0
    job_s = wall_times(lambda: run_job(tokens, cfg, device=dev), sync, 5)
    job_peak = device_peak()
    tracer = trace.enable_tracing()
    again = run_job(tokens, cfg, device=dev)
    trace.disable_tracing()
    t0 = time.perf_counter()
    idx = build_index(stats, vocab_size=vocab, device=dev)
    sync()
    index_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    g, ln, hit_rows = lookup_batch(stats, rng, N_LOOKUPS, vocab)
    g_dev, ln_dev = torch.as_tensor(g, device=dev), torch.as_tensor(ln, device=dev)
    got = lookup(idx, g_dev, ln_dev)
    lookup_s = wall_times(lambda: lookup(idx, g_dev, ln_dev), sync, 20)

    p_rows = rng.integers(0, len(stats), N_PREFIXES)
    pl = np.minimum(stats.lengths[p_rows], rng.integers(0, SIGMA, N_PREFIXES)
                    ).astype(np.int32)
    pg = (stats.grams[p_rows] * (np.arange(SIGMA)[None, :] < pl[:, None])
          ).astype(np.int32)
    pg_dev, pl_dev = torch.as_tensor(pg, device=dev), torch.as_tensor(pl, device=dev)
    cont = continuations(idx, pg_dev, pl_dev, k=TOP_K)
    cont_s = wall_times(lambda: continuations(idx, pg_dev, pl_dev, k=TOP_K), sync, 20)
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() if tokens.is_cuda else 0

    # ---- checks ------------------------------------------------------------
    bc = np.bincount(toks, minlength=vocab + 1)
    want_terms = np.flatnonzero(bc[1:] >= TAU) + 1
    uni = stats.lengths == 1
    check(np.array_equal(stats.grams[uni, 0], want_terms)
          and np.array_equal(stats.counts[uni], bc[want_terms]),
          "unigram counts == bincount for every term with cf >= tau")
    got = got.cpu().numpy()
    check(np.array_equal(got[:len(hit_rows)], stats.counts[hit_rows]),
          "every sampled hit returns its NGramStats count")
    check(np.array_equal(got, expected_lookups(stats, g, ln, vocab)),
          "all 2**16 lookups == exact host answers")
    check_continuations(stats, idx, pg, pl, cont)
    check(all(np.array_equal(getattr(stats, f), getattr(again, f))
              for f in ("grams", "lengths", "counts"))
          and stats.counters == again.counters, "a repeated job gives the same output")

    profile_job(tokens, cfg, dev)

    spans: dict[str, float] = {}
    for ev in tracer.events:
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    n_real = int((toks != 0).sum())
    warm = float(np.median(job_s))
    print(f"main: job cold {job_cold_s:.3f} s; warm median {warm:.3f} s "
          f"(min {min(job_s):.3f}, max {max(job_s):.3f}, n={len(job_s)}) = "
          f"{n_real / warm:,.0f} terms/s ({toks.size / warm:,.0f} positions/s); "
          f"{len(stats)} n-grams (sigma={SIGMA}, tau={TAU}); counters {stats.counters}")
    print("main: spans of a traced warm run (ms, round.* synced) "
          + ", ".join(f"{k} {v:.1f}" for k, v in spans.items()))
    print(f"main: build_index {index_s:.3f} s, {idx.n_rows} rows in capacity "
          f"{idx.size}")
    for what, n_q, times in (("lookup", N_LOOKUPS, lookup_s),
                             (f"continuations k={TOP_K}", N_PREFIXES, cont_s)):
        med = float(np.median(times))
        print(f"main: {what}: batch of {n_q} median {med * 1e3:.3f} ms "
              f"(max {max(times) * 1e3:.3f}, n={len(times)}) = {n_q / med:,.0f} q/s")
    print(f"main: peak device memory {peak / 2**30:.2f} GiB (the jobs alone "
          f"{job_peak / 2**30:.2f} GiB); kernel launches {launches}")
    print("main: checks passed (unigrams == bincount, hits, misses/malformed, "
          "continuation mass and top-k pairs, repeated job)")
    return dict(tokens=tokens, toks=toks, n_terms=n_terms, stats=stats, idx=idx,
                queries=(g_dev, ln_dev), prefixes=(pg_dev, pl_dev),
                launches=launches, warm_s=warm)


# --------------------------------------------------------------------- phase 6
def naive_map_records(toks: np.ndarray, sigma: int) -> int:
    """``oracle.expected_map_records(toks, sigma, "naive")`` in closed form,
    vectorised: each position starts min(sigma, tokens from it to the next
    PAD) grams, and a PAD starts none."""
    pos = np.arange(toks.size)
    pad = np.flatnonzero(toks == 0)
    next_pad = np.append(pad, toks.size)[np.searchsorted(pad, pos)]
    return int(np.minimum(next_pad - pos, sigma).sum())


def phase_methods(dev, main: dict) -> dict:
    """NAIVE, APRIORI-SCAN and APRIORI-INDEX through ``run_job`` at phase 3's
    corpus and configuration, each held against phase 3's SUFFIX-sigma output."""
    vocab = corpus.NYT.vocab_size
    tokens, toks, want = main["tokens"], main["toks"], main["stats"]
    sync = torch.cuda.synchronize if tokens.is_cuda else (lambda: None)
    launches: dict[str, int] = {}
    counters, warm_s = {}, {}
    for method in METHODS:
        cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab, method=method,
                          apriori_index_k=APRIORI_INDEX_K)
        if tokens.is_cuda:
            torch.cuda.empty_cache()
        reset_peak()
        ops.launches.clear()
        t0 = time.perf_counter()
        stats = run_job(tokens, cfg, device=dev)
        sync()
        cold_s = time.perf_counter() - t0
        per_job = dict(ops.launches)
        warm = wall_times(lambda: run_job(tokens, cfg, device=dev), sync, 3)
        peak = device_peak()
        for name, n in ops.launches.items():
            launches[name] = launches.get(name, 0) + n
        tracer = trace.enable_tracing()
        run_job(tokens, cfg, device=dev)
        trace.disable_tracing()
        spans: dict[str, float] = {}
        for ev in tracer.events:
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
        c = stats.counters
        counters[method] = c
        warm_s[method] = float(np.median(warm))
        print(f"methods: {method}: jobs {c['jobs']}, map_records {c['map_records']:,}, "
              f"shuffle_records {c['shuffle_records']:,}, shuffle_bytes "
              f"{c['shuffle_bytes']:,}; job cold {cold_s:.3f} s, warm median "
              f"{np.median(warm):.3f} s (min {min(warm):.3f}, max {max(warm):.3f}, "
              f"n={len(warm)}); peak device memory {peak / 2**30:.2f} GiB; launches "
              f"a job: suffix_pack {per_job.get('suffix_pack', 0)}, hash_partition "
              f"{per_job.get('hash_partition', 0)}")
        print(f"methods: {method}: spans of a traced warm run (ms, synced) "
              + ", ".join(f"{k} {v:.1f}" for k, v in spans.items()))
        check(all(np.array_equal(getattr(stats, f), getattr(want, f))
                  for f in ("grams", "lengths", "counts")),
              f"{method} output == SUFFIX-sigma output ({len(want)} n-grams)")
        profile_job(tokens, cfg, dev, label=f"methods: {method}: profile")
        del stats
    closed = naive_map_records(toks, SIGMA)
    check(counters["naive"]["map_records"] == closed,
          f"NAIVE map_records == closed form ({closed:,})")
    check(counters["apriori_scan"]["map_records"] <= counters["naive"]["map_records"]
          and counters["apriori_scan"]["jobs"] <= SIGMA,
          "APRIORI-SCAN emits at most NAIVE's records in at most sigma jobs")
    print(f"methods: checks passed (each output == SUFFIX-sigma's, NAIVE map_records "
          f"== closed form {closed:,}, APRIORI-SCAN pruned); kernel launches {launches}")
    return dict(launches=launches, counters=counters, warm_s=warm_s)



# -------------------------------------------------------------------- phase 10
def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def rank_batches(mesh, sharded, g, ln, mode: str) -> tuple[np.ndarray, float]:
    """Every batch of ``RANK_BATCH`` queries through ``serve_queries``: the
    answers and the host seconds (the card synchronized by each batch's
    gather)."""
    from repro_torch.index import serve_queries
    out = []
    t0 = time.perf_counter()
    for i in range(0, len(g), RANK_BATCH):
        out.append(serve_queries(sharded, g[i:i + RANK_BATCH], ln[i:i + RANK_BATCH],
                                 mode=mode, k=TOP_K))
    return np.concatenate(out), time.perf_counter() - t0


def rank_index(mesh, stats, queries, layouts) -> dict:
    """The sharded index of ``stats`` in each layout, and ``queries``' answers
    (lookups, continuations) through it, on this rank."""
    from repro_torch.index import build_sharded_index
    from repro_torch.obs import metrics as obs_metrics
    g, ln, pg, pl = queries
    out = {}
    for layout in layouts:
        reg = obs_metrics.MetricsRegistry()
        obs_metrics.set_registry(reg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded = build_sharded_index(stats, vocab_size=corpus.NYT.vocab_size, mesh=mesh,
                                      compress=layout == "compressed", block_size=4,
                                      device=mesh.device)
        build_s = time.perf_counter() - t0
        sent0 = mesh.comm_bytes
        rank_batches(mesh, sharded, g[:RANK_BATCH], ln[:RANK_BATCH], "lookup")  # first
        look, look_s = rank_batches(mesh, sharded, g, ln, "lookup")
        cont, cont_s = rank_batches(mesh, sharded, pg, pl, "continuations")
        snap = reg.snapshot()["counters"] if mesh.rank == 0 else {}
        obs_metrics.set_registry(None)
        out[layout] = dict(
            build_s=build_s, lookup_s=look_s, cont_s=cont_s,
            sent=mesh.comm_bytes - sent0, nbytes=sharded.nbytes,
            retries=snap.get("serve.retries"), batches=snap.get("serve.batches"),
            digest=digest(look, cont),
            answers=(look, cont) if mesh.rank == 0 else None)
        del sharded
        torch.cuda.empty_cache()
    return out


def rank_reduce_scatter(mesh, n: int, reps: int = 2) -> dict:
    """Seconds of the reduce-scatter of an int32 [n] vector on this rank, in
    turns (gloo's own on the staged host copy, ``DataMesh.reduce_scatter``'s
    all-to-all of the blocks and a local sum, the same twice, gloo's): both
    must give the same answer."""
    import torch.distributed as dist
    # torch 2.13 names it ``reduce_scatter_single`` and deprecates the older name
    gloo_rs = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    g = torch.Generator().manual_seed(mesh.rank)
    t = torch.randint(0, 1000, (n,), generator=g, dtype=torch.int32).to(mesh.device)
    times: dict[str, list[float]] = {"gloo": [], "all_to_all": []}
    want = None
    for name in ("gloo", "all_to_all", "all_to_all", "gloo") * reps:
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "gloo":
            out = torch.empty(n // mesh.size, dtype=t.dtype)
            gloo_rs(out, t.cpu())
            out = out.to(mesh.device)
        else:
            out = mesh.reduce_scatter(t)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        want = out if want is None else want
        check(torch.equal(out, want), f"reduce-scatter {name} == gloo's")
    return times


def rank_turns(mesh, fn):
    """``fn()`` on each rank in turn (the others wait at a barrier), so the
    ranks' peaks of a memory-heavy step do not add up on the shared card."""
    import torch.distributed as dist
    out = None
    for turn in range(mesh.size):
        dist.barrier()
        if turn == mesh.rank:
            out = fn()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    dist.barrier()
    return out


def rank_waves(mesh, toks) -> dict:
    """Phase 10 (a) on one rank: SUFFIX-sigma with the fold thread and
    without, in turns (on, off, off, on, ...: a first run and three warm
    ones each), then APRIORI-SCAN (a first run and two warm ones), through
    the mesh waves at ``RANK_WAVE``."""
    vocab = corpus.NYT.vocab_size
    runs = [("SUFFIX-sigma", "suffix_sigma", True),
            ("SUFFIX-sigma, no fold thread", "suffix_sigma", False)]
    runs = runs + runs[::-1] + runs + runs[::-1] + [("APRIORI-SCAN", "apriori_scan", True)] * 3
    out: dict = {}
    for label, method, overlap in runs:
        cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab, method=method)
        if label not in out:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out[label] = dict(times=[], sent=[], comm_s=[], peak=0)
        r = out[label]
        b0, s0 = mesh.comm_bytes, mesh.comm_seconds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = WaveExecutor(cfg, wave_tokens=RANK_WAVE, mesh=mesh, overlap=overlap,
                             device=mesh.device).run(toks)
        torch.cuda.synchronize()
        r["times"].append(time.perf_counter() - t0)
        r["sent"].append(mesh.comm_bytes - b0)
        r["comm_s"].append(mesh.comm_seconds - s0)
        r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated())
        r.update(counters=dict(stats.counters),
                 digest=digest(stats.grams, stats.lengths, stats.counts),
                 stats=(stats.grams, stats.lengths, stats.counts) if mesh.rank == 0 else None)
        del stats
    for r in out.values():
        r.update(first=r["times"][0], warm=r["times"][1:], sent=r["sent"][1:],
                 comm_s=r["comm_s"][1:])
    return out


def rank_service(mesh, toks, queries) -> dict:
    """Phase 10 (b) and (c) on one rank: phase 5's service (hash combiner,
    compressed rungs, block size 4) with waves of ``RANK_WAVE`` across the
    ranks, fed phase 5's base and deltas; after each ingest the sharded
    generational index of its levels (``prev``: the last one); then the
    service's answers (continuations in turns, batches of ``RANK_BATCH``)
    and the sharded index's, in batches of ``RANK_BATCH``."""
    from repro_torch.index import shard_generational
    from repro_torch.obs import metrics as obs_metrics
    g, ln, pg, pl = queries
    base, rest = np.split(toks, [int(len(toks) * 0.6)])
    batches = [base] + np.array_split(rest, N_DELTAS)
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=corpus.NYT.vocab_size,
                      combine_route="hash")
    reg = obs_metrics.MetricsRegistry()
    if mesh.rank == 0:
        obs_metrics.set_registry(reg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    svc = StreamingNGramService(cfg, compress=True, block_size=4, wave_tokens=RANK_WAVE,
                                mesh=mesh, device=mesh.device)
    sharded, ingests = None, []
    for batch in batches:
        b0, s0 = mesh.comm_bytes, mesh.comm_seconds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = svc.ingest(batch)
        torch.cuda.synchronize()
        t_ingest = time.perf_counter() - t0
        t0 = time.perf_counter()
        sharded = shard_generational(svc.gen, mesh=mesh, prev=sharded)
        torch.cuda.synchronize()
        t_shard = time.perf_counter() - t0
        snap = reg.snapshot()["counters"]
        ingests.append(dict(
            positions=len(batch), s=t_ingest, job_s=rep["job_s"], waves=rep["waves"],
            merges=rep["merges"], rungs=rep["segment_rows"], shard_s=t_shard,
            segments=sharded.n_segments, sent=mesh.comm_bytes - b0,
            comm_s=mesh.comm_seconds - s0, builds=snap.get("serve.shard_builds"),
            reuses=snap.get("serve.shard_reuses")))
    ingest_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    look = svc.lookup(g, ln)
    look_s = time.perf_counter() - t0

    def service_continuations():
        t0 = time.perf_counter()
        rows = np.concatenate([svc.continuations(pg[i:i + RANK_BATCH], pl[i:i + RANK_BATCH],
                                                 k=TOP_K)
                               for i in range(0, len(pg), RANK_BATCH)])
        return rows, time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    cont, cont_s, cont_peak = rank_turns(mesh, service_continuations)
    torch.cuda.reset_peak_memory_stats()
    sent0 = mesh.comm_bytes
    sh_look, sh_look_s = rank_batches(mesh, sharded, g, ln, "lookup")
    sh_cont, sh_cont_s = rank_batches(mesh, sharded, pg, pl, "continuations")
    obs_metrics.set_registry(None)
    return dict(ingests=ingests, ingest_peak=ingest_peak, look_s=look_s, cont_s=cont_s,
                cont_peak=cont_peak, sh_look_s=sh_look_s, sh_cont_s=sh_cont_s,
                sh_sent=mesh.comm_bytes - sent0, sh_peak=torch.cuda.max_memory_allocated(),
                sh_segments=sharded.n_segments, gen=repr(svc.gen),
                digest=digest(look, cont, sh_look, sh_cont),
                answers=(look, cont, sh_look, sh_cont) if mesh.rank == 0 else None)


def rank_main(mesh, toks_path: str, stats_path: str, queries) -> dict:
    """Phase 10 on one rank: the four methods, the sharded index, the mesh
    waves, the service across ranks and its sharded generational index,
    with this rank's kernel launches counted from the start, then the two
    reduce-scatters at APRIORI-INDEX's totals."""
    from repro_torch.pipeline import stages as pstages
    ops.launches.clear()
    toks = np.load(toks_path, mmap_mode="r")          # each rank reads its own rows
    vocab = corpus.NYT.vocab_size
    out = {"methods": {}, "rank": mesh.rank, "device": str(mesh.device),
           "backend": mesh.backend}
    for method in ("suffix_sigma",) + METHODS:
        cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab, method=method,
                          apriori_index_k=APRIORI_INDEX_K)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = run_job(toks, cfg, mesh, device=mesh.device)
        cold = time.perf_counter() - t0
        warm, sent, comm_s = [], [], []
        for _ in range(3 if cold < 8.0 else 1):
            b0, s0 = mesh.comm_bytes, mesh.comm_seconds
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = run_job(toks, cfg, mesh, device=mesh.device)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
            sent.append(mesh.comm_bytes - b0)
            comm_s.append(mesh.comm_seconds - s0)
        canon = pstages.canonical_stats(stats)
        out["methods"][method] = dict(
            cold=cold, warm=warm, sent=sent, comm_s=comm_s,
            peak=torch.cuda.max_memory_allocated(), counters=dict(stats.counters),
            same_again=digest(stats.grams, stats.lengths, stats.counts)
            == digest(again.grams, again.lengths, again.counts),
            digest=digest(canon.grams, canon.lengths, canon.counts),
            stats=(canon.grams, canon.lengths, canon.counts) if mesh.rank == 0 else None)
        del stats, again, canon
    st = np.load(stats_path)
    stats = NGramStats(st["grams"], st["lengths"], st["counts"])
    out["index"] = rank_index(mesh, stats, queries, ("flat", "compressed"))
    del stats
    out["waves"] = rank_waves(mesh, toks)
    out["service"] = rank_service(mesh, toks, queries)
    out["launches"] = dict(ops.launches)
    out["reduce_scatter"] = rank_reduce_scatter(mesh, mesh.size * -(-len(toks)
                                                                  // mesh.size))
    return out


def rank_nccl(mesh, stats_path: str, queries) -> dict:
    """The flat sharded index on one rank under NCCL."""
    ops.launches.clear()
    st = np.load(stats_path)
    stats = NGramStats(st["grams"], st["lengths"], st["counts"])
    out = rank_index(mesh, stats, queries, ("flat",))["flat"]
    out["backend"] = mesh.backend
    out["launches"] = dict(ops.launches)
    return out


def phase_ranks(dev, main: dict, methods: dict, stream: dict, wave: dict) -> dict:
    """The multi-rank paths: the four methods, the sharded index, the mesh
    waves, the service across ranks and its sharded generational index on
    ``N_RANKS`` gloo ranks sharing the card, the flat sharded index on one
    NCCL rank, each held against the single-device output of phase 3, 5, 6
    or 8."""
    t_phase = time.perf_counter()
    vocab = corpus.NYT.vocab_size
    want = main["stats"]
    PHASE10_DIR.mkdir(parents=True, exist_ok=True)
    toks_path, stats_path = PHASE10_DIR / "tokens.npy", PHASE10_DIR / "stats.npz"
    np.save(toks_path, main["toks"])
    np.savez(stats_path, grams=want.grams, lengths=want.lengths, counts=want.counts)
    g, ln = (t.cpu().numpy() for t in main["queries"])
    pg, pl = (t.cpu().numpy() for t in main["prefixes"])
    pg = np.concatenate([pg, np.zeros((N_EMPTY, SIGMA), pg.dtype)])
    pl = np.concatenate([pl, np.zeros(N_EMPTY, pl.dtype)])
    queries = (g, ln, pg, pl)

    # the single-device answers
    idx = main["idx"]
    want_look = lookup(idx, torch.as_tensor(g, device=dev),
                       torch.as_tensor(ln, device=dev)).cpu().numpy()
    nd, tot, terms, counts = continuations(idx, torch.as_tensor(pg, device=dev),
                                           torch.as_tensor(pl, device=dev), k=TOP_K)
    want_cont = torch.cat([nd[:, None], tot[:, None], terms, counts], 1).cpu().numpy()
    # phase 5's service: every batch ingested (and compacted since, which
    # changes no answer)
    svc5 = stream["svc"]
    want_svc = (svc5.lookup(g, ln), np.concatenate([
        svc5.continuations(pg[i:i + RANK_BATCH], pl[i:i + RANK_BATCH], k=TOP_K)
        for i in range(0, len(pg), RANK_BATCH)]))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = spawn_ranks(N_RANKS, rank_main, str(toks_path), str(stats_path), queries,
                        device=dev, backend="gloo")
    spawn_s = time.perf_counter() - t0
    lead = ranks[0]
    check([r["backend"] for r in ranks] == ["gloo"] * N_RANKS
          and all(r["device"].startswith("cuda") for r in ranks),
          f"{N_RANKS} gloo ranks on the card")
    single_counters = {"suffix_sigma": want.counters, **methods["counters"]}
    single_warm = {"suffix_sigma": main["warm_s"], **methods["warm_s"]}
    for method, m in lead["methods"].items():
        grams, lengths, cnts = m["stats"]
        check(np.array_equal(grams, want.grams) and np.array_equal(lengths, want.lengths)
              and np.array_equal(cnts, want.counts),
              f"ranks: {method} on {N_RANKS} ranks == phase 3's stats ({len(want):,} n-grams)")
        check(all(r["methods"][method]["digest"] == m["digest"] for r in ranks),
              f"ranks: {method}: every rank returns the same output")
        check(all(r["methods"][method]["same_again"] for r in ranks),
              f"ranks: {method}: a repeated run gives the same output")
        c = m["counters"]
        check(c["map_records"] == single_counters[method]["map_records"],
              f"ranks: {method} map_records == the single-device job's")
        check(c["overflow"] == 0, f"ranks: {method} overflow 0")
        w = [x["methods"][method] for x in ranks]
        print(f"ranks: {method} on {N_RANKS} gloo ranks ({card_line()}): cold "
              f"{m['cold']:.3f} s, warm median {np.median(m['warm']):.3f} s (max over "
              f"ranks {max(np.median(x['warm']) for x in w):.3f}, n={len(m['warm'])}) "
              f"vs one device warm median {single_warm[method]:.3f} s; counters {c}; "
              f"capacity {c.get('capacity', 'n/a')}, retries {c.get('retries', 'n/a')}, "
              f"shuffle_records {int(c['shuffle_records']):,}; bytes sent a rank "
              f"(warm run) {[int(np.median(x['sent'])) for x in w]}, seconds in "
              f"collectives a rank {[round(float(np.median(x['comm_s'])), 3) for x in w]}; "
              f"peak device memory a rank (GiB) {[round(x['peak'] / 2**30, 2) for x in w]}")
    for layout, ix in lead["index"].items():
        look, cont = ix["answers"]
        check(np.array_equal(look, want_look),
              f"ranks: {layout} sharded index: {len(g):,} lookups == one device")
        check(np.array_equal(cont, want_cont),
              f"ranks: {layout} sharded index: {len(pg):,} continuations "
              f"({N_EMPTY} of length 0) == one device")
        check(all(r["index"][layout]["digest"] == ix["digest"] for r in ranks),
              f"ranks: {layout}: every rank returns the same answers")
        print(f"ranks: {layout} sharded index on {N_RANKS} gloo ranks ({card_line()}): "
              f"built in {ix['build_s']:.3f} s ({ix['nbytes']:,} bytes in all); "
              f"{len(g):,} lookups in {ix['lookup_s']:.3f} s = "
              f"{len(g) / ix['lookup_s']:,.0f} lookups/s, {len(pg):,} continuations "
              f"in {ix['cont_s']:.3f} s = {len(pg) / ix['cont_s']:,.0f}/s, batches of "
              f"{RANK_BATCH}; serve.batches {ix['batches']}, serve.retries "
              f"{ix['retries']}; bytes sent a rank "
              f"{[r['index'][layout]['sent'] for r in ranks]}")

    # (a) the mesh waves against phases 3, 6 and 8
    for label, w in lead["waves"].items():
        suffix = label.startswith("SUFFIX")
        one = wave["runs"][("SUFFIX-sigma" if suffix else "apriori_scan")
                           + f", {wave_label(RANK_WAVE)}"]
        grams, lengths, cnts = w["stats"]
        check(np.array_equal(grams, want.grams) and np.array_equal(lengths, want.lengths)
              and np.array_equal(cnts, want.counts),
              f"ranks: mesh waves, {label}: output == phase 3's (and phase 6's) stats")
        check(all(r["waves"][label]["digest"] == w["digest"] for r in ranks),
              f"ranks: mesh waves, {label}: every rank returns the same output")
        c = w["counters"]
        single = one["counters"]
        # APRIORI-SCAN's waves emit at tau 1: phase 8's records, not phase 6's
        check(c["map_records"] == (want.counters if suffix else single)["map_records"],
              f"ranks: mesh waves, {label}: map_records == phase {3 if suffix else 8}'s")
        for key in ("jobs", "waves", "fold_rows"):
            check(c[key] == single[key], f"ranks: mesh waves, {label}: {key} == phase 8's")
        ws = [r["waves"][label] for r in ranks]
        print(f"ranks: mesh waves, {label}, waves of 2**{RANK_WAVE.bit_length() - 1} on "
              f"{N_RANKS} gloo ranks ({card_line()}): first {w['first']:.3f} s, warm median "
              f"{np.median(w['warm']):.3f} s (max over ranks "
              f"{max(np.median(x['warm']) for x in ws):.3f}, n={len(w['warm'])}) vs one "
              f"device's waves warm median {one['warm_s']:.3f} s; retries {c['retries']}, "
              f"fold_rows {c['fold_rows']:,}, shuffle_records {c['shuffle_records']:,}; "
              f"counters {c}; bytes sent a rank (warm) "
              f"{[int(np.median(x['sent'])) for x in ws]}, seconds in collectives a rank "
              f"{[round(float(np.median(x['comm_s'])), 3) for x in ws]}; peak device "
              f"memory a rank (GiB) {[round(x['peak'] / 2**30, 2) for x in ws]}")
    on, off = (lead["waves"][k] for k in ("SUFFIX-sigma", "SUFFIX-sigma, no fold thread"))
    print(f"ranks: mesh waves, the fold thread across {N_RANKS} ranks ({card_line()}), "
          f"runs in turns: warm median {np.median(on['warm']):.3f} s with it "
          f"{[round(t, 3) for t in on['warm']]}, {np.median(off['warm']):.3f} s without "
          f"{[round(t, 3) for t in off['warm']]} (first {on['first']:.3f} / "
          f"{off['first']:.3f} s)")

    # (b) the service across ranks and (c) its sharded generational index
    sv = lead["service"]
    look, cont, sh_look, sh_cont = sv["answers"]
    check(np.array_equal(look, want_svc[0]) and np.array_equal(cont, want_svc[1]),
          f"ranks: service across {N_RANKS} ranks: {len(g):,} lookups and {len(pg):,} "
          "continuations == phase 5's service")
    check(np.array_equal(sh_look, want_svc[0]) and np.array_equal(sh_cont, want_svc[1]),
          f"ranks: sharded generational index: {len(g):,} lookups and {len(pg):,} "
          f"continuations ({N_EMPTY} of length 0) == phase 5's service")
    check(all(r["service"]["digest"] == sv["digest"] for r in ranks),
          "ranks: service and sharded generational index: every rank answers the same")
    for step, ing in enumerate(sv["ingests"]):
        label = "base" if step == 0 else f"delta {step}"
        print(f"ranks: service, {label}: {ing['positions']:,} positions in {ing['waves']} "
              f"waves across {N_RANKS} gloo ranks ({card_line()}): ingest {ing['s']:.3f} s "
              f"(job {ing['job_s']:.3f} s), merges {ing['merges']}, rungs {ing['rungs']}; "
              f"shard_generational {ing['shard_s']:.3f} s, {ing['segments']} segments, "
              f"builds {ing['builds']} reuses {ing['reuses']} (rank 0, running totals); "
              f"bytes sent a rank {[r['service']['ingests'][step]['sent'] for r in ranks]}, "
              f"seconds in collectives a rank "
              f"{[round(r['service']['ingests'][step]['comm_s'], 3) for r in ranks]}")
    svs = [r["service"] for r in ranks]
    print(f"ranks: service across {N_RANKS} ranks ({card_line()}): {sv['gen']}; "
          f"{len(g):,} lookups in {sv['look_s']:.3f} s, {len(pg):,} continuations in "
          f"{sv['cont_s']:.3f} s (batches of {RANK_BATCH}, rank by rank); sharded "
          f"generational index: {len(g):,} lookups in {sv['sh_look_s']:.3f} s = "
          f"{len(g) / sv['sh_look_s']:,.0f}/s, {len(pg):,} continuations in "
          f"{sv['sh_cont_s']:.3f} s = {len(pg) / sv['sh_cont_s']:,.0f}/s over "
          f"{sv['sh_segments']} segments; bytes sent a rank "
          f"{[x['sh_sent'] for x in svs]}; peak device memory a rank (GiB): ingests "
          f"{[round(x['ingest_peak'] / 2**30, 2) for x in svs]}, service continuations "
          f"{[round(x['cont_peak'] / 2**30, 2) for x in svs]}, sharded queries "
          f"{[round(x['sh_peak'] / 2**30, 2) for x in svs]}")

    n_totals = N_RANKS * -(-len(main["toks"]) // N_RANKS)
    print(f"ranks: reduce-scatter of int32 [{n_totals:,}] (APRIORI-INDEX's totals) "
          f"on {N_RANKS} gloo ranks ({card_line()}), in turns, median s a rank: "
          + "; ".join(f"{name} {[round(float(np.median(r['reduce_scatter'][name])), 4) for r in ranks]}"
                      for name in ("gloo", "all_to_all")))
    t0 = time.perf_counter()
    (one,) = spawn_ranks(1, rank_nccl, str(stats_path), queries, device=dev,
                         backend="nccl")
    nccl_s = time.perf_counter() - t0
    look, cont = one["answers"]
    check(one["backend"] == "nccl", "the one-rank index runs under NCCL")
    check(np.array_equal(look, want_look) and np.array_equal(cont, want_cont),
          "ranks: flat sharded index on 1 NCCL rank == one device")
    print(f"ranks: flat sharded index on 1 NCCL rank ({card_line()}): {len(g):,} "
          f"lookups in {one['lookup_s']:.3f} s = {len(g) / one['lookup_s']:,.0f} "
          f"lookups/s, {len(pg):,} continuations in {one['cont_s']:.3f} s; "
          f"serve.retries {one['retries']}; launches {one['launches']}")

    launches = collections.Counter()
    for r in ranks + [one]:
        launches.update(r["launches"])
    missing = [k for k in RANK_KERNELS if all(r["launches"].get(k, 0) == 0
                                                for r in ranks)]
    check(not missing, f"the ranks launched every kernel of their path (missing {missing})")
    for path in (toks_path, stats_path):
        path.unlink()
    print(f"ranks: {N_RANKS} ranks spawned and joined in {spawn_s:.1f} s, the NCCL "
          f"rank in {nccl_s:.1f} s; kernel launches in the ranks {dict(launches)}; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    print("ranks: checks passed (four methods == one device on every rank, map_records, "
          "sharded flat and compressed answers == one device, mesh waves == phases 3, 6 "
          "and 8, the service and its sharded generational index == phase 5's service, "
          "NCCL rank, launches)")
    return dict(launches=dict(launches))


# --------------------------------------------------------------------- phase 5
def prefix_batch(stats, rng, n: int):
    """Prefixes (len 0..sigma-1) of job-output rows, as phase 3 draws them."""
    sigma = stats.grams.shape[1]
    rows = rng.integers(0, len(stats), n)
    pl = np.minimum(stats.lengths[rows], rng.integers(0, sigma, n)).astype(np.int32)
    pg = (stats.grams[rows] * (np.arange(sigma)[None, :] < pl[:, None])).astype(np.int32)
    return pg, pl


def expected_continuations(stats, pg, pl, k: int) -> np.ndarray:
    """Exact host answers [Q, 2+2k] (n_distinct | total | top-k terms | cfs):
    the stats grouped by (length, prefix), ranked cf desc, next term asc."""
    sigma = stats.grams.shape[1]
    r = len(stats)
    parent = stats.grams * (np.arange(sigma)[None, :] < (stats.lengths - 1)[:, None])
    uniq, inv, n_per = np.unique(row_keys(stats.lengths, parent),
                                 return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    last = stats.grams[np.arange(r), stats.lengths - 1].astype(np.int64)
    counts = stats.counts.astype(np.int64)
    order = np.lexsort((last, -counts, inv))
    start = np.concatenate([[0], np.cumsum(n_per)[:-1]])
    mass = np.bincount(inv, weights=counts, minlength=len(uniq)).astype(np.int64)
    q = row_keys(pl + 1, pg)
    pos = np.minimum(np.searchsorted(uniq, q), len(uniq) - 1)
    found = uniq[pos] == q
    nd = np.where(found, n_per[pos], 0)
    offs = start[pos][:, None] + np.arange(k)[None, :]
    in_group = np.arange(k)[None, :] < nd[:, None]
    safe = order[np.minimum(offs, r - 1)]
    terms = np.where(in_group, last[safe], 0)
    cfs = np.where(in_group, counts[safe], 0)
    return np.concatenate([nd[:, None], np.where(found, mass[pos], 0)[:, None],
                           terms, cfs], axis=1)


def flat_bytes_u32(ix) -> int:
    """Bytes of the flat layout of ``ix``'s rows with uint32 lanes and counts
    (``repro``'s flat index): the reference of the at-rest ratio."""
    size, sigma, n_l = ix.size, ix.sigma, ix.n_lanes
    cells = sigma * (ix.n_fanout + 1)
    return 4 * (size * (1 + n_l) + size + (sigma + 1) + cells + size * n_l
                + 2 * size + cells + size + 1)


def union_of(batches: list) -> NGramStats:
    """Dedup-summed union of job outputs in canonical order (host numpy)."""
    return stages.canonical_stats(NGramStats(
        np.concatenate([b.grams for b in batches]),
        np.concatenate([b.lengths for b in batches]),
        np.concatenate([b.counts for b in batches])))


def profile_ingest(svc, tokens) -> dict:
    """One ingest under ``torch.profiler``: device time by kernel and the
    share of the wall time the card sat idle (:func:`busy_union_ms`)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = svc.ingest(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault(ev.name, [0.0, 0])
            acc[0] += ev.time_range.elapsed_us() / 1e3
            acc[1] += 1
    busy_ms = busy_union_ms(prof)
    print(f"stream: profiled ingest {wall_ms:.1f} ms wall (job {rep['job_s'] * 1e3:.1f} ms, "
          f"ingest {rep['ingest_s'] * 1e3:.1f} ms, merges {rep['merges']}), device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}; "
          f"{sum(k for _, k in by_name.values())} device launches")
    top = sorted(by_name, key=lambda name: -by_name[name][0])[:10]
    top += [name for name in by_name if "hash_combine" in name and name not in top]
    for name in top:                    # the ten longest, and the combine stage's
        ms, k = by_name[name]
        print(f"stream:   device {ms:9.3f} ms x{k:<3d} {name[:90]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    for ev in host:
        print(f"stream:   host {ev.self_cpu_time_total / 1e3:9.3f} ms self  "
              f"{ev.key[:60]} x{ev.count}")
    return rep


def phase_streaming(dev, main: dict) -> dict:
    """Streaming ingest into a compressed generational index, at full width."""
    vocab = corpus.NYT.vocab_size
    toks = main["toks"]
    base, rest = np.split(toks, [int(len(toks) * 0.6)])
    batches = [base] + np.array_split(rest, N_DELTAS)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    # the reference: each batch's job output on the sort-route combiner
    ref_cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab)
    ref_stats = [run_job(b, ref_cfg, device=dev) for b in batches]
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab, combine_route="hash")
    # default construction: the port's default route is "merge" (the card)
    svc = StreamingNGramService(cfg, compress=True, block_size=4, device=dev)
    check(svc.gen.route == "merge", "a default service compacts on the merge route")
    rng = np.random.default_rng(5)
    reset_peak()
    peak = 0
    tracer = trace.enable_tracing()
    ops.launches.clear()
    for step, batch in enumerate(batches):
        label = "base" if step == 0 else f"delta {step}"
        if step == len(batches) - 1 and dev.type == "cuda":
            rep = profile_ingest(svc, batch)
        else:
            rep = svc.ingest(batch)
        sync()
        union = union_of(ref_stats[:step + 1])
        levels = svc.gen.segments                    # materialize every rung
        kinds = ["compressed" if isinstance(ix, CompressedNGramIndex) else "flat"
                 for ix in levels]
        at_rest = svc.gen.nbytes_at_rest
        flat = sum(flat_bytes_u32(ix) for ix in levels)
        at_rest_u32 = sum(ix.nbytes_at_rest if isinstance(ix, CompressedNGramIndex)
                          else flat_bytes_u32(ix) for ix in levels)
        print(f"stream: {label}: {len(batch)} positions, job {rep['job_s']:.3f} s, "
              f"ingest {rep['ingest_s']:.3f} s, merges {rep['merges']}, rungs "
              f"{rep['segment_rows']} ({', '.join(kinds)}); bytes at rest "
              f"{at_rest_u32:,} (flat rungs in uint32 lanes) vs {flat:,} all flat "
              f"= {flat / at_rest_u32:.3f}x smaller; resident {svc.gen.nbytes:,} "
              f"(port, int64 flat lanes; at rest as stored {at_rest:,})")
        g, ln, _ = lookup_batch(union, rng, N_LOOKUPS, vocab)
        t0 = time.perf_counter()
        got = svc.lookup(g, ln)
        t_svc = time.perf_counter() - t0
        check(np.array_equal(got, expected_lookups(union, g, ln, vocab)),
              f"{label}: 2**16 service lookups == union")
        h0, m0 = svc.cache.hits, svc.cache.misses
        check(np.array_equal(svc.lookup(g, ln), got) and svc.cache.misses == m0
              and svc.cache.hits == h0 + len(g), f"{label}: repeat served from cache")
        pg, pl = prefix_batch(union, rng, N_PREFIXES)
        t0 = time.perf_counter()
        rows = svc.continuations(pg, pl, k=TOP_K)
        t_svc_c = time.perf_counter() - t0
        check(np.array_equal(rows, expected_continuations(union, pg, pl, TOP_K)),
              f"{label}: 2**14 service continuations == union")
        # the generational index alone, device tensors in and out
        g_dev, ln_dev = torch.as_tensor(g, device=dev), torch.as_tensor(ln, device=dev)
        pg_dev, pl_dev = torch.as_tensor(pg, device=dev), torch.as_tensor(pl, device=dev)
        lk = wall_times(lambda: lookup(svc.gen, g_dev, ln_dev), sync, 5)
        peak = max(peak, device_peak())
        reset_peak()
        held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        ct = wall_times(lambda: continuations(svc.gen, pg_dev, pl_dev, k=TOP_K), sync, 5)
        cont_peak = device_peak()
        peak = max(peak, cont_peak)
        print(f"stream: {label}: service {N_LOOKUPS / t_svc:,.0f} lookups/s and "
              f"{N_PREFIXES / t_svc_c:,.0f} continuations/s cold (host cache "
              f"included); generational index {N_LOOKUPS / np.median(lk):,.0f} "
              f"lookups/s, {N_PREFIXES / np.median(ct):,.0f} continuations/s "
              f"(median of 5 batches); checks passed")
        print(f"stream: {label}: continuations of {N_PREFIXES} prefixes over "
              f"{len(levels)} rungs: peak device memory {cont_peak / 2**30:.2f} GiB "
              f"({(cont_peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} "
              f"GiB held before the call)")

    compact_inputs = list(reversed(svc.gen.levels))   # elder first, as merged
    t0 = time.perf_counter()
    svc.gen.compact_all()
    sync()
    t_compact = time.perf_counter() - t0
    trace.disable_tracing()
    launches = dict(ops.launches)
    peak = max(peak, device_peak())
    union = union_of(ref_stats)
    (final,) = svc.gen.segments
    check(isinstance(final, CompressedNGramIndex), "the compacted rung is compressed")
    t0 = time.perf_counter()
    flat_direct = build_index(union, vocab_size=vocab, device=dev)
    sync()
    t_flat = time.perf_counter() - t0
    t0 = time.perf_counter()
    direct = compress_index(flat_direct, block_size=4, device=dev)
    sync()
    t_compress = time.perf_counter() - t0
    for f in ("heads", "lcps", "payload", "block_base", "counts_packed",
              "cont_heads", "cont_lcps", "cont_payload", "cont_block_base",
              "cont_last_packed", "cont_counts_packed", "sec_cache",
              "cumsum_cache", "fan_cache", "cont_fan_cache"):
        check(torch.equal(getattr(final, f), getattr(direct, f)),
              f"compacted rung {f} == compress_index(build_index(union))")
    g, ln, _ = lookup_batch(union, rng, N_LOOKUPS, vocab)
    check(np.array_equal(svc.lookup(g, ln), expected_lookups(union, g, ln, vocab)),
          "lookups after compact_all == union")
    pg, pl = prefix_batch(union, rng, N_PREFIXES)
    check(np.array_equal(svc.continuations(pg, pl, k=TOP_K),
                         expected_continuations(union, pg, pl, TOP_K)),
          "continuations after compact_all == union")
    spans: dict[str, list] = {}
    for ev in tracer.events:
        acc = spans.setdefault(ev["name"], [0, 0.0])
        acc[0] += 1
        acc[1] += ev["dur"] / 1e3
    print(f"stream: compact_all {t_compact:.3f} s -> one compressed rung of "
          f"{final.n_rows} rows, equal to a direct compressed build of the union; "
          f"at rest {final.nbytes_at_rest:,} bytes vs {flat_bytes_u32(final):,} flat "
          f"(uint32) = {flat_bytes_u32(final) / final.nbytes_at_rest:.3f}x")
    print(f"stream: direct build of the union: build_index {t_flat:.3f} s (device), "
          f"compress_index {t_compress:.3f} s (torch build on the card)")
    print("stream: spans (count, ms) " + ", ".join(
        f"{k} {n} {ms:.1f}" for k, (n, ms) in sorted(spans.items())))
    decode_ms = [ev["dur"] / 1e3 for ev in tracer.events if ev["name"] == "compress.decode"]
    n_decodes = len(decode_ms)
    print(f"stream: block_expand launches {launches.get('block_expand', 0)} for "
          f"{n_decodes} compressed-rung decodes (compress.decode spans, ms: "
          + ", ".join(f"{ms:.2f}" for ms in decode_ms) + ")")
    if dev.type == "cuda":
        check(launches.get("block_expand", 0) == n_decodes,
              "one block_expand launch per compressed-rung decode")
    print(f"stream: peak device memory {peak / 2**30:.2f} GiB; kernel launches {launches}")
    return dict(svc=svc, final=final, union=union, base_tokens=base, batches=batches,
                compact_inputs=compact_inputs, launches=launches)


# --------------------------------------------------------------------- phase 7
def drive(label: str, fn, dev, warm: int = 3, prefix: str = "ext"):
    """``fn`` on the card: one cold call, ``warm`` more, one under
    torch.profiler.  Prints cold and warm seconds, peak device memory over
    the calls (and what was held before them), device busy ms, idle share
    and the kernel launches of one call, on lines that start with
    ``prefix``; returns (the cold call's result, a dict of those numbers)."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reset_peak()
    held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    before = dict(ops.launches)
    t0 = time.perf_counter()
    out = fn()
    sync()
    cold = time.perf_counter() - t0
    per_call = {k: v - before.get(k, 0) for k, v in ops.launches.items()
                if v != before.get(k, 0)}
    times = wall_times(fn, sync, warm)
    peak = device_peak()
    wall_ms, busy_ms = (profile_call(fn, f"{prefix}: {label}: profile", "call")
                        if dev.type == "cuda" else (float("nan"), float("nan")))
    print(f"{prefix}: {label}: cold {cold:.3f} s; warm median {np.median(times):.3f} s (min "
          f"{min(times):.3f}, max {max(times):.3f}, n={len(times)}); peak device memory "
          f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held before); device busy "
          f"{busy_ms:.1f} ms of {wall_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}); "
          f"launches a call {per_call}")
    return out, dict(cold_s=cold, warm_s=float(np.median(times)), peak=peak, held=held,
                     busy_ms=busy_ms, wall_ms=wall_ms)


def same_rows(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("grams", "lengths", "counts"))


def phase_extensions(dev, main: dict, corpora, split_terms: int | None = None) -> dict:
    """The paper's extensions at full width: the time-series job on both
    combine routes, maximal / closed filtering and document frequencies on
    phase 3's corpus and output; the two-phase sigma split against the
    whole sigma-40 job at ``split_terms`` (phase 3's corpus unless given);
    postings at POSTINGS_TERMS.  The corpus with years comes from
    ``corpora`` (:class:`CorpusProcess`)."""
    vocab = corpus.NYT.vocab_size
    n_l = pack.n_lanes(SIGMA, vocab)
    st = corpora.wait("ext")
    toks, years = st["toks"], st["years"]
    check(np.array_equal(toks, main["toks"]), "the corpus with years is phase 3's stream")
    tokens, want = main["tokens"], main["stats"]
    years_dev = torch.as_tensor(years, device=dev)
    print(f"ext: phase 3's corpus with a year bucket a document ({N_BUCKETS} buckets), "
          f"made in {float(st['gen_s']):.1f} s by the corpus process (waited for "
          f"{st['waited_s']:.1f} s)")
    del st
    ops.launches.clear()

    # time series (SSVI-B): repro's ngram --series deployment
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab, n_buckets=N_BUCKETS)
    series, _ = drive("series job (sort route)",
                      lambda: run_job(tokens, cfg, bucket_ids=years_dev, device=dev), dev)
    c, w = series.counters, want.counters
    check(np.array_equal(series.grams, want.grams)
          and np.array_equal(series.lengths, want.lengths),
          f"series rows == phase 3's SUFFIX-sigma rows ({len(want)})")
    check(series.counts.shape == (len(want), N_BUCKETS)
          and np.array_equal(series.counts.sum(axis=1), want.counts),
          "every series sums to phase 3's count")
    check(c["map_records"] == w["map_records"], "series map_records == phase 3's")
    check(c["shuffle_records"] >= w["shuffle_records"],
          "series shuffle_records >= phase 3's (the combiner keeps buckets apart)")
    check(c["shuffle_bytes"] == c["shuffle_records"] * 4 * (n_l + 2),
          "series shuffle_bytes == shuffle_records x (n_lanes + 2) uint32 words")
    print(f"ext: series counters {c} (phase 3: map_records {w['map_records']:,}, "
          f"shuffle_records {w['shuffle_records']:,}, shuffle_bytes {w['shuffle_bytes']:,})")
    hcfg = dataclasses.replace(cfg, combine_route="hash")
    hseries, _ = drive("series job (hash route)",
                       lambda: run_job(tokens, hcfg, bucket_ids=years_dev, device=dev), dev)
    check(same_rows(hseries, series), "hash-route series == sort-route series")
    print(f"ext: hash-route series counters {hseries.counters}")
    del hseries

    # maximal and closed n-grams (SSVI-A) of phase 3's output
    filtered = {}
    for mode in ("max", "closed"):
        got, _ = drive(f"filter_stats {mode}",
                       lambda mode=mode: extensions_filter(want, mode, device=dev), dev)
        t0 = time.perf_counter()
        on_cpu = extensions_filter(want, mode, device="cpu")
        cpu_s = time.perf_counter() - t0
        check(same_rows(got, on_cpu) and got.counters == on_cpu.counters,
              f"filter_stats {mode} on the card == device='cpu'")
        print(f"ext: filter_stats {mode}: {len(got):,} of {len(want):,} grams; the same "
              f"call with device='cpu' {cpu_s:.3f} s (host)")
        filtered[mode] = got
    check(np.isin(row_keys(filtered["max"].lengths, filtered["max"].grams),
                  row_keys(filtered["closed"].lengths, filtered["closed"].grams)).all(),
          "maximal grams are closed")

    # document frequencies (SSII): one job, and one job a length
    pcfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab)
    df, _ = drive("document_frequencies",
                  lambda: aggregations.document_frequencies(tokens, pcfg, device=dev), dev)
    dfl, _ = drive("df_suffix_lengths",
                   lambda: aggregations.df_suffix_lengths(tokens, pcfg, device=dev), dev,
                   warm=1)
    df = stages.canonical_stats(df)
    check(same_rows(df, stages.canonical_stats(dfl)),
          "document_frequencies == df_suffix_lengths")
    keys = row_keys(want.lengths, want.grams)
    q = row_keys(df.lengths, df.grams)
    pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    check(np.array_equal(keys[pos], q), "df's grams are phase 3's grams")
    check(np.all(df.counts <= want.counts[pos]), "df <= cf")
    print(f"ext: df: {len(df):,} grams with df >= {TAU} (of {len(want):,} with cf >= "
          f"{TAU}); counters {df.counters}, per length {dfl.counters}")
    del df, dfl

    # the two-phase sigma split at the text-analytics case, against the job
    split_tokens = (tokens if split_terms in (None, main["n_terms"]) else torch.as_tensor(
        corpus.zipf_corpus(split_terms, corpus.NYT, seed=0, duplicate_frac=0.02),
        device=dev))
    scfg = NGramConfig(sigma=SPLIT_SIGMA, tau=SPLIT_TAU, vocab_size=vocab)
    full, _ = drive(f"SUFFIX-sigma sigma={SPLIT_SIGMA} (the reference)",
                    lambda: run_job(split_tokens, scfg, device=dev), dev, warm=1)
    split, _ = drive(f"sigma_split head {SPLIT_HEAD}, survivors 1/{round(1 / SPLIT_FRAC)}",
                     lambda: suffix_sigma.sigma_split(split_tokens, scfg, SPLIT_HEAD,
                                                      SPLIT_FRAC, device=dev), dev, warm=1)
    # with no frequent head, the split is phase A's output, grams sigma_head wide
    split = stages.canonical_stats(NGramStats(
        np.pad(split.grams, ((0, 0), (0, SPLIT_SIGMA - split.grams.shape[1]))),
        split.lengths, split.counts, split.counters))
    check(same_rows(split, full),
          f"sigma_split == the sigma-{SPLIT_SIGMA} job ({len(full):,} grams)")
    n = split_tokens.shape[0]
    survivors = split.counters.get("phase_b_records", 0)
    print(f"ext: sigma_split at {n:,} positions: {int(survivors):,} "
          f"survivors ({survivors / n:.5f} of the positions; buffer "
          f"{max(64, int(n * SPLIT_FRAC)):,}); {len(full):,} grams, "
          f"{int((full.lengths > SPLIT_HEAD).sum()):,} longer than {SPLIT_HEAD}; counters "
          f"{split.counters}")
    del full, split

    # postings (SSVI-B's inverted index), at POSTINGS_TERMS: the host dict
    ptoks = torch.as_tensor(corpus.zipf_corpus(POSTINGS_TERMS, corpus.NYT, seed=0,
                                               duplicate_frac=0.02), device=dev)
    post, _ = drive(f"postings at {POSTINGS_TERMS} terms",
                    lambda: aggregations.postings(ptoks, pcfg, device=dev), dev, warm=1)
    cf = run_job(ptoks, pcfg, device=dev).to_dict()
    check({g: sum(p.values()) for g, p in post.items()} == cf,
          f"postings marginalize to cf ({len(cf):,} grams)")
    print(f"ext: postings: {len(post):,} grams, {sum(map(len, post.values())):,} "
          "(gram, document) pairs")

    launches = dict(ops.launches)
    print(f"ext: checks passed; kernel launches {launches}")
    return dict(launches=launches, years=years_dev, split_tokens=split_tokens)


# --------------------------------------------------------------------- phase 8
#: phase 8: wave sizes on phase 3's corpus (None: one wave, the corpus); the
#: corpus past what one NAIVE job can hold, and the waves each method takes there
WAVE_SIZES = (None, 1 << 25, 1 << 23, 1 << 21)
BIG_TERMS = 1 << 27
BIG_WAVES = {"suffix_sigma": 1 << 24, "naive": 1 << 23}
N_PIPELINED = 8


def wave_label(wave) -> str:
    return "one wave" if wave is None else f"waves of 2**{wave.bit_length() - 1}"


@contextlib.contextmanager
def counted(into: collections.Counter):
    """Add the kernel launches made inside the block to ``into``."""
    before = collections.Counter(ops.launches)
    try:
        yield
    finally:
        into.update(ops.launches - before)


@contextlib.contextmanager
def captured_merges(min_rows: int):
    """While active, ``ops.merge_path`` records every merge's (m, n) in
    ``shapes``, and of the merges of at least ``min_rows`` rows in all
    copies to the host the inputs (a keys, b keys, a counts, b counts) of
    the largest so far (m + n) and of the widest (the largest diagonal
    window, min(m, n)); ``copy_s`` is the time the copies took.  Yields
    that dict."""
    inner = ops.merge_path
    out = dict(shapes=[], largest=None, widest=None, copy_s=0.0)
    size = {"largest": lambda m, n: m + n, "widest": min}

    def recording(ak, bk, av, bv):
        m, n = ak.shape[0], bk.shape[0]
        out["shapes"].append((m, n))
        beat = [k for k, f in size.items() if m + n >= min_rows and (
            out[k] is None or f(m, n) > f(out[k][0].shape[0], out[k][1].shape[0]))]
        if beat:
            t0 = time.perf_counter()
            host = tuple(t.cpu() for t in (ak, bk, av, bv))
            out["copy_s"] += time.perf_counter() - t0
            out.update(dict.fromkeys(beat, host))
        return inner(ak, bk, av, bv)

    ops.merge_path = recording
    try:
        yield out
    finally:
        ops.merge_path = inner


def phase_waves(dev, main: dict, stream: dict, corpora) -> dict:
    """The wave engine at full width.  On phase 3's corpus: SUFFIX-sigma at
    four wave sizes, the tiered and pairwise folds, the sort route, the hash
    combiner and the fold without its thread, and the three other methods,
    each equal to phase 3's output; ``run_streaming`` against a flat index of
    the monolithic tau = 1 job; the wave service against phase 5's.  Then
    BIG_TERMS: SUFFIX-sigma and NAIVE in waves against the monolithic
    SUFFIX-sigma job there (its corpus from ``corpora``).  ``launches``
    counts the wave entry points' launches only: the references (the monolithic jobs, the flat index,
    ``compress_index``, phase 5's service) are left out."""
    vocab = corpus.NYT.vocab_size
    toks, tokens, want = main["toks"], main["tokens"], main["stats"]
    n = toks.size
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab)
    runs: dict[str, dict] = {}
    launches: collections.Counter = collections.Counter()

    def waves(label: str, c: NGramConfig, wave, **kw):
        ex = WaveExecutor(c, wave_tokens=wave, device=dev, **kw)
        with counted(launches):
            out, nums = drive(label, lambda: ex.run(toks), dev, prefix="waves")
        n_waves = 1 if wave is None else -(-n // wave)
        check(same_rows(out, want), f"{label}: output == phase 3's ({len(want):,} n-grams)")
        check(out.counters["waves"] == n_waves, f"{label}: {n_waves} waves")
        print(f"waves: {label}: {n_waves} waves; counters {out.counters}")
        runs[label] = dict(nums, counters=out.counters)
        return out

    for wave in WAVE_SIZES:
        out = waves(f"SUFFIX-sigma, {wave_label(wave)}", cfg, wave)
        check(out.counters["map_records"] == want.counters["map_records"],
              f"{wave_label(wave)}: map_records == phase 3's")
    mid, small = WAVE_SIZES[2], WAVE_SIZES[3]
    for acc in ("tiered", "pairwise"):
        waves(f"SUFFIX-sigma, {wave_label(small)}, {acc} fold", cfg, small, accumulator=acc)
    waves(f"SUFFIX-sigma, {wave_label(mid)}, sort route", cfg, mid, merge_route="sort")
    waves(f"SUFFIX-sigma, {wave_label(mid)}, hash combiner",
          dataclasses.replace(cfg, combine_route="hash"), mid)
    waves(f"SUFFIX-sigma, {wave_label(mid)}, no fold thread", cfg, mid, overlap=False)
    for method in METHODS:
        waves(f"{method}, {wave_label(mid)}", NGramConfig(
            sigma=SIGMA, tau=TAU, vocab_size=vocab, method=method,
            apriori_index_k=APRIORI_INDEX_K), mid)

    # run_streaming into compressed rungs, against a flat index of one
    # monolithic tau = 1 job: its rows straight from run_plan's rounds, as
    # build_index sorts them on the card (the job's host canonical sort of
    # every tau = 1 row would add minutes and change no index)
    cfg1 = NGramConfig(sigma=SIGMA, tau=1, vocab_size=vocab)
    rng = np.random.default_rng(8)
    t0 = time.perf_counter()
    rows1 = pipeline_executor._run_rounds(tokens, None, n, cfg1, plan_for(cfg1), 1, {})
    flat = build_index(rows1, vocab_size=vocab, device=dev)
    sync()
    t_flat = time.perf_counter() - t0
    g, ln, _ = lookup_batch(rows1, rng, N_LOOKUPS, vocab)
    pg, pl = prefix_batch(rows1, rng, N_PREFIXES)
    g_dev, ln_dev = torch.as_tensor(g, device=dev), torch.as_tensor(ln, device=dev)
    pg_dev, pl_dev = torch.as_tensor(pg, device=dev), torch.as_tensor(pl, device=dev)
    want_l = lookup(flat, g_dev, ln_dev)
    want_c = continuations(flat, pg_dev, pl_dev, k=TOP_K)
    t0 = time.perf_counter()
    direct = compress_index(flat, block_size=4, device=dev)
    sync()
    t_direct = time.perf_counter() - t0
    del flat
    torch.cuda.empty_cache()
    reset_peak()
    with counted(launches):
        t0 = time.perf_counter()
        gen, reports = WaveExecutor(cfg1, wave_tokens=mid, device=dev).run_streaming(
            toks, compress=True)
        sync()
        t_stream = time.perf_counter() - t0
        stream_peak = device_peak()
        got_l = lookup(gen, g_dev, ln_dev)
        got_c = continuations(gen, pg_dev, pl_dev, k=TOP_K)
    check(len(reports) == -(-n // mid), "run_streaming: one ingest a wave")
    check(torch.equal(got_l, want_l),
          "run_streaming: 2**16 lookups == the flat index of the tau = 1 job")
    check(all(torch.equal(a, b) for a, b in zip(got_c, want_c)),
          "run_streaming: 2**14 top-8 continuations == the flat index's")
    rungs = [ix.n_rows for ix in gen.levels]
    query_peak = device_peak()
    with counted(launches):
        t0 = time.perf_counter()
        gen.compact_all()
        (rung,) = gen.segments
        sync()
        t_compact = time.perf_counter() - t0
    check(isinstance(rung, CompressedNGramIndex), "run_streaming: compact_all's rung is compressed")
    for f in ("heads", "lcps", "payload", "block_base", "counts_packed",
              "cont_heads", "cont_lcps", "cont_payload", "cont_block_base",
              "cont_last_packed", "cont_counts_packed", "sec_cache",
              "cumsum_cache", "fan_cache", "cont_fan_cache"):
        check(torch.equal(getattr(rung, f), getattr(direct, f)),
              f"run_streaming: compact_all's {f} == compress_index(build_index(tau = 1 job))")
    print(f"waves: run_streaming at {wave_label(mid)}, tau 1: {len(reports)} ingests, rungs "
          f"{rungs} before compact_all, {t_stream:.3f} s (peak device memory "
          f"{stream_peak / 2**30:.2f} GiB; queries over the rungs {query_peak / 2**30:.2f} "
          f"GiB); compact_all {t_compact:.3f} s -> {rung.n_rows:,} rows, equal to "
          f"compress_index(build_index(...)) of the monolithic tau = 1 job's "
          f"{len(rows1):,} rows (rows + flat index {t_flat:.3f} s, compress_index "
          f"{t_direct:.3f} s); lookups and continuations equal the flat index's")
    del gen, rung, direct, rows1, want_l, want_c, got_l, got_c
    torch.cuda.empty_cache()

    # the wave service against phase 5's: the same base and deltas
    scfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab, combine_route="hash")
    union, ref_svc = stream["union"], stream["svc"]
    g, ln, _ = lookup_batch(union, rng, N_LOOKUPS, vocab)
    pg, pl = prefix_batch(union, rng, N_PREFIXES)
    m = N_LOOKUPS // N_PIPELINED
    batches = [lookup_batch(union, rng, m, vocab)[:2] for _ in range(N_PIPELINED)]
    fresh = [lookup_batch(union, rng, m, vocab)[:2] for _ in range(N_PIPELINED)]
    with counted(launches):
        svc = StreamingNGramService(scfg, compress=True, block_size=4, wave_tokens=mid,
                                    device=dev)
        reports = [svc.ingest(b) for b in stream["batches"]]
        got = svc.lookup(g, ln)
        got_c = svc.continuations(pg, pl, k=TOP_K)
        t0 = time.perf_counter()
        piped = svc.lookup_pipelined(batches)
        t_piped = time.perf_counter() - t0
        t0 = time.perf_counter()
        for bg, bl in fresh:
            svc.lookup(bg, bl)
        t_seq = time.perf_counter() - t0
    print(f"waves: service with {wave_label(mid)}: ingests of " + ", ".join(
        f"{r['waves']} waves in {r['job_s']:.3f} s" for r in reports))
    check(np.array_equal(got, ref_svc.lookup(g, ln))
          and np.array_equal(got, expected_lookups(union, g, ln, vocab)),
          "wave service: 2**16 lookups == phase 5's service == the union")
    check(np.array_equal(got_c, ref_svc.continuations(pg, pl, k=TOP_K)),
          "wave service: 2**14 continuations == phase 5's service")
    check(len(piped) == N_PIPELINED and all(
        np.array_equal(a, ref_svc.lookup(bg, bl)) for (bg, bl), a in zip(batches, piped)),
        f"wave service: lookup_pipelined over {N_PIPELINED} batches == lookup, batch by batch")
    print(f"waves: service lookups of {N_PIPELINED} batches of {m} (cold cache): "
          f"pipelined {t_piped:.4f} s, one by one {t_seq:.4f} s; checks passed")
    del svc
    torch.cuda.empty_cache()

    # past what one NAIVE job can hold: the monolithic SUFFIX-sigma job is
    # the reference; SUFFIX-sigma and NAIVE run in waves.  The SUFFIX-sigma
    # run's fold hands its largest and widest merges of BIG_TERMS rows or
    # more to phase 4.
    st = corpora.wait("big")
    big = st["toks"]
    print(f"waves: corpus of {BIG_TERMS} NYT-profile terms, {big.size:,} positions, "
          f"made in {float(st['gen_s']):.1f} s by the corpus process (waited for "
          f"{st['waited_s']:.1f} s)")
    del st
    big_dev = torch.as_tensor(big, device=dev)
    reset_peak()
    t0 = time.perf_counter()
    ref = run_job(big_dev, cfg, device=dev)
    sync()
    mono_s, mono_peak = time.perf_counter() - t0, device_peak()
    del big_dev
    torch.cuda.empty_cache()
    print(f"waves: {BIG_TERMS} terms: the monolithic SUFFIX-sigma job {mono_s:.3f} s (cold), peak "
          f"device memory {mono_peak / 2**30:.2f} GiB; {len(ref):,} n-grams")
    big_peaks, fold = {}, None
    for method, wave in BIG_WAVES.items():
        c = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab, method=method)
        torch.cuda.empty_cache()
        reset_peak()
        held = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        with (captured_merges(BIG_TERMS) if fold is None else contextlib.nullcontext()) as cap, \
                counted(launches):
            t0 = time.perf_counter()
            out = WaveExecutor(c, wave_tokens=wave, device=dev).run(big)
            sync()
            secs, big_peaks[method] = time.perf_counter() - t0, device_peak()
        fold = fold or cap
        copy_s = cap["copy_s"] if cap is not None else 0.0
        check(same_rows(out, ref), f"{BIG_TERMS} terms: {method} in {wave_label(wave)} == "
              "the monolithic SUFFIX-sigma job")
        print(f"waves: {BIG_TERMS} terms: {method} in {wave_label(wave)}: {out.counters['waves']} "
              f"waves, {secs - copy_s:.3f} s (cold"
              + (f"; {secs:.3f} s with {copy_s:.3f} s of copying two merges' inputs to the "
                 "host for phase 4" if cap is not None else "")
              + f"), peak device memory {big_peaks[method] / 2**30:.2f} GiB "
              f"({held / 2**30:.2f} GiB held before); fold_rows {out.counters['fold_rows']:,}; "
              "equal to the monolithic job")
        del out
    check(dev.type != "cuda" or big_peaks["suffix_sigma"] < mono_peak,
          f"{BIG_TERMS} terms: the SUFFIX-sigma wave run peaks below the monolithic job")
    print(f"waves: {BIG_TERMS} terms, the SUFFIX-sigma fold's merges (m, n): {fold['shapes']}")
    check(fold["largest"] is not None, f"the fold merged {BIG_TERMS} rows or more at once")
    launches = dict(launches)
    print(f"waves: checks passed; kernel launches of the wave entry points {launches}")
    return dict(launches=launches, fold=fold, runs=runs)


# --------------------------------------------------------------------- phase 9
#: phase 9: the closed-loop load on the frontend (``repro``'s
#: ``benchmarks/frontend.py`` protocol at phase 5's corpus)
FE_CLIENTS = 16
FE_LOOKUP_BATCH = 64                     # grams a /v1/lookup body
FE_TOPK, FE_TOPK_REPEATS = 1 << 12, 1 << 10
FE_SSE, FE_SSE_STEPS = 64, 8
FE_DEADLINE_S = 0.002
SHED_BUDGET, SHED_CLIENTS, SHED_EACH, SHED_K = 64, 256, 2, 7
#: the kernels of the frontend's path: the ingests' job and compactions, and
#: the queries' searches (``block_expand`` launches once per compressed-rung
#: decode, checked against the ``compress.decode`` spans)
FE_KERNELS = ("suffix_pack", "hash_partition", "lcp_boundary", "hash_combine",
              "merge_path", "bsearch", "block_decode")
CLI_SERVE_TOKENS, CLI_WAVE_TOKENS = 1 << 23, 1 << 21
REPLAY_BATCHES = 40


def http_post(conn, path: str, body: dict, headers: dict | None = None):
    """(status, body text) of one POST on a kept-alive connection."""
    conn.request("POST", path, body=json.dumps(body),
                 headers={"Content-Type": "application/json", **(headers or {})})
    r = conn.getresponse()
    return r.status, r.read().decode()


def closed_loop(addr, jobs: list, n_clients: int, headers: dict | None = None,
                start=None) -> list:
    """Each job (path, body) POSTed by ``n_clients`` threads, each sending its
    next job when its last answer is in: (status, text, seconds) per job.
    ``start`` (a barrier) releases the threads together.  A client error
    propagates to the caller.

    Connections open one at a time, each confirmed by a ``/healthz`` round
    trip before the next opens: the server listens with the standard
    library's backlog of 5, and a burst of simultaneous connects past it is
    reset.  An SSE stream ends its connection, so its client opens the next
    one the same way (outside the timed request)."""
    import http.client
    import threading
    out: list = [None] * len(jobs)
    nxt = iter(range(len(jobs)))
    lock, connecting = threading.Lock(), threading.Lock()
    errors: list = []

    def open_conn():
        with connecting:
            conn = http.client.HTTPConnection(*addr, timeout=120)
            conn.request("GET", "/healthz")
            check(conn.getresponse().read() == b'{"status": "ok"}', "the server is up")
        return conn

    def client():
        try:
            conn = open_conn()
            if start is not None:
                start.wait()
            while True:
                with lock:
                    i = next(nxt, None)
                if i is None:
                    break
                path, body = jobs[i]
                t0 = time.perf_counter()
                status, text = http_post(conn, path, body, headers)
                out[i] = (status, text, time.perf_counter() - t0)
                if path == "/v1/complete":       # the server closed the stream
                    conn.close()
                    conn = open_conn()
            conn.close()
        except BaseException as e:               # re-raised on the caller's thread
            errors.append(e)
            raise

    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "every client thread finished")
    if errors:
        raise errors[0]
    return out


def topk_json(row, k: int, generation: int) -> dict:
    """``/v1/topk``'s body for one expected [2+2k] row."""
    return {"n_distinct": int(row[0]), "total": int(row[1]),
            "terms": [int(t) for t in row[2:2 + k]],
            "counts": [int(c) for c in row[2 + k:2 + 2 * k]], "generation": generation}


def greedy_events(answer, prefixes: list, steps: int, k: int) -> list:
    """The SSE events of each prefix's greedy completion over a window of
    the last sigma - 1 terms, from ``answer(pg, pl)`` -> [Q, 2+2k] rows: one
    batch a step for every stream still going."""
    events = [[] for _ in prefixes]
    ctx = [list(p) for p in prefixes]
    live = list(range(len(prefixes)))
    for step in range(steps):
        pg = np.zeros((len(live), SIGMA), np.int32)
        pl = np.zeros((len(live),), np.int32)
        for j, i in enumerate(live):
            w = ctx[i][-(SIGMA - 1):]
            pg[j, :len(w)] = w
            pl[j] = len(w)
        rows = answer(pg, pl)
        going = []
        for j, i in enumerate(live):
            term, count = int(rows[j][2]), int(rows[j][2 + k])
            if count:
                events[i].append({"step": step, "term": term, "count": count})
                ctx[i].append(term)
                going.append(i)
        live = going
        if not live:
            break
    return events


def sse_events(text: str) -> list:
    data = [ln[6:] for ln in text.split("\n") if ln.startswith("data: ")]
    check(data[-1] == "[DONE]", "an SSE stream ends with [DONE]")
    return [json.loads(d) for d in data[:-1]]


def run_cli(args: list, log: Path) -> subprocess.Popen:
    """Start ``python -m <args>`` from the repository, output to ``log``."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    return subprocess.Popen([sys.executable, "-m", *args], cwd=root, env=env,
                            stdout=log.open("w"), stderr=subprocess.STDOUT)


def phase_frontend(dev, main: dict, stream: dict) -> dict:
    """The serving tier at full width: phase 5's service behind
    ``QueryFrontend`` and ``serve_http``, under a closed-loop HTTP load, then
    a shedding burst, the registry and trace checks, and both CLIs."""
    import threading
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import report as obs_report
    from repro_torch.serve import AdmissionController, LRUQueryCache, QueryFrontend, serve_http
    vocab = corpus.NYT.vocab_size
    union = stream["union"]
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.set_registry(reg)
    tracer = trace.enable_tracing()
    ops.launches.clear()                                   # the phase's own path
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab, combine_route="hash")
    svc = StreamingNGramService(cfg, compress=True, block_size=4, route="merge", device=dev)
    t0 = time.perf_counter()
    for batch in stream["batches"]:
        svc.ingest(batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    levels = svc.gen.segments                              # what the queries read
    kinds = ["compressed" if isinstance(ix, CompressedNGramIndex) else "flat"
             for ix in levels]
    print(f"frontend: service on phase 5's {len(stream['batches'])} batches in "
          f"{t_ingest:.3f} s: rungs {list(svc.gen.level_rows)} ({', '.join(kinds)}), "
          f"generation {svc.gen.generation}")
    check("compressed" in kinds and "flat" in kinds, "queries cross compressed and flat rungs")
    gen_id = svc.gen.generation

    # the load: 2**16 lookups in bodies of 64, 2**12 top-8 queries (a quarter
    # repeating one just before it, so it is in flight), 64 SSE streams
    rng = np.random.default_rng(9)
    g, ln, _ = lookup_batch(union, rng, N_LOOKUPS, vocab)
    want_lk = expected_lookups(union, g, ln, vocab)
    lk_jobs = [("/v1/lookup", {"grams": [g[j, :min(int(ln[j]), SIGMA)].tolist()
                                         for j in range(i, i + FE_LOOKUP_BATCH)],
                               "lengths": ln[i:i + FE_LOOKUP_BATCH].tolist()})
               for i in range(0, N_LOOKUPS, FE_LOOKUP_BATCH)]
    pg, pl = prefix_batch(union, rng, FE_TOPK - FE_TOPK_REPEATS)
    order = list(range(len(pg)))
    for src in rng.choice(len(pg), FE_TOPK_REPEATS, replace=False):
        order.insert(order.index(int(src)) + 1, int(src))
    want_tk = expected_continuations(union, pg, pl, TOP_K)
    tk_jobs = [("/v1/topk", {"prefix": pg[i, :pl[i]].tolist(), "k": TOP_K}) for i in order]
    sse_rows = rng.integers(0, len(union), FE_SSE)
    sse_prefix = [union.grams[r, :1].tolist() for r in sse_rows]
    sse_jobs = [("/v1/complete", {"prefix": p, "steps": FE_SSE_STEPS, "k": TOP_K})
                for p in sse_prefix]
    kinds = rng.permutation(np.repeat([0, 1, 2], [len(lk_jobs), len(tk_jobs), len(sse_jobs)]))
    queues = [iter(lk_jobs), iter(tk_jobs), iter(sse_jobs)]
    jobs = [next(queues[k]) for k in kinds]
    where = [np.flatnonzero(kinds == k) for k in range(3)]

    fe = QueryFrontend(svc, deadline_s=FE_DEADLINE_S)
    srv = serve_http(fe, "127.0.0.1", 0, block=False)
    reset_peak()
    before = ops.launches.copy()
    t0 = time.perf_counter()
    res = closed_loop(srv.server_address, jobs, FE_CLIENTS)
    wall = time.perf_counter() - t0
    query_launches = ops.launches - before
    srv.shutdown()
    srv.server_close()
    fe.close()
    peak = device_peak()
    batch_stats = fe.batcher.stats()
    n_load_spans = len(tracer.events)

    # ---- checks: every answer exact --------------------------------------
    check(all(r[0] == 200 for r in res), "every load request answered 200")
    got = np.concatenate([json.loads(res[i][1])["counts"] for i in where[0]])
    check(np.array_equal(got, want_lk), "all 2**16 frontend lookups == union")
    check(all(json.loads(res[i][1])["generation"] == gen_id for i in where[0]),
          "lookup bodies carry the service's generation")
    check(all(json.loads(res[i][1]) == topk_json(want_tk[j], TOP_K, gen_id)
              for i, j in zip(where[1], order)), "all 2**12 frontend top-k == union")
    n_events = sum(len(sse_events(res[i][1])) for i in where[2])

    # ---- shedding: a burst of cold top-k at batch priority ----------------
    adm = AdmissionController(queue_budget=SHED_BUDGET)
    fe2 = QueryFrontend(svc, admission=adm, deadline_s=FE_DEADLINE_S)
    srv2 = serve_http(fe2, "127.0.0.1", 0, block=False)
    n_shed = SHED_CLIENTS * SHED_EACH
    spg, spl = prefix_batch(union, np.random.default_rng(10), n_shed)
    want_shed = expected_continuations(union, spg, spl, SHED_K)
    shed_jobs = [("/v1/topk", {"prefix": spg[i, :spl[i]].tolist(), "k": SHED_K})
                 for i in range(n_shed)]
    before = ops.launches.copy()
    res2 = closed_loop(srv2.server_address, shed_jobs, SHED_CLIENTS,
                       headers={"X-Priority": "batch"},
                       start=threading.Barrier(SHED_CLIENTS))
    query_launches += ops.launches - before
    srv2.shutdown()
    srv2.server_close()
    fe2.close()
    codes = collections.Counter(r[0] for r in res2)
    check(set(codes) <= {200, 503}, f"burst answers are 200 or 503 ({dict(codes)})")
    check(codes[503] > 0, f"the burst past queue_budget={SHED_BUDGET} shed ({dict(codes)})")
    check(all(json.loads(r[1]) == topk_json(want_shed[i], SHED_K, gen_id)
              for i, r in enumerate(res2) if r[0] == 200),
          f"every admitted burst answer == union ({codes[200]})")
    launches = dict(ops.launches)
    trace.disable_tracing()

    # ---- the load's batch shapes again, one thread, nothing else running:
    # the median live slots of each kind's flushes, padded to its bucket as
    # the batcher pads, on a cold cache (an upper bound on the load's work)
    from repro_torch.serve.batcher import select_bucket
    flushes: dict[str, list] = {}
    for e in tracer.events[:n_load_spans]:
        if e["name"] == "serve.flush":
            flushes.setdefault(e["args"]["kind"], []).append(e)
    replay = {}
    live_cache = svc.cache
    for kind, src_g, src_l in (("lookup", g, ln), ("topk", pg, pl)):
        m = int(np.median([e["args"]["live"] for e in flushes[kind]]))
        bucket = select_bucket(m, fe.batcher.buckets)
        svc.cache = LRUQueryCache()
        times = []
        for i in range(0, REPLAY_BATCHES * m, m):
            bg = np.zeros((bucket, SIGMA), np.int32)
            bl = np.zeros((bucket,), np.int32)
            bg[:m], bl[:m] = src_g[i:i + m], src_l[i:i + m]
            t0 = time.perf_counter()
            if kind == "lookup":
                svc.lookup(bg, bl)
            else:
                svc.continuations(bg, bl, k=TOP_K)
            times.append(time.perf_counter() - t0)
        load_ms = np.mean([e["dur"] for e in flushes[kind]]) / 1e3
        replay[kind] = (m, bucket, float(np.median(times)) * 1e3, load_ms)
    svc.cache = live_cache

    # ---- both CLIs on the card, side by side, while the checks run -------
    out_dir = Path(__file__).resolve().parent / "build" / "phase9"
    out_dir.mkdir(parents=True, exist_ok=True)
    cli = {}
    for name, args in (
            ("ngram", ["repro_torch.launch.ngram", "--tokens", str(main["n_terms"]),
                       "--sigma", str(SIGMA), "--tau", str(TAU)]),
            ("serve_ngrams", ["repro_torch.launch.serve_ngrams", "--streaming",
                              "--compress", "--tokens", str(CLI_SERVE_TOKENS),
                              "--wave-tokens", str(CLI_WAVE_TOKENS)])):
        m = out_dir / f"{name}.jsonl"
        m.unlink(missing_ok=True)
        cli[name] = (m, out_dir / f"{name}.log", time.perf_counter())
        cli[name] += (run_cli(args + ["--device", dev.type, "--metrics", str(m)],
                              cli[name][1]),)

    # ---- the SSE oracle: direct service calls on a cold cache, and the host
    live_cache, svc.cache = svc.cache, LRUQueryCache()
    want_sse = greedy_events(lambda a, b: svc.continuations(a, b, k=TOP_K), sse_prefix,
                             FE_SSE_STEPS, TOP_K)
    svc.cache = live_cache
    check(want_sse == greedy_events(lambda a, b: expected_continuations(union, a, b, TOP_K),
                                    sse_prefix, FE_SSE_STEPS, TOP_K),
          "the greedy oracle: the service's direct calls == the host's")
    check(all(sse_events(res[i][1]) == want for i, want in zip(where[2], want_sse)),
          "every SSE completion == the greedy oracle")
    svc.cache.publish_metrics()
    obs_metrics.set_registry(None)

    # ---- metrics and trace ------------------------------------------------
    snap = reg.snapshot()
    export = tracer.export()
    check(obs_report.validate_metrics(snap) == [], "the phase's metrics validate")
    check(obs_report.validate_trace(export) == [], "the phase's trace validates")
    names = collections.Counter(e["name"] for e in export["traceEvents"])
    check(names["serve.request"] > 0 and names["serve.flush"] > 0,
          "serve.request and serve.flush spans recorded")
    every = {**snap["counters"], **snap["gauges"], **snap["histograms"]}
    for inst in ("frontend.requests", "frontend.shed", "frontend.coalesced",
                 "frontend.batches", "frontend.queue_depth", "frontend.batch_fill",
                 "frontend.ttfb_seconds", "gen.generation", "gen.ingests", "gen.merges",
                 "gen.bytes_at_rest", "cache.hits", "cache.misses", "job.jobs",
                 "job.map_records", "job.shuffle_skew"):
        check(inst in every, f"instrument {inst} recorded")
    c = snap["counters"]
    check(c["frontend.shed"] == codes[503], "frontend.shed == the 503s")
    check(c["frontend.coalesced"] + c["cache.hits"] >= FE_TOPK_REPEATS,
          "every repeated top-k coalesced or hit the cache")
    check(c["job.jobs"] == len(stream["batches"]), "one job an ingest")
    if dev.type == "cuda":                   # a CPU tensor launches no kernel
        for k in ("bsearch", "block_decode"):
            check(query_launches.get(k, 0) > 0, f"{k} launched from the frontend's queries")
        missing = [k for k in FE_KERNELS if launches.get(k, 0) == 0]
        check(not missing, f"the frontend's path launched every kernel (missing {missing})")
        check(launches.get("block_expand", 0) == names["compress.decode"],
              "one block_expand launch per compressed-rung decode")

    for name, (m, log, t_start, proc) in cli.items():
        rc = proc.wait(timeout=600)
        text = log.read_text()
        print(f"frontend: cli {name} exit {rc} in {time.perf_counter() - t_start:.1f} s; "
              + " | ".join(ln.strip() for ln in text.splitlines()
                           if ln.startswith(("method=", "counters:", "base:", "ingest[",
                                             "final:"))))
        check(rc == 0, f"python -m repro_torch.launch.{name} exits 0:\n{text[-3000:]}")
        rec = obs_report.read_jsonl(str(m))[-1]
        check(obs_report.validate_metrics(rec["metrics"]) == [], f"{name}'s metrics validate")
        check(rec["env"]["device_kind"] == dev.type, f"{name} saw the card")
    rec = obs_report.read_jsonl(str(cli["ngram"][0]))[-1]["metrics"]
    for k, v in main["stats"].counters.items():
        got_v = rec["gauges" if k in obs_metrics.MAX_MERGED_COUNTERS else "counters"]["job." + k]
        check(got_v == v, f"ngram CLI job.{k} == phase 3's ({got_v} vs {v})")
    n_line = next(ln for ln in cli["ngram"][1].read_text().splitlines()
                  if ln.startswith("method="))
    check(f": {len(main['stats'])} n-grams in " in n_line, "ngram CLI n-grams == phase 3's")

    # ---- print ---------------------------------------------------------------
    n_req = len(jobs)
    print(f"frontend: closed loop, {FE_CLIENTS} clients over localhost HTTP: {n_req} requests "
          f"({len(lk_jobs)} /v1/lookup of {FE_LOOKUP_BATCH} grams, {len(tk_jobs)} /v1/topk "
          f"k={TOP_K} with {FE_TOPK_REPEATS} repeats, {len(sse_jobs)} /v1/complete of "
          f"{FE_SSE_STEPS} steps, {n_events} events) in {wall:.3f} s = {n_req / wall:,.0f} "
          f"requests/s, {N_LOOKUPS / wall:,.0f} lookups/s; every answer exact")
    for what, idx in (("lookup", where[0]), ("topk", where[1]), ("complete", where[2])):
        lat = np.asarray([res[i][2] for i in idx]) * 1e3
        print(f"frontend: client latency /v1/{what}: p50 {np.percentile(lat, 50):.3f} ms, "
              f"p99 {np.percentile(lat, 99):.3f} ms, max {lat.max():.3f} ms (n={len(lat)})")
    fill = snap["histograms"]["frontend.batch_fill"]
    print(f"frontend: batches {c['frontend.batches']} (load: {batch_stats['batches']} of "
          f"{batch_stats['requests']} requests, {batch_stats['padded_slots']} padded slots); "
          f"batch_fill p50 {fill['p50']:.3f}, p95 {fill['p95']:.3f}; ttfb p50 "
          f"{snap['histograms']['frontend.ttfb_seconds']['p50'] * 1e3:.3f} ms, p99 "
          f"{snap['histograms']['frontend.ttfb_seconds']['p99'] * 1e3:.3f} ms")
    print(f"frontend: coalesced {c['frontend.coalesced']}, shed {c['frontend.shed']} of "
          f"{n_shed} in the burst ({codes[200]} admitted, exact), cache hit rate "
          f"{snap['gauges']['cache.hit_rate']:.3f} ({c['cache.hits']} hits, "
          f"{c['cache.misses']} misses); peak device memory under the load "
          f"{peak / 2**30:.2f} GiB")
    flush: dict[str, list] = {}
    for e in export["traceEvents"]:
        if e["name"] == "serve.flush":
            acc = flush.setdefault(e["args"]["kind"], [0, 0.0])
            acc[0] += 1
            acc[1] += e["dur"] / 1e6
    print("frontend: the batcher thread's serve.flush spans (a lookup batch's submit; "
          "a top-k batch's whole answer): " + ", ".join(
              f"{k} {n} batches {sec:.3f} s" for k, (n, sec) in sorted(flush.items()))
          + f", against the load's {wall:.3f} s and the burst")
    for kind, (m, bucket, direct_ms, load_ms) in replay.items():
        print(f"frontend: a {kind} batch of {m} live slots in a bucket of {bucket}, direct "
              f"on one thread with a cold cache: median {direct_ms:.3f} ms over "
              f"{REPLAY_BATCHES} batches (a lookup batch with its read-back); under the "
              f"load its flush spans averaged {load_ms:.3f} ms")
    print(f"frontend: launches by kernel (ingests, load and burst) {launches}; from the "
          f"queries alone {dict(query_launches)}; spans {dict(names)}")
    print(f"frontend: registry {len(c)} counters, {len(snap['gauges'])} gauges, "
          f"{len(snap['histograms'])} histograms; metrics and trace validate")
    return dict(launches=launches)


# --------------------------------------------------------------------- phase 4
def _probes(lo, hi, pos, steps: int) -> tuple[int, int, torch.Tensor]:
    """(total probes, distinct rows probed, probes [Q] of each query) of a
    bounded binary search, replayed from its answer: a step goes right
    exactly when mid < the final position."""
    lo, hi, pos = lo.to(torch.int64), hi.to(torch.int64), pos.to(torch.int64)
    mids = []
    per_query = torch.zeros_like(lo)
    for _ in range(steps):
        live = lo < hi
        mid = (lo + hi) // 2
        mids.append(mid[live])
        per_query += live
        right = mid < pos
        lo = torch.where(live & right, mid + 1, lo)
        hi = torch.where(live & ~right, mid, hi)
    mids = torch.cat(mids)
    return int(mids.numel()), int(torch.unique(mids).numel()), per_query


def bound(bytes_moved: float, ops_done: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_done / SCALAR_OPS_PER_S * 1e3
    return (float(t_bytes), "bytes") if t_bytes >= t_ops else (float(t_ops), "operations")


#: lcp_boundary's edge lengths: the generic instance's short rows (1-5; 5
#: is the main path's), the shortest tiled row, sigma_split's phase A (16)
#: and the sigma-40 job (40), a warp's 32 terms and either side, 100, and
#: the longest row that still gets a tile (16 rows)
LCP_EDGE_LENGTHS = (1, 2, 3, 4, 5, 6, 16, 31, 32, 33, 40, 100, ops.LCP_MAX_TILED_LENGTH)


def lcp_block_rows(length: int) -> int:
    """Rows a block of the ``lcp_boundary`` kernel takes at rows of
    ``length`` terms: its tile, or 256 (one a thread) in the generic
    instance."""
    return ops._lcp_tile_rows(length) or 256


def lcp_sorted(rng, n: int, length: int) -> np.ndarray:
    """n sorted int32 rows: each drawn row twice and once with only its last
    term changed, a third with a PAD tail, and the first row of every block
    of the ``lcp_boundary`` kernel equal to the row before it."""
    base = rng.integers(1, 4, (-(-n // 3), length))
    cut = np.where(rng.random(len(base)) < 1 / 3, rng.integers(0, length, len(base)), length)
    base[np.arange(length)[None, :] >= cut[:, None]] = 0
    last = base.copy()
    last[:, -1] = (last[:, -1] + 1) % 4
    rows = np.concatenate([base, base, last])[:n]
    rows = rows[np.lexsort(rows.T[::-1])]
    t = lcp_block_rows(length)
    rows[t::t] = rows[t - 1::t][:len(rows[t::t])]
    return rows.astype(np.int32)


def lcp_edge_matrices(rng) -> list[tuple[str, np.ndarray, int]]:
    """(name, terms, offset in words of the view into its storage) at the
    edges of ``lcp_boundary``'s blocks, which tests/test_torch_kernels.py
    also runs: N = 1, T - 1, T, T + 1 and 3T + 2 for the block of T rows
    taken at each length, rows too long for a tile, all-zero matrices, views
    that are not 16-byte aligned, and row 0 starting with INT_MIN."""
    out = []
    for length in LCP_EDGE_LENGTHS:
        t = lcp_block_rows(length)
        out += [(f"L{length}-n{n}", lcp_sorted(rng, n, length), 0)
                for n in (1, t - 1, t, t + 1, 3 * t + 2)]
    long_rows = ops.LCP_MAX_TILED_LENGTH + 1
    out += [(f"L{long_rows}-n{n}", lcp_sorted(rng, n, long_rows), 0) for n in (1, 2, 257)]
    out += [(f"zeros-L{length}-n{n}", np.zeros((n, length), np.int32), 0)
            for length, n in ((1, 3), (5, 257), (6, 1169), (40, 578))]
    out += [(f"L{length}-n{n}-off{offset}", lcp_sorted(rng, n, length), offset)
            for length, n, offset in ((5, 770, 1), (6, 3506, 3), (7, 1025, 2), (16, 481, 1),
                                      (40, 578, 2), (1, 257, 3), (long_rows, 2, 1))]
    out.append(("intmin-row0", np.asarray([[-2**31, -2**31, 5], [-2**31, 3, 0]], np.int32), 0))
    return out


def edge_cases(dev):
    """(kernel name, kernel call, plain call) on ragged and corner inputs."""
    rng = np.random.default_rng(3)
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), device=dev, dtype=dt)  # noqa: E731
    cases = []
    for toks, sigma, vocab in (([5], 5, 20_000), ([0], 3, 7), ([1, 1], 64, 1),
                               (rng.integers(0, 4, 1001), 7, 3),
                               (rng.integers(0, 70_001, 777), 9, 70_000),
                               (rng.integers(0, 2**20, 513), 64, 2**30)):
        x = t(np.asarray(toks, np.int32))
        cases.append(("suffix_pack",
                      lambda x=x, s=sigma, v=vocab: ops.suffix_pack(x, sigma=s, vocab_size=v),
                      lambda x=x, s=sigma, v=vocab: ref.suffix_pack_ref(x, sigma=s, vocab_size=v)))
    for n, parts in ((1, 64), (1, 1), (257, 7), (300_001, 512), (5000, 4096)):
        keys = rng.integers(0, 2**32, n).astype(np.int64)
        keys[: min(n, 3)] = [2**32 - 1, 2**31, 0][: min(n, 3)]
        valid = rng.random(n) < 0.7
        k, v = t(keys), t(valid)
        cases.append(("hash_partition",
                      lambda k=k, v=v, p=parts: ops.hash_partition(k, v, n_parts=p),
                      lambda k=k, v=v, p=parts: ref.hash_partition_ref(k, v, p)))
    for n, length, vmax in ((1, 5, 9), (1000, 1, 3), (999, 100, 2), (4097, 5, 4)):
        a = rng.integers(0, vmax, (n, length)).astype(np.int32)
        a = t(a[np.lexsort(a.T[::-1])])
        cases.append(("lcp_boundary", lambda a=a: ops.lcp_boundary(a),
                      lambda a=a: ref.lcp_boundary_ref(a)))
    for _, terms, offset in lcp_edge_matrices(rng):
        flat = torch.zeros(terms.size + offset, dtype=torch.int32, device=dev)
        a = flat[offset:].view(terms.shape)
        a.copy_(torch.as_tensor(terms))
        cases.append(("lcp_boundary", lambda a=a: ops.lcp_boundary(a),
                      lambda a=a: ref.lcp_boundary_ref(a)))
    # suffix_pack at its tile edges (T = 1024 positions for n_lanes <= 4;
    # more lanes take the generic instance) with a PAD run across the edge;
    # sigma 1, 64 and past 64; a new lane matrix and the map's records
    for n in (1, 3, 63, 64, 65, 1023, 1024, 1025, 2049):
        for sigma, vocab, edge in ((5, 20_000, 1024), (40, 2**30, 64)):
            toks = rng.integers(1, 300, n).astype(np.int32)
            toks[max(0, min(n, edge) - 3):edge + 2] = 0
            x = t(toks)
            cases.append(("suffix_pack",
                          lambda x=x, s=sigma, v=vocab: ops.suffix_pack(x, sigma=s, vocab_size=v),
                          lambda x=x, s=sigma, v=vocab: ref.suffix_pack_ref(x, sigma=s, vocab_size=v)))
    big = rng.integers(0, 2**20, 5000).astype(np.int32)
    for sigma, vocab in ((1, 20_000), (1, 2**30), (64, 2**30), (5, 20_000), (8, 300),
                         (128, 1), (65, 2**30), (300, 2**30)):
        x = t(big % (min(vocab, 2**20) + 1))
        for records in (False, True):
            def run(fn, x=x, s=sigma, v=vocab, records=records):
                if not records:
                    return fn(x, sigma=s, vocab_size=v)
                rec = torch.full((x.shape[0], pack.n_lanes(s, v) + 1), -1,
                                 dtype=torch.int64, device=x.device)
                fn(x, sigma=s, vocab_size=v, out=rec)
                return rec
            cases.append(("suffix_pack", lambda run=run: run(ops.suffix_pack),
                          lambda run=run: run(ref.suffix_pack_ref)))
    # bsearch: every lane-count instance (1-4 and the generic 6), four
    # layouts of the lanes, brackets of width 0, 1, 2**d - 1, 2**d and R
    # (d = 2, 3, 4), full and truncated steps, int32 and int64 brackets, keys
    # >= 2**31, both bounds
    r, q = 300, 600
    widths = np.array([0, 1, 3, 4, 7, 8, 15, 16, r])
    for n_l in (1, 2, 3, 4, 6):
        lanes = 2**31 + rng.integers(0, 3, (r, n_l)).astype(np.int64)
        lanes = lanes[np.lexsort(lanes.T[::-1])]
        queries = t(2**31 + rng.integers(0, 4, (q, n_l)).astype(np.int64))
        width = widths[rng.integers(0, len(widths), q)]
        lo = rng.integers(0, r + 1 - width)
        hi = lo + width
        # the lanes as a view of a wider matrix, junk columns before and
        # after: 16-byte lane-pair loads from lane 0 or 1, or none
        for k, (before, after) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
            junk = np.full((r, 1), 2**32 - 1, np.int64)
            view = t(np.concatenate([junk] * before + [lanes] + [junk] * after,
                                    axis=1))[:, before:before + n_l]
            dt = (np.int32, np.int64)[k % 2]
            a = (view, queries, t(lo.astype(dt)), t(hi.astype(dt)))
            for upper in (False, True):
                for steps in (ref.search_steps(r), 1, 3):
                    cases.append(("bsearch",
                                  lambda a=a, u=upper, st=steps:
                                  ops.bsearch(*a, upper=u, steps=st),
                                  lambda a=a, u=upper, st=steps:
                                  ref.bsearch_ref(*a, upper=u, steps=st)))
    for r, n_l, q, upper in ((1, 1, 5, False), (1, 2, 5, True), (333, 3, 1000, False),
                             (333, 3, 1000, True), (4096, 4, 3000, True)):
        lanes = rng.integers(0, 40, (r, n_l + 1)).astype(np.int64) + 2**31
        lanes = lanes[np.lexsort(lanes[:, 1:].T[::-1])]
        queries = rng.integers(0, 44, (q, n_l)).astype(np.int64) + 2**31
        lo = rng.integers(0, r + 1, q)                 # includes lo == hi == r
        hi = np.where(rng.random(q) < 0.2, lo, np.minimum(lo + rng.integers(0, r + 1, q), r))
        view = t(lanes)[:, 1:]                          # a row-strided view
        args = (view, t(queries), t(lo.astype(np.int32)), t(hi.astype(np.int32)))
        cases.append(("bsearch", lambda a=args, u=upper: ops.bsearch(*a, upper=u),
                      lambda a=args, u=upper: ref.bsearch_ref(*a, upper=u)))
    # suffix_pack's bucketed records (lanes | weight | meta) for every tiled
    # lane count (1-4; 4 twice: the widest tile, 6 columns in dynamic shared
    # memory, with sigma 8 and with the widest halo, sigma 128) and the
    # generic instance (sigma 40, 20 lanes), at the tile edges, into a
    # matrix of -1; meta words >= 2**31
    for sigma, vocab in ((2, 20_000), (3, 20_000), (5, 20_000), (8, 20_000), (128, 1),
                         (40, 20_000)):
        for n in (1, 1023, 1025, 3001):
            x = t(rng.integers(0, min(vocab, 300) + 1, n).astype(np.int32))
            m = t(rng.integers(0, 2**32, n).astype(np.uint32).view(np.int32))

            def run(fn, x=x, m=m, s=sigma, v=vocab):
                rec = torch.full((x.shape[0], pack.n_lanes(s, v) + 2), -1,
                                 dtype=torch.int64, device=x.device)
                fn(x, sigma=s, vocab_size=v, out=rec, meta=m)
                return rec
            cases.append(("suffix_pack", lambda run=run: run(ops.suffix_pack),
                          lambda run=run: run(ref.suffix_pack_ref)))
    return cases


def phase_kernels(dev, main: dict, methods: dict, stream: dict, ext: dict,
                  probe: ctypes.CDLL):
    """Each kernel against its plain version at the main paths' shapes.
    Returns the rows and a function to run after phase 8, which adds its
    launches to every row and ``merge_path`` at the fold's shapes."""
    vocab = corpus.NYT.vocab_size
    n_l = pack.n_lanes(SIGMA, vocab)
    tokens, idx = main["tokens"], main["idx"]
    n = tokens.shape[0]
    rows = []
    by_path = {k: {"main": main["launches"].get(k, 0),
                   "methods": methods["launches"].get(k, 0),
                   "stream": stream["launches"].get(k, 0),
                   "ext": ext["launches"].get(k, 0)} for k in KERNELS}

    def measure(name, path, kernel, plain, bytes_u32, bytes_stored, ops_done, shape,
                plain_reps=10):
        """One row; ``bytes_u32`` counts uint32 values at 4 bytes, ``bytes_stored``
        at the 8 bytes of the port's int64 lanes (equal where all is 32-bit);
        the plain version's time is a mean over ``plain_reps`` calls."""
        err = max_abs_err(kernel(), plain())
        check(err == 0, f"{name} kernel == plain version at {shape}")
        ms = cuda_ms(kernel) if tokens.is_cuda else float("nan")
        k_ms = kernel_ms(kernel, f"{name}_kernel") if tokens.is_cuda else float("nan")
        q_ms = queued_ms(kernel) if tokens.is_cuda else float("nan")
        plain_ms = cuda_ms(plain, plain_reps) if tokens.is_cuda else float("nan")
        bound_ms, bound_by = bound(bytes_u32, ops_done)
        stored_ms, _ = bound(bytes_stored, ops_done)
        print(f"kernel {name} at {shape}: equal; {ms:.4f} ms a call, kernel "
              f"{fmt_ms(k_ms)} ms on the device (profiler), a call queued "
              f"{q_ms:.4f} ms on the device (events), plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, uint32 values), "
              f"{stored_ms:.4f} ms as stored (int64 lanes); launches {by_path[name]}; "
              "library call: none")
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{name}.cu",
                    replaces=KERNELS[name], launches=by_path[name][path],
                    launches_by_path=by_path[name], max_abs_err=err, ms=ms,
                    kernel_ms=k_ms, queued_ms=q_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by,
                    bound_ms_as_stored=stored_ms, library_ms=None, shape=shape)

    def at_shape(row: dict, other: dict, key: str = "methods_shape") -> None:
        """Attach to ``row`` the measurement ``other`` at the shape another
        path gives the kernel: phase 6's jobs (``methods_shape``), phase 7's
        (``ext_shape``), phase 8's fold (``fold_shape``, ``fold_widest_shape``)."""
        row[key] = {k: other[k] for k in (
            "shape", "max_abs_err", "ms", "kernel_ms", "queued_ms", "plain_ms", "bound_ms",
            "bound_by", "bound_ms_as_stored")}

    # the main path's own intermediates, rebuilt stage by stage; suffix_pack
    # as the map emit (suffix_sigma.make_records) calls it: whole records
    records = torch.empty((n, n_l + 1), dtype=torch.int64, device=tokens.device)
    plain_out = torch.empty_like(records)
    rows.append(measure(
        "suffix_pack", "main",
        lambda: ops.suffix_pack(tokens, sigma=SIGMA, vocab_size=vocab, out=records),
        lambda: ref.suffix_pack_ref(tokens, sigma=SIGMA, vocab_size=vocab, out=plain_out),
        n * (4 + 4 * (n_l + 1)), n * (4 + 8 * (n_l + 1)), 6 * SIGMA * n,
        f"tokens [{n}] -> records [{n}, {n_l + 1}] (lanes | weight)"))
    del plain_out
    # the lanes alone, [N, n_lanes], as every round of phase 6 emits them
    at_shape(rows[-1], measure(
        "suffix_pack", "methods",
        lambda: ops.suffix_pack(tokens, sigma=SIGMA, vocab_size=vocab),
        lambda: ref.suffix_pack_ref(tokens, sigma=SIGMA, vocab_size=vocab),
        n * (4 + 4 * n_l), n * (4 + 8 * n_l), 6 * SIGMA * n,
        f"tokens [{n}] -> lanes alone [{n}, {n_l}] (the methods' emit)"))
    # whole bucketed records, [N, n_lanes + 2], as the series job emits them:
    # the meta column adds 4 B read and 8 B written a position as stored
    years = ext["years"]
    bucketed = torch.empty((n, n_l + 2), dtype=torch.int64, device=tokens.device)
    plain_out = torch.empty_like(bucketed)
    at_shape(rows[0], measure(
        "suffix_pack", "ext",
        lambda: ops.suffix_pack(tokens, sigma=SIGMA, vocab_size=vocab, out=bucketed,
                                meta=years),
        lambda: ref.suffix_pack_ref(tokens, sigma=SIGMA, vocab_size=vocab, out=plain_out,
                                    meta=years),
        n * (4 + 4 + 4 * (n_l + 2)), n * (4 + 4 + 8 * (n_l + 2)), 6 * SIGMA * n,
        f"tokens [{n}] + years [{n}] -> records [{n}, {n_l + 2}] (lanes | weight | bucket)"),
        "ext_shape")
    del bucketed, plain_out
    records = stages.combine(records, n_l)
    live = records[:, n_l] > 0
    key = stages.partition_keys(records, n_l, kind="lead", vocab_size=vocab)
    rows.append(measure(
        "hash_partition", "main",
        lambda: ops.hash_partition(key, live, n_parts=64),
        lambda: ref.hash_partition_ref(key, live, 64),
        n * (4 + 1 + 4) + 64 * 4, n * (8 + 1 + 4) + 64 * 4, 10 * n,
        f"keys [{n}], 64 parts"))
    del key, live
    # the largest call of phase 6: NAIVE's whole-gram keys, one a record
    exploded, _ = naive._explode(tokens, SIGMA, vocab)
    live = exploded[:, n_l] > 0
    key = stages.partition_keys(exploded, n_l, kind="gram", vocab_size=vocab)
    del exploded
    r = key.shape[0]
    at_shape(rows[-1], measure(
        "hash_partition", "methods",
        lambda: ops.hash_partition(key, live, n_parts=64),
        lambda: ref.hash_partition_ref(key, live, 64),
        r * (4 + 1 + 4) + 64 * 4, r * (8 + 1 + 4) + 64 * 4, 10 * r,
        f"NAIVE's gram keys [{r}], 64 parts"))
    del key, live
    terms = pack.unpack_terms(stages.sort_stage(records, n_keys=n_l)[:, :n_l],
                              vocab_size=vocab, sigma=SIGMA)
    del records
    rows.append(measure(
        "lcp_boundary", "main", lambda: ops.lcp_boundary(terms),
        lambda: ref.lcp_boundary_ref(terms),
        n * (4 * SIGMA + 4 + SIGMA), n * (4 * SIGMA + 4 + SIGMA), 3 * SIGMA * n,
        f"terms [{n}, {SIGMA}]"))
    del terms

    # bsearch as the point lookups call it (the row reported), and as the
    # continuation queries do
    steps = ref.search_steps(idx.size)
    g, ln = main["queries"]
    g, ln, valid = index_query._clean(idx, g, ln, lo_len=1)
    q_lanes = pack.pack_terms(g, vocab_size=vocab)
    lead = pack.lead_term(q_lanes[:, 0], vocab_size=vocab)
    lo, hi = index_query._bracket(idx, idx.fanout, ln, lead)
    pg, pl = main["prefixes"]
    pg, pl, _ = index_query._clean(idx, pg, pl, lo_len=0)
    p_lanes = pack.pack_terms(pg, vocab_size=vocab)
    p_lead = pack.lead_term(p_lanes[:, 0], vocab_size=vocab)
    c_lo, c_hi = index_query._bracket(idx, idx.cont_fanout, pl + 1, p_lead)
    shapes = (("lookup", idx.lanes, q_lanes, lo, hi, False),
              ("continuation lower", idx.cont_prefix, p_lanes, c_lo, c_hi, False),
              ("continuation upper", idx.cont_prefix, p_lanes, c_lo, c_hi, True))
    # the floor of a search: its longest query's round trips, one dependent
    # L2 load each, plus a launch
    levels = bsearch_levels()
    if tokens.is_cuda:
        l2_us, empty_ms = latency_floor(probe, idx.lanes.untyped_storage().nbytes() // 8, dev)
        print(f"kernel bsearch floor: one dependent load from L2 "
              f"{'not measured' if l2_us is None else f'{l2_us:.4f} us'}, an empty "
              f"kernel {fmt_ms(empty_ms)} ms on the device")
    else:
        l2_us = empty_ms = None
    for label, lanes, q, b_lo, b_hi, upper in shapes:
        pos = ops.bsearch(lanes, q, b_lo, b_hi, upper=upper, steps=steps)
        probes, distinct, per_q = _probes(b_lo, b_hi, pos, steps)
        trips = -(-per_q // levels)                 # round trips of each query
        n_q = q.shape[0]
        row = measure(
            "bsearch", "main",
            lambda l=lanes, q=q, a=b_lo, b=b_hi, u=upper: ops.bsearch(l, q, a, b, upper=u, steps=steps),
            lambda l=lanes, q=q, a=b_lo, b=b_hi, u=upper: ref.bsearch_ref(l, q, a, b, upper=u, steps=steps),
            n_q * (4 * n_l + 4 + 4 + 4) + distinct * 4 * n_l,
            n_q * (8 * n_l + 4 + 4 + 4) + distinct * 8 * n_l,
            probes * (2 * n_l + 4),
            f"{label}: index [{idx.size}, {n_l}], queries [{n_q}], {steps} steps, "
            f"{probes} probes of {distinct} distinct rows; round trips at {levels} "
            f"levels each: max {int(trips.max())}, mean {float(trips.float().mean()):.3f}")
        floor_ms = (None if None in (l2_us, empty_ms)
                    else int(trips.max()) * l2_us / 1e3 + empty_ms)
        if floor_ms is not None and row["kernel_ms"] is not None:
            print(f"kernel bsearch at {label}: floor {floor_ms:.4f} ms "
                  f"({int(trips.max())} round trips x {l2_us:.4f} us + "
                  f"{empty_ms:.4f} ms); kernel {row['kernel_ms'] / floor_ms:.2f}x the floor")
        row.update(levels=levels, round_trips_max=int(trips.max()),
                   round_trips_mean=float(trips.float().mean()),
                   l2_latency_us=l2_us, empty_kernel_ms=empty_ms, floor_ms=floor_ms)
        if label == "lookup":
            rows.append(row)
    rows += stream_kernel_rows(dev, stream, measure)
    ext_kernel_rows(dev, main, ext, measure, at_shape, {r["name"]: r for r in rows})
    cases = edge_cases(dev) + stream_edge_cases(dev)
    for name, kernel, plain in cases:
        check(max_abs_err(kernel(), plain()) == 0, f"{name} edge case")
    print(f"kernels: {len(cases)} edge cases equal their plain versions "
          "(N=1, ragged N, keys >= 2**31, lo == hi, empty brackets, upper, "
          "strided lanes, sigma=64; suffix_pack tile edges, sigma 65-300, lanes, "
          "records, and bucketed records for lane counts 1-4 and 20; bsearch lane counts 1-4 and 6 in four layouts, bracket "
          "widths 0, 1, 2**d - 1, 2**d and R, truncated steps, int32 and int64 brackets; "
          "strided records, M=0, N=0, all-equal keys across runs, sentinel "
          "tails, sigma=15, block id nb-1; hash_combine K 1-5 x blocks 32-1024 in "
          "place, aligned and not, and on separate tensors, all keys equal or "
          "distinct; merge_path K 1-6, M=1, N=1, ties in runs of 256, 1024 and "
          "5000 rows across tiles, M = N = 2**26 + 4,099; lcp_boundary at N = 1, T - 1, T, T + 1 and 3T + 2 "
          "for L 1-6, 16, 31-33, 40, 100 and 3072 (T = 256 rows a block at L <= 5), "
          "L = 3073, zeros, unaligned views, INT_MIN in row 0; block_expand and block_decode at block "
          f"sizes {', '.join(map(str, BLOCK_SIZES))} x sigma 1, 5, 15 x both views, "
          "out= in place, "
          "empty id lists)")

    def after_waves(waves: dict) -> None:
        """Phase 8's launches in every row, then ``merge_path`` at the 2**27
        fold's widest and largest merges, whose inputs phase 8 kept."""
        for k, paths in by_path.items():
            paths["waves"] = waves["launches"].get(k, 0)
        fold = waves.pop("fold")
        merge_row = next(r for r in rows if r["name"] == "merge_path")
        for key, what in (("widest", "fold_widest_shape"), ("largest", "fold_shape")):
            torch.cuda.empty_cache()
            ak, bk, av, bv = (t.to(dev) for t in fold.pop(key))
            m, nn, k = ak.shape[0], bk.shape[0], ak.shape[1]
            steps = ref.search_steps(min(m, nn) + 1)
            at_shape(merge_row, measure(
                "merge_path", "waves", lambda: ops.merge_path(ak, bk, av, bv),
                lambda: ref.merge_path_ref(ak, bk, av, bv),
                2 * (m + nn) * (4 * k + 4), 2 * (m + nn) * (8 * k + 8),
                (m + nn) * steps * (2 * k + 6),
                f"the {BIG_TERMS}-term deferred fold's {key} merge: runs [{m}, {k}] + "
                f"[{nn}, {k}], {steps} steps", plain_reps=2), what)
            del ak, bk, av, bv
        torch.cuda.empty_cache()

    return rows, after_waves


def ext_kernel_rows(dev, main: dict, ext: dict, measure, at_shape, rows: dict) -> None:
    """The shapes phase 7 gives ``hash_combine`` (the series job's lanes |
    bucket keys, the generic instance) and ``lcp_boundary`` (the sigma-40
    job's terms), attached to their rows as ``ext_shape``; and
    ``lcp_boundary`` at ``sigma_split``'s phase A (the sigma-16 job's
    terms), as ``split_shape``."""
    vocab = corpus.NYT.vocab_size
    n_l = pack.n_lanes(SIGMA, vocab)
    tokens, years = main["tokens"], ext["years"]
    records, _ = suffix_sigma.make_records(tokens, sigma=SIGMA, vocab_size=vocab,
                                           bucket_ids=years)
    plain_rec = records.clone()
    keys = stages._keys(records, n_l, True)                     # as combine_hash keys them
    n, k = keys.shape

    def in_place(fn, rec):
        w = rec[:, n_l]
        fn(keys, w, out=w)
        return rec
    at_shape(rows["hash_combine"], measure(
        "hash_combine", "ext", lambda: in_place(ops.hash_combine, records),
        lambda: in_place(ref.hash_combine_ref, plain_rec),
        n * (4 * k + 8), n * (8 * k + 16), n * (12 * k + 12),
        f"keys [{n}, {k}] = lanes | bucket (the generic instance), weights in place in "
        f"records [{n}, {n_l + 2}], blocks of 256 rows, 512 slots"), "ext_shape")
    del plain_rec, keys
    if dev.type == "cuda":
        combine_stage(records, n_l, has_bucket=True)
    del records
    for sigma, key, what in (
            (SPLIT_HEAD, "split_shape", f"sigma_split's phase A, a sigma-{SPLIT_HEAD} job"),
            (SPLIT_SIGMA, "ext_shape", f"the sigma-{SPLIT_SIGMA} job's reducer")):
        n_w = pack.n_lanes(sigma, vocab)
        rec, _ = suffix_sigma.make_records(ext["split_tokens"], sigma=sigma, vocab_size=vocab)
        terms = pack.unpack_terms(stages.sort_stage(rec, n_keys=n_w)[:, :n_w],
                                  vocab_size=vocab, sigma=sigma)
        del rec
        n = terms.shape[0]
        at_shape(rows["lcp_boundary"], measure(
            "lcp_boundary", "ext", lambda: ops.lcp_boundary(terms),
            lambda: ref.lcp_boundary_ref(terms),
            n * (4 * sigma + 4 + sigma), n * (4 * sigma + 4 + sigma), 3 * sigma * n,
            f"terms [{n}, {sigma}] ({what})"), key)
        del terms


def combine_stage(records: torch.Tensor, n_lanes: int, reps: int = 10,
                  has_bucket: bool = False) -> int:
    """Print the device time of one ``stages.combine_hash(records, n_lanes,
    has_bucket)`` call, every kernel it launches summed, and return its
    launches.  Each kernel's mean time counts once for each launch a call
    makes, so a launch the profiler missed at its window's start moves
    nothing.  The call rewrites the weights in place; the keys, and so the
    work, stay."""
    times = device_launches(lambda: stages.combine_hash(records, n_lanes, has_bucket),
                            reps)
    per_call = {name: max(1, round(len(t) / reps)) for name, t in times.items()}
    ms = sum(float(np.mean(t)) * per_call[name] for name, t in times.items()) / 1e3
    n, cols = records.shape
    moved = 2 * n * cols * 8             # every row read, its sectors written back
    launches = sum(per_call.values())
    names = "; ".join(f"{name[:60]} x{k}" for name, k in per_call.items())
    print(f"kernel hash_combine stage: stages.combine_hash on records [{n}, {cols}]"
          f"{' keyed on lanes | bucket' if has_bucket else ''}: "
          f"{launches} kernel launches a call ({names}), {ms:.4f} ms on the device; "
          f"in place every row read and written back whole, {moved:,} bytes: "
          f"{bound(moved, 0)[0]:.4f} ms at 3.35 TB/s")
    return launches


def measure_expand(dev, c, measure, label: str) -> dict:
    """``block_expand`` on the point view of compressed rung ``c`` as
    decode_segment launches it: one chunk (the whole rung here), its lanes
    packed into the key columns of a [rows, 1 + n_lanes] matrix in place.
    With ``measure`` the kernel's row; without, the times alone."""
    vocab = c.vocab_size
    n_l = c.n_lanes
    bs = c.block_size
    nb_used = -(-c.n_rows // bs)
    cb = min(max(1, index_compress._DECODE_CHUNK_ROWS // bs), nb_used)
    n = min(cb * bs, c.n_rows)
    ids = torch.arange(cb, dtype=torch.int32, device=dev).clamp(max=c.n_blocks - 1)
    base_h = c.block_base[:cb + 1].cpu().numpy().view(np.uint32).astype(np.int64)
    read = cb * (4 + 4 + bs * c.lcp_width / 8) + (base_h[-1] - base_h[0]) * c.term_bits / 8
    args = (c.lcps, c.payload, c.block_base, c.sec_cache, ids)
    kw = dict(term_bits=c.term_bits, lcp_width=c.lcp_width, block_size=bs, len_off=0,
              vocab_size=vocab)
    keys = torch.empty((n, 1 + n_l), dtype=torch.int64, device=dev)
    plain_keys = torch.empty_like(keys)
    kernel = lambda: ops.block_expand(*args, **kw, out=keys[:, 1:])  # noqa: E731
    plain = lambda: ref.block_expand_ref(*args, **kw, out=plain_keys[:, 1:])  # noqa: E731
    shape = (f"blocks [{cb}] of {bs} rows, sigma {c.sigma}, packed in place into "
             f"keys[:, 1:] [{n}, {n_l}]")
    if measure is not None:
        return measure("block_expand", "stream", kernel, plain, read + n * n_l * 4,
                       read + n * n_l * 8, cb * bs * c.sigma * 16, f"{label}: {shape}")
    check(max_abs_err(kernel(), plain()) == 0, f"block_expand == plain version at {shape}")
    return dict(shape=shape, ms=cuda_ms(kernel),
                kernel_ms=kernel_ms(kernel, "block_expand_kernel"),
                bound_ms=bound(read + n * n_l * 4, 0)[0])


def stream_kernel_rows(dev, stream: dict, measure) -> list[dict]:
    """The four kernels of phase 5 at the shapes it gave them."""
    vocab = corpus.NYT.vocab_size
    n_l = pack.n_lanes(SIGMA, vocab)
    rows = []
    # hash_combine: the base batch's map records (the largest combine call),
    # combined in place as stages.combine_hash calls it (out= the weight
    # column); repeated calls recombine the same keys, so the work repeats
    base = torch.as_tensor(stream["base_tokens"], device=dev)
    records, _ = suffix_sigma.make_records(base, sigma=SIGMA, vocab_size=vocab)
    plain_rec = records.clone()

    def in_place(fn, rec):
        w = rec[:, n_l]
        fn(rec[:, :n_l], w, out=w)
        return rec
    n = records.shape[0]
    rows.append(measure(
        "hash_combine", "stream", lambda: in_place(ops.hash_combine, records),
        lambda: in_place(ref.hash_combine_ref, plain_rec),
        n * (4 * n_l + 8), n * (8 * n_l + 16), n * (12 * n_l + 12),
        f"records [{n}, {n_l + 1}] combined in place (out= the weight column), "
        "blocks of 256 rows, 512 slots"))
    del plain_rec
    if dev.type == "cuda":
        check(combine_stage(records, n_l) == 1,
              "one kernel launch per stages.combine_hash call")
    del records, base
    # merge_path: the last merge of compact_all (the largest on the path), on
    # the very inputs it merged: the elder flat rung and the decoded
    # compressed one, both capacity-padded with sentinel tails
    runs = [index_merge._merge_input_segment(e, route="merge")
            for e in stream["compact_inputs"]]
    runs = [(r.keys, r.counts) for r in runs]
    while len(runs) > 2:                          # compact_all's pairing tree
        paired = [ops.merge_path(runs[i][0], runs[i + 1][0], runs[i][1], runs[i + 1][1])
                  for i in range(0, len(runs) - 1, 2)]
        runs = paired + runs[2 * len(paired):]
    (ak, av), (bk, bv) = runs
    m, nn, k = ak.shape[0], bk.shape[0], ak.shape[1]
    steps = ref.search_steps(min(m, nn) + 1)
    rows.append(measure(
        "merge_path", "stream", lambda: ops.merge_path(ak, bk, av, bv),
        lambda: ref.merge_path_ref(ak, bk, av, bv),
        2 * (m + nn) * (4 * k + 4), 2 * (m + nn) * (8 * k + 8),
        (m + nn) * steps * (2 * k + 6),
        f"compact_all's runs [{m}, {k}] + [{nn}, {k}] (sentinel tails), {steps} steps"))
    del runs, ak, av, bk, bv
    # block_expand: compact_all's decode of its compressed input, one launch
    # as decode_segment makes it, packed into the key columns in place (and,
    # for scale, the compacted rung decoded whole, and the first port's
    # 1,024-block chunk); block_decode: 2**16 point lookups against the
    # compacted rung
    c = max((e for e in stream["compact_inputs"] if isinstance(e, CompressedNGramIndex)),
            key=lambda e: e.n_rows)
    rows.append(measure_expand(dev, c, measure, "compact_all's decode of its compressed "
                               f"input, rung of {c.n_blocks} blocks"))
    c = stream["final"]
    stream_args = (c.lcps, c.payload, c.block_base, c.sec_cache)
    kw = dict(term_bits=c.term_bits, lcp_width=c.lcp_width, block_size=c.block_size,
              len_off=0)
    row_bytes = c.block_size * c.lcp_width / 8
    if dev.type == "cuda":
        whole = measure_expand(dev, c, None, "")
        print(f"kernel block_expand at the compacted rung decoded whole ({whole['shape']}): "
              f"{whole['ms']:.4f} ms a call, kernel {fmt_ms(whole['kernel_ms'])} ms on the "
              f"device; bound {whole['bound_ms']:.6f} ms (uint32 values)")
        old = torch.arange(min(1024, c.n_blocks), dtype=torch.int32, device=dev)
        old_fn = lambda: ops.block_expand(*stream_args, old, **kw)  # noqa: E731
        check(max_abs_err(old_fn(), ref.block_expand_ref(*stream_args, old, **kw)) == 0,
              "block_expand on a 1,024-block chunk == plain version")
        nb_old = old.shape[0]
        base_h = c.block_base[:nb_old + 1].cpu().numpy().view(np.uint32).astype(np.int64)
        old_read = nb_old * (4 + 4 + row_bytes) + float(base_h[-1] - base_h[0]) * c.term_bits / 8
        print(f"kernel block_expand continuity at the first port's chunk (blocks "
              f"[{nb_old}] of the compacted rung, int32 terms [{nb_old}, {c.block_size}, "
              f"{SIGMA}]): {cuda_ms(old_fn):.4f} ms a call, kernel "
              f"{fmt_ms(kernel_ms(old_fn, 'block_expand_kernel'))} ms on the device; bound "
              f"{bound(old_read + nb_old * c.block_size * SIGMA * 4, 0)[0]:.6f} ms")
    g, ln, _ = lookup_batch(stream["union"], np.random.default_rng(6), N_LOOKUPS, vocab)
    g, ln, _ = index_query._clean(c, torch.as_tensor(g, device=dev),
                                  torch.as_tensor(ln, device=dev), lo_len=1)
    q_lanes = pack.pack_terms(g, vocab_size=vocab)
    qkey = index_query._dense_qkey(c, ln, g)
    lo_h, hi_h = index_query._c_head_bracket(
        c, c.fan_cache, ln, pack.lead_term(q_lanes[:, 0], vocab_size=vocab))
    pos_h = ops.bsearch(c.head_lanes, qkey, lo_h, hi_h, upper=True, steps=c.head_steps)
    blk = (pos_h.to(torch.int64) - 1).clamp(0, c.n_blocks - 1).to(torch.int32)
    distinct = torch.unique(blk).to(torch.int64)
    base_all = c.block_base.to(torch.int64) & 0xFFFFFFFF
    d_pay = float((base_all[distinct + 1] - base_all[distinct]).sum()) * c.term_bits / 8
    n_q = blk.shape[0]
    bd_bytes = n_q * (4 * SIGMA + 4 + 4 + 8) + distinct.numel() * (row_bytes + 8) + d_pay
    rows.append(measure(
        "block_decode", "stream",
        lambda: ops.block_decode(*stream_args, blk, g, ln, **kw),
        lambda: ref.block_decode_ref(*stream_args, blk, g, ln, **kw),
        bd_bytes, bd_bytes, n_q * c.block_size * SIGMA * 20,
        f"queries [{n_q}] over {distinct.numel()} distinct blocks of a rung of "
        f"{c.n_blocks} blocks"))
    return rows


def stream_edge_cases(dev):
    """(kernel name, kernel call, plain call) for the four phase-5 kernels on
    ragged and corner inputs, and on small real compressed indexes."""
    rng = np.random.default_rng(4)
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    cases = []
    for n, k, vmax in ((1, 2, 5), (257, 3, 4), (1000, 1, 2**32), (4096, 4, 3),
                       (300_001, 3, 40)):
        keys = rng.integers(0, vmax, (n, k)).astype(np.int64)
        keys[: min(n, 3), 0] = [2**32 - 1, 2**31, 0][: min(n, 3)]
        w = rng.choice([0, 1, 2**31 + 3, 2**32 - 1], n).astype(np.int64)
        kt, wt = t(keys), t(w)
        cases.append(("hash_combine", lambda a=kt, b=wt: ops.hash_combine(a, b),
                      lambda a=kt, b=wt: ref.hash_combine_ref(a, b)))
        rec = torch.cat([kt, wt[:, None]], dim=1)   # keys and weight read in place
        cases.append(("hash_combine",
                      lambda r=rec, k=k: ops.hash_combine(r[:, :k], r[:, k]),
                      lambda r=rec, k=k: ref.hash_combine_ref(r[:, :k], r[:, k])))
    for m, n, k, vmax in ((0, 5, 2, 9), (7, 0, 2, 9), (1, 1, 1, 1), (500, 700, 3, 1),
                          (1000, 333, 4, 2**32), (4096, 4096, 2, 50)):
        a = rng.integers(0, vmax, (m, k)).astype(np.int64)
        b = rng.integers(0, vmax, (n, k)).astype(np.int64)
        a, b = a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])]
        if m > 3 and n > 3:                       # sentinel tails on both runs
            a[-2:], b[-3:] = 2**32 - 1, 2**32 - 1
        args = (t(a), t(b), t(rng.integers(0, 2**32, m)), t(rng.integers(0, 2**32, n)))
        cases.append(("merge_path", lambda x=args: ops.merge_path(*x),
                      lambda x=args: ref.merge_path_ref(*x)))
    cases += combine_edge_cases(dev) + merge_edge_cases(dev)
    # real compressed indexes: sigma 5 and 15 (8-bit lcps), every block (the
    # sentinel tail and block nb-1 included), queries hitting block nb-1
    for sigma, vocab, n_tok in ((5, 300, 3000), (15, 40, 2000), (3, 7, 50)):
        toks = rng.integers(0, vocab + 1, n_tok).astype(np.int32)
        st = run_job(toks, NGramConfig(sigma=sigma, tau=1, vocab_size=vocab), device=dev)
        c = build_compressed_index(st, vocab_size=vocab, block_size=4, device=dev)
        nb = c.n_blocks
        for view, off in (("point", 0), ("cont", 1)):
            sa = ((c.lcps, c.payload, c.block_base) if off == 0 else
                  (c.cont_lcps, c.cont_payload, c.cont_block_base)) + (c.sec_cache,)
            kw = dict(term_bits=c.term_bits, lcp_width=c.lcp_width,
                      block_size=c.block_size, len_off=off)
            ids = t(np.arange(nb, dtype=np.int32))
            cases.append(("block_expand",
                          lambda x=sa, i=ids, w=kw: ops.block_expand(*x, i, **w),
                          lambda x=sa, i=ids, w=kw: ref.block_expand_ref(*x, i, **w)))
            q = 777
            blk = rng.integers(0, nb, q).astype(np.int32)
            blk[:50] = nb - 1
            rows = rng.integers(0, len(st), q)
            qt, ql = st.grams[rows].astype(np.int32), st.lengths[rows].astype(np.int32)
            ql[:20] = sigma + 1                   # the sentinel key
            qt[:20] = (1 << c.term_bits) - 1
            qa = (t(blk), t(qt), t(ql))
            cases.append(("block_decode",
                          lambda x=sa, y=qa, w=kw: ops.block_decode(*x, *y, **w),
                          lambda x=sa, y=qa, w=kw: ref.block_decode_ref(*x, *y, **w)))
    return cases + block_edge_cases(dev)


def combine_edge_cases(dev):
    """``hash_combine``'s records instance (K = 1-4 key lanes of one
    contiguous [N, K + 1] matrix, combined in place, tiles of 1,024 rows) and
    its generic instance (K = 5, or the same matrix at an 8-byte offset, or
    separate tensors): N off the tile and the block, blocks of 32-1024 rows,
    all keys equal or all distinct, weights that wrap.  The matrix cases
    compare the whole matrix, so the keys must come back untouched."""
    rng = np.random.default_rng(8)
    cases = []

    def keys_of(kind, n, k):
        if kind == "equal":
            return np.full((n, k), 2**31 + 5, np.int64)
        if kind == "distinct":                   # row i spells i
            return (np.arange(n)[:, None] + 7 * np.arange(k)[None, :]) + 2**31
        return rng.integers(0, 3, (n, k)) + 2**31

    def in_place(fn, rec, k, block, off):
        flat = torch.zeros(rec.numel() + 2, dtype=torch.int64, device=dev)
        r = flat[off:off + rec.numel()].view(rec.shape)
        r.copy_(rec)
        w = r[:, k]
        check(fn(r[:, :k], w, block=block, out=w).data_ptr() == w.data_ptr(),
              "hash_combine returns out")
        return r

    sizes = (1, 1023, 1025, 3001, 70_001)
    for i, (k, block) in enumerate((k, b) for k in (1, 2, 3, 4, 5)
                                   for b in (32, 64, 256, 1024)):
        n, kind = sizes[i % len(sizes)], ("dup", "equal", "distinct")[i % 3]
        w = rng.choice([0, 1, 2**31 + 3, 2**32 - 1], n)
        rec = torch.as_tensor(np.concatenate([keys_of(kind, n, k), w[:, None]], axis=1),
                              device=dev)
        for off in (0, 1):                          # 16-byte aligned, and not
            cases.append(("hash_combine",
                          lambda r=rec, k=k, b=block, o=off: in_place(ops.hash_combine, r, k, b, o),
                          lambda r=rec, k=k, b=block, o=off: in_place(ref.hash_combine_ref,
                                                                       r, k, b, o)))
        kt, wt = rec[:, :k].contiguous(), rec[:, k].contiguous()   # separate tensors
        cases.append(("hash_combine",
                      lambda a=kt, c=wt, b=block: ops.hash_combine(a, c, block=b),
                      lambda a=kt, c=wt, b=block: ref.hash_combine_ref(a, c, block=b)))
    return cases


def tied_run(n: int, run: int, k: int, shift: int = 0) -> np.ndarray:
    """n sorted rows of k lanes (>= 2**31) whose keys change every ``run``
    rows from row ``shift``: long runs of equal keys, equal across runs
    built alike."""
    ids = (np.arange(n) + shift) // run
    lanes = [ids // 3 ** (k - 1 - c) % (3 if c else n + 1) for c in range(k)]
    return np.stack(lanes, axis=1).astype(np.int64) + 2**31


def merge_edge_cases(dev):
    """``merge_path``'s tiles (512 output rows, K = 1-5) and its generic
    instance (K = 6): runs inside one tile and across many, M = 1 and N = 1,
    sentinel tails, lanes >= 2**31, ties equal across A and B in runs of
    256, 1,024 and 5,000 rows that straddle the tiles' edges, and runs of
    2**26 + 4,099 rows (diagonal windows past 2**26)."""
    rng = np.random.default_rng(9)
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    cases = []

    def add(a, b):
        args = (t(a), t(b), t(rng.integers(0, 2**32, len(a))),
                t(rng.integers(0, 2**32, len(b))))
        cases.append(("merge_path", lambda x=args: ops.merge_path(*x),
                      lambda x=args: ref.merge_path_ref(*x)))

    for m, n, k, vmax in ((1, 1, 4, 3), (1, 1, 6, 3), (1, 900, 4, 5), (900, 1, 4, 5),
                          (3, 5, 1, 2), (1000, 24, 5, 4), (300_000, 70_000, 4, 40),
                          (70_000, 300_000, 6, 40), (4096, 4096, 3, 2**32)):
        a = rng.integers(0, vmax, (m, k)).astype(np.int64) + (2**31 if vmax < 2**31 else 0)
        b = rng.integers(0, vmax, (n, k)).astype(np.int64) + (2**31 if vmax < 2**31 else 0)
        a, b = a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])]
        if m > 3 and n > 3:                       # sentinel tails on both runs
            a[-2:], b[-3:] = 2**32 - 1, 2**32 - 1
        add(a, b)
    for k in (1, 2, 3, 4, 5, 6):
        for run, m, n, shift in ((256, 4096, 3000, 0), (1024, 3500, 4100, 100),
                                 (5000, 20_000, 12_000, 2500)):
            add(tied_run(m, run, k), tied_run(n, run, k, shift))
    # diagonal windows past 2**26 rows, where split_warp divides in 64 bits:
    # two runs of 2**26 + 4,099 keys in [2**31, 2**31 + 2**20), ties across
    # them, made on the card from a seed
    gen = torch.Generator(device=dev).manual_seed(9)
    big = (1 << 26) + 4099
    a, b = ((torch.randint(0, 1 << 20, (big,), generator=gen, device=dev).sort().values
             + 2**31)[:, None] for _ in range(2))
    av = torch.arange(big, device=dev)
    bv = av + big
    cases.append(("merge_path", lambda: ops.merge_path(a, b, av, bv),
                  lambda: ref.merge_path_ref(a, b, av, bv)))
    return cases


#: block sizes of the block kernels' edge grid: every group width of the
#: warp-group decode, full (1, 4, 8, 16, 32 lanes) and part-used (2 and 3 rows
#: in 4, 17 in 32), and the generic walk (33)
BLOCK_SIZES = (1, 2, 3, 4, 8, 16, 17, 32, 33)


def block_edge_cases(dev):
    """``block_expand`` and ``block_decode`` over block_size x sigma (1, 5, 15)
    x len_off (0, 1) on fuzzed streams: ids arbitrary, repeated and nb - 1;
    ``out=`` a row-strided view one row short of B * block_size inside a
    matrix of -1 (compared whole, so nothing around it may be written); int32
    terms at sigma 5; an empty id list; and real compressed indexes at every
    block size (decode_segment's one launch, and lookups at block nb - 1)."""
    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    cases = []

    def expand_into(fn, sa, ids, kw, n, n_l, vocab):
        full = torch.full((n + 3, n_l + 2), -1, dtype=torch.int64, device=dev)
        check(fn(*sa, ids, **kw, out=full[:n, 1:1 + n_l], vocab_size=vocab).data_ptr()
              == full[:n, 1:1 + n_l].data_ptr(), "block_expand returns out")
        return full

    grid = [(bs, sigma, off) for bs in BLOCK_SIZES for sigma in (1, 5, 15)
            for off in (0, 1)] + [(3, 40, 1), (16, 40, 1)]   # sigma past 32 too
    for bs, sigma, off in grid:
        tb = int(rng.choice([3, 7, 15, 16]))
        lw = 4 if sigma <= 14 else 8
        nb = int(rng.integers(2, 300))
        size = nb * bs
        sa = (t(rng.integers(0, 2**32, -(-size * lw // 32)).astype(np.uint32).view(np.int32)),
              t(rng.integers(0, 2**32, int(rng.integers(1, 2000))).astype(np.uint32)
                .view(np.int32)),
              t(np.sort(rng.integers(0, 2**24, nb + 1)).astype(np.uint32).view(np.int32)),
              t(np.sort(rng.integers(0, size + 1, sigma + 1)).astype(np.int32)))
        kw = dict(term_bits=tb, lcp_width=lw, block_size=bs, len_off=off)
        blk = rng.integers(0, nb, 1000).astype(np.int32)
        blk[:3], blk[3:8] = nb - 1, blk[8]
        ids = t(blk)
        vocab = (1 << tb) - 1
        n_l = pack.n_lanes(sigma, vocab)
        n = blk.shape[0] * bs - 1
        cases.append(("block_expand",
                      lambda x=sa, i=ids, w=kw, n=n, n_l=n_l, v=vocab:
                      expand_into(ops.block_expand, x, i, w, n, n_l, v),
                      lambda x=sa, i=ids, w=kw, n=n, n_l=n_l, v=vocab:
                      expand_into(ref.block_expand_ref, x, i, w, n, n_l, v)))
        if sigma == 5:
            cases.append(("block_expand",
                          lambda x=sa, i=ids, w=kw: ops.block_expand(*x, i, **w),
                          lambda x=sa, i=ids, w=kw: ref.block_expand_ref(*x, i, **w)))
        qt = rng.integers(0, 1 << tb, (blk.shape[0], sigma)).astype(np.int32)
        ql = rng.integers(0, sigma + 2, blk.shape[0]).astype(np.int32)
        rows = ref.block_expand_ref(*sa, ids, **kw).cpu().numpy()
        pick = rng.integers(0, bs, blk.shape[0])
        mine = rng.random(blk.shape[0]) < 0.5       # a row of the block itself
        qt[mine] = rows[np.arange(blk.shape[0]), pick][mine]
        g = blk.astype(np.int64) * bs + pick
        sec_h = sa[3].cpu().numpy()
        ql[mine] = (g[:, None] >= sec_h[None, :]).sum(axis=1)[mine]
        qa = (ids, t(qt), t(ql))
        cases.append(("block_decode",
                      lambda x=sa, y=qa, w=kw: ops.block_decode(*x, *y, **w),
                      lambda x=sa, y=qa, w=kw: ref.block_decode_ref(*x, *y, **w)))
        if sigma == 1 and off == 0:                  # an empty id list
            none = t(np.zeros(0, np.int32))
            qn = (none, t(np.zeros((0, sigma), np.int32)), none)
            cases.append(("block_expand",
                          lambda x=sa, i=none, w=kw: ops.block_expand(*x, i, **w),
                          lambda x=sa, i=none, w=kw: ref.block_expand_ref(*x, i, **w)))
            cases.append(("block_decode",
                          lambda x=sa, y=qn, w=kw: ops.block_decode(*x, *y, **w),
                          lambda x=sa, y=qn, w=kw: ref.block_decode_ref(*x, *y, **w)))
    # real compressed indexes at every block size: the point view through
    # decode_segment's launch into keys[:, 1:], lookups on blocks nb - 1
    toks = rng.integers(0, 301, 3000).astype(np.int32)
    st = run_job(toks, NGramConfig(sigma=5, tau=1, vocab_size=300), device=dev)
    for bs in BLOCK_SIZES:
        pad = -(-(len(st) + 1) // (128 * bs)) * 128 * bs
        c = build_compressed_index(st, vocab_size=300, block_size=bs, pad_to=pad,
                                   device=dev)
        sa = (c.lcps, c.payload, c.block_base, c.sec_cache)
        kw = dict(term_bits=c.term_bits, lcp_width=c.lcp_width, block_size=bs, len_off=0)
        ids = t(np.arange(c.n_blocks, dtype=np.int32))
        cases.append(("block_expand",
                      lambda x=sa, i=ids, w=kw, n=c.n_rows, n_l=c.n_lanes:
                      expand_into(ops.block_expand, x, i, w, n, n_l, 300),
                      lambda x=sa, i=ids, w=kw, n=c.n_rows, n_l=c.n_lanes:
                      expand_into(ref.block_expand_ref, x, i, w, n, n_l, 300)))
        blk = rng.integers(0, c.n_blocks, 777).astype(np.int32)
        blk[:50] = c.n_blocks - 1
        rows = rng.integers(0, len(st), 777)
        qa = (t(blk), t(st.grams[rows].astype(np.int32)), t(st.lengths[rows].astype(np.int32)))
        cases.append(("block_decode",
                      lambda x=sa, y=qa, w=kw: ops.block_decode(*x, *y, **w),
                      lambda x=sa, y=qa, w=kw: ref.block_decode_ref(*x, *y, **w)))
    return cases


def lm_small_run(model, toks: torch.Tensor) -> list:
    """Prefill the first LM_SMALL_PROMPT tokens, then decode the rest one at
    a time (teacher-forced, so the card and the CPU see the same tokens):
    the float32 logits of the prefill and of each step."""
    p = LM_SMALL_PROMPT
    with torch.inference_mode():
        cache, logits = lm.prefill(model, toks[:, :p], max_seq=toks.shape[1])
        out = [logits]
        for i in range(p, toks.shape[1]):
            logits, cache = lm.decode_step(model, cache, toks[:, i], i)
            out.append(logits)
    return [o.cpu() for o in out]


def lm_reduced_on_card(dev) -> None:
    """(a) Each arch's REDUCED config (float32) with the same seeded weights on
    the card and on the CPU: prefill 2x12 and 6 decode steps (mixtral's
    window of 8 rolls the prompt into its ring and wraps it), every logit
    within LM_F32_TOL (rtol and atol) of the CPU's.  TF32 is off for the
    check, so the card's float32 matmuls are float32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for arch in LM_ARCHS:
            cfg = lm_configs.get(arch).make_reduced()
            cpu = lm.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
            card = copy.deepcopy(cpu).to(dev)
            rng = np.random.default_rng(11)
            toks = torch.as_tensor(rng.integers(
                1, cfg.vocab_size, (2, LM_SMALL_PROMPT + LM_SMALL_STEPS)))
            want, got = lm_small_run(cpu, toks), lm_small_run(card, toks.to(dev))
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            ok = all(torch.allclose(g, w, rtol=LM_F32_TOL, atol=LM_F32_TOL)
                     for g, w in zip(got, want))
            t = lm.cache_len(cfg, LM_SMALL_PROMPT + LM_SMALL_STEPS)
            print(f"lm: {arch} reduced f32, card vs cpu, prefill 2x{LM_SMALL_PROMPT} + "
                  f"{LM_SMALL_STEPS} steps (cache {t} slots): max_abs_err {err:.3e} "
                  f"(tol {LM_F32_TOL} rtol and atol, TF32 off)")
            check(ok, f"{arch} reduced: the card's logits equal the CPU's")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def recorded_routes():
    """Every ``router_topk`` call's expert ids ([T, k], on the card) in call
    order, one a MoE layer a forward or decode step."""
    calls, real = [], lm_moe.router_topk

    def record(x, w_router, cfg):
        ids, gates, logits = real(x, w_router, cfg)
        calls.append(ids.clone())
        return ids, gates, logits
    lm_moe.router_topk = record
    try:
        yield calls
    finally:
        lm_moe.router_topk = real


def kept_claims(ids: torch.Tensor, moe) -> torch.Tensor:
    """[T, k] bool: the claims of a call with these expert ids that the
    capacity kept (both dispatches drop the same claims)."""
    pos = lm_moe.claim_positions(ids, moe.n_experts)
    return pos < moe.capacity(ids.shape[0])


def served_routes(calls: list, n_layers: int, step: int, moe) -> list:
    """For each MoE layer, the expert ids the serving run gave the tokens of
    each sequence up to decode step ``step`` (its prompt in the prefill, then
    one token a step), and which of those claims the capacity kept: [B * n, k]
    each, in a prefill's token order (n = prompt + step + 1)."""
    b, p = LM_BATCH, LM_PROMPT
    n = p + step + 1
    out = []
    for layer in range(n_layers):
        pre = calls[layer]                                          # [B*P, k]
        steps = [calls[n_layers * (1 + j) + layer] for j in range(step + 1)]
        ids = torch.cat([pre.reshape(b, p, -1), torch.stack(steps, 1)], 1)
        keep = torch.cat([kept_claims(pre, moe).reshape(b, p, -1),
                          torch.stack([kept_claims(s, moe) for s in steps], 1)], 1)
        out.append((ids.reshape(b * n, -1), keep.reshape(b * n, -1)))
    return out


def route_changed(served: list, ref_calls: list, moe) -> torch.Tensor:
    """[B] bool: the sequences with a token routed to another set of experts,
    or a claim lost to the capacity, in the serving run or in the prefill,
    at any layer."""
    changed = torch.zeros(LM_BATCH, dtype=torch.bool, device=ref_calls[0].device)
    for (ids, keep), ref in zip(served, ref_calls):
        differ = (ids.sort(-1).values != ref.sort(-1).values).any(-1)
        lost = ~keep.all(-1) | ~kept_claims(ref, moe).all(-1)
        changed |= (differ | lost).reshape(LM_BATCH, -1).any(-1)
    return changed


@contextlib.contextmanager
def pinned_routes(model, served: list):
    """A prefill inside routes every token as the serving run did: each MoE
    layer takes the served expert ids (its gates recomputed from its own
    router logits and renormalised over them, as ``router_topk`` does), the
    claims the serving run dropped get gate 0, and the capacity holds every
    claim.  So the prefill computes, in exact arithmetic, what the serving
    run computed for these tokens."""
    layers = iter(served)
    real = lm_moe.router_topk

    def pinned(x, w_router, cfg):
        ids, keep = next(layers)
        logits = torch.matmul(x.float(), w_router.float())
        gates = torch.softmax(logits, dim=-1).gather(-1, ids)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        return ids, (gates * keep).to(x.dtype), logits
    ffns = [(layer.ffn, layer.ffn.cfg) for layer in model.layers]
    lm_moe.router_topk = pinned
    for ffn, cfg in ffns:
        ffn.cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    try:
        yield
    finally:
        lm_moe.router_topk = real
        for ffn, cfg in ffns:
            ffn.cfg = cfg


def lm_step_bytes(model, cache: dict) -> int:
    """Bytes one decode step must move: every weight but the embedding table
    (the GShard dispatch reads every expert), the batch's embedding rows,
    the whole cache read once and the new entries written."""
    cfg = model.cfg
    weights = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                  if n != "embed")
    cache_read = sum(c.numel() * c.element_size() for c in cache.values())
    written = sum(c[:, :, 0].numel() * c.element_size() for c in cache.values())
    return weights + LM_BATCH * cfg.d_model * model.embed.element_size() + cache_read + written


def serve_cli_llama() -> list:
    """(b) ``python -m repro_torch.launch.serve --arch llama3.2-1b`` at
    repro's defaults, on the card by default: its two lines, parsed."""
    log = PHASE10_DIR.parent / "phase11" / "serve_llama.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    proc = run_cli(["repro_torch.launch.serve", "--arch", "llama3.2-1b"], log)
    check(proc.wait(timeout=300) == 0, f"serve CLI exited 0 (log {log})")
    out = log.read_text()
    m = re.search(r"prefill (\d+)x(\d+) in ([0-9.]+)ms; decode (\d+) steps @ ([0-9.]+) tok/s",
                  out)
    ids = re.search(r"sample generation ids: (\[.*\])", out)
    check(m is not None and ids is not None, f"serve CLI printed repro's two lines: {out!r}")
    check((int(m[1]), int(m[2]), int(m[4])) == (LM_BATCH, LM_PROMPT, LM_STEPS - 1),
          "serve CLI ran repro's defaults")
    print(f"lm: llama3.2-1b CLI (python -m repro_torch.launch.serve --arch llama3.2-1b): "
          f"prefill {m[3]} ms, decode {m[5]} tok/s (first calls, as repro's CLI)")
    return json.loads(ids[1])


def lm_full(dev, arch: str, card: str, cli_ids: list | None) -> dict:
    """(b, c) One arch at full width, through ``serve.generate`` as the CLI
    runs it (cold), then LM_WARM times more (warm); each checked decode step's logits
    against the last-position logits of a prefill of the same tokens."""
    cfg = lm_configs.get(arch).make()
    if arch in LM_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=LM_LAYERS[arch])
    gc.collect()
    torch.cuda.empty_cache()
    reset_peak()
    held = torch.cuda.memory_allocated()
    model = lm.init_params(cfg, dev, torch.Generator(dev).manual_seed(0))
    prompts = lm_serve.draw_prompts(cfg, LM_BATCH, LM_PROMPT)
    with recorded_routes() as routes:
        cold = lm_serve.generate(model, prompts, LM_STEPS)
    warm = [lm_serve.generate(model, prompts, LM_STEPS) for _ in range(LM_WARM)]
    peak = device_peak() - held
    check(all(bool(torch.isfinite(lg).all()) for lg in cold.logits), f"{arch}: finite logits")
    check(all(torch.equal(cold.tokens, w.tokens) for w in warm),
          f"{arch}: the warm runs generate as the cold")
    prefill_s = statistics.median(w.prefill_s for w in warm)
    decode_s = statistics.median(w.decode_s for w in warm)
    if cli_ids is not None:
        check(cold.tokens[0, :16].tolist() == cli_ids,
              f"{arch}: the CLI generated what the in-process run did")

    prompts = prompts.to(dev)
    with torch.inference_mode():
        longest = torch.cat([prompts, cold.tokens], 1)  # every token the run saw
        x_all, _, _ = lm.forward(model, longest)
        refs = []
        for i in LM_CHECKED:
            seq = longest[:, : LM_PROMPT + i + 1]
            with recorded_routes() as ref_routes:
                _, ref = lm.prefill(model, seq, max_seq=seq.shape[1])
            refs.append((seq, ref, ref_routes))
        rows = decode_rows(model, cold.logits, routes, refs)
        for r, (_, ref, _) in zip(rows, refs):
            whole = torch.matmul(x_all[:, LM_PROMPT + r["step"]], model.lm_head).float()
            r["floor"] = (whole - ref).abs().amax(-1).cpu()
            r["ref_max"] = ref.abs().amax(-1).cpu()
        with recorded_routes() as fault_routes, self_slot_masked(model):
            fault_logits = forced_decode(model, prompts, cold.tokens)
        fault_rows = decode_rows(model, fault_logits, fault_routes, refs)
        cache, _ = lm.prefill(model, prompts, max_seq=LM_PROMPT + LM_STEPS)
        step_bytes = lm_step_bytes(model, cache)
    del model, cache, x_all, refs
    gc.collect()
    torch.cuda.empty_cache()

    steps = LM_STEPS - 1
    flops = lm_configs.base.lm_model_flops(cfg, "prefill", LM_BATCH, LM_PROMPT)
    out = {"arch": arch, "layers": cfg.n_layers, "peak_gib": peak / 2**30,
           "prefill_ms": (cold.prefill_s * 1e3, prefill_s * 1e3),
           "step_ms": (cold.decode_s * 1e3 / steps, decode_s * 1e3 / steps),
           "tok_s": LM_BATCH * steps / decode_s, "step_bytes": step_bytes,
           "bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
           "mfu": flops / prefill_s / BF16_FLOPS_PER_S, "rows": rows,
           "fault_rows": fault_rows}
    print(f"lm: {arch} ({cfg.n_layers} layers, bf16) on {card}: prefill "
          f"{LM_BATCH}x{LM_PROMPT} {out['prefill_ms'][1]:.2f} ms warm (median of {LM_WARM}) "
          f"({out['prefill_ms'][0]:.2f} cold), {out['mfu']:.4f} of dense bf16 peak "
          f"({flops / 1e12:.3f} TFLOP); decode {out['step_ms'][1]:.3f} ms a step warm "
          f"({out['step_ms'][0]:.3f} cold), {out['tok_s']:.1f} tok/s; a step reads "
          f"{step_bytes / 1e9:.3f} GB, {out['bound_ms']:.3f} ms at 3.35 TB/s "
          f"({out['step_ms'][1] / out['bound_ms']:.2f}x); peak {out['peak_gib']:.2f} GiB")
    for r in rows:
        print(f"lm: {arch} decode step {r['step']} vs prefill of the same "
              f"{LM_PROMPT + r['step'] + 1} tokens, by sequence: {readings(r)}; prefill "
              f"vs the {LM_PROMPT + LM_STEPS}-token forward "
              f"{[round(v, 4) for v in r['floor'].tolist()]}; |logit| max "
              f"{[round(v, 2) for v in r['ref_max'].tolist()]}")
    for r in fault_rows:
        print(f"lm: {arch} planted fault (token masked from its own slot), decode step "
              f"{r['step']}, by sequence: {readings(r)}")
    return out


def readings(r: dict) -> str:
    """A row's errors by sequence, as the ``lm:`` lines print them."""
    def fmt(key):
        return [round(v, 4) for v in r[key].tolist()]
    out = f"max_abs_err {fmt('max_abs')}, rel_rms {fmt('rel')}"
    if "pinned" in r:
        out += (f"; rerouted or dropped {r['excused'].tolist()}; against the prefill "
                f"routed as served max_abs_err {fmt('pinned')}, rel_rms {fmt('pinned_rel')}")
    return out


def errors(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """[B] max abs error and [B] rms error over the reference's rms."""
    d = got - ref
    rel = d.square().mean(-1).sqrt() / ref.square().mean(-1).sqrt()
    return d.abs().amax(-1).cpu(), rel.cpu()


def decode_rows(model, step_logits: list, routes: list, refs: list) -> list:
    """For each checked decode step i, step i's logits (``step_logits[i +
    1]``, after the prefill's) against the prefill of the same tokens in
    ``refs``; for a MoE arch also whether each sequence was routed apart
    (``routes`` are the serving run's ``router_topk`` calls) and the errors
    against a prefill routed as served."""
    cfg = model.cfg
    rows = []
    for i, (seq, ref, ref_routes) in zip(LM_CHECKED, refs):
        got = step_logits[i + 1]
        row = {"step": i, "excused": torch.zeros(LM_BATCH, dtype=torch.bool)}
        row["max_abs"], row["rel"] = errors(got, ref)
        if cfg.moe is not None:
            served = served_routes(routes, cfg.n_layers, i, cfg.moe)
            row["excused"] = route_changed(served, ref_routes, cfg.moe).cpu()
            with pinned_routes(model, served):
                _, pinned = lm.prefill(model, seq, max_seq=seq.shape[1])
            row["pinned"], row["pinned_rel"] = errors(got, pinned)
        rows.append(row)
    return rows


def forced_decode(model, prompts: torch.Tensor, tokens: torch.Tensor) -> list:
    """``serve.generate``'s prefill and decode steps with ``tokens`` fed in
    place of the argmax: the prefill's logits, then each step's."""
    cache, logits = lm.prefill(model, prompts, max_seq=LM_PROMPT + LM_STEPS)
    out = [logits]
    for i in range(LM_STEPS - 1):
        logits, cache = lm.decode_step(model, cache, tokens[:, i], LM_PROMPT + i)
        out.append(logits)
    return out


@contextlib.contextmanager
def self_slot_masked(model):
    """A planted cache fault: in every decode step each layer's attention
    leaves the new token's own cache slot out of ``live``, so the token does
    not attend to itself (the prefill is untouched)."""
    attns = [layer.attn for layer in model.layers]
    for attn in attns:
        def masked(h, cache, slot, live, positions, real=attn.decode):
            live = live.clone()
            live[slot] = False
            return real(h, cache, slot, live, positions)
        attn.decode = masked
    try:
        yield
    finally:
        for attn in attns:
            del attn.decode


def rule_breaches(r: dict, b: int) -> list:
    """What a checked (step, sequence) breaks of the rule: its decode logits
    within LM_BF16_ATOL (max abs) and LM_BF16_REL (rms relative) of the
    last-position logits of a prefill of the same tokens.  For a MoE arch, a
    sequence whose tokens were routed to another set of experts, or lost a
    claim to the capacity, in the serving run or in that prefill (bf16
    rounding moves near ties; prefill and decode have other capacities) is
    excused from that; every sequence of a MoE arch is held to both limits
    against a prefill routed as the serving run was (``pinned_routes``)."""
    held = [("the prefill's", "max_abs", "rel")] if not bool(r["excused"][b]) else []
    if "pinned" in r:
        held.append(("the prefill routed as served", "pinned", "pinned_rel"))
    out = []
    for what, a, rel in held:
        if not (r[a][b].item() <= LM_BF16_ATOL and r[rel][b].item() <= LM_BF16_REL):
            out.append(f"against {what}: max_abs_err {r[a][b].item():.4f} (limit "
                       f"{LM_BF16_ATOL}), rel_rms {r[rel][b].item():.4f} (limit {LM_BF16_REL})")
    return out


def lm_decode_rule(run: dict) -> None:
    """Every checked (step, sequence) of a full-width run keeps the rule
    (``rule_breaches``), and the planted fault's run breaks it at every
    checked step (in one sequence or more)."""
    excused = caught = 0
    for r, f in zip(run["rows"], run["fault_rows"]):
        for b in range(LM_BATCH):
            where = f"{run['arch']} step {r['step']} sequence {b}"
            excused += bool(r["excused"][b])
            breaches = rule_breaches(r, b)
            check(not breaches, f"{where}: decode logits equal a prefill's ({breaches})")
        at_step = sum(bool(rule_breaches(f, b)) for b in range(LM_BATCH))
        check(at_step > 0, f"{run['arch']} step {r['step']}: the rule catches the planted "
              f"fault (token masked from its own slot) in some sequence")
        caught += at_step
    n = len(run["rows"]) * LM_BATCH
    pinned = (f"; all {n} within them of the prefill routed as served"
              if "pinned" in run["rows"][0] else "")
    print(f"lm: {run['arch']}: {n - excused} of {n} checked positions within "
          f"{LM_BF16_ATOL} (max abs) and {LM_BF16_REL} (rms relative) of the prefill's "
          f"logits, {excused} excused (rerouted or dropped){pinned}; the planted fault "
          f"broke the rule at {caught} of {n}, at every checked step")


def phase_lm(dev, card: str) -> list:
    """Phase 11: LM serving (see the module docstring)."""
    t0 = time.perf_counter()
    lm_reduced_on_card(dev)
    cli_ids = serve_cli_llama()
    runs = [lm_full(dev, arch, card, cli_ids if arch == "llama3.2-1b" else None)
            for arch in LM_ARCHS]
    for run in runs:
        lm_decode_rule(run)
    print(f"lm: phase 11 took {time.perf_counter() - t0:.1f} s")
    return runs


# ------------------------------------------------------------------ phase 12
def tree_leaves(tree) -> dict:
    """name -> float64 host tensor of every leaf of a training tree
    (Stacked leaves stacked)."""
    return {n: (torch.stack(tuple(v)) if isinstance(v, Stacked) else v)
            .detach().double().cpu() for n, v in named_leaves(tree)}


def leaf_err(got: dict, want: dict) -> float:
    """Largest over leaves of the max abs error over the leaf's max abs."""
    return max(float((got[n] - want[n]).abs().max() / max(float(want[n].abs().max()), 1e-30))
               for n in want)


def reduced_train_step(model, batch: dict) -> dict:
    """One ``make_train_step`` of ``model`` (trainable), with the gradient
    it takes: the loss, the gradient norm and lr, and every gradient, moment
    and updated parameter leaf on the host."""
    dev = model.device
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    params = lm.param_tree(model)
    loss, _, grads = lm_train_loop.value_and_grad(
        lambda p, x: lm.loss_fn(model, x), params, b)
    step = lm_train_loop.make_train_step(lambda p, x: lm.loss_fn(model, x),
                                         lm_optimizer.OptimizerConfig(**TRAIN_OPT))
    params, state, m = step(params, lm_optimizer.init_state(params), b)
    return {"loss": float(loss), "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
            "grads": tree_leaves(grads), "m": tree_leaves(state["m"]),
            "params": tree_leaves(params)}


def train_reduced_on_card(dev) -> None:
    """(a) Each arch's REDUCED config in float32, the same seeded weights on
    the card and on the CPU: one ``make_train_step`` on one batch.  The
    loss, the gradient norm, every gradient leaf and every first moment
    (linear in the gradient) within TRAIN_F32_TOL of the CPU's (max abs
    error over the leaf's max abs); every updated parameter within 1e-6 of
    its leaf's scale, but for entries whose gradient is so near 0 that a
    rounding flips its sign in Adam's ``m / sqrt(v)`` and moves it by up
    to 2 lr: fewer than 1e-3 of a leaf's, each within 2 lr.  TF32 is off."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for arch in LM_ARCHS:
            cfg = lm_configs.get(arch).make_reduced()
            cpu = lm.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
            card = copy.deepcopy(cpu).to(dev)
            batch = lm_loader.SyntheticLMLoader(cfg.vocab_size, 16, 4).batch_at(0)
            want = reduced_train_step(cpu.requires_grad_(True), batch)
            got = reduced_train_step(card.requires_grad_(True), batch)
            lr = want["lr"]
            loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            gn_err = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
            g_err, m_err = leaf_err(got["grads"], want["grads"]), leaf_err(got["m"], want["m"])
            p_max, flipped = 0.0, 0
            for n, w in want["params"].items():
                d = (got["params"][n] - w).abs()
                tight = 1e-6 * float(w.abs().max())
                p_max = max(p_max, float(d.max()) / lr)
                far = int((d > tight + 1e-6 * lr).sum())
                flipped += far
                check(float(d.max()) <= tight + 2 * lr and far < 1e-3 * d.numel(),
                      f"{arch} reduced: updated {n} within the update rule")
            print(f"train: {arch} reduced f32, card vs cpu, one make_train_step on "
                  f"4x16: loss err {loss_err:.2e}, grad norm err {gn_err:.2e}, gradient "
                  f"{g_err:.2e} and first moment {m_err:.2e} of the leaf's max abs (tol "
                  f"{TRAIN_F32_TOL}); updated params max {p_max:.3e} lr apart, {flipped} "
                  f"entries past 1e-6 of their leaf (TF32 off)")
            check(max(loss_err, gn_err, g_err, m_err) <= TRAIN_F32_TOL,
                  f"{arch} reduced: the card's train step equals the CPU's")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def state_bytes(model) -> tuple[int, int, int]:
    """(parameters, bytes of the weights, bytes of weights + grads + float32
    moments)."""
    n = sum(p.numel() for p in model.parameters())
    w = sum(p.numel() * p.element_size() for p in model.parameters())
    return n, w, 2 * w + 8 * n


def first_train_batch(cfg, dev) -> dict:
    """``launch.train``'s batch of step 0, on ``dev``."""
    loader = lm_loader.LMBatchLoader(lm_train.train_corpus(cfg, TRAIN_CORPUS_TOKENS),
                                     TRAIN_SEQ, TRAIN_BATCH, seed=0)
    return {k: torch.as_tensor(v, device=dev) for k, v in loader.batch_at(0).items()}


def train_full(dev, cfg, steps: int) -> dict:
    """``launch.train.train`` of ``cfg`` for ``steps`` steps on the card, no
    checkpoint: step seconds, losses, peak over what was held before."""
    gc.collect()
    torch.cuda.empty_cache()
    reset_peak()
    held = torch.cuda.memory_allocated()
    ckpt = PHASE12_DIR / f"main_{int(cfg.remat)}"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        run = lm_train.train(cfg, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             corpus_tokens=TRAIN_CORPUS_TOKENS,
                             ckpt_dir=str(ckpt), ckpt_every=steps + 1, device=dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out = {"peak": device_peak() - held, "step_s": run.step_s, "losses": run.losses,
           "bytes": state_bytes(run.model), "retries": run.retries}
    # where a warm step's time goes: the loss and its gradient, then the update
    model, state = run.model, run.state
    batch = first_train_batch(cfg, dev)
    grad_s, update_s = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, grads = lm_train_loop.value_and_grad(lambda p, b: lm.loss_fn(model, b),
                                                   state["params"], batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, state["opt"], _ = lm_optimizer.apply_updates(
            state["params"], grads, state["opt"], lm_optimizer.OptimizerConfig())
        torch.cuda.synchronize()
        grad_s.append(t1 - t0)
        update_s.append(time.perf_counter() - t1)
        del grads
    out["grad_s"], out["update_s"] = statistics.median(grad_s), statistics.median(update_s)
    del run, model, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_child(out_path: str) -> None:
    """The recovery check, in a process of its own started with
    ``CUBLAS_WORKSPACE_CONFIG`` set, under deterministic algorithms: the
    first step's gradients with and without remat; an uninterrupted run of
    TRAIN_STEPS; a run checkpointing every TRAIN_CKPT_EVERY steps with a
    failure injected at TRAIN_FAIL_AT (one save, one restore).  Writes its
    readings as JSON to ``out_path``."""
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda")
    cfg = lm_configs.get(TRAIN_ARCH).make()
    model = lm.init_params(cfg, dev, torch.Generator(dev).manual_seed(0)).requires_grad_(True)
    batch = first_train_batch(cfg, dev)
    grads = []
    for remat in (True, False):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        _, _, g = lm_train_loop.value_and_grad(lambda p, b: lm.loss_fn(model, b),
                                               lm.param_tree(model), batch)
        grads.append(lm_tree.tensors(g))
    remat_equal = all(torch.equal(a, b) for a, b in zip(*grads))
    _, weights, need = state_bytes(model)
    del model, grads, g
    gc.collect()
    torch.cuda.empty_cache()

    root = PHASE12_DIR / "recovery"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    ckpt_bytes = need - weights          # weights and moments on disk, no grads
    check(free >= 1.25 * ckpt_bytes, f"phase 12 needs {1.25 * ckpt_bytes / 1e9:.1f} GB free "
          f"under {root} for its checkpoint; the disk has {free / 1e9:.1f} GB")
    try:
        whole = lm_train.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                               corpus_tokens=TRAIN_CORPUS_TOKENS,
                               ckpt_dir=str(root / "whole"), ckpt_every=TRAIN_STEPS + 1,
                               device=dev)
        ref = lm_tree.tensors(whole.state)
        whole_losses, whole_step_s = whole.losses, whole.step_s
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        cut = lm_train.train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             corpus_tokens=TRAIN_CORPUS_TOKENS,
                             ckpt_dir=str(root / "cut"), ckpt_every=TRAIN_CKPT_EVERY,
                             device=dev, injector=lm_fault.FailureInjector({TRAIN_FAIL_AT}))
        got = lm_tree.tensors(cut.state)
        equal = len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref))
        events = cut.ckpt.events
        result = {"remat_equal": remat_equal, "equal": equal, "n_tensors": len(ref),
                  "retries": cut.retries, "steps_run": len(cut.step_s),
                  "losses": whole_losses, "cut_losses": cut.losses,
                  "step_s": whole_step_s, "events": events, "free": free}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    Path(out_path).write_text(json.dumps(result))


def train_recovery(card: str) -> dict:
    """Run :func:`train_child` in a fresh process and read its readings."""
    PHASE12_DIR.mkdir(parents=True, exist_ok=True)
    out, log = PHASE12_DIR / "recovery.json", PHASE12_DIR / "recovery.log"
    out.unlink(missing_ok=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    gc.collect()
    torch.cuda.empty_cache()
    with open(log, "w") as f:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--train-child", str(out)], env=env, stdout=f,
                              stderr=subprocess.STDOUT, timeout=900)
    check(proc.returncode == 0, f"the recovery process exited 0 (log {log}: "
          f"{log.read_text()[-3000:]})")
    return json.loads(out.read_text())


def phase_train(dev, card: str) -> dict:
    """Phase 12: LM training (see the module docstring)."""
    t0 = time.perf_counter()
    train_reduced_on_card(dev)
    cfg = lm_configs.get(TRAIN_ARCH).make()
    on = train_full(dev, cfg, TRAIN_STEPS)
    off = train_full(dev, dataclasses.replace(cfg, remat=False), TRAIN_REMAT_OFF_STEPS)
    rec = train_recovery(card)

    n_params, _, wgm = on["bytes"]
    flops = lm_configs.base.lm_model_flops(cfg, "train", TRAIN_BATCH, TRAIN_SEQ)
    warm = statistics.median(on["step_s"][1:])
    warm_off = statistics.median(off["step_s"][1:])
    det = statistics.median(rec["step_s"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    losses = on["losses"]
    check(all(np.isfinite(losses)) and len(losses) == TRAIN_STEPS and on["retries"] == 0,
          "the full-width run took every step, its losses finite")
    check(losses[-1] < losses[0], f"the loss falls: step 0 {losses[0]:.4f}, step "
          f"{TRAIN_STEPS - 1} {losses[-1]:.4f}")
    print(f"train: {TRAIN_ARCH} ({cfg.n_layers} layers, d {cfg.d_model}, bf16, remat) "
          f"through launch.train on {card}: batch {TRAIN_BATCH}x{TRAIN_SEQ}, "
          f"{n_params / 1e9:.3f} G params; step "
          f"{warm * 1e3:.2f} ms warm (median of {TRAIN_STEPS - 1}; first "
          f"{on['step_s'][0] * 1e3:.1f} ms), {tokens / warm:.0f} tokens/s, "
          f"{flops / warm / BF16_FLOPS_PER_S:.4f} of dense bf16 peak ({flops / 1e12:.3f} "
          f"TFLOP a step, lm_model_flops); peak {on['peak'] / 2**30:.2f} GiB against "
          f"weights + grads + moments {wgm / 2**30:.2f} GiB; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} by step {TRAIN_STEPS - 1}")
    print(f"train: a warm step's parts (median of 3): loss and gradient "
          f"{on['grad_s'] * 1e3:.2f} ms, AdamW update {on['update_s'] * 1e3:.2f} ms")
    print(f"train: remat off, {TRAIN_REMAT_OFF_STEPS} steps: step {warm_off * 1e3:.2f} ms "
          f"warm (remat on {warm * 1e3:.2f}; loss and gradient {off['grad_s'] * 1e3:.2f} "
          f"ms), peak {off['peak'] / 2**30:.2f} GiB (remat on {on['peak'] / 2**30:.2f})")
    check(rec["remat_equal"], "the first step's gradients with and without remat are "
          "bit-equal (deterministic algorithms)")
    save = next(e for e in rec["events"] if e["kind"] == "save")
    restore = next(e for e in rec["events"] if e["kind"] == "restore")
    check(rec["retries"] == 1 and rec["steps_run"] == TRAIN_STEPS + TRAIN_FAIL_AT
          - TRAIN_CKPT_EVERY and len(rec["events"]) == 2,
          f"the recovery run made one save and one restore and replayed from step "
          f"{TRAIN_CKPT_EVERY} ({rec['retries']} restarts, {rec['steps_run']} steps run)")
    check(rec["equal"], f"the recovered run's final params, moments and step "
          f"({rec['n_tensors']} tensors) are bit-equal to the uninterrupted run's")
    check(rec["cut_losses"][-1] == rec["losses"][-1], "the recovered run's last loss is "
          "the uninterrupted run's")
    print(f"train: recovery on {card}, deterministic algorithms "
          f"(CUBLAS_WORKSPACE_CONFIG=:4096:8, a process of its own): {TRAIN_STEPS} steps, "
          f"a checkpoint every {TRAIN_CKPT_EVERY}, a failure at step {TRAIN_FAIL_AT}: "
          f"final params, moments and step bit-equal to an uninterrupted run "
          f"({rec['n_tensors']} tensors); save {save['copy_s']:.2f} s to host + "
          f"{save['write_s']:.2f} s written ({save['bytes'] / 1e9:.3f} GB), restore "
          f"{restore['seconds']:.2f} s ({restore['bytes'] / 1e9:.3f} GB, a warm read: "
          f"the file cache holds the files just written); {rec['free'] / 1e9:.0f} GB "
          f"free under the checkpoint directory")
    print(f"train: deterministic step {det * 1e3:.2f} ms warm against {warm * 1e3:.2f} "
          f"ms ({det / warm:.3f}x); first step's gradients bit-equal with and without "
          f"remat")
    print(f"train: phase 12 took {time.perf_counter() - t0:.1f} s")
    return {"warm_s": warm, "rec": rec, "peak": on["peak"]}


# ------------------------------------------------------------------ phase 13
def recsys_batch(arch: str, cfg, step: int, batch: int) -> dict:
    """The seeded numpy batch of a recsys arch's training loss."""
    if arch == "bst":
        return recsys_data.BehaviorSeqGen(cfg.item_vocab, cfg.seq_len).batch_at(step, batch)
    if arch == "two-tower-retrieval":
        return recsys_data.RetrievalGen(cfg.item_vocab, cfg.user_feat).batch_at(step, batch)
    return recsys_data.CTRBatchGen((cfg.field_vocab,) * cfg.n_sparse).batch_at(step, batch)


def graph_batch(g, mask_every: int = 0) -> dict:
    """A full-batch GIN batch of graph ``g``: every edge, every label (or,
    with ``mask_every``, every ``mask_every``-th edge and node masked out)."""
    b = {"features": g.features, "edge_src": g.edge_index[0],
         "edge_dst": g.edge_index[1], "labels": g.labels}
    if mask_every:
        b["edge_mask"] = np.arange(g.n_edges) % mask_every != 0
        b["label_mask"] = np.arange(g.n_nodes) % mask_every != 0
    return b


def on(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def to_host(model):
    """A CPU copy of a recsys or GIN model (its tree copied leaf by leaf)."""
    return type(model)(model.cfg, lm_tree.map_leaves(lambda t: t.detach().cpu(),
                                                     model.tree()))


def model_module(cfg):
    return gnn if isinstance(cfg, gnn.GINConfig) else recsys


def loss_and_grads(model, batch: dict):
    """(loss, grads tree) of ``model``'s training loss on ``batch``."""
    mod, cfg = model_module(model.cfg), model.cfg
    loss, _, grads = lm_train_loop.value_and_grad(
        lambda p, b: mod.loss_fn(p, b, cfg), mod.param_tree(model), on(batch, model.device))
    return float(loss), grads


def tree_err(got, want) -> float:
    """Largest over leaves of the max abs error over the leaf's max abs, for
    trees on any two devices: taken on ``got``'s device, a slice at a time
    (a leaf may be a 10 GB table)."""
    worst = 0.0
    want = dict(named_leaves(want))
    for name, g in named_leaves(got):
        w = want[name]
        g, w = g.detach().reshape(-1), w.detach().reshape(-1)
        err, scale = 0.0, 0.0
        for lo in range(0, g.numel(), 1 << 26):
            ws = w[lo:lo + (1 << 26)].to(g.device, torch.float32)
            err = max(err, float((g[lo:lo + (1 << 26)].float() - ws).abs().max()))
            scale = max(scale, float(ws.abs().max()))
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def reduced_recsys_gnn_on_card(dev) -> None:
    """(a) Each recsys arch's and gin-tu's REDUCED config in float32, the
    same seeded weights on the card and on the CPU: one ``make_train_step``;
    loss, every gradient leaf and every first-moment leaf within
    RG_F32_TOL of the CPU's (of the leaf's max abs)."""
    for arch in RG_ARCHS:
        cfg = lm_configs.get(arch).make_reduced()
        mod = model_module(cfg)
        cpu = mod.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
        card = copy.deepcopy(cpu).to(dev)
        if arch == "gin-tu":
            batch = graph_batch(graph.random_graph(300, 2000, cfg.d_feat, cfg.n_classes,
                                                   seed=1), mask_every=5)
        else:
            batch = recsys_batch(arch, cfg, 0, 64)
        out = []
        for model in (cpu.requires_grad_(True), card.requires_grad_(True)):
            params = mod.param_tree(model)
            b = on(batch, model.device)
            loss, _, grads = lm_train_loop.value_and_grad(
                lambda p, x: mod.loss_fn(p, x, cfg), params, b)
            step = lm_train_loop.make_train_step(lambda p, x: mod.loss_fn(p, x, cfg),
                                                 lm_optimizer.OptimizerConfig(**TRAIN_OPT))
            _, state, _ = step(params, lm_optimizer.init_state(params), b)
            out.append((float(loss), grads, state["m"]))
        (lw, gw, mw), (lg, gg, mg) = out
        loss_err = abs(lg - lw) / abs(lw)
        g_err, m_err = tree_err(gg, gw), tree_err(mg, mw)
        print(f"recsys: {arch} reduced f32, card vs cpu, one make_train_step: loss err "
              f"{loss_err:.2e}, gradient {g_err:.2e} and first moment {m_err:.2e} of the "
              f"leaf's max abs (tol {RG_F32_TOL}, TF32 off)")
        check(max(loss_err, g_err, m_err) <= RG_F32_TOL,
              f"{arch} reduced: the card's train step equals the CPU's")


def full_width_on_card(dev) -> dict:
    """(b) Each arch at full width in float32 (gin-tu as ``repro``'s
    build_cell builds it, at full_graph_sm): one loss and gradient at batch
    RG_CHECK_BATCH on the card against the same weights on the host CPU.
    Returns each recsys arch's card model, for (c)."""
    models = {}
    for arch in RG_ARCHS:
        t0 = time.perf_counter()
        if arch == "gin-tu":
            shape = gin_tu.SHAPES["full_graph_sm"]
            cfg = gin_tu.cell_config(shape)
            d = shape.dims
            batch = graph_batch(graph.random_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                                                   d["n_classes"], seed=0))
            what = f"full_graph_sm ({d['n_nodes']} nodes, {d['n_edges']} edges)"
        else:
            cfg = lm_configs.get(arch).make()
            batch = recsys_batch(arch, cfg, 0, RG_CHECK_BATCH)
            what = f"batch {RG_CHECK_BATCH}"
        mod = model_module(cfg)
        card = mod.init_params(cfg, dev, torch.Generator(dev).manual_seed(0))
        cpu = to_host(card).requires_grad_(True)
        card.requires_grad_(True)
        lg, gg = loss_and_grads(card, batch)
        lw, gw = loss_and_grads(cpu, batch)
        del cpu
        loss_err, g_err = abs(lg - lw) / abs(lw), tree_err(gg, gw)
        n = sum(p.numel() for p in card.parameters())
        print(f"recsys: {arch} full width ({n / 1e6:.1f} M params, f32"
              f"{', node features bf16 on the wire' if arch == 'gin-tu' else ''}), card "
              f"vs host cpu, loss and gradient at {what}: loss {lg:.6f}, loss err "
              f"{loss_err:.2e}, gradient {g_err:.2e} of the leaf's max abs (tol "
              f"{RG_F32_TOL}); {time.perf_counter() - t0:.1f} s")
        check(np.isfinite(lg) and max(loss_err, g_err) <= RG_F32_TOL,
              f"{arch} full width: the card's loss and gradient equal the CPU's")
        del gg, gw
        if arch != "gin-tu":
            models[arch] = card
    gc.collect()
    return models


def timed(fn, reps: int) -> tuple[float, float]:
    """(first, median of ``reps`` warm) seconds of ``fn()``, each synchronized."""
    out = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out[0], statistics.median(out[1:])


def train_step_fn(model, batch_on_card: dict):
    """One AdamW train step of ``model`` on the batch, state kept across calls."""
    mod, cfg = model_module(model.cfg), model.cfg
    params = mod.param_tree(model)
    state = lm_optimizer.init_state(params)
    step = lm_train_loop.make_train_step(lambda p, b: mod.loss_fn(p, b, cfg),
                                         lm_optimizer.OptimizerConfig())

    def run():
        nonlocal state
        _, state, m = step(params, state, batch_on_card)
        return m
    return run, state


def recsys_train_timed(dev, arch: str, model) -> dict:
    """A warm train step at the largest power of two up to train_batch that
    fits the card."""
    cfg = model.cfg
    b = recsys_configs.SHAPES["train_batch"].dims["batch"]
    batch = run = state = None
    while True:
        gc.collect()
        torch.cuda.empty_cache()
        reset_peak()
        try:
            batch = on(recsys_batch(arch, cfg, 1, b), dev)
            run, state = train_step_fn(model, batch)
            cold, warm = timed(run, RG_WARM)
            break
        except torch.cuda.OutOfMemoryError:
            batch = run = state = None
            b //= 2
            check(b >= 512, f"{arch}: a train step fits the card at batch 512")
    loss = float(run()["loss"])
    peak = device_peak()
    del run, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": b, "cold": cold, "warm": warm, "loss": loss, "peak": peak}


def recsys_flops(arch: str, cfg, batch: int) -> float:
    if arch == "bst":
        return bst_configs._flops(cfg, batch)
    if arch == "autoint":
        return autoint_configs._flops(cfg, batch)
    if arch == "xdeepfm":
        return xdeepfm_configs._flops(cfg, batch)
    return two_tower_configs._flops(cfg, batch)


def recsys_timed(dev, models: dict, card: str) -> dict:
    """(c) The recsys archs on the card: a train step at train_batch (or the
    largest power of two below it that fits), serve_p99 and, for two-tower
    and BST, retrieval_cand.  Each arch's train step: its batch and peak."""
    steps = {}
    for arch in RG_TIMED_ORDER:
        model = models.pop(arch).requires_grad_(False)
        cfg = model.cfg
        full = recsys_configs.SHAPES["train_batch"].dims["batch"]
        with torch.no_grad():
            p99 = on(recsys_batch(arch, cfg, 2, recsys_configs.SHAPES["serve_p99"]
                                  .dims["batch"]), dev)
            params = recsys.param_tree(model)
            fwd = (lambda: recsys.twotower_embed(params, p99, cfg)) \
                if arch == "two-tower-retrieval" else (lambda: model(p99))
            _, p99_s = timed(fwd, RG_WARM)
            n_p99 = recsys_configs.SHAPES["serve_p99"].dims["batch"]
            fl = recsys_flops(arch, cfg, n_p99)
            line = (f"serve_p99 (batch {n_p99}) {p99_s * 1e3:.3f} ms, "
                    f"{n_p99 / p99_s:.0f} samples/s, {fl / p99_s / F32_FLOPS_PER_S:.4f} of "
                    f"the f32 peak")
            if arch in ("two-tower-retrieval", "bst"):
                n = recsys_configs.SHAPES["retrieval_cand"].dims["n_candidates"]
                rng = np.random.default_rng(3)
                if arch == "two-tower-retrieval":
                    cand = {"user": torch.as_tensor(rng.standard_normal(
                                (1, cfg.user_feat)).astype(np.float32), device=dev),
                            "candidates": torch.as_tensor(rng.integers(
                                0, cfg.item_vocab, n).astype(np.int32), device=dev)}
                    score = lambda: recsys.twotower_score_candidates(params, cand, cfg)
                    fl = two_tower_configs._retrieval_flops(cfg, n)
                else:    # one user's history against 1M candidate targets
                    hist = rng.integers(0, cfg.item_vocab, (1, cfg.seq_len))
                    cand = {"history": torch.as_tensor(np.repeat(hist, n, 0).astype(np.int32),
                                                       device=dev),
                            "target": torch.as_tensor(rng.integers(
                                0, cfg.item_vocab, n).astype(np.int32), device=dev),
                            "labels": None}
                    score = lambda: recsys.bst_forward(params, cand, cfg)
                    fl = bst_configs._flops(cfg, n)
                reset_peak()
                scores = score()
                check(bool(torch.isfinite(scores).all()) and scores.numel() == n,
                      f"{arch}: retrieval_cand scores are finite, one a candidate")
                del scores
                _, cand_s = timed(score, RG_WARM)
                line += (f"; retrieval_cand (1 x {n:,}) {cand_s * 1e3:.3f} ms, "
                         f"{n / cand_s:.0f} candidates/s, {fl / cand_s / F32_FLOPS_PER_S:.4f} "
                         f"of the f32 peak, peak {device_peak() / 2**30:.2f} GiB")
                del cand, score
        model.requires_grad_(True)
        r = recsys_train_timed(dev, arch, model)
        fl = 3 * recsys_flops(arch, cfg, r["batch"])
        cut = "" if r["batch"] == full else f" (cut from {full:,}: the card holds no more)"
        print(f"recsys: {arch} full width on {card}: train step at batch {r['batch']:,}"
              f"{cut} {r['warm'] * 1e3:.2f} ms warm (median of {RG_WARM}; first "
              f"{r['cold'] * 1e3:.1f} ms), {r['batch'] / r['warm']:.0f} samples/s, "
              f"{fl / r['warm'] / F32_FLOPS_PER_S:.4f} of the f32 peak ({fl / 1e9:.2f} "
              f"GFLOP a step, 3x the config's _flops), peak {r['peak'] / 2**30:.2f} GiB, "
              f"loss {r['loss']:.4f}; {line}")
        check(np.isfinite(r["loss"]), f"{arch}: the train step's loss is finite")
        steps[arch] = r
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return steps


def gin_timed(dev, name: str, batch: dict, n_edges: int, card: str,
              note: str = "") -> int:
    """(c) A warm GIN train step of ``repro``'s build_cell model at ``name``;
    its peak bytes."""
    shape = gin_tu.SHAPES[name]
    cfg = gin_tu.cell_config(shape)
    model = gnn.init_params(cfg, dev, torch.Generator(dev).manual_seed(0)).requires_grad_(True)
    gc.collect()
    torch.cuda.empty_cache()
    reset_peak()
    b = on(batch, dev)
    run, state = train_step_fn(model, b)
    cold, warm = timed(run, RG_WARM)
    loss = float(run()["loss"])
    fl = gin_tu.model_flops(shape)
    n_nodes = batch["features"].shape[0]
    peak = device_peak()
    print(f"gnn: gin-tu {name} on {card} ({n_nodes:,} nodes, {n_edges:,} edges, d_feat "
          f"{cfg.d_feat}, bf16 on the wire{note}): train step {warm * 1e3:.2f} ms warm "
          f"(median of {RG_WARM}; first {cold * 1e3:.1f} ms), {n_edges / warm:.3e} edges/s, "
          f"{fl / warm / F32_FLOPS_PER_S:.4f} of the f32 peak ({fl / 1e9:.2f} GFLOP a step, "
          f"model_flops), peak {peak / 2**30:.2f} GiB, loss {loss:.4f}")
    check(np.isfinite(loss), f"gin-tu {name}: the train step's loss is finite")
    del model, run, state, b
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def save_npz(path: Path, **arrays) -> None:
    """``np.savez`` to ``path``, renamed into place once whole."""
    tmp = path.with_name(path.stem + ".part.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


#: where the corpus process writes phase 7's and phase 8's corpora
CORPUS_DIR = Path(__file__).resolve().parent / "build" / "corpora"


def corpus_child(out_dir: str) -> None:
    """Phase 3's, phase 7's and phase 8's corpora, made in a process of its
    own (no CUDA) from the script's start, beside the kernels' build and the
    card's work: phase 3's corpus (``main.npz``), the same with a year
    bucket a document (``ext.npz``; phase 7 checks its stream is phase
    3's), then BIG_TERMS (``big.npz``), each with the seconds its making
    took."""
    out = Path(out_dir)
    t0 = time.perf_counter()
    toks = corpus.zipf_corpus(MAIN_TERMS, corpus.NYT, seed=0, duplicate_frac=0.02)
    save_npz(out / "main.npz", toks=toks, gen_s=time.perf_counter() - t0)
    del toks
    t0 = time.perf_counter()
    toks, years = corpus.zipf_corpus(MAIN_TERMS, corpus.NYT, seed=0, duplicate_frac=0.02,
                                     with_years=True)
    save_npz(out / "ext.npz", toks=toks, years=years, gen_s=time.perf_counter() - t0)
    del toks, years
    t0 = time.perf_counter()
    big = corpus.zipf_corpus(BIG_TERMS, corpus.NYT, seed=0, duplicate_frac=0.02)
    save_npz(out / "big.npz", toks=big, gen_s=time.perf_counter() - t0)


class CorpusProcess:
    """The running ``--corpus-child`` process (the numpy generator takes
    about 17 s for each 2**25-term corpus and 67 s for BIG_TERMS on the
    card's host, time the card would otherwise wait through)."""

    def __init__(self):
        CORPUS_DIR.mkdir(parents=True, exist_ok=True)
        for f in CORPUS_DIR.glob("*.npz"):
            f.unlink()
        self.log = CORPUS_DIR / "corpus.log"
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--corpus-child",
                 str(CORPUS_DIR)], stdout=f, stderr=subprocess.STDOUT)

    def wait(self, name: str) -> dict:
        """The arrays of ``<name>.npz`` once written, its file removed."""
        path = CORPUS_DIR / f"{name}.npz"
        out = wait_for(path, self.proc, self.log)
        path.unlink()
        return out

    def close(self) -> None:
        """Check the process exited 0 (it has written both corpora), or stop
        it if it still runs."""
        if self.proc.poll() is None:
            self.proc.kill()
        check(self.proc.wait() == 0, f"the corpus process exited 0 (log {self.log})")


def graph_child(out_dir: str, name: str) -> None:
    """One of phase 13's large host graphs, made in a process of its own (no
    CUDA) while the card runs the rest of the phase: ogb_products' random
    graph, or minibatch_lg's Reddit-sized one, its CSR table and a fanout
    15-10 sample of 1,024 seeds.  It lands in ``out_dir`` as
    ``<name>.npz`` with the seconds its parts took."""
    out = Path(out_dir)
    d = gin_tu.SHAPES[name].dims
    t0 = time.perf_counter()
    if name == "ogb_products":
        g = graph.random_graph(d["n_nodes"], d["n_edges"], d["d_feat"], d["n_classes"],
                               seed=0)
        save_npz(out / "ogb_products.npz", edge_index=g.edge_index, features=g.features,
                 labels=g.labels, n_nodes=g.n_nodes, gen_s=time.perf_counter() - t0)
        return
    t0 = time.perf_counter()
    g = graph.random_graph(d["n_nodes"], d["n_edges"], d["d_feat"], d["n_classes"], seed=0)
    t1 = time.perf_counter()
    table = graph.CSRNeighborTable(g)
    t2 = time.perf_counter()
    seeds = np.random.default_rng(1).choice(g.n_nodes, d["batch_nodes"], replace=False)
    sub = graph.sample_subgraph(g, table, seeds, d["fanout"], seed=2)
    t3 = time.perf_counter()
    n_sub = sub.features.shape[0]
    save_npz(out / "minibatch_lg.npz", features=sub.features, edge_src=sub.edge_src,
             edge_dst=sub.edge_dst, edge_mask=sub.edge_mask,
             labels=np.pad(sub.labels, (0, n_sub - sub.n_seeds)),
             label_mask=np.arange(n_sub) < sub.n_seeds, n_edges=g.n_edges,
             gen_s=t1 - t0, csr_s=t2 - t1, sample_s=t3 - t2)


def wait_for(path: Path, proc: subprocess.Popen, log: Path) -> dict:
    """The arrays of ``path`` once its graph process has written it."""
    t0 = time.perf_counter()
    while not path.exists():
        check(proc.poll() is None or path.exists(), f"the graph process wrote {path.name} "
              f"(log {log}: {log.read_text()[-3000:]})")
        time.sleep(0.1)
    out = dict(np.load(path))
    out["waited_s"] = time.perf_counter() - t0
    return out


def dst_partitioned_rank(mesh, graph_path: str, name: str, compare: bool) -> dict:
    """GIN's dst-partitioned loss and gradient of ``repro``'s build_cell
    model at shape ``name`` on this rank, for the graph saved at
    ``graph_path``; with ``compare``, the one-device ``loss_fn``'s on the
    same batch too."""
    st = np.load(graph_path)
    g = graph.Graph(st["edge_index"], st["features"], st["labels"], int(st["n_nodes"]))
    cfg = gin_tu.cell_config(gin_tu.SHAPES[name])
    src, dst, mask = graph.partition_edges_by_dst(g, mesh.size)
    batch = {"features": g.features, "edge_src": src, "edge_dst": dst, "edge_mask": mask,
             "labels": g.labels, "label_mask": np.ones(g.n_nodes, bool)}
    dev = mesh.device
    model = gnn.init_params(cfg, dev, torch.Generator(dev).manual_seed(0)).requires_grad_(True)
    b = on(batch, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, grads = lm_train_loop.value_and_grad(
        lambda p, x: gnn.loss_fn_dst_partitioned(p, x, cfg, mesh), gnn.param_tree(model), b)
    torch.cuda.synchronize()
    out = {"loss": float(loss), "seconds": time.perf_counter() - t0,
           "grads": lm_tree.tree_to_numpy(grads), "backend": mesh.backend,
           "comm_bytes": mesh.comm_bytes, "comm_s": mesh.comm_seconds,
           "edges": int(src.shape[0])}
    if compare:
        del grads
        one, ref = loss_and_grads(model, batch)
        out["one_loss"] = one
        out["one_err"] = tree_err(lm_tree.map_leaves(torch.from_numpy, out["grads"]), ref)
    return out


def dst_partitioned_on_card(dev, card: str, ogb_path: Path) -> None:
    """(d) ``loss_fn_dst_partitioned`` at full_graph_sm on RG_GLOO_RANKS gloo
    ranks sharing the card, and at ogb_products (the graph process's file)
    on one NCCL rank, started beside them: each loss within
    RG_DIST_LOSS_TOL, each all-reduced gradient within RG_F32_TOL, of the
    one-device ``loss_fn``."""
    d = gin_tu.SHAPES["full_graph_sm"].dims
    g = graph.random_graph(d["n_nodes"], d["n_edges"], d["d_feat"], d["n_classes"], seed=0)
    cora_path = PHASE13_DIR / "full_graph_sm.npz"
    save_npz(cora_path, edge_index=g.edge_index, features=g.features, labels=g.labels,
             n_nodes=g.n_nodes)
    kbuild.build()           # once, before two threads spawn ranks
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nccl = pool.submit(spawn_ranks, 1, dst_partitioned_rank, str(ogb_path),
                           "ogb_products", True, device=dev, backend="nccl")
        gloo = spawn_ranks(RG_GLOO_RANKS, dst_partitioned_rank, str(cora_path),
                           "full_graph_sm", False, device=dev, backend="gloo")
        gloo_s = time.perf_counter() - t0
        nccl = nccl.result()
    both_s = time.perf_counter() - t0
    # full_graph_sm's one-device reference, here
    cfg = gin_tu.cell_config(gin_tu.SHAPES["full_graph_sm"])
    model = gnn.init_params(cfg, dev, torch.Generator(dev).manual_seed(0)).requires_grad_(True)
    src, dst, mask = graph.partition_edges_by_dst(g, RG_GLOO_RANKS)
    one, ref = loss_and_grads(model, {"features": g.features, "edge_src": src,
                                      "edge_dst": dst, "edge_mask": mask,
                                      "labels": g.labels})
    cora = (one, [tree_err(lm_tree.map_leaves(torch.from_numpy, r["grads"]), ref)
                  for r in gloo])
    del model, ref
    for name, ranks, (one, errs), backend, n in (
            ("full_graph_sm", gloo, cora, "gloo", d["n_nodes"]),
            ("ogb_products", nccl, (nccl[0]["one_loss"], [nccl[0]["one_err"]]), "nccl",
             gin_tu.SHAPES["ogb_products"].dims["n_nodes"])):
        loss_errs = [abs(r["loss"] - one) / abs(one) for r in ranks]
        print(f"gnn: loss_fn_dst_partitioned at {name} ({n:,} nodes, "
              f"{ranks[0]['edges'] * len(ranks):,} padded edges) on {len(ranks)} {backend} "
              f"rank{'s' if len(ranks) > 1 else ''} ({card}): loss {ranks[0]['loss']:.6f}, "
              f"err {max(loss_errs):.2e} of the one-device loss_fn's (tol "
              f"{RG_DIST_LOSS_TOL}), all-reduced gradient {max(errs):.2e} of the leaf's "
              f"max abs (tol {RG_F32_TOL}); loss and gradient "
              f"{max(r['seconds'] for r in ranks) * 1e3:.1f} ms a rank (cold), "
              f"{ranks[0]['comm_bytes'] / 1e6:.2f} MB sent a rank in "
              f"{ranks[0]['comm_s'] * 1e3:.1f} ms of collectives")
        check(all(r["backend"] == backend for r in ranks), f"{name}: ranks on {backend}")
        check(max(loss_errs) <= RG_DIST_LOSS_TOL and max(errs) <= RG_F32_TOL,
              f"{name}: the dst-partitioned loss and gradient equal loss_fn's")
    print(f"gnn: the ranks took {gloo_s:.1f} s (4 gloo) and {both_s:.1f} s (with the NCCL "
          f"rank beside them)")
    cora_path.unlink()


def phase_recsys_gnn(dev, card: str) -> dict:
    """Phase 13: recsys and GNN (see the module docstring).  The peaks of
    BST's train step and GIN's on Cora, for phase 15 (b)."""
    t0 = time.perf_counter()
    PHASE13_DIR.mkdir(parents=True, exist_ok=True)
    for f in PHASE13_DIR.glob("*.npz"):
        f.unlink()
    procs, logs = {}, {}
    for name in ("minibatch_lg", "ogb_products"):      # two cores, side by side
        logs[name] = PHASE13_DIR / f"{name}.log"
        with open(logs[name], "w") as f:
            procs[name] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--graph-child",
                 str(PHASE13_DIR), name], stdout=f, stderr=subprocess.STDOUT)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    peaks = {}
    try:
        reduced_recsys_gnn_on_card(dev)
        print(f"recsys: (a) took {time.perf_counter() - t0:.1f} s")
        models = full_width_on_card(dev)
        print(f"recsys: (b) done at {time.perf_counter() - t0:.1f} s")
        steps = recsys_timed(dev, models, card)
        print(f"recsys: (c) done at {time.perf_counter() - t0:.1f} s")
        for name in ("full_graph_sm", "molecule"):
            d = gin_tu.SHAPES[name].dims
            if name == "molecule":
                g = graph.batched_molecules(d["batch"], d["n_nodes"], d["n_edges"],
                                            d["d_feat"], seed=0)
            else:
                g = graph.random_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                                       d["n_classes"], seed=0)
            peaks[name] = gin_timed(dev, name, graph_batch(g), g.n_edges, card)
        ogb_path = PHASE13_DIR / "ogb_products.npz"
        st = wait_for(ogb_path, procs["ogb_products"], logs["ogb_products"])
        gin_timed(dev, "ogb_products", {"features": st["features"],
                                        "edge_src": st["edge_index"][0],
                                        "edge_dst": st["edge_index"][1],
                                        "labels": st["labels"]},
                  st["edge_index"].shape[1], card,
                  f"; graph made in {float(st['gen_s']):.1f} s by the graph process, "
                  f"waited for {st['waited_s']:.1f} s")
        del st
        dst_partitioned_on_card(dev, card, ogb_path)
        print(f"gnn: (d) done at {time.perf_counter() - t0:.1f} s")
        st = wait_for(PHASE13_DIR / "minibatch_lg.npz", procs["minibatch_lg"],
                      logs["minibatch_lg"])
        d = gin_tu.SHAPES["minibatch_lg"].dims
        n_sub, n_edges = st["features"].shape[0], st["edge_src"].shape[0]
        check((n_sub, n_edges) == gin_tu.sampled_sizes(d),
              "minibatch_lg: the sample has sampled_sizes' nodes and edges")
        print(f"gnn: minibatch_lg host graph ({d['n_nodes']:,} nodes, {int(st['n_edges']):,} "
              f"edges, d_feat {d['d_feat']}) made in {float(st['gen_s']):.1f} s, its CSR "
              f"table in {float(st['csr_s']):.1f} s, a fanout {d['fanout']} sample of "
              f"{d['batch_nodes']} seeds in {float(st['sample_s']) * 1e3:.1f} ms, by a "
              f"graph process beside the card's work (waited for {st['waited_s']:.1f} s)")
        gin_timed(dev, "minibatch_lg", {k: st[k] for k in (
            "features", "edge_src", "edge_dst", "edge_mask", "labels", "label_mask")},
            n_edges, card, "; the sampled subgraph")
        for name, proc in procs.items():
            check(proc.wait(timeout=60) == 0,
                  f"the {name} graph process exited 0 (log {logs[name]})")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in PHASE13_DIR.glob("*.npz"):
            f.unlink()
    print(f"recsys: phase 13 took {time.perf_counter() - t0:.1f} s")
    bst = steps["bst"]
    full = recsys_configs.SHAPES["train_batch"].dims["batch"]
    return {"bst": bst["peak"] if bst["batch"] == full else None,
            "gin": peaks["full_graph_sm"]}


# ------------------------------------------------------------------ phase 14
#: phase 14: the sharded MoE on (data, model) grids of gloo ranks sharing
#: the card, at full width with depth cut to MOE_LAYERS, and the examples
MOE_ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")
MOE_RANKS = 4
MOE_MODEL = 2                   # a 2 x 2 grid for the archs
MOE_FFTP_MODEL = 4              # a 1 x 4 grid for ffTP
MOE_LAYERS = 1
MOE_BATCH, MOE_SEQ = 8, 128     # repro's launch/train.py defaults
MOE_TOL = 1e-4
#: ffTP at the CPU test's width (tests/test_torch_moe_sharded.py): 2 experts
#: on 4 model ranks, d 16, d_ff 32, top-2, at capacity factor E and 1.25
FFTP_CASES = ((2, 2.0), (2, 1.25))
FFTP_D = 16
#: the kernels every example's path launches (the ISSUE's table of phase 14)
EXAMPLE_KERNELS = ("suffix_pack", "hash_partition", "lcp_boundary", "bsearch",
                   "merge_path")
#: ngram_language_model's one cut: 40 steps of its default 300
EXAMPLES_LM_STEPS = 40
PHASE14_DIR = Path(__file__).resolve().parent / "build" / "phase14"


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, on ``got``'s device."""
    want = want.to(got.device, torch.float32)
    return float((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def sliced_leaves(tree, moe, tp: int, m: int) -> dict:
    """name -> tensor of a transformer's parameter or gradient tree, each
    ``Stacked`` leaf stacked, the MoE leaves cut to model rank ``m``'s part."""
    out = {}
    for name, leaf in named_leaves(tree):
        if isinstance(leaf, Stacked):
            key = name.rsplit("/", 1)[-1]
            parts = [lm_moe.shard_leaf(key, t, moe, tp, m) if "/ffn/" in name else t
                     for t in leaf]
            leaf = torch.stack([t.detach() for t in parts])
        out[name] = leaf.detach()
    return out


def barrier(mesh) -> None:
    mesh.all_reduce(torch.zeros(1, device=mesh.device))


def moe_arch_rank(world, grid, arch: str) -> dict:
    """Phase 14 (a) for ``arch`` on this rank of ``grid``: the arch at full
    width, MOE_LAYERS deep, float32, its MoE on the grid.  The MoE layer on
    a seeded x of the batch's shape against one-device ``moe_ffn(sort)`` on
    this rank's row with the whole weights; one loss and gradient (cold,
    then warm) against the one-device model run row by row.  Each rank
    draws the whole model leaf by leaf from the seed and keeps its part;
    the one-device references run two ranks at a time, one model column
    after the other, so at most two whole models are on the card."""
    dev = grid.device
    full = lm_configs.get(arch).make()
    one = dataclasses.replace(full, n_layers=MOE_LAYERS, dtype=torch.float32,
                              moe=dataclasses.replace(full.moe, dispatch="sort"))
    cfg = dataclasses.replace(one, moe=dataclasses.replace(one.moe, mesh=grid,
                                                           dp_axes="data"))
    tp, m, rows, i = grid.model.size, grid.model.rank, grid.data.size, grid.data.rank
    gen = torch.Generator(dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ), generator=gen,
                           device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    x = torch.randn((MOE_BATCH, MOE_SEQ, cfg.d_model), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t_start = time.perf_counter()
    model = lm.init_params(cfg, dev, torch.Generator(dev).manual_seed(0)).requires_grad_(True)
    n_part = sum(p.numel() for p in model.parameters())
    ffn = dict(model.layers[0].ffn.named_parameters())
    x_row = lm.row_block(cfg, x)
    with torch.no_grad():
        y, y_aux = lm_moe.moe_ffn_sharded(x_row, ffn, cfg.moe)
        ids, _, _ = lm_moe.router_topk(x_row.reshape(-1, cfg.d_model), ffn["router"], cfg.moe)
        capacity = cfg.moe.capacity(ids.shape[0])
        dropped = int((lm_moe.claim_positions(ids, cfg.moe.n_experts) >= capacity).sum())

    def step():
        return lm_train_loop.value_and_grad(lambda p, b: lm.loss_fn(model, b),
                                            lm.param_tree(model), batch)
    seconds, sent, comm_s = [], [], []
    for _ in range(2):                          # cold, then warm
        b0, s0 = grid.comm_bytes, grid.comm_seconds
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, metrics, grads = step()
        torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
        sent.append(grid.comm_bytes - b0)
        comm_s.append(grid.comm_seconds - s0)
    peak = torch.cuda.max_memory_allocated(dev)
    got = sliced_leaves(grads, cfg.moe, 1, 0)
    del model, ffn, grads
    gc.collect()
    torch.cuda.empty_cache()
    out = {"arch": arch, "loss": float(loss), "aux": float(metrics["aux"]),
           "n_part": n_part, "dropped": dropped, "capacity": capacity,
           "tokens_row": int(ids.shape[0]), "ms": [s * 1e3 for s in seconds],
           "sent": sent, "comm_s": comm_s, "peak": peak, "rank": grid.rank, "row": i,
           "col": m, "before_ref_s": time.perf_counter() - t_start}
    for turn in range(tp):                      # the references, a column at a time
        if turn == m:
            ref = lm.init_params(one, dev, torch.Generator(dev).manual_seed(0))
            ref.requires_grad_(True)
            whole = dict(ref.layers[0].ffn.named_parameters())
            with torch.no_grad():
                outs = [lm_moe.moe_ffn(xr, whole, one.moe) for xr in x.chunk(rows)]
            out["y_err"] = rel_err(y, outs[i][0])
            out["aux_ref"] = float(torch.stack([a for _, a in outs]).mean())
            out["y_aux"] = float(y_aux)
            out["y_aux_err"] = abs(out["y_aux"] - out["aux_ref"]) / abs(out["aux_ref"])
            del whole, outs
            ms_one = []
            for _ in range(2):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                acc, losses = None, []
                for r in range(rows):
                    part = {k: v.chunk(rows)[r] for k, v in batch.items()}
                    rl, _, rg = lm_train_loop.value_and_grad(
                        lambda p, b: lm.loss_fn(ref, b), lm.param_tree(ref), part)
                    losses.append(float(rl))
                    rg = sliced_leaves(rg, cfg.moe, tp, m)
                    acc = rg if acc is None else {k: acc[k] + rg[k] for k in acc}
                    del rg
                torch.cuda.synchronize(dev)
                ms_one.append((time.perf_counter() - t0) * 1e3)
            want = {k: v / rows for k, v in acc.items()}
            out["ms_one"] = ms_one
            out["loss_ref"] = float(np.mean(losses))
            out["loss_err"] = abs(out["loss"] - out["loss_ref"]) / abs(out["loss_ref"])
            errs = {k: rel_err(got[k], want[k]) for k in want}
            out["grad_err"] = max(errs.values())
            out["worst_leaf"] = max(errs, key=errs.get)
            out["n_leaves"] = len(errs)
            out["shapes_equal"] = all(got[k].shape == want[k].shape for k in want)
            out["peak_ref"] = torch.cuda.max_memory_allocated(dev)
            del ref, acc, want
            gc.collect()
            torch.cuda.empty_cache()
        barrier(world)
    out["total_s"] = time.perf_counter() - t_start
    return out


def fftp_rank(grid) -> list:
    """Phase 14 (b) on this rank of a 1 x MOE_FFTP_MODEL grid: 2 experts at
    the CPU test's width (every rank holds both at d_ff / 4): y, aux and the
    gradient of sum(y * y) + aux against the one-device sort path."""
    dev = grid.device
    out = []
    for n_exp, cf in FFTP_CASES:
        one = lm_moe.MoEConfig(n_exp, 2, 32, capacity_factor=cf, dispatch="sort")
        cfg = dataclasses.replace(one, mesh=grid, dp_axes="data")
        gen = torch.Generator(dev).manual_seed(2)
        whole = lm_moe.init_moe_params(FFTP_D, one, torch.float32, lambda shape, dtype:
                                       torch.randn(shape, generator=gen, dtype=dtype,
                                                   device=dev))
        x = torch.randn((4, 8, FFTP_D), generator=gen, device=dev)
        res = []
        for params, c in ((lm_moe.shard_moe_params(whole, cfg), cfg), (whole, one)):
            p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            xx = x.clone().requires_grad_(True)
            fn = lm_moe.moe_ffn_sharded if c.mesh is not None else lm_moe.moe_ffn
            y, aux = fn(xx, p, c)
            g = torch.autograd.grad((y * y).sum() + aux, [*p.values(), xx])
            res.append((y.detach(), float(aux.detach()), dict(zip([*p, "x"], g))))
        (y, aux, g), (y1, aux1, g1) = res
        errs = [rel_err(g[k], lm_moe.shard_leaf(k, g1[k], cfg, grid.model.size,
                                                grid.model.rank) if k != "x" else g1[k])
                for k in g]
        out.append({"layout": "ep" if lm_moe.expert_parallel(cfg, grid.model.size)
                    else "fftp", "y_err": rel_err(y, y1),
                    "aux_err": abs(aux - aux1) / abs(aux1), "grad_err": max(errs),
                    "wg_shape": tuple(g["wg"].shape)})
    return out


def moe_rank(world) -> dict:
    """Phase 14 (a) and (b) on one of MOE_RANKS gloo ranks sharing the card."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    grid = grid_mesh(world, MOE_MODEL)
    fftp = grid_mesh(world, MOE_FFTP_MODEL)
    return {"archs": [moe_arch_rank(world, grid, arch) for arch in MOE_ARCHS],
            "fftp": fftp_rank(fftp), "shape": grid.shape, "fftp_shape": fftp.shape}


def examples_child(out_path: str, device: str) -> None:
    """The port's six examples in this process, on the card (``device``
    "cuda") or the CPU ("cpu", the five n-gram examples): each one's
    printed lines and seconds and the kernels' launches, to ``out_path`` as
    JSON.  An example's own assert fails the process."""
    import importlib
    import io

    from repro_torch import examples
    out = {}
    ops.launches.clear()
    for name in examples.NAMES:
        argv = [] if device == "cuda" else ["--device", "cpu"]
        if name == "ngram_language_model":
            if device == "cpu":
                continue
            ckpt = PHASE14_DIR / "lm_ckpt"
            shutil.rmtree(ckpt, ignore_errors=True)
            argv += ["--steps", str(EXAMPLES_LM_STEPS), "--ckpt-dir", str(ckpt)]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            importlib.import_module(f"repro_torch.examples.{name}").main(argv)
        out[name] = {"lines": buf.getvalue().splitlines(),
                     "seconds": time.perf_counter() - t0}
    Path(out_path).write_text(json.dumps({"examples": out, "launches": dict(ops.launches)}))


def start_examples(device: str) -> tuple[subprocess.Popen, Path, Path]:
    out, log = PHASE14_DIR / f"examples_{device}.json", PHASE14_DIR / f"examples_{device}.log"
    out.unlink(missing_ok=True)
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                 "--examples-child", str(out), device],
                                stdout=f, stderr=subprocess.STDOUT)
    return proc, out, log


def finish_examples(proc, out: Path, log: Path) -> dict:
    check(proc.wait() == 0, f"the examples process exited 0 (log {log}: "
          f"{log.read_text()[-3000:]})")
    return json.loads(out.read_text())


#: what varies between runs of an example: seconds, rates and (the LM's) losses
EXAMPLE_TIMES = re.compile(r"\d[\d,]*(\.\d+)?(?=s\b)|\d[\d,]* tok/s")


def phase_moe_examples(dev, card: str) -> dict:
    """Phase 14: the sharded MoE and the examples (see the module docstring)."""
    t0 = time.perf_counter()
    PHASE14_DIR.mkdir(parents=True, exist_ok=True)
    # (c) both runs of the examples beside (a) and (b), which wait on gloo
    cpu, cuda = start_examples("cpu"), start_examples("cuda")
    try:
        ranks = spawn_ranks(MOE_RANKS, moe_rank, device=dev, backend="gloo")
        t_ranks = time.perf_counter() - t0
        for a, arch in enumerate(MOE_ARCHS):
            rs = [r["archs"][a] for r in ranks]
            r0 = rs[0]
            full = lm_configs.get(arch).make()
            print(f"moe: {arch} at full width (d {full.d_model}, {full.moe.n_experts} "
                  f"experts, top-{full.moe.top_k}, d_ff_expert {full.moe.d_ff_expert}"
                  f"{f', {full.moe.n_shared} shared of {full.moe.d_ff_shared_total}' if full.moe.n_shared else ''}, "
                  f"capacity_factor {full.moe.capacity_factor}), depth cut to {MOE_LAYERS} of "
                  f"{full.n_layers} layers (the one cut), float32, TF32 off, on a "
                  f"{ranks[0]['shape']['data']} x {ranks[0]['shape']['model']} (data, model) "
                  f"grid of {MOE_RANKS} gloo ranks sharing {card}; batch {MOE_BATCH}x{MOE_SEQ}, "
                  f"{r0['tokens_row']} tokens a data row, capacity {r0['capacity']} a rank's "
                  f"expert; {r0['n_part'] / 1e9:.3f} G parameters a rank")
            print(f"moe: {arch} MoE layer ({card}): y of each rank within "
                  f"{max(r['y_err'] for r in rs):.2e} of one-device moe_ffn(sort) on its row "
                  f"with the whole weights (tol {MOE_TOL}), aux {r0['y_aux']:.6f} within "
                  f"{max(r['y_aux_err'] for r in rs):.2e} of the rows' mean; dropped claims "
                  f"by row {[r['dropped'] for r in rs if r['col'] == 0]}")
            print(f"moe: {arch} loss and gradient ({card}): loss {r0['loss']:.6f}, within "
                  f"{max(r['loss_err'] for r in rs):.2e} of the one-device model's run row by "
                  f"row ({r0['loss_ref']:.6f}); every gradient leaf ({r0['n_leaves']} a rank, "
                  f"MoE leaves the rank's part) within {max(r['grad_err'] for r in rs):.2e} of "
                  f"the leaf's max abs (tol {MOE_TOL}; worst {r0['worst_leaf']})")
            print(f"moe: {arch} a step ({card}): sharded "
                  f"{max(r['ms'][1] for r in rs):.1f} ms warm (cold "
                  f"{max(r['ms'][0] for r in rs):.1f} ms), one device row by row "
                  f"{min(r['ms_one'][1] for r in rs):.1f} ms warm; a rank sent "
                  f"{max(r['sent'][1] for r in rs) / 1e9:.3f} GB in "
                  f"{max(r['comm_s'][1] for r in rs):.2f} s of collectives (warm step); peak "
                  f"{max(r['peak'] for r in rs) / 2**30:.2f} GiB a rank sharded, "
                  f"{max(r['peak_ref'] for r in rs) / 2**30:.2f} GiB with the one-device "
                  f"reference (gloo ranks sharing one card: correctness and staging, not "
                  f"NVLink); the arch took {max(r['total_s'] for r in rs):.1f} s a rank, "
                  f"{max(r['before_ref_s'] for r in rs):.1f} s of it before the references")
            check(all(r["shapes_equal"] for r in rs), f"{arch}: gradient leaves' shapes")
            check(max(r["y_err"] for r in rs) <= MOE_TOL
                  and max(r["y_aux_err"] for r in rs) <= MOE_TOL,
                  f"{arch}: the sharded MoE layer equals one-device moe_ffn on each row")
            check(max(r["loss_err"] for r in rs) <= MOE_TOL
                  and max(r["grad_err"] for r in rs) <= MOE_TOL,
                  f"{arch}: the sharded loss and gradient equal the one-device model's")
            check(len({r["loss"] for r in rs}) == 1, f"{arch}: every rank holds one loss")
        for c, (n_exp, cf) in enumerate(FFTP_CASES):
            fs = [r["fftp"][c] for r in ranks]
            print(f"moe: ffTP, {n_exp} experts on a {ranks[0]['fftp_shape']['data']} x "
                  f"{ranks[0]['fftp_shape']['model']} grid ({card}): d {FFTP_D}, d_ff 32 "
                  f"(wg {fs[0]['wg_shape']} a rank), top-2, capacity_factor {cf}: y within "
                  f"{max(f['y_err'] for f in fs):.2e}, aux {max(f['aux_err'] for f in fs):.2e}, "
                  f"the gradient of sum(y*y) + aux {max(f['grad_err'] for f in fs):.2e} of "
                  f"one-device moe_ffn(sort)'s (tol {MOE_TOL})")
            check(all(f["layout"] == "fftp" for f in fs)
                  and max(max(f["y_err"], f["aux_err"], f["grad_err"]) for f in fs) <= MOE_TOL,
                  f"ffTP at capacity factor {cf} equals the one-device sort path")
        print(f"moe: the {MOE_RANKS} ranks took {t_ranks:.1f} s ({card})")
        card_run, cpu_run = finish_examples(*cuda), finish_examples(*cpu)
    finally:
        for proc, _, _ in (cpu, cuda):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, got in card_run["examples"].items():
        lines = [EXAMPLE_TIMES.sub("<t>", ln) for ln in got["lines"]]
        if name == "ngram_language_model":
            first, last = map(float, re.search(r"done: loss (\S+) -> (\S+),",
                                               got["lines"][-1]).groups())
            print(f"examples: {name} on {card}: {len(lines)} lines in "
                  f"{got['seconds']:.1f} s, {EXAMPLES_LM_STEPS} steps (cut from 300, the "
                  f"one cut), loss {first:.3f} -> {last:.3f}; {got['lines'][2]}")
            check(last < first, f"{name}: the loss falls")
            continue
        want = [EXAMPLE_TIMES.sub("<t>", ln) for ln in cpu_run["examples"][name]["lines"]]
        print(f"examples: {name} on {card}: {len(lines)} lines in {got['seconds']:.1f} s, "
              f"equal to the CPU run's once times are masked; {got['lines'][0][:100]}")
        check(lines == want, f"{name}: the card's lines equal the CPU's")
    launches = card_run["launches"]
    missing = [k for k in EXAMPLE_KERNELS if launches.get(k, 0) == 0]
    check(not missing, f"the examples launched every kernel of their path (missing {missing})")
    print(f"examples: one process on {card}, beside the ranks: "
          f"{sum(e['seconds'] for e in card_run['examples'].values()):.1f} s in the "
          f"examples, launches {launches}")
    print(f"moe: phase 14 took {time.perf_counter() - t0:.1f} s ({card})")
    return {"launches": launches}


class DryRunProcesses:
    """Phase 15 (a)'s ``python -m repro_torch.launch.dryrun --all
    --include-ngram`` processes, one a layout (16x16, 2x16x16), started
    at the top of the script: they trace on the card's fake tensors,
    beside everything else, one CPU thread each."""

    def __init__(self):
        self.out = PHASE15_DIR / "records"
        shutil.rmtree(self.out, ignore_errors=True)
        self.out.mkdir(parents=True)
        root = Path(__file__).resolve().parent
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(root / "src")] + os.environ.get("PYTHONPATH", "").split(
                           os.pathsep)).rstrip(os.pathsep))
        self.logs = {m: PHASE15_DIR / f"dryrun_{m}.log" for m in DRYRUN_MESHES}
        self.procs = {}
        for m in DRYRUN_MESHES:
            with open(self.logs[m], "w") as f:
                self.procs[m] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                     "--include-ngram", "--mesh", m, "--out", str(self.out)],
                    stdout=f, stderr=subprocess.STDOUT, env=env, cwd=root)
        self.t0 = time.time()

    def wait(self) -> list[dict]:
        """Every record, once both processes have exited 0."""
        t0 = time.perf_counter()
        for m, proc in self.procs.items():
            rc = proc.wait()
            check(rc == 0, f"the {m} dry run exited 0 (it exited {rc}; log {self.logs[m]})")
        # a process's log is last written as it ends
        ends = ", ".join(f"{m} {self.logs[m].stat().st_mtime - self.t0:.1f} s"
                         for m in DRYRUN_MESHES)
        print(f"dryrun: the layouts' processes ended after {ends}; phase 15 waited "
              f"{time.perf_counter() - t0:.1f} s for them")
        return [json.loads(f.read_text()) for f in sorted(self.out.glob("*.json"))]

    def kill(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def dryrun_cell_lines(recs: list[dict]) -> dict:
    """(a): one line a cell; the records by (mesh, arch, shape)."""
    by = {}
    for r in recs:
        by[r["mesh"], r["arch"], r["shape"]] = r
        head = f"dryrun: [{r['mesh']}] {r['arch']}/{r['shape']}:"
        if r["status"] != "ok":
            print(f"{head} {r['status']} ({r.get('reason') or r.get('error')})")
            continue
        rl, mem = r["roofline"], r["memory"]
        held = mem["argument_bytes"] + mem["temp_bytes"]
        print(f"{head} {rl['bottleneck']}-bound, step {rl['step_time_s'] * 1e3:.3f} ms, "
              f"roofline fraction {rl['roofline_fraction']:.4f}, "
              f"{mem['argument_bytes'] / 2**30:.2f} + {mem['temp_bytes'] / 2**30:.2f} GiB "
              f"a device (argument + temp) = {held / HBM_PER_CHIP:.3f} of 80 GiB, "
              f"traced in {r['trace_s']} s")
    return by


def _real_shard(shape, dtype, device):
    """A real local shard for (b): indices 0 (every id valid), masks
    true, floats small normal draws."""
    if dtype == torch.bool:
        return torch.ones(shape, dtype=dtype, device=device)
    if not dtype.is_floating_point:
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.randn(shape, dtype=torch.float32, device=device).mul_(0.02).to(dtype)


def dryrun_one_device(dev, card: str, plain_peaks: dict) -> None:
    """(b): three steps of phases 12 and 13 on a (1, 1) layout, the dry
    run's trace against the same step run for real on the card, as
    DTensors, and its peak against the peak phase 12 or 13 read of the
    port's own step (``plain_peaks``, by arch; None: not comparable)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    train = cell_base.ShapeDef("train_8x128", "train",
                               {"seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH})
    cases = [("llama3.2-1b train 8x128", "llama3.2-1b",
              lambda m: cell_base.build_lm_cell(lm_configs.get(TRAIN_ARCH).make(), train, m)),
             ("bst train_batch", "bst", lambda m: bst_configs.build_cell(
                 None, recsys_configs.SHAPES["train_batch"], m)),
             ("gin-tu full_graph_sm (Cora)", "gin", lambda m: gin_tu.build_cell(
                 None, gin_tu.SHAPES["full_graph_sm"], m))]
    for label, arch, build in cases:
        with fake_mesh((1, 1), ("data", "model"), "cuda") as mesh:
            cell = build(mesh)
            t0 = time.perf_counter()
            counts = dryrun.measure(cell, mesh, "cuda")
            trace_s = time.perf_counter() - t0
            arg_bytes = dryrun.argument_bytes(cell, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with implicit_replication(), regions.installed():
                args = dryrun.arguments(cell, mesh, dev, _real_shard)
                real_bytes = sum(t.to_local().numel() * t.element_size()
                                 for t in dryrun._tensors(args))
                with FlopCounterMode(display=False) as fc:
                    out = cell.step_fn(*args)
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            del args, out
        flops = fc.get_total_flops()
        ratio = counts["peak_bytes"] / peak
        plain = plain_peaks.get(arch)
        vs_plain = (f"; over phase 12-13's peak of the port's own step "
                    f"{plain / 2**30:.2f} GiB = {counts['peak_bytes'] / plain:.3f}"
                    if plain else "")
        print(f"dryrun: (1,1) {label}: argument bytes {arg_bytes:,} traced, "
              f"{real_bytes:,} real; FLOPs {counts['flops']:,} traced, {flops:,} by "
              f"FlopCounterMode on the real step; peak {counts['peak_bytes'] / 2**30:.2f} "
              f"GiB traced over the DTensor step's {peak / 2**30:.2f} GiB "
              f"max_memory_allocated = {ratio:.3f}{vs_plain} (traced in {trace_s:.1f} s; "
              f"{card})")
        check(arg_bytes == real_bytes, f"{label}: the dry run's argument bytes are the real ones")
        check(counts["flops"] == flops, f"{label}: the dry run's FLOPs are FlopCounterMode's")
        check(DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1],
              f"{label}: the dry run's peak within {DRYRUN_PEAK_BAND} of the card's")
        if plain:
            check(DRYRUN_PEAK_BAND[0] <= counts["peak_bytes"] / plain <= DRYRUN_PEAK_BAND[1],
                  f"{label}: the dry run's peak within {DRYRUN_PEAK_BAND} of the port's "
                  f"own step's")
        gc.collect()
        torch.cuda.empty_cache()


def dryrun_nyt_rank0(dev, by: dict, card: str) -> dict:
    """(c): nyt_lm's job as rank 0 of 256 for real on the card, its
    exchanges on the fake group (shapes, not answers: no answer is
    checked), the main path's kernels launched."""
    cfg = NGramConfig(sigma=NYT["sigma"], tau=100, vocab_size=NYT["vocab"])
    n_local = -(-NYT["n_tokens"] // NYT_RANKS)
    n_local = -(-n_local // 8) * 8
    capacity = max(8, int(cfg.capacity_factor * n_local / NYT_RANKS) + 1)
    g = torch.Generator(dev).manual_seed(15)
    tok = torch.randint(1, NYT["vocab"], (n_local,), generator=g, device=dev,
                        dtype=torch.int32)
    tok[torch.rand(n_local, generator=g, device=dev) < 1 / 20] = 0   # documents
    with fake_mesh((16, 16), ("data", "model"), "cuda") as mesh:
        axes = mesh_axes(paper_configs.flat_mesh(mesh), ("shards",))
        suffix_sigma.distributed_block(tok[:1 << 16], cfg, axes, capacity)   # warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.launches.clear()
        t0 = time.perf_counter()
        out = suffix_sigma.distributed_block(tok, cfg, axes, capacity)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.launches)
        peak = torch.cuda.max_memory_allocated() - base
    rec = by["16x16", "ngram-suffix-sigma", "nyt_lm"]
    traced = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
    print(f"dryrun: nyt_lm rank 0 of {NYT_RANKS} on the card: {n_local:,} tokens, vocab "
          f"{NYT['vocab']:,}, sigma {NYT['sigma']}, capacity {capacity:,}: {ms:.1f} ms, "
          f"terms {tuple(out[0].shape)}, launches {launches}; peak "
          f"{peak / 2**30:.3f} GiB on the card (above the tokens), the dry run's "
          f"argument + temp {traced / 2**30:.3f} GiB; the fake exchange returns "
          f"shapes, not answers: no answer checked ({card})")
    missing = [k for k in ("suffix_pack", "hash_partition", "lcp_boundary")
               if launches.get(k, 0) == 0]
    check(not missing, f"nyt_lm's rank launched the main path's kernels (missing {missing})")
    check(f"cap={capacity}" in rec["notes"], "the real job's capacity is the cell's")
    del out
    return {"launches": launches}


def phase_dryrun(dev, card: str, procs: DryRunProcesses, plain_peaks: dict) -> dict:
    """Phase 15: the dry run (a) whole, from its two processes, (b) on a
    (1, 1) layout against the card, (c) nyt_lm's rank 0 for real.
    ``plain_peaks``: phases 12-13's peaks of (b)'s steps, by arch."""
    dryrun_one_device(dev, card, plain_peaks)                       # (b)
    recs = procs.wait()                                             # (a)
    by = dryrun_cell_lines(recs)
    status = collections.Counter(r["status"] for r in recs)
    print(f"dryrun: {status['ok']} ok, {status['skipped']} skipped (documented), "
          f"{status['failed']} failed of {len(recs)} cells")
    check(len(recs) == DRYRUN_CELLS and status["failed"] == 0
          and status["skipped"] == DRYRUN_SKIPS,
          f"the dry run: {DRYRUN_CELLS} cells, 0 failed, {DRYRUN_SKIPS} documented skips")
    return dryrun_nyt_rank0(dev, by, card)                          # (c)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    corpora = CorpusProcess()                           # beside the build
    dry = DryRunProcesses()                             # phase 15 (a), beside it all
    try:
        return build_and_run(dev, card, corpora, dry)
    finally:
        if corpora.proc.poll() is None:
            corpora.proc.kill()
            corpora.proc.wait()
        dry.kill()


def build_and_run(dev, card: str, corpora: CorpusProcess, dry: DryRunProcesses) -> int:
    """Phase 1, then the rest."""
    probe_lib = kbuild.BUILD_ROOT.parent / "probe" / "liblatency_probe.so"
    probe_nvcc = start_nvcc(PROBE_SRC, probe_lib)      # beside the kernels' builds
    kbuild.entries()                                    # phase 1
    info = kbuild.build_info
    print(f"build: {len(info['compiled'])} kernels compiled in "
          f"{info['seconds']:.1f} s into {info['directory']}")
    for name, report in info["ptxas"].items():
        used = [ln.strip() for ln in report.splitlines() if "Used" in ln]
        print(f"build: {name}: {'; '.join(used)}")
    x = torch.randint(0, 3, (1 << 20, SIGMA), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops.lcp_boundary(x)
    torch.cuda.synchronize()
    print(f"build: first lcp_boundary call {(time.perf_counter() - t0) * 1e3:.3f} ms "
          f"at [{1 << 20}, {SIGMA}] (its module loaded by build.entries())")
    del x

    return run_phases(dev, card, probe_nvcc, probe_lib, corpora, dry)


def run_phases(dev, card: str, probe_nvcc, probe_lib: Path, corpora: CorpusProcess,
               dry: DryRunProcesses) -> int:
    """Phases 2-15, in their order, then the last lines."""
    t_start = time.perf_counter()

    def done(phase: str) -> None:
        print(f"time: {phase} done at {time.perf_counter() - t_start:.1f} s")
    phase_oracle(dev)                                   # phase 2
    done("phase 2 (oracle)")
    main_run = phase_main_path(dev, corpora=corpora)    # phase 3
    missing = [k for k in MAIN_KERNELS if main_run["launches"].get(k, 0) == 0]
    check(not missing, f"main path launched every kernel (missing {missing})")
    done("phase 3 (main path)")
    methods = phase_methods(dev, main_run)              # phase 6
    missing = [k for k in METHOD_KERNELS if methods["launches"].get(k, 0) == 0]
    check(not missing, f"the methods launched every kernel (missing {missing})")
    done("phase 6 (methods)")
    torch.cuda.empty_cache()
    stream = phase_streaming(dev, main_run)             # phase 5
    missing = [k for k in KERNELS if stream["launches"].get(k, 0) == 0]
    check(not missing, f"streaming path launched every kernel (missing {missing})")
    done("phase 5 (streaming)")
    torch.cuda.empty_cache()
    ext = phase_extensions(dev, main_run, corpora)      # phase 7
    missing = [k for k in EXT_KERNELS if ext["launches"].get(k, 0) == 0]
    check(not missing, f"the extensions launched every kernel of their path (missing {missing})")
    done("phase 7 (extensions)")
    torch.cuda.empty_cache()
    rows, after_waves = phase_kernels(dev, main_run, methods, stream, ext,  # phase 4
                                      finish_nvcc(probe_nvcc, probe_lib))
    done("phase 4 (kernels)")
    torch.cuda.empty_cache()
    wave = phase_waves(dev, main_run, stream, corpora)  # phase 8
    corpora.close()
    missing = [k for k in KERNELS if wave["launches"].get(k, 0) == 0]
    check(not missing, f"the wave path launched every kernel (missing {missing})")
    done("phase 8 (waves)")
    after_waves(wave)
    done("phase 4 at the fold's merges")
    torch.cuda.empty_cache()
    fe = phase_frontend(dev, main_run, stream)          # phase 9
    done("phase 9 (frontend)")
    torch.cuda.empty_cache()
    # the ranks run last: torch.profiler loses device events in an old
    # process (PERF.md section 7), so phase 4 must not wait for them
    ranks = phase_ranks(dev, main_run, methods, stream, wave)  # phase 10
    done("phase 10 (ranks)")
    for row in rows:
        row["launches_by_path"]["frontend"] = fe["launches"].get(row["name"], 0)
        row["launches_by_path"]["ranks"] = ranks["launches"].get(row["name"], 0)
    # the LM path runs no kernel of the port: free the n-gram phases' tensors
    # for the full-width models
    del main_run, methods, stream, ext, wave, fe, ranks, after_waves
    gc.collect()
    torch.cuda.empty_cache()
    print(f"lm: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
          f"before phase 11")
    phase_lm(dev, card)                                 # phase 11
    done("phase 11 (lm)")
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(dev, card)                      # phase 12
    done("phase 12 (train)")
    gc.collect()
    torch.cuda.empty_cache()
    rg = phase_recsys_gnn(dev, card)                    # phase 13
    done("phase 13 (recsys, gnn)")
    gc.collect()
    torch.cuda.empty_cache()
    ex = phase_moe_examples(dev, card)                  # phase 14
    done("phase 14 (moe, examples)")
    for row in rows:
        row["launches_by_path"]["examples"] = ex["launches"].get(row["name"], 0)
    gc.collect()
    torch.cuda.empty_cache()
    dr = phase_dryrun(dev, card, dry, {                 # phase 15
        "llama3.2-1b": train["peak"], "bst": rg["bst"], "gin": rg["gin"]})
    done("phase 15 (dryrun)")
    for row in rows:
        row["launches_by_path"]["dryrun"] = dr["launches"].get(row["name"], 0)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-child"]:      # phase 12's recovery process
        train_child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--examples-child"]:   # phase 14's examples
        examples_child(sys.argv[2], sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--corpus-child"]:     # phase 7's and 8's corpora
        corpus_child(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--graph-child"]:      # phase 13's host graphs
        graph_child(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main())
