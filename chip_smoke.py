#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Needs one CUDA device, ``nvcc`` and the repository's ``src/`` beside this
file; imports nothing of JAX or of the ``repro`` package.  Exits non-zero,
printing no result, when ``torch.cuda.is_available()`` is false or the port
is missing.  Phases, each printing one JSON line:

1. device: the card, its count, torch/CUDA versions, and ``nvidia-smi``'s
   name and power limit (also printed raw on its own line);
2. build: every CUDA library compiled by ``nvcc`` from ``csrc/``, one
   ``nvcc`` per source, all started together;
3. kernels vs plain versions on the card at the kdd99 main-path shapes
   (G = 131,072 granules, n_dec = 23, V = 10, nc = 41 candidates,
   n_bins ∈ {160, 10,240, 1,310,720} with class ids r drawn from
   [0, n_bins / V)), four measures: contingency and Θ_PR bit-equal,
   SCE/LCE/CCE within rtol=1e-5 and atol = 1e-6·max|plain| (within-tile sum
   order; relative, because the scaled CCE and LCE are ~1e-8 and below at
   these shapes, so an absolute 1e-6 would pass zeros).  Then the fused and
   sweep kernels at n_bins = 1,310,720 with r drawn from [0, K), K ∈ {1,
   1,024}: the ladder-off shape of the first greedy iterations, where every
   granule lies in one or a few 256-bin tiles.  Every fused and sweep row is
   also run twice (equal bits), the sweep's skewed rows at the rung n_bins =
   10,240 (equal bits), and the sweep's Θ_PR equals the fused kernel's bit
   for bit on every row.  Each
   row prints max|plain| and the error relative to it.  CUDA-event times of
   kernel, plain version and, for the contingency, one
   ``index_put_(accumulate=True)`` call (a yardstick the port never calls),
   beside the bound: the larger of bytes moved once over the card's memory
   rate and operations over its float32 (non-tensor) peak, the figures of
   ``repro_torch.launch.roofline`` for the card's name (H100 SXM: 3.35 TB/s,
   67 TFLOP/s); each row names the tiling the analytic selector gave it;
4. main path: ``python -m repro_torch.launch.reduce --dataset kdd99
   --max-rows 5000000 --device cuda`` in-process with ``--backend sweep``
   (PR and SCE), ``fused``, ``pallas`` and ``segment`` (PR, the plain
   cross-check, which ``--engine auto`` runs on the device engine; each run
   prints its engine); a plain cross-check runs ``segment`` under
   :func:`plain_segment`, its dense contingency and ``measures.evaluate``
   on the card, as the CPU computes it, not its fused-kernel route; reducts
   and cores equal, the Θ_PR history bit-equal,
   every kernel's launch count > 0 in that phase; then a small input
   (mushroom, 2,000 rows) on the card against the same driver on the CPU;
5. the ``nvidia-smi`` line again, the ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}`` (after phases 6-17).

The LM serving slice adds:

6. the flash-attention and RWKV6 kernels vs their plain versions on the
   card: flash at tinyllama-1.1b prefill shapes (B = 1, 32 query heads over
   4 kv heads, S ∈ {1,024, 2,048}, Dh 64, causal) and at mistral-nemo-12b's
   heads (32 over 8, Dh 128, S = 2,048): bf16 inputs through the
   tensor-core kernel, each element within one output rounding, |d| <=
   1e-2·|plain| + 2e-3, and the same inputs in f32 through the f32 kernel
   within rtol = atol = 2e-5, both timed; RWKV6 at rwkv6-3b shapes (H = 40,
   D = 64, f32) on both of its paths: the chunked prefill kernel at B = 1,
   T ∈ {1,000, 1,024, 2,048}, the decode kernel at B ∈ {1, 4}, T = 1; with
   sigmoid decays, and (one row a path) the model's decays w =
   exp(−exp(z)), z over [−8, 4]; each within rtol = atol = 1e-4 of the
   plain version, and each row naming its path (launch counter).  CUDA-event
   times of kernel, plain version and, for flash, one
   ``scaled_dot_product_attention`` call (a yardstick the port never calls);
   for RWKV6 also ``graph_ms``, the device time of a call replayed in a CUDA
   graph (a decode step's kernel is shorter than the wrapper's host work, so
   the event time there is the host's).  The families slice adds two flash
   rows: seamless-m4t-medium's encoder (B 4, 16 over 16 heads of 64, S =
   1,024, ``causal=False``: every (query, key) pair visible) and
   qwen3-moe-235b-a22b's heads (B 1, 64 over 4 heads of 128, S = 2,048,
   causal), at the same bounds.  Beside the bound: flash 4·Hq·Dh
   operations per visible (query, key) pair over 989 TFLOP/s (bf16) against
   q, k, v, o read or written once over 3.35 TB/s; RWKV6 5·D² f32
   operations per token and head (r·S, then w ⊙ S + k·vᵀ) over 67 TFLOP/s
   against r, k, v, w, o and the state once (the roofline module's figures);
7. serving at full width and full depth in bf16, tinyllama-1.1b then
   rwkv6-3b, through ``build_model`` and ``ServingEngine.serve``: 8 requests,
   prompt lengths seeded in [256, 1,536], 32 new tokens, ``max_batch`` 4,
   ``cache_len`` 2,048.  Every request completes with its budget, no logit
   is NaN, and ``flash_attention`` (tinyllama) / ``rwkv6`` (rwkv6-3b) were
   launched (counts set to 0 just before each model's run, read just
   after); every tinyllama prefill went through the tensor-core flash
   kernel, and rwkv6-3b launched both RWKV6 paths (prefills chunked,
   decode steps row-split).  Prints prefill ms, decode-step ms, tokens/s and peak memory;
8. a cross-check at full width with the depth cut to 2 layers, f32 with
   TF32 off: the same parameters served on the card and on the CPU give
   equal tokens, and prefill logits agree within 1e-4·max|logit| (the
   CPU's top-2 gap is printed where a token differs).

The device-engine slice adds, on the kdd99 granularity of phase 4 (built
once, on the card):

9. device engine: ``plar_reduce(engine="device")`` against
   ``engine="host"`` on the card for ``segment`` (PR, SCE) and
   ``sweep_xla`` (PR): reducts, cores and iteration counts equal, Θ
   histories bit-equal, and the PR reduct equal to phase 4's ``sweep``
   kernel reduct.  Each device config runs twice (the second call captures
   nothing); each run prints loop seconds, bodies replayed, ``done`` polls,
   captures and capture seconds (from the ``engine.dispatch`` span) and peak
   device memory; then a warm start (seed with ``theta_full = +inf``, then
   resume) from the cold run's core equals the cold run;
10. ensemble: PR, PR with bags 0 and 1, SCE, LCE and CCE as one
   ``plar_reduce_ensemble`` grid (``segment``, ``mp_chunk`` 21), each
   member byte-identical to its solo device run at the same ``mp_chunk``;
   prints the grid's loop seconds against the sum of the solo loops.
   The engine's graphs are released after this phase.

The online-service slice adds, on the kdd99 table of phase 4 (5,000,000 x
41, 99,741 granules), through ``repro_torch.service.ReductServer`` on the
card:

11. service: (a) streaming — the first 2,500,000 rows submitted, then 4
    updates of 625,000 rows; after the submit and after each update, solo
    PR queries on ``segment`` (device engine; plain, the answer), ``sweep``,
    ``fused`` and ``pallas`` (host loop: the three Θ kernels) with equal
    reducts and bit-equal Θ_PR, then one window of 4 clients (PR, SCE, LCE, CCE)
    served by one stacked dispatch; at the end every measure's answer, and
    every backend's, equals a batch ``plar_reduce`` over the full table,
    reduct and Θ history; (b) merge during capture — the engine's graphs
    released, dataset B's 4,000,000-row update merge and dataset A's
    dispatch in one window, A's dispatch held until B's merge has begun
    (so the two meet whatever either takes): the merge span overlaps the
    dispatch span, the device guard keeps the merge out of the capture,
    and both answers equal their solo runs; (c) checkpoint and restart — ``stop()`` writes the
    checkpoint, a new server restores both datasets and its first query is
    a warm repair with the same answer; (d) shard recovery —
    ``DatasetHandle.create_sharded`` with 4 shards at ``chunk_rows``
    1,048,576, shard 2 dropped and recovered: the merged granularity
    bitwise equal to the unfailed build, the reduct equal.  Prints the
    per-update latency against the full recompute, merge seconds, captures
    per window (``engine.dispatch`` / ``engine.dispatch_ensemble`` spans),
    the guard's waits, peak device memory (below the card's memory) and the
    Θ kernels' launches in this phase (counts set to 0 just before it, each
    > 0 after).  Any retry, stale serve, quarantine, flush or checkpoint
    failure fails the phase.  The engine's graphs are released after it.

The mesh-driver slice adds, after phase 11 (the engine's graphs released):

12. distributed: this process as a world of one NCCL rank, mesh (1, 1)
    (``("data", "model")``), through ``plar_reduce_distributed``.  On phase
    4's kdd99 granularity (99,741 live granules, capacity 131,072, so the
    device engine evaluates at the top rung of 1,310,720 bins): PR on
    ``all_reduce`` and ``reduce_scatter``, each on the host loop and on the
    device engine (its body, with the collectives, captured as a CUDA
    graph), PR on ``fused`` (host loop: the CUDA fused-Θ kernel's raw
    partial every iteration, since one data shard never regroups), and SCE
    on ``all_reduce``; then the 5,000,000 x 41 table itself, its
    granularity built on the card by the per-shard GrC step, PR on
    ``all_reduce`` with ``engine="auto"``, which must take the host loop
    (the device engine's static working set would be 5,000,000·V bins).
    At one data shard the driver's ``reduce_scatter`` merge is its
    ``all_reduce`` (as in JAX), so the phase also runs the adapter's NCCL
    ``reduce_scatter_tensor`` itself on a ``[41, 131,072, 23]``
    contingency, eagerly and captured in a CUDA graph, each output equal
    to its input.  Every reduct and core equals phase 4's ``sweep``
    run of the same measure, every Θ_PR history bit for bit, SCE's within
    rtol=1e-6, atol=1e-7; the fused kernel launched in the phase (counts set
    to 0 just before it).  Prints each run's seconds, iterations, fused and
    fallen-back iterations, the engine that ran, the greedy loop's
    collective bytes an iteration (host loop; the one-time gathers of the
    core and Θ(D|C) left out) or bodies, polls and captures (device
    engine), the phase's seconds and peak device memory.  The process
    group is destroyed at its end.

The training slice adds, after phase 8:

13. training on the card, through ``repro_torch.train``: (a) the kernels
    under autograd — ``flash_attention_diff`` in bf16 at tinyllama-1.1b's
    heads (B 1, 32 over 4 heads of 64, S = 2,048, causal; the tensor-core
    kernel), output within phase 6's per-element bound, dq/dk/dv within
    1e-5·max|grad| of the plain version's autograd on the same inputs (the
    backward is that same plain recompute); ``rwkv6_diff`` in f32 at
    rwkv6-3b's heads (B 1, H 40, T 1,024, D 64, the model's decays), o and
    the final state within rtol = atol = 1e-4, the gradients of r, k, v, w,
    u and s0 within 1e-4·max|grad| of the token loop's autograd; each
    kernel launched once in its forward; times of forward + backward
    against the plain versions'; (b) tinyllama-1.1b at full width and
    depth, bf16, f32 moments, remat ``nothing``: ``Trainer.fit`` on
    ``TokenStream`` batches of 4 x 2,048 in 2 microbatches, 6 steps,
    checkpoints every 2 (JAX's layout, in ``build/``, removed after):
    every loss and grad norm finite, every parameter leaf's second moment
    > 0 (each leaf, wq/wk/wv/wo included, got a nonzero gradient), the
    tensor-core flash kernel launched in the steps (counts set to 0 just
    before, read just after); then step 2's checkpoint restored into a
    trainer seeded otherwise and run to step 6 gives the uninterrupted
    run's parameters and moments bit for bit (both runs under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``; the max
    difference is printed); s/step, tokens/s, peak memory; (c) rwkv6-3b at
    full width, depth cut to 4 layers, bf16, 3 steps of 2 x 1,024: the
    chunked RWKV6 kernel launched, every leaf's second moment > 0 (the
    decay parameters ``w0``/``w_lora_*`` and ``bonus_u`` included); (d)
    both models at full width, 2 layers, f32, TF32 off, one train step of 2
    x 128 tokens from the same parameters on the card and on the CPU: the
    loss within 1e-5·|loss|, every gradient leaf within 1e-4·max|grad|
    (gradients, not parameters: Adam's first step is ≈ sign(g)); for
    rwkv6-3b within max(1e-4, 2 × the CPU's floor), the floor being how far
    the CPU's own step moves when its recurrence runs in chunks instead of a
    token loop (two exact f32 implementations; ~2.4e-4 at full width); (e) the
    reduce-then-train pipeline, ``examples/pt_feature_selected_training.py``
    on the card with its own checks (the same reduct as on the CPU, both
    trainings' losses fall, the reduct's accuracy at least the full
    table's), the flash kernel launched there.

The families slice adds, after phase 13:

14. the LM families served in bf16 at full width with seeded weights, one
    model at a time (built, driven, freed), the launch counts set to 0
    just before each model's run and read just after: qwen3-moe-235b-a22b
    (128 experts top-8; 94 → 4 layers) through ``ServingEngine.serve`` on
    phase 7's traffic; jamba-1.5-large-398b (one period, 72 → 8 layers: 7
    Mamba + 1 attention, MoE every other layer; experts 16 → 8, top-2
    kept, since one period at 16 experts is 90.5 GB of bf16 weights) on 4
    requests of 256–1,024 prompt tokens, 16 new, ``max_batch`` 4,
    ``cache_len`` 2,048; llava-next-34b (60 → 4 layers) by ``prefill`` on
    2 x (2,880 + 64) tokens with ``frontend_feats`` [2, 2,880, 1,152],
    ``cache_len`` 3,072, then 32 greedy ``decode`` steps; seamless-m4t-medium
    (12 + 12 layers, not cut) by ``EncDecLM.prefill`` on frames [4, 1,024,
    160], then 32 greedy steps, ``cache_len`` 64.  Every request ends with
    its budget, no logit is NaN, every model launched flash and every bf16
    prefill took the tensor-core kernel, seamless's launches are its 12
    encoder layers' and all non-causal, jamba's 7 Mamba layers ran on the
    card once a prefill and a step, and parameters and cache leaves lie on
    the card.  Prints init s, prefill ms, decode-step ms, tokens/s, peak
    memory, launches and each cut (``reduced``);
15. the families on the card against the CPU, f32, TF32 off, from the
    same parameters: qwen3-moe at full width, 1 layer, served (prompts of
    300, 150 and 17 tokens, 8 new); seamless-m4t-medium at full size
    (frames [2, 300, 160], 8 greedy steps); llava-next-34b at full width, 1
    layer (2,880 + 64 tokens with ``frontend_feats``, 8 greedy steps);
    jamba's first block at full width as one ``Block`` (Mamba with a dense
    MLP; prefill of 1,024 tokens, then 4 decode steps).  Tokens equal, and
    each of logits, cross K, block outputs and states within
    1e-4·max|CPU|; where a token differs the CPU's top-2 gap is printed,
    and for MoE whether the router's top-k differed.

The tile-selection slice adds, after phase 15 (the disk cache of tunings
points at ``build/chip_smoke_autotune/`` for the whole run, emptied at its
start and removed at its end, so no earlier tuning leaks in):

16. tiles: (a) on a small table (nc 9, G 20,000, n_bins 12,000, V 10;
    n_dec 2 and 23; class ids r from [0, 1) — every granule in one class,
    its segment long and split — and from [0, 300)), every feasible tiling
    of each kernel (``model.feasible_tiles``) against its plain version:
    the contingency and Θ_PR bit-equal, Θ_SCE bit-equal across the tilings
    and within phase 3's tolerance of the plain version; (b) at phase 3's
    top row (n_bins 1,310,720, r uniform, Θ_PR), each kernel's pinned
    (the kernels' earlier fixed shapes), heuristic, analytic and ``refine=True`` top-3
    tilings, and the model's top 3: ``ms``, the median of 5 CUDA-event
    means of 10 back-to-back calls (host work included, as phase 3's),
    ``graph_ms`` for the Θ kernels (5 calls replayed in a CUDA graph: the
    device time alone), the modeled ms and the bound, one line each beside
    the ``nvidia-smi`` line;
    (c) kdd99 (5,000,000 x 41) reduced once for each selector on ``sweep``
    (host loop) and on ``segment`` (device engine), after clearing the
    tunings (b) persisted: the reduct and the Θ_PR history equal phase 4's.

The paper slice adds, after phase 16 (before the ``kernels`` line):

17. paper: (a) the five tables of ``repro_torch.launch.paper_tables``
    (``table_6_9``, ``table_10``, ``table_11``, ``table_12``, ``fig_9``) at
    JAX's defaults on ``segment``, and ``table_6_9`` again on ``sweep``
    (each asserts HAR, FSPA and PLAR select the same subset), every row
    printed; (b) the full sdss stand-in (320,000 x 5,201, ``v_max`` 8, 17
    classes; never cut in width, any cut in rows printed as ``reduced``
    with its reason): ``table_11``'s configuration on ``sweep`` (SCE,
    ``max_features`` 1, lanes 32 and 128, the second run timed), then the
    table granulated once on the card and one whole greedy PR reduction
    (``compute_core=False``, host loop) on ``segment`` (the plain answer,
    under :func:`plain_segment`, first), ``sweep``, ``fused`` and ``pallas``: reducts equal, Θ_PR
    histories bit-equal, each kernel launched by its run; prints
    ``granulate_s``, ``elapsed_s``, iterations, launches and peak device
    memory; (c) the dry-run cell's shard steps
    (``repro_torch.launch.dryrun.run_plar_cell(..., execute=True)``, one pod
    and two: 20,480 and 10,240 x 326, n_bins 512, SCE) on a world of one
    NCCL rank: ``all_reduce``, ``reduce_scatter``, the fused-pack form and
    the ``fused`` schedule (which must launch the fused-Θ kernel), each Θ
    equal to the solo evaluation, the records printed (device ms, the
    median of 7, beside the modelled terms).

The LM-distribution slice adds, after phase 17 (before the ``kernels``
line):

18. mesh_lm: a world of one NCCL rank (as phase 12), mesh (1, 1) over
    ``("data", "model")``: (a) tinyllama-1.1b at full width (d 2,048, 32/4
    heads of 64, bf16, seeded), depth cut (``reduced``), 3 ``Trainer`` steps
    at 2 x 2,048 tokens with ``mesh=`` against the same steps with
    ``mesh=None`` (deterministic algorithms on, warn_only): losses and grad
    norms within 1e-5 relative, every parameter leaf within 1e-4·max|p|,
    whether each is bit-equal printed, the tensor-core flash kernel's
    launches equal (and > 0); s/step and peak memory of both; (b)
    rwkv6-3b at full width (d 2,560, 40 heads), 4 layers: a 1,024-token
    prefill and 8 greedy decode steps under ``use_mesh`` against the same
    unsharded: tokens equal, launches by path (``rwkv6_chunked``,
    ``rwkv6_decode``) equal; (c) qwen3-moe-235b-a22b with
    ``moe_weight_stationary=True``, full width, depth cut as phase 14:
    prefill and decode under ``use_mesh`` (one model shard: JAX's rule
    takes the local path) against the local path without a mesh: tokens
    equal; (d) the collectives on NCCL: ``compressed_psum_mean`` on a
    [4,096] f32 tensor within one quantization step of it, and
    ``pipeline_apply`` over a one-stage ``pipe`` mesh equal to ``stage_fn``.
    Prints the phase's seconds.

The dry-run slice adds, after phase 18 (before the ``kernels`` line):

19. model_vs_card: (a) the dry-run's counting
    (``launch.roofline.StepCounter``, ``launch.dryrun.count_step``) on
    one step the card can also run: tinyllama-1.1b at full width and depth
    (22 layers, bf16, seeded), one ``make_train_step`` of 2 x 2,048 tokens
    (``launch.specs.make_train_setup``) on mesh (1, 1), first modelled (a
    fake world of one rank, the ``meta`` device, the kernels' twins), then
    on a world of one NCCL rank for real under the same counter: the flash
    twin's calls equal the real step's flash launches, and the counted
    operations and bytes are equal both ways; the modelled
    ``total_hbm_bytes`` is printed beside the measured
    ``max_memory_allocated`` above the memory allocated before the step's
    setup, and their ratio; (b) the four benches
    (``launch.bench_serve``, ``bench_chaos``, ``bench_obs``,
    ``bench_ingest``) at the JAX benchmarks' preset sizes on the card:
    every correctness guarantee asserted, each wall-clock ratio printed
    beside JAX's bound with ``bound_met`` (bounds set on a CPU: a miss does
    not fail the phase); (c) ``examples/pt_serve_lm.py`` on the card: flash
    launches > 0 and its tokens equal the port's ``ServingEngine`` called
    directly on the same seeded weights; (d) one LM dry-run cell end to end
    through the CLI (rwkv6-3b, long_500k, single pod) in a process of its
    own: ``status: ok`` and its seconds.

Kernel times in the ``kernels`` line: the contingency kernels at n_bins =
1,310,720 with uniform r, Θ_PR, launches from phase 4 (fused Θ also at K ∈
{1, 1,024}); flash (the bf16 tensor-core kernel) at S = 2,048, Dh 64, and
RWKV6's prefill at B = 1, T = 2,048 (its top-level numbers) and decode at
B = 4, T = 1 (``paths``), launches from phase 7.  The three Θ kernels'
entries also carry ``service_launches``, their launches in phase 11, and
``mesh_launches``, their launches in phase 12, and ``sdss_launches``,
their launches in the sdss reductions of phase 17 (b); flash and RWKV6 carry
``train_launches``, their launches in phase 13 (b) and (c), and
``train_ms`` / ``train_plain_ms``, forward + backward of the differentiable
wrapper and of the plain version's autograd at the shapes of 13 (a).
Flash also carries ``families_launches``, its launches by model in phase
14, and ``families_rows``, phase 6's two rows of the families slice.
Flash and RWKV6 carry ``mesh_launches``, their launches on phase 18's mesh
path ((a)'s sharded steps; (b)'s sharded serving, by path).  Flash also
carries ``model_vs_card``: phase 19 (a)'s twin calls and real launches.  The
three contingency kernels carry ``tiles`` (phase 16's picks by selector)
and ``tiles_ms`` (their times there): ``analytic_tiles``/``analytic_ms``
and ``pinned_ms`` beside them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np

CARD = types.SimpleNamespace(spec=None, roofline=None)  # the roofline module and the card's spec
SHAPE = dict(G=131_072, n_dec=23, V=10, nc=41)
N_BINS = (160, 10_240, 1_310_720)
SKEWED_K = (1, 1_024)   # sweep-only rows at the top n_bins: r drawn from [0, K)
DELTAS = ("PR", "SCE", "LCE", "CCE")
REPLACES = {
    "contingency": "src/repro/kernels/contingency/kernel.py:76",
    "fused_theta": "src/repro/kernels/contingency/fused.py:85",
    "sweep_theta": "src/repro/kernels/contingency/sweep.py:98",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:99",
    "rwkv6": "src/repro/kernels/rwkv6/kernel.py:71",
}
SOURCES = {
    "contingency": "src/repro_torch/kernels/contingency/csrc/contingency.cu",
    "fused_theta": "src/repro_torch/kernels/contingency/csrc/fused_theta.cu",
    "sweep_theta": "src/repro_torch/kernels/contingency/csrc/sweep_theta.cu",
    "segments": "src/repro_torch/kernels/contingency/csrc/segments.cuh",
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_tc.cu",
    "rwkv6": "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu",
}
FLASH_CASES = (  # (B, S, Hq, Hkv, Dh, causal)
    (1, 1_024, 32, 4, 64, True), (1, 2_048, 32, 4, 64, True),   # tinyllama-1.1b prefill
    (1, 2_048, 32, 8, 128, True),                               # mistral-nemo-12b heads
    (4, 1_024, 16, 16, 64, False),             # seamless-m4t-medium's encoder, non-causal
    (1, 2_048, 64, 4, 128, True),              # qwen3-moe-235b-a22b's heads: GQA group 16
)
FLASH_PICK = (2_048, 64)           # the kernels line's top-level flash row: S, Dh (tinyllama)
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 1e-2, 2e-3   # per element: one bf16 rounding
FLASH_F32_TOL = 2e-5
RWKV_CASES = (  # rwkv6-3b (B, T, decays): H 40, D 64
    (1, 1_000, "sigmoid"), (1, 1_024, "sigmoid"), (1, 2_048, "sigmoid"), (1, 2_048, "model"),
    (1, 1, "sigmoid"), (4, 1, "sigmoid"), (4, 1, "model"),
)
SERVE = dict(requests=8, prompt_min=256, prompt_max=1_536, new_tokens=32,
             max_batch=4, cache_len=2_048)
CROSS = dict(layers=2, prompts=(300, 150, 17), new_tokens=8, max_batch=2, cache_len=512)
TRAIN_FLASH = (1, 32, 4, 2_048, 64)   # B, Hq, Hkv, S, Dh: tinyllama-1.1b heads, bf16
TRAIN_RWKV = (1, 40, 1_024, 64)       # B, H, T, D: rwkv6-3b heads, f32
TRAIN_FLASH_GRAD_REL = 1e-5           # the same plain backward on the same inputs
TRAIN_RWKV_GRAD_REL = 1e-4            # the chunked form's backward vs the token loop's
TRAIN_LM = dict(global_batch=4, seq_len=2_048, microbatches=2, steps=6, ckpt_every=2,
                restart_from=2)       # tinyllama-1.1b, full width and depth, bf16
TRAIN_RWKV_LM = dict(layers=4, global_batch=2, seq_len=1_024, steps=3)
TRAIN_CROSS = dict(layers=2, global_batch=2, seq_len=128)
FAMILIES = {  # phase 14: bf16 on the card at full width; depth and other cuts in "reduced"
    "qwen3-moe-235b-a22b": dict(layers=4, serve=dict(SERVE)),
    "jamba-1.5-large-398b": dict(layers=8, experts=8, serve=dict(
        requests=4, prompt_min=256, prompt_max=1_024, new_tokens=16, max_batch=4,
        cache_len=2_048)),
    "llava-next-34b": dict(layers=4, batch=2, text_tokens=64, new_tokens=32, cache_len=3_072),
    "seamless-m4t-medium": dict(batch=4, frames=1_024, new_tokens=32, cache_len=64),
}
FAMILY_CROSS = dict(prompts=(300, 150, 17), new_tokens=8, max_batch=2, cache_len=512,
                    frames=300, text_tokens=64, block_tokens=1_024, block_steps=4)
KDD99 = ["--dataset", "kdd99", "--max-rows", "5000000", "--device", "cuda"]
MAIN_RUNS = [  # (backend, delta)
    ("sweep", "PR"), ("fused", "PR"), ("pallas", "PR"), ("segment", "PR"),
    ("sweep", "SCE"),
]
ENGINE_RUNS = [("segment", "PR"), ("segment", "SCE"), ("sweep_xla", "PR")]  # (backend, delta)
ENSEMBLE_GRID = [{"delta": "PR"}, {"delta": "PR", "seed": 0}, {"delta": "PR", "seed": 1},
                 {"delta": "SCE"}, {"delta": "LCE"}, {"delta": "CCE"}]
ENSEMBLE_MP_CHUNK = 21   # two chunks of the 41 candidates: half the contingency a config
SERVICE = dict(first=2_500_000, update_rows=625_000, updates=4,
               backends=("segment", "sweep", "fused", "pallas"),
               b_first=1_000_000, a_touch=1_000, shards=4, shard_chunk_rows=1_048_576,
               drop=2)
CARD_BYTES = 80e9        # the H100's device memory
MESH_SCATTER_SHAPE = (41, 131_072, 23)   # [nc, bins, m] of phase 12's reduce_scatter check
TILES_SMALL = dict(nc=9, G=20_000, n_bins=12_000, V=10, n_decs=(2, 23), Ks=(1, 300))
TILES_REPS = 5      # phase 16 (b): repeats of 10 calls, and calls a CUDA graph holds
TILE_KERNELS = {"contingency": "contingency", "fused": "fused_theta", "sweep": "sweep_theta"}
AUTOTUNE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_autotune"
SDSS = dict(rows=320_000, attrs=5_201, classes=17, reduced=None,  # phase 17 (b): full size
            backends=("segment", "sweep", "fused", "pallas"))  # segment (the answer) first:
                                                               # it pays the first run's costs
DRYRUN_FORMS = [("all_reduce", False), ("reduce_scatter", False), ("all_reduce", True),
                ("fused", False)]   # phase 17 (c): (collective, fused_pack)
MESH_LM = dict(  # phase 18 on a world of one NCCL rank: full width, depth cut
    train=dict(arch="tinyllama-1.1b", layers=4, global_batch=2, seq_len=2_048, steps=3),
    rwkv=dict(arch="rwkv6-3b", layers=4, batch=1, prompt=1_024, new_tokens=8,
              cache_len=1_040),
    moe=dict(arch="qwen3-moe-235b-a22b", batch=2, prompt=256, new_tokens=8, cache_len=512),
    compress_n=4_096, pipe=dict(M=4, mb=2, D=256))
MODEL_CARD = dict(arch="tinyllama-1.1b", global_batch=2, seq_len=2_048)  # phase 19 (a)
DRYRUN_CELL = ("rwkv6-3b", "long_500k", "single")       # phase 19 (d), through the CLI
MESH_RUNS = [  # (delta, collective, engine) of phase 12 on the kdd99 granularity
    ("PR", "all_reduce", "host"), ("PR", "all_reduce", "device"),
    ("PR", "reduce_scatter", "host"), ("PR", "reduce_scatter", "device"),
    ("PR", "fused", "host"), ("SCE", "all_reduce", "host"),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    if p.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {p.stderr.strip()}")
    return p.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, after one warm-up."""
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


def graph_ms(torch, fn, reps: int) -> float:
    """Device time of ``fn`` a call: ``reps`` calls captured in one CUDA
    graph, replayed once between CUDA events (no host work between them)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                     # warm-up on the capture's side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, dtype: str = "f32"):
    """The least ms the card could take, and what bounds it: bytes moved
    once over its memory rate, or operations over its peak for ``dtype``
    (``repro_torch.launch.roofline``'s figures for this card)."""
    t = CARD.roofline.roofline_terms(ops, nbytes, 0.0, dtype=dtype, spec=CARD.spec)
    if t["memory_s"] >= t["compute_s"]:
        return t["memory_s"] * 1e3, "bytes"
    return t["compute_s"] * 1e3, "operations"


def operands(torch, n_bins: int, dev, K=None):
    """Main-path operands from a seed: ~24% padding slots (w = 0, r = 0), as
    kdd99's 99,741 live granules in a 131,072-slot capacity; class ids r
    drawn from [0, K), by default K = n_bins / V."""
    G, n_dec, V, nc = SHAPE["G"], SHAPE["n_dec"], SHAPE["V"], SHAPE["nc"]
    gen = torch.Generator().manual_seed(n_bins if K is None else n_bins + K)
    K = n_bins // V if K is None else K
    r = torch.randint(0, K, (G,), generator=gen, dtype=torch.int32)
    x_t = torch.randint(0, V, (nc, G), generator=gen, dtype=torch.int32)
    d = torch.randint(0, n_dec, (G,), generator=gen, dtype=torch.int32)
    w = torch.randint(1, 200, (G,), generator=gen).to(torch.float32)
    pad = torch.rand((G,), generator=gen) < 0.24
    w[pad] = 0.0
    r[pad] = 0
    packed = r[None, :] * V + x_t
    return [t.to(dev) for t in (x_t, r, d, w, packed)]


def theta_row(torch, name, kern, plain, delta, nbytes, nc, G, reps, plain_reps, **at) -> dict:
    """One Θ kernel vs its plain version: Θ_PR bit-equal, the other measures
    within rtol = 1e-5, atol = 1e-6·max|plain|; times and the bound."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = bool(torch.isfinite(got).all()) and (
        torch.equal(got, want) if delta == "PR"
        else scale > 0 and torch.allclose(got, want, rtol=1e-5, atol=1e-6 * scale))
    if not ok:
        raise AssertionError(f"{name} != plain for {delta} at {at}: max err {err}, "
                             f"max |plain| {scale}")
    # the work this data needs: one add per live granule and θ' of at most
    # one (row, decision) cell per granule (~4 flops)
    b_ms, b_by = bound(nbytes, 5 * nc * G)
    return dict(kernel=name, **at, delta=delta, max_abs_err=err, max_abs_plain=scale,
                max_rel_err=err / scale if scale else 0.0, ms=time_ms(torch, kern, reps),
                plain_ms=time_ms(torch, plain, plain_reps), library_ms=None,
                bound_ms=b_ms, bound_by=b_by), got


def phase_kernels(torch, ops, ref, card: str) -> dict:
    """Each kernel vs its plain version at the main-path shapes; times."""
    dev = torch.device("cuda")
    G, n_dec, V, nc = SHAPE["G"], SHAPE["n_dec"], SHAPE["V"], SHAPE["nc"]
    rows = []
    cases = [(n_bins, None) for n_bins in N_BINS] + [(N_BINS[-1], k) for k in SKEWED_K]
    for n_bins, skew in cases:
        x_t, r, d, w, packed = operands(torch, n_bins, dev, skew)
        K = n_bins // V if skew is None else skew
        n = torch.tensor(float(w.sum()), device=dev)
        big = n_bins > 100_000
        reps, plain_reps = (5, 3) if big else (50, 10)

        if skew is None:  # contingency: bit-equal
            got = ops.contingency(packed, d, w, n_bins=n_bins, n_dec=n_dec)
            want = ref.contingency_ref(packed, d, w, n_bins=n_bins, n_dec=n_dec)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            c_scale = float(want.max())
            if not torch.equal(got, want) or c_scale <= 0:
                raise AssertionError(f"contingency != plain at n_bins={n_bins} (max err {err})")
            del got, want
            keep = w[None, :].expand(nc, G) != 0
            c_idx = torch.arange(nc, device=dev)[:, None].expand(nc, G)[keep]
            p_idx = packed.to(torch.int64)[keep]
            d_idx = d.to(torch.int64)[None, :].expand(nc, G)[keep]
            w_val = w[None, :].expand(nc, G)[keep]

            def library():
                torch.zeros((nc, n_bins, n_dec), device=dev).index_put_(
                    (c_idx, p_idx, d_idx), w_val, accumulate=True)

            nbytes = packed.numel() * 4 + 2 * G * 4 + nc * n_bins * n_dec * 4
            b_ms, b_by = bound(nbytes, nc * G)
            rows.append(dict(
                kernel="contingency", n_bins=n_bins, K=K, delta=None, max_abs_err=err,
                max_abs_plain=c_scale, max_rel_err=err / c_scale,
                ms=time_ms(torch, lambda: ops.contingency(packed, d, w, n_bins=n_bins, n_dec=n_dec), reps),
                plain_ms=time_ms(torch, lambda: ref.contingency_ref(packed, d, w, n_bins=n_bins, n_dec=n_dec), plain_reps),
                library_ms=time_ms(torch, library, plain_reps),
                bound_ms=b_ms, bound_by=b_by,
                tiles=list(ops.resolve_tiles("contingency", nc=nc, g=G, n_bins=n_bins, m=n_dec,
                                             device=dev))))
            del c_idx, p_idx, d_idx, w_val, keep
            torch.cuda.empty_cache()

        for delta in DELTAS:
            def fused(delta=delta):
                return ops.fused_theta(packed, d, w, n, delta=delta, n_bins=n_bins, n_dec=n_dec)

            row, fused_got = theta_row(
                torch, "fused_theta", fused,
                lambda: ref.fused_theta_ref(packed, d, w, n, delta=delta, n_bins=n_bins, n_dec=n_dec),
                delta, packed.numel() * 4 + 2 * G * 4 + nc * 4, nc, G, reps, plain_reps,
                n_bins=n_bins, K=K)
            row["same_bits_again"] = torch.equal(fused_got, fused())
            row["tiles"] = list(ops.resolve_tiles("fused", nc=nc, g=G, n_bins=n_bins, m=n_dec,
                                                  delta=delta, device=dev))
            if not row["same_bits_again"]:
                raise AssertionError(f"fused_theta bits differ on a second run for {delta} at "
                                     f"n_bins={n_bins}, K={K}")
            rows.append(row)
            pr = {"fused": fused_got}

            def sweep(nb=n_bins, delta=delta):
                return ops.sweep_theta(x_t, r, d, w, n, delta=delta, v_max=V, n_bins=nb, n_dec=n_dec)

            row, got = theta_row(
                torch, "sweep_theta", sweep,
                lambda: ref.sweep_theta_ref(x_t, r, d, w, n, delta=delta, v_max=V, n_bins=n_bins, n_dec=n_dec),
                delta, x_t.numel() * 4 + 3 * G * 4 + nc * 4, nc, G, 20, plain_reps,
                n_bins=n_bins, K=K)
            # the same bits on a second run, at a smaller rung >= K·V, and
            # (Θ_PR) from the fused kernel
            row["same_bits_again"] = torch.equal(got, sweep())
            row["tiles"] = list(ops.resolve_tiles("sweep", nc=nc, g=G, n_bins=n_bins, m=n_dec,
                                                  v_max=V, delta=delta, device=dev))
            if K * V <= N_BINS[1] < n_bins:
                row["same_bits_at_rung"] = torch.equal(got, sweep(N_BINS[1]))
            if delta == "PR" and "fused" in pr:
                row["same_bits_as_fused"] = torch.equal(got, pr["fused"])
            if not all(row.get(k, True) for k in ("same_bits_again", "same_bits_at_rung",
                                                  "same_bits_as_fused")):
                raise AssertionError(f"sweep_theta bits differ for {delta} at n_bins={n_bins}, "
                                     f"K={K}: {row}")
            rows.append(row)
        del x_t, r, d, w, packed
        torch.cuda.empty_cache()
    for row in rows:
        emit({"phase": "kernel", **row, "card": card})
    return {"rows": rows}


@contextlib.contextmanager
def plain_segment():
    """``segment`` as the plain answer on the card: candidates evaluated on
    the dense ``[nc, n_bins, m]`` contingency and ``measures.evaluate``, the
    CPU's arithmetic, instead of the fused kernel its row of
    ``plan.BACKENDS`` names for the card (the table alone picks the route).
    For the length of a reference run; no other thread runs a reduction
    meanwhile."""
    from repro_torch.core import plan

    row = plan.BACKENDS["segment"]
    plan.BACKENDS["segment"] = row._replace(card=None)
    try:
        yield
    finally:
        plan.BACKENDS["segment"] = row


@contextlib.contextmanager
def _held_until_merge(handle_a, handle_b, timeout_s: float = 300.0):
    """Dataset A's reductions wait, inside their ``scheduler.dispatch``
    span, until dataset B's merge has begun (its ``update``, called inside
    the ``scheduler.merge`` span): the two spans meet whatever either takes.
    Instance attributes over the handles' methods, removed on exit."""
    begun = threading.Event()
    update = handle_b.update

    def signalled(*args, **kwargs):
        begun.set()
        return update(*args, **kwargs)

    def held(fn):
        def call(*args, **kwargs):
            if not begun.wait(timeout_s):
                raise AssertionError("dataset B's merge did not begin")
            return fn(*args, **kwargs)
        return call

    handle_b.update = signalled
    handle_a.reduce, handle_a.reduce_many = held(handle_a.reduce), held(handle_a.reduce_many)
    try:
        yield
    finally:
        del handle_b.update, handle_a.reduce, handle_a.reduce_many


def plain_if_segment(backend: str):
    """:func:`plain_segment` for a ``segment`` run, else nothing."""
    return plain_segment() if backend == "segment" else contextlib.nullcontext()


def run_cli(torch, reduce_cli, backend: str, delta: str) -> dict:
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), plain_if_segment(backend):
        out = reduce_cli.main(KDD99 + ["--backend", backend, "--delta", delta])
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def phase_main_path(torch, ops, reduce_cli, card: str) -> dict:
    """kdd99 at 5,000,000 x 41 through the CLI on the card; launches counted."""
    results = []
    ops.reset_launch_counts()              # counts of the main path only
    for backend, delta in MAIN_RUNS:
        before = ops.launch_counts()
        out = run_cli(torch, reduce_cli, backend, delta)
        after = ops.launch_counts()
        out["launches"] = {k: after[k] - before[k] for k in after}
        if not all(math.isfinite(v) for v in out["theta_history"] + [out["theta_full"]]):
            raise AssertionError(f"non-finite Θ in the {backend}/{delta} run")
        if out["table_shape"] != [5_000_000, 41]:
            raise AssertionError(f"table shape {out['table_shape']}")
        emit({"phase": "main_path", "card": card, **{k: out[k] for k in (
            "backend", "engine", "delta", "table_shape", "granules", "iterations", "reduct",
            "core", "theta_full", "granulate_s", "elapsed_s", "wall_s",
            "max_memory_allocated", "launches")}})
        results.append(out)
    launches = ops.launch_counts()
    pr = [o for o in results if o["delta"] == "PR"]
    for o in pr[1:]:
        if (o["reduct"], o["core"]) != (pr[0]["reduct"], pr[0]["core"]):
            raise AssertionError(f"reduct/core differ: {o['backend']} vs {pr[0]['backend']}")
        if o["theta_history"] != pr[0]["theta_history"]:
            raise AssertionError(f"Θ_PR history differs: {o['backend']} vs {pr[0]['backend']}")
        if o["granules"] != pr[0]["granules"]:
            raise AssertionError("granule counts differ between runs")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    emit({"phase": "main_path_check", "pr_backends_agree": True,
          "launches": launches})
    return {"runs": results, "launches": launches}


def phase_small_reference(torch, plar_reduce, scaled_paper_dataset) -> dict:
    """A small input reduced on the card and again on the CPU (plain versions)."""
    x, d = scaled_paper_dataset("mushroom", max_rows=2000, max_attrs=22).table()
    checks = []
    for backend in ("sweep", "fused", "pallas", "segment"):
        for delta in ("PR", "SCE"):
            rc = plar_reduce(x, d, delta=delta, backend=backend, device="cuda")
            rp = plar_reduce(x, d, delta=delta, backend=backend, device="cpu")
            same = (rc.reduct, rc.core) == (rp.reduct, rp.core)
            if delta == "PR":
                same = same and rc.theta_history == rp.theta_history
            else:
                same = same and all(
                    math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-7)
                    for a, b in zip(rc.theta_history, rp.theta_history))
            if not same:
                raise AssertionError(f"card != CPU on mushroom for {backend}/{delta}")
            checks.append(f"{backend}/{delta}")
    emit({"phase": "small_reference", "dataset": "mushroom", "rows": 2000,
          "agree": checks})
    return {"agree": checks}


def _new_spans(obs, before: int, name: str) -> list:
    """The spans named ``name`` recorded since the tracer counted ``before``."""
    tracer = obs.get_tracer()
    fresh = tracer.recorded - before
    return [rec for rec in (tracer.records()[-fresh:] if fresh else []) if rec.name == name]


def _engine_run(torch, obs, plar_reduce, gran, **kw) -> dict:
    """One ``plar_reduce`` on the kdd99 granularity: its result, the
    ``engine.dispatch`` span of a device run (bodies, polls, captures) and
    the peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = obs.get_tracer().recorded
    t0 = time.perf_counter()
    r = plar_reduce(source=gran, device="cuda", **kw)
    torch.cuda.synchronize()
    out = dict(reduct=r.reduct, core=r.core, iterations=r.iterations,
               theta_full=r.theta_full, theta_history=r.theta_history,
               elapsed_s=r.elapsed_s, wall_s=time.perf_counter() - t0,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    if kw["engine"] == "device":
        spans = _new_spans(obs, before, "engine.dispatch")
        if len(spans) != 1:
            raise AssertionError(f"expected one engine.dispatch span, got {len(spans)}")
        out.update({k: spans[0].args[k] for k in (
            "loop_s", "bodies", "polls", "captures", "capture_s")})
    else:   # the host loop: its greedy iterations, each timed
        out["loop_s"] = sum(r.per_iteration_s)
    return out


def _same_run(a: dict, b: dict) -> bool:
    return all(a[k] == b[k] for k in ("reduct", "core", "iterations", "theta_full",
                                      "theta_history"))


def phase_device_engine(torch, obs, plar_reduce, gran, sweep_pr: dict, card: str) -> dict:
    """The device engine against the host loop on the card at kdd99."""
    rows = []
    for backend, delta in ENGINE_RUNS:
        kw = dict(backend=backend, delta=delta)
        host = _engine_run(torch, obs, plar_reduce, gran, engine="host", **kw)
        first = _engine_run(torch, obs, plar_reduce, gran, engine="device", **kw)
        again = _engine_run(torch, obs, plar_reduce, gran, engine="device", **kw)
        for name, run in (("device", first), ("device again", again)):
            if not _same_run(run, host):
                raise AssertionError(f"{backend}/{delta}: {name} engine != host loop: "
                                     f"{run['reduct']} {run['theta_history']} vs "
                                     f"{host['reduct']} {host['theta_history']}")
        if first["captures"] != 1 or again["captures"] != 0:
            raise AssertionError(f"{backend}/{delta}: captures {first['captures']}, "
                                 f"then {again['captures']} (expected 1, then 0)")
        if delta == "PR" and (first["reduct"], first["core"]) != (sweep_pr["reduct"],
                                                                   sweep_pr["core"]):
            raise AssertionError(f"{backend}/PR device reduct {first['reduct']} != the sweep "
                                 f"kernel's {sweep_pr['reduct']}")
        row = dict(backend=backend, delta=delta, reduct=first["reduct"], core=first["core"],
                   iterations=first["iterations"], equal_to_host=True,
                   equal_to_sweep_kernel=delta == "PR",
                   host={k: host[k] for k in ("loop_s", "elapsed_s", "max_memory_allocated")},
                   device={k: first[k] for k in ("loop_s", "elapsed_s", "bodies", "polls",
                                                 "captures", "capture_s",
                                                 "max_memory_allocated")},
                   device_again={k: again[k] for k in ("loop_s", "elapsed_s", "bodies", "polls",
                                                       "captures", "max_memory_allocated")})
        emit({"phase": "device_engine", "card": card, **row})
        rows.append(row)
    # warm start from the cold run's core (plus its first greedy pick): seed
    # with theta_full = +inf, then resume; equal to the cold run
    cold = _engine_run(torch, obs, plar_reduce, gran, engine="device", backend="segment",
                       delta="PR")
    prefix = cold["reduct"][: len(cold["core"]) + 1]
    warm = _engine_run(torch, obs, plar_reduce, gran, engine="device", backend="segment",
                       delta="PR", warm_start=prefix)
    if (warm["reduct"], warm["theta_history"]) != (cold["reduct"], cold["theta_history"]):
        raise AssertionError(f"warm start from {prefix} != cold run: {warm['reduct']} vs "
                             f"{cold['reduct']}")
    warm_row = dict(prefix=prefix, reduct=warm["reduct"], equal_to_cold=True,
                    **{k: warm[k] for k in ("loop_s", "bodies", "polls", "captures")})
    emit({"phase": "device_engine_warm_start", "card": card, **warm_row})
    return {"runs": rows, "warm_start": warm_row}


def phase_ensemble(torch, obs, plar_reduce, plar_reduce_ensemble, gran, card: str) -> dict:
    """The measure grid (plus two PR bags) as one stacked loop at kdd99; each
    member byte-identical to its solo device run."""
    import dataclasses

    from repro_torch.core import bagged_weights

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = obs.get_tracer().recorded
    t0 = time.perf_counter()
    ens = plar_reduce_ensemble(source=gran, configs=ENSEMBLE_GRID, backend="segment",
                               mp_chunk=ENSEMBLE_MP_CHUNK, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    span = _new_spans(obs, before, "engine.dispatch_ensemble")
    if len(span) != 1:
        raise AssertionError(f"expected one engine.dispatch_ensemble span, got {len(span)}")
    members, solo_loop_s, solo_capture_s = [], 0.0, 0.0
    for c, r in zip(ENSEMBLE_GRID, ens):
        src = gran
        if "seed" in c:
            w = torch.as_tensor(bagged_weights(gran, c["seed"]), device="cuda")
            src = dataclasses.replace(gran, w=w, n_total=w.sum().to(torch.int32))
        solo = _engine_run(torch, obs, plar_reduce, src, engine="device", backend="segment",
                           delta=c["delta"], mp_chunk=ENSEMBLE_MP_CHUNK)
        got = dict(reduct=r.reduct, core=r.core, iterations=r.iterations,
                   theta_full=r.theta_full, theta_history=r.theta_history)
        if not _same_run(got, solo):
            raise AssertionError(f"ensemble member {c} != its solo run: {r.reduct} "
                                 f"{r.theta_history} vs {solo['reduct']} {solo['theta_history']}")
        solo_loop_s += solo["loop_s"]
        solo_capture_s += solo["capture_s"]
        members.append(dict(config=c, reduct=r.reduct, core=r.core, iterations=r.iterations,
                            equal_to_solo=True, solo_loop_s=solo["loop_s"],
                            solo_bodies=solo["bodies"], solo_captures=solo["captures"]))
    # loops with their captures, and without them (replays alone)
    out = dict(configs=len(ENSEMBLE_GRID), mp_chunk=ENSEMBLE_MP_CHUNK, wall_s=wall,
               loop_s=span[0].dur, capture_s=span[0].args["capture_s"],
               bodies=span[0].args["bodies"], polls=span[0].args["polls"],
               captures=span[0].args["captures"], max_memory_allocated=peak,
               solo_loop_s_sum=solo_loop_s, solo_capture_s_sum=solo_capture_s,
               replay_s=span[0].dur - span[0].args["capture_s"],
               solo_replay_s_sum=solo_loop_s - solo_capture_s, members=members)
    emit({"phase": "ensemble", "card": card, **out})
    return out


def _captures(obs, before: int) -> int:
    """Graphs the engine captured since the tracer counted ``before``."""
    return sum(rec.args.get("captures", 0)
               for name in ("engine.dispatch", "engine.dispatch_ensemble")
               for rec in _new_spans(obs, before, name))


def _same_answer(a, b) -> bool:
    return (a.reduct, a.theta_history) == (b.reduct, b.theta_history)


def phase_service(torch, obs, ops, x, d, stream, card: str) -> dict:
    """The online reduct service at kdd99 on the card: streaming with the
    four backends and a stacked window, a merge during a capture, a
    checkpoint and restart, and shard recovery."""
    import asyncio

    from repro_torch.core import engine, plar_reduce
    from repro_torch.core.guard import device_guard
    from repro_torch.service import DatasetHandle, ReductServer

    cfg = SERVICE
    n_dec, v_max = stream.n_dec, stream.v_max
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_service_")
    guard = device_guard("cuda")
    tracer = obs.get_tracer()
    out = {"table_shape": list(x.shape), "checkpoint_dir": ckdir}
    engine.release_graphs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()          # the service path's counts only

    def summary_ok(srv, where):
        summ = srv.summary()
        bad = {k: summ[k] for k in ("retries", "stale_served", "quarantined", "flush_failures")
               if summ[k]}
        if srv.checkpointer is not None and srv.checkpointer.failed_saves:
            bad["failed_saves"] = srv.checkpointer.failed_saves
        if bad:
            raise AssertionError(f"service {where}: {bad}")
        return summ

    async def first_life():
        rounds = []
        async with ReductServer(device="cuda", checkpoint_dir=ckdir) as srv:
            t0 = time.perf_counter()
            await srv.submit("kdd", x[:cfg["first"]], d[:cfg["first"]], n_dec=n_dec, v_max=v_max)
            out["submit_s"] = time.perf_counter() - t0
            for i in range(cfg["updates"] + 1):
                rnd = {"round": i}
                if i:
                    lo = cfg["first"] + (i - 1) * cfg["update_rows"]
                    await srv.update("kdd", x[lo:lo + cfg["update_rows"]],
                                     d[lo:lo + cfg["update_rows"]])
                    rnd["rows_added"] = cfg["update_rows"]
                solo = {}
                for b in cfg["backends"]:
                    before = tracer.recorded
                    t0 = time.perf_counter()
                    with plain_if_segment(b):         # segment: the plain answer
                        r = await srv.query("kdd", "PR", backend=b)
                    req = srv.requests[-1]
                    solo[b] = dict(result=r, latency_s=time.perf_counter() - t0, warm=req.warm,
                                   prefix_kept=req.prefix_kept, captures=_captures(obs, before),
                                   merge_s=[m.dur for m in _new_spans(obs, before,
                                                                      "scheduler.merge")])
                ref = solo["segment"]["result"]
                for b, s_ in solo.items():
                    if not _same_answer(s_["result"], ref):
                        raise AssertionError(f"round {i}: {b} PR {s_['result'].reduct} "
                                             f"{s_['result'].theta_history} != segment's "
                                             f"{ref.reduct} {ref.theta_history}")
                before, runs = tracer.recorded, srv.stats["engine_runs"]
                t0 = time.perf_counter()
                window = await asyncio.gather(*[srv.query("kdd", m) for m in DELTAS])
                w_lat = time.perf_counter() - t0
                sizes = [q.batch_size for q in list(srv.requests)[-len(DELTAS):]]
                if srv.stats["engine_runs"] - runs != 1 or sizes != [len(DELTAS)] * len(DELTAS):
                    raise AssertionError(f"round {i}: the 4-client window took "
                                         f"{srv.stats['engine_runs'] - runs} dispatches, "
                                         f"batch sizes {sizes}")
                granules = await asyncio.to_thread(lambda: srv.handle("kdd").n_granules)
                rnd.update(
                    granules=granules,
                    update_latency_s=solo["segment"]["latency_s"],
                    merge_s=sum(solo["segment"]["merge_s"]),
                    reduct=ref.reduct,
                    solo={b: {k: v for k, v in s_.items() if k != "result"}
                          for b, s_ in solo.items()},
                    window=dict(latency_s=w_lat, captures=_captures(obs, before),
                                warm=[q.warm for q in list(srv.requests)[-len(DELTAS):]],
                                reducts={m: r.reduct for m, r in zip(DELTAS, window)}),
                    captures=sum(s_["captures"] for s_ in solo.values())
                    + _captures(obs, before))
                emit({"phase": "service_round", "card": card, **rnd})
                rnd["answers"] = {"solo": {b: s_["result"] for b, s_ in solo.items()},
                                  "window": dict(zip(DELTAS, window))}
                rounds.append(rnd)

            # (b) dataset B's big merge in one window with A's dispatch, the
            # engine's graphs released so A's dispatch captures
            await srv.submit("kdd_b", x[:cfg["b_first"]], d[:cfg["b_first"]],
                             n_dec=n_dec, v_max=v_max)
            engine.release_graphs()
            await srv.update("kdd", x[:cfg["a_touch"]], d[:cfg["a_touch"]])
            await srv.update("kdd_b", x[cfg["b_first"]:], d[cfg["b_first"]:])
            waits = (guard.capture_waits, guard.capture_wait_s, guard.shared_waits)
            before = tracer.recorded
            with _held_until_merge(srv.handle("kdd"), srv.handle("kdd_b")):
                ra, rb = await asyncio.gather(srv.query("kdd", "PR", backend="segment"),
                                              srv.query("kdd_b", "PR", backend="segment"))
            merges = [m for m in _new_spans(obs, before, "scheduler.merge")
                      if m.args["dataset"] == "kdd_b"]
            disp = [m for m in _new_spans(obs, before, "scheduler.dispatch")
                    if m.args["dataset"] == "kdd"]
            caps = [m for m in _new_spans(obs, before, "engine.dispatch")]
            overlap = (len(merges) == 1 and len(disp) == 1
                       and merges[0].t_start < disp[0].t_start + disp[0].dur
                       and disp[0].t_start < merges[0].t_start + merges[0].dur)
            solo_a = plar_reduce(source=srv.handle("kdd").gran, delta="PR", backend="segment",
                                 device="cuda")
            solo_b = plar_reduce(source=srv.handle("kdd_b").gran, delta="PR",
                                 backend="segment", device="cuda")
            merge_b = dict(
                merge_s=merges[0].dur if merges else None,
                merge_rows=int(x.shape[0]) - cfg["b_first"],
                dispatch_s=disp[0].dur if disp else None,
                spans_overlap=overlap,
                captures=sum(c.args.get("captures", 0) for c in caps),
                capture_waits=guard.capture_waits - waits[0],
                capture_wait_s=guard.capture_wait_s - waits[1],
                merge_waits=guard.shared_waits - waits[2],
                a_equal_solo=_same_answer(ra, solo_a), b_equal_solo=_same_answer(rb, solo_b))
            emit({"phase": "service_merge_during_capture", "card": card, **merge_b})
            if not (overlap and merge_b["captures"] >= 1 and merge_b["a_equal_solo"]
                    and merge_b["b_equal_solo"]):
                raise AssertionError(f"merge during capture: {merge_b}")
            out["merge_during_capture"] = merge_b
            last_a = ra
        out["first_life"] = summary_ok(srv, "first life")
        return rounds, last_a

    rounds, last_a = asyncio.run(first_life())

    # (a) the final answers against batch plar_reduce over the full table
    final = rounds[-1]["answers"]
    recompute = {}
    for m in DELTAS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = plar_reduce(x, d, delta=m, n_dec=n_dec, v_max=v_max, device="cuda")
        torch.cuda.synchronize()
        recompute[m] = time.perf_counter() - t0
        served = [final["window"][m]] + (list(final["solo"].values()) if m == "PR" else [])
        for r in served:
            if not _same_answer(r, batch):
                raise AssertionError(f"served {m} {r.reduct} {r.theta_history} != batch "
                                     f"plar_reduce {batch.reduct} {batch.theta_history}")
    lat = [r["update_latency_s"] for r in rounds[1:]]
    out.update(
        rounds=[{k: v for k, v in r.items() if k != "answers"} for r in rounds],
        final_equal_batch=True, full_recompute_s=recompute,
        update_latency_s=lat, mean_update_latency_s=sum(lat) / len(lat),
        merge_s_per_update=[r["merge_s"] for r in rounds[1:]],
        captures_per_window=[r["captures"] for r in rounds])
    emit({"phase": "service_streaming", "card": card,
          **{k: out[k] for k in ("submit_s", "full_recompute_s", "update_latency_s",
                                 "mean_update_latency_s", "merge_s_per_update",
                                 "captures_per_window", "final_equal_batch")}})

    # (c) restart from the checkpoint: the first query is a warm repair
    async def second_life():
        async with ReductServer(device="cuda", checkpoint_dir=ckdir) as srv:
            restored = srv.stats["restored_datasets"]
            t0 = time.perf_counter()
            r = await srv.query("kdd", "PR", backend="segment")
            lat = time.perf_counter() - t0
            warm = srv.requests[-1].warm and srv.handle("kdd").last_was_warm
        summary_ok(srv, "second life")
        return dict(restored_datasets=restored, first_query_warm=warm, first_query_s=lat,
                    equal_to_last_answer=_same_answer(r, last_a))

    restart = asyncio.run(second_life())
    emit({"phase": "service_restart", "card": card, **restart})
    if not (restart["restored_datasets"] == 2 and restart["first_query_warm"]
            and restart["equal_to_last_answer"]):
        raise AssertionError(f"restart: {restart}")
    out["restart"] = restart

    # (d) shard recovery: drop shard 2, re-fold it from its lineage
    t0 = time.perf_counter()
    h = DatasetHandle.create_sharded(stream, cfg["shards"], chunk_rows=cfg["shard_chunk_rows"],
                                     device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    unfailed = {k: getattr(h.gran, k).clone() for k in ("x", "d", "w", "valid", "num", "n_total")}
    fp, r0 = h.fingerprint, h.reduce("PR")
    h.drop_shard(cfg["drop"])
    before = tracer.recorded
    t0 = time.perf_counter()
    recovered = h.recover_shards(stream)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    refold = _new_spans(obs, before, "recovery.refold_shard")
    bitwise = all(torch.equal(getattr(h.gran, k), v) for k, v in unfailed.items())
    r1 = h.reduce("PR", warm=False)
    shards = dict(shards=cfg["shards"], chunk_rows=cfg["shard_chunk_rows"], dropped=cfg["drop"],
                  recovered=recovered, granules=int(unfailed["num"]), build_s=build_s,
                  recover_s=recover_s, refold_s=refold[0].dur if refold else None,
                  bitwise_equal=bitwise, fingerprint_equal=h.fingerprint == fp,
                  reduct=r1.reduct, reduct_equal=r1.reduct == r0.reduct)
    emit({"phase": "service_shard_recovery", "card": card, **shards})
    if not (recovered == [cfg["drop"]] and bitwise and shards["fingerprint_equal"]
            and shards["reduct_equal"]):
        raise AssertionError(f"shard recovery: {shards}")
    out["shard_recovery"] = shards
    del h, unfailed

    torch.cuda.synchronize()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["launches"] = ops.launch_counts()
    emit({"phase": "service_check", "card": card, "launches": out["launches"],
          "max_memory_allocated": out["max_memory_allocated"], "card_bytes": CARD_BYTES})
    for name, count in out["launches"].items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the service path")
    if not out["max_memory_allocated"] < CARD_BYTES:
        raise AssertionError(f"peak device memory {out['max_memory_allocated']} bytes")
    engine.release_graphs()
    return out


def _mesh_run(torch, obs, fn, **kw) -> dict:
    """One ``plar_reduce_distributed`` call: its result, seconds, the fused
    schedule's iterations and fallbacks, the engine that ran, and its span:
    ``engine.dispatch`` (device engine) or ``mesh.loop`` (host loop, whose
    collectives all run from Python: the loop's bytes an iteration, the
    core's folds in, the one-time gathers of the core and Θ(D|C) left out)."""
    names = ("plar_mesh_fused_iterations_total", "plar_mesh_fused_fallbacks_total")
    before_c = [obs.counter(n).value for n in names]
    before = obs.get_tracer().recorded
    t0 = time.perf_counter()
    r = fn(**kw)
    torch.cuda.synchronize()
    fused, fallback = (obs.counter(n).value - b for n, b in zip(names, before_c))
    device, host = (_new_spans(obs, before, n) for n in ("engine.dispatch", "mesh.loop"))
    if (len(device), len(host)) not in ((1, 0), (0, 1)):
        raise AssertionError(f"expected one engine.dispatch or one mesh.loop span, got "
                             f"{len(device)} and {len(host)}")
    out = dict(delta=kw["delta"], collective=kw["collective"], engine=kw["engine"],
               engine_ran="device" if device else "host",
               reduct=r.reduct, core=r.core, iterations=r.iterations, theta_full=r.theta_full,
               theta_history=r.theta_history, elapsed_s=r.elapsed_s,
               wall_s=time.perf_counter() - t0, fused_iterations=fused,
               fallback_iterations=fallback)
    if device:
        out.update({k: device[0].args[k] for k in ("loop_s", "bodies", "polls", "captures",
                                                   "capture_s")})
    else:
        out["loop_s"] = sum(r.per_iteration_s)
        out["loop_collective_bytes"] = host[0].args["collective_bytes"]
        out["collective_bytes_per_iteration"] = (host[0].args["collective_bytes"]
                                                 / max(r.iterations, 1))
    return out


def _reduce_scatter_check(torch, coll) -> dict:
    """``_MeshColl.psum_scatter_bins`` (NCCL ``reduce_scatter_tensor``) on a
    world of one rank, eagerly and inside a CUDA graph: the driver's merge
    takes it only at two or more data shards, which one card never has.  At
    one shard every bin stays, so the output equals the input."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    cont = torch.randint(0, 1 << 20, MESH_SCATTER_SHAPE, generator=gen, device=dev,
                         dtype=torch.int32).to(torch.float32)
    eager = coll.psum_scatter_bins(cont.clone())
    static_in = cont.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up outside the capture
        coll.psum_scatter_bins(static_in.clone())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = coll.psum_scatter_bins(static_in)
    static_in.copy_(cont)
    graph.replay()
    torch.cuda.synchronize()
    out = dict(shape=list(MESH_SCATTER_SHAPE), eager_equal=bool(torch.equal(eager, cont)),
               captured_equal=bool(torch.equal(static_out, cont)))
    del graph, static_in, static_out, eager, cont
    return out


def phase_distributed(torch, obs, ops, x, d, main_runs, card: str) -> dict:
    """The mesh driver in this process: a world of one NCCL rank, mesh
    (1, 1), on phase 4's kdd99 granularity and on its 5,000,000 x 41
    table; every answer held against phase 4's ``sweep`` runs."""
    import torch.distributed as dist

    from repro_torch.core import resolve_granularity
    from repro_torch.core.distributed import plar_reduce_distributed
    from repro_torch.core.engine import _MeshColl
    from repro_torch.distributed import init_process_group, make_mesh

    store = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_")) / "store"
    init_process_group("cuda", rank=0, world_size=1, store_path=str(store), timeout_s=300)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        gran = resolve_granularity(x, d, device="cuda")
        sweep = {o["delta"]: o for o in main_runs if o["backend"] == "sweep"}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()          # the mesh phase's counts only
        t0 = time.perf_counter()
        runs = [_mesh_run(torch, obs, plar_reduce_distributed, mesh=mesh, source=gran,
                          delta=delta, collective=coll, engine=eng)
                for delta, coll, eng in MESH_RUNS]
        del gran
        runs.append(_mesh_run(torch, obs, plar_reduce_distributed, x=x, d=d, mesh=mesh,
                              delta="PR", collective="all_reduce", engine="auto"))
        runs[-1]["input"] = "x, d (GrC built on the card, one build a shard)"
        scatter = _reduce_scatter_check(torch, _MeshColl(mesh))
        elapsed = time.perf_counter() - t0
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = ops.launch_counts()
        for run in runs:
            want = sweep[run["delta"]]
            run["equal_to_phase4"] = (run["reduct"], run["core"]) == (want["reduct"], want["core"])
            if run["delta"] == "PR":
                run["theta_bit_equal"] = run["theta_history"] == want["theta_history"]
            else:
                run["theta_within_tol"] = len(run["theta_history"]) == len(
                    want["theta_history"]) and all(
                    math.isclose(a, b, rel_tol=1e-6, abs_tol=1e-7)
                    for a, b in zip(run["theta_history"], want["theta_history"]))
            emit({"phase": "distributed", "card": card, **{
                k: v for k, v in run.items() if k != "theta_history"}})
        fused = sum(r["fused_iterations"] for r in runs)
        fallback = sum(r["fallback_iterations"] for r in runs)
        out = dict(mesh=dict(mesh.shape), world=dist.get_world_size(), backend=dist.get_backend(),
                   runs=runs, elapsed_s=elapsed,
                   iterations=sum(r["iterations"] for r in runs),
                   fused_share=fused / max(fused + fallback, 1), fused_iterations=fused,
                   fallback_iterations=fallback, reduce_scatter=scatter,
                   max_memory_allocated=peak, launches=launches)
        emit({"phase": "distributed_check", "card": card, **{
            k: v for k, v in out.items() if k != "runs"}})
        bad = [(r["delta"], r["collective"], r["engine"]) for r in runs
               if not (r["equal_to_phase4"] and r.get("theta_bit_equal", True)
                       and r.get("theta_within_tol", True))]
        if bad:
            raise AssertionError(f"mesh runs differ from phase 4's sweep runs: {bad}")
        if runs[-1]["engine_ran"] != "host":
            raise AssertionError("engine='auto' took the device engine on the x, d path, "
                                 "whose static working set no card holds")
        if not (scatter["eager_equal"] and scatter["captured_equal"]):
            raise AssertionError(f"reduce_scatter on a world of one rank changed its input: "
                                 f"{scatter}")
        if launches["fused_theta"] <= 0:
            raise AssertionError("the fused-Θ kernel was not launched by the mesh phase")
        if fallback or fused <= 0:
            raise AssertionError(f"fused schedule: {fused} fused, {fallback} fallen back "
                                 "(one data shard never falls back)")
        if not peak < CARD_BYTES:
            raise AssertionError(f"peak device memory {peak} bytes")
        return out
    finally:
        from repro_torch.core import engine

        engine.release_graphs()
        dist.destroy_process_group()


def phase_lm_kernels(torch, fa, rk, card: str) -> dict:
    """The flash and RWKV6 kernels vs their plain versions at the serving
    path's full-width shapes; times and bounds."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False    # the f32 plain versions
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for b, s, hq, hkv, dh, causal in FLASH_CASES:
        q = torch.randn((b, hq, s, dh), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((b, hkv, s, dh), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((b, hkv, s, dh), generator=gen, device=dev).to(torch.bfloat16)
        fa.reset_launch_counts()
        got = fa.flash_attention(q, k, v, causal=causal)
        if fa.launch_counts() != {"flash_attention": 1, "flash_attention_tc": 1}:
            raise AssertionError(f"bf16 flash at Dh {dh} did not take the tensor-core kernel: "
                                 f"{fa.launch_counts()}")
        want = fa.attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        # bf16: one rounding of the same f32 value, element by element
        over = float((diff - (FLASH_BF16_RTOL * want.float().abs() + FLASH_BF16_ATOL)).max())
        if not (bool(torch.isfinite(got).all()) and over <= 0):
            raise AssertionError(f"flash_attention != plain at S={s}, Dh {dh} (bf16): max err "
                                 f"{err}, {over} past |d| <= {FLASH_BF16_RTOL}·|plain| + "
                                 f"{FLASH_BF16_ATOL}")
        # f32: the same inputs through the f32 CUDA-core kernel
        qf, kf, vf = q.float(), k.float(), v.float()
        got32 = fa.flash_attention(qf, kf, vf, causal=causal)
        want32 = fa.attention_ref(qf, kf, vf, causal=causal)
        err32 = float((got32 - want32).abs().max())
        if not torch.allclose(got32, want32, rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL):
            raise AssertionError(f"flash_attention != plain at S={s}, Dh {dh} (f32): max err {err32}")
        del got32, want32, diff
        pairs = b * (s * (s + 1) // 2 if causal else s * s)   # visible (query, key) pairs
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
        b_ms, b_by = bound(nbytes, 4 * hq * dh * pairs, "bf16")
        rows.append(dict(
            kernel="flash_attention", shape=dict(B=b, Hq=hq, Hkv=hkv, S=s, Dh=dh,
                                                 dtype="bfloat16", causal=causal),
            path="tensor cores (flash_attention_tc.cu)",
            max_abs_err=err, f32_max_abs_err=err32,
            tolerance=(f"bf16 |d| <= {FLASH_BF16_RTOL}·|plain| + {FLASH_BF16_ATOL}; "
                       f"f32 rtol = atol = {FLASH_F32_TOL}"),
            ms=time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal), 20),
            f32_kernel_ms=time_ms(torch, lambda: fa.flash_attention(qf, kf, vf, causal=causal),
                                  5),
            plain_ms=time_ms(torch, lambda: fa.attention_ref(q, k, v, causal=causal), 5),
            library_ms=time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), 20),
            bound_ms=b_ms, bound_by=b_by))
        del q, k, v, qf, kf, vf, got, want
    for b, t, decays in RWKV_CASES:
        h, d = 40, 64
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
        r, k, v = rnd(b, h, t, d) * 0.5, rnd(b, h, t, d) * 0.5, rnd(b, h, t, d) * 0.5
        if decays == "model":   # models/rwkv.py: w = exp(-exp(w0 + lora)), ~1.8e-24 .. ~0.9997
            w = torch.exp(-torch.exp(torch.rand((b, h, t, d), generator=gen, device=dev) * 12 - 8))
        else:
            w = torch.sigmoid(rnd(b, h, t, d))
        u, s0 = rnd(h, d) * 0.5, rnd(b, h, d, d) * 0.1
        rk.reset_launch_counts()
        o, st = rk.rwkv6(r, k, v, w, u, s0)
        path = next(p for p in ("rwkv6_decode", "rwkv6_chunked") if rk.launch_counts()[p] == 1)
        o_ref, st_ref = rk.rwkv6_ref(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        err = max(float((o - o_ref).abs().max()), float((st - st_ref).abs().max()))
        if not (torch.isfinite(o).all() and torch.allclose(o, o_ref, rtol=1e-4, atol=1e-4)
                and torch.allclose(st, st_ref, rtol=1e-4, atol=1e-4)):
            raise AssertionError(f"rwkv6 != plain at B={b} T={t} ({decays} decays, {path}): "
                                 f"max err {err}")
        nbytes = 4 * (5 * b * h * t * d + 2 * b * h * d * d + h * d)
        b_ms, b_by = bound(nbytes, 5 * d * d * t * b * h)
        call = lambda: rk.rwkv6(r, k, v, w, u, s0)  # noqa: E731
        rows.append(dict(
            kernel="rwkv6", path=path,
            shape=dict(B=b, H=h, T=t, D=d, dtype="float32"), decays=decays,
            max_abs_err=err, tolerance=1e-4,
            ms=time_ms(torch, call, 20), graph_ms=graph_ms(torch, call, 20),
            plain_ms=time_ms(torch, lambda: rk.rwkv6_ref(r, k, v, w, u, s0), 2 if t > 1 else 20),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
        del r, k, v, w, u, s0, o, st, o_ref, st_ref
    torch.cuda.empty_cache()
    for row in rows:
        emit({"phase": "lm_kernel", **row, "card": card})
    return {"rows": rows}


def phase_serving(torch, lm, card: str) -> dict:
    """Full-width, full-depth bf16 serving of both ported families."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine

    results = {}
    for arch, kernel in (("tinyllama-1.1b", "flash_attention"), ("rwkv6-3b", "rwkv6")):
        cfg = get_config(arch)
        allocated_before = torch.cuda.memory_allocated()   # the previous model is gone
        t0 = time.perf_counter()
        model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rng = np.random.default_rng(0)
        lens = rng.integers(SERVE["prompt_min"], SERVE["prompt_max"] + 1, SERVE["requests"])
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(n)),
                        max_new_tokens=SERVE["new_tokens"]) for i, n in enumerate(lens)]
        engine = ServingEngine(cfg, model, max_batch=SERVE["max_batch"],
                               cache_len=SERVE["cache_len"], device="cuda")
        torch.cuda.reset_peak_memory_stats()
        with _watch_logits(model) as finite:
            lm.reset()                               # counts of this run only
            t0 = time.perf_counter()
            done = engine.serve(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = lm.counts()
        for r in done:
            if r.output is None or len(r.output) != SERVE["new_tokens"]:
                raise AssertionError(f"{arch}: request {r.rid} ended with {r.output}")
        if launches[kernel] <= 0:
            raise AssertionError(f"{arch}: kernel {kernel} was not launched while serving")
        if kernel == "flash_attention" and launches["flash_attention_tc"] != launches[kernel]:
            raise AssertionError(f"{arch}: a prefill left the tensor-core flash kernel: {launches}")
        if kernel == "rwkv6" and not (launches["rwkv6_chunked"] > 0 and launches["rwkv6_decode"] > 0
                                      and launches["rwkv6_chunked"] + launches["rwkv6_decode"]
                                      == launches["rwkv6"]):
            raise AssertionError(f"{arch}: serving did not take both RWKV6 paths: {launches}")
        if not bool(torch.stack(finite).all()):
            raise AssertionError(f"{arch}: a prefill or decode step gave a non-finite logit")
        n_new = sum(len(r.output) for r in done)
        out = dict(
            arch=arch, layers=cfg.n_layers, d_model=cfg.d_model, dtype=cfg.param_dtype,
            params=sum(p.numel() for p in model.parameters()), init_s=init_s,
            logit_checks=len(finite), allocated_before_build=allocated_before,
            prompt_lens=[int(n) for n in lens], new_tokens=n_new, wall_s=wall,
            tokens_per_s=n_new / wall,
            prefill_ms=[x * 1e3 for x in engine.prefill_s],
            prefill_ms_mean=1e3 * sum(engine.prefill_s) / len(engine.prefill_s),
            decode_step_ms_mean=1e3 * sum(engine.decode_step_s) / len(engine.decode_step_s),
            decode_step_ms_batch4=_mean_ms(engine, 4), decode_steps=len(engine.decode_step_s),
            max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches)
        emit({"phase": "serving", "card": card, **out})
        results[arch] = out
        del model, engine, done, finite
        torch.cuda.empty_cache()
    return results


def _leaf_devices(tree) -> set:
    """The device types of every tensor in a nested dict (a cache)."""
    if isinstance(tree, dict):
        return set().union(*(_leaf_devices(v) for v in tree.values()))
    return {tree.device.type}


@contextlib.contextmanager
def _watch_logits(model, devices: set = None):
    """While open, ``model.prefill`` / ``decode`` append whether all their
    logits are finite (a device flag: no extra sync while serving), and add
    the device types of their caches' leaves to ``devices`` where given.  On
    exit the class's methods come back, which also breaks the wrapper's
    reference to the model, so ``del model`` frees its weights."""
    flags = []

    def watch(name):
        fn = getattr(model, name)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            flags.append(out[0].isfinite().all())
            if devices is not None:
                devices.update(_leaf_devices(out[1]))
            return out
        setattr(model, name, wrapped)

    watch("prefill")
    watch("decode")
    try:
        yield flags
    finally:
        del model.prefill, model.decode


def _mean_ms(engine, batch: int):
    steps = [t for t, b in zip(engine.decode_step_s, engine.decode_batch) if b == batch]
    return 1e3 * sum(steps) / len(steps) if steps else None


def phase_cross_check(torch, card: str) -> dict:
    """Full width, 2 layers, f32, TF32 off: the card serves what the CPU serves."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    results = {}
    for arch in ("tinyllama-1.1b", "rwkv6-3b"):
        cfg = dataclasses.replace(get_config(arch), n_layers=CROSS["layers"])
        cpu = build_model(cfg, device="cpu", dtype=torch.float32,
                          generator=torch.Generator().manual_seed(1))
        card_model = build_model(cfg, device="cuda", dtype=torch.float32)
        card_model.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab, n) for n in CROSS["prompts"]]
        tokens, logits = {}, {}
        for name, model, dev in (("cuda", card_model, "cuda"), ("cpu", cpu, "cpu")):
            reqs = [Request(rid=i, prompt=p, max_new_tokens=CROSS["new_tokens"])
                    for i, p in enumerate(prompts)]
            eng = ServingEngine(model.cfg, model, max_batch=CROSS["max_batch"],
                                cache_len=CROSS["cache_len"], device=dev)
            tokens[name] = [r.output for r in eng.serve(reqs)]
            with torch.inference_mode():
                lg, _, _ = model.prefill(torch.as_tensor(prompts[0][None], device=dev),
                                         CROSS["cache_len"])
            logits[name] = lg.float().cpu()
        scale = float(logits["cpu"].abs().max())
        err = float((logits["cuda"] - logits["cpu"]).abs().max())
        out = dict(arch=arch, layers=CROSS["layers"], d_model=cfg.d_model, dtype="float32",
                   prompts=list(CROSS["prompts"]), tokens_equal=tokens["cuda"] == tokens["cpu"],
                   prefill_logit_max_abs_err=err, max_abs_logit=scale)
        if not out["tokens_equal"]:
            out["first_difference"] = _first_difference(torch, cpu, prompts, tokens)
        emit({"phase": "cross_check", "card": card, **out})
        if not out["tokens_equal"]:
            raise AssertionError(f"{arch}: card tokens != CPU tokens: {out['first_difference']}")
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{arch}: prefill logits differ by {err} (max |logit| {scale})")
        results[arch] = out
        del cpu, card_model
        torch.cuda.empty_cache()
    return results


def _first_difference(torch, cpu_model, prompts, tokens) -> dict:
    """Where the card's tokens first leave the CPU's, and the CPU's top-2
    logit gap at that step (greedy decode of that request alone)."""
    for i, (a, b) in enumerate(zip(tokens["cuda"], tokens["cpu"])):
        if a == b:
            continue
        step = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([prompts[i], np.asarray(b[:step], dtype=np.int64)])
        with torch.inference_mode():
            lg = cpu_model(torch.as_tensor(seq[None]))[0, -1].float()
        top = torch.topk(lg, 2).values
        return dict(request=i, step=step, cuda=a[step], cpu=b[step],
                    cpu_top2_gap=float(top[0] - top[1]))
    return {}


def _grads_of(torch, fn, inputs, cotangents):
    """(outputs, gradients of the inputs) of ``fn`` under ``cotangents``."""
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return [o.detach() for o in outs], torch.autograd.grad(outs, ins, cotangents)


def _rel_err(got, want) -> float:
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / scale if scale > 0 else math.inf


def _train_kernels(torch, fa, rk) -> list:
    """Phase 13 (a): each kernel's differentiable wrapper against the plain
    version's autograd at a full-width model's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = []
    b, hq, hkv, s, dh = TRAIN_FLASH
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                  for shape in ((b, hq, s, dh), (b, hkv, s, dh), (b, hkv, s, dh), (b, hq, s, dh)))
    diff = lambda *a: fa.flash_attention_diff(*a, causal=True)  # noqa: E731
    plain = lambda *a: fa.attention_ref(*a, causal=True)        # noqa: E731
    fa.reset_launch_counts()
    (o,), grads = _grads_of(torch, diff, (q, k, v), (g,))
    launches = fa.launch_counts()
    (o_ref,), grads_ref = _grads_of(torch, plain, (q, k, v), (g,))
    torch.cuda.synchronize()
    d = (o.float() - o_ref.float()).abs()
    over = float((d - (FLASH_BF16_RTOL * o_ref.float().abs() + FLASH_BF16_ATOL)).max())
    grad_err = max(_rel_err(x, y) for x, y in zip(grads, grads_ref))
    zero = [n for n, x in zip("qkv", grads) if not float(x.float().abs().max()) > 0]
    row = dict(kernel="flash_attention", wrapper="flash_attention_diff",
               shape=dict(B=b, Hq=hq, Hkv=hkv, S=s, Dh=dh, dtype="bfloat16", causal=True),
               launches=launches, max_abs_err=float(d.max()), grad_max_rel_err=grad_err,
               tolerance=(f"out |d| <= {FLASH_BF16_RTOL}·|plain| + {FLASH_BF16_ATOL}; grads "
                          f"{TRAIN_FLASH_GRAD_REL}·max|grad|"),
               fwd_bwd_ms=time_ms(torch, lambda: _grads_of(torch, diff, (q, k, v), (g,)), 5),
               plain_fwd_bwd_ms=time_ms(torch, lambda: _grads_of(torch, plain, (q, k, v), (g,)), 3))
    rows.append(row)
    if launches != {"flash_attention": 1, "flash_attention_tc": 1}:
        raise AssertionError(f"flash_attention_diff's forward left the tensor-core kernel: {launches}")
    if zero or over > 0 or not grad_err <= TRAIN_FLASH_GRAD_REL:
        raise AssertionError(f"flash_attention_diff != plain autograd: {row} (zero grads {zero})")
    del q, k, v, g, o, o_ref, grads, grads_ref, d

    b, h, t, dd = TRAIN_RWKV
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    r, k, v = rnd(b, h, t, dd) * 0.5, rnd(b, h, t, dd) * 0.5, rnd(b, h, t, dd) * 0.5
    w = torch.exp(-torch.exp(torch.rand((b, h, t, dd), generator=gen, device=dev) * 12 - 8))
    u, s0 = rnd(h, dd) * 0.5, rnd(b, h, dd, dd) * 0.1
    cot = (rnd(b, h, t, dd), rnd(b, h, dd, dd))
    ins = (r, k, v, w, u, s0)
    rk.reset_launch_counts()
    (o, st), grads = _grads_of(torch, rk.rwkv6_diff, ins, cot)
    launches = rk.launch_counts()
    (o_ref, st_ref), grads_ref = _grads_of(torch, rk.rwkv6_ref, ins, cot)
    torch.cuda.synchronize()
    err = max(float((o - o_ref).abs().max()), float((st - st_ref).abs().max()))
    grad_errs = {n: _rel_err(x, y) for n, x, y in zip(("r", "k", "v", "w", "u", "s0"),
                                                       grads, grads_ref)}
    ok = (torch.allclose(o, o_ref, rtol=1e-4, atol=1e-4)
          and torch.allclose(st, st_ref, rtol=1e-4, atol=1e-4)
          and all(e <= TRAIN_RWKV_GRAD_REL for e in grad_errs.values()))
    row = dict(kernel="rwkv6", wrapper="rwkv6_diff",
               shape=dict(B=b, H=h, T=t, D=dd, dtype="float32"), decays="model",
               launches=launches, max_abs_err=err, grad_max_rel_err=grad_errs,
               tolerance=f"out rtol = atol = 1e-4; grads {TRAIN_RWKV_GRAD_REL}·max|grad|",
               fwd_bwd_ms=time_ms(torch, lambda: _grads_of(torch, rk.rwkv6_diff, ins, cot), 3),
               plain_fwd_bwd_ms=time_ms(torch, lambda: _grads_of(torch, rk.rwkv6_ref, ins, cot), 1))
    rows.append(row)
    if launches["rwkv6_chunked"] != 1 or launches["rwkv6"] != 1:
        raise AssertionError(f"rwkv6_diff's forward did not take the chunked kernel: {launches}")
    if not ok:
        raise AssertionError(f"rwkv6_diff != plain autograd: {row}")
    torch.cuda.empty_cache()
    return rows


def _leaves_without_gradient(state) -> list:
    """Leaves whose AdamW second moment is 0 everywhere: no step gave them
    a nonzero gradient."""
    return [k for k, v in state["opt_v"].items() if not float(v.abs().max()) > 0]


def _finite_history(hist) -> bool:
    return all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist)


def _train_tinyllama(torch, lm) -> dict:
    """Phase 13 (b): full width and depth, 6 steps with checkpoints, then
    the restart from step 2."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.train import CheckpointManager, TrainConfig, Trainer

    cfg = get_config("tinyllama-1.1b")
    run = TRAIN_LM
    ckpt_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tc = TrainConfig(peak_lr=3e-4, warmup_steps=2, total_steps=run["steps"],
                     microbatches=run["microbatches"], ckpt_every=run["ckpt_every"],
                     ckpt_keep=3, ckpt_dir=str(ckpt_dir), log_every=1)
    stream = TokenStream(vocab=cfg.vocab, seq_len=run["seq_len"],
                         global_batch=run["global_batch"], seed=0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, tc, device="cuda", seed=0)
        lm.reset()                                   # counts of the training steps only
        t0 = time.perf_counter()
        state, hist = trainer.fit(stream.batch, steps=run["steps"])
        wall = time.perf_counter() - t0
        launches = lm.counts()
        peak = torch.cuda.max_memory_allocated()
        step_s = list(trainer.step_times)
        no_grad = _leaves_without_gradient(state)
        straight = {name: {k: t.detach().clone() for k, t in state[name].items()}
                    for name in ("params", "opt_m", "opt_v")}
        ckpt_steps = trainer.ckpt.all_steps()
        del trainer, state
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        resumed = Trainer(cfg, dataclasses.replace(tc, ckpt_dir=None), device="cuda", seed=1)
        _, tree, _ = CheckpointManager(str(ckpt_dir)).restore(run["restart_from"])
        state = resumed.state_from_tree(tree)
        del tree
        restore_s = time.perf_counter() - t0
        state, _ = resumed.fit(stream.batch, steps=run["steps"], state=state,
                               start_step=run["restart_from"])
        restart_diff = max(float((state[name][k].detach().float() - t.float()).abs().max())
                           for name, leaves in straight.items() for k, t in leaves.items())
        del resumed, state, straight
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    tokens = run["global_batch"] * run["seq_len"]
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    out = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, dtype=cfg.param_dtype,
               moment_dtype=tc.moment_dtype, remat=cfg.remat_policy, **run,
               params=cfg.param_count(), losses=[h["loss"] for h in hist],
               grad_norms=[h["grad_norm"] for h in hist], step_s=step_s,
               s_per_step=steady, tokens_per_s=tokens / steady, wall_s=wall,
               max_memory_allocated=peak, launches=launches, leaves_without_gradient=no_grad,
               checkpoint_steps=ckpt_steps, restore_s=restore_s,
               restart_max_abs_diff=restart_diff,
               restart_check="bit-equal, deterministic algorithms on (warn_only)")
    if not _finite_history(hist) or len(hist) != run["steps"]:
        raise AssertionError(f"tinyllama-1.1b: a loss or grad norm is not finite: {hist}")
    if no_grad:
        raise AssertionError(f"tinyllama-1.1b: leaves without a gradient: {no_grad}")
    if not (launches["flash_attention_tc"] > 0
            and launches["flash_attention_tc"] == launches["flash_attention"]):
        raise AssertionError(f"tinyllama-1.1b: the steps left the tensor-core flash kernel: "
                             f"{launches}")
    if restart_diff != 0.0:
        raise AssertionError(f"tinyllama-1.1b: the restart from step {run['restart_from']} "
                             f"differs from the uninterrupted run by {restart_diff}")
    return out


def _train_rwkv(torch, lm) -> dict:
    """Phase 13 (c): rwkv6-3b at full width, depth cut to 4 layers."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.train import TrainConfig, Trainer

    run = TRAIN_RWKV_LM
    cfg = dataclasses.replace(get_config("rwkv6-3b"), n_layers=run["layers"])
    tc = TrainConfig(peak_lr=3e-4, warmup_steps=1, total_steps=run["steps"], log_every=1)
    stream = TokenStream(vocab=cfg.vocab, seq_len=run["seq_len"],
                         global_batch=run["global_batch"], seed=0)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, tc, device="cuda", seed=0)
    lm.reset()
    t0 = time.perf_counter()
    state, hist = trainer.fit(stream.batch, steps=run["steps"])
    wall = time.perf_counter() - t0
    launches = lm.counts()
    step_s = list(trainer.step_times)
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    out = dict(arch=cfg.name, reduced=["n_layers 32 -> 4"], d_model=cfg.d_model, dtype=cfg.param_dtype, remat=cfg.remat_policy, **run,
               losses=[h["loss"] for h in hist], grad_norms=[h["grad_norm"] for h in hist],
               step_s=step_s, s_per_step=steady,
               tokens_per_s=run["global_batch"] * run["seq_len"] / steady, wall_s=wall,
               max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
               leaves_without_gradient=_leaves_without_gradient(state))
    del trainer, state
    torch.cuda.empty_cache()
    if not _finite_history(hist):
        raise AssertionError(f"rwkv6-3b: a loss or grad norm is not finite: {hist}")
    if out["leaves_without_gradient"]:
        raise AssertionError(f"rwkv6-3b: leaves without a gradient: {out['leaves_without_gradient']}")
    if not launches["rwkv6_chunked"] > 0:
        raise AssertionError(f"rwkv6-3b: the chunked RWKV6 kernel was not launched: {launches}")
    return out


class _Recording:
    """The optimizer interface of a train step, keeping the step's gradients."""

    def __init__(self, opt):
        self.opt, self.lr, self.grads = opt, opt.lr, None

    def update(self, grads, state, params):
        self.grads = {k: g.detach().cpu() for k, g in grads.items()}
        return self.opt.update(grads, state, params)


def _step_grads(torch, model, batch):
    """One train step of ``model``: (loss, its gradients on the host)."""
    from repro_torch.train import AdamW, constant_schedule, make_train_step

    rec = _Recording(AdamW(lr=constant_schedule(1e-4)))
    params = dict(model.named_parameters())
    st = rec.opt.init(params)
    state = {"params": params, "opt_m": st.m, "opt_v": st.v, "opt_step": st.step}
    _, metrics = make_train_step(model, rec)(state, batch)
    return float(metrics["loss"]), rec.grads


@contextlib.contextmanager
def _rwkv6_forward(rk_ops, fn):
    """Run ``rwkv6_diff``'s forward through ``fn`` while open (a measurement
    aid: the step's second plain implementation of the recurrence)."""
    saved = rk_ops.rwkv6
    rk_ops.rwkv6 = fn
    try:
        yield
    finally:
        rk_ops.rwkv6 = saved


def _train_cross_check(torch, rk) -> dict:
    """Phase 13 (d): one step card vs CPU, full width, 2 layers, f32.

    rwkv6-3b's gradients at full width are ill-conditioned: two exact f32
    implementations of the step on the same CPU (the recurrence as a token
    loop, ``rwkv6_ref``, or in 16-token chunks, ``rwkv6_chunked_ref``)
    disagree by ~2.4e-4·max|grad| on some leaves.  That disagreement, the
    CPU's floor, is measured here; the card is held within max(1e-4, 2 ×
    floor) of the CPU (each side within one floor of the exact gradient).
    tinyllama-1.1b is held within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels.rwkv6 import ops as rk_ops
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for arch in ("tinyllama-1.1b", "rwkv6-3b"):
        cfg = dataclasses.replace(get_config(arch), n_layers=TRAIN_CROSS["layers"])
        cpu = build_model(cfg, device="cpu", dtype=torch.float32,
                          generator=torch.Generator().manual_seed(2))
        card = build_model(cfg, device="cuda", dtype=torch.float32)
        card.load_state_dict(cpu.state_dict())
        batch = TokenStream(vocab=cfg.vocab, seq_len=TRAIN_CROSS["seq_len"],
                            global_batch=TRAIN_CROSS["global_batch"], seed=2).batch(0)
        loss_card, g_card = _step_grads(torch, card, batch)
        del card
        torch.cuda.empty_cache()
        params0 = {k: t.clone() for k, t in cpu.state_dict().items()}
        loss_cpu, g_cpu = _step_grads(torch, cpu, batch)
        floor = None
        if arch == "rwkv6-3b":
            cpu.load_state_dict(params0)             # the step updated it in place
            chunked = lambda *a: rk.rwkv6_chunked_ref(*a, chunk=rk.CHUNK)  # noqa: E731
            with _rwkv6_forward(rk_ops, chunked):
                _, g_alt = _step_grads(torch, cpu, batch)
            floor = max(_rel_err(g_alt[k], g) for k, g in g_cpu.items())
            del g_alt
        del cpu, params0
        errs = {k: _rel_err(g_card[k], g) for k, g in g_cpu.items()}
        worst = sorted(errs, key=errs.get, reverse=True)[:3]
        tol = 1e-4 if floor is None else max(1e-4, 2 * floor)
        out = dict(arch=arch, layers=cfg.n_layers, d_model=cfg.d_model, dtype="float32",
                   **{k: TRAIN_CROSS[k] for k in ("global_batch", "seq_len")},
                   loss_cuda=loss_card, loss_cpu=loss_cpu,
                   loss_rel_err=abs(loss_card - loss_cpu) / abs(loss_cpu),
                   grad_max_rel_err=errs[worst[0]], worst_leaves={k: errs[k] for k in worst},
                   cpu_floor=floor, grad_tolerance=tol,
                   zero_grad_leaves=[k for k, g in g_card.items() if not float(g.abs().max()) > 0])
        emit({"phase": "train_cross_check", **out})
        if not out["loss_rel_err"] <= 1e-5:
            raise AssertionError(f"{arch}: train loss card {loss_card} != CPU {loss_cpu}")
        if not errs[worst[0]] <= tol or out["zero_grad_leaves"]:
            raise AssertionError(f"{arch}: card gradients differ from the CPU's: {out}")
        results[arch] = out
    return results


def _train_pipeline(torch, lm) -> dict:
    """Phase 13 (e): the reduce-then-train example on the card."""
    path = Path(__file__).resolve().parent / "examples" / "pt_feature_selected_training.py"
    spec = importlib.util.spec_from_file_location("pt_feature_selected_training", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    lm.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        out = example.main(["--device", "cuda"])
    out = dict(out, seconds=time.perf_counter() - t0, launches=lm.counts(),
               printed=printed.getvalue().splitlines())
    if not out["launches"]["flash_attention"] > 0:
        raise AssertionError(f"the pipeline's training did not launch the flash kernel: {out}")
    return out


def phase_training(torch, fa, rk, lm, card: str) -> dict:
    """Phase 13: training on the card, (a)–(e)."""
    out = {"kernels": _train_kernels(torch, fa, rk)}
    for row in out["kernels"]:
        emit({"phase": "train_kernel", **row, "card": card})
    out["tinyllama-1.1b"] = _train_tinyllama(torch, lm)
    emit({"phase": "train_tinyllama", "card": card, **out["tinyllama-1.1b"]})
    out["rwkv6-3b"] = _train_rwkv(torch, lm)
    emit({"phase": "train_rwkv6", "card": card, **out["rwkv6-3b"]})
    out["cross_check"] = _train_cross_check(torch, rk)
    out["pipeline"] = _train_pipeline(torch, lm)
    emit({"phase": "train_pipeline", "card": card, **out["pipeline"]})
    return out


@contextlib.contextmanager
def _flash_by_mask(fa):
    """While open, the flash launches of the models' attention (through
    ``flash_attention_diff``) by mask: ``{"causal": n, "non_causal": n}``."""
    from repro_torch.models import attention
    inner = attention.flash_attention_diff
    seen = {"causal": 0, "non_causal": 0}

    def wrapped(q, k, v, *, causal=True, **kw):
        before = fa.launch_counts()["flash_attention"]
        out = inner(q, k, v, causal=causal, **kw)
        seen["causal" if causal else "non_causal"] += fa.launch_counts()["flash_attention"] - before
        return out
    attention.flash_attention_diff = wrapped
    try:
        yield seen
    finally:
        attention.flash_attention_diff = inner


@contextlib.contextmanager
def _mamba_calls():
    """While open, the Mamba layers' calls (``models.blocks.mamba``) by where
    they ran: ``{"cuda": n, "other": n}`` (input and every parameter on the
    card, or not)."""
    from repro_torch.models import blocks
    inner = blocks.mamba
    seen = {"cuda": 0, "other": 0}

    def wrapped(params, x, cfg, **kw):
        on_card = x.is_cuda and all(p.is_cuda for p in params.parameters())
        seen["cuda" if on_card else "other"] += 1
        return inner(params, x, cfg, **kw)
    blocks.mamba = wrapped
    try:
        yield seen
    finally:
        blocks.mamba = inner


def _family_cfg(arch: str):
    """The phase-14 config of ``arch``: full width, depth (and jamba's expert
    count) cut as FAMILIES says, and the cuts listed."""
    from repro_torch.configs import get_config
    cfg, spec, reduced = get_config(arch), FAMILIES[arch], []
    if "layers" in spec:
        reduced.append(f"layers {cfg.n_layers} -> {spec['layers']}")
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    if "experts" in spec:
        reduced.append(f"experts {cfg.n_experts} -> {spec['experts']} (top-{cfg.top_k} kept)")
        cfg = dataclasses.replace(cfg, n_experts=spec["experts"])
    return cfg, reduced


def _greedy(torch, model, cache, lengths, first, steps: int, finite: list,
            keep_logits: bool = False):
    """``steps`` greedy decode steps from the tokens ``first`` [B, 1]; returns
    (tokens [B, steps], each step's host seconds, each step's last-position
    logits [B, V] on the host with ``keep_logits``, else None)."""
    tok, toks, step_s, kept = first, [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        logits, cache, lengths = model.decode(cache, tok, lengths)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        toks.append(tok.cpu())
        step_s.append(time.perf_counter() - t0)
        finite.append(logits.isfinite().all())
        if keep_logits:
            kept.append(logits[:, -1].float().cpu())
    return torch.cat(toks, dim=1), step_s, (kept if keep_logits else None)


def _greedy_difference(torch, got: dict) -> dict:
    """Where the card's greedy tokens first leave the CPU's, and the CPU's
    top-2 logit gap at that step; ``got[device] = (tokens [B, n], each
    step's logits [B, V])``."""
    diff = (got["cuda"][0] != got["cpu"][0]).nonzero()
    row, step = (int(v) for v in diff[0])
    top = torch.topk(got["cpu"][1][step][row], 2).values
    return dict(row=row, step=step, cuda=int(got["cuda"][0][row, step]),
                cpu=int(got["cpu"][0][row, step]), cpu_top2_gap=float(top[0] - top[1]))


def _family_run(torch, arch: str, cfg, model, rng) -> dict:
    """Drive one family's main path; the traffic is FAMILIES[arch]'s."""
    from repro_torch.serving import Request, ServingEngine

    spec, dev = FAMILIES[arch], torch.device("cuda")
    if "serve" in spec:                                   # ServingEngine.serve, as phase 7
        sv = spec["serve"]
        lens = rng.integers(sv["prompt_min"], sv["prompt_max"] + 1, sv["requests"])
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(n)),
                        max_new_tokens=sv["new_tokens"]) for i, n in enumerate(lens)]
        engine = ServingEngine(cfg, model, max_batch=sv["max_batch"], cache_len=sv["cache_len"],
                               device="cuda")
        devices = set()
        with _watch_logits(model, devices) as finite:
            t0 = time.perf_counter()
            done = engine.serve(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        for r in done:
            if r.output is None or len(r.output) != sv["new_tokens"]:
                raise AssertionError(f"{arch}: request {r.rid} ended with {r.output}")
        return dict(traffic=f"ServingEngine.serve: {sv}", prompt_lens=[int(n) for n in lens],
                    new_tokens=sum(len(r.output) for r in done), wall_s=wall,
                    prefill_s=list(engine.prefill_s), decode_step_s=list(engine.decode_step_s),
                    cache_devices=sorted(devices), finite=finite)
    finite = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        if cfg.is_encdec:                                 # EncDecLM.prefill on frames
            frames = torch.randn((spec["batch"], spec["frames"], cfg.frontend_dim),
                                 generator=torch.Generator(device=dev).manual_seed(3),
                                 device=dev)
            cache, lengths = model.prefill({"frames": frames}, spec["cache_len"])
            first = torch.zeros((spec["batch"], 1), dtype=torch.long, device=dev)
            traffic = (f"EncDecLM.prefill on frames {list(frames.shape)}, cache_len "
                       f"{spec['cache_len']}, then {spec['new_tokens']} greedy decode steps")
        else:                                             # prefill with the frontend's features
            p = cfg.frontend_tokens
            toks = torch.as_tensor(rng.integers(0, cfg.vocab, (spec["batch"],
                                                               p + spec["text_tokens"])),
                                   device=dev)
            feats = torch.randn((spec["batch"], p, cfg.frontend_dim), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(3))
            logits, cache, lengths = model.prefill({"tokens": toks, "frontend_feats": feats},
                                                   spec["cache_len"])
            finite.append(logits.isfinite().all())
            first = logits[:, -1].argmax(-1, keepdim=True)
            traffic = (f"prefill on tokens {list(toks.shape)} + frontend_feats "
                       f"{list(feats.shape)}, cache_len {spec['cache_len']}, then "
                       f"{spec['new_tokens']} greedy decode steps")
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out, step_s, _ = _greedy(torch, model, cache, lengths, first, spec["new_tokens"],
                                 finite)
    if out.shape != (spec["batch"], spec["new_tokens"]):
        raise AssertionError(f"{arch}: decode gave {tuple(out.shape)} tokens")
    return dict(traffic=traffic, new_tokens=out.numel(), wall_s=prefill_s + sum(step_s),
                prefill_s=[prefill_s], decode_step_s=step_s,
                cache_devices=sorted(_leaf_devices(cache)), finite=finite)


def phase_families(torch, fa, lm, card: str) -> dict:
    """Phase 14: MoE, the Mamba hybrid, the VLM and the enc-dec, served in
    bf16 at full width on the card, one after the other."""
    from repro_torch.models import build_model

    results = {}
    for arch in FAMILIES:
        cfg, reduced = _family_cfg(arch)
        allocated_before = torch.cuda.memory_allocated()   # the previous model is gone
        t0 = time.perf_counter()
        model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if any(p.device.type != "cuda" for p in model.parameters()):
            raise AssertionError(f"{arch}: a parameter is not on the card")
        torch.cuda.reset_peak_memory_stats()
        with _flash_by_mask(fa) as by_mask, _mamba_calls() as mamba_calls:
            lm.reset()                                    # counts of this model's run only
            run = _family_run(torch, arch, cfg, model, np.random.default_rng(0))
            launches = lm.counts()
        finite = run.pop("finite")
        if run["cache_devices"] != ["cuda"]:
            raise AssertionError(f"{arch}: cache leaves on {run['cache_devices']}")
        if not bool(torch.stack(finite).all()):
            raise AssertionError(f"{arch}: a prefill or decode step gave a non-finite logit")
        if launches["flash_attention"] <= 0 or (launches["flash_attention_tc"]
                                                != launches["flash_attention"]):
            raise AssertionError(f"{arch}: the bf16 prefills did not all take the tensor-core "
                                 f"flash kernel: {launches}")
        if cfg.is_encdec and by_mask != {"causal": 0, "non_causal": cfg.enc_layers}:
            raise AssertionError(f"{arch}: the encoder's flash launches were {by_mask}, not "
                                 f"{cfg.enc_layers} non-causal")
        n_mamba = sum(k == "mamba" for k in cfg.block_kinds())
        prefills, steps = len(run["prefill_s"]), len(run["decode_step_s"])
        if n_mamba and mamba_calls != {"cuda": n_mamba * (prefills + steps), "other": 0}:
            raise AssertionError(f"{arch}: {n_mamba} Mamba layers over {prefills} prefills and "
                                 f"{steps} steps ran {mamba_calls}")
        out = dict(
            arch=arch, d_model=cfg.d_model, layers=cfg.n_layers, reduced=reduced,
            dtype=cfg.param_dtype, params=sum(p.numel() for p in model.parameters()),
            param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
            init_s=init_s, allocated_before_build=allocated_before, **run,
            prefill_ms=[x * 1e3 for x in run["prefill_s"]],
            prefill_ms_mean=1e3 * sum(run["prefill_s"]) / prefills,
            decode_step_ms_mean=1e3 * sum(run["decode_step_s"]) / steps,
            tokens_per_s=run["new_tokens"] / run["wall_s"], logit_checks=len(finite),
            max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
            flash_by_mask=by_mask, mamba_calls=mamba_calls if n_mamba else None)
        for key in ("prefill_s", "decode_step_s"):
            del out[key]
        emit({"phase": "families", "card": card, **out})
        results[arch] = out
        del model, finite, run
        torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def _router_ids():
    """While open, every MoE layer's top-k expert ids, in call order."""
    from repro_torch.models import moe
    inner, seen = moe.route, []

    def wrapped(*args, **kw):
        gates, ids = inner(*args, **kw)
        seen.append(ids.cpu())
        return gates, ids
    moe.route = wrapped
    try:
        yield seen
    finally:
        moe.route = inner


def _cross_pair(torch, cfg, seed: int):
    """The same f32 parameters on the CPU and on the card."""
    from repro_torch.models import build_model
    cpu = build_model(cfg, device="cpu", dtype=torch.float32,
                      generator=torch.Generator().manual_seed(seed))
    card = build_model(cfg, device="cuda", dtype=torch.float32)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _err(got, want) -> list:
    """[max |got - want|, max |want|] on the host."""
    got, want = got.float().cpu(), want.float().cpu()
    return [float((got - want).abs().max()), float(want.abs().max())]


def _cross_moe(torch, arch: str) -> dict:
    """qwen3-moe, full width, 1 layer: served on both devices."""
    from repro_torch.configs import get_config
    from repro_torch.serving import Request, ServingEngine

    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    cpu, card = _cross_pair(torch, cfg, 4)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n) for n in FAMILY_CROSS["prompts"]]
    tokens, logits = {}, {}
    for name, model, dev in (("cuda", card, "cuda"), ("cpu", cpu, "cpu")):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=FAMILY_CROSS["new_tokens"])
                for i, p in enumerate(prompts)]
        eng = ServingEngine(cfg, model, max_batch=FAMILY_CROSS["max_batch"],
                            cache_len=FAMILY_CROSS["cache_len"], device=dev)
        tokens[name] = [r.output for r in eng.serve(reqs)]
        with torch.inference_mode():
            logits[name], _, _ = model.prefill(torch.as_tensor(prompts[0][None], device=dev),
                                               FAMILY_CROSS["cache_len"])
    out = dict(arch=arch, reduced=[f"layers {get_config(arch).n_layers} -> 1"],
               traffic=f"ServingEngine.serve, prompts {list(FAMILY_CROSS['prompts'])}, "
                       f"{FAMILY_CROSS['new_tokens']} new tokens",
               tokens_equal=tokens["cuda"] == tokens["cpu"],
               checks={"prefill logits of prompt 0": _err(logits["cuda"], logits["cpu"])})
    if not out["tokens_equal"]:
        diff = _first_difference(torch, cpu, prompts, tokens)
        seq = np.concatenate([prompts[diff["request"]],
                              np.asarray(tokens["cpu"][diff["request"]][:diff["step"]])])
        ids = {}
        for name, model, dev in (("cuda", card, "cuda"), ("cpu", cpu, "cpu")):
            with torch.inference_mode(), _router_ids() as seen:
                model(torch.as_tensor(seq[None], device=dev))
            ids[name] = seen
        diff["router_topk_differs"] = any(not torch.equal(a, b)
                                          for a, b in zip(ids["cuda"], ids["cpu"]))
        out["first_difference"] = diff
    return out


def _cross_frontend(torch, arch: str) -> dict:
    """llava-next, full width, 1 layer: a prefill with frontend features,
    then greedy decode steps, on both devices."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    cpu, card = _cross_pair(torch, cfg, 5)
    rng = np.random.default_rng(5)
    p, new = cfg.frontend_tokens, FAMILY_CROSS["new_tokens"]
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, p + FAMILY_CROSS["text_tokens"])))
    feats = torch.as_tensor(rng.standard_normal((1, p, cfg.frontend_dim)).astype(np.float32))
    got, prefill = {}, {}
    for name, model, dev in (("cuda", card, "cuda"), ("cpu", cpu, "cpu")):
        with torch.inference_mode():
            lg, cache, lengths = model.prefill(
                {"tokens": toks.to(dev), "frontend_feats": feats.to(dev)}, toks.shape[1] + new)
            first = lg[:, -1].argmax(-1, keepdim=True)
            out, _, logits = _greedy(torch, model, cache, lengths, first, new - 1, [],
                                     keep_logits=True)
        # the first token comes from the prefill's logits, the rest from the steps'
        got[name] = (torch.cat([first.cpu(), out], dim=1), [lg[:, -1].float().cpu()] + logits)
        prefill[name] = lg
    out = dict(arch=arch, reduced=[f"layers {get_config(arch).n_layers} -> 1"],
               traffic=f"prefill on tokens {list(toks.shape)} + frontend_feats "
                       f"{list(feats.shape)}, then {new - 1} greedy decode steps",
               tokens_equal=torch.equal(got["cuda"][0], got["cpu"][0]),
               checks={"prefill logits": _err(prefill["cuda"], prefill["cpu"])})
    if not out["tokens_equal"]:
        out["first_difference"] = _greedy_difference(torch, got)
    return out


def _cross_encdec(torch, arch: str) -> dict:
    """seamless-m4t-medium at full size: encode frames, greedy decode."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    cpu, card = _cross_pair(torch, cfg, 6)
    frames = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (2, FAMILY_CROSS["frames"], cfg.frontend_dim)).astype(np.float32))
    new, got, cross_k = FAMILY_CROSS["new_tokens"], {}, {}
    for name, model, dev in (("cuda", card, "cuda"), ("cpu", cpu, "cpu")):
        with torch.inference_mode():
            cache, lengths = model.prefill({"frames": frames.to(dev)}, new)
            cross_k[name] = cache["cross_k"].clone()
            first = torch.zeros((2, 1), dtype=torch.long, device=dev)
            toks, _, logits = _greedy(torch, model, cache, lengths, first, new, [],
                                      keep_logits=True)
        got[name] = (toks, logits)
    out = dict(arch=arch, reduced=[], traffic=f"EncDecLM.prefill on frames "
                                              f"{list(frames.shape)}, then {new} greedy steps",
               tokens_equal=torch.equal(got["cuda"][0], got["cpu"][0]),
               checks={"cross_k": _err(cross_k["cuda"], cross_k["cpu"]),
                       "first decode step's logits": _err(got["cuda"][1][0], got["cpu"][1][0])})
    if not out["tokens_equal"]:
        out["first_difference"] = _greedy_difference(torch, got)
    return out


def _cross_mamba_block(torch, arch: str) -> dict:
    """jamba's first block at full width (Mamba + dense MLP) as one Block:
    a prefill, then decode steps from its state, on both devices."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import Block, layer_pattern

    cfg = dataclasses.replace(get_config(arch), param_dtype="float32", compute_dtype="float32")
    kind, is_moe = layer_pattern(cfg)[0][0]
    if (kind, is_moe) != ("mamba", False):
        raise AssertionError(f"{arch}: pattern position 0 is {kind}, MoE {is_moe}")
    cpu = Block(cfg, kind, is_moe, device=torch.device("cpu"), seed=7, prefix="/blocks/pos0/0")
    card = Block(cfg, kind, is_moe, device=torch.device("cuda"), seed=0, prefix="/blocks/pos0/0")
    card.load_state_dict(cpu.state_dict())
    n, steps = FAMILY_CROSS["block_tokens"], FAMILY_CROSS["block_steps"]
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (1, n + steps, cfg.d_model)).astype(np.float32))
    got = {}
    for name, blk, dev in (("cuda", card, "cuda"), ("cpu", cpu, "cpu")):
        xd = x.to(dev)
        with torch.inference_mode():
            y, cache = blk.full(xd[:, :n], torch.arange(n, device=dev)[None],
                                window=cfg.window, collect_cache=True)
            ys = [y]
            for i in range(n, n + steps):
                y_i, cache = blk.decode(xd[:, i:i + 1], cache, None, window=cfg.window)
                ys.append(y_i)
        got[name] = {"block outputs (prefill and decode steps)": torch.cat(ys, dim=1),
                     "conv state": cache["conv"], "ssm state": cache["ssm"]}
    return dict(arch=arch, block="pattern position 0: mamba + dense MLP",
                reduced=["one block of 72"], traffic=f"Block.full on {n} tokens, then "
                                                      f"{steps} Block.decode steps",
                tokens_equal=True,
                checks={k: _err(got["cuda"][k], got["cpu"][k]) for k in got["cpu"]})


def phase_families_cross(torch, card: str) -> dict:
    """Phase 15: the new families on the card against the CPU, f32, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    results = {}
    for arch, fn in (("qwen3-moe-235b-a22b", _cross_moe), ("seamless-m4t-medium", _cross_encdec),
                     ("llava-next-34b", _cross_frontend),
                     ("jamba-1.5-large-398b", _cross_mamba_block)):
        t0 = time.perf_counter()
        out = fn(torch, arch)
        out["seconds"] = time.perf_counter() - t0
        emit({"phase": "families_cross", "card": card, **out})
        if not out["tokens_equal"]:
            raise AssertionError(f"{arch}: card tokens != CPU tokens: {out['first_difference']}")
        bad = {k: v for k, v in out["checks"].items() if not v[0] <= 1e-4 * v[1]}
        if bad:
            raise AssertionError(f"{arch}: card and CPU differ past 1e-4·max|CPU| ([err, max]): "
                                 f"{bad}")
        results[arch] = out
        gc.collect()
        torch.cuda.empty_cache()
    return results


def median_ms(torch, fn, reps: int, calls: int = 10) -> float:
    """Median over ``reps`` repeats of the mean CUDA-event time of ``calls``
    back-to-back calls of ``fn`` (a wrapper's host work included, as phase
    3's times), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def _tile_call(ops, kernel: str, o: dict, n_bins: int, n_dec: int, delta, tiles, V: int):
    """One wrapper call of ``kernel`` on the operands ``o`` with ``tiles``."""
    if kernel == "contingency":
        return ops.contingency(o["packed"], o["d"], o["w"], n_bins=n_bins, n_dec=n_dec,
                               threads=tiles[0], ctas=tiles[1])
    if kernel == "fused":
        return ops.fused_theta(o["packed"], o["d"], o["w"], o["n"], delta=delta, n_bins=n_bins,
                               n_dec=n_dec, chunk=tiles[0], threads=tiles[1])
    return ops.sweep_theta(o["x_t"], o["r"], o["d"], o["w"], o["n"], delta=delta, v_max=V,
                           n_bins=n_bins, n_dec=n_dec, bc=tiles[0], chunk=tiles[1],
                           threads=tiles[2])


def _plain_call(ref, kernel: str, o: dict, n_bins: int, n_dec: int, delta, V: int):
    if kernel == "contingency":
        return ref.contingency_ref(o["packed"], o["d"], o["w"], n_bins=n_bins, n_dec=n_dec)
    if kernel == "fused":
        return ref.fused_theta_ref(o["packed"], o["d"], o["w"], o["n"], delta=delta,
                                   n_bins=n_bins, n_dec=n_dec)
    return ref.sweep_theta_ref(o["x_t"], o["r"], o["d"], o["w"], o["n"], delta=delta, v_max=V,
                               n_bins=n_bins, n_dec=n_dec)


def _tiles_bit_equal(torch, ops, ref, model) -> dict:
    """16 (a): every feasible tiling of each kernel against its plain version."""
    dev = torch.device("cuda")
    nc, G, n_bins, V = (TILES_SMALL[k] for k in ("nc", "G", "n_bins", "V"))
    checked = {name: 0 for name in TILE_KERNELS}
    for n_dec in TILES_SMALL["n_decs"]:
        for K in TILES_SMALL["Ks"]:
            gen = torch.Generator().manual_seed(1600 + 10 * n_dec + K)
            r = torch.randint(0, K, (G,), generator=gen, dtype=torch.int32)
            x_t = torch.randint(0, V, (nc, G), generator=gen, dtype=torch.int32)
            d = torch.randint(0, n_dec, (G,), generator=gen, dtype=torch.int32)
            w = torch.randint(1, 200, (G,), generator=gen).to(torch.float32)
            pad = torch.rand((G,), generator=gen) < 0.24
            w[pad] = 0.0
            o = {k: t.to(dev) for k, t in dict(r=r, x_t=x_t, d=d, w=w).items()}
            o["packed"] = (o["r"][None, :] * V + o["x_t"]).contiguous()
            o["n"] = float(w.sum())
            for kernel in TILE_KERNELS:
                tilings = model.feasible_tiles(kernel, nc, G, n_bins, n_dec)
                for delta in ((None,) if kernel == "contingency" else ("PR", "SCE")):
                    want = _plain_call(ref, kernel, o, n_bins, n_dec, delta, V)
                    first = None
                    for tiles in tilings:
                        got = _tile_call(ops, kernel, o, n_bins, n_dec, delta, tiles, V)
                        first = got if first is None else first
                        if delta in (None, "PR"):
                            ok = torch.equal(got, want)
                        else:
                            scale = float(want.abs().max())
                            ok = torch.equal(got, first) and torch.allclose(
                                got, want, rtol=1e-5, atol=1e-6 * scale)
                        if not ok:
                            raise AssertionError(
                                f"{kernel} tiling {tiles} != plain for {delta} at n_dec={n_dec},"
                                f" K={K}: max err {float((got - want).abs().max())}")
                        checked[kernel] += 1
    torch.cuda.synchronize()
    return {"launches_checked": checked, "shape": {k: v for k, v in TILES_SMALL.items()}}


def _tiles_at_kdd99(torch, ops, autotune, model, card: str) -> dict:
    """16 (b): the selectors' tilings at phase 3's top row, measured, modeled
    and bounded."""
    dev = torch.device("cuda")
    G, n_dec, V, nc = SHAPE["G"], SHAPE["n_dec"], SHAPE["V"], SHAPE["nc"]
    top = N_BINS[-1]
    x_t, r, d, w, packed = operands(torch, top, dev)
    # |U| on the card: a host scalar would be copied in, which a CUDA graph refuses
    o = dict(x_t=x_t, r=r, d=d, w=w, packed=packed, n=torch.tensor(float(w.sum()), device=dev))
    nbytes = {"contingency": packed.numel() * 4 + 2 * G * 4 + nc * top * n_dec * 4,
              "fused": packed.numel() * 4 + 2 * G * 4 + nc * 4,
              "sweep": x_t.numel() * 4 + 3 * G * 4 + nc * 4}
    ops_count = {"contingency": nc * G, "fused": 5 * nc * G, "sweep": 5 * nc * G}
    out = {}
    for kernel in TILE_KERNELS:
        delta = None if kernel == "contingency" else "PR"
        shape = dict(nc=nc, g=G, n_bins=top, m=n_dec, v_max=V, delta="PR")
        picks = {sel: tuple(autotune.resolve_tiles(kernel, selector=sel, device=dev, **shape))
                 for sel in autotune.SELECTOR_MODES}
        picks["refined"] = tuple(autotune.autotune_block_sizes(
            nc, G, top, n_dec, kernel=kernel, delta=delta, v_max=V, refine=True, top_k=3,
            device=dev))
        ranked = model.rank_tiles(kernel, nc, G, top, n_dec, v_max=V, delta="PR", spec=CARD.spec)
        order = [picks["pinned"], picks["heuristic"], picks["analytic"], picks["refined"]]
        order += [t for t, _, _ in ranked[:3]]
        b_ms, b_by = bound(nbytes[kernel], ops_count[kernel])
        rows = []
        for tiles in dict.fromkeys(order):
            cost = model.kernel_cost(kernel, nc, G, top, n_dec, tiles, v_max=V, delta="PR",
                                     spec=CARD.spec)
            row = dict(kernel=TILE_KERNELS[kernel], tiles=list(tiles),
                       fields=list(model.TILE_FIELDS[kernel]),
                       selectors=[k for k, v in picks.items() if v == tiles],
                       model_rank=next((i for i, (t, _, _) in enumerate(ranked) if t == tiles),
                                       None),
                       ms=median_ms(torch, lambda t=tiles: _tile_call(
                           ops, kernel, o, top, n_dec, delta, t, V), TILES_REPS),
                       # the device time alone (a CUDA graph of 5 calls); the
                       # contingency's 4.9 GB output a call is left out
                       graph_ms=None if kernel == "contingency" else graph_ms(
                           torch, lambda t=tiles: _tile_call(ops, kernel, o, top, n_dec, delta,
                                                             t, V), TILES_REPS),
                       modeled_ms=model.modeled_time_s(cost, CARD.spec) * 1e3,
                       bound_ms=b_ms, bound_by=b_by, n_bins=top, delta=delta)
            rows.append(row)
            emit({"phase": "tiles_kdd99", "card": card, **row})
            torch.cuda.empty_cache()
        out[kernel] = {"picks": {k: list(v) for k, v in picks.items()}, "rows": rows}
    return out


def _tiles_reductions(torch, ops, autotune, engine, plar_reduce, gran, main_runs) -> list:
    """16 (c): kdd99 under each selector on sweep and on segment (device
    engine); reducts and Θ_PR histories equal phase 4's."""
    autotune.autotune_cache_clear(disk=True)     # the model's own picks, not (b)'s tunings
    want = {o["backend"]: o for o in main_runs if o["delta"] == "PR"}
    rows = []
    for backend, eng in (("sweep", "host"), ("segment", "device")):
        for sel in autotune.SELECTOR_MODES:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = plar_reduce(source=gran, delta="PR", backend=backend, engine=eng, selector=sel,
                              device="cuda")
            torch.cuda.synchronize()
            row = dict(backend=backend, engine=eng, selector=sel, reduct=res.reduct,
                       elapsed_s=res.elapsed_s, wall_s=time.perf_counter() - t0,
                       launches=ops.launch_counts(),
                       same_as_phase_4=(res.reduct, res.core, res.theta_history) == (
                           want[backend]["reduct"], want[backend]["core"],
                           want[backend]["theta_history"]))
            if not row["same_as_phase_4"]:
                raise AssertionError(f"kdd99 {backend}/{sel} differs from phase 4: {row}")
            if backend == "sweep" and row["launches"]["sweep_theta"] <= 0:
                raise AssertionError(f"the sweep kernel was not launched under {sel}")
            rows.append(row)
        engine.release_graphs()
    return rows


def phase_tiles(torch, ops, ref, autotune, model, engine, plar_reduce, resolve_granularity,
                scaled_paper_dataset, main_runs, card: str) -> dict:
    """Phase 16: every tiling gives the plain bits; the selectors' tilings
    timed at kdd99's shapes; kdd99 reduced under each selector."""
    out = {"bit_equal": _tiles_bit_equal(torch, ops, ref, model)}
    emit({"phase": "tiles_bit_equal", "card": card, **out["bit_equal"]})
    print(card, flush=True)
    out["kdd99"] = _tiles_at_kdd99(torch, ops, autotune, model, card)
    x, d = scaled_paper_dataset("kdd99", max_rows=5_000_000, max_attrs=64).table()
    gran = resolve_granularity(x, d, device="cuda")
    del x, d
    out["reductions"] = _tiles_reductions(torch, ops, autotune, engine, plar_reduce, gran,
                                          main_runs)
    for row in out["reductions"]:
        emit({"phase": "tiles_reduce", "card": card, **row})
    del gran
    torch.cuda.empty_cache()
    return out


def _paper_tables(torch, paper_tables, card: str) -> dict:
    """(a) The five tables at JAX's defaults on ``segment``; ``table_6_9``
    also on ``sweep``.  Each row printed, with its table and backend."""
    out = {}
    runs = [(name, "segment") for name in paper_tables.ALL_TABLES] + [("table_6_9", "sweep")]
    for name, backend in runs:
        t0 = time.perf_counter()
        rows = paper_tables.ALL_TABLES[name](device="cuda", backend=backend)
        seconds = time.perf_counter() - t0
        for row in rows:
            emit({"phase": "paper_table", "table": name, "backend": backend, "card": card,
                  **row})
        out[f"{name}/{backend}"] = {"rows": rows, "seconds": seconds}
    return out


def _sdss_table_11(torch, paper_tables, card: str) -> dict:
    """``table_11``'s configuration at the full sdss stand-in, on ``sweep``."""
    t0 = time.perf_counter()
    rows = paper_tables.table_11(max_rows=SDSS["rows"], max_attrs=SDSS["attrs"],
                                 device="cuda", backend="sweep")
    out = {"rows": rows, "seconds": time.perf_counter() - t0, "backend": "sweep",
           "table": [SDSS["rows"], SDSS["attrs"]]}
    emit({"phase": "paper_sdss_table_11", "card": card, **out})
    return out


def _sdss_reductions(torch, ops, plar_reduce, resolve_granularity, scaled_paper_dataset,
                     card: str) -> dict:
    """One whole greedy PR reduction of the full sdss stand-in on each
    kernel backend and on ``segment`` (the plain-PyTorch answer,
    :func:`plain_segment`)."""
    x, d = scaled_paper_dataset("sdss", max_rows=SDSS["rows"], max_attrs=SDSS["attrs"]).table()
    if list(x.shape) != [SDSS["rows"], SDSS["attrs"]] or int(d.max()) + 1 != SDSS["classes"]:
        raise AssertionError(f"sdss table {list(x.shape)}, {int(d.max()) + 1} classes")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gran = resolve_granularity(x, d, device="cuda")
    granules, capacity = int(gran.num), gran.capacity
    torch.cuda.synchronize()
    granulate_s = time.perf_counter() - t0
    granulate_peak = torch.cuda.max_memory_allocated()
    del x, d
    runs = []
    for backend in SDSS["backends"]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with plain_if_segment(backend):
            r = plar_reduce(source=gran, delta="PR", backend=backend, engine="host",
                            compute_core=False, device="cuda")
        torch.cuda.synchronize()
        run = dict(backend=backend, engine="host", reduct=r.reduct, iterations=r.iterations,
                   theta_full=r.theta_full, theta_history=r.theta_history,
                   evaluations=r.n_evaluations, elapsed_s=r.elapsed_s,
                   wall_s=time.perf_counter() - t0,
                   per_iteration_s=r.per_iteration_s,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches=ops.launch_counts())
        if not all(math.isfinite(v) for v in r.theta_history + [r.theta_full]):
            raise AssertionError(f"non-finite Θ in the sdss {backend} run")
        emit({"phase": "paper_sdss", "card": card, "table": [SDSS["rows"], SDSS["attrs"]],
              "granules": granules, "capacity": capacity, "granulate_s": granulate_s,
              "reduced": SDSS["reduced"], **run})
        runs.append(run)
    del gran
    torch.cuda.empty_cache()
    plain = runs[0]
    for run in runs[1:]:
        if run["reduct"] != plain["reduct"]:
            raise AssertionError(f"sdss reduct on {run['backend']} {run['reduct']} != "
                                 f"segment's {plain['reduct']}")
        if run["theta_history"] != plain["theta_history"]:
            raise AssertionError(f"sdss Θ_PR history on {run['backend']} differs from segment's")
    kernel_of = {"sweep": "sweep_theta", "fused": "fused_theta", "pallas": "contingency"}
    launches = {kernel_of[r["backend"]]: r["launches"][kernel_of[r["backend"]]]
                for r in runs if r["backend"] in kernel_of}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by its sdss run")
    out = dict(table=[SDSS["rows"], SDSS["attrs"]], granules=granules, capacity=capacity,
               granulate_s=granulate_s, granulate_peak=granulate_peak, runs=runs,
               launches=launches, reduced=SDSS["reduced"])
    emit({"phase": "paper_sdss_check", "card": card, "reducts_equal": True,
          "theta_pr_bit_equal": True, "launches": launches, "granulate_s": granulate_s,
          "granulate_peak": granulate_peak, "reduced": SDSS["reduced"]})
    return out


def _dryrun_steps(torch, ops, card: str) -> dict:
    """(c) The dry-run cell's shard steps, one pod and two, on a world of one
    NCCL rank: every evaluation form, and the fused schedule's kernel."""
    import torch.distributed as dist

    from repro_torch.distributed import init_process_group
    from repro_torch.launch import dryrun

    store = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_")) / "store"
    init_process_group("cuda", rank=0, world_size=1, store_path=str(store), timeout_s=300)
    records = []
    try:
        for mesh_kind in ("single", "multi"):
            for collective, fused_pack in DRYRUN_FORMS:
                rec = dryrun.run_plar_cell(mesh_kind, collective=collective,
                                           fused_pack=fused_pack, execute=True, device="cuda")
                emit({"phase": "paper_dryrun", "card": card, **rec})
                if rec["status"] != "ok":
                    raise AssertionError(f"dry-run {mesh_kind}/{collective}: {rec.get('reason')}")
                if collective == "fused" and rec["executed"]["launches"]["fused_theta"] <= 0:
                    raise AssertionError("the fused dry-run step launched no fused-Θ kernel")
                records.append(rec)
    finally:
        dist.destroy_process_group()
    return {"records": records}


def _mesh_train(torch, lm, mesh) -> dict:
    """Phase 18 (a): the same 3 Trainer steps with ``mesh=`` and without."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import unshard
    from repro_torch.train import TrainConfig, Trainer

    run = MESH_LM["train"]
    full = get_config(run["arch"])
    cfg = dataclasses.replace(full, n_layers=run["layers"])
    tc = TrainConfig(peak_lr=3e-4, warmup_steps=1, total_steps=run["steps"], log_every=1)
    stream = TokenStream(vocab=cfg.vocab, seq_len=run["seq_len"],
                         global_batch=run["global_batch"], seed=0)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for tag, m in (("unsharded", None), ("mesh", mesh)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tr = Trainer(cfg, tc, mesh=m, device="cuda", seed=0)
            state = tr.init_state()
            lm.reset()                                   # this run's steps only
            losses, gnorms, step_s = [], [], []
            for step in range(run["steps"]):
                t0 = time.perf_counter()
                state, met = tr.step_fn(state, stream.batch(step))
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(met["loss"]))
                gnorms.append(float(met["grad_norm"]))
            out[tag] = dict(losses=losses, grad_norms=gnorms, step_s=step_s,
                            s_per_step=sorted(step_s[1:])[len(step_s[1:]) // 2],
                            max_memory_allocated=torch.cuda.max_memory_allocated(),
                            launches=lm.counts(),
                            params={k: unshard(v).detach().clone()
                                    for k, v in state["params"].items()})
            del tr, state
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = out["unsharded"], out["mesh"]
    param_err = {k: float((b["params"][k].float() - v.float()).abs().max() /
                          max(float(v.float().abs().max()), 1e-30))
                 for k, v in a["params"].items()}
    bit_equal = dict(losses=a["losses"] == b["losses"], grad_norms=a["grad_norms"] ==
                     b["grad_norms"], params=all(torch.equal(b["params"][k], v)
                                                 for k, v in a["params"].items()))
    for r in (a, b):
        del r["params"]
    res = dict(arch=cfg.name, d_model=cfg.d_model, heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
               head_dim=cfg.hd, dtype=cfg.param_dtype,
               reduced=[f"layers {full.n_layers} -> {cfg.n_layers}"],
               tokens=f"{run['global_batch']} x {run['seq_len']}", steps=run["steps"],
               unsharded=a, mesh=b, bit_equal=bit_equal,
               max_param_rel_err=max(param_err.values()))
    for key in ("losses", "grad_norms"):
        bad = [(x, y) for x, y in zip(a[key], b[key]) if abs(y - x) > 1e-5 * abs(x)]
        if bad or not all(math.isfinite(x) for x in b[key]):
            raise AssertionError(f"phase 18 (a): {key} on the mesh differ: {bad}")
    if res["max_param_rel_err"] > 1e-4:
        worst = max(param_err, key=param_err.get)
        raise AssertionError(f"phase 18 (a): parameter {worst} differs by "
                             f"{param_err[worst]} of its max")
    fl = (a["launches"]["flash_attention_tc"], b["launches"]["flash_attention_tc"])
    if not (fl[0] > 0 and fl[0] == fl[1] and b["launches"]["flash_attention"] == fl[1]):
        raise AssertionError(f"phase 18 (a): flash launches {b['launches']} on the mesh, "
                             f"{a['launches']} without")
    return res


def _mesh_serve(torch, lm, model, toks, cache_len: int, steps: int, mesh) -> dict:
    """Prefill and ``steps`` greedy decode steps, under ``use_mesh(mesh)``
    (and ``no_grad``: DTensor's views fail under ``inference_mode`` in torch
    2.11)."""
    from repro_torch.distributed import unshard, use_mesh

    torch.cuda.synchronize()
    lm.reset()
    t0 = time.perf_counter()
    with torch.no_grad(), use_mesh(mesh):
        logits, cache, lengths = model.prefill(toks, cache_len)
        out = [unshard(logits)[:, -1].argmax(-1, keepdim=True)]
        for _ in range(steps):
            logits, cache, lengths = model.decode(cache, out[-1], lengths)
            out.append(unshard(logits)[:, -1].argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    return dict(tokens=torch.cat(out, 1).cpu(), seconds=time.perf_counter() - t0,
                launches=lm.counts())


def _mesh_serving(torch, lm, mesh, key: str) -> dict:
    """Phase 18 (b)/(c): the same greedy serving with and without the mesh."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    run = MESH_LM[key]
    if key == "moe":
        cfg, reduced = _family_cfg(run["arch"])
        cfg = dataclasses.replace(cfg, moe_weight_stationary=True)
    else:
        full = get_config(run["arch"])
        cfg = dataclasses.replace(full, n_layers=run["layers"])
        reduced = [f"layers {full.n_layers} -> {cfg.n_layers}"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (run["batch"], run["prompt"])),
                           device="cuda")
    local = _mesh_serve(torch, lm, model, toks, run["cache_len"], run["new_tokens"], None)
    model.shard(mesh)
    sharded = _mesh_serve(torch, lm, model, toks, run["cache_len"], run["new_tokens"], mesh)
    peak = torch.cuda.max_memory_allocated()
    del model
    torch.cuda.empty_cache()
    same = torch.equal(local["tokens"], sharded["tokens"])
    res = dict(arch=cfg.name, d_model=cfg.d_model, dtype=cfg.param_dtype, reduced=reduced,
               moe_weight_stationary=cfg.moe_weight_stationary,
               traffic=f"prefill {run['batch']} x {run['prompt']}, {run['new_tokens']} greedy "
                       f"decode steps, cache_len {run['cache_len']}",
               tokens_equal=same, tokens=sharded["tokens"].tolist(),
               local_s=local["seconds"], mesh_s=sharded["seconds"],
               local_launches=local["launches"], mesh_launches=sharded["launches"],
               max_memory_allocated=peak)
    if not same:
        raise AssertionError(f"phase 18 ({key}): tokens on the mesh {sharded['tokens']} "
                             f"differ from the local path's {local['tokens']}")
    if sharded["launches"] != local["launches"] or not any(local["launches"].values()):
        raise AssertionError(f"phase 18 ({key}): launches {sharded['launches']} on the mesh, "
                             f"{local['launches']} without")
    if key == "rwkv" and not (local["launches"]["rwkv6_chunked"] > 0
                              and local["launches"]["rwkv6_decode"] > 0):
        raise AssertionError(f"phase 18 (b): an RWKV6 path was not launched: {local['launches']}")
    return res


def _mesh_collectives(torch, mesh) -> dict:
    """Phase 18 (d): the int8 compressed mean and a one-stage pipeline on NCCL."""
    from repro_torch.distributed import (compressed_psum_mean, make_mesh, pipeline_apply,
                                         use_mesh)

    dev = torch.device("cuda")
    x = torch.randn(MESH_LM["compress_n"], generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev)
    with use_mesh(mesh):
        mean, res = compressed_psum_mean(x, ("data",), n_shards=1)
    step = float(x.abs().max()) / 127.0
    comp_err = float((mean - x).abs().max())
    pipe = make_mesh((1,), ("pipe",), device="cuda")
    pp = MESH_LM["pipe"]
    gen = torch.Generator(device=dev).manual_seed(5)
    ws = torch.randn((1, pp["D"], pp["D"]), generator=gen, device=dev) * pp["D"] ** -0.5
    xs = torch.randn((pp["M"], pp["mb"], pp["D"]), generator=gen, device=dev)
    stage = lambda w, h: torch.tanh(h @ w)                                 # noqa: E731
    ys = pipeline_apply(stage, pipe)(ws, xs)
    pipe_equal = torch.equal(ys, stage(ws[0], xs))
    out = dict(compress=dict(n=x.numel(), max_abs_err=comp_err, quant_step=step,
                             residual_exact=torch.equal(res, x - mean)),
               pipeline=dict(stages=1, **pp, equal_to_stage_fn=pipe_equal))
    if not comp_err <= step or not out["compress"]["residual_exact"]:
        raise AssertionError(f"phase 18 (d): compressed mean off by {comp_err} (step {step})")
    if not pipe_equal:
        raise AssertionError("phase 18 (d): the one-stage pipeline differs from stage_fn")
    return out


def phase_mesh_lm(torch, lm, card: str) -> dict:
    """Phase 18: LM distribution on a world of one NCCL rank, mesh (1, 1)."""
    import torch.distributed as dist

    from repro_torch.distributed import init_process_group, make_mesh

    store = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_lm_")) / "store"
    init_process_group("cuda", rank=0, world_size=1, store_path=str(store), timeout_s=300)
    t0 = time.perf_counter()
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        out = {"mesh": dict(mesh.shape), "world": dist.get_world_size(),
               "backend": dist.get_backend()}
        out["train"] = _mesh_train(torch, lm, mesh)
        emit({"phase": "mesh_lm_train", "card": card, **out["train"]})
        out["rwkv"] = _mesh_serving(torch, lm, mesh, "rwkv")
        emit({"phase": "mesh_lm_rwkv6", "card": card, **out["rwkv"]})
        out["moe"] = _mesh_serving(torch, lm, mesh, "moe")
        emit({"phase": "mesh_lm_moe", "card": card, **out["moe"]})
        out["collectives"] = _mesh_collectives(torch, mesh)
        out["seconds"] = time.perf_counter() - t0
        emit({"phase": "mesh_lm", "card": card, "seconds": out["seconds"],
              **out["collectives"]})
        return out
    finally:
        dist.destroy_process_group()


def _model_vs_card(torch, fa) -> dict:
    """Phase 19 (a): one training step counted modelled, then for real."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import init_process_group, make_mesh
    from repro_torch.launch import dryrun, specs
    from repro_torch.models.config import ShapeConfig

    cfg = get_config(MODEL_CARD["arch"])
    shape = ShapeConfig("train_2x2048", MODEL_CARD["seq_len"], MODEL_CARD["global_batch"],
                        "train")
    t0 = time.perf_counter()
    with dryrun.fake_world((1, 1), ("data", "model")) as mesh:
        fn, args, _, _ = specs.make_setup(cfg, shape, mesh)
        modelled = dryrun.count_step(fn, args)
        del fn, args
    model_s = time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_model_card_")) / "store"
    init_process_group("cuda", rank=0, world_size=1, store_path=str(store), timeout_s=300)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn, args, _, _ = specs.make_setup(cfg, shape, mesh)
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        real = dryrun.count_step(fn, args)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        measured = torch.cuda.max_memory_allocated() - base
        launches = fa.launch_counts()
        del fn, args
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    total = modelled["memory"]["total_hbm_bytes"]
    out = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.param_dtype,
               tokens=f"{shape.global_batch} x {shape.seq_len}", mesh=[1, 1],
               modelled_s=model_s, step_s=step_s,
               flash_twin_calls=modelled["modelled"]["flash_attention"],
               flash_launches=launches["flash_attention"],
               flops=dict(modelled=modelled["flops"], real=real["flops"]),
               bytes=dict(modelled=modelled["bytes"], real=real["bytes"]),
               convert_bytes=dict(modelled=modelled["convert_bytes"],
                                  real=real["convert_bytes"]),
               collectives=dict(modelled=modelled["calls"], real=real["calls"]),
               ops=dict(modelled=modelled["ops"], real=real["ops"]),
               memory_modelled=modelled["memory"], counted_peak_real=real["memory"],
               total_hbm_bytes=total, measured_peak_bytes=measured,
               modelled_over_measured=total / measured)
    if not (out["flash_twin_calls"] == out["flash_launches"] > 0):
        raise AssertionError(f"phase 19 (a): {out['flash_twin_calls']} flash twin calls, "
                             f"{out['flash_launches']} launches on the card")
    for key in ("flops", "bytes"):
        if out[key]["modelled"] != out[key]["real"]:
            raise AssertionError(f"phase 19 (a): counted {key} differ: {out[key]}, "
                                 f"ops {out['ops']}")
    return out


def _benches(torch, card: str) -> dict:
    """Phase 19 (b): the four benches at the JAX presets' sizes on the card."""
    from repro_torch.launch import bench_chaos, bench_common, bench_ingest, bench_obs
    from repro_torch.launch import bench_serve

    presets = ((bench_serve, ["serve_batched_vs_single_flight", "serve_dedup_and_admission"]),
               (bench_chaos, list(bench_chaos.SECTIONS)),
               (bench_obs, list(bench_obs.SECTIONS)),
               (bench_ingest, ["ingest_stream_vs_monolithic"]))
    out = {}
    for mod, sections in presets:
        name = mod.__name__.rsplit(".", 1)[-1]
        t0 = time.perf_counter()
        results = {sec: mod.SECTIONS[sec](device="cuda") for sec in sections}
        bounds = bench_common.check_bounds(mod.BOUNDS, results)
        out[name] = dict(rows=results, bounds=bounds, seconds=time.perf_counter() - t0)
        emit({"phase": "model_vs_card_bench", "bench": name, "card": card,
              "seconds": out[name]["seconds"], "bounds": bounds})
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _serve_example(torch, fa) -> dict:
    """Phase 19 (c): the serving example on the card against the engine."""
    import runpy

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    ex = runpy.run_path(str(Path(__file__).resolve().parent / "examples" / "pt_serve_lm.py"),
                        run_name="pt_serve_lm")
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    done = ex["main"](["--device", "cuda", "--ckpt-dir", str(Path(tempfile.gettempdir()) /
                                                              "no_checkpoint")])
    seconds = time.perf_counter() - t0
    launches = fa.launch_counts()["flash_attention"]
    cfg = get_config("gemma-2b").reduced()          # the example's default arch, seeded
    engine = ServingEngine(cfg, build_model(cfg, device="cuda"), max_batch=4,
                           cache_len=ex["CACHE_LEN"], device="cuda")
    direct = engine.serve(ex["requests"](cfg, len(done)))
    out = dict(arch=cfg.name, requests=len(done), seconds=seconds, flash_launches=launches,
               tokens=sum(len(r.output) for r in done),
               tokens_equal=[r.output for r in done] == [r.output for r in direct])
    if not (launches > 0 and out["tokens_equal"]):
        raise AssertionError(f"phase 19 (c): {out}")
    return out


def _dryrun_cli(card: str) -> dict:
    """Phase 19 (d): one LM dry-run cell through the CLI, in its own process."""
    arch, shape, mesh = DRYRUN_CELL
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    src = Path(__file__).resolve().parent / "src"
    env = {**os.environ, "PYTHONPATH": str(src)}
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--mesh", mesh, "--out", str(out_dir)],
                       env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"phase 19 (d): the dry-run CLI failed: {p.stderr[-3000:]}")
    rec = json.loads((out_dir / f"{arch}__{shape}__{mesh}.json").read_text())
    shutil.rmtree(out_dir, ignore_errors=True)
    if rec["status"] != "ok":
        raise AssertionError(f"phase 19 (d): {rec.get('status')}: {rec}")
    return dict(arch=arch, shape=shape, mesh=mesh, status=rec["status"], seconds=seconds,
                count_s=rec["count_s"], chips=rec["chips"],
                memory_per_device=rec["memory_per_device"],
                flops_per_device=rec["flops_per_device"],
                bytes_per_device=rec["bytes_per_device"], roofline=rec["roofline"],
                modelled_calls=rec["kernels"]["modelled_calls"])


def phase_model_vs_card(torch, fa, card: str) -> dict:
    """Phase 19: the dry-run's model against the card, the benches, the
    serving example and one dry-run cell through its CLI."""
    t0 = time.perf_counter()
    out = {"train": _model_vs_card(torch, fa)}
    emit({"phase": "model_vs_card_train", "card": card, **out["train"]})
    out["benches"] = _benches(torch, card)
    out["serve_example"] = _serve_example(torch, fa)
    emit({"phase": "model_vs_card_serve_example", "card": card, **out["serve_example"]})
    out["dryrun_cli"] = _dryrun_cli(card)
    emit({"phase": "model_vs_card_dryrun_cli", "card": card, **out["dryrun_cli"]})
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "model_vs_card", "card": card, "seconds": out["seconds"]})
    return out


def phase_paper(torch, ops, plar_reduce, resolve_granularity, scaled_paper_dataset,
                card: str) -> dict:
    """Phase 17: the paper's tables, the full sdss stand-in on every Θ
    backend, and the dry-run cell's shard steps."""
    from repro_torch.launch import paper_tables

    t0 = time.perf_counter()
    out = {"tables": _paper_tables(torch, paper_tables, card)}
    print(card, flush=True)
    out["sdss_table_11"] = _sdss_table_11(torch, paper_tables, card)
    out["sdss"] = _sdss_reductions(torch, ops, plar_reduce, resolve_granularity,
                                   scaled_paper_dataset, card)
    print(card, flush=True)
    out["dryrun"] = _dryrun_steps(torch, ops, card)
    out["seconds"] = time.perf_counter() - t0
    emit({"phase": "paper_done", "card": card, "seconds": out["seconds"]})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the full report here (JSON)")
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA card")
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        fail(f"the port is missing: no {src / 'repro_torch'} beside this script")
    sys.path.insert(0, str(src))
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tempfile.tempdir = scratch.name   # every phase's temporary files; removed at exit

    from repro_torch import obs
    from repro_torch.core import engine, plar_reduce, plar_reduce_ensemble, resolve_granularity
    from repro_torch.data import scaled_paper_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6 as rk
    from repro_torch.kernels.contingency import autotune, model, ops, ref
    from repro_torch.launch import reduce as reduce_cli
    from repro_torch.launch import roofline

    CARD.roofline, CARD.spec = roofline, roofline.device_spec("cuda")
    shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)   # no earlier tuning leaks in
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(AUTOTUNE_DIR / "autotune.json")

    lm = types.SimpleNamespace(  # the serving path's launch counters
        reset=lambda: (fa.reset_launch_counts(), rk.reset_launch_counts()),
        counts=lambda: {**fa.launch_counts(), **rk.launch_counts()})

    t_start = time.perf_counter()
    smi = nvidia_smi()
    card = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi, flush=True)
    emit({"phase": "device", "name": card, "count": count, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvidia_smi": smi})

    secs = build.build_all(force=True)
    emit({"phase": "build", "seconds": secs, "kernels": sorted(build.KERNELS)})

    report = {"card": smi, "kernels_vs_plain": phase_kernels(torch, ops, ref, smi)}
    report["main_path"] = phase_main_path(torch, ops, reduce_cli, smi)
    report["small_reference"] = phase_small_reference(torch, plar_reduce, scaled_paper_dataset)

    kdd99 = scaled_paper_dataset("kdd99", max_rows=5_000_000, max_attrs=64)
    x, d = kdd99.table()
    gran = resolve_granularity(x, d, device="cuda")
    sweep_pr = next(o for o in report["main_path"]["runs"]
                    if (o["backend"], o["delta"]) == ("sweep", "PR"))
    engine.release_graphs()        # phase 4's segment run captured its graph: start afresh
    obs.enable()
    report["device_engine"] = phase_device_engine(torch, obs, plar_reduce, gran, sweep_pr, smi)
    report["ensemble"] = phase_ensemble(torch, obs, plar_reduce, plar_reduce_ensemble, gran, smi)
    del gran
    engine.release_graphs()
    report["service"] = phase_service(torch, obs, ops, x, d, kdd99, smi)
    engine.release_graphs()
    report["distributed"] = phase_distributed(torch, obs, ops, x, d,
                                              report["main_path"]["runs"], smi)
    obs.disable()
    del x, d
    report["lm_kernels_vs_plain"] = phase_lm_kernels(torch, fa, rk, smi)
    report["serving"] = phase_serving(torch, lm, smi)
    report["cross_check"] = phase_cross_check(torch, smi)
    report["training"] = phase_training(torch, fa, rk, lm, smi)
    report["families"] = phase_families(torch, fa, lm, smi)
    report["families_cross"] = phase_families_cross(torch, smi)
    report["tiles"] = phase_tiles(torch, ops, ref, autotune, model, engine, plar_reduce,
                                  resolve_granularity, scaled_paper_dataset,
                                  report["main_path"]["runs"], smi)
    report["paper"] = phase_paper(torch, ops, plar_reduce, resolve_granularity,
                                  scaled_paper_dataset, smi)
    report["mesh_lm"] = phase_mesh_lm(torch, lm, smi)
    report["model_vs_card"] = phase_model_vs_card(torch, fa, smi)
    shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)

    top = N_BINS[-1]
    kernels = []
    for name in ("contingency", "fused_theta", "sweep_theta"):
        rows = [r for r in report["kernels_vs_plain"]["rows"] if r["kernel"] == name]
        pick = next(r for r in rows if r["n_bins"] == top and r["K"] == top // SHAPE["V"]
                    and r["delta"] in (None, "PR"))
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": report["main_path"]["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "ms": pick["ms"], "plain_ms": pick["plain_ms"],
            "bound_ms": pick["bound_ms"], "bound_by": pick["bound_by"],
            "library_ms": pick["library_ms"],
            "at": {"n_bins": top, "delta": pick["delta"], **SHAPE},
        }
        entry["service_launches"] = report["service"]["launches"][name]
        entry["mesh_launches"] = report["distributed"]["launches"][name]
        entry["sdss_launches"] = report["paper"]["sdss"]["launches"][name]
        tiles = report["tiles"]["kdd99"][next(k for k, v in TILE_KERNELS.items() if v == name)]
        by_tiles = {tuple(r["tiles"]): r["ms"] for r in tiles["rows"]}
        entry["tiles"] = tiles["picks"]
        entry["tiles_ms"] = {sel: by_tiles[tuple(t)] for sel, t in tiles["picks"].items()}
        entry["analytic_tiles"] = tiles["picks"]["analytic"]
        entry["analytic_ms"] = entry["tiles_ms"]["analytic"]
        entry["pinned_ms"] = entry["tiles_ms"]["pinned"]
        if name != "contingency":   # the Θ kernels: the shared segment kernels, and skewed r
            entry["headers"] = [SOURCES["segments"]]
            entry["ms_at_K"] = {str(r["K"]): r["ms"] for r in rows
                                if r["n_bins"] == top and r["delta"] == "PR"}
        kernels.append(entry)
    train_rows = {r["kernel"]: r for r in report["training"]["kernels"]}
    flash_rows = [r for r in report["lm_kernels_vs_plain"]["rows"] if r["kernel"] == "flash_attention"]
    pick = next(r for r in flash_rows
                if (r["shape"]["S"], r["shape"]["Dh"]) == FLASH_PICK and r["shape"]["causal"])
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"],
        "launches": report["serving"]["tinyllama-1.1b"]["launches"]["flash_attention_tc"],
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows),
        "ms": pick["ms"], "plain_ms": pick["plain_ms"],
        "bound_ms": pick["bound_ms"], "bound_by": pick["bound_by"],
        "library_ms": pick["library_ms"], "at": pick["shape"],
        "train_launches": report["training"]["tinyllama-1.1b"]["launches"]["flash_attention_tc"],
        "families_launches": {a: r["launches"]["flash_attention"]
                              for a, r in report["families"].items()},
        "families_rows": [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                             "bound_by", "max_abs_err")}
                          for r in flash_rows if r["shape"]["Hq"] in (16, 64)],
        "train_ms": train_rows["flash_attention"]["fwd_bwd_ms"],
        "train_plain_ms": train_rows["flash_attention"]["plain_fwd_bwd_ms"],
        "mesh_launches": report["mesh_lm"]["train"]["mesh"]["launches"]["flash_attention_tc"],
        "model_vs_card": {k: report["model_vs_card"]["train"][k]
                          for k in ("flash_twin_calls", "flash_launches")},
    })
    rwkv_rows = [r for r in report["lm_kernels_vs_plain"]["rows"] if r["kernel"] == "rwkv6"]
    rwkv_launches = report["serving"]["rwkv6-3b"]["launches"]
    paths = {}
    for key, path, b, t in (("prefill", "rwkv6_chunked", 1, 2_048), ("decode", "rwkv6_decode", 4, 1)):
        row = next(r for r in rwkv_rows if r["path"] == path and r["decays"] == "sigmoid"
                   and r["shape"]["B"] == b and r["shape"]["T"] == t)
        paths[key] = {"launches": rwkv_launches[path],
                      **{k: row[k] for k in ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                                             "max_abs_err", "shape")}}
    kernels.append({
        "name": "rwkv6", "route": "cuda", "source": SOURCES["rwkv6"],
        "replaces": REPLACES["rwkv6"], "launches": rwkv_launches["rwkv6"],
        "max_abs_err": max(r["max_abs_err"] for r in rwkv_rows),
        **{k: paths["prefill"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "at": paths["prefill"]["shape"], "paths": paths,
        "train_launches": report["training"]["rwkv6-3b"]["launches"]["rwkv6"],
        "train_ms": train_rows["rwkv6"]["fwd_bwd_ms"],
        "train_plain_ms": train_rows["rwkv6"]["plain_fwd_bwd_ms"],
        "mesh_launches": {k: report["mesh_lm"]["rwkv"]["mesh_launches"][k]
                          for k in ("rwkv6_chunked", "rwkv6_decode")},
    })
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1, default=str))
    scratch.cleanup()
    tempfile.tempdir = None
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card, "count": count}})


if __name__ == "__main__":
    main()
