"""Where a serving run's time goes on the card: a ``torch.profiler`` reading.

    python -m repro_torch.launch.profile_serve [--arch tinyllama-1.1b]
        [--layers N] [--experts N]

Builds the model at full width (bf16, seeded) on the card, its depth and
expert count cut where ``--layers`` / ``--experts`` say (as ``chip_smoke.py``
phase 14 cuts qwen3-moe and jamba to fit the card), warms it up, then
profiles two windows, each ending in a synchronize:

* ``prefill`` — one prefill of a ``PROMPT``-token request;
* ``serve``   — ``ServingEngine.serve`` of ``BATCH`` requests of
  ``SHORT_PROMPT`` tokens and ``STEPS`` + 1 new tokens each: the short
  prefills, then ``STEPS`` decode steps at full batch.

For each window it prints one JSON line: the host wall time, the device
busy time (the union of the CUDA kernel intervals in the trace), the idle
share (1 − busy / wall), the kernel launches, the kernels that took the
most device time, and the RWKV6 kernel's device time and launches split by
path (``rwkv6_paths``: the chunked prefill kernel and the row-split decode
kernel; empty for a model without RWKV6) and, for a model with Mamba or
MoE layers, the device and host time inside them (``block_ranges``: the
profiler's ``device_ms``, and ``device_ms_in_span``, the kernels within the
range's own spans on the device timeline; the ``ssm.mamba`` range holds
the projections, the conv and the plain chunked scan, ``moe.moe`` the
routing, dispatch, expert products and combine).  The enc-dec family has no serving engine and is not
profiled here.  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

PROMPT = 1024          # tokens of the profiled prefill
SHORT_PROMPT = 64      # tokens of each served request
BATCH = 4              # served requests, all decoded together
STEPS = 16             # decode steps of the served window
CACHE_LEN = 2048
SEED = 0
RWKV6_PATHS = {"prefill": "rwkv6_chunked_kernel", "decode": "rwkv6_decode_kernel"}
RANGES = {"mamba": "ssm.mamba", "moe": "moe.moe"}   # blocks' function: profiler range


def _kernel_intervals(prof) -> List[tuple]:
    """(start_us, end_us, name) of every device kernel in a profile."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.time_range.start, e.time_range.end, e.name))
    return out


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def _range_ms(prof, name: str) -> Optional[Dict[str, float]]:
    """Device time of the kernels launched inside the profiler range
    ``name``, and the host time spent inside it."""
    for e in prof.key_averages():
        if e.key == name:
            return {"device_ms": e.device_time_total / 1e3, "host_ms": e.cpu_time_total / 1e3}
    return None


def _in_span_ms(events, name: str) -> float:
    """Device time of the kernels that lie inside the device-timeline spans
    of the range ``name`` (``key_averages()``' ``device_time_total`` of a
    ``record_function`` range can exceed the window's busy time)."""
    spans = sorted((s, e) for s, e, n in events if n == name)
    total = 0.0
    for s, e, n in events:
        if n not in RANGES.values() and any(a <= s and e <= b for a, b in spans):
            total += e - s
    return total / 1e3


@contextlib.contextmanager
def _block_ranges():
    """While open, the blocks' Mamba and MoE calls run inside the profiler
    ranges of :data:`RANGES` (no range, and no cost, outside a profile)."""
    from repro_torch.models import blocks
    saved = {fn: getattr(blocks, fn) for fn in RANGES}

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    for fn, name in RANGES.items():
        setattr(blocks, fn, ranged(name, saved[fn]))
    try:
        yield
    finally:
        for fn, inner in saved.items():
            setattr(blocks, fn, inner)


def window(name: str, fn, top: int = 8) -> Dict:
    """Profile ``fn()`` (CPU and CUDA activities) and summarize the device."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof, _block_ranges():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the ranges are user annotations on the device timeline too: not kernels
    events = _kernel_intervals(prof)
    kernels = [k for k in events if k[2] not in RANGES.values()]
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for s, e, n in kernels:
        by_name[n][0] += e - s
        by_name[n][1] += 1
    busy = _busy_us(kernels)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    paths = {}
    for path, kernel in RWKV6_PATHS.items():
        hits = [(t, c) for n, (t, c) in by_name.items() if kernel in n]
        if hits:
            paths[path] = {"ms": sum(t for t, _ in hits) / 1e3, "launches": sum(c for _, c in hits)}
    return {
        "window": name, "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / wall_us if wall_us else None,
        "kernel_launches": len(kernels),
        "top_kernels": [{"name": n[:90], "ms": t / 1e3, "count": c} for n, (t, c) in ranked],
        "rwkv6_paths": paths,
        "block_ranges": {n: {**_range_ms(prof, n), "device_ms_in_span": _in_span_ms(events, n)}
                         for n in RANGES.values() if _range_ms(prof, n)},
    }


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to N layers")
    ap.add_argument("--experts", type=int, default=0, help="cut the expert count to N")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card (torch.cuda.is_available() is False)")

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(args.arch)
    if cfg.is_encdec:
        raise SystemExit(f"{cfg.name}: the enc-dec family has no serving engine to profile")
    cut = {k: v for k, v in (("n_layers", args.layers), ("n_experts", args.experts)) if v}
    cfg = dataclasses.replace(cfg, **cut)
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    long_prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (1, PROMPT)), device="cuda")

    def serve():
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, SHORT_PROMPT),
                        max_new_tokens=STEPS + 1) for i in range(BATCH)]
        ServingEngine(cfg, model, max_batch=BATCH, cache_len=CACHE_LEN,
                      device="cuda").serve(reqs)

    def prefill():
        with torch.inference_mode():
            model.prefill(long_prompt, CACHE_LEN)

    prefill()                                        # warm-up: cuBLAS, kernel builds
    serve()
    out = [window("prefill", prefill), window("serve", serve)]
    out[0].update(arch=cfg.name, tokens=PROMPT, cut=cut)
    out[1].update(arch=cfg.name, batch=BATCH, decode_steps=STEPS,
                  short_prompt=SHORT_PROMPT)
    for row in out:
        print(json.dumps(row), flush=True)
    return out


if __name__ == "__main__":
    main()
