"""Where a serving run's time goes on the card: a ``torch.profiler`` reading.

    python -m repro_torch.launch.profile_serve [--arch tinyllama-1.1b]

Builds the model at full width (bf16, seeded) on the card, warms it up, then
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
kernel; empty for a model without RWKV6).  Needs a CUDA card; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
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


def window(name: str, fn, top: int = 8) -> Dict:
    """Profile ``fn()`` (CPU and CUDA activities) and summarize the device."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _kernel_intervals(prof)
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
    }


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA card (torch.cuda.is_available() is False)")

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(args.arch)
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
    out[0].update(arch=cfg.name, tokens=PROMPT)
    out[1].update(arch=cfg.name, batch=BATCH, decode_steps=STEPS,
                  short_prompt=SHORT_PROMPT)
    for row in out:
        print(json.dumps(row), flush=True)
    return out


if __name__ == "__main__":
    main()
