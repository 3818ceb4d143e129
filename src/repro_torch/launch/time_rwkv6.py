"""Time the RWKV6 wrapper on the card at rwkv6-3b shapes (H 40, D 64, f32).

For each case (decode: B ∈ {1, 4}, T = 1; prefill: B = 1, T ∈ {1,000,
2,048}) it checks the kernel against the plain version (rtol = atol = 1e-4)
and prints one JSON line: ``ms``, the CUDA-event time of a call through the
wrapper (host work included), and ``graph_ms``, the device time of a call
replayed in a CUDA graph (no host work between the launches), measured as
``chip_smoke.py`` measures them.  Every time is the median of
:data:`READINGS` readings.

It imports only ``repro_torch.kernels.rwkv6`` (``rwkv6``, ``rwkv6_ref``), so
it also times another checkout's kernels: put that checkout's ``src`` on
the path and run this file, e.g. to compare a parent tree with this one on
one card::

    PYTHONPATH=src python -m repro_torch.launch.time_rwkv6
    PYTHONPATH=<parent>/src python src/repro_torch/launch/time_rwkv6.py

Each line names the package it timed (``tree``) and the card
(``nvidia-smi`` name and power limit).  Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

import repro_torch
from repro_torch.kernels.rwkv6 import rwkv6, rwkv6_ref

CASES = ((1, 1), (4, 1), (1, 1_000), (1, 2_048))  # (B, T)
H, D, REPS = 40, 64, 20
READINGS = 5  # a time is the median of these


def _card() -> str:
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return p.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Mean CUDA-event time of ``fn`` over REPS calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def graph_ms(fn) -> float:
    """Device time of ``fn`` a call: REPS calls captured in one CUDA graph,
    replayed once between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                     # warm-up on the capture's side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> List[Dict]:
    if not torch.cuda.is_available():
        raise SystemExit("time_rwkv6: needs a CUDA card")
    card, tree = _card(), str(Path(repro_torch.__file__).resolve().parent)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, t in CASES:
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
        r, k, v = (rnd(b, H, t, D) * 0.5 for _ in range(3))
        w = torch.sigmoid(rnd(b, H, t, D))
        u, s0 = rnd(H, D) * 0.5, rnd(b, H, D, D) * 0.1
        call = lambda: rwkv6(r, k, v, w, u, s0)  # noqa: E731
        o, s = call()
        o_ref, s_ref = rwkv6_ref(r, k, v, w, u, s0)
        torch.testing.assert_close(o, o_ref, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-4)
        row = dict(kernel="rwkv6", B=b, H=H, T=t, D=D, tree=tree, card=card,
                   ms=statistics.median(time_ms(call) for _ in range(READINGS)),
                   graph_ms=statistics.median(graph_ms(call) for _ in range(READINGS)))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
