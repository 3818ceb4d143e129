"""Where a training step's time goes on the card: a ``torch.profiler`` reading.

    python -m repro_torch.launch.profile_train [--arch tinyllama-1.1b] [--layers N]

Builds the model at full width (bf16, seeded) on the card in a
:class:`~repro_torch.train.Trainer`, takes one step to warm up, then
times one more step without the profiler, then profiles a third
(``Trainer.step_fn``, each ending in a synchronize).
Defaults are ``chip_smoke.py`` phase 13's runs: tinyllama-1.1b at full
depth, 4 x 2,048 tokens in 2 microbatches; rwkv6-3b cut to 4 layers, 2 x
1,024 tokens.  Prints one JSON line: the step's host wall time without and with the
profiler (which slows each launch on the host), the device busy time (the
union of the kernel intervals), the idle share, the kernel launches, the
kernels that took the most device time, and the kernels' plain backwards
(the ``flash_attention_diff.backward`` and ``rwkv6_diff.backward``
profiler ranges): the device time of their kernels as a share of the busy
time, and the host time inside them as a share of the profiled wall.
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import torch

from repro_torch.kernels.flash_attention.ops import BACKWARD_RANGE as FLASH_BWD
from repro_torch.kernels.rwkv6.ops import BACKWARD_RANGE as RWKV6_BWD
from .profile_serve import _busy_us, _kernel_intervals, _range_ms

RUNS = {  # arch: (layers or None for full depth, global batch, seq len, microbatches)
    "tinyllama-1.1b": (None, 4, 2_048, 2),
    "rwkv6-3b": (4, 2, 1_024, 1),
}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=sorted(RUNS))
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card (torch.cuda.is_available() is False)")

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.train import TrainConfig, Trainer

    layers, batch, seq, micro = RUNS[args.arch]
    cfg = get_config(args.arch)
    if args.layers or layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers or layers)
    trainer = Trainer(cfg, TrainConfig(microbatches=micro), device="cuda", seed=0)
    state = trainer.init_state()
    stream = TokenStream(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)
    state, _ = trainer.step_fn(state, stream.batch(0))          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = trainer.step_fn(state, stream.batch(1))
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = trainer.step_fn(state, stream.batch(2))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the ranges are user annotations on the device timeline too: not kernels
    kernels = [k for k in _kernel_intervals(prof) if k[2] not in (FLASH_BWD, RWKV6_BWD)]
    busy = _busy_us(kernels)
    by_name: Dict[str, List[float]] = {}
    for s, e, n in kernels:
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + e - s, c + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    plain_bwd = {name: _range_ms(prof, name) for name in (FLASH_BWD, RWKV6_BWD)}
    ranges = [v for v in plain_bwd.values() if v]
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "global_batch": batch, "seq_len": seq,
        "microbatches": micro, "unprofiled_wall_ms": unprofiled_ms, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3, "idle_share": 1.0 - busy / wall_us,
        "kernel_launches": len(kernels),
        "top_kernels": [{"name": n[:90], "ms": t / 1e3, "count": c} for n, (t, c) in ranked],
        "plain_backward": plain_bwd,
        "plain_backward_share_of_busy": sum(v["device_ms"] for v in ranges) * 1e3 / busy,
        "plain_backward_share_of_wall": sum(v["host_ms"] for v in ranges) * 1e3 / wall_us,
        "card": torch.cuda.get_device_name(0),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
