"""Serving launcher of the port.

    python -m repro_torch.launch.serve --arch <id> [--smoke] [--device cuda|cpu] [--seed N]

The JAX launcher's flags, plus ``--device`` (default ``cuda``; without a
card that is an error, never a silent CPU run) and ``--seed`` (the model's
parameters and the prompts).  ``--smoke`` serves the reduced config.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device,
                        generator=torch.Generator().manual_seed(args.seed))
    engine = ServingEngine(cfg, model, max_batch=args.max_batch,
                           cache_len=args.cache_len, device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 8),
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    done = engine.serve(reqs)
    for r in done:
        print(f"req {r.rid}: {r.output}  ({r.latency_s*1e3:.0f} ms)")
    return done


if __name__ == "__main__":
    main()
