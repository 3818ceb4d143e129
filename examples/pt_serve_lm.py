"""Serve a small model with batched requests (continuous batching) on the port.

    PYTHONPATH=src python examples/pt_serve_lm.py [--arch gemma-2b] [--requests 8] \
        [--max-batch 4] [--device cuda|cpu] [--ckpt-dir runs/pt_train_lm_ckpt]

The counterpart of ``examples/serve_lm.py``.  It loads the latest
checkpoint of ``examples/pt_train_lm.py`` when ``--ckpt-dir`` holds one of
this arch (its ~100M config), otherwise the arch's reduced config with
seeded weights, then drives the port's ``ServingEngine`` with a batch of
prompts of varying lengths and budgets; the prefill runs the flash kernel
on the card.  ``--device`` defaults to ``cuda``; ``--device cpu`` runs it
without a card.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine

CACHE_LEN = 96


def load_model(arch: str, ckpt_dir: str, device: str):
    """(config, model, source): the training example's latest checkpoint of
    ``arch`` when there is one, else the reduced config, seeded."""
    from repro_torch.models.convert import params_from_jax
    from repro_torch.train import CheckpointManager

    ckpt = CheckpointManager(ckpt_dir) if Path(ckpt_dir).is_dir() else None
    if ckpt is not None and ckpt.latest_step() is not None:
        from pt_train_lm import scale_to_100m

        step, tree, extra = ckpt.restore()
        cfg = scale_to_100m(get_config(arch))
        if extra.get("arch") == cfg.name:
            model = build_model(cfg, device=device)
            model.load_state_dict(params_from_jax(cfg, tree["params"]))
            return cfg, model, f"checkpoint step {step} of {ckpt_dir}"
    cfg = get_config(arch).reduced()
    return cfg, build_model(cfg, device=device), "seeded weights (seed 0)"


def requests(cfg, n: int):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=int(rng.integers(4, 24))),
                    max_new_tokens=int(rng.integers(4, 12)))
            for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="runs/pt_train_lm_ckpt")
    args = ap.parse_args(argv)

    cfg, model, source = load_model(args.arch, args.ckpt_dir, args.device)
    engine = ServingEngine(cfg, model, max_batch=args.max_batch, cache_len=CACHE_LEN,
                           device=args.device)
    reqs = requests(cfg, args.requests)
    print(f"serving {len(reqs)} requests of {cfg.name} ({source}), "
          f"max_batch={args.max_batch} (continuous batching)")
    done = engine.serve(reqs)
    for r in done:
        print(f"req {r.rid}: prompt_len={len(r.prompt)} → {len(r.output)} tokens "
              f"in {r.latency_s*1e3:.0f} ms: {r.output}")
    tput = sum(len(r.output) for r in done) / max(sum(r.latency_s for r in done), 1e-9)
    where = (torch.cuda.get_device_name(engine.device) if engine.device.type == "cuda"
             else "CPU")
    print(f"aggregate decode throughput ≈ {tput:.1f} tok/s ({where})")
    return done


if __name__ == "__main__":
    main()
