"""Train a ~100M-param LM for a few hundred steps on the port (the end-to-end driver).

    PYTHONPATH=src python examples/pt_train_lm.py [--steps 300] [--arch tinyllama-1.1b] [--device cuda|cpu]

The counterpart of ``examples/train_lm.py``: the port's Trainer with its
cosine schedule, grad clipping, checkpointing (atomic + retention, JAX's
layout), preemption handler, straggler monitor and deterministic
restart-safe data.  The model is a ~100M config of the chosen
architecture's family (depth/width scaled, same block structure).
``--device`` defaults to ``cuda``; ``--device cpu`` runs it without a card.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.train import TrainConfig, Trainer


def scale_to_100m(cfg):
    """Same family, ~100M params: d_model=512, 8 layers, vocab 32k."""
    changes = dict(
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 4) or 4,
        head_dim=64, d_ff=1536, vocab=32_000,
        param_dtype="float32", compute_dtype="float32",
        remat=False, fsdp=False,
    )
    if cfg.n_experts:
        changes.update(n_experts=8, top_k=2, moe_d_ff=512)
    if cfg.attn_every:
        changes.update(attn_every=4, n_layers=8)
    if cfg.family == "ssm":
        changes.update(rwkv_head_dim=64)
    return dataclasses.replace(cfg, **changes)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="runs/pt_train_lm_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = scale_to_100m(get_config(args.arch))
    print(f"arch={cfg.name} (~{cfg.param_count() / 1e6:.0f}M params analytic) on {args.device}")

    tc = TrainConfig(
        peak_lr=3e-4, warmup_steps=20, total_steps=args.steps,
        ckpt_every=50, ckpt_dir=args.ckpt_dir, log_every=10,
    )
    trainer = Trainer(cfg, tc, device=args.device)
    trainer.install_preemption_handler()

    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=0)
    state, history = trainer.fit(stream.batch, steps=args.steps)
    print("\nstep  loss    grad_norm  s/step")
    for h in history:
        print(f"{h['step']:>4}  {h['loss']:<7.4f} {h['grad_norm']:<9.3f} "
              f"{h['sec_per_step']:.2f}")
    if trainer.straggler_steps:
        print(f"straggler steps flagged: {trainer.straggler_steps}")
    if history:
        first, last = history[0]["loss"], history[-1]["loss"]
        print(f"\nloss {first:.3f} → {last:.3f} over {args.steps} steps "
              f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    print(f"checkpoints in {args.ckpt_dir}: rerun this script to resume.")
    return history


if __name__ == "__main__":
    main()
