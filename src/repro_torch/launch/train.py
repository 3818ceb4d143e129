"""Training launcher of the port.

    python -m repro_torch.launch.train --arch <id> [--smoke] [--steps N] [--device cuda|cpu]

The JAX launcher's flags, plus ``--device`` (default ``cuda``; without a
card that is an error, never a silent CPU run) and ``--seed`` (the model's
parameters and the token stream).  ``--smoke`` trains the reduced config.
``--mesh`` (sharded training) is not ported yet.
"""
from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--mesh", default=None,
                    help="mesh shape as 'data,model' (not ported yet)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.train import TrainConfig, Trainer

    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training is not ported yet (ROADMAP §1 item 8)")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    tc = TrainConfig(
        peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps, microbatches=args.microbatches,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
    )
    trainer = Trainer(cfg, tc, device=args.device, seed=args.seed)
    trainer.install_preemption_handler()

    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq_len,
                         global_batch=args.global_batch, seed=args.seed)
    state, history = trainer.fit(stream.batch, steps=args.steps)
    for h in history:
        print(f"step {h['step']:>5}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.3f}  {h['sec_per_step']:.2f}s/step")
    return state, history


if __name__ == "__main__":
    main()
