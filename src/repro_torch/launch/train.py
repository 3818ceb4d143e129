"""Training launcher of the port.

    python -m repro_torch.launch.train --arch <id> [--smoke] [--steps N] [--device cuda|cpu]
        [--mesh data,model]

The JAX launcher's flags, plus ``--device`` (default ``cuda``; without a
card that is an error, never a silent CPU run) and ``--seed`` (the model's
parameters and the token stream).  ``--smoke`` trains the reduced config.

``--mesh data,model`` trains sharded (``Trainer(mesh=)``) on ``data·model``
ranks: under ``torchrun`` (``WORLD_SIZE`` in the environment) this process
is one rank; otherwise the launcher spawns the ranks itself, one a card on
``cuda`` (NCCL; more ranks than cards is an error) and gloo ranks on
``--device cpu``.  Every rank trains on the same token stream; rank 0
prints.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple


def _parser() -> argparse.ArgumentParser:
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
                    help="mesh shape as 'data,model' (one rank a position)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _mesh_shape(ap, text: str) -> Tuple[int, ...]:
    try:
        shape = tuple(int(v) for v in text.split(","))
    except ValueError:
        shape = ()
    if not 1 <= len(shape) <= 2 or min(shape) < 1:
        ap.error(f"--mesh takes data[,model] sizes (e.g. 2,2), got {text!r}")
    return shape


def _train(args, mesh=None, device=None):
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    tc = TrainConfig(
        peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps, microbatches=args.microbatches,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
    )
    trainer = Trainer(cfg, tc, mesh=mesh, device=device or args.device, seed=args.seed)
    trainer.install_preemption_handler()

    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq_len,
                         global_batch=args.global_batch, seed=args.seed)
    state, history = trainer.fit(stream.batch, steps=args.steps)
    if mesh is None or mesh.rank == 0:
        where = "" if mesh is None else f"  mesh {dict(mesh.shape)}"
        for h in history:
            print(f"step {h['step']:>5}  loss {h['loss']:.4f}  "
                  f"gnorm {h['grad_norm']:.3f}  {h['sec_per_step']:.2f}s/step{where}",
                  flush=True)
    return state, history


def _rank(device, argv: List[str]) -> None:
    """One rank of ``--mesh``: its mesh, then the loop."""
    from repro_torch.distributed.api import make_mesh

    ap = _parser()
    args = ap.parse_args(argv)
    shape = _mesh_shape(ap, args.mesh)
    _train(args, make_mesh(shape, ("data", "model")[:len(shape)], device=device), device)


def main(argv: Optional[List[str]] = None):
    ap = _parser()
    args = ap.parse_args(argv)
    if not args.mesh:
        return _train(args)
    shape = _mesh_shape(ap, args.mesh)
    argv = list(argv) if argv is not None else __import__("sys").argv[1:]
    if "WORLD_SIZE" in os.environ:          # under torchrun: this process is one rank
        import torch.distributed as dist

        from repro_torch.distributed.api import init_process_group

        dev = init_process_group(args.device)
        try:
            return _rank(dev, argv)
        finally:
            dist.destroy_process_group()
    import math

    import torch

    from repro_torch.distributed.api import spawn

    world = math.prod(shape)
    if args.device == "cuda":
        n_gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > n_gpus:
            ap.error(f"--mesh {args.mesh} needs {world} ranks, one GPU each (NCCL puts "
                     f"one rank on one card); {n_gpus} GPU(s) visible")
    spawn(_rank, world, (argv,), device=args.device, timeout_s=3600.0)
    return None


if __name__ == "__main__":
    main()
