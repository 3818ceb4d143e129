"""End-to-end driver of the PyTorch port: PLAR feature selection feeding model training.

    PYTHONPATH=src python examples/pt_feature_selected_training.py [--device cuda|cpu]

The counterpart of ``examples/feature_selected_training.py``.  The paper
positions attribute reduction as the preprocessing step of a learning
pipeline; this runs that loop on the port:

  1. generate a high-dimensional tabular stream (gisette-shaped);
  2. run PLAR (SCE) to find the reduct, on ``--device`` and, as a check, on
     the CPU (the same reduct);
  3. train a small tabular transformer on (a) all attributes and (b) the
     reduct only — same budget — through the port's train step (attention
     through the flash kernel's differentiable wrapper on the card);
  4. check that both trainings ran (finite losses that fell) and that the
     reduct model matches or beats the full-attribute model's held-out
     accuracy — the paper's "reduce uncertainty & complexity without losing
     discernibility" claim, measured end to end.

``--device`` defaults to ``cuda``; ``--device cpu`` runs it without a card.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import argparse

import numpy as np
import torch

from repro_torch.core import plar_reduce
from repro_torch.data import FeatureSelectedStream, TabularStream
from repro_torch.models import build_model
from repro_torch.models.config import ArchConfig
from repro_torch.train import AdamW, constant_schedule, make_train_step


def tabular_lm(n_attrs: int, v_max: int, n_classes: int) -> ArchConfig:
    """Tiny decoder treating each attribute as one token position."""
    return ArchConfig(
        name=f"tab-{n_attrs}", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab=max(v_max, n_classes) + 1, param_dtype="float32",
        compute_dtype="float32", remat=False, fsdp=False,
    )


def train_tabular(x: np.ndarray, d: np.ndarray, device, steps: int = 60, batch: int = 64):
    """(held-out accuracy of the class token, first and last train loss)."""
    n, a = x.shape
    cfg = tabular_lm(a, int(x.max()), int(d.max()) + 1)
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    opt = AdamW(lr=constant_schedule(3e-3), weight_decay=0.0)
    params = dict(model.named_parameters())
    st = opt.init(params)
    state = {"params": params, "opt_m": st.m, "opt_v": st.v, "opt_step": st.step}
    step_fn = make_train_step(model, opt)

    rng = np.random.default_rng(0)
    split = int(0.9 * n)
    losses = []
    for _ in range(steps):
        idx = rng.integers(0, split, batch)
        toks = x[idx]
        # predict the class token at the last position
        labels = np.concatenate([toks[:, 1:], d[idx][:, None]], axis=1)
        state, metrics = step_fn(state, {"tokens": toks.astype(np.int64),
                                         "labels": labels.astype(np.int64)})
        losses.append(float(metrics["loss"]))
    with torch.inference_mode():
        logits = model(torch.as_tensor(x[split:], dtype=torch.int64, device=model.device))
    pred = logits[:, -1].argmax(-1).cpu().numpy()
    return float((pred == d[split:]).mean()), losses[0], losses[-1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)

    stream = TabularStream(n_rows=3000, n_attrs=48, v_max=4, n_dec=2,
                           redundancy=0.5, relevance=3, noise=0.02, seed=7)
    x, d = stream.table()
    print(f"table: {x.shape}, classes={int(d.max()) + 1}")

    r = plar_reduce(x, d, delta="SCE", max_features=12, device=args.device)
    print(f"PLAR reduct: {r.reduct} ({len(r.reduct)}/{x.shape[1]} attributes)")
    if args.device != "cpu":
        on_cpu = plar_reduce(x, d, delta="SCE", max_features=12, device="cpu")
        if (on_cpu.reduct, on_cpu.core) != (r.reduct, r.core):
            raise AssertionError(f"reduct on {args.device} {r.reduct} != on the CPU {on_cpu.reduct}")

    xr, dr = FeatureSelectedStream(stream, r.reduct).table()
    runs = {}
    for name, (xs, ds) in (("full", (x, d)), ("reduct", (xr, dr))):
        acc, first, last = train_tabular(xs, ds, args.device, steps=args.steps)
        if not (np.isfinite(first) and np.isfinite(last) and last < first):
            raise AssertionError(f"{name}: train loss {first} -> {last} did not fall")
        runs[name] = {"width": xs.shape[1], "accuracy": acc, "first_loss": first,
                      "last_loss": last}
    print(f"full attributes : acc={runs['full']['accuracy']:.3f} "
          f"(train loss {runs['full']['last_loss']:.3f}) width={x.shape[1]}")
    print(f"PLAR reduct     : acc={runs['reduct']['accuracy']:.3f} "
          f"(train loss {runs['reduct']['last_loss']:.3f}) width={xr.shape[1]}")
    print("→ reduct keeps the signal at "
          f"{xr.shape[1] / x.shape[1]:.0%} of the input width")
    if runs["reduct"]["accuracy"] < runs["full"]["accuracy"]:
        raise AssertionError(f"the reduct lost accuracy: {runs}")
    return {"reduct": r.reduct, "core": r.core, "runs": runs}


if __name__ == "__main__":
    main()
