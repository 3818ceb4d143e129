"""Decision tables of the paper's Table-5 shapes, made on the device from a seed.

The generator of ``repro_torch.data.pipeline.TabularStream``, rewritten in
torch so that a 320,000 x 5,201 table takes a few large calls on the card
instead of tens of seconds of host numpy:

* the schema is the configuration's and the same for every seed: which
  attributes copy which, and which the decision depends on, are drawn from
  the configuration's name;
* ``n_proto = n_rows · distinct_fraction`` prototype rows of codes in
  ``[0, v_max)``;
* each attribute after the first is, with probability ``redundancy``, a
  copy of an earlier one (the copy of a copy resolves to its source);
* the decision is ``Σ_i x[:, rel_i] · v_max^i  mod n_dec`` over
  ``relevance`` attributes, and a share ``noise`` of prototypes get a
  uniformly drawn decision instead;
* rows draw prototypes by zipf-ish popularity (weight ``1/rank``), so that
  a table collapses to far fewer granules than rows, as connection logs do.

The same ``(seed, job)`` gives the same table on the same card and PyTorch
build.  The small per-column choices are drawn on the host; every array of
the table's size is drawn on the device.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple

import numpy as np
import torch

__all__ = ["Prototypes", "derive_seed", "prototypes", "draw_rows", "make_table"]


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit seed from the run's seed and a label (any whole numbers)."""
    text = ":".join(str(p) for p in (seed,) + parts)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


@dataclasses.dataclass
class Prototypes:
    """Prototype rows, their decisions and the popularity rows are drawn by."""

    x: torch.Tensor       # [n_proto, n_attrs] int32
    d: torch.Tensor       # [n_proto] int32
    cdf: torch.Tensor     # [n_proto] float64: cumulative popularity 1/rank, ending at 1
    seed: int


def prototypes(cfg: dict, seed: int, job, device) -> Prototypes:
    """The prototypes of table ``(seed, job)`` of configuration ``cfg``."""
    dev = torch.device(device)
    rows, attrs, v = int(cfg["rows"]), int(cfg["attrs"]), int(cfg["v_max"])
    m = int(cfg["n_dec"])
    base_seed = derive_seed(seed, "table", job)
    rng = np.random.default_rng(derive_seed(0, "schema", cfg["name"]))
    gen = _generator(dev, base_seed)
    n_proto = max(2, int(rows * float(cfg["distinct_fraction"])))

    src = np.arange(attrs)
    for j in range(1, attrs):
        if rng.random() < float(cfg["redundancy"]):
            src[j] = src[rng.integers(0, j)]
    base, col = np.unique(src, return_inverse=True)
    rel = rng.choice(attrs, size=min(int(cfg["relevance"]), attrs), replace=False)

    xb = torch.randint(0, v, (n_proto, len(base)), generator=gen, device=dev,
                       dtype=torch.int32)
    code = torch.zeros((n_proto,), dtype=torch.int64, device=dev)
    for a in rel:
        code = code * v + xb[:, int(col[a])]
    d = code % m
    flip = torch.rand((n_proto,), generator=gen, device=dev) < float(cfg["noise"])
    drawn = torch.randint(0, m, (n_proto,), generator=gen, device=dev)
    d = torch.where(flip, drawn, d).to(torch.int32)
    x = xb.index_select(1, torch.as_tensor(col, device=dev))
    del xb
    cdf = np.cumsum(1.0 / np.arange(1, n_proto + 1))
    cdf = torch.as_tensor(cdf / cdf[-1], device=dev)
    return Prototypes(x=x, d=d, cdf=cdf, seed=base_seed)


def draw_rows(protos: Prototypes, n: int, *label) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` rows drawn from ``protos`` by popularity; ``label`` picks the draw.

    By inverse CDF from uniform draws (``torch.multinomial`` on the card
    draws differently from one call to the next under the same generator
    state).
    """
    gen = _generator(protos.x.device, derive_seed(protos.seed, "rows", *label))
    u = torch.rand((n,), generator=gen, device=protos.x.device, dtype=torch.float64)
    idx = torch.clamp(torch.searchsorted(protos.cdf, u, right=True), max=protos.cdf.shape[0] - 1)
    return protos.x.index_select(0, idx), protos.d.index_select(0, idx)


def make_table(cfg: dict, seed: int, job, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Table ``(seed, job)``: ``cfg["rows"]`` rows, int32 codes and decisions."""
    protos = prototypes(cfg, seed, job, device)
    return draw_rows(protos, int(cfg["rows"]))
