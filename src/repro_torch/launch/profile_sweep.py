"""Where one sweep-Θ or fused-Θ call's time goes on the card: a ``torch.profiler`` reading.

    python -m repro_torch.launch.profile_sweep

At the kdd99 main-path shapes of ``chip_smoke.py`` phase 3 (G = 131,072
granules, ~24% of them padding, n_dec = 23, V = 10, nc = 41 candidates),
for each (n_bins, K) of ``CASES`` — class ids r drawn from [0, K) — and
each of ``ops.sweep_theta`` and ``ops.fused_theta`` (on the packed keys
r·V + x) it warms the kernel up, then profiles ``CALLS`` back-to-back calls of measure ``DELTA`` ending in a
synchronize, and prints one JSON line: host wall time and device busy time
per call, the idle share, and the device time per call of each kernel (the
ordering kernels, the two tile paths, the ordered sum, the scale).
Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import json
from typing import Dict, List

import torch

from repro_torch.launch.profile_serve import window

G, N_DEC, V, NC = 131_072, 23, 10, 41
CASES = ((160, 16), (10_240, 1_024), (1_310_720, 131_072), (1_310_720, 1), (1_310_720, 1_024))
CALLS, DELTA = 5, "SCE"


def operands(n_bins: int, k: int, dev: torch.device):
    """Seeded operands: x in [0, V), r in [0, K), d in [0, n_dec), integer
    weights, ~24% padding slots (w = 0)."""
    gen = torch.Generator().manual_seed(n_bins + k)
    r = torch.randint(0, k, (G,), generator=gen, dtype=torch.int32)
    x_t = torch.randint(0, V, (NC, G), generator=gen, dtype=torch.int32)
    d = torch.randint(0, N_DEC, (G,), generator=gen, dtype=torch.int32)
    w = torch.randint(1, 200, (G,), generator=gen).to(torch.float32)
    w[torch.rand((G,), generator=gen) < 0.24] = 0.0
    return [t.to(dev) for t in (x_t, r, d, w)]


def main() -> List[Dict]:
    if not torch.cuda.is_available():
        raise SystemExit("profile_sweep needs a CUDA card (torch.cuda.is_available() is False)")

    from repro_torch.kernels.contingency import ops

    dev = torch.device("cuda")
    out = []
    for (n_bins, k), kernel in ((case, kernel) for case in CASES for kernel in ("sweep", "fused")):
        x_t, r, d, w = operands(n_bins, k, dev)
        packed = r[None, :] * V + x_t
        n = float(w.sum())

        def calls():
            for _ in range(CALLS):
                if kernel == "sweep":
                    ops.sweep_theta(x_t, r, d, w, n, delta=DELTA, v_max=V, n_bins=n_bins,
                                    n_dec=N_DEC)
                else:
                    ops.fused_theta(packed, d, w, n, delta=DELTA, n_bins=n_bins, n_dec=N_DEC)

        calls()                                      # warm-up: the build, the allocator
        row = window(f"{kernel} n_bins={n_bins} K={k}", calls, top=12)
        per = {"wall_ms_per_call": row["wall_ms"] / CALLS,
               "device_busy_ms_per_call": row["device_busy_ms"] / CALLS,
               "kernels_ms_per_call": {t["name"]: t["ms"] / CALLS for t in row["top_kernels"]}}
        row.update(per, n_bins=n_bins, K=k, delta=DELTA, calls=CALLS,
                   card=torch.cuda.get_device_name(0))
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
