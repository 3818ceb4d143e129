"""The ``segment`` backend's candidate Θ on the card: the fused kernel's route.

On a CUDA operand ``plan.candidate_theta(backend="segment")`` launches the
fused contingency→Θ kernel (``ops.fused_theta``) on the masked weights; on
the CPU it keeps the dense scatter-add and ``measures.evaluate``, the JAX
package's arithmetic.  Here, on the CPU:

* the route's plain version (``ops.fused_theta`` on CPU tensors, i.e.
  ``ref.fused_theta_raw_ref`` and one scale) against ``candidate_theta``
  on ``segment``: Θ_PR bit-equal, SCE/LCE/CCE within 1e-6·max(1, |Θ|)
  and within rtol 1e-5, atol 1e-6·max|Θ| (the card tests' tolerance), with
  keys outside ``[0, n_bins)``, zero weights and invalid granules;
* ``plan.BACKENDS`` records the route: ``card_kernel`` names ``fused`` for
  ``segment`` on a CUDA device only, so a CPU runner resolves no tiles and
  its dispatch spans count no Θ launches (``theta_launches`` 0);
* the table alone picks the route, and the drivers' up-front check refuses
  on the card what the fused kernel cannot take;
* importing the route (``kernels.contingency.ops``) loads neither
  ``repro_torch.launch`` nor DTensor, and the card's figures it reads
  (``repro_torch.cards``) are the ones ``launch.roofline`` re-exports.

The card itself (the launch, the bits there, the stacked body's graph pool)
is held in ``tests/test_torch_cuda.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import cards, obs
from repro_torch.core import engine, plan, plar_reduce, plar_reduce_ensemble
from repro_torch.core.plan import _masked_w, candidate_theta, card_kernel
from repro_torch.kernels.contingency import ops
from repro_torch.launch import roofline

torch.set_num_threads(1)

DELTAS = ["PR", "SCE", "LCE", "CCE"]
ROOT = Path(__file__).resolve().parents[1]


def _operands(seed, *, nc, g, n_bins, m, spread):
    """Packed keys drawn from the first ``spread`` bins, with keys past
    ``n_bins`` and below 0, zero weights and invalid granules (whose keys
    and weights are in range: only ``valid`` drops them)."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, min(spread, n_bins), (nc, g)).astype(np.int32)
    slots = rng.random((nc, g))
    packed[slots < 0.04] = -1 - rng.integers(0, 5)
    packed[(slots >= 0.04) & (slots < 0.08)] = n_bins + rng.integers(0, 300)
    d = rng.integers(0, m, g).astype(np.int32)
    w = rng.integers(1, 40, g).astype(np.int32)
    cols = rng.random(g)
    w[cols < 0.05] = 0
    valid = cols >= 0.12
    n = int(w[valid].sum())
    return (torch.from_numpy(packed), torch.from_numpy(d), torch.from_numpy(w),
            torch.from_numpy(valid), torch.tensor(n, dtype=torch.int32))


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("nc,g,n_bins,m,spread", [
    (1, 300, 256, 2, 256),          # one candidate, one tile
    (5, 2000, 1000, 7, 40),         # keys crowded into the first tile
    (9, 5000, 3000, 23, 3000),      # kdd99's decision width, n_bins off the tile
], ids=["one", "crowded", "spread"])
def test_fused_route_matches_segment_on_cpu(delta, nc, g, n_bins, m, spread):
    packed, d, w, valid, n = _operands(nc + g + n_bins, nc=nc, g=g, n_bins=n_bins, m=m,
                                       spread=spread)
    want = candidate_theta(delta, packed, d, w, valid, n, n_bins=n_bins, m=m, backend="segment")
    got = ops.fused_theta(packed, d, _masked_w(w, valid), n, delta=delta, n_bins=n_bins,
                          n_dec=m)
    assert got.shape == want.shape == (nc,) and got.dtype == want.dtype == torch.float32
    if delta == "PR":
        assert torch.equal(got, want)
    else:
        assert bool((want != 0).any())
        gap = (got.double() - want.double()).abs() / want.double().abs().clamp(min=1.0)
        assert float(gap.max()) <= 1e-6
        # and relative to the measure's own scale (CCE reads ~1e-7 here)
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("backend,device,kernel", [
    ("segment", "cuda", "fused"),
    ("segment", "cpu", None),
    ("segment", None, None),
    ("onehot", "cuda", None),
    ("sweep_xla", "cuda", None),
    ("fused", "cpu", "fused"),
    ("sweep", None, "sweep"),
    ("pallas", "cuda", "contingency"),
])
def test_card_kernel_reads_the_backend_table(backend, device, kernel):
    """Only ``segment`` has a card kernel (``BACKENDS[...].card``); the
    kernel backends launch theirs on any device."""
    assert card_kernel(backend, device) == kernel
    assert plan.BACKENDS[backend].card == ("fused" if backend == "segment" else None)


def _table(seed, n=160, a=6):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, (n, a)).astype(np.int32)
    x[:, 4] = x[:, 1]
    d = ((x[:, 0] + rng.integers(0, 2, n)) % 2).astype(np.int32)
    return x, d


@pytest.mark.parametrize("span", ["engine.dispatch", "engine.dispatch_ensemble"])
def test_cpu_runner_resolves_no_tiles_and_counts_no_launches(span):
    """A CPU runner of ``segment`` keys on no launch shape, its body runs
    the dense path, and its dispatch span says so: ``theta_launches`` 0."""
    x, d = _table(3)
    obs.enable()
    try:
        if span == "engine.dispatch":
            plar_reduce(x, d, delta="SCE", engine="device", device="cpu")
        else:
            plar_reduce_ensemble(x, d, configs=DELTAS, device="cpu")
        rec = next(r for r in reversed(obs.get_tracer().records()) if r.name == span)
    finally:
        obs.disable()
    assert rec.args["theta_launches"] == 0 and rec.args["bodies"] > 0
    assert engine.body_tiles("segment", "SCE", 6, 160, 2, 3, 64, "analytic", "cpu") == ()
    runner = engine.make_ensemble_run("incremental", "segment", DELTAS, 6, 160, 2, 3,
                                      device="cpu")
    assert runner.cfg.tiles == () and runner.loop.last_launches == 0


@pytest.mark.parametrize("card", [None, "fused"])
def test_the_table_alone_picks_the_route(monkeypatch, card):
    """``candidate_theta`` launches the fused kernel wherever ``plan.BACKENDS``
    says a candidate evaluation on the backend does (``card_kernel``), and
    nowhere else: here a ``segment`` row given the kernel for every device
    takes the route on CPU operands, and the row as it is keeps the dense
    path there."""
    if card:
        monkeypatch.setitem(plan.BACKENDS, "segment",
                            plan.BACKENDS["segment"]._replace(kernel=card))
    calls = []
    fused = ops.fused_theta
    monkeypatch.setattr(ops, "fused_theta", lambda *a, **k: calls.append(1) or fused(*a, **k))
    packed, d, w, valid, n = _operands(7, nc=3, g=400, n_bins=300, m=4, spread=300)
    candidate_theta("SCE", packed, d, w, valid, n, n_bins=300, m=4, backend="segment")
    assert len(calls) == (1 if card else 0)


@pytest.mark.parametrize("backend,mode,device,cap,m,refused", [
    ("segment", "incremental", "cuda", 2**26, 23, "keys"),       # 41·2^26 keys past an int32
    ("segment", "incremental", "cuda", 131_072, 227, "shared memory"),
    ("fused", "incremental", "cuda", 131_072, 300, "shared memory"),
    ("segment", "incremental", "cuda", 131_072, 226, None),      # the widest that fits
    ("segment", "incremental", "cpu", 2**26, 300, None),         # the dense path
    ("segment", "spark", "cuda", 2**26, 300, None),              # no candidate kernel
    ("onehot", "incremental", "cuda", 2**26, 300, None),
    ("pallas", "incremental", "cuda", 2**26, 300, None),
])
def test_card_shape_check_refuses_what_the_fused_kernel_cannot_take(
        monkeypatch, backend, mode, device, cap, m, refused):
    """The drivers' up-front check: ``segment`` (and ``fused``) on the card
    refuse a table whose candidate chunk (41 of 41 attributes here) passes
    the fused kernel's keys or a 256-bin tile's shared memory (an H100
    block's 232,448 bytes: 226 decisions fit, 227 do not); the CPU, spark
    mode and the other backends are not held to it."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"shared_memory_per_block_optin": 232_448}))
    check = lambda: plan.check_card_shape(backend, mode, device, n_attrs=41, cap=cap, m=m,  # noqa: E731
                                          mp_chunk=64)
    if refused is None:
        check()
    else:
        with pytest.raises(ValueError, match=f"fused Θ kernel.*{refused}"):
            check()


@pytest.mark.parametrize("module", ["repro_torch.kernels.contingency.ops", "repro_torch.cards"])
def test_the_route_imports_no_launch_package_or_dtensor(module):
    """The route's lazy import (and the card's figures it reads) stays clear
    of ``repro_torch.launch`` (its mesh) and of DTensor: set-up pays only
    for the kernels' wrappers."""
    code = (f"import sys, repro_torch.core, {module}\n"
            "bad = [m for m in ('repro_torch.launch', 'repro_torch.launch.mesh',\n"
            "                   'repro_torch.launch.roofline', 'torch.distributed.tensor')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr


@pytest.mark.parametrize("name", ["DeviceSpec", "H100_SXM", "H200_SXM", "device_spec"])
def test_roofline_reexports_the_card_figures(name):
    assert getattr(roofline, name) is getattr(cards, name)
    assert cards.device_spec("cpu") is cards.device_spec() is cards.H100_SXM
