"""Tile selection for the Hopper contingency kernels (the port's counterpart
of ``repro.kernels.contingency.autotune``).

A kernel's tiling is its launch shape, in the fields of
:data:`.model.TILE_FIELDS`:

* ``contingency``: ``(threads, ctas)`` — threads a CTA, and the grid's cap
  in CTAs an SM (the CTAs stride over the (candidate, granule) pairs);
* ``fused``: ``(chunk, threads)`` — the fewest keys of a long segment's
  chunk (one CTA of 256 threads builds a chunk's histogram), and the threads
  a CTA of the count and scatter passes;
* ``sweep``: ``(bc, chunk, threads)`` — ``bc`` candidates read a segment
  entry at once (1, 2, 4 or 8; a long CTA holds ``bc`` histograms), then
  the fused kernel's two fields.

The JAX package's TPU tiles ``(bk, bg)`` / ``(bc, bk, bg)`` cut the bin
and granule axes of a one-hot matmul; here the bin tile is fixed at 256
(``plan.LADDER_TILE``: the plain versions, the ladder and the ordered
per-tile sum share it), and every field changes the launch shape only.
Counts are exact integers in f32 and the per-tile partials are summed in
ascending order whatever the tiling, so every tiling gives the plain
version's bits.

Three selector modes, shared by every kernel entry point
(:func:`resolve_tiles` is the one seam ``ops.py`` calls):

* ``analytic`` — **the default**: the cost model of :mod:`.model` ranks
  every feasible tiling on the card's figures (:func:`device_spec`) and
  takes the best modeled time.  A tuning persisted by
  :func:`autotune_block_sizes` for this card, kernel and shape bucket wins
  over the model.
* ``heuristic`` — a zero-cost shape rule (:func:`select_block_sizes`).
* ``pinned`` — the kernels' earlier fixed launch shapes (:data:`.model.PINNED_TILES`),
  for bisections and benchmarks.

The disk cache is the port's own: ``$REPRO_TORCH_AUTOTUNE_CACHE``, else
``$XDG_CACHE_HOME/repro-torch-plar/autotune.json`` (``~/.cache`` without
XDG), keyed ``repro_torch|<card>|<kernel>|<bucket>`` with ``<card>``
``torch.cuda.get_device_name()`` or ``cpu``.  The JAX package's file, its
variable and its ``<platform>|<kernel>|<bucket>`` keys are never read: a TPU
tiling is not a Hopper one.
"""
from __future__ import annotations

import json
import logging
import os
import statistics
import time
from collections import OrderedDict
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.plan import SELECTOR_MODES, check_selector
from repro_torch.cards import DeviceSpec, device_spec

from .model import (
    CANDIDATE_BC,
    KERNELS,
    PINNED_TILES,
    TILE,
    TILE_FIELDS,
    rank_tiles,
    select_tiles,
)

logger = logging.getLogger(__name__)

__all__ = [
    "SELECTOR_MODES",
    "DEFAULT_SELECTOR",
    "check_selector",
    "autotune_block_sizes",
    "autotune_cache_clear",
    "autotune_cache_info",
    "platform_of",
    "resolve_tiles",
    "select_block_sizes",
    "shape_bucket",
]

DEFAULT_SELECTOR = "analytic"

# In-memory tuning cache: bounded LRU (a service process sweeps many (K, G)
# regimes; the cache must not grow with them).
_CACHE_MAXSIZE = 256
_CACHE: "OrderedDict[Tuple, Tuple[int, ...]]" = OrderedDict()
_CACHE_STATS = {"hits": 0, "misses": 0}
# registry handles, looked up once: resolve_tiles runs before every launch
_DISK_HITS = obs.counter("plar_autotune_disk_hits_total",
                         "tile resolutions served from the persisted tuning")
_DISK_MISSES = obs.counter("plar_autotune_disk_misses_total",
                           "tile resolutions that fell through to the analytic model")

_DISK_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_KEY_PREFIX = "repro_torch"
_disk_state: Dict[str, object] = {"path": None, "data": None}


def platform_of(device=None) -> str:
    """The cache's platform key: the card's name, or ``"cpu"``."""
    if device is None or torch.device(device).type != "cuda":
        return "cpu"
    return device_spec(device).name


def select_block_sizes(n_bins: int, g: int, m: int, *, kernel: str = "fused", nc: int = 1,
                       spec: Optional[DeviceSpec] = None) -> Tuple[int, ...]:
    """The heuristic mode: a shape rule, no model.

    * ``contingency``: 256 threads, and a grid no larger than the pairs need
      (at most 64 CTAs an SM);
    * ``fused``: chunks of 4,096 keys, 256 threads, or 128 when the keys
      fill fewer than one CTA of 1,024 keys an SM;
    * ``sweep``: the largest ``bc`` of 1, 2, 4, 8 (at most ``nc``, rounded
      up) whose histograms leave two long CTAs resident an SM, then the
      fused rule.
    """
    spec = device_spec() if spec is None else spec
    if kernel == "contingency":
        pairs = max(nc * g, 1)
        return (256, max(1, min(64, -(-pairs // (256 * spec.sms)))))
    threads = 256 if nc * g >= 1024 * spec.sms else 128
    if kernel == "fused":
        return (4096, threads)
    if kernel != "sweep":
        raise ValueError(f"unknown kernel: {kernel!r} (one of: {', '.join(KERNELS)})")
    per_cand = (TILE * m + TILE) * 4
    room = spec.smem_per_sm // 2 - spec.smem_reserved_per_block
    bcs = [bc for bc in CANDIDATE_BC if bc // 2 < max(nc, 1) and bc * per_cand <= room]
    return (max(bcs) if bcs else 1, 4096, threads)


def resolve_tiles(
    kernel: str,
    *,
    nc: int,
    g: int,
    n_bins: int,
    m: int,
    v_max: int = 1,
    delta: str = "SCE",
    selector: Optional[str] = None,
    device=None,
) -> Tuple[int, ...]:
    """The shared tile selector: the tiling of ``kernel`` in the order of
    :data:`.model.TILE_FIELDS`.

    ``selector=None`` means the default mode (``analytic``).  ``device`` is
    the card the launch goes to (its name keys the disk cache, its figures
    feed the model); ``None`` or the CPU take the fixed H100 SXM spec under
    the key ``"cpu"``.  Resolution is host Python over ints: the wrappers
    call it before a launch, outside any CUDA graph capture, so a captured
    body holds the tiles it was given.
    """
    check_selector(selector)
    mode = DEFAULT_SELECTOR if selector is None else selector
    if kernel not in TILE_FIELDS:
        raise ValueError(f"unknown kernel: {kernel!r} (one of: {', '.join(KERNELS)})")
    if mode == "pinned":
        return PINNED_TILES[kernel]
    spec = device_spec(device)
    if mode == "heuristic":
        return select_block_sizes(n_bins, g, m, kernel=kernel, nc=nc, spec=spec)
    # analytic: a persisted tuning for this (card, kernel, shape bucket) wins
    tuned = _disk_get(_disk_key(platform_of(device), kernel, shape_bucket(nc, g, n_bins, m)),
                      kernel)
    if tuned is not None:
        _DISK_HITS.inc()
        return tuned
    _DISK_MISSES.inc()
    return select_tiles(kernel, nc, g, n_bins, m, v_max=v_max, delta=delta, spec=spec)


# ---------------------------------------------------------------------------
# persistent tuning cache: (card, kernel, shape bucket) → tiles
# ---------------------------------------------------------------------------


def shape_bucket(nc: int, g: int, n_bins: int, m: int) -> Tuple[int, int, int, int]:
    """Pow2 shape bucket: one tuning covers a ×2 band per axis."""

    def p2(v: int) -> int:
        return 1 << (max(int(v), 1) - 1).bit_length()

    return (p2(nc), p2(g), p2(n_bins), p2(m))


def _disk_path() -> Path:
    return _path_of(os.environ.get(_DISK_ENV), os.environ.get("XDG_CACHE_HOME"),
                    os.environ.get("HOME"))


@lru_cache(maxsize=16)
def _path_of(env: Optional[str], xdg: Optional[str], home: Optional[str]) -> Path:
    """The disk cache's path for these variables (memoized: every launch
    that resolves its tiles asks)."""
    if env:
        return Path(env)
    base = Path(xdg) if xdg else Path.home() / ".cache"
    return base / "repro-torch-plar" / "autotune.json"


def _disk_key(platform: str, kernel: str, bucket: Tuple[int, ...]) -> str:
    return f"{_KEY_PREFIX}|{platform}|{kernel}|" + "x".join(str(b) for b in bucket)


def _disk_data() -> Dict[str, list]:
    """The disk cache, loaded lazily and again when its path changes."""
    path = _disk_path()
    if _disk_state["path"] != path or _disk_state["data"] is None:
        data: Dict[str, list] = {}
        try:
            with open(path) as f:
                raw = json.load(f)
            if isinstance(raw, dict):
                data = {str(k): list(v) for k, v in raw.items()
                        if str(k).startswith(_KEY_PREFIX + "|") and isinstance(v, (list, tuple))}
        except (OSError, ValueError):
            data = {}
        _disk_state["path"] = path
        _disk_state["data"] = data
    return _disk_state["data"]  # type: ignore[return-value]


def _disk_get(key: str, kernel: str) -> Optional[Tuple[int, ...]]:
    val = _disk_data().get(key)
    if not val or len(val) != len(TILE_FIELDS[kernel]):
        return None
    return tuple(int(v) for v in val)


def _disk_put(key: str, tiles: Sequence[int]) -> None:
    data = _disk_data()
    data[key] = [int(t) for t in tiles]
    path = _disk_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(data, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError as e:  # read-only file system: the tuning is still served from memory
        logger.warning("autotune: could not persist tuning cache to %s: %s", path, e)


def _cache_put(key: Tuple, tiles: Tuple[int, ...]) -> None:
    _CACHE[key] = tiles
    _CACHE.move_to_end(key)
    while len(_CACHE) > _CACHE_MAXSIZE:
        _CACHE.popitem(last=False)


def autotune_cache_clear(disk: bool = False) -> None:
    """Drop all in-memory tunings (and the on-disk cache with ``disk=True``)."""
    _CACHE.clear()
    _CACHE_STATS["hits"] = 0
    _CACHE_STATS["misses"] = 0
    if disk:
        _disk_state["data"] = {}
        _disk_state["path"] = _disk_path()
        try:
            _disk_path().unlink(missing_ok=True)
        except OSError:
            pass


def autotune_cache_info() -> Dict[str, object]:
    """Cache observability: sizes, hit/miss counters, disk location."""
    return {
        "size": len(_CACHE),
        "maxsize": _CACHE_MAXSIZE,
        "hits": _CACHE_STATS["hits"],
        "misses": _CACHE_STATS["misses"],
        "disk_path": str(_disk_path()),
        "disk_entries": len(_disk_data()),
    }


# ---------------------------------------------------------------------------
# measured refinement
# ---------------------------------------------------------------------------


def _operands(nc: int, g: int, n_bins: int, m: int, v_max: int, device):
    """Seeded operands of one shape: keys, slab and class ids spread over
    the bins, weights 1, decisions uniform."""
    rng = np.random.default_rng(0)
    n_cls = max(n_bins // max(v_max, 1), 1)
    host = dict(
        packed=rng.integers(0, n_bins, (nc, g)), x_t=rng.integers(0, max(v_max, 1), (nc, g)),
        r_ids=rng.integers(0, n_cls, (g,)), d=rng.integers(0, max(m, 1), (g,)))
    out = {k: torch.as_tensor(v, dtype=torch.int32, device=device) for k, v in host.items()}
    out["w"] = torch.ones((g,), dtype=torch.float32, device=device)
    return out


def _build_candidate_fn(kernel, tiles, operands, *, n_bins, n_dec, delta, v_max):
    """Zero-argument launcher of one candidate tiling (the seam the tests
    replace)."""
    from . import ops

    o = operands
    if kernel == "contingency":
        threads, ctas = tiles
        return lambda: ops.contingency(o["packed"], o["d"], o["w"], n_bins=n_bins, n_dec=n_dec,
                                       threads=threads, ctas=ctas)
    if kernel == "fused":
        chunk, threads = tiles
        return lambda: ops.fused_theta_raw(o["packed"], o["d"], o["w"], delta=delta,
                                           n_bins=n_bins, n_dec=n_dec, chunk=chunk,
                                           threads=threads)
    bc, chunk, threads = tiles
    return lambda: ops.sweep_theta(o["x_t"], o["r_ids"], o["d"], o["w"], 1.0, delta=delta,
                                   v_max=v_max, n_bins=n_bins, n_dec=n_dec, bc=bc,
                                   chunk=chunk, threads=threads)


def _time_candidate(fn, reps: int, device) -> float:
    """Seconds of one call: the median of ``reps`` CUDA-event timings on a
    card (each after a synchronize), the best wall time of ``reps`` calls on
    the CPU (the plain version: the mechanism, not a speed)."""
    if device is not None and torch.device(device).type == "cuda":
        times = []
        for _ in range(max(reps, 1)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        return statistics.median(times)
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def autotune_block_sizes(
    nc: int,
    g: int,
    n_bins: int,
    m: int,
    *,
    delta: Optional[str] = None,
    kernel: Optional[str] = None,
    v_max: int = 1,
    reps: int = 3,
    candidates: Optional[Sequence[Sequence[int]]] = None,
    refine: bool = False,
    top_k: int = 3,
    platform: Optional[str] = None,
    device=None,
) -> Tuple[int, ...]:
    """Rank the candidate tilings with the model; optionally time the top-k.

    ``delta=None`` tunes the contingency kernel, a measure name the fused Θ
    kernel, ``kernel="sweep"`` (with ``v_max``) the sweep Θ kernel.  By
    default (``refine=False``) the pick is the model's best and nothing is
    launched.  ``refine=True`` times the ``top_k`` best-modeled tilings on
    ``device`` (CUDA events on a card; the plain version's wall time on the
    CPU, where the numbers mean nothing): a candidate whose launch is
    refused (too much shared memory, too many threads) is skipped with a
    warning, and the fastest of the rest wins.  The winner is memoized in the
    bounded LRU (keyed by the card) and persisted to the disk cache, where
    the ``analytic`` selector of any process on the same card finds it.
    """
    if kernel is None:
        kernel = "contingency" if delta is None else "fused"
    if kernel not in TILE_FIELDS:
        raise ValueError(f"unknown kernel: {kernel!r} (one of: {', '.join(KERNELS)})")
    delta_eff = delta or "SCE"
    if platform is None:
        platform = platform_of(device)
    if candidates is not None:
        candidates = tuple(tuple(int(t) for t in c) for c in candidates)
    key = (platform, kernel, nc, g, n_bins, m, delta, v_max, reps, candidates, refine, top_k)
    if key in _CACHE:
        _CACHE_STATS["hits"] += 1
        obs.counter("plar_autotune_cache_hits_total", "autotune LRU hits").inc()
        _CACHE.move_to_end(key)
        return _CACHE[key]
    _CACHE_STATS["misses"] += 1
    obs.counter("plar_autotune_cache_misses_total",
                "autotune LRU misses (re-ranked/timed)").inc()

    ranked = rank_tiles(kernel, nc, g, n_bins, m, v_max=v_max, delta=delta_eff,
                        candidates=candidates, spec=device_spec(device))
    best = ranked[0][0]
    if refine and len(ranked) > 1:
        dev = torch.device("cpu") if device is None else torch.device(device)
        operands = _operands(nc, g, n_bins, m, v_max, dev)
        best_dt, timed_best = float("inf"), None
        for tiles, _cost, _t in ranked[:top_k]:
            fn = _build_candidate_fn(kernel, tiles, operands, n_bins=n_bins, n_dec=m,
                                     delta=delta_eff, v_max=v_max)
            try:
                fn()                                     # build and warm up
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            except (RuntimeError, ValueError) as e:
                logger.warning("autotune: %s candidate %s refused on %s (skipped): %s",
                               kernel, tiles, platform, e)
                continue
            dt = _time_candidate(fn, reps, dev)
            if dt < best_dt:
                timed_best, best_dt = tiles, dt
        if timed_best is not None:
            best = timed_best

    _cache_put(key, best)
    # a rank over a caller-restricted list is not a shape tuning: it must
    # not shadow the model for the whole bucket
    if candidates is None or refine:
        _disk_put(_disk_key(platform, kernel, shape_bucket(nc, g, n_bins, m)), best)
    return best
