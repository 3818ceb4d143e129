"""Forward heuristic attribute reduction: HAR / FSPA baselines + PLAR.

The PyTorch port of ``repro.core.reduction``, single process, on the host
loop: the paper's Algorithm 1 (HAR), the FSPA accelerator of Qian et al.,
and the PLAR greedy loop (Algorithm 2), one device→host sync per greedy
iteration.

* HAR: no GrC initialization (every raw row is its own record), candidates
  one at a time, every evaluation re-keys from scratch (``mode="spark"``).
* FSPA = HAR + universe shrinking: θ of a pure class is exactly 0 for
  SCE/LCE/CCE and ``-|E|/|U|`` for PR, so dropping pure classes and carrying
  one PR correction scalar reproduces HAR's Θ values exactly.
* PLAR = GrC init + candidate chunks + the incremental packed-id evaluation
  (``mode="spark"`` gives the paper-faithful loop).

Two greedy loops, as in the JAX package: the device-resident engine
(``core/engine.py``: one captured body replayed on the card, no host read
but a ``done`` flag) and the host loop (one device→host sync per
iteration).  Both evaluate candidates with the engine's ``_eval_chunk`` and
fold with its ``_advance``.  ``engine="auto"`` takes the device engine for
:data:`DEVICE_BACKENDS` and the host loop otherwise (the CUDA kernel
backends); both record byte-identical Θ histories.
:func:`plar_reduce_ensemble` runs a grid of configs over one granularity in
one stacked engine loop.

Spans (``repro_torch.obs``, recorded when tracing is on): ``reduce.granulate``
(:func:`resolve_granularity`), ``reduce.plar`` (one :func:`plar_reduce`)
and, on its host loop, ``reduce.theta_full``, ``reduce.core``,
``reduce.greedy`` and one ``reduce.iteration`` a greedy iteration;
``reduce.ensemble`` (one :func:`plar_reduce_ensemble` past its granulation,
to the read of the grid's answers) holds one ``reduce.theta_full`` and one
``reduce.core`` a config that computes its core.  Each ends at a host read
of the device work it covers (``repro_torch.device``'s counted reads), so
its end is the device's; none adds a synchronize.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import (DeviceLike, host_float, host_int, host_reads,
                                resolve_device, to_host)

from . import measures
from .engine import (
    _LOCAL,
    ENSEMBLE_DELTAS,
    EnsembleOperands,
    _advance,
    _Cfg,
    _eval_chunk,
    _launches,
    _spark_thetas,
    make_ensemble_run,
    run_engine,
    run_ensemble,
    runner_for,
    unpack_ensemble_result,
)
from .granularity import (
    Granularity,
    build_granularity,
    build_granularity_streaming,
    chain_fallbacks,
    column_terms,
    next_pow2,
    row_fingerprints,
    with_capacity,
)
from .plan import (
    _THETA_BACKENDS as _BACKENDS,
    BACKENDS,
    DEVICE_BACKENDS,
    check_backend,
    check_card_shape,
    check_engine,
    check_mode,
    check_selector,
    check_stacked,
    contingency_from_ids,
    ids_by_sort,
    ladder_rungs,
    rung_for,
    subset_ids,
    theta_for_ids,
)

__all__ = ["ReductionResult", "plar_reduce", "plar_reduce_ensemble",
           "har_reduce", "fspa_reduce", "raw_granularity",
           "resolve_granularity", "sum_terms", "bagged_weights",
           "expand_ensemble_grid", "normalize_ensemble_configs",
           "partition_reduce_params", "DEVICE_BACKENDS",
           "ENSEMBLE_SHARED_KEYS"]

_MASK32 = 0xFFFFFFFF


def _resolve_engine(engine: str, backend: str) -> str:
    """Validate the engine knob and resolve ``auto``.

    ``auto`` takes the device-resident engine (core/engine.py) for the plain
    backends (:data:`DEVICE_BACKENDS`, JAX's rule) and the host loop for the
    CUDA kernel backends (``pallas``/``fused``/``sweep``); ``device`` runs
    either kind on the engine, a kernel backend's launch shape fixed once a
    runner.
    """
    check_engine(engine)
    if engine == "auto":
        return "device" if BACKENDS[backend].device else "host"
    return engine


@dataclasses.dataclass
class ReductionResult:
    reduct: List[int]               # selected attributes, core first then greedy order
    core: List[int]
    theta_full: float               # Θ(D|C) — the stopping target
    theta_history: List[float]      # Θ(D|R) after each greedy addition
    iterations: int
    n_evaluations: int              # candidate evaluations performed
    elapsed_s: float
    per_iteration_s: List[float]
    # set by the serving layer's graceful degradation (§3.10): True marks a
    # last-known-good result served because the fresh dispatch failed
    stale: bool = False
    # the mesh driver's: this rank's granule table (its data shard's)
    granules: Optional[Granularity] = dataclasses.field(default=None, compare=False,
                                                        repr=False)

    @property
    def n_selected(self) -> int:
        return len(self.reduct)


@contextlib.contextmanager
def _counted_span(name: str, **attrs):
    """``obs.span`` with a ``host_reads`` attribute: the device→host reads
    this thread made while the span was open, its children's included."""
    with obs.span(name, **attrs) as sp:
        r0 = host_reads()
        yield sp
        sp.set(host_reads=host_reads() - r0)


def raw_granularity(x, d, *, n_dec: int, v_max: int,
                    device: DeviceLike = "cuda") -> Granularity:
    """A decision table *without* GrC initialization: every row is a granule."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.int32).to(dev)
    n, n_attrs = x.shape
    return Granularity(
        x=x,
        d=torch.as_tensor(d, dtype=torch.int32).to(dev),
        w=torch.ones((n,), dtype=torch.int32, device=dev),
        valid=torch.ones((n,), dtype=torch.bool, device=dev),
        num=torch.tensor(n, dtype=torch.int32, device=dev),
        n_total=torch.tensor(n, dtype=torch.int32, device=dev),
        n_attrs=n_attrs,
        n_dec=n_dec,
        v_max=v_max,
    )


# ---------------------------------------------------------------------------
# inner pieces
# ---------------------------------------------------------------------------


_CODE_BOUND = 1 << 31  # the codes of a partition are held as int32


def _rank_pairs(hi: torch.Tensor, hi_bound: int, lo: torch.Tensor, lo_bound: int,
                valid: torch.Tensor) -> torch.Tensor:
    """Dense ranks of the pairs ``(hi, lo)``, ``hi`` primary, as
    :func:`ids_by_sort` gives them (invalid slots 0).

    ``hi < hi_bound`` and ``lo < lo_bound`` on valid slots.  Where every
    packed key ``hi·lo_bound + lo`` stays below the sentinel 2³² - 1 it is
    ranked as one key (one sort), else as two (two sorts).
    """
    if hi_bound * lo_bound < 1 << 32:
        return ids_by_sort([hi.to(torch.int64) * lo_bound + lo], valid)[0]
    return ids_by_sort([lo, hi], valid)[0]


def _append_column(code: torch.Tensor, bound: int, col: torch.Tensor, v: int,
                   valid: torch.Tensor, *, col_first: bool):
    """An order-preserving int32 code of the pairs ``(code, col)``, or
    ``(col, code)`` with ``col_first``, and its bound.

    Mixed radix (``code·v + col``, ``col·bound + code``) while the bound
    stays within 2³¹; past that ``code`` is ranked densely first (bound
    ``cap``), and where even that is too wide the pairs are ranked.
    """
    cap = valid.shape[0]
    if bound * v > _CODE_BOUND and bound > cap:
        code, bound = ids_by_sort([code], valid)[0], cap
    if bound * v > _CODE_BOUND:
        pair = (col, v, code, bound) if col_first else (code, bound, col, v)
        return _rank_pairs(*pair, valid), min(cap, bound * v)
    return (col * bound + code if col_first else code * v + col), bound * v


def _core_inner_thetas(gran: Granularity, delta: str, *, exact: bool) -> np.ndarray:
    """Θ(D|C\\{a}) for every a ∈ C (paper lines 3–8, the core step).

    Exact (A ≤ 128): the ids of U/(C\\{a}) are the dense ranks of the
    granules in the lexicographic order of the other columns, column 0 most
    significant, as ``subset_ids(gran, C\\{a}, exact=True)`` gives them.
    They come from two chains of single-column refinements instead of A sort
    chains over A - 1 columns: the prefix partition ``P_a`` by columns
    ``0..a-1`` (``P_{a+1}`` codes ``(P_a, x_a)``), the suffix partition
    ``S_a`` by columns ``a+1..A-1`` (``S_a`` codes ``(x_{a+1}, S_{a+1})``),
    and the ids rank ``(P_a, S_a)``.  A partition is held as an
    order-preserving code of its columns (mixed radix over codes in
    ``[0, v_max)``, :func:`_check_codes`; dense ranks where that grows too
    wide), so ranking a lexicographic order gives the same ids whichever
    way the order was coded, and the contingencies and Θ are the same bits.
    The suffixes are held as one ``[A, cap]`` int32 tensor; the prefix is
    carried.  One Θ is evaluated an attribute, all read in one host read.
    """
    A = gran.n_attrs
    n_bins = gran.capacity  # ≤ G distinct classes always
    out = np.zeros((A,), np.float64)
    if A == 0:
        return out

    if exact and A <= 128:
        cap, v, valid = gran.capacity, gran.v_max, gran.valid
        suffix = torch.zeros((A, cap), dtype=torch.int32, device=gran.device)
        s_bounds = [1] * A
        for a in range(A - 2, -1, -1):
            suffix[a], s_bounds[a] = _append_column(
                suffix[a + 1], s_bounds[a + 1], gran.x[:, a + 1], v, valid, col_first=True)
        prefix, p_bound = torch.zeros((cap,), dtype=torch.int32, device=gran.device), 1
        thetas = []
        for a in range(A):
            ids = _rank_pairs(prefix, p_bound, suffix[a], s_bounds[a], valid)
            cont = contingency_from_ids(ids, gran.d, gran.w, valid, n_bins=n_bins, m=gran.n_dec)
            thetas.append(measures.evaluate(delta, cont, gran.n_total))
            if a < A - 1:
                prefix, p_bound = _append_column(prefix, p_bound, gran.x[:, a], v, valid,
                                                 col_first=False)
        return to_host(torch.stack(thetas)).numpy().astype(np.float64)

    # Linear-sketch path: h(C\{a}) = h(C) - term_a  (mod 2³²).
    h1, h2 = row_fingerprints(gran.x, 0), row_fingerprints(gran.x, 7919)
    for a in range(A):
        t1 = column_terms(gran.x[:, a], a, A, 0)
        t2 = column_terms(gran.x[:, a], a, A, 7919)
        ids, _k = ids_by_sort([(h2 - t2) & _MASK32, (h1 - t1) & _MASK32], gran.valid)
        cont = contingency_from_ids(ids, gran.d, gran.w, gran.valid,
                                    n_bins=n_bins, m=gran.n_dec)
        out[a] = host_float(measures.evaluate(delta, cont, gran.n_total))
    return out


# ---------------------------------------------------------------------------
# ingestion
# ---------------------------------------------------------------------------


def _shrink_capacity(gran: Granularity, sp) -> Granularity:
    """Shrink the static capacity to the live granule count (next pow2);
    the count read sets the span ``sp``'s ``granules``."""
    num = host_int(gran.num)
    sp.set(granules=num)
    cap2 = next_pow2(max(num, 16))
    return with_capacity(gran, cap2) if cap2 != gran.capacity else gran


def _iter_chunks(source, chunk_rows: int):
    """Chunk iterator over the GranuleSource protocol (``n_chunks``/``chunk``)."""
    return (source.chunk(i, chunk_rows) for i in range(source.n_chunks(chunk_rows)))


def _materialize(source, chunk_rows: int):
    xs, ds = zip(*_iter_chunks(source, chunk_rows))
    return np.concatenate(xs), np.concatenate(ds)


def _check_source_args(x, d, source):
    if source is not None and (x is not None or d is not None):
        raise ValueError("pass either (x, d) arrays or source=, not both")
    if source is None and (x is None or d is None):
        raise ValueError("pass (x, d) arrays or source=")
    if (source is not None and not isinstance(source, Granularity)
            and not hasattr(source, "chunk")):
        raise TypeError(
            f"source must be a Granularity or GranuleSource, got {type(source)!r}")


def resolve_granularity(
    x=None,
    d=None,
    *,
    source=None,
    grc_init: bool = True,
    n_dec: Optional[int] = None,
    v_max: Optional[int] = None,
    exact: bool = True,
    chunk_rows: int = 65536,
    device: DeviceLike = "cuda",
) -> Granularity:
    """The one ingestion seam: everything the drivers accept → ``Granularity``
    on ``device``.

    * a prebuilt :class:`Granularity` (``source=``) — moved to ``device`` and
      used as-is (capacity re-packed when ``grc_init``);
    * a GranuleSource (``source=``, anything with a ``chunk`` method) —
      streamed chunkwise through :func:`build_granularity_streaming`
      (``grc_init=False`` materializes the chunks: HAR has no compressed
      representation);
    * raw ``(x, d)`` arrays (numpy or tensors) — ``n_dec``/``v_max`` are
      inferred from the data when not given.

    Span ``reduce.granulate`` (``rows`` handed in, ``granules``,
    ``host_reads``, ``fallbacks``: the builds made again on the column
    chain): with GrC it ends at the read of the live count.
    """
    dev = resolve_device(device)
    _check_source_args(x, d, source)
    rows = source.capacity if isinstance(source, Granularity) else (
        len(x) if source is None else None)
    with _counted_span("reduce.granulate", rows=rows) as sp:
        f0 = chain_fallbacks()
        try:
            if isinstance(source, Granularity):
                g = source.to(dev)
                return _shrink_capacity(g, sp) if grc_init else g

            if source is not None:
                n_dec = source.n_dec if n_dec is None else n_dec
                v_max = source.v_max if v_max is None else v_max
                if grc_init:
                    return _shrink_capacity(build_granularity_streaming(
                        _iter_chunks(source, chunk_rows), n_dec=n_dec, v_max=v_max,
                        exact=exact, device=dev), sp)
                x, d = _materialize(source, chunk_rows)

            x = torch.as_tensor(x, dtype=torch.int32).to(dev)
            d = torch.as_tensor(d, dtype=torch.int32).to(dev)
            if n_dec is None:
                n_dec = host_int(d.max()) + 1
            if v_max is None:
                v_max = host_int(x.max()) + 1
            if not grc_init:
                return raw_granularity(x, d, n_dec=n_dec, v_max=v_max, device=dev)
            return _shrink_capacity(
                build_granularity(x, d, n_dec=n_dec, v_max=v_max, exact=exact), sp)
        finally:
            sp.set(fallbacks=chain_fallbacks() - f0)


def _check_codes(gran: Granularity) -> None:
    """Every live granule's attribute codes lie in ``[0, v_max)``.

    A caller may pass its own ``v_max``.  One below the codes packs two
    (class, value) pairs into one key on every backend, and the sweep kernel
    on the card, which reads only the keys of a tile's own classes, would
    drop the keys past a class's range.  Checked once a run: one min/max
    over the table and one sync.
    """
    if gran.capacity == 0 or gran.n_attrs == 0:
        return
    x = torch.where(gran.valid[:, None], gran.x, 0)
    lo, hi = (host_int(v) for v in torch.aminmax(x))
    if lo < 0 or hi >= gran.v_max:
        raise ValueError(
            f"attribute codes must lie in [0, v_max={gran.v_max}); the table "
            f"holds codes in [{lo}, {hi}]")


def _validate_warm_start(warm_start, n_attrs: Optional[int]) -> List[int]:
    """Canonicalize + validate a warm-start prefix (integral, unique, in range).

    A prefix longer than ``max_features`` is deliberately not an error: like
    core attributes, the forced prefix folds unconditionally and the cap
    gates only further greedy additions.
    """
    warm: List[int] = []
    for a in warm_start:
        ai = int(a)
        if ai != a:
            raise ValueError(
                f"warm_start entries must be integral attribute "
                f"indices, got {a!r}")
        warm.append(ai)
    if len(set(warm)) != len(warm):
        raise ValueError(f"warm_start contains duplicates: {warm}")
    if n_attrs is not None:
        bad = [a for a in warm if not 0 <= a < n_attrs]
        if bad:
            raise ValueError(
                f"warm_start attributes {bad} out of range [0, {n_attrs})")
    return warm


# ---------------------------------------------------------------------------
# main driver
# ---------------------------------------------------------------------------


def plar_reduce(
    x=None,
    d=None,
    *,
    source=None,                         # Granularity | GranuleSource (alt. to x, d)
    chunk_rows: int = 65536,             # streaming-ingestion chunk size
    delta: str = "PR",
    n_dec: Optional[int] = None,
    v_max: Optional[int] = None,
    eps: float = 0.0,
    tol: float = 1e-6,
    tie_tol: float = 1e-5,
    max_features: Optional[int] = None,
    mode: str = "incremental",          # "incremental" (optimized) | "spark" (paper-faithful)
    backend: str = "segment",           # segment|onehot|pallas|fused|fused_xla|sweep|sweep_xla
    ladder: bool = False,                # K-adaptive bin ladder (DESIGN.md §5.3)
    selector: str = "analytic",          # kernel tiles and ladder rungs: heuristic|analytic|pinned
    mp_chunk: int = 64,                  # model-parallelism level (paper Table 12 knob)
    grc_init: bool = True,               # paper Fig. 9 knob
    shrink: bool = False,                # FSPA universe shrinking
    exact: bool = True,
    compute_core: bool = True,
    engine: str = "auto",                # "device" loop | "host" loop | "auto"
    warm_start: Optional[Sequence[int]] = None,  # resume greedy from this prefix
    device: DeviceLike = "cuda",
) -> ReductionResult:
    """PLAR (Algorithm 2) on one process, on ``device``.

    ``warm_start`` seeds the selection with a previously chosen prefix: the
    prefix attributes are folded as forced selections and the greedy loop
    resumes from there.  It replaces the core computation (``core`` comes
    back empty) and, on the device engine, runs as a seed + resume pair of
    calls of the same runner (one capture).  ``max_features`` caps only
    further greedy additions.

    On a CUDA ``device``, ``segment`` (the default) evaluates candidates
    with the fused Θ kernel, not the dense ``[nc, n_bins, m]`` contingency
    it keeps on the CPU, and so takes the kernel's limits: a table of more
    than 226 decision classes (a 256-bin tile's histogram past an H100
    block's shared memory) or a candidate chunk of ``min(mp_chunk, A) ·
    capacity`` ≥ 2³¹ keys is refused before the first launch
    (:func:`~.plan.check_card_shape`), where the dense path ran it; and
    Θ_PR is bit-equal to the CPU's only below 2²⁴ rows.
    """
    t0 = time.perf_counter()
    check_mode(mode)
    check_backend(backend)
    check_selector(selector, "selector")
    engine = _resolve_engine(engine, backend)
    launches0 = _launches()
    with _counted_span("reduce.plar", delta=delta, backend=backend, engine=engine) as sp:
        gran = resolve_granularity(
            x, d, source=source, grc_init=grc_init, n_dec=n_dec, v_max=v_max,
            exact=exact, chunk_rows=chunk_rows, device=device)
        A = gran.n_attrs
        check_card_shape(backend, mode, gran.device, n_attrs=A, cap=gran.capacity,
                         m=gran.n_dec, mp_chunk=mp_chunk)
        n_evals = 0

        warm: Optional[List[int]] = None
        if warm_start is not None:
            warm = _validate_warm_start(warm_start, A)

        # Θ(D|C): stopping target.
        with obs.span("reduce.theta_full"):
            _check_codes(gran)
            ids_c, _k = subset_ids(gran, list(range(A)), exact=exact)
            theta_full = host_float(theta_for_ids(delta, ids_c, gran, n_bins=gran.capacity))

        # --- core (skipped under warm_start: the prefix stands in for it) ---
        core: List[int] = []
        if compute_core and warm is None:
            with _counted_span("reduce.core", n_attrs=A) as sp_core:
                inner = _core_inner_thetas(gran, delta, exact=exact)
                sig = inner - theta_full  # Θ(D|C\{a}) - Θ(D|C)
                core = [int(a) for a in range(A) if sig[a] > eps + tie_tol]
                sp_core.set(core=len(core))
            n_evals += A
        max_sel = int(max_features) if max_features is not None else A
        cfg = _Cfg.solo(delta, mode, backend, A, gran.capacity, gran.n_dec, gran.v_max, tol,
                        tie_tol, shrink, max_sel, mp_chunk)

        if engine == "device":
            # core folds + greedy loop + stopping rule as one device-resident
            # loop (core/engine.py), one device→host transfer at the end
            reduct, theta_hist, iterations, ev, per_iter_s = run_engine(
                runner_for(cfg, selector, gran.device), gran.capacity, A, gran.valid, gran.x,
                gran.d, gran.w, gran.n_total, theta_full, core, warm_start=warm)
        else:
            forced = core if warm is None else warm
            with obs.span("reduce.greedy", forced=len(forced)):
                reduct, theta_hist, iterations, ev, per_iter_s = _host_loop(
                    cfg, gran, forced, theta_full, ladder=ladder, selector=selector)
        n_evals += ev
        sp.set(iterations=iterations, evaluations=n_evals, launches=_launches() - launches0)

    return ReductionResult(
        reduct=reduct,
        core=core,
        theta_full=theta_full,
        theta_history=theta_hist,
        iterations=iterations,
        n_evaluations=n_evals,
        elapsed_s=time.perf_counter() - t0,
        per_iteration_s=per_iter_s,
    )


def _host_loop(cfg: _Cfg, gran: Granularity, forced: List[int], theta_full: float, *,
               ladder: bool, selector: str):
    """The host greedy loop, one sync a candidate chunk: fold the forced
    prefix, then add the argmin candidate while Θ(D|R) is above the
    stopping target.  Returns ``(reduct, theta_history, iterations,
    evaluations, per_iteration_s)``, as :func:`~.engine.run_engine` does.
    One ``reduce.iteration`` span an iteration, ended by its read of
    Θ(D|R)."""
    (delta,), mode, backend, v = cfg.deltas, cfg.mode, cfg.backend, cfg.v_max
    A, cap, m, n, dev = gran.n_attrs, gran.capacity, gran.n_dec, gran.n_total, gran.device
    r_ids = torch.zeros((cap,), dtype=torch.int32, device=dev)
    k = 1
    active = gran.valid
    # float32 accumulation of the shrink correction, as the JAX package keeps it
    pr_correction = np.float32(0.0)
    reduct: List[int] = []
    theta_hist: List[float] = []
    per_iter_s: List[float] = []
    n_evals = 0

    rungs = ladder_rungs(cfg.n_bins, selector=selector, g=cap, m=m) if ladder else None

    def _eval_bins_for(k_):
        if ladder:
            return rung_for(k_, v, rungs)
        # the XLA-twin backends keep the full bound (the JAX device engine's
        # grouping); the kernel backends take the cheaper pow2 bound
        return cap * v if BACKENDS[backend].device else next_pow2(max(k_, 1)) * v

    # read-once candidate slab for the slab backends, hoisted out of the loop
    x_t_full = gran.x.t().contiguous() if BACKENDS[backend].slab else None

    # the stop threshold in f32 arithmetic, as the JAX drivers compute it
    stop_thresh = measures.f32_threshold(theta_full, cfg.tol)
    n_np = np.float32(host_int(n))

    def fold(a):
        """Add ``a`` to R, then shrink; Θ(D|R) with the correction before it.

        The advance is the device engine's, at the full bin bound cap·V
        whatever the backend: Θ(D|R) is summed over the same rows on every
        path, which keeps theta histories byte-identical across engines,
        backends and the ladder."""
        nonlocal r_ids, k, active, pr_correction
        r_ids, k_new, theta, g_pure = _advance(cfg, _LOCAL, r_ids, gran.x[:, a], gran.d, gran.w,
                                               active, n, delta)
        k = host_int(k_new)
        reduct.append(a)
        theta_hist.append(float(np.float32(host_float(theta)) + pr_correction))
        if cfg.shrink:
            if delta == "PR":
                shed = np.float32(host_int(torch.where(g_pure, gran.w, torch.zeros_like(gran.w))
                                           .sum()))
                pr_correction = pr_correction - np.float32(shed / n_np)
            active = active & ~g_pure
        return theta_hist[-1]

    for a in forced:           # the core attributes, or the warm-start prefix
        fold(a)
    theta_r = theta_hist[-1] if theta_hist else float("inf")

    remaining = [a for a in range(A) if a not in reduct]
    iterations = 0
    while remaining and theta_r > stop_thresh and len(reduct) < cfg.max_sel:
        it0 = time.perf_counter()
        nc = min(cfg.mp_chunk, max(len(remaining), 1))
        corr = torch.tensor(float(pr_correction), dtype=torch.float32, device=dev)
        with obs.span("reduce.iteration", i=iterations, candidates=len(remaining),
                      chunks=-(-len(remaining) // nc)) as sp:
            thetas = np.full((len(remaining),), np.inf, np.float64)
            if mode == "spark":
                # re-key from scratch: fingerprint of the current R columns
                hR1, hR2 = sum_terms(gran.x, reduct, 0), sum_terms(gran.x, reduct, 7919)
                for s in range(0, len(remaining), nc):
                    cols = remaining[s: s + nc]
                    vals = _spark_thetas(delta, hR1, hR2, cols, gran.x, gran.d, gran.w, active,
                                         n, n_bins=cap, m=m) + corr
                    thetas[s: s + len(cols)] = to_host(vals).numpy()
            else:
                eval_bins = _eval_bins_for(k)
                for s in range(0, len(remaining), nc):
                    cols = torch.tensor(remaining[s: s + nc], dtype=torch.int64, device=dev)
                    x_cand = (gran.x.index_select(1, cols).t() if x_t_full is None
                              else x_t_full.index_select(0, cols))           # [nc, G]
                    vals = _eval_chunk(delta, x_cand, r_ids, gran.d, gran.w, active, n,
                                       n_bins=eval_bins, m=m, v_max=v, backend=backend,
                                       selector=selector)
                    thetas[s: s + len(cols)] = to_host(vals + corr).numpy()
            n_evals += len(remaining)

            best = measures.argmin_with_ties(thetas, cfg.tie_tol)  # paper line 13: argmin Θ
            theta_r = fold(remaining.pop(best))
            sp.set(k=k)
        iterations += 1
        per_iter_s.append(time.perf_counter() - it0)
    return reduct, theta_hist, iterations, n_evals, per_iter_s




# ---------------------------------------------------------------------------
# reduct ensembles: one stacked engine loop for a whole config grid
# ---------------------------------------------------------------------------


# Per-config knobs the ensemble grid accepts; everything else (mode, backend,
# ladder, mp_chunk, ingestion) is shared — static choices of the runner.
_ENSEMBLE_DEFAULTS = {
    "delta": "PR",
    "tol": 1e-6,
    "tie_tol": 1e-5,
    "max_features": None,
    "shrink": False,
    "compute_core": True,
    "eps": 0.0,
    "seed": None,          # bagged row-weight resample seed (None = no bag)
    "warm_start": None,    # forced greedy-resume prefix (replaces the core)
}

# Driver kwargs of :func:`plar_reduce` that the stacked engine *shares*
# across a grid (static choices + ingestion) — the complement of
# ``_ENSEMBLE_DEFAULTS``: per-config knobs may differ, shared knobs must agree.
ENSEMBLE_SHARED_KEYS = ("mode", "backend", "ladder", "selector", "mp_chunk",
                        "exact", "grc_init", "chunk_rows")


def partition_reduce_params(delta: str, params: dict):
    """Split one ``plar_reduce``-style ``(delta, params)`` query into the
    ``(config, shared)`` pair the stacked engine takes, or return ``None``
    when the query cannot ride it (a host-only backend, ``engine="host"``,
    an unknown knob, a ladder off ``sweep_xla``)."""
    if delta not in ENSEMBLE_DELTAS:
        return None
    config = {"delta": delta}
    shared = {}
    for k, v in params.items():
        if k in _ENSEMBLE_DEFAULTS and k != "delta":
            config[k] = v
        elif k in ENSEMBLE_SHARED_KEYS:
            shared[k] = v
        else:
            return None
    try:
        check_stacked(shared.get("backend", "segment"), shared.get("ladder", False))
        check_mode(shared.get("mode", "incremental"))
    except ValueError:
        return None
    return config, shared


def expand_ensemble_grid(configs, seeds=None):
    """Expand ``configs`` (dicts or bare measure names) × ``seeds``.

    ``seeds`` crosses every config with one bagged replica per seed
    (``configs=["PR"], seeds=range(8)`` is an 8-bag PR ensemble); configs
    outer, seeds inner.  A config carrying its own ``seed`` cannot be
    combined with ``seeds=``.  Returns plain dicts, defaults not yet filled.
    """
    expanded = []
    for c in configs:
        if isinstance(c, str):
            c = {"delta": c}
        c = dict(c)
        if seeds is None:
            expanded.append(c)
            continue
        if c.get("seed") is not None:
            raise ValueError(
                "pass bag seeds either per config ('seed') or via seeds=, "
                "not both")
        for s in seeds:
            expanded.append({**c, "seed": int(s)})
    return expanded


def normalize_ensemble_configs(configs, seeds=None) -> List[dict]:
    """Validate + default-fill an ensemble grid (see ``_ENSEMBLE_DEFAULTS``)."""
    expanded = expand_ensemble_grid(configs, seeds)
    if not expanded:
        raise ValueError("ensemble configs must be non-empty")
    out = []
    for c in expanded:
        unknown = sorted(set(c) - set(_ENSEMBLE_DEFAULTS))
        if unknown:
            raise ValueError(
                f"unknown ensemble config keys {unknown} "
                f"(one of: {', '.join(sorted(_ENSEMBLE_DEFAULTS))})")
        full = {**_ENSEMBLE_DEFAULTS, **c}
        if full["delta"] not in ENSEMBLE_DELTAS:
            raise ValueError(
                f"unknown measure: {full['delta']!r} "
                f"(one of: {', '.join(ENSEMBLE_DELTAS)})")
        if full["warm_start"] is not None:
            # range re-checked by the driver once A is known
            full["warm_start"] = _validate_warm_start(full["warm_start"], None)
        out.append(full)
    return out


def bagged_weights(gran: Granularity, seed: int) -> np.ndarray:
    """Bootstrap resample of the row multiset as granule weights ``[cap]``.

    Draws ``n_total`` rows with replacement from the live rows — a
    multinomial over granules weighted by ``w`` — with numpy's
    ``default_rng(seed)``, so the bags are the JAX package's.  The
    granularity itself is shared by every bag; zero-weight granules stay
    live and contribute 0 to every contingency.
    """
    return _bag(to_host(gran.w).numpy(), to_host(gran.valid).numpy(), seed)


def _bag(w: np.ndarray, valid: np.ndarray, seed: int) -> np.ndarray:
    """:func:`bagged_weights` of host copies of ``gran.w`` and ``gran.valid``."""
    live = np.where(valid, w.astype(np.int64), 0)
    total = int(live.sum())
    if total <= 0:
        raise ValueError("cannot bag an empty granularity")
    rng = np.random.default_rng(int(seed))
    return rng.multinomial(total, live / live.sum()).astype(np.int32)


def plar_reduce_ensemble(
    x=None,
    d=None,
    *,
    source=None,                         # Granularity | GranuleSource (alt. to x, d)
    configs: Sequence,                   # per-config dicts (or measure names)
    seeds: Optional[Sequence[int]] = None,  # bag grid: configs × seeds
    chunk_rows: int = 65536,
    n_dec: Optional[int] = None,
    v_max: Optional[int] = None,
    mode: str = "incremental",
    backend: str = "segment",            # plan.ENSEMBLE_BACKENDS
    ladder: bool = False,                # requires a slab backend: sweep_xla
    selector: str = "analytic",
    mp_chunk: int = 64,
    grc_init: bool = True,
    exact: bool = True,
    device: DeviceLike = "cuda",
) -> List[ReductionResult]:
    """A grid of PLAR reductions over ONE granularity in ONE engine loop.

    Every config runs the greedy selection ``plar_reduce(engine="device")``
    would, byte-identical per config (reduct, core, Θ history), in one
    stacked loop (one capture per grid).  Per-config knobs: ``delta``,
    ``tol``, ``tie_tol``, ``max_features``, ``shrink``, ``compute_core``,
    ``eps``, ``seed`` (a bagged row-weight resample, :func:`bagged_weights`:
    its solo twin is ``plar_reduce`` on the same granularity with ``w``
    replaced) and ``warm_start`` (a forced prefix replacing the core).
    Shared knobs (``mode``, ``backend``, ``ladder``, ``mp_chunk``) are
    static choices of the runner.  On the card ``segment`` takes the fused
    Θ kernel's limits, as in :func:`plar_reduce`.

    Results come back in grid order (``configs`` × ``seeds``); ``elapsed_s``
    is the per-config share of the wall clock, and ``per_iteration_s``
    entries are the loop average over every executed body in the grid.
    """
    t0 = time.perf_counter()
    check_mode(mode)
    check_stacked(backend, ladder)
    check_selector(selector, "selector")
    cfgs = normalize_ensemble_configs(configs, seeds)
    gran = resolve_granularity(
        x, d, source=source, grc_init=grc_init, n_dec=n_dec, v_max=v_max,
        exact=exact, chunk_rows=chunk_rows, device=device)
    dev = gran.device

    A = gran.n_attrs
    m = gran.n_dec
    cap = gran.capacity
    check_card_shape(backend, mode, dev, n_attrs=A, cap=cap, m=m, mp_chunk=mp_chunk)
    C = len(cfgs)
    deltas = [c["delta"] for c in cfgs]

    ws = np.zeros((C, cap), np.int32)
    core_attrs = np.zeros((C, max(A, 1)), np.int32)
    core_counts = np.zeros((C,), np.int32)
    ns = np.zeros((C,), np.int64)
    cores: List[List[int]] = []
    evals0 = np.zeros((C,), np.int64)

    with _counted_span("reduce.ensemble", configs=C, deltas=",".join(deltas),
                       backend=backend) as sp:
        # Θ(D|C) of every config; its ids are w-independent, computed once for the grid
        with obs.span("reduce.theta_full"):
            _check_codes(gran)
            ids_c, _k = subset_ids(gran, list(range(A)), exact=exact)
            base_w = to_host(gran.w).numpy().astype(np.int32)
            valid = to_host(gran.valid).numpy()
            grans, thetas = [], []
            for j, c in enumerate(cfgs):
                ws[j] = base_w if c["seed"] is None else _bag(base_w, valid, c["seed"])
                ns[j] = int(np.where(valid, ws[j], 0).sum())
                w_t = torch.as_tensor(ws[j], device=dev)
                n_t = torch.tensor(ns[j], dtype=torch.int32, device=dev)
                grans.append(gran if c["seed"] is None
                             else dataclasses.replace(gran, w=w_t, n_total=n_t))
                cont_j = contingency_from_ids(ids_c, gran.d, w_t, gran.valid, n_bins=cap, m=m)
                thetas.append(measures.evaluate(c["delta"], cont_j, n_t))
            theta_fulls = to_host(torch.stack(thetas)).numpy().astype(np.float64)

        for j, c in enumerate(cfgs):
            core_j: List[int] = []
            if c["warm_start"] is not None:
                # the prefix stands in for the core, as in plar_reduce(warm_start=)
                forced_j = _validate_warm_start(c["warm_start"], A)
                core_attrs[j, : len(forced_j)] = forced_j
                core_counts[j] = len(forced_j)
            elif c["compute_core"]:
                with _counted_span("reduce.core", n_attrs=A, delta=c["delta"]) as sp_core:
                    inner = _core_inner_thetas(grans[j], c["delta"], exact=exact)
                    sig = inner - theta_fulls[j]
                    core_j = [int(a) for a in range(A) if sig[a] > c["eps"] + c["tie_tol"]]
                    sp_core.set(core=len(core_j))
                evals0[j] = A
                core_attrs[j, : len(core_j)] = core_j
                core_counts[j] = len(core_j)
            cores.append(core_j)

        ops = EnsembleOperands(
            tol=torch.tensor([c["tol"] for c in cfgs], dtype=torch.float32, device=dev),
            tie_tol=torch.tensor([c["tie_tol"] for c in cfgs], dtype=torch.float32, device=dev),
            max_sel=torch.tensor([A if c["max_features"] is None else int(c["max_features"])
                                  for c in cfgs], dtype=torch.int32, device=dev),
            shrink=torch.tensor([bool(c["shrink"]) for c in cfgs], device=dev),
            theta_full=torch.tensor(theta_fulls, dtype=torch.float32, device=dev),
            n=torch.tensor(ns, dtype=torch.int32, device=dev),
            w=torch.as_tensor(ws, device=dev),
            core_attrs=torch.as_tensor(core_attrs, device=dev),
            core_count=torch.as_tensor(core_counts, device=dev),
        )
        runner = make_ensemble_run(mode, backend, deltas, A, cap, m, gran.v_max, int(mp_chunk),
                                   bool(ladder), str(selector), device=dev)
        fin, loop_s = run_ensemble(runner, cap, A, gran.valid, gran.x, gran.d, ops)
        per_cfg = unpack_ensemble_result(fin, core_counts)
        sp.set(bodies=runner.loop.last_bodies)

    elapsed = time.perf_counter() - t0
    total_bodies = sum(len(r[0]) for r in per_cfg)
    per_body = loop_s / total_bodies if total_bodies else 0.0
    return [
        ReductionResult(
            reduct=reduct,
            core=cores[j],
            theta_full=float(theta_fulls[j]),
            theta_history=hist,
            iterations=iters,
            n_evaluations=int(evals0[j]) + ev,
            elapsed_s=elapsed / C,
            per_iteration_s=[per_body] * len(reduct),
        )
        for j, (reduct, hist, iters, ev) in enumerate(per_cfg)]


def sum_terms(x: torch.Tensor, cols: Sequence[int], seed: int) -> torch.Tensor:
    """Fingerprint restricted to a column subset (recomputed from scratch)."""
    h = torch.zeros((x.shape[0],), dtype=torch.int64, device=x.device)
    for c in cols:
        h = (h + column_terms(x[:, c], c, x.shape[1], seed)) & _MASK32
    return h


def har_reduce(x=None, d=None, **kw) -> ReductionResult:
    """Paper baseline: Algorithm 1 — no GrC, sequential, re-key per candidate."""
    kw.setdefault("mode", "spark")
    kw.setdefault("mp_chunk", 1)
    return plar_reduce(x, d, grc_init=False, shrink=False, **kw)


def fspa_reduce(x=None, d=None, **kw) -> ReductionResult:
    """Paper baseline: FSPA — HAR + exact universe shrinking (positive approximation)."""
    kw.setdefault("mode", "spark")
    kw.setdefault("mp_chunk", 1)
    return plar_reduce(x, d, grc_init=False, shrink=True, **kw)
