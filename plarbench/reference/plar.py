"""PLAR's answers worked out plainly, in PyTorch, on any device.

The semantics are those the port documents (``repro_torch.core``), written
again from the paper's definitions without any of its code:

* **Granules** (GrC initialisation): the distinct ``(row, decision)`` pairs
  with their multiplicities.  Rows are grouped by two random linear hashes
  ``Σ_j x_j·r_j`` (exact int64 sums) and every row is then compared with its
  group's first row, so the grouping is exact or the call raises.
* **Θ(D|B)** for the four measures, with ``c`` a class-decision count, ``e``
  a class size and ``N = |U|``:
  PR ``-Σ_{pure classes} e / N``; SCE ``-Σ c·log(c/e) / N``;
  LCE ``Σ c·(e - c) / N²``; CCE ``Σ_class [e²(e-1) - Σ_j c²(c-1)] / max(N²(N-1), 1)``.
* **Core**: ``a`` with ``Θ(D|C\\{a}) - Θ(D|C) > eps + tie_tol``.
* **Greedy**: from the core, while candidates remain and ``Θ(D|R)`` is above
  ``f32(f32(Θ(D|C)) + f32(tol))``, add the lowest-numbered candidate whose
  ``Θ(D|R∪{a})`` is within ``f32(f32(min) + f32(tie_tol))``; the history is
  ``Θ(D|R)`` after each addition.
* **Warm repair** (the reduct service): fold the previous reduct, keep its
  longest prefix whose every attribute still lowers Θ by more than
  ``tie_tol`` (cut where Θ first reaches the stopping target), and continue
  greedily from the kept prefix.

The program computes Θ in float32, so where the exact value a rule tests
lies within float32's reach of the rule's edge, either decision is sound.
Given the program's answer (``follow``) and the reach of its Θ, the
reference takes the program's decision there and decides every other one
itself; what no Θ within the reach explains is counted (``Answer.off``).
The reach is ``margin`` where every partial sum is an exact float32 integer
(PR while |U| < 2^24: only the last division rounds) and ``wide_margin``
times ``max(1, |Θ|)`` otherwise (every partial sum of thousands rounds at
2^-24).  Each cell states its own two margins, from the program's readings
at the cell's size.  ``Reducer.followed`` keeps, for each of the two, the
largest share of a Θ's reach that a followed decision needed (its distance
from the edge over the Θ values the rule compares, over ``max(1, |Θ|)``
where wide): the reading a cell's margins are set from.

Counts are summed exactly in float64; ``dtype`` is the precision the measure
is computed in (float64 for the reference, bfloat16 for the control).
Candidates are evaluated in chunks, each one pass of scatters over
``chunk x G`` entries.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Granules", "granulate", "union_granules", "Reducer", "Answer",
           "f32_threshold", "valid_prefix_len", "reach", "MEASURES"]

MEASURES = ("PR", "SCE", "LCE", "CCE")
_HASH_SEED = 20_160_817            # the reference's own multipliers
_BLOCK_CELLS = 1 << 25             # int64 cells one hashing temporary may hold


def f32_threshold(base: float, tol: float) -> float:
    """``base + tol`` as float32 arithmetic rounds it."""
    return float(np.float32(np.float32(base) + np.float32(tol)))


def reach(theta_reach: dict) -> dict:
    """The :class:`Reducer` margins a cell states (``theta_reach`` in its
    ``workloads/<cell>.json``)."""
    return {"margin": float(theta_reach["exact"]), "wide_margin": float(theta_reach["rounded"])}


def valid_prefix_len(history: Sequence[float], theta_full: float, *,
                     tol: float, tie_tol: float) -> int:
    """The longest prefix whose every attribute lowers Θ by more than
    ``tie_tol``, cut right after Θ first reaches the stopping target."""
    stop = f32_threshold(theta_full, tol)
    prev, k = math.inf, 0
    for t in history:
        if prev - t <= tie_tol:
            break
        k, prev = k + 1, t
        if t <= stop:
            break
    return k


# ---------------------------------------------------------------------------
# grouping rows exactly
# ---------------------------------------------------------------------------


def _multipliers(n: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(_HASH_SEED + n)
    return torch.randint(1, 1 << 31, (2, n), generator=gen, dtype=torch.int64).to(device)


def _hashes(x: torch.Tensor, d: Optional[torch.Tensor]) -> torch.Tensor:
    """[2, N] int64: ``Σ_j x_j·r_j`` (+ ``(d+1)·r_d``), summed over column blocks."""
    n, a = x.shape
    r = _multipliers(a + 1, x.device)
    h = torch.zeros((2, n), dtype=torch.int64, device=x.device)
    step = max(1, _BLOCK_CELLS // max(n, 1))
    for lo in range(0, a, step):
        hi = min(lo + step, a)
        xb = x[:, lo:hi].to(torch.int64)
        for i in range(2):
            h[i] += (xb * r[i, lo:hi]).sum(dim=1)
    if d is not None:
        h += (d.to(torch.int64) + 1)[None, :] * r[:, a:a + 1]
    return h


def _group(keys: Sequence[torch.Tensor]):
    """Dense ids of equal key tuples; ``(ids, count, first row of each group)``."""
    n = keys[0].shape[0]
    order = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    start = torch.ones((n,), dtype=torch.bool, device=order.device)
    for k in keys:
        ks = k[order]
        start[1:] &= ks[1:] == ks[:-1]
    start = ~start
    start[0] = True
    gid = torch.cumsum(start.to(torch.int64), 0) - 1
    ids = torch.empty_like(gid)
    ids[order] = gid
    return ids, int(gid[-1]) + 1 if n else 0, order[start]


def _check_groups(x: torch.Tensor, ids: torch.Tensor, first: torch.Tensor,
                  skip_col: Optional[int] = None) -> None:
    """Every row equals its group's first row (outside ``skip_col``)."""
    n, a = x.shape
    step = max(1, _BLOCK_CELLS // max(a, 1))
    for lo in range(0, n, step):
        rows = x[lo:lo + step]
        reps = x.index_select(0, first[ids[lo:lo + step]])
        neq = rows != reps
        if skip_col is not None:
            neq[:, skip_col] = False
        if bool(neq.any()):
            raise RuntimeError("reference: a hash collision grouped two different rows")


def _classes(x: torch.Tensor, drop: Optional[int] = None,
             h: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, int]:
    """Class ids of the partition of the rows of ``x`` by all its columns
    (``drop``: all but that one)."""
    if h is None:
        h = _hashes(x, None)
    if drop is not None:
        r = _multipliers(x.shape[1] + 1, x.device)
        h = h - x[:, drop].to(torch.int64)[None, :] * r[:, drop:drop + 1]
    ids, k, first = _group([h[0], h[1]])
    _check_groups(x, ids, first, skip_col=drop)
    return ids, k


@dataclasses.dataclass
class Granules:
    """Distinct ``(row, decision)`` pairs and their multiplicities."""

    x: torch.Tensor   # [G, A] int32
    d: torch.Tensor   # [G] int64
    w: torch.Tensor   # [G] float64 (whole numbers)

    @property
    def n(self) -> int:
        return self.x.shape[0]


def granulate(x: torch.Tensor, d: torch.Tensor) -> Granules:
    """GrC initialisation of raw rows, exactly."""
    h = _hashes(x, d)
    ids, k, first = _group([h[0], h[1]])
    _check_groups(x, ids, first)
    if bool((d != d.index_select(0, first[ids])).any()):
        raise RuntimeError("reference: a hash collision grouped two decisions")
    w = torch.zeros((k,), dtype=torch.float64, device=x.device)
    w.index_add_(0, ids, torch.ones_like(ids, dtype=torch.float64))
    return Granules(x=x.index_select(0, first).to(torch.int32),
                    d=d.index_select(0, first).to(torch.int64), w=w)


def union_granules(parts: Sequence[Granules]) -> Tuple[Granules, torch.Tensor]:
    """The granules of all ``parts`` once each, and ``[len(parts), G]``
    weights: row ``i`` is part ``i``'s multiplicity of each granule."""
    x = torch.cat([p.x for p in parts])
    d = torch.cat([p.d for p in parts])
    h = _hashes(x, d)
    ids, k, first = _group([h[0], h[1]])
    _check_groups(x, ids, first)
    weights = torch.zeros((len(parts), k), dtype=torch.float64, device=x.device)
    lo = 0
    for i, p in enumerate(parts):
        weights[i].index_add_(0, ids[lo:lo + p.n], p.w)
        lo += p.n
    g = Granules(x=x.index_select(0, first), d=d.index_select(0, first),
                 w=weights.sum(0))
    return g, weights


# ---------------------------------------------------------------------------
# the measures
# ---------------------------------------------------------------------------


def _theta(delta: str, c: torch.Tensor, cell_cls: torch.Tensor, e: torch.Tensor,
           n: float, dtype) -> torch.Tensor:
    """Θ per row of ``c`` ([nc, L] cell counts), ``cell_cls`` the class of
    each cell (an index into ``e``'s [nc, K] class sizes)."""
    c, e = c.to(dtype), e.to(dtype)
    n_t = torch.tensor(n, dtype=torch.float64).to(dtype)
    idx = cell_cls.expand(c.shape[0], -1)
    if delta == "PR":
        top = torch.zeros_like(e).scatter_reduce_(1, idx, c, reduce="amax")
        pos = torch.where((top == e) & (e > 0), e, torch.zeros_like(e)).sum(1)
        return (-pos / n_t).to(torch.float64)
    if delta == "SCE":
        ec = e.gather(1, idx)
        safe = torch.where(c > 0, c, torch.ones_like(c))
        terms = torch.where(c > 0, c * torch.log(safe / torch.where(c > 0, ec, safe)),
                            torch.zeros_like(c))
        return (-terms.sum(1) / n_t).to(torch.float64)
    if delta == "LCE":
        raw = (e * e).sum(1) - (c * c).sum(1)
        return (raw / (n_t * n_t)).to(torch.float64)
    if delta == "CCE":
        one = torch.ones((), dtype=dtype, device=c.device)
        raw = ((e * e * torch.clamp(e - one, min=0)).sum(1)
               - (c * c * torch.clamp(c - one, min=0)).sum(1))
        return (raw / torch.clamp(n_t * n_t * (n_t - 1), min=1)).to(torch.float64)
    raise ValueError(f"unknown measure: {delta!r} (one of: {', '.join(MEASURES)})")


def _dense(ids: torch.Tensor) -> Tuple[torch.Tensor, int]:
    uniq, inv = torch.unique(ids, return_inverse=True)
    return inv, int(uniq.shape[0])


@dataclasses.dataclass
class Answer:
    """One reduction's answer."""

    reduct: List[int]
    core: List[int]
    theta_full: float
    theta_history: List[float]
    off: int = 0          # decisions of a followed answer that no Θ within reach explains


class Reducer:
    """PLAR on one granule table whose weights may change (the service)."""

    def __init__(self, g: Granules, *, n_dec: int, v_max: int, delta: str,
                 tol: float = 1e-6, tie_tol: float = 1e-5, eps: float = 0.0,
                 margin: float = 0.0, wide_margin: Optional[float] = None,
                 chunk: int = 64, dtype=torch.float64):
        if delta not in MEASURES:
            raise ValueError(f"unknown measure: {delta!r}")
        self.g, self.m, self.v, self.delta = g, int(n_dec), int(v_max), delta
        self.tol, self.tie_tol, self.eps = float(tol), float(tie_tol), float(eps)
        self._margins = (float(margin), float(margin if wide_margin is None else wide_margin))
        self.chunk, self.dtype = int(chunk), dtype
        self.w = g.w
        self._h = _hashes(g.x, None)
        self._c_ids = _classes(g.x, h=self._h)
        self._prefix: dict = {(): (torch.zeros_like(g.d), 1)}
        self.followed = {"exact": 0.0, "rounded": 0.0}

    def set_weights(self, w: torch.Tensor) -> None:
        self.w = w

    @property
    def n(self) -> float:
        return float(self.w.sum())

    def _regime(self, *values: float) -> Tuple[str, float]:
        if self.delta == "PR" and self.n < 2**24:
            return "exact", 1.0
        return "rounded", max([1.0] + [abs(v) for v in values if math.isfinite(v)])

    def reach(self, *values: float) -> float:
        """How far the program's float32 Θ may sit from the exact value
        near ``values``: ``margin`` while every partial sum is an exact
        float32 integer (PR, |U| < 2^24), else ``wide_margin·max(1, |Θ|)``."""
        regime, scale = self._regime(*values)
        return self._margins[regime == "rounded"] * scale

    def _within(self, dist: float, n_values: int, *values: float) -> bool:
        """Whether a decision ``dist`` from its rule's edge, on ``n_values``
        Θ values near ``values``, is within their reach; a followed one is
        kept in :attr:`followed`."""
        regime, scale = self._regime(*values)
        need = max(dist, 0.0) / n_values / scale
        if need > self._margins[regime == "rounded"]:
            return False
        self.followed[regime] = max(self.followed[regime], need)
        return True

    def theta_of(self, ids: torch.Tensor, k: int) -> float:
        """Θ(D|B) of the partition ``ids`` (``k`` classes)."""
        cells = torch.zeros((k * self.m,), dtype=torch.float64, device=ids.device)
        cells.index_add_(0, ids * self.m + self.g.d, self.w)
        e = cells.view(k, self.m).sum(1)
        cls = torch.arange(k * self.m, device=ids.device) // self.m
        return float(_theta(self.delta, cells[None], cls, e[None], self.n, self.dtype)[0])

    def theta_full(self) -> float:
        return self.theta_of(*self._c_ids)

    def core(self, theta_full: float, follow: Optional[set] = None) -> Tuple[List[int], int]:
        """The core, and how many of ``follow``'s decisions no Θ within
        reach explains."""
        out, off = [], 0
        edge = self.eps + self.tie_tol
        for a in range(self.g.x.shape[1]):
            inner = self.theta_of(*_classes(self.g.x, drop=a, h=self._h))
            sig = inner - theta_full
            taken = sig > edge
            if follow is not None and (a in follow) != taken:
                if self._within(abs(sig - edge), 2, inner, theta_full):
                    taken = a in follow
                else:
                    off += 1
            if taken:
                out.append(a)
        return out, off

    def classes(self, prefix: Sequence[int]) -> Tuple[torch.Tensor, int]:
        """Class ids of the partition by ``prefix`` (cached per prefix)."""
        key = tuple(prefix)
        if key not in self._prefix:
            r, _k = self.classes(key[:-1])
            self._prefix[key] = _dense(r * self.v + self.g.x[:, key[-1]].to(torch.int64))
        return self._prefix[key]

    def candidates(self, prefix: Sequence[int], cols: Sequence[int]) -> np.ndarray:
        """Θ(D|R∪{a}) for each ``a`` of ``cols``, ``R = prefix``."""
        r, k = self.classes(prefix)
        g, m, v = self.g, self.m, self.v
        q, nq = _dense(r * m + g.d)                       # (class, decision) pairs
        r_of_q = torch.zeros((nq,), dtype=torch.int64, device=r.device)
        r_of_q[q] = r
        cell_cls = (r_of_q[:, None] * v + torch.arange(v, device=r.device)).reshape(1, -1)
        out = np.empty((len(cols),), np.float64)
        for lo in range(0, len(cols), self.chunk):
            sel = torch.as_tensor(list(cols[lo:lo + self.chunk]), device=r.device)
            nc = sel.shape[0]
            xc = g.x.index_select(1, sel).t().to(torch.int64)        # [nc, G]
            off = torch.arange(nc, device=r.device)[:, None]
            cells = torch.zeros((nc * nq * v,), dtype=torch.float64, device=r.device)
            cells.index_add_(0, (off * (nq * v) + q * v + xc).reshape(-1),
                             self.w.expand(nc, -1).reshape(-1))
            cells = cells.view(nc, nq * v)
            e = torch.zeros((nc, k * v), dtype=torch.float64, device=r.device)
            e.scatter_add_(1, cell_cls.expand(nc, -1), cells)
            out[lo:lo + nc] = _theta(self.delta, cells, cell_cls, e, self.n,
                                     self.dtype).cpu().numpy()
        return out

    def _pick(self, thetas: np.ndarray, cols: Sequence[int], follow: Optional[int]):
        """The candidate the tie rule takes, or ``follow`` where Θ values within
        reach would take it; and 1 where ``follow`` was refused."""
        band = f32_threshold(thetas.min(), self.tie_tol)
        exact = int(np.nonzero(thetas <= band)[0][0])
        if follow is None or follow == cols[exact]:
            return exact, 0
        if follow not in cols:
            return exact, 1
        i = list(cols).index(follow)
        dist = max([float(thetas[i]) - band] + [band - float(t) for t in thetas[:i]])
        return (i, 0) if self._within(dist, 2, float(thetas.min())) else (exact, 1)

    def reduce(self, *, compute_core: bool = True,
               warm_start: Optional[Sequence[int]] = None,
               follow: Optional[dict] = None) -> Answer:
        """One reduction: core (unless warm-started), then the greedy loop.

        ``follow`` is the program's answer (``reduct``, ``core``).  Where the
        exact value a rule tests lies within reach of the rule's edge
        (the tie band, the stopping target, the core's threshold), the
        program's float32 decision stands; ``Answer.off`` counts its decisions
        that no Θ within reach explains.
        """
        theta_full = self.theta_full()
        core, off = [], 0
        if compute_core and warm_start is None:
            core, off = self.core(theta_full, None if follow is None else set(follow["core"]))
        reduct = list(core if warm_start is None else warm_start)
        target = None if follow is None else list(follow["reduct"])
        if target is not None and target[:len(reduct)] != reduct:
            off += 1
        hist = [self.theta_of(*self.classes(reduct[:i + 1])) for i in range(len(reduct))]
        theta_r = hist[-1] if hist else math.inf
        stop = f32_threshold(theta_full, self.tol)
        remaining = [a for a in range(self.g.x.shape[1]) if a not in reduct]
        while remaining:
            go = theta_r > stop
            if target is not None and (len(target) > len(reduct)) != go:
                if self._within(abs(theta_r - stop), 1, theta_r):
                    go = not go
                else:
                    off += 1
            if not go:
                break
            thetas = self.candidates(reduct, remaining)
            nxt = target[len(reduct)] if target is not None and len(target) > len(reduct) else None
            best, miss = self._pick(thetas, remaining, nxt)
            off += miss
            reduct.append(remaining.pop(best))
            theta_r = float(thetas[best])
            hist.append(theta_r)
        return Answer(reduct=reduct, core=core, theta_full=theta_full, theta_history=hist,
                      off=off)

    def _prefix_lengths(self, hist: Sequence[float], theta_full: float) -> List[int]:
        """The kept prefix lengths :func:`valid_prefix_len` gives, the exact
        one first, then those Θ values within reach could give."""
        stop = f32_threshold(theta_full, self.tol)
        m = self.reach(*hist)
        states, ks = [(math.inf, 0)], set()
        for t in hist:
            nxt = []
            for prev, k in states:
                flat = prev - t <= self.tie_tol
                for stops in {flat, not flat} if abs(prev - t - self.tie_tol) <= 2 * m else {flat}:
                    if stops:
                        ks.add(k)
                        continue
                    reached = t <= stop
                    for done in {reached, not reached} if abs(t - stop) <= m else {reached}:
                        if done:
                            ks.add(k + 1)
                        else:
                            nxt.append((t, k + 1))
            states = nxt
        ks.update(k for _p, k in states)
        exact = valid_prefix_len(hist, theta_full, tol=self.tol, tie_tol=self.tie_tol)
        return [exact] + sorted(ks - {exact})

    def repair(self, prev: Optional[Sequence[int]], follow: Optional[dict] = None) -> Answer:
        """The service's answer: cold without a previous reduct, else the
        previous reduct validated, trimmed and continued.  With ``follow``,
        the first kept length that explains the program's answer is taken."""
        if not prev:
            return self.reduce(follow=follow)
        prev = list(prev)
        hist = [self.theta_of(*self.classes(prev[:i + 1])) for i in range(len(prev))]
        first = None
        for k in self._prefix_lengths(hist, self.theta_full()):
            ans = self.reduce(warm_start=prev[:k], follow=follow)
            first = first or ans
            if follow is None or ans.off == 0:
                return ans
        return first
