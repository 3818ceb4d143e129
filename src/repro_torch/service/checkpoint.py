"""Durable service state: DatasetHandle checkpoints (DESIGN.md §3.10).

The §3.7 service keeps everything that matters on the device: the live
granularity, the per-config reducts and Θ histories that make warm repair
possible, and (for sharded builds) the lineage metadata.  A process restart
loses all of it — the first post-restart query would pay a cold rebuild and
a cold reduction.  This module persists that state with the
``train/checkpoint.py`` idioms (flatten → npz, committed-sentinel atomic
steps, keep-N retention, background writer thread), so a restarted
:class:`~repro_torch.service.server.ReductServer` restores its handles and
answers its first query through the §3.7 warm ``repair_reduce`` path.

Layout: one committed step holds every dataset —

* arrays  (``arrays.npz``): per dataset, the granularity arrays
  (``<name>/gran/{x,d,w,valid,num,n_total}``) and every cached result's
  vector state (``<name>/results/<i>/{reduct,core,theta_history,
  per_iteration_s}``);
* metadata (``manifest.json`` → ``extra``): per dataset, the static schema
  (``n_attrs``/``n_dec``/``v_max``/``exact``), counters, the content
  fingerprint (verified on restore — a mismatch is
  :class:`~repro_torch.service.errors.CheckpointCorrupt`), the result cache keys
  (repr-encoded param tuples), and the shard lineage as JSON.

Dataset names become npz key prefixes, so they must not contain ``/``
(``ReductServer.submit`` enforces this when checkpointing is on).

The port's ``repro.service.checkpoint``.  The layout is the JAX package's,
key for key (the same ``repr``-encoded result keys and the same
fingerprint), so a step that either package writes restores in the other
(tests/test_torch_recovery.py).  The snapshot is a ``.cpu()`` copy on the
caller's thread under the device guard's shared side (``core/guard.py``);
a restore puts every granularity on the restoring side's explicit device.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.granularity import granularity_from_numpy
from repro_torch.core.guard import device_guard
from repro_torch.core.recovery import ShardLineage
from repro_torch.core.reduction import ReductionResult
from repro_torch.device import DeviceLike
from repro_torch.train.checkpoint import CheckpointManager

from .errors import CheckpointCorrupt
from .state import DatasetHandle, granularity_fingerprint

__all__ = ["ServiceCheckpointer", "handle_to_state", "handle_from_state"]


def handle_to_state(handle: DatasetHandle) -> Tuple[dict, dict]:
    """Snapshot one handle as ``(array_tree, json_meta)``.

    The array copy to host happens here, on the caller's thread, so a
    background writer never races live device buffers being replaced by a
    concurrent merge.
    """
    g = handle.gran
    with device_guard(g.device).shared():
        tree: Dict[str, Any] = {"gran": {
            k: getattr(g, k).cpu().numpy()
            for k in ("x", "d", "w", "valid", "num", "n_total")}}
        fingerprint = handle.fingerprint
    results: Dict[str, Any] = {}
    results_meta = []
    for i, (key, r) in enumerate(
            sorted(handle._results.items(), key=lambda kv: repr(kv[0]))):
        results[str(i)] = {
            "reduct": np.asarray(r.reduct, np.int32),
            "core": np.asarray(r.core, np.int32),
            "theta_history": np.asarray(r.theta_history, np.float64),
            "per_iteration_s": np.asarray(r.per_iteration_s, np.float64),
        }
        results_meta.append({
            "key": repr(key),
            "theta_full": float(r.theta_full),
            "iterations": int(r.iterations),
            "n_evaluations": int(r.n_evaluations),
            "elapsed_s": float(r.elapsed_s),
        })
    if results:
        tree["results"] = results
    meta = {
        "n_attrs": g.n_attrs, "n_dec": g.n_dec, "v_max": g.v_max,
        "exact": handle.exact,
        "n_updates": handle.n_updates,
        "rows_absorbed": handle.rows_absorbed,
        "fingerprint": fingerprint,
        "results": results_meta,
        "lineage": ([l.to_dict() for l in handle.lineage]
                    if handle.lineage is not None else None),
    }
    return tree, meta


def handle_from_state(tree: dict, meta: dict, *,
                      device: DeviceLike = "cuda") -> DatasetHandle:
    """Rebuild a handle on ``device`` from its checkpointed state (inverse
    of :func:`handle_to_state`).  The restored content fingerprint is
    recomputed from the arrays and checked against the recorded one — a
    mismatch means the arrays and metadata are out of sync
    (:class:`CheckpointCorrupt`), not silently-wrong warm starts later.
    """
    g = tree["gran"]
    gran = granularity_from_numpy(
        g["x"], g["d"], g["w"], g["valid"], g["num"], g["n_total"],
        n_attrs=int(meta["n_attrs"]), n_dec=int(meta["n_dec"]),
        v_max=int(meta["v_max"]), device=device)
    with device_guard(gran.device).shared():
        fp = granularity_fingerprint(gran)
    if fp != int(meta["fingerprint"]):
        raise CheckpointCorrupt(
            f"restored granularity fingerprint {fp:#x} != recorded "
            f"{int(meta['fingerprint']):#x} (arrays and metadata disagree)")
    results: Dict[tuple, ReductionResult] = {}
    arrays = tree.get("results", {})
    for i, rm in enumerate(meta.get("results", [])):
        arr = arrays[str(i)]
        key = ast.literal_eval(rm["key"])
        results[key] = ReductionResult(
            reduct=[int(a) for a in np.asarray(arr["reduct"])],
            core=[int(a) for a in np.asarray(arr["core"])],
            theta_full=float(rm["theta_full"]),
            theta_history=[float(t) for t in np.asarray(arr["theta_history"])],
            iterations=int(rm["iterations"]),
            n_evaluations=int(rm["n_evaluations"]),
            elapsed_s=float(rm["elapsed_s"]),
            per_iteration_s=[float(t)
                             for t in np.asarray(arr["per_iteration_s"])],
        )
    lineage = None
    if meta.get("lineage") is not None:
        lineage = tuple(ShardLineage.from_dict(d) for d in meta["lineage"])
    handle = DatasetHandle(
        gran=gran, exact=bool(meta["exact"]),
        n_updates=int(meta["n_updates"]),
        rows_absorbed=int(meta["rows_absorbed"]),
        lineage=lineage,
    )
    handle._results = results
    handle._fp = fp
    return handle


class _ServiceManager(CheckpointManager):
    """CheckpointManager with the chaos harness's checkpoint-crash site:
    the fault fires *after* the arrays and manifest are staged but *before*
    the commit (sentinel + rename), so an injected crash exercises exactly
    the window the atomic layout protects — prior committed steps survive
    untouched (tests/test_torch_recovery.py).

    Write failures (injected or real: full disk, dead mount) are absorbed
    into ``last_error`` instead of raised: a checkpoint is an availability
    feature, and a broken disk must not take the serving path — or the
    background writer thread — down with it.
    """

    fault_plan = None
    last_error: Optional[BaseException] = None

    def _pre_commit(self, tmp_dir: str) -> None:
        if self.fault_plan is not None:
            self.fault_plan.inject("checkpoint")

    def _write(self, step, host, extra):
        try:
            with obs.span("checkpoint.write", step=int(step)):
                return super()._write(step, host, extra)
        except BaseException as e:
            self.last_error = e
            obs.event("checkpoint.write_failed", step=int(step),
                      error=f"{type(e).__name__}: {e}")
            obs.counter("plar_checkpoint_failed_total",
                        "checkpoint writes that failed (absorbed)").inc()
            return ""


class ServiceCheckpointer:
    """Keep-N durable snapshots of a server's :class:`DatasetHandle` map.

    ``save`` snapshots host-side on the calling thread (cheap: one
    device→host copy per live array) and, with ``blocking=False``, hands
    the write to the manager's background thread — the §3.7 serving path
    never waits on disk.  ``restore`` returns the newest readable committed
    step's handles on ``device`` (corrupt steps are skipped with a warning
    by the underlying manager).
    """

    def __init__(self, directory: str, *, keep: int = 3,
                 fault_plan=None, device: DeviceLike = "cuda") -> None:
        self.directory = directory
        self.device = device
        self._mgr = _ServiceManager(directory, keep=keep)
        self._mgr.fault_plan = fault_plan
        self._step = (self._mgr.latest_step() or 0)
        self.saves = 0
        self.failed_saves = 0
        self.last_error: Optional[BaseException] = None

    def _harvest(self) -> bool:
        """Collect a write failure recorded by the (possibly background)
        writer since the last check.  True when one was found."""
        err = self._mgr.last_error
        if err is None:
            return False
        self._mgr.last_error = None
        self.last_error = err
        self.failed_saves += 1
        return True

    def save(self, handles: Dict[str, Optional[DatasetHandle]], *,
             blocking: bool = True) -> Optional[str]:
        """Snapshot every live handle as one committed step.

        Names still reserved by an in-flight ``submit`` (value ``None``)
        are skipped — they have no state yet.  Returns the step path, or
        ``None`` when a blocking write failed (failures are absorbed and
        counted in ``failed_saves``/``last_error``; background-write
        failures surface at the next ``save``/``wait``).  The previous
        committed step always remains restorable — the atomic step layout
        commits all-or-nothing.
        """
        tree: Dict[str, Any] = {}
        metas: Dict[str, Any] = {}
        with obs.span("checkpoint.snapshot", datasets=len(handles)):
            for name, handle in handles.items():
                if handle is None:
                    continue
                t, m = handle_to_state(handle)
                tree[name] = t
                metas[name] = m
        obs.counter("plar_checkpoint_saves_total",
                    "checkpoint steps staged for write").inc()
        if blocking:
            self._mgr.wait()  # never two writers racing in one directory
        self._harvest()  # a background failure from the previous save
        self._step += 1
        path = self._mgr.save(self._step, tree, extra={"datasets": metas},
                              blocking=blocking)
        if blocking and self._harvest():
            return None
        self.saves += 1
        return path

    def wait(self) -> None:
        """Join the background writer (call before process exit)."""
        self._mgr.wait()
        self._harvest()

    def restore(self) -> Tuple[int, Dict[str, DatasetHandle]]:
        """Handles from the newest readable committed step.

        Raises ``FileNotFoundError`` when no committed step exists (a cold
        start) and :class:`CheckpointCorrupt` when a step's arrays and
        metadata disagree.
        """
        with obs.span("checkpoint.restore"):
            step, tree, extra = self._mgr.restore()
            handles = {
                name: handle_from_state(tree.get(name, {}), meta,
                                        device=self.device)
                for name, meta in extra.get("datasets", {}).items()
            }
        obs.counter("plar_checkpoint_restores_total",
                    "checkpoint restore calls that found a step").inc()
        return step, handles
