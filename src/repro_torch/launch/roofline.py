"""Roofline terms and the card's figures: the port's counterpart of
``repro.launch.roofline``.

The card's figures (:class:`DeviceSpec`, :data:`H100_SXM`,
:func:`device_spec`) live in :mod:`repro_torch.cards`, which imports torch
alone, and are re-exported here; ``chip_smoke.py``'s bounds read them from
either.

Three terms per step, as in the JAX package:

    compute    = flops / peak ops/s of the operand type
    memory     = bytes / device memory bytes/s
    collective = wire bytes / NVLink bytes/s (each way)

``extrapolate`` and ``extrapolate_collectives`` carry the JAX package's
linear probe rule (``total(P) = p1 + (P - 1)·(p2 - p1)``) and
:func:`model_flops` its useful-work yardstick, over the port's
``ArchConfig``.

:class:`StepCounter` takes the place of what JAX reads from XLA's cost
analysis and from the compiled HLO (its parsers ``parse_collectives`` and
``parse_convert_bytes`` have no counterpart): a dispatch mode that counts,
for one rank (its local shards), as a step runs eagerly:

* operations: ``torch.utils.flop_counter``'s formulas on the local ops,
  plus the hand-written kernels' analytic operations (their wrappers hand
  them to :func:`repro_torch.kernels.launching.note_kernel`, for a launch
  on the card and for the dry-run's shape-only twin alike);
* bytes: each local op's tensor inputs read once and its outputs written
  once (eager PyTorch launches one kernel an op), views and DTensor's
  bookkeeping (``empty*``, ``prim.*``, ``wait_tensor``) skipped, plus the
  kernels' analytic bytes; ``convert_bytes`` those of dtype casts;
* collectives: every ``_c10d_functional`` collective DTensor issues (and
  its ``_dtensor.shard_dim_alltoall``; on a CPU mesh DTensor replaces that
  by an ``all_gather``, gloo having no all-to-all) and every ``c10d`` one
  of the port's ``shard_map`` islands (``psum``, ``pmax``,
  ``all_gather``): kind, payload bytes, group size; the wire bytes of
  :func:`ring_wire_bytes`;
* live bytes: the high-water mark of the storages the step allocates (a
  storage counts from the op that makes it until it is freed).

The ops DTensor's sharding propagation runs at the global shape (on
fake tensors) are skipped: a rank never runs them.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.cards import H100_SXM, H200_SXM, DeviceSpec, device_spec
from repro_torch.kernels.launching import add_sink, remove_sink

__all__ = [
    "DeviceSpec",
    "H100_SXM",
    "H200_SXM",
    "CollectiveStats",
    "StepCounter",
    "collective_stats",
    "device_spec",
    "extrapolate",
    "extrapolate_collectives",
    "model_flops",
    "ring_wire_bytes",
    "roofline_terms",
    "storages",
    "PEAK_FLOPS",
    "PEAK_FLOPS_F32",
    "HBM_BW",
    "NVLINK_BW",
]


PEAK_FLOPS = H100_SXM.bf16_ops_per_s
PEAK_FLOPS_F32 = H100_SXM.f32_ops_per_s
HBM_BW = H100_SXM.hbm_bytes_per_s
NVLINK_BW = H100_SXM.nvlink_bytes_per_s


def roofline_terms(flops_dev: float, bytes_dev: float, wire_bytes_dev: float, *,
                   dtype: str = "bf16", spec: Optional[DeviceSpec] = None) -> dict:
    """Compute, memory and collective seconds on ``spec`` (default
    :data:`H100_SXM`), the dominant one, and the bound (their largest).

    ``dtype`` names the operations' type: ``"bf16"`` (tensor cores, as the
    JAX package's TPU figure) or ``"f32"`` (CUDA cores).
    """
    spec = H100_SXM if spec is None else spec
    compute = flops_dev / spec.peak_ops(dtype)
    memory = bytes_dev / spec.hbm_bytes_per_s
    collective = wire_bytes_dev / spec.nvlink_bytes_per_s
    dominant = max(
        [("compute", compute), ("memory", memory), ("collective", collective)],
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "bound_s": max(compute, memory, collective),
    }


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    result_bytes: Dict[str, int]     # Σ result sizes per kind
    wire_bytes: Dict[str, float]     # ring-model per-device wire bytes per kind

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def as_dict(self):
        return {"counts": self.counts, "result_bytes": self.result_bytes,
                "wire_bytes": self.wire_bytes,
                "total_wire_bytes": self.total_wire_bytes}


def extrapolate(p1: float, p2: float, n_periods: int) -> float:
    """total(P) = p1 + (P-1)·(p2-p1); clamps tiny negative diffs to 0."""
    delta = max(p2 - p1, 0.0)
    return p1 + (n_periods - 1) * delta


def extrapolate_collectives(s1: CollectiveStats, s2: CollectiveStats,
                            n_periods: int) -> Dict[str, float]:
    kinds = set(s1.wire_bytes) | set(s2.wire_bytes)
    return {k: extrapolate(s1.wire_bytes.get(k, 0.0), s2.wire_bytes.get(k, 0.0), n_periods)
            for k in kinds}


def model_flops(cfg, shape) -> float:
    """6·N_active·D for training; 2·N_active·D + attention reads for serving.

    Attention scores/values add 4·B·Hq·Dh·S_q·S_kv per attention layer
    (halved for causal).  The textbook MFU numerator, the JAX package's
    arithmetic over the port's ``ArchConfig``.
    """
    n_active = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    kinds = cfg.block_kinds()
    n_attn = sum(1 for k in kinds if k == "attn")
    if cfg.is_encdec:
        n_attn = cfg.enc_layers + 2 * cfg.dec_layers

    if shape.kind == "train":
        if cfg.is_encdec:
            dec = s // 4
            tokens = b * (s + dec)
            attn = 4 * b * cfg.n_heads * cfg.hd * (
                cfg.enc_layers * s * s
                + cfg.dec_layers * dec * dec * 0.5
                + cfg.dec_layers * dec * s
            )
        else:
            tokens = b * s
            attn = 2 * b * cfg.n_heads * cfg.hd * n_attn * (
                min(s, cfg.window or s) * s
            )  # causal ⇒ ×1/2 of 4·S² (window caps the span)
        return 6.0 * n_active * tokens + 3.0 * attn

    if shape.kind == "prefill":
        tokens = b * s
        if cfg.is_encdec:
            attn = 4 * b * cfg.n_heads * cfg.hd * cfg.enc_layers * s * s
        else:
            attn = 2 * b * cfg.n_heads * cfg.hd * n_attn * min(s, cfg.window or s) * s
        return 2.0 * n_active * tokens + attn

    # decode: one token per sequence
    span = min(s, cfg.window or s)
    if cfg.is_encdec:
        attn = 4 * b * cfg.n_heads * cfg.hd * cfg.dec_layers * (s + 1)
        return 2.0 * n_active * b + attn
    attn = 4 * b * cfg.n_heads * cfg.hd * n_attn * span
    return 2.0 * n_active * b + attn


# ---------------------------------------------------------------------------
# collectives and the counting dispatch mode
# ---------------------------------------------------------------------------


def ring_wire_bytes(kind: str, payload: float, n: int) -> float:
    """Bytes one rank sends under a ring over ``n`` ranks for a collective
    handed ``payload`` bytes (for ``all_gather``, its own shard)."""
    if n <= 1:
        return 0.0
    if kind == "all_reduce":
        return 2.0 * (n - 1) / n * payload
    if kind == "reduce_scatter":
        return (n - 1) / n * payload
    if kind == "all_gather":
        return float(n - 1) * payload
    if kind == "all_to_all":
        return (n - 1) / n * payload
    if kind == "collective_permute":
        return float(payload)
    raise ValueError(f"unknown collective kind {kind!r}")


_RESULT = {"all_reduce": lambda b, n: b, "reduce_scatter": lambda b, n: b // n,
           "all_gather": lambda b, n: b * n, "all_to_all": lambda b, n: b,
           "collective_permute": lambda b, n: b}


def collective_stats(calls: List[Tuple[str, int, int]]) -> Dict:
    """``[(kind, payload bytes, group size)]`` → JAX's ``CollectiveStats``
    dict (counts, result bytes, ring wire bytes), plus the payloads."""
    counts: Dict[str, int] = {}
    payload: Dict[str, int] = {}
    result: Dict[str, int] = {}
    wire: Dict[str, float] = {}
    for kind, b, n in calls:
        counts[kind] = counts.get(kind, 0) + 1
        payload[kind] = payload.get(kind, 0) + b
        result[kind] = result.get(kind, 0) + _RESULT[kind](b, n)
        wire[kind] = wire.get(kind, 0.0) + ring_wire_bytes(kind, b, n)
    return {"counts": counts, "result_bytes": result, "wire_bytes": wire,
            "total_wire_bytes": sum(wire.values()), "payload_bytes": payload,
            "total_payload_bytes": sum(payload.values())}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storages(tree) -> Dict[int, int]:
    """``{storage: bytes}`` of ``tree``'s tensors (the local shards of DTensors)."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _group_size(group) -> int:
    if isinstance(group, str):                       # a functional collective's group name
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(group).size()
    if isinstance(group, torch.ScriptObject):            # a c10d op's boxed group
        import torch.distributed as dist
        group = dist.ProcessGroup.unbox(group)
    return group.size()


# (namespace, op name) → (kind, the argument holding the payload, the group argument)
_C10D = {
    ("_c10d_functional", "all_reduce"): ("all_reduce", 0, 2),
    ("_c10d_functional", "all_reduce_"): ("all_reduce", 0, 2),
    ("_c10d_functional", "all_gather_into_tensor"): ("all_gather", 0, 2),
    ("_c10d_functional", "all_gather_into_tensor_out"): ("all_gather", 0, 2),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce_scatter", 0, 3),
    ("_c10d_functional", "all_to_all_single"): ("all_to_all", 0, 3),
    ("c10d", "allreduce_"): ("all_reduce", 0, 1),
    ("c10d", "allgather_"): ("all_gather", 1, 2),
    ("c10d", "_allgather_base_"): ("all_gather", 1, 2),
    ("c10d", "reduce_scatter_tensor_coalesced_"): ("reduce_scatter", 1, 2),
    ("c10d", "_reduce_scatter_base_"): ("reduce_scatter", 1, 2),
    ("c10d", "alltoall_base_"): ("all_to_all", 1, 2),
    ("c10d", "send"): ("collective_permute", 0, 1),
    ("_dtensor", "shard_dim_alltoall"): ("all_to_all", 0, 3),
}
_BOOKKEEPING = {"wait_tensor", "_wrap_tensor_autograd", "recv_", "recv_any_source_",
                "barrier", "monitored_barrier_"}


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class StepCounter(TorchDispatchMode):
    """Count one rank's operations, bytes, casts, collectives and live bytes
    while a step runs under it (module doc).  Usable on the card and on the
    ``meta`` device of the dry-run alike::

        with StepCounter() as c:
            out = step(*args)
        c.flops, c.bytes, c.collective_stats(), c.peak_bytes
    """

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.convert_bytes = 0.0
        self.ops = 0
        self.collectives: List[Tuple[str, int, int]] = []
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}     # storage → bytes, for those this step made

    # -- the kernels' analytic costs -----------------------------------------
    def _note_kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def __enter__(self):
        add_sink(self._note_kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        remove_sink(self._note_kernel)
        return super().__exit__(*exc)

    # -- live storage ----------------------------------------------------------
    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, key)

    def _allocated_outputs(self, ins, outs) -> None:
        """Count the outputs that do not write into an input (in place)."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata not in seen:
                self._allocated(t)

    def held_bytes(self, tree) -> int:
        """Bytes of the storages of ``tree``'s tensors (local shards of
        DTensors) that this step made and that are still live."""
        return sum(self._live.get(k, 0) for k in storages(tree))

    def collective_stats(self) -> Dict:
        return collective_stats(self.collectives)

    # -- the dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor unwraps: its local ops come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                       # DTensor's sharding propagation, global shapes
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "c10d", "_dtensor"):
            spec = _C10D.get((ns, name))
            if spec is not None:
                kind, arg, grp = spec
                payload = sum(_nbytes(t) for t in tree_leaves(args[arg])
                              if isinstance(t, torch.Tensor))
                self.collectives.append((kind, payload, _group_size(args[grp])))
            elif name not in _BOOKKEEPING:
                raise NotImplementedError(f"StepCounter: no rule for the collective {func}")
            self._allocated_outputs(ins, outs)
            return out
        if ns == "prim":
            return out
        self.ops += 1
        view = _is_view(func)
        if not view:
            self._allocated_outputs(ins, outs)
        if view or name.startswith("empty") or name in ("detach", "lift_fresh", "set_"):
            return out
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += float(fn(*args, **kwargs, out_val=out))
        moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += moved
        if (name == "_to_copy" and ins and outs and ins[0].dtype != outs[0].dtype) or (
                name == "copy_" and len(ins) >= 2 and ins[0].dtype != ins[1].dtype):
            self.convert_bytes += moved
        return out
