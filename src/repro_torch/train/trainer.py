"""Training loop: sharded train step, grad accumulation, fault tolerance.

The port's ``repro.train.trainer``:

* **Train step** — ``make_train_step``: the model's loss, its gradient by
  autograd (``torch.autograd.grad``; attention and RWKV6 go through their
  kernels' differentiable wrappers), then AdamW.  The parameters and
  moments are updated in place (JAX donates the state's buffers).
* **Grad accumulation** — microbatches are run one after another and their
  gradients summed in f32, then divided by their count, as JAX's
  ``lax.scan`` does (``.grad`` accumulation would sum in the parameters'
  bf16).  Activation memory ∝ 1/n_micro.
* **Checkpoint/restart** — every ``ckpt_every`` steps via
  :class:`CheckpointManager` (async, atomic), in JAX's layout:
  ``{"params", "opt_m", "opt_v", "opt_step"}`` with block leaves stacked
  over periods (``models.convert.params_to_jax``), so each package resumes
  the other's checkpoints.  ``Trainer.fit`` resumes bit-exact (the data
  stream is indexed by step).
* **Preemption** — SIGTERM/SIGINT set a flag; the loop checkpoints and exits
  cleanly at the next step boundary.
* **Straggler mitigation** — per-step wall time EMA (the first step never
  seeds it); steps slower than ``straggler_factor ×`` EMA are recorded.

* **Sharded step** (``mesh=``, one process a rank, every rank running the
  same loop on the same data): the parameters and AdamW moments are DTensors
  placed by the model's ``param_shardings`` (``state_shardings``), each
  microbatch is placed over the batch axes (``batch_sharding``), and the step
  runs under ``use_mesh``.  Gradients come back in the parameters'
  placements; the clipping norm is the global one, every element counted
  once (a replicated shard on the ranks at coordinate 0 of its replicated
  axes only, one ``all_reduce`` over the world); AdamW then updates each
  rank's local shards.  Checkpoints are gathered and written once per world.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from functools import cached_property
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.api import (BATCH_AXES, P, place_like, shard_by_shape,
                                        sharding_for, unshard, use_mesh)
from repro_torch.models import build_model
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import params_from_jax, params_to_jax
from .checkpoint import CheckpointManager
from .optimizer import AdamW, AdamWState, cosine_schedule

State = Dict[str, Any]

__all__ = ["TrainConfig", "TrainState", "Trainer", "make_train_step"]


@dataclasses.dataclass
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    microbatches: int = 1
    ckpt_every: int = 50
    ckpt_keep: int = 3
    ckpt_dir: Optional[str] = None
    straggler_factor: float = 2.0
    log_every: int = 10


class TrainState:
    """Tiny train-state record (params + AdamW state)."""

    def __init__(self, params, opt: AdamWState):
        self.params = params
        self.opt = opt

    def as_tree(self) -> State:
        return {"params": self.params, "opt_m": self.opt.m, "opt_v": self.opt.v,
                "opt_step": self.opt.step}

    @staticmethod
    def from_tree(tree: State) -> "TrainState":
        return TrainState(tree["params"],
                          AdamWState(tree["opt_step"], tree["opt_m"], tree["opt_v"]))


def make_train_step(model, optimizer: AdamW, *, microbatches: int = 1, mesh=None) -> Callable:
    """(state, batch) → (state, metrics).  ``state["params"]`` are the
    model's own parameters (made trainable here); the step updates them and
    the moments in place.  ``batch`` is a dict of arrays or tensors (moved to
    the model's device), split into ``microbatches`` along the batch axis.
    With a ``mesh`` (the model's parameters placed on it) the step runs
    under ``use_mesh`` and each microbatch is placed over the batch axes."""
    model.requires_grad_(True)

    def grads_of(params: Dict[str, torch.Tensor], batch):
        if mesh is not None:
            batch = {k: shard_by_shape(P(BATCH_AXES), v.shape, mesh).place(v)
                     for k, v in batch.items()}
        with use_mesh(mesh):
            loss, metrics = model.loss(batch)
            grads = torch.autograd.grad(loss, list(params.values()))
        # each gradient in its parameter's placements
        grads = [place_like(g, p) for g, p in zip(grads, params.values())]
        return dict(zip(params, grads)), {k: unshard(v) for k, v in metrics.items()}

    def train_step(state: State, batch: Mapping[str, Any]):
        params = state["params"]
        opt_state = AdamWState(state["opt_step"], state["opt_m"], state["opt_v"])
        dev = mesh.device if mesh is not None else model.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if microbatches > 1:
            gsum, per_micro = None, []
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                g, m = grads_of(params, mb)
                if gsum is None:
                    gsum = {k: t.float() for k, t in g.items()}
                else:
                    for k, t in g.items():
                        gsum[k] += t.float()
                per_micro.append(m)
                del g
            grads = {k: t / microbatches for k, t in gsum.items()}
            metrics = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
        else:
            grads, metrics = grads_of(params, batch)
        params, new_opt, gnorm = optimizer.update(grads, opt_state, params)
        metrics = dict(metrics, grad_norm=gnorm, lr=optimizer.lr(new_opt.step))
        return {"params": params, "opt_m": new_opt.m, "opt_v": new_opt.v,
                "opt_step": new_opt.step}, metrics

    return train_step


class Trainer:
    """The training loop of one model on ``device`` (the card by default),
    its parameters seeded from ``seed``."""

    def __init__(self, arch_cfg: ArchConfig, train_cfg: TrainConfig, mesh=None, *,
                 device: DeviceLike = "cuda", seed: int = 0):
        """``mesh``: a :class:`repro_torch.distributed.Mesh` to train sharded
        on (its rank's device then overrides ``device``)."""
        self.cfg = arch_cfg
        self.tc = train_cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.seed = seed
        self.model = build_model(arch_cfg, device=self.device,
                                 generator=torch.Generator().manual_seed(seed))
        if mesh is not None:
            self.model.shard(mesh)
        self.optimizer = AdamW(
            lr=cosine_schedule(train_cfg.peak_lr, train_cfg.warmup_steps,
                               train_cfg.total_steps),
            weight_decay=train_cfg.weight_decay,
            grad_clip=train_cfg.grad_clip,
            moment_dtype=train_cfg.moment_dtype,
        )
        self.ckpt = (CheckpointManager(train_cfg.ckpt_dir, keep=train_cfg.ckpt_keep)
                     if train_cfg.ckpt_dir else None)
        self._preempted = False
        self.step_times: list = []
        self.straggler_steps: list = []

    # -- sharding ----------------------------------------------------------
    def state_shardings(self):
        """The state's shardings (``None`` without a mesh): the parameters'
        for the parameters and both moments, replicated for the step."""
        if self.mesh is None:
            return None
        psh = self.model.param_shardings(self.mesh)
        return {"params": psh, "opt_m": psh, "opt_v": psh,
                "opt_step": sharding_for(P(), self.mesh)}

    def batch_sharding(self):
        if self.mesh is None:
            return None
        return sharding_for(P(BATCH_AXES), self.mesh)

    def _load_params(self, state: Mapping[str, torch.Tensor]) -> None:
        """Full parameter values (every rank the same) into the model, each
        rank keeping its shard."""
        if self.mesh is None:
            self.model.load_state_dict(state)
            return
        with torch.no_grad():
            for key, p in self.model.named_parameters():
                p.copy_(place_like(state[key].to(self.device, p.dtype), p))

    # -- lifecycle -----------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> State:
        """Fresh state: the model's parameters drawn again from ``seed`` (the
        trainer's by default) and zero moments."""
        seed = self.seed if seed is None else seed
        fresh = build_model(self.cfg, device=self.device,
                            generator=torch.Generator().manual_seed(seed))
        self._load_params(fresh.state_dict())
        del fresh
        params = dict(self.model.named_parameters())
        opt = self.optimizer.init(params)
        return {"params": params, "opt_m": opt.m, "opt_v": opt.v, "opt_step": opt.step}

    def state_to_tree(self, state: State) -> Dict[str, Any]:
        """The state as JAX's checkpoint tree: numpy leaves, stacked blocks
        (full arrays: a sharded leaf is gathered, a collective)."""
        cfg = self.cfg

        def full(tree):
            return {k: unshard(v) for k, v in tree.items()}
        return {"params": params_to_jax(cfg, full(state["params"])),
                "opt_m": params_to_jax(cfg, full(state["opt_m"])),
                "opt_v": params_to_jax(cfg, full(state["opt_v"])),
                "opt_step": np.asarray(int(state["opt_step"]), np.int32)}

    def state_from_tree(self, tree: Mapping[str, Any]) -> State:
        """Load a checkpoint tree (either package's) into the model's
        parameters; the moments come to the device in their stored dtype
        (under a mesh each placed like its parameter)."""
        self._load_params(params_from_jax(self.cfg, tree["params"]))
        params = dict(self.model.named_parameters())
        moments = {name: {k: place_like(t.to(self.device), params[k]) for k, t in
                          params_from_jax(self.cfg, tree[name]).items()}
                   for name in ("opt_m", "opt_v")}
        step = torch.as_tensor(np.asarray(tree["opt_step"]), dtype=torch.int32,
                               device=self.device)
        return {"params": params, **moments, "opt_step": step}

    @cached_property
    def step_fn(self):
        return make_train_step(self.model, self.optimizer, microbatches=self.tc.microbatches,
                               mesh=self.mesh)

    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    # -- loop ------------------------------------------------------------------
    def restore_or_init(self, seed: Optional[int] = None):
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            step, tree, _ = self.ckpt.restore()
            return int(step), self.state_from_tree(tree)
        return 0, self.init_state(seed)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, data_fn: Callable[[int], Dict[str, Any]],
            *, steps: Optional[int] = None, start_step: Optional[int] = None,
            state: Optional[State] = None):
        """data_fn(step) → batch dict (deterministic per step: restart-safe)."""
        total = steps if steps is not None else self.tc.total_steps
        if state is None:
            start, state = self.restore_or_init()
        else:
            start = start_step or 0
        history = []
        ema = None
        step = start
        steps_done = 0
        while step < total:
            batch = data_fn(step)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            steps_done += 1
            if steps_done == 1:
                pass  # the first step builds kernels and warms caches: never seeds the EMA
            elif ema is None:
                ema = dt
            elif dt > self.tc.straggler_factor * ema:
                self.straggler_steps.append(step)
            else:
                ema = 0.9 * ema + 0.1 * dt
            step += 1
            if step % self.tc.log_every == 0 or step == total:
                history.append({"step": step, "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"]),
                                "sec_per_step": dt})
            should_ckpt = self.ckpt is not None and (
                step % self.tc.ckpt_every == 0 or step == total or self._preempted)
            if should_ckpt:
                tree = self.state_to_tree(state)       # every rank: a gather under a mesh
                if self.mesh is None or self.mesh.rank == 0:
                    self.ckpt.save(step, tree, extra={"arch": self.cfg.name}, blocking=False)
            if self._preempted:
                if self.ckpt is not None:
                    self.ckpt.wait()
                break
        if self.ckpt is not None:
            self.ckpt.wait()
        return state, history
