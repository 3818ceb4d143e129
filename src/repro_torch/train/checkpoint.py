"""Sharded checkpointing with atomic commits, retention and elastic restore.

Layout (one directory per step)::

    <dir>/step_000120/
        manifest.json        # step, flat key list, shapes/dtypes, extra metadata
        arrays.npz           # flat {key: ndarray}; written by the save host
        COMMITTED            # sentinel written last → crash-safe

* **Atomicity**: everything lands in ``step_NNN.tmp`` and is renamed after
  the sentinel is in place; a restart ignores uncommitted directories.
* **Host arrays**: arrays are stored logically (unsharded, numpy); restore
  returns numpy arrays, or tensors on an explicit ``device``.
* **Async**: `save(..., blocking=False)` hands the host arrays to a writer
  thread; training continues, `wait()` joins before the next save.
* **Retention**: keep the last `keep` committed steps, delete older.

The port's ``repro.train.checkpoint``.  The on-disk layout is the JAX
manager's: the same files, array keys and manifest fields, so each manager
reads the other's steps.  Leaves may be numpy arrays or tensors (copied to
the host with ``.cpu()`` on the saving thread).

* **Sharded saves**: a tree holding DTensors (a sharded train state) is
  gathered to full arrays on every rank (a collective: every rank calls
  ``save``) and written once per world, by rank 0; a blocking save ends at
  a barrier, so every rank then sees the committed step.
* **Elastic restore**: ``restore(shardings=)`` places each leaf by its
  sharding (a tree of ``NamedSharding`` or ``None``, like the state) on
  whatever mesh the sharding names, so a checkpoint written on one mesh
  restores on another.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.device import DeviceLike, resolve_device

Pytree = Any

_SENTINEL = "COMMITTED"

# What a truncated/corrupt checkpoint surfaces as: a half-written npz is a
# BadZipFile or EOFError, a clipped manifest a JSONDecodeError, a missing
# array key a KeyError, a garbage header a ValueError/OSError.
_CORRUPT_ERRORS = (OSError, EOFError, KeyError, ValueError,
                   json.JSONDecodeError, zipfile.BadZipFile)


def _atomic_write(path: str, writer) -> None:
    """Crash-safe file write: ``writer(tmp_path)`` then atomic ``os.replace``.

    A crash mid-write leaves only ``<path>.tmp`` — never a truncated file at
    the final name — so a reader can trust any file that exists."""
    tmp = path + ".tmp"
    writer(tmp)
    os.replace(tmp, path)


def _flatten(tree: Pytree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Pytree:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _to_host(v) -> np.ndarray:
    if isinstance(v, DTensor):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Pytree, *, extra: Optional[dict] = None,
             blocking: bool = True) -> str:
        flat = _flatten(tree)
        sharded = any(isinstance(v, DTensor) for v in flat.values())
        host = {k: _to_host(v) for k, v in flat.items()}  # device → host copy
        if sharded and dist.get_rank() != 0:              # written once per world
            if blocking:
                dist.barrier()
            return self._path(step)
        if blocking:
            out = self._write(step, host, extra or {})
            if sharded:
                dist.barrier()
            return out
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True
        )
        self._thread.start()
        return self._path(step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def _write(self, step: int, host: Dict[str, np.ndarray], extra: dict) -> str:
        final = self._path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        # each file lands via its own tmp + os.replace: a crash at any point
        # leaves either no file or a complete one, never a truncated npz
        def dump_npz(p):
            with open(p, "wb") as f:  # file object: savez must not append .npz
                np.savez(f, **host)

        _atomic_write(os.path.join(tmp, "arrays.npz"), dump_npz)
        manifest = {
            "step": step,
            "keys": sorted(host),
            "shapes": {k: list(v.shape) for k, v in host.items()},
            "dtypes": {k: str(v.dtype) for k, v in host.items()},
            "time": time.time(),
            "extra": extra,
        }

        def dump_json(p):
            with open(p, "w") as f:
                json.dump(manifest, f)

        _atomic_write(os.path.join(tmp, "manifest.json"), dump_json)
        self._pre_commit(tmp)
        _atomic_write(os.path.join(tmp, _SENTINEL),
                      lambda p: open(p, "w").write("ok\n"))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _pre_commit(self, tmp_dir: str) -> None:
        """Hook between the array/manifest writes and the commit (sentinel +
        rename).  Subclasses use it for fault injection: raising here aborts
        the step with nothing committed, proving the atomicity contract."""

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(full, _SENTINEL)):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_step(self, step: int) -> Tuple[Dict[str, np.ndarray], dict]:
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            flat = {k: npz[k] for k in manifest["keys"]}
        return flat, manifest

    def restore(self, step: Optional[int] = None, *, device: Optional[DeviceLike] = None,
                shardings: Optional[Pytree] = None) -> Tuple[int, Pytree, dict]:
        """Returns (step, tree, extra).  The tree's leaves are numpy arrays,
        or tensors on ``device`` when one is given; a leaf whose entry in
        ``shardings`` (same structure) is a ``NamedSharding`` is placed by it,
        a DTensor on its mesh's device.

        With ``step=None`` (auto-pick), a truncated or corrupt step — partial
        write that still got committed, bit rot, manual tampering — is
        *skipped with a warning* and the next older committed step is tried,
        so a restart degrades to slightly-older state instead of dying
        mid-startup.  An explicitly requested ``step`` still raises: the
        caller asked for that step specifically and silently substituting
        another would be wrong.
        """
        if step is not None:
            flat, manifest = self._load_step(step)
        else:
            candidates = self.all_steps()
            if not candidates:
                raise FileNotFoundError(
                    f"no committed checkpoints in {self.directory}")
            flat = manifest = None
            for s in reversed(candidates):
                try:
                    flat, manifest = self._load_step(s)
                    step = s
                    break
                except _CORRUPT_ERRORS as e:
                    warnings.warn(
                        f"skipping corrupt checkpoint {self._path(s)}: "
                        f"{type(e).__name__}: {e}", stacklevel=2)
            if flat is None:
                raise FileNotFoundError(
                    f"no readable checkpoints in {self.directory} "
                    f"(all {len(candidates)} committed steps are corrupt)")
        if device is not None:
            dev = resolve_device(device)
            flat = {k: torch.as_tensor(v).to(dev) for k, v in flat.items()}
        if shardings is not None:
            flat_sh = _flatten(shardings)
            flat = {k: (v if flat_sh.get(k) is None else flat_sh[k].place(
                torch.as_tensor(v).to(flat_sh[k].mesh.device))) for k, v in flat.items()}
        return step, _unflatten(flat), manifest.get("extra", {})
