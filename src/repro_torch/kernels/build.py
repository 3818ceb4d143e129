"""Build and load the port's CUDA kernels (CUDA C++, ``sm_90a``).

Every kernel family keeps its sources under ``kernels/<family>/csrc/``.  Each
kernel's source is compiled by its own ``nvcc`` into a shared library with a
plain C interface, all of them started together, at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 [family flags] \\
         -shared -Xcompiler -fPIC -o build/repro_torch/lib<name>-<hash>.so <name>.cu

and loaded with :mod:`ctypes` (every pointer and the stream as
``c_void_p``).  A library's file name carries a hash of its sources and
flags, so an edit rebuilds and a stale library is never loaded.  The build
directory is ``build/repro_torch`` under the repository root (``.gitignore``
lists ``build/``), or ``$REPRO_TORCH_BUILD_DIR``.

Flags by family:

* ``contingency`` (contingency, fused Θ, sweep Θ): ``--fmad=false`` keeps
  every product and sum of the θ' epilogues rounded on its own, as the plain
  PyTorch version's ops are.
* ``flash_attention`` (f32 and bf16 on the CUDA cores, and the bf16
  tensor-core kernel ``flash_attention_tc``) and ``rwkv6``: the default
  contraction to FMA; their plain versions are compared within a
  tolerance, not bit for bit.

``--use_fast_math`` is never passed: ``logf`` and ``expf`` stay accurate.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["KERNELS", "Kernel", "build_all", "build_dir", "check", "load", "nvcc_path"]

_KERNELS_DIR = Path(__file__).resolve().parent
BASE_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One shared library: its source, the headers it includes, its flags."""

    family: str                       # package under kernels/
    source: str                       # file under kernels/<family>/csrc/
    headers: Tuple[str, ...] = ()     # files under the same csrc/ it includes
    flags: Tuple[str, ...] = ()       # added to BASE_FLAGS

    @property
    def csrc(self) -> Path:
        return _KERNELS_DIR / self.family / "csrc"


_CONTINGENCY = dict(family="contingency", headers=("common.cuh", "segments.cuh"),
                    flags=("--fmad=false",))
# kernel name → how to build it
KERNELS: Dict[str, Kernel] = {
    "contingency": Kernel(source="contingency.cu", **_CONTINGENCY),
    "fused_theta": Kernel(source="fused_theta.cu", **_CONTINGENCY),
    "sweep_theta": Kernel(source="sweep_theta.cu", **_CONTINGENCY),
    "flash_attention": Kernel(family="flash_attention", source="flash_attention.cu"),
    "flash_attention_tc": Kernel(family="flash_attention", source="flash_attention_tc.cu"),
    "rwkv6": Kernel(family="rwkv6", source="rwkv6.cu"),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py → repository root
    return _KERNELS_DIR.parents[2] / "build" / "repro_torch"


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are compiled from their csrc/ at first use")


def _flags(name: str) -> Tuple[str, ...]:
    return BASE_FLAGS + KERNELS[name].flags


def _lib_path(name: str) -> Path:
    k = KERNELS[name]
    h = hashlib.sha256()
    for fname in (k.source,) + k.headers:
        h.update(fname.encode())
        h.update((k.csrc / fname).read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(force: bool = False, names: Optional[List[str]] = None) -> float:
    """Compile every missing library (every library with ``force``), one
    ``nvcc`` per source, all started together; ``names`` limits the build to
    those kernels.

    Returns the seconds taken.  Raises with ``nvcc``'s output if any build
    fails.
    """
    with _lock:
        t0 = time.perf_counter()
        todo = [n for n in (names or KERNELS) if force or not _lib_path(n).exists()]
        if not todo:
            return 0.0
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs: List[Tuple[str, Path, subprocess.Popen]] = []
        for name in todo:
            k = KERNELS[name]
            tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *_flags(name), "-o", str(tmp), str(k.csrc / k.source)]
            procs.append((name, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, tmp, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(name)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _lib_path(name))  # atomic: no half-written library
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if missing)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all(names=[name])
    lib = ctypes.CDLL(str(path))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg: Optional[bytes] = lib.repro_error_string(err)
        raise RuntimeError(
            f"{what}: CUDA error {err} ({(msg or b'?').decode()})")
