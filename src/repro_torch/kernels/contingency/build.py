"""The contingency family's view of the port's one kernel build.

The build itself (one ``nvcc`` per source, all started together, hashed
library names under ``build/repro_torch/``) lives in
:mod:`repro_torch.kernels.build`, which builds every kernel family.  This
module keeps the names its callers import: :data:`KERNELS` maps the three
contingency kernels to their sources in :data:`CSRC`, and
:func:`build_all` / :func:`load` / :func:`check` are the shared ones.
"""
from __future__ import annotations

from typing import Dict

from ..build import build_all, build_dir, check, load, nvcc_path
from ..build import KERNELS as _ALL

__all__ = ["CSRC", "KERNELS", "build_all", "build_dir", "check", "load", "nvcc_path"]

CSRC = _ALL["contingency"].csrc
KERNELS: Dict[str, str] = {n: k.source for n, k in _ALL.items() if k.family == "contingency"}
