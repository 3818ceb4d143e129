"""RWKV6 recurrence: every RWKV time-mix call's kernel (CUDA, sm_90a).

``ops`` holds the wrapper (kernel on a CUDA tensor, plain version on a CPU
tensor, with a launch counter), ``ref`` the plain PyTorch version,
``csrc/`` the kernel.
"""
from .ops import LAUNCHES, launch_counts, reset_launch_counts, rwkv6
from .ref import rwkv6_ref

__all__ = ["LAUNCHES", "launch_counts", "reset_launch_counts", "rwkv6", "rwkv6_ref"]
