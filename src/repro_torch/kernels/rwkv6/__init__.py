"""RWKV6 recurrence: every RWKV time-mix call's kernel (CUDA, sm_90a).

``ops`` holds the wrapper (a kernel on a CUDA tensor, the plain version on a
CPU tensor, with launch counters), the raw kernel entry ``rwkv6_scan`` (CUDA
tensors only) and the differentiable form for training (``rwkv6_diff``),
``ref`` the plain PyTorch version, ``csrc/`` the kernel.
"""
from .ops import (CHUNK, LAUNCHES, launch_counts, reset_launch_counts, rwkv6, rwkv6_diff,
                  rwkv6_scan)
from .ref import rwkv6_chunked_ref, rwkv6_ref

__all__ = ["CHUNK", "LAUNCHES", "launch_counts", "reset_launch_counts", "rwkv6",
           "rwkv6_chunked_ref", "rwkv6_diff", "rwkv6_ref", "rwkv6_scan"]
