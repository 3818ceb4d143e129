"""Flash attention: the LM prefill's attention kernel (CUDA, sm_90a).

``ops`` holds the wrapper (kernel on a CUDA tensor, plain version on a CPU
tensor, with a launch counter), ``ref`` the plain PyTorch version,
``csrc/`` the kernel.
"""
from .ops import LAUNCHES, flash_attention, launch_counts, reset_launch_counts
from .ref import attention_ref

__all__ = ["LAUNCHES", "attention_ref", "flash_attention", "launch_counts",
           "reset_launch_counts"]
