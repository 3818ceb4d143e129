"""Flash attention: the LM prefill's attention kernel (CUDA, sm_90a).

``ops`` holds the wrapper (a kernel on a CUDA tensor — the bf16
tensor-core kernel or the f32 one, by dtype and head width — the plain
version on a CPU tensor, with launch counters) and its differentiable form
for training (``flash_attention_diff``, ``mha``), ``ref`` the plain PyTorch
version, ``csrc/`` the kernels.
"""
from .ops import (LAUNCHES, TC_HEAD_DIMS, flash_attention, flash_attention_diff,
                  launch_counts, mha, reset_launch_counts, takes_tensor_cores)
from .ref import attention_ref, attention_tc_ref

__all__ = ["LAUNCHES", "TC_HEAD_DIMS", "attention_ref", "attention_tc_ref", "flash_attention",
           "flash_attention_diff", "launch_counts", "mha", "reset_launch_counts",
           "takes_tensor_cores"]
