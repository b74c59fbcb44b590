"""Hand-written CUDA kernels for NVIDIA Hopper, one per TPU kernel of the
serving path.

Each subpackage's ``ops.py`` holds the wrapper (launches the kernel from
``csrc/`` on a CUDA tensor, counts its launches, raises on what the
kernel does not take) and the plain PyTorch version of the same function
(taken for a CPU tensor, and the yardstick a kernel is held against on
the card).  ``_build`` compiles the sources with ``nvcc`` for ``sm_90a``
at first use.  The MoE-gating and RG-LRU scan kernels are still to be
ported.
"""
from .flash_attention.ops import flash_attention, flash_attention_plain
from .decode_attention.ops import decode_attention, decode_attention_plain

__all__ = ["flash_attention", "flash_attention_plain", "decode_attention",
           "decode_attention_plain"]
