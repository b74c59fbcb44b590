"""Hand-written CUDA kernels for NVIDIA Hopper: one per TPU kernel of the
serving path, and the backwards of flash attention and the RG-LRU scan
that training needs (the reference differentiates those in plain JAX).

Each subpackage's ``ops.py`` holds the wrapper (launches the kernel from
``csrc/`` on a CUDA tensor, counts its launches, raises on what the
kernel does not take) and the plain PyTorch version of the same function
(taken for a CPU tensor, and the yardstick a kernel is held against on
the card).  ``_build`` compiles the sources with ``nvcc`` for ``sm_90a``
at first use.
"""
from .flash_attention.ops import (flash_attention, flash_attention_bwd,
                                  flash_attention_bwd_plain,
                                  flash_attention_plain)
from .decode_attention.ops import decode_attention, decode_attention_plain
from .rglru_scan.ops import (rglru_scan, rglru_scan_bwd, rglru_scan_bwd_plain,
                             rglru_scan_plain)
from .moe_gating.ops import moe_gating, moe_gating_plain

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "decode_attention",
           "decode_attention_plain", "rglru_scan", "rglru_scan_plain",
           "rglru_scan_bwd", "rglru_scan_bwd_plain", "moe_gating",
           "moe_gating_plain"]
