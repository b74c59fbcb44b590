"""Model substrate: config-driven decoder (attention, RG-LRU and MoE
blocks) with the hand-written kernels, and the weight conversion from the
JAX reference."""
from . import convert, layers, moe, recurrent, transformer
from .convert import params_from_numpy
from .transformer import (
    cast_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "convert", "layers", "moe", "recurrent", "transformer", "params_from_numpy", "cast_params",
    "decode_step", "forward", "init_cache", "init_params", "prefill",
]
