"""Model substrate: config-driven decoder (attention with RoPE or M-RoPE,
MLA, RG-LRU, MoE and xLSTM blocks) with the hand-written kernels, the
stub frontends, and the weight conversion from the JAX reference."""
from . import convert, frontends, layers, moe, recurrent, transformer, xlstm
from .convert import params_from_numpy
from .transformer import (
    cast_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
    reset_cache,
)

__all__ = [
    "convert", "frontends", "layers", "moe", "recurrent", "transformer",
    "xlstm",
    "params_from_numpy", "cast_params", "decode_step", "forward",
    "init_cache", "init_params", "prefill", "reset_cache",
]
