"""Model substrate: config-driven decoder with the hand-written attention
kernels, and the weight conversion from the JAX reference."""
from . import convert, layers, transformer
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
    "convert", "layers", "transformer", "params_from_numpy", "cast_params",
    "decode_step", "forward", "init_cache", "init_params", "prefill",
]
