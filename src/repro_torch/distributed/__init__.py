"""Distribution substrate: sharding rules, activation constraints,
pipeline stages (``.pipeline``) and flash-decode (``.flash_decode``)."""
from .context import constrain, use_sharding_rules
from .sharding import (
    batch_pspecs,
    cache_pspecs,
    named,
    param_pspecs,
    state_pspecs,
)

__all__ = [
    "constrain", "use_sharding_rules", "batch_pspecs", "cache_pspecs",
    "named", "param_pspecs", "state_pspecs",
]
