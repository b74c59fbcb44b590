"""Training substrate: optimizer, train step, checkpointing."""
from . import checkpoint, optimizer, trainer
from .optimizer import (AdamWConfig, adamw_update, cosine_schedule,
                        init_opt_state, wsd_schedule)
from .trainer import init_train_state, make_train_step, train_state_specs

__all__ = [
    "checkpoint", "optimizer", "trainer", "AdamWConfig", "adamw_update",
    "cosine_schedule", "init_opt_state", "wsd_schedule", "init_train_state",
    "make_train_step", "train_state_specs",
]
