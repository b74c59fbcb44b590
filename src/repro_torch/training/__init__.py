"""Training substrate: optimizer, train step, its CUDA graph,
checkpointing."""
from . import checkpoint, graphs, optimizer, trainer
from .graphs import TrainStepGraph
from .optimizer import (AdamWConfig, adamw_update, cosine_schedule,
                        init_opt_state, wsd_schedule)
from .trainer import init_train_state, make_train_step, train_state_specs

__all__ = [
    "checkpoint", "graphs", "optimizer", "trainer", "TrainStepGraph",
    "AdamWConfig", "adamw_update",
    "cosine_schedule", "init_opt_state", "wsd_schedule", "init_train_state",
    "make_train_step", "train_state_specs",
]
