"""Training substrate of the port: the synthetic data pipeline, AdamW,
the train and eval steps, checkpoints and the fault-tolerant loop."""
from .checkpoint import CheckpointManager
from .data import SyntheticLM
from .loop import LoopConfig, LoopReport, run_training
from .optimizer import (
    AdamWConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    schedule,
)
from .steps import build_eval_step, build_train_step, loss_and_grads

__all__ = [
    "AdamWConfig", "CheckpointManager", "LoopConfig", "LoopReport",
    "SyntheticLM", "adamw_update", "build_eval_step", "build_train_step",
    "global_norm", "init_opt_state", "loss_and_grads", "run_training",
    "schedule",
]
