"""Training: optimizers, the train step, checkpoints and fault handling."""
from .checkpoint import Checkpointer, latest_step, restore_checkpoint, save_checkpoint
from .fault import PreemptionGuard, StepWatchdog
from .optimizer import OptConfig, apply_updates, cosine_lr, global_norm, init_opt_state
from .train_step import TrainConfig, grads_of, loss_fn, make_train_step

__all__ = [
    "Checkpointer", "latest_step", "restore_checkpoint", "save_checkpoint",
    "PreemptionGuard", "StepWatchdog",
    "OptConfig", "apply_updates", "cosine_lr", "global_norm", "init_opt_state",
    "TrainConfig", "grads_of", "loss_fn", "make_train_step",
]
