"""The training path of the port (``src/repro/train``): AdamW, the train
and eval steps, checkpoints.  The reference's ``compression`` (int8
all-reduce) waits for the ``torch.distributed`` backend (ROADMAP.md)."""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (OptConfig, OptState, adamw_update,
                                         init_opt_state)
from repro_torch.train.train_step import make_eval_step, make_train_step

__all__ = ["CheckpointManager", "OptConfig", "OptState", "adamw_update",
           "init_opt_state", "make_train_step", "make_eval_step"]
