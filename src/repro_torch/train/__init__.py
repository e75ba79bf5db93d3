"""The training path of the port (``src/repro/train``): AdamW, the train
and eval steps (over a training mesh too), checkpoints (with the elastic
reshard) and the int8 compressed all-reduce (``compression``)."""
from repro_torch.train.checkpoint import CheckpointManager, tree_specs
from repro_torch.train.compression import (compressed_psum,
                                           make_compressed_allreduce)
from repro_torch.train.optimizer import (OptConfig, OptState, adamw_update,
                                         init_opt_state)
from repro_torch.train.train_step import make_eval_step, make_train_step

__all__ = ["CheckpointManager", "OptConfig", "OptState", "adamw_update",
           "compressed_psum", "init_opt_state", "make_compressed_allreduce",
           "make_eval_step", "make_train_step", "tree_specs"]
