"""Training substrate: optimizer, train step, checkpointing, compression
(the JAX package's ``repro.train``)."""
from .checkpoint import AsyncCheckpointer, latest_step, restore, save
from .compress import (CompressState, compressed_psum, ef_compress_grads,
                       init_compress_state)
from .optimizer import (AdamWConfig, OptState, adamw_update, init_opt_state,
                        lr_schedule)
from .train_step import make_train_step

__all__ = ["AdamWConfig", "AsyncCheckpointer", "CompressState", "OptState",
           "adamw_update", "compressed_psum", "ef_compress_grads",
           "init_compress_state", "init_opt_state", "latest_step",
           "lr_schedule", "make_train_step", "restore", "save"]
