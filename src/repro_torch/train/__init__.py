"""Training substrate: optimizer, steps, checkpointing, on one device or a
mesh (``sharded``)."""
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                     make_train_step, xent_loss)
from repro_torch.train import checkpoint

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "make_train_step",
           "make_prefill_step", "make_decode_step", "xent_loss", "checkpoint"]
