"""Training: MultiBox loss, train state (EMA), optimizer, train step/loop."""

from multibox_tpu_torch.train.loss import multibox_loss
from multibox_tpu_torch.train.state import TrainState, create_train_state, make_train_step

__all__ = ["multibox_loss", "TrainState", "create_train_state", "make_train_step"]
