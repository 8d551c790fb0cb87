"""Stage-1 training of the port: the step and the epoch loop (``train.loop``),
the StepLR schedule (``train.schedulers``) and checkpoints
(``train.checkpoint``)."""

from sttode_tpu_torch.train.checkpoint import (checkpoint_epochs,
                                               checkpoint_path,
                                               latest_checkpoint,
                                               load_checkpoint,
                                               save_checkpoint)
from sttode_tpu_torch.train.loop import TrainStep, make_train_step, train_epoch
from sttode_tpu_torch.train.schedulers import set_lr, step_lr

__all__ = ["TrainStep", "checkpoint_epochs", "checkpoint_path",
           "latest_checkpoint", "load_checkpoint", "make_train_step",
           "save_checkpoint", "set_lr", "step_lr", "train_epoch"]
