"""Training of the port: the stage-1 and stage-2 steps and the epoch loop
(``train.loop``), the StepLR and lambda schedules (``train.schedulers``) and
checkpoints (``train.checkpoint``)."""

from sttode_tpu_torch.train.checkpoint import (checkpoint_epochs,
                                               checkpoint_path,
                                               latest_checkpoint,
                                               load_checkpoint,
                                               save_checkpoint)
from sttode_tpu_torch.train.loop import (SamplerTrainStep, TrainStep,
                                         make_sampler_train_step,
                                         make_train_step, train_epoch)
from sttode_tpu_torch.train.schedulers import lambda_lr, set_lr, step_lr

__all__ = ["SamplerTrainStep", "TrainStep", "checkpoint_epochs",
           "checkpoint_path", "latest_checkpoint", "lambda_lr",
           "load_checkpoint", "make_sampler_train_step", "make_train_step",
           "save_checkpoint", "set_lr", "step_lr", "train_epoch"]
