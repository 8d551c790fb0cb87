"""Training of the port: the stage-1 and stage-2 steps, their captured
multi-step form and the epoch loop (``train.loop``, ``train.graph``), the
StepLR, lambda and plateau schedules (``train.schedulers``), checkpoints,
saved in the foreground or the background and pruned (``train.checkpoint``),
the gradient guards and guarded Adam (``train.guards``), Riemannian SGD
over manifold-constrained leaves (``train.riemannian``) and the divergence
supervisor (``train.supervisor``)."""

from sttode_tpu_torch.train.checkpoint import (checkpoint_epochs,
                                               checkpoint_path, flush_saves,
                                               latest_checkpoint,
                                               load_checkpoint,
                                               prune_checkpoints,
                                               restore_shardings,
                                               save_checkpoint,
                                               wait_for_saves)
from sttode_tpu_torch.train.loop import (SamplerTrainStep, TrainStep,
                                         make_sampler_train_step,
                                         make_train_step, stack_batches,
                                         stack_noise, train_epoch)
from sttode_tpu_torch.train.schedulers import (ExpParamAnnealer,
                                               ReduceOnPlateau,
                                               adam_with_schedule, lambda_lr,
                                               set_lr, step_lr)

__all__ = ["ExpParamAnnealer", "ReduceOnPlateau", "SamplerTrainStep",
           "TrainStep", "adam_with_schedule", "checkpoint_epochs",
           "checkpoint_path", "flush_saves", "lambda_lr", "latest_checkpoint",
           "load_checkpoint", "make_sampler_train_step", "make_train_step",
           "prune_checkpoints", "restore_shardings", "save_checkpoint",
           "set_lr", "stack_batches", "stack_noise", "step_lr", "train_epoch",
           "wait_for_saves"]
