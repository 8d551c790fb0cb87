"""Stage-1 training of the port (``train.loop``)."""

from sttode_tpu_torch.train.loop import TrainStep, make_train_step, train_epoch

__all__ = ["TrainStep", "make_train_step", "train_epoch"]
