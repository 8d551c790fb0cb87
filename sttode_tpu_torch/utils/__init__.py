"""Utilities of the port: distributions, metrics and the NBA horizon table
(``utils.metrics``), logging, flat parameter views (``utils.flat_params``),
tracing, timing and the parameter table (``utils.profiling``) and
trajectory plots (``utils.visualize``, matplotlib imported at the first
plot), δ-hyperbolicity (``utils.delta``) and the analysis toolbox
(``utils.analysis``)."""

from sttode_tpu_torch.utils.distributions import DiagNormal, RelaxedOneHot
from sttode_tpu_torch.utils.logging import Logger, print_log
from sttode_tpu_torch.utils.metrics import (AverageMeter, best_sample_indices,
                                            compute_ade, compute_fde,
                                            count_miss_samples)

__all__ = ["DiagNormal", "RelaxedOneHot", "Logger", "print_log",
           "AverageMeter", "best_sample_indices", "compute_ade",
           "compute_fde", "count_miss_samples"]
