"""sttode_tpu_torch — the PyTorch/CUDA port of ``sttode_tpu``: serving and
training of both stages.

The JAX package ``sttode_tpu`` stays the reference; this package mirrors its
module paths, public names and parameter layouts so that the same weights
(carried by ``bridge.params_from_jax``) give the same forecasts.

What is ported: best-of-K inference (``models.sttode.sttode_inference``) and
the ``serving.Predictor`` around it; the stage-1 CVAE training step
(``models.sttode.sttode_forward``, ``train.make_train_step``: autograd over
every parameter leaf, then Adam); the reference's recipes around it — the
ETH-UCY (with its C++ windowing engine, ``native``), SDD and NBA loaders
(``data``), bucketed scene batching and a prefetch thread, StepLR
(``train.schedulers``), checkpoints (``train.checkpoint``), the best-of-K
and horizon-table evaluations (``evaluation``) and the CLIs
``python -m sttode_tpu_torch.cli.train`` / ``cli.test``; and stage 2, the
DLow diversity sampler over the frozen stage-1 net
(``models.sampler``: ``sampler_forward`` and its KL and diversity losses;
``train.make_sampler_train_step``, Adam over the sampler's leaves only;
the lambda decay ``train.schedulers.lambda_lr``), its CLIs
``cli.trainsampler`` / ``cli.test_sampler`` and
``Predictor(sampler_params=, sampler_cfg=)``. Stage 2 runs the encoder's
attention kernels forward only (the frozen net takes no gradient) and
decodes in plain PyTorch, as the JAX package does. The model's options
ride on every path: the ODE encoder's solvers (``ode``: the fixed grid,
adaptive dopri5 in its while and scan-budget forms, the continuous adjoint
``odeint_adjoint``; ``--ode_method dopri5 --ode_adjoint``), the learned
prior (``learn_prior``) and encoder-layer dropout (``dropout``, the plain
attention path); ``cli.trainvae`` trains the VAE-only objective. The
training options ride on the CLIs: ``--supervise`` (``train.supervisor``:
divergence detection and an in-place rollback to the last-good
checkpoint), ``--profile_dir`` (``utils.profiling.trace``), ``cli.test
--save_plots`` (``utils.visualize``), the gradient guards and guarded
Adam (``train.guards``), ``ReduceOnPlateau`` and ``ExpParamAnnealer``. The
decoder side, which the model never instantiates, is ported too
(``nn.transformer.decoder_layer`` / ``decoder_stack``,
``nn.ode_block.ode_decoder``, ``mhgsa``'s ``bias_kv`` and
``add_zero_attn``).
Hand-written CUDA kernels carry these paths on an NVIDIA Hopper card:

- ``kernels.mhgsa.fused_geodesic_attention`` — whole-S geodesic attention,
  forward and backward (a ``torch.autograd.Function``);
- ``kernels.mhgsa.flash_geodesic_attention`` — the same S-tiled, with key
  validity, for any context length (the scene axis beyond 1036 scenes):
  forward, and a backward in two sweeps (dq; dk and dv);
- ``kernels.packed_mhgsa.packed_geodesic_attention`` — the same for many
  small problems (L·S ≤ 32²) with key validity, forward and backward;
- ``kernels.select_decode.select_decode`` — the whole two-block decompose
  decode of all K samples, in fp32 or bf16 storage.

The entry points (``Predictor``, ``make_train_step``,
``make_sampler_train_step``, the CLIs) run on the card unless the caller
passes ``device="cpu"`` (``--device cpu``).

On CPU tensors every kernel wrapper runs its plain PyTorch version instead;
on CUDA tensors it launches the kernel or raises. Importing this package
builds nothing and needs no CUDA compiler: the kernels are compiled with
``nvcc`` at their first launch (``kernels._build``).

This package never imports ``jax`` or ``sttode_tpu``.
"""

from sttode_tpu_torch.models.sampler import (SamplerConfig, sampler_forward,
                                             sampler_init)
from sttode_tpu_torch.models.sttode import (Batch, STTODEConfig,
                                            sttode_forward, sttode_inference,
                                            sttode_init)
from sttode_tpu_torch.serving import Predictor
from sttode_tpu_torch.train import (make_sampler_train_step, make_train_step,
                                    train_epoch)

__all__ = ["Batch", "Predictor", "STTODEConfig", "SamplerConfig",
           "make_sampler_train_step", "make_train_step", "sampler_forward",
           "sampler_init", "sttode_forward", "sttode_inference", "sttode_init",
           "train_epoch"]
