"""Training steps and train state of the compression stage; counterpart of
the JAX package's `training/train_step.py` (`create_train_state`,
`make_optimizers`, `ingest_batch`, `make_train_step_g`, `make_eval_step`).

Two optimizer groups, as in the JAX package's `optax.multi_transform`:
`hyper` (the parameters of the hyperlatent density) and `amort` (every
other codec parameter), each Adam with b1 0.9, b2 0.999, eps 1e-8 and the
piecewise-constant learning-rate schedule of the step counter. One
`torch.optim.Adam` with two parameter groups computes the same updates.
`Config.weight_decay` is not applied: `optax.adam` ignores it too.

Unlike the JAX package's pure functions, a step updates the state in place
(parameters, optimizer moments, step counter, noise generator): it saves
a copy of every parameter and moment per step. Each step runs with TF32
off (`runtime.fp32_numerics`), the fp32 arithmetic the CPU parity tests
hold. The GAN stage (discriminator, `train_step_d`) is not ported yet.
"""

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from hific_tpu_torch.config import Config
from hific_tpu_torch.models.hific import HiFiC, init_random_
from hific_tpu_torch.runtime import fp32_numerics, resolve_device
from hific_tpu_torch.training.losses import compression_loss
from hific_tpu_torch.training.schedules import scheduled_param

ADAM = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
HYPER_PREFIX = "hyperprior.hyperlatent_density."


@dataclasses.dataclass
class TrainState:
    step: int                        # generator steps taken
    model: HiFiC
    optimizer: torch.optim.Adam      # param groups 'amort' and 'hyper'
    generator: torch.Generator       # quantization noise, on the device


def _require_compression(config: Config) -> None:
    if config.use_discriminator:
        raise NotImplementedError("hific_tpu_torch trains the compression "
                                  "stage only; the GAN stage is not ported "
                                  "yet")


def make_optimizers(config: Config, model: HiFiC) -> torch.optim.Adam:
    amort, hyper = [], []
    for name, p in model.named_parameters():
        (hyper if name.startswith(HYPER_PREFIX) else amort).append(p)
    return torch.optim.Adam(
        [{"params": amort, "name": "amort"},
         {"params": hyper, "name": "hyper"}],
        lr=scheduled_param(config.learning_rate, config.lr_schedule, 0,
                           config.ignore_schedule), **ADAM)


def create_train_state(config: Config, seed: int = 0, device=None
                       ) -> TrainState:
    """Seeded random weights (`init_random_`) on `device` (the card unless
    named), fresh Adam moments, step 0."""
    _require_compression(config)
    device = resolve_device(device)
    model = init_random_(HiFiC(config), torch.Generator().manual_seed(seed))
    model = model.to(device, memory_format=torch.channels_last)
    noise = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(0, model, make_optimizers(config, model), noise)


def ingest_batch(x, config: Config, device) -> torch.Tensor:
    """NHWC uint8 (numpy or tensor) -> NCHW channels-last float32 on
    `device` in [0, 1] (or [-1, 1] with normalize_input_image), the values
    the JAX package's `ingest_batch` makes. Float batches pass unchanged."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    x = x.to(device)
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) / 255.0
        if config.normalize_input_image:
            x = x * 2.0 - 1.0
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def make_train_step_g(config: Config, lpips_fn: Optional[Callable] = None):
    """Compression step: gradients of the compression loss w.r.t. the codec
    parameters, one Adam update of both groups, step += 1. Returns
    step_fn(state, x) -> diagnostics (device tensors, no host read)."""
    _require_compression(config)

    def step_fn(state: TrainState, x):
        with fp32_numerics(deterministic=False):
            x = ingest_batch(x, config, _device(state))
            state.model.train()
            state.optimizer.zero_grad(set_to_none=True)
            intermediates, _ = state.model(x, state.generator, training=True)
            loss, diagnostics = compression_loss(
                config, intermediates, lpips_fn, state.step,
                config.ignore_schedule)
            diagnostics["weighted_compression_loss"] = loss
            loss.backward()
            lr = scheduled_param(config.learning_rate, config.lr_schedule,
                                 state.step, config.ignore_schedule)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in diagnostics.items()}

    return step_fn


def make_eval_step(config: Config, lpips_fn: Optional[Callable] = None):
    """Validation forward: eval_fn(state, x, generator) -> (diagnostics,
    intermediates), with rounded hyperlatents and no update."""

    def eval_fn(state: TrainState, x, generator: torch.Generator):
        with fp32_numerics(deterministic=False), torch.no_grad():
            x = ingest_batch(x, config, _device(state))
            state.model.eval()
            intermediates, _ = state.model(x, generator, training=False)
            loss, diagnostics = compression_loss(
                config, intermediates, lpips_fn, state.step,
                config.ignore_schedule)
            diagnostics["weighted_compression_loss"] = loss
        return diagnostics, intermediates

    return eval_fn
