"""Training steps and train state; counterpart of the JAX package's
`training/train_step.py` (`create_train_state`, `make_optimizers`,
`ingest_batch`, `make_train_step_g`, `make_train_step_d`,
`make_eval_step`).

Two optimizer groups, as in the JAX package's `optax.multi_transform`:
`hyper` (the parameters of the hyperlatent density) and `amort` (every
other codec parameter), each Adam with b1 0.9, b2 0.999, eps 1e-8 and the
piecewise-constant learning-rate schedule of the step counter. One
`torch.optim.Adam` with two parameter groups computes the same updates.
`Config.weight_decay` is not applied: `optax.adam` ignores it too.

The GAN stage (`config.use_discriminator`) adds the discriminator with its
own Adam, whose learning rate follows the schedule at the count of
discriminator steps, as `optax.adam(lr_schedule)` reads its own count:
after a warmstart from step 500,000 the generator's rate is 1e-5 and the
discriminator's 1e-4. A G step adds beta * G loss and steps the codec
only; a D step runs the codec forward without gradient on its own batch
and steps the discriminator only; only G steps move `state.step`.

Under `dtype="bfloat16"` the step's convs run in bfloat16, and each Adam
moment takes its parameter's dtype, as optax's does: the transposed convs'
parameters and moments are bfloat16, every other leaf float32. The DLMM
variant's rate terms come from its hyperprior (`HyperpriorDLMM`), and
`sample_noise` draws the generator's noise from the state's generator
after the quantization noise.

Unlike the JAX package's pure functions, a step updates the state in place
(parameters, optimizer moments, counters, noise generator, the
discriminator's `u`): it saves a copy of every parameter and moment per
step. Each step runs with TF32 off (`runtime.fp32_numerics`, in either
dtype), the arithmetic the CPU parity tests hold.
"""

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from hific_tpu_torch.config import Config
from hific_tpu_torch.models.discriminator import Discriminator
from hific_tpu_torch.models.hific import (
    HiFiC,
    discriminator_forward,
    init_random_,
)
from hific_tpu_torch.models.layers import compute_dtype
from hific_tpu_torch.runtime import fp32_numerics, resolve_device
from hific_tpu_torch.training.losses import compression_loss, gan_loss
from hific_tpu_torch.training.schedules import scheduled_param

ADAM = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
HYPER_PREFIX = "hyperprior.hyperlatent_density."


@dataclasses.dataclass
class TrainState:
    step: int                        # generator steps taken
    model: HiFiC
    optimizer: torch.optim.Adam      # param groups 'amort' and 'hyper'
    generator: torch.Generator       # quantization noise, on the device
    # The GAN stage's; None (and 0) in the compression stage.
    disc: Optional[Discriminator] = None
    disc_optimizer: Optional[torch.optim.Adam] = None
    disc_steps: int = 0              # discriminator steps taken


def _lr(config: Config, count: int) -> float:
    return scheduled_param(config.learning_rate, config.lr_schedule, count,
                           config.ignore_schedule)


def make_optimizers(config: Config, model: HiFiC) -> torch.optim.Adam:
    amort, hyper = [], []
    for name, p in model.named_parameters():
        (hyper if name.startswith(HYPER_PREFIX) else amort).append(p)
    return torch.optim.Adam(
        [{"params": amort, "name": "amort"},
         {"params": hyper, "name": "hyper"}], lr=_lr(config, 0), **ADAM)


def make_disc_optimizer(config: Config, disc: Discriminator
                        ) -> torch.optim.Adam:
    return torch.optim.Adam(disc.parameters(), lr=_lr(config, 0), **ADAM)


def create_train_state(config: Config, seed: int = 0, device=None
                       ) -> TrainState:
    """Seeded random weights (`init_random_`; the discriminator's, in the
    GAN stage, drawn after the codec's from the same generator) on
    `device` (the card unless named), fresh Adam moments, step 0."""
    device = resolve_device(device)
    weights = torch.Generator().manual_seed(seed)
    model = init_random_(HiFiC(config), weights)
    model = model.to(device, memory_format=torch.channels_last)
    noise = torch.Generator(device=device).manual_seed(seed + 1)
    state = TrainState(0, model, make_optimizers(config, model), noise)
    if config.use_discriminator:
        disc = init_random_(Discriminator(config.effective_latent_channels,
                                          compute_dtype(config.dtype)),
                            weights)
        state.disc = disc.to(device, memory_format=torch.channels_last)
        state.disc_optimizer = make_disc_optimizer(config, state.disc)
    return state


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


def _set_lr(optimizer: torch.optim.Adam, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def make_train_step_g(config: Config, lpips_fn: Optional[Callable] = None):
    """Generator/compression step: gradients of the compression loss (plus
    beta * G loss in the GAN stage, through the discriminator, whose `u`
    advances) w.r.t. the codec parameters, one Adam update of both groups,
    step += 1. No discriminator gradient is computed or left in `.grad`.
    Returns step_fn(state, x) -> diagnostics (device tensors, no host
    read)."""

    def step_fn(state: TrainState, x):
        with fp32_numerics(deterministic=False):
            x = ingest_batch(x, config, _device(state))
            state.model.train()
            state.optimizer.zero_grad(set_to_none=True)
            intermediates, _ = state.model(x, state.generator, training=True)
            loss, diagnostics = compression_loss(
                config, intermediates, lpips_fn, state.step,
                config.ignore_schedule)
            if config.use_discriminator:
                # The graph is built without the discriminator's leaves.
                state.disc_optimizer.zero_grad(set_to_none=True)
                state.disc.requires_grad_(False)
                try:
                    disc_out = discriminator_forward(
                        intermediates, state.disc, train_generator=True)
                finally:
                    state.disc.requires_grad_(True)
                _, g_loss = gan_loss(config.gan_loss_type, disc_out)
                loss = loss + config.beta * g_loss
                diagnostics["gen_loss"] = g_loss
                diagnostics["weighted_gen_loss"] = config.beta * g_loss
            diagnostics["weighted_compression_loss"] = loss
            loss.backward()
            _set_lr(state.optimizer, _lr(config, state.step))
            state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in diagnostics.items()}

    return step_fn


def make_train_step_d(config: Config):
    """Discriminator step on its own batch: the codec forward without
    gradient (fresh quantization noise from the state's generator), then
    the gradients of the D loss w.r.t. the discriminator's parameters
    only, one Adam update at the schedule's rate for the count of D steps.
    `state.step` does not move. Returns step_fn(state, x) -> diagnostics
    (`disc_loss`, `D_real`, `D_gen`; device tensors)."""
    if not config.use_discriminator:
        raise ValueError(f"model_type {config.model_type!r} has no "
                         f"discriminator")

    def step_fn(state: TrainState, x):
        with fp32_numerics(deterministic=False):
            x = ingest_batch(x, config, _device(state))
            state.model.train()
            with torch.no_grad():
                intermediates, _ = state.model(x, state.generator,
                                               training=True)
            state.disc_optimizer.zero_grad(set_to_none=True)
            disc_out = discriminator_forward(intermediates, state.disc,
                                             train_generator=False)
            d_loss, _ = gan_loss(config.gan_loss_type, disc_out)
            d_loss.backward()
            _set_lr(state.disc_optimizer, _lr(config, state.disc_steps))
            state.disc_optimizer.step()
        state.disc_steps += 1
        return {"disc_loss": d_loss.detach(),
                "D_real": torch.mean(disc_out.d_real.detach()),
                "D_gen": torch.mean(disc_out.d_gen.detach())}

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
