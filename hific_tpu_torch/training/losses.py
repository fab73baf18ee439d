"""Losses of the compression stage; counterpart of the JAX package's
`training/losses.py` (`distortion_loss`, `weighted_rate_loss`,
`compression_loss`). The GAN losses belong to the GAN stage.

The rate penalty is a `torch.where` on the device: no host read of the
quantized rate per step.
"""

import torch

from hific_tpu_torch.training.schedules import scheduled_param


def distortion_loss(x_gen, x_real):
    """MSE in [0, 255]."""
    return torch.mean(torch.square(x_gen * 255.0 - x_real * 255.0))


def weighted_rate_loss(config, total_nbpp, total_qbpp, step: int,
                       ignore_schedule: bool = False):
    """The noisy rate weighted by lambda_A where the quantized rate exceeds
    the scheduled target, else by lambda_B: (weighted rate, penalty)."""
    lambda_a = scheduled_param(config.lambda_A, config.lambda_schedule, step,
                               ignore_schedule)
    lambda_b = scheduled_param(config.lambda_B, config.lambda_schedule, step,
                               ignore_schedule)
    target_bpp = scheduled_param(config.target_rate, config.target_schedule,
                                 step, ignore_schedule)
    rate_penalty = torch.where(total_qbpp > target_bpp, lambda_a, lambda_b)
    return rate_penalty * total_nbpp, rate_penalty


def compression_loss(config, intermediates, lpips_fn, step: int,
                     ignore_schedule: bool = False):
    """k_M * MSE + k_P * LPIPS + weighted rate: (loss, diagnostics).

    lpips_fn: (x_gen, x_real) -> per-image LPIPS, or None to leave the
    perceptual term out.
    """
    x_real = intermediates.input_image
    x_gen = intermediates.reconstruction
    if config.normalize_input_image:
        x_real = (x_real + 1.0) / 2.0
        x_gen = (x_gen + 1.0) / 2.0

    dist = distortion_loss(x_gen, x_real)
    if lpips_fn is not None:
        percep = torch.mean(lpips_fn(x_gen, x_real))
    else:
        percep = torch.zeros((), device=dist.device)

    weighted_distortion = config.k_M * dist
    weighted_perceptual = config.k_P * percep
    weighted_rate, rate_penalty = weighted_rate_loss(
        config, intermediates.n_bpp, intermediates.q_bpp, step,
        ignore_schedule)

    loss = weighted_rate + weighted_distortion + weighted_perceptual
    diagnostics = {
        "distortion": dist,
        "perceptual": percep,
        "rate_penalty": rate_penalty,
        "n_rate": intermediates.n_bpp,
        "q_rate": intermediates.q_bpp,
        "weighted_rate": weighted_rate,
        "weighted_distortion": weighted_distortion,
        "weighted_perceptual": weighted_perceptual,
        "weighted_R_D": weighted_rate + weighted_distortion,
        "weighted_compression_loss_sans_G": loss,
    }
    return loss, diagnostics
