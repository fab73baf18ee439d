"""Training losses; counterpart of the JAX package's `training/losses.py`
(`distortion_loss`, `weighted_rate_loss`, `compression_loss`, and the GAN
losses `non_saturating_gan_loss`, `least_squares_gan_loss`, `gan_loss`).

The rate penalty is a `torch.where` on the device: no host read of the
quantized rate per step. It branches on the batch's mean quantized rate;
under data parallelism the caller hands `compression_loss` the
all-reduced mean of the global batch (`branch_qbpp`), the value the JAX
package's SPMD step computes, so every rank takes the same branch.
"""

import torch
import torch.nn.functional as F

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


def non_saturating_gan_loss(d_real_logits, d_gen_logits):
    """(D loss, G loss) from the logits: mean sigmoid cross-entropies, as
    optax's `sigmoid_binary_cross_entropy` averaged."""
    bce = F.binary_cross_entropy_with_logits
    d_loss = (bce(d_real_logits, torch.ones_like(d_real_logits))
              + bce(d_gen_logits, torch.zeros_like(d_gen_logits)))
    g_loss = bce(d_gen_logits, torch.ones_like(d_gen_logits))
    return d_loss, g_loss


def least_squares_gan_loss(d_real, d_gen):
    """(D loss, G loss) from the probabilities."""
    d_loss = 0.5 * (torch.mean(torch.square(d_real - 1.0))
                    + torch.mean(torch.square(d_gen)))
    g_loss = 0.5 * torch.mean(torch.square(d_gen - 1.0))
    return d_loss, g_loss


def gan_loss(gan_loss_type: str, disc_out):
    if gan_loss_type == "non_saturating":
        return non_saturating_gan_loss(disc_out.d_real_logits,
                                       disc_out.d_gen_logits)
    if gan_loss_type == "least_squares":
        return least_squares_gan_loss(disc_out.d_real, disc_out.d_gen)
    raise ValueError(f"Invalid GAN loss {gan_loss_type}")


def compression_loss(config, intermediates, lpips_fn, step: int,
                     ignore_schedule: bool = False, branch_qbpp=None):
    """k_M * MSE + k_P * LPIPS + weighted rate: (loss, diagnostics).

    lpips_fn: (x_gen, x_real) -> per-image LPIPS, or None to leave the
    perceptual term out. branch_qbpp: the quantized rate the penalty's
    branch reads (the global batch's all-reduced mean under data
    parallelism); `intermediates.q_bpp` when None.
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
        config, intermediates.n_bpp,
        intermediates.q_bpp if branch_qbpp is None else branch_qbpp, step,
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
