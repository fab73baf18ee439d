"""Quantization relaxations and entropy bookkeeping; counterpart of the JAX
package's `ops/quantize.py`.

The noise comes from an explicit `torch.Generator` on the tensor's device
(the JAX package takes a PRNG key); the two give different numbers from one
seed, so tests hand both the same noise.
"""

import math
from typing import Optional, Sequence, Tuple

import torch

LOG2_E = 1.0 / math.log(2.0)


def quantize_noise(x: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """x + U(-1/2, 1/2) noise, the training relaxation of rounding. The
    noise takes x's memory layout."""
    return x + torch.empty_like(x).uniform_(-0.5, 0.5, generator=generator)


def quantize_round(x: torch.Tensor, means: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """floor(x + 1/2), optionally around `means`."""
    if means is not None:
        return torch.floor(x - means + 0.5) + means
    return torch.floor(x + 0.5)


def quantize_ste(x: torch.Tensor, means: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Straight-through rounding: the forward rounds, the gradient is the
    identity."""
    if means is not None:
        v = x - means
        return v + (torch.floor(v + 0.5) - v).detach() + means
    return x + (torch.floor(x + 0.5) - x).detach()


def estimate_entropy(likelihood: torch.Tensor, spatial_shape: Sequence[int],
                     eps: float = 1e-9) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bits per batch element, bpp) from per-element likelihoods; bpp is
    normalized by the ORIGINAL image's pixel count."""
    batch_size = likelihood.shape[0]
    n_pixels = float(math.prod(spatial_shape))
    n_bits = torch.sum(torch.log(likelihood + eps)) * (-LOG2_E) / batch_size
    return n_bits, n_bits / n_pixels


def estimate_entropy_log(log_likelihood: torch.Tensor,
                         spatial_shape: Sequence[int]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`estimate_entropy` from log-likelihoods (the DLMM hyperprior's)."""
    batch_size = log_likelihood.shape[0]
    n_pixels = float(math.prod(spatial_shape))
    n_bits = torch.sum(log_likelihood) * (-LOG2_E) / batch_size
    return n_bits, n_bits / n_pixels
