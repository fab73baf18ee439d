"""Quantization relaxations and entropy bookkeeping; counterpart of the JAX
package's `ops/quantize.py`.

The noise comes from an explicit `torch.Generator` on the tensor's device
(the JAX package takes a PRNG key); the two give different numbers from one
seed, so tests hand both the same noise.

Under data parallelism (`batch_shard`) every draw covers the GLOBAL batch
and the rank keeps its rows: the noise of a data-parallel step is the
single-process step's on the same global batch, and every rank's
generator advances as the single process's does, so the ranks' generators
stay identical and a checkpoint of any of them resumes the run exactly.
The cost is one global batch of noise per draw on every rank.
"""

import contextlib
import contextvars
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

LOG2_E = 1.0 / math.log(2.0)

# (index, count): this process holds shard `index` of `count` equal shards
# of the batch; None outside a data-parallel step.
_BATCH_SHARD = contextvars.ContextVar("hific_batch_shard", default=None)


@contextlib.contextmanager
def batch_shard(index: int, count: int):
    """Within the block, noise draws (`quantize_noise`, the generator's
    `sample_noise`) are the global batch's rows of shard `index` of
    `count`."""
    token = _BATCH_SHARD.set((index, count))
    try:
        yield
    finally:
        _BATCH_SHARD.reset(token)


def current_batch_shard() -> Optional[Tuple[int, int]]:
    return _BATCH_SHARD.get()


def draw_like(x: torch.Tensor, fill: Callable[[torch.Tensor], None]
              ) -> torch.Tensor:
    """A tensor of x's shape and memory layout filled in place by `fill`
    (a random draw); inside `batch_shard` the draw is made for the global
    batch, laid out as the single process's would be, and this shard's
    rows are returned."""
    shard = _BATCH_SHARD.get()
    if shard is None:
        out = torch.empty_like(x)
        fill(out)
        return out
    index, count = shard
    n = x.shape[0]
    layout = (torch.channels_last
              if x.dim() == 4 and not x.is_contiguous()
              and x.is_contiguous(memory_format=torch.channels_last)
              else torch.contiguous_format)
    full = torch.empty((n * count,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device, memory_format=layout)
    fill(full)
    return full[index * n:(index + 1) * n]


def quantize_noise(x: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """x + U(-1/2, 1/2) noise, the training relaxation of rounding. The
    noise takes x's memory layout."""
    return x + draw_like(x, lambda t: t.uniform_(-0.5, 0.5,
                                                 generator=generator))


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
