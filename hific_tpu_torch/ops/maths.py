"""Maths of the bottleneck: lower bounds with their gradient rules, CDFs,
quantiles and the PMF -> integer-CDF quantizer of the entropy coder.

Counterpart of the JAX package's `ops/maths.py`. The two lower bounds are
`torch.autograd.Function`s with the gradient rules of the JAX package's
`custom_vjp`s, so the density and the scale bound train as they do there.
"""

import math

import numpy as np
import scipy.stats
import torch

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


class _LowerBoundIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _LowerBoundToward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x >= bound)
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (above,) = ctx.saved_tensors
        return g * (above | (g < 0)).to(g.dtype), None


def lower_bound_identity(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound); the gradient passes through unchanged."""
    return _LowerBoundIdentity.apply(x, bound)


def lower_bound_toward(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound); the gradient passes where x >= bound, or where it is
    negative (a descent step then pushes x up toward the bound)."""
    return _LowerBoundToward.apply(x, bound)


def standardized_cdf_gaussian(value: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF in erfc form, stable in the left tail."""
    return 0.5 * torch.special.erfc(value * (-_INV_SQRT2))


def standardized_cdf_logistic(value: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(value)


def standardized_quantile_gaussian(quantile):
    return scipy.stats.norm.ppf(quantile)


def standardized_quantile_logistic(quantile):
    return scipy.stats.logistic.ppf(quantile)


def quantile_gaussian(quantile, mean, scale):
    return scipy.stats.norm.ppf(quantile, loc=mean, scale=scale)


def quantile_logistic(quantile, mean, scale):
    return scipy.stats.logistic.ppf(quantile, loc=mean, scale=scale)


def pmf_to_quantized_cdf(pmf, precision: int) -> np.ndarray:
    """Quantize a PMF to an integer CDF summing exactly to 2**precision.

    Rounds the scaled cumulative sum; where that zeroes a symbol of nonzero
    probability, one unit of frequency is taken from the currently smallest
    symbol with frequency > 1. Returns int32 of length len(pmf) + 1, with
    cdf[0] == 0 and cdf[-1] == 1 << precision, non-decreasing.
    """
    pmf = np.asarray(pmf, dtype=np.float64)
    if precision < 8:
        raise ValueError("precision should be in [8, 32]")
    if pmf.ndim != 1 or pmf.shape[0] < 2:
        raise ValueError("pmf must be 1-D with at least 2 entries")
    if np.any(np.isnan(pmf)) or np.any(pmf < 0.0):
        raise ValueError("pmf must be non-negative and free of NaNs")

    target_total = 1 << precision
    cdf = np.zeros(pmf.shape[0] + 1, dtype=np.float64)
    cdf[1:] = np.cumsum(pmf)
    cdf = np.round(cdf * target_total / cdf[-1]).astype(np.int64)

    for i in range(len(cdf) - 1):
        if cdf[i] == cdf[i + 1]:
            freqs = cdf[1:] - cdf[:-1]
            candidates = np.where(freqs > 1)[0]
            if candidates.size == 0:
                raise ValueError("no frequency available to steal")
            best_steal = candidates[np.argmin(freqs[candidates])]
            if best_steal < i:
                cdf[best_steal + 1: i + 1] -= 1
            else:
                cdf[i + 1: best_steal + 1] += 1

    if cdf[0] != 0 or cdf[-1] != target_total or np.any(np.diff(cdf) < 0):
        raise ValueError("CDF normalization error")
    return cdf.astype(np.int32)
