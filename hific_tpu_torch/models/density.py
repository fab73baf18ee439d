"""Probability densities of the bottleneck; counterpart of the JAX
package's `models/density.py`.

- `HyperlatentDensity`: the learned non-parametric factorized density over
  hyperlatents (Balle 2018 section 6.1): per channel, a stack of monotone
  1-D maps evaluated for all channels at once as batched matrix products.
- `latent_likelihood`: the boxcar-convolved Gaussian/logistic likelihood of
  the conditional latent prior.
- `dlmm_log_likelihood`: the discretized logistic-mixture log-likelihood of
  the DLMM hyperprior (a training-only estimate).

Both bound their likelihoods with `lower_bound_toward`, whose gradient rule
is the JAX package's, so they train as they do there.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hific_tpu_torch.models.hyper import unpack_likelihood_params
from hific_tpu_torch.ops.maths import (
    lower_bound_toward,
    standardized_cdf_gaussian,
    standardized_cdf_logistic,
)

MIN_SCALE = 0.11
LOG_SCALES_MIN = -3.0
MIN_LIKELIHOOD = 1e-9
TAIL_MASS = 2 ** (-8)
PRECISION_P = 16


def standardized_cdf(likelihood_type: str):
    if likelihood_type == "gaussian":
        return standardized_cdf_gaussian
    if likelihood_type == "logistic":
        return standardized_cdf_logistic
    raise ValueError(f"unknown likelihood model: {likelihood_type}")


def latent_likelihood(x, mean, scale, likelihood_type: str = "gaussian",
                      min_likelihood: float = MIN_LIKELIHOOD):
    """P(round(y) = x | mu, sigma) = CDF(x + 1/2) - CDF(x - 1/2), with both
    CDF arguments folded into the left tail for stability."""
    cdf = standardized_cdf(likelihood_type)
    xc = torch.abs(x - mean)
    cdf_upper = cdf((0.5 - xc) / scale)
    cdf_lower = cdf(-(0.5 + xc) / scale)
    return lower_bound_toward(cdf_upper - cdf_lower, min_likelihood)


def dlmm_log_likelihood(x, dlmm_params, likelihood_type: str = "gaussian",
                        min_likelihood: float = MIN_LIKELIHOOD):
    """Discretized mixture log-likelihood of x (N, C, H, W) under the K
    components of dlmm_params (N, 3 C K, H, W): log sum_k pi_k P_k(x), each
    P_k the boxcar-convolved CDF difference around its mean at its bounded
    log-scale. Returns (N, C, H, W)."""
    cdf = standardized_cdf(likelihood_type)
    x, (logit_pis, means, log_scales), _ = unpack_likelihood_params(
        x, dlmm_params, LOG_SCALES_MIN)
    xc = torch.abs(x - means)
    inv_stds = torch.exp(-log_scales)
    cdf_upper = cdf(inv_stds * (0.5 - xc))
    cdf_lower = cdf(inv_stds * (-0.5 - xc))
    pmf_k = lower_bound_toward(cdf_upper - cdf_lower, min_likelihood)
    lse_in = torch.log_softmax(logit_pis, dim=2) + torch.log(pmf_k)
    return torch.logsumexp(lse_in, dim=2)


class HyperlatentDensity(nn.Module):
    """Factorized density, one univariate model per channel. The CDF logits
    are  logits <- softplus(H_k) @ logits + b_k + tanh(a_k) * tanh(logits)
    with filter widths (1, 3, 3, 3, 1); H_k is (C, f_out, f_in)."""

    def __init__(self, n_channels: int, init_scale: float = 10.0,
                 filters=(3, 3, 3), min_likelihood: float = MIN_LIKELIHOOD):
        super().__init__()
        self.n_channels = n_channels
        self.min_likelihood = min_likelihood
        dims = (1,) + tuple(filters) + (1,)
        self.n_layers = len(filters) + 1
        scale = init_scale ** (1.0 / self.n_layers)
        for k in range(self.n_layers):
            h_init = float(np.log(np.expm1(1.0 / scale / dims[k + 1])))
            self.register_parameter(f"H_{k}", nn.Parameter(
                torch.full((n_channels, dims[k + 1], dims[k]), h_init)))
            self.register_parameter(f"a_{k}", nn.Parameter(
                torch.zeros(n_channels, dims[k + 1], 1)))
            self.register_parameter(f"b_{k}", nn.Parameter(
                torch.zeros(n_channels, dims[k + 1], 1)))

    def layers(self):
        return [(getattr(self, f"H_{k}"), getattr(self, f"a_{k}"),
                 getattr(self, f"b_{k}")) for k in range(self.n_layers)]

    def cdf_logits(self, x):
        """CDF logits at `x` of shape (C, 1, M). A bfloat16 x is widened
        to the parameters' float32 at the first product, where the JAX
        package's einsum promotes it."""
        logits = x.to(self.H_0.dtype)
        for h, a, b in self.layers():
            logits = torch.bmm(F.softplus(h), logits) + b
            logits = logits + torch.tanh(a) * torch.tanh(logits)
        return logits

    def likelihood_collapsed(self, x):
        """Likelihood of x of shape (C, 1, M)."""
        upper = self.cdf_logits(x + 0.5)
        lower = self.cdf_logits(x - 0.5)
        # The sigmoid difference in whichever tail is more stable; the sign
        # is a constant of the gradient, as in the JAX package.
        sign = -torch.sign(upper + lower).detach()
        lik = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        return lower_bound_toward(lik, self.min_likelihood)

    def forward(self, x):
        """Likelihood of NCHW `x`; same shape."""
        n, c, h, w = x.shape
        flat = x.permute(1, 0, 2, 3).reshape(c, 1, -1)
        lik = self.likelihood_collapsed(flat)
        return lik.reshape(c, n, h, w).permute(1, 0, 2, 3)
