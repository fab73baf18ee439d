"""ChannelNorm and InstanceNorm, plain PyTorch.

`channel_norm` is the CPU path of the norm kernel and its yardstick: it
normalizes each pixel over the channel axis of an NCHW tensor, then applies
the per-channel affine. Like the JAX package's `ops/channel_norm.py` (and
torch.var), it divides by C - 1, and eps is 1e-3.

`instance_norm` is the JAX package's `instance_norm`, which is plain XLA
there and plain torch here: each (N, C) plane normalized over H and W with
the biased variance, eps 1e-5.
"""

import torch


def channel_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float = 1e-3) -> torch.Tensor:
    """x: (N, C, H, W); gamma, beta: (C,)."""
    c = x.shape[1]
    mu = x.mean(dim=1, keepdim=True)
    centered = x - mu
    var = (centered * centered).sum(dim=1, keepdim=True) / (c - 1)
    x_normed = centered * torch.rsqrt(var + eps)
    return x_normed * gamma.view(1, c, 1, 1) + beta.view(1, c, 1, 1)


def instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """x: (N, C, H, W); gamma, beta: (C,) in x's dtype."""
    c = x.shape[1]
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    x_normed = (x - mu) * torch.rsqrt(var + eps)
    return x_normed * gamma.view(1, c, 1, 1) + beta.view(1, c, 1, 1)
