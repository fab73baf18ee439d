"""Hyperprior analysis and synthesis transforms (Balle 2018) on NCHW
tensors; counterpart of the JAX package's `models/hyper.py`
(`HyperpriorAnalysis`, `HyperpriorSynthesis`, `HyperpriorSynthesisDLMM`,
`get_num_dlmm_channels`, `unpack_likelihood_params`). The convs compute in
`dtype` (float32 without one); the transposed convs keep their parameters
in it and compute in their input's dtype."""

from typing import Optional

import torch
from torch import nn

from hific_tpu_torch.models.layers import Conv, ConvTranspose
from hific_tpu_torch.ops.maths import lower_bound_toward


def get_num_dlmm_channels(C: int, K: int = 4, n_params: int = 3) -> int:
    """Channels of a K-component discretized logistic mixture head: per
    latent channel, K each of (mixture logit, mean, log-scale)."""
    return C * K * n_params


def unpack_likelihood_params(x, conv_out, log_scales_min: float):
    """Split the DLMM head's output (N, 3 C K, H, W) into (logit_pis,
    means, log_scales), each (N, C, K, H, W), the log-scales bounded below,
    and reshape x (N, C, H, W) to (N, C, 1, H, W). Channel order is the
    JAX package's: parameter kind, then latent channel, then component."""
    n, c, h, w = x.shape
    K = conv_out.shape[1] // (3 * c)
    conv_out = conv_out.reshape(n, 3, c, K, h, w)
    logit_pis = conv_out[:, 0]
    means = conv_out[:, 1]
    log_scales = lower_bound_toward(conv_out[:, 2], log_scales_min)
    return x.reshape(n, c, 1, h, w), (logit_pis, means, log_scales), K


class HyperpriorAnalysis(nn.Module):
    """latents (C ch) -> hyperlatents (N ch), 4x spatial reduction: a 3x3
    zero-padded conv, then two reflect-padded 5x5 stride-2 convs, ReLU
    between layers and none after the last."""

    n_downsampling_layers = 2

    def __init__(self, C: int = 220, N: int = 320,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(C, N, 3, padding=1, padding_mode="zeros",
                          dtype=dtype)
        self.conv2 = Conv(N, N, 5, stride=2, padding=2, padding_mode="reflect",
                          dtype=dtype)
        self.conv3 = Conv(N, N, 5, stride=2, padding=2, padding_mode="reflect",
                          dtype=dtype)
        # Modules, so that a forward hook sees each ReLU (chip_smoke.py's
        # KinkMasks); no parameters.
        self.act1, self.act2 = nn.ReLU(), nn.ReLU()

    def forward(self, x):
        x = self.act1(self.conv1(x))
        x = self.act2(self.conv2(x))
        return self.conv3(x)


class HyperpriorSynthesis(nn.Module):
    """hyperlatents (N ch) -> one latent distribution parameter (C ch), 4x
    upsample: two ConvTranspose(5x5, s2, p2, op1) + ReLU, then a 3x3
    zero-padded conv."""

    def __init__(self, C: int = 220, N: int = 320,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = ConvTranspose(N, N, 5, stride=2, padding=2, dtype=dtype)
        self.conv2 = ConvTranspose(N, N, 5, stride=2, padding=2, dtype=dtype)
        self.conv3 = Conv(N, C, 3, padding=1, padding_mode="zeros",
                          dtype=dtype)
        self.act1, self.act2 = nn.ReLU(), nn.ReLU()

    def forward(self, x):
        x = self.act1(self.conv1(x))
        x = self.act2(self.conv2(x))
        return self.conv3(x)


class HyperpriorSynthesisDLMM(HyperpriorSynthesis):
    """The DLMM variant: the synthesis, then a 1x1 head to the C K 3
    mixture parameters (K = 4, as in the JAX package)."""

    def __init__(self, C: int = 64, N: int = 320,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(C, N, dtype)
        self.conv_out = Conv(C, get_num_dlmm_channels(C), 1, dtype=dtype)

    def forward(self, x):
        return self.conv_out(super().forward(x))
