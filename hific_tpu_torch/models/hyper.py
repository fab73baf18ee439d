"""Hyperprior analysis and synthesis transforms (Balle 2018) on NCHW
tensors; counterpart of `HyperpriorAnalysis` and `HyperpriorSynthesis` in
the JAX package's `models/hyper.py`."""

import torch
from torch import nn

from hific_tpu_torch.models.layers import Conv, ConvTranspose


class HyperpriorAnalysis(nn.Module):
    """latents (C ch) -> hyperlatents (N ch), 4x spatial reduction: a 3x3
    zero-padded conv, then two reflect-padded 5x5 stride-2 convs, ReLU
    between layers and none after the last."""

    n_downsampling_layers = 2

    def __init__(self, C: int = 220, N: int = 320):
        super().__init__()
        self.conv1 = Conv(C, N, 3, padding=1, padding_mode="zeros")
        self.conv2 = Conv(N, N, 5, stride=2, padding=2, padding_mode="reflect")
        self.conv3 = Conv(N, N, 5, stride=2, padding=2, padding_mode="reflect")

    def forward(self, x):
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        return self.conv3(x)


class HyperpriorSynthesis(nn.Module):
    """hyperlatents (N ch) -> one latent distribution parameter (C ch), 4x
    upsample: two ConvTranspose(5x5, s2, p2, op1) + ReLU, then a 3x3
    zero-padded conv."""

    def __init__(self, C: int = 220, N: int = 320):
        super().__init__()
        self.conv1 = ConvTranspose(N, N, 5, stride=2, padding=2)
        self.conv2 = ConvTranspose(N, N, 5, stride=2, padding=2)
        self.conv3 = Conv(N, C, 3, padding=1, padding_mode="zeros")

    def forward(self, x):
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        return self.conv3(x)
