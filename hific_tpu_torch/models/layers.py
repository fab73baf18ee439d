"""Conv building blocks on NCHW tensors stored channels-last.

Counterparts of the JAX package's `models/layers.py`. Parameter names follow
its tree (`<name>/Conv_0/kernel` becomes `<name>.weight`; see `weights.py`),
and the arithmetic is torch's own: a reflect pad then a VALID `F.conv2d`,
zero padding inside `F.conv2d`, and `F.conv_transpose2d` for the
transposed convolutions.
"""

import torch
import torch.nn.functional as F
from torch import nn

from hific_tpu_torch.ops.fused_norm import channel_norm_fused
from hific_tpu_torch.ops.padding import reflect_pad


class Conv(nn.Module):
    """2-D convolution with torch-style integer padding, padding_mode
    'zeros' (inside F.conv2d) or 'reflect' (a pad, then a VALID conv)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 padding_mode: str = "zeros"):
        super().__init__()
        if padding_mode not in ("zeros", "reflect"):
            raise ValueError(f"unknown padding_mode {padding_mode!r}")
        self.stride = stride
        self.padding = padding
        self.padding_mode = padding_mode
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        pad = self.padding
        if self.padding_mode == "reflect":
            x, pad = reflect_pad(x, pad), 0
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=pad)


class ConvTranspose(nn.Module):
    """torch.nn.ConvTranspose2d: out = (in - 1) * stride - 2 * padding +
    kernel + output_padding. The weight is (I, O, kH, kW)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 2, padding: int = 1, output_padding: int = 1):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(in_features, features, k, k))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias,
                                  stride=self.stride, padding=self.padding,
                                  output_padding=self.output_padding)


class Norm(nn.Module):
    """ChannelNorm with learned affine and an optional fused ReLU.

    Always `channel_norm_fused`: the CUDA kernel on a GPU tensor, its plain
    version on a CPU tensor.
    """

    def __init__(self, n_channels: int, activation: str = "none"):
        super().__init__()
        self.activation = activation
        self.gamma = nn.Parameter(torch.ones(n_channels))
        self.beta = nn.Parameter(torch.zeros(n_channels))

    def forward(self, x):
        return channel_norm_fused(x, self.gamma, self.beta,
                                  act=self.activation)
