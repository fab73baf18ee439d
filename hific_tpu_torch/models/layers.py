"""Conv building blocks on NCHW tensors stored channels-last.

Counterparts of the JAX package's `models/layers.py`. Parameter names follow
its tree (`<name>/Conv_0/kernel` becomes `<name>.weight`; see `weights.py`),
and the arithmetic is torch's own: a reflect pad then a VALID `F.conv2d`,
zero padding inside `F.conv2d`, and `F.conv_transpose2d` for the
transposed convolutions. `SNConv` is the discriminator's spectrally
normalised conv, with the JAX package's power iteration written out.
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


# Every SNConv of the discriminator: 4x4, stride 2, reflect pad 1, and
# the JAX package's l2-normalisation epsilon.
SN_KERNEL_SIZE = 4
SN_STRIDE = 2
SN_PADDING = 1
SN_EPS = 1e-12


def _l2n(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + SN_EPS)


class SNConv(nn.Module):
    """Spectrally normalised 4x4 stride-2 conv, the JAX package's `SNConv`:
    one power iteration per call on the weight as an (O, I*kh*kw) matrix,
    v = l2n(W^T u) and u' = l2n(W v) without gradient, sigma = u' . (W v)
    with gradient through W, then a reflect pad of 1 and a VALID conv with
    W / sigma, plus the bias. l2n(a) = a / (|a| + eps), as in JAX
    (`torch.nn.utils.spectral_norm` divides by max(|a|, eps) and draws its
    own u).

    `u` (O,) is a buffer, replaced by u' on each call with
    `update_stats=True`. u' is a new tensor, and sigma's graph holds it and
    v, never the buffer, so the copy does not disturb the backward.
    """

    def __init__(self, in_features: int, features: int):
        super().__init__()
        k = SN_KERNEL_SIZE
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("u", torch.empty(features))

    def sigma(self, update_stats: bool = True) -> torch.Tensor:
        """The weight's spectral norm estimate; advances `u` when asked."""
        w_mat = self.weight.reshape(self.weight.shape[0], -1)
        with torch.no_grad():
            v = _l2n(w_mat.t() @ self.u)
            u_new = _l2n(w_mat @ v)
        if update_stats:
            self.u.copy_(u_new)
        return torch.dot(u_new, w_mat @ v)

    def forward(self, x, update_stats: bool = True):
        weight = self.weight / self.sigma(update_stats)
        return F.conv2d(reflect_pad(x, SN_PADDING), weight, self.bias,
                        stride=SN_STRIDE)
