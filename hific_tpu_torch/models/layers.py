"""Conv building blocks on NCHW tensors stored channels-last.

Counterparts of the JAX package's `models/layers.py`. Parameter names follow
its tree (`<name>/Conv_0/kernel` becomes `<name>.weight`; see `weights.py`),
and the arithmetic is torch's own: a reflect pad then a VALID `F.conv2d`,
zero padding inside `F.conv2d`, and `F.conv_transpose2d` for the
transposed convolutions. `SNConv` is the discriminator's spectrally
normalised conv, with the JAX package's power iteration written out.

Compute dtype, as the JAX layers use Flax's: a `Conv` given `dtype` keeps
float32 parameters and computes in `dtype` (its input, weight and bias
cast, its output in `dtype`); without one it computes in the promoted
type of its input and weight. A `ConvTranspose` declares its parameters in
`dtype` (float32 without one), so under bfloat16 they are bfloat16 leaves,
and computes in its input's dtype, its weight and bias cast to it. `Norm`
hands a bfloat16 input to the norm kernel's bfloat16 entry point with
float32 gamma and beta, where the JAX package casts gamma and beta to
bfloat16 and computes in it.
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from hific_tpu_torch.ops.channel_norm import instance_norm
from hific_tpu_torch.ops.fused_norm import channel_norm_fused
from hific_tpu_torch.ops.padding import reflect_pad

NORM_TYPES = ("channel", "instance")


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """`Config.dtype` -> the layers' `dtype` argument: bfloat16, or None
    (float32) as the JAX package's `HiFiC` maps it."""
    return torch.bfloat16 if name == "bfloat16" else None


class Conv(nn.Module):
    """2-D convolution with torch-style integer padding, padding_mode
    'zeros' (inside F.conv2d) or 'reflect' (a pad, then a VALID conv)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 padding_mode: str = "zeros",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if padding_mode not in ("zeros", "reflect"):
            raise ValueError(f"unknown padding_mode {padding_mode!r}")
        self.stride = stride
        self.padding = padding
        self.padding_mode = padding_mode
        self.dtype = dtype
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        pad = self.padding
        if self.padding_mode == "reflect":
            x, pad = reflect_pad(x, pad), 0
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.conv2d(x.to(dtype), self.weight.to(dtype),
                        self.bias.to(dtype), stride=self.stride, padding=pad)


class ConvTranspose(nn.Module):
    """torch.nn.ConvTranspose2d: out = (in - 1) * stride - 2 * padding +
    kernel + output_padding. The weight is (I, O, kH, kW), in `dtype`
    (float32 without one); the product runs in x's dtype."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 2, padding: int = 1, output_padding: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        k = kernel_size
        dtype = dtype or torch.float32
        self.weight = nn.Parameter(torch.empty(in_features, features, k, k,
                                               dtype=dtype))
        self.bias = nn.Parameter(torch.empty(features, dtype=dtype))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), stride=self.stride,
                                  padding=self.padding,
                                  output_padding=self.output_padding)


class Norm(nn.Module):
    """Channel or instance norm with learned float32 affine and an optional
    trailing ReLU.

    Channel: `channel_norm_fused` with the ReLU fused, the CUDA kernel on a
    GPU tensor (float32 or bfloat16, statistics in float32), its plain
    version on a CPU tensor. Instance: plain torch, gamma and beta cast to
    x's dtype as in the JAX package.
    """

    def __init__(self, n_channels: int, activation: str = "none",
                 norm_type: str = "channel"):
        super().__init__()
        if norm_type not in NORM_TYPES:
            raise ValueError(f"unknown norm type {norm_type!r}")
        self.activation = activation
        self.norm_type = norm_type
        self.gamma = nn.Parameter(torch.ones(n_channels))
        self.beta = nn.Parameter(torch.zeros(n_channels))

    def forward(self, x):
        if self.norm_type == "channel":
            return channel_norm_fused(x, self.gamma, self.beta,
                                      act=self.activation)
        y = instance_norm(x, self.gamma.to(x.dtype), self.beta.to(x.dtype))
        return torch.relu(y) if self.activation == "relu" else y


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
    W / sigma, plus the bias, both cast to x's dtype. l2n(a) = a / (|a| + eps), as in JAX
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
        return F.conv2d(reflect_pad(x, SN_PADDING), weight.to(x.dtype),
                        self.bias.to(x.dtype), stride=SN_STRIDE)
