"""Synthesis transform (quantized latents -> image) on NCHW tensors stored
channels-last; counterpart of the JAX package's `models/generator.py`.

ChannelNorm, a 3x3 head conv to 960 channels + ChannelNorm, residual blocks
at latent resolution with a global skip, four ConvTranspose(3x3, s2, p1,
op1) upsamples 960 -> 480 -> 240 -> 120 -> 60, each with ChannelNorm + ReLU,
and a reflect-padded 7x7 projection to RGB. The JAX package can run the last
upsample and the projection on a depth-to-space grid (`d2s_generator_tail`,
a TPU layout rewrite with the same parameters and math); this module always
computes the plain layers.
"""

from torch import nn

from hific_tpu_torch.models.layers import Conv, ConvTranspose, Norm
from hific_tpu_torch.ops.padding import reflect_pad

GENERATOR_FILTERS = (960, 480, 240, 120, 60)


class ResidualBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = Conv(c, c, 3)
        self.norm1 = Norm(c, "relu")
        self.conv2 = Conv(c, c, 3)
        self.norm2 = Norm(c)

    def forward(self, x):
        res = self.norm1(self.conv1(reflect_pad(x, 1)))
        res = self.norm2(self.conv2(reflect_pad(res, 1)))
        return res + x


class Generator(nn.Module):
    def __init__(self, C: int = 220, n_residual_blocks: int = 9):
        super().__init__()
        f = GENERATOR_FILTERS
        self.n_residual_blocks = n_residual_blocks
        self.norm_in = Norm(C)
        self.conv_head = Conv(C, f[0], 3)
        self.norm_head = Norm(f[0])
        for m in range(n_residual_blocks):
            self.add_module(f"resblock_{m}", ResidualBlock(f[0]))
        for i in range(4):
            self.add_module(f"upconv{i}", ConvTranspose(f[i], f[i + 1], 3))
            self.add_module(f"norm_up{i}", Norm(f[i + 1], "relu"))
        self.conv_out = Conv(f[4], 3, 7)

    def forward(self, y):
        head = self.norm_head(self.conv_head(reflect_pad(self.norm_in(y), 1)))
        x = head
        for m in range(self.n_residual_blocks):
            x = getattr(self, f"resblock_{m}")(x)
        x = x + head  # global skip
        for i in range(4):
            x = getattr(self, f"norm_up{i}")(getattr(self, f"upconv{i}")(x))
        return self.conv_out(reflect_pad(x, 3))
