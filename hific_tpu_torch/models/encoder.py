"""Analysis transform (image -> latents) on NCHW tensors stored
channels-last; counterpart of the JAX package's `models/encoder.py`.

7x7 stem to 60 channels, four stride-2 3x3 convs (120/240/480/960) after an
asymmetric reflect pad, each followed by a norm (channel or instance) +
ReLU, then a reflect-padded 3x3 projection to C latent channels: 16x
spatial reduction. The convs compute in `dtype` (float32 without one).
With `s2d_front` and channel norm (the config's `s2d_encoder_front`, off by
default as in the JAX package), an input of even H and W runs the stem, its
norm and the first downsample on the packed half-resolution grid
(`ops/s2d.py`): the same function of the same parameters, summed in another
order. Instance norm, or an odd H or W (an odd window of the tiled
encoder, say), falls back to the plain layers, as in the JAX package.
"""

from typing import Optional

import torch
from torch import nn

from hific_tpu_torch.models.layers import Conv, Norm
from hific_tpu_torch.ops.padding import asymmetric_pad_2x, reflect_pad
from hific_tpu_torch.ops.s2d import encoder_front_s2d

ENCODER_FILTERS = (60, 120, 240, 480, 960)


class Encoder(nn.Module):
    n_downsampling_layers = 4

    def __init__(self, C: int = 220, in_channels: int = 3,
                 norm_type: str = "channel",
                 dtype: Optional[torch.dtype] = None, s2d_front: bool = False):
        super().__init__()
        f = ENCODER_FILTERS
        self.dtype = dtype
        # The per-phase norm of the packed front is a ChannelNorm of a view.
        self.s2d_front = s2d_front and norm_type == "channel"
        self.conv_stem = Conv(in_channels, f[0], 7, dtype=dtype)
        self.norm_stem = Norm(f[0], "relu", norm_type)
        for i in range(4):
            self.add_module(f"conv_down{i}",
                            Conv(f[i], f[i + 1], 3, stride=2, dtype=dtype))
            self.add_module(f"norm_down{i}", Norm(f[i + 1], "relu", norm_type))
        self.conv_out = Conv(f[4], C, 3, dtype=dtype)

    def forward(self, x):
        if self.s2d_front and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            x = encoder_front_s2d(
                x, self.conv_stem.weight, self.conv_stem.bias, self.norm_stem,
                self.conv_down0.weight, self.conv_down0.bias, self.dtype)
            x = self.norm_down0(x)
            start = 1
        else:
            x = self.norm_stem(self.conv_stem(reflect_pad(x, 3)))
            start = 0
        for i in range(start, 4):
            x = getattr(self, f"conv_down{i}")(asymmetric_pad_2x(x))
            x = getattr(self, f"norm_down{i}")(x)
        return self.conv_out(reflect_pad(x, 1))
