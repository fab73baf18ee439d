"""Analysis transform (image -> latents) on NCHW tensors stored
channels-last; counterpart of the JAX package's `models/encoder.py`.

7x7 stem to 60 channels, four stride-2 3x3 convs (120/240/480/960) after an
asymmetric reflect pad, each followed by a norm (channel or instance) +
ReLU, then a reflect-padded 3x3 projection to C latent channels: 16x
spatial reduction. The convs compute in `dtype` (float32 without one).
"""

from typing import Optional

import torch
from torch import nn

from hific_tpu_torch.models.layers import Conv, Norm
from hific_tpu_torch.ops.padding import asymmetric_pad_2x, reflect_pad

ENCODER_FILTERS = (60, 120, 240, 480, 960)


class Encoder(nn.Module):
    n_downsampling_layers = 4

    def __init__(self, C: int = 220, in_channels: int = 3,
                 norm_type: str = "channel",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        f = ENCODER_FILTERS
        self.conv_stem = Conv(in_channels, f[0], 7, dtype=dtype)
        self.norm_stem = Norm(f[0], "relu", norm_type)
        for i in range(4):
            self.add_module(f"conv_down{i}",
                            Conv(f[i], f[i + 1], 3, stride=2, dtype=dtype))
            self.add_module(f"norm_down{i}", Norm(f[i + 1], "relu", norm_type))
        self.conv_out = Conv(f[4], C, 3, dtype=dtype)

    def forward(self, x):
        x = self.norm_stem(self.conv_stem(reflect_pad(x, 3)))
        for i in range(4):
            x = getattr(self, f"conv_down{i}")(asymmetric_pad_2x(x))
            x = getattr(self, f"norm_down{i}")(x)
        return self.conv_out(reflect_pad(x, 1))
