"""Conditional patchGAN discriminator; counterpart of the JAX package's
`models/discriminator.py`, on NCHW tensors.

The quantized latents go through a 3x3 reflect-padded conv to 12 channels
and LeakyReLU(0.2), are upsampled x16 (nearest) and concatenated after the
image's channels; four spectrally normalised 4x4 stride-2 convs (64, 128,
256, 512, reflect pad 1) with LeakyReLU(0.2) and a 1x1 conv give one logit
per patch. No norm layer: every conv is cuDNN's.
"""

import torch
import torch.nn.functional as F
from torch import nn

from hific_tpu_torch.models.layers import Conv, SNConv

DISC_FILTERS = (64, 128, 256, 512)
CONTEXT_C_OUT = 12
UPSAMPLE_FACTOR = 16


class Discriminator(nn.Module):
    def __init__(self, C: int):
        super().__init__()
        self.context_conv = Conv(C, CONTEXT_C_OUT, 3, stride=1, padding=1,
                                 padding_mode="reflect")
        in_features = 3 + CONTEXT_C_OUT
        for i, filters in enumerate(DISC_FILTERS):
            setattr(self, f"conv{i + 1}", SNConv(in_features, filters))
            in_features = filters
        self.conv_out = Conv(in_features, 1, 1)

    def forward(self, x, y, update_stats: bool = True):
        """x: images (N, 3, H, W); y: quantized latents (N, C, H/16, W/16).
        Returns (probabilities, logits), each (N * H/16 * W/16, 1) in
        (N, h, w) order."""
        y = F.leaky_relu(self.context_conv(y), 0.2)
        y = F.interpolate(y, scale_factor=UPSAMPLE_FACTOR, mode="nearest")
        x = torch.cat([x, y], dim=1)
        for i in range(len(DISC_FILTERS)):
            x = F.leaky_relu(getattr(self, f"conv{i + 1}")(x, update_stats),
                             0.2)
        logits = self.conv_out(x).reshape(-1, 1)
        return torch.sigmoid(logits), logits
