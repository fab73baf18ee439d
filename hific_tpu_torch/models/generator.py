"""Synthesis transform (quantized latents -> image) on NCHW tensors stored
channels-last; counterpart of the JAX package's `models/generator.py`.

A norm, a 3x3 head conv to 960 channels + norm, optionally `noise_dim`
channels of standard normal noise concatenated after the head
(`sample_noise`, which widens the residual trunk to 960 + noise_dim),
residual blocks at latent resolution with a global skip, four
ConvTranspose(3x3, s2, p1, op1) upsamples 960 -> 480 -> 240 -> 120 -> 60,
each with a norm + ReLU, and a reflect-padded 7x7 projection to RGB. The
norms are channel or instance norms; the convs compute in `dtype` (float32
without one), while `norm_in` sees the latents in their own dtype, as in
the JAX package. With `use_remat` each residual block runs under
non-reentrant activation checkpointing where a gradient is recorded, so its
activations are recomputed in the backward instead of kept, as the JAX
package wraps each block in `nn.remat`. With `d2s_tail` and channel norm
(the config's `d2s_generator_tail`, on by default as in the JAX package),
the last upsample, its norm and the projection run on the packed
half-resolution grid (`ops/d2s.py`): the same function of the same
parameters, summed in another order; under instance norm the flag falls
back to the plain layers, as the JAX package's does.
"""

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from hific_tpu_torch.models.layers import Conv, ConvTranspose, Norm
from hific_tpu_torch.ops.d2s import generator_tail_d2s
from hific_tpu_torch.ops.padding import reflect_pad
from hific_tpu_torch.ops.quantize import draw_like

GENERATOR_FILTERS = (960, 480, 240, 120, 60)


def generator_noise(shape, generator: Optional[torch.Generator], dtype,
                    device) -> torch.Tensor:
    """`sample_noise`'s standard normal draw, (N, h, w, noise_dim) NHWC
    as in the JAX package (tests hand both packages the same noise by
    replacing it); inside `ops.quantize.batch_shard`, the rows of the
    global batch's draw."""
    return draw_like(torch.empty(shape, dtype=dtype, device=device),
                     lambda t: t.normal_(generator=generator))


class ResidualBlock(nn.Module):
    def __init__(self, c: int, norm_type: str = "channel",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(c, c, 3, dtype=dtype)
        self.norm1 = Norm(c, "relu", norm_type)
        self.conv2 = Conv(c, c, 3, dtype=dtype)
        self.norm2 = Norm(c, norm_type=norm_type)

    def forward(self, x):
        res = self.norm1(self.conv1(reflect_pad(x, 1)))
        res = self.norm2(self.conv2(reflect_pad(res, 1)))
        return res + x


class Generator(nn.Module):
    def __init__(self, C: int = 220, n_residual_blocks: int = 9,
                 norm_type: str = "channel", sample_noise: bool = False,
                 noise_dim: int = 32, use_remat: bool = False,
                 dtype: Optional[torch.dtype] = None, d2s_tail: bool = False):
        super().__init__()
        f = GENERATOR_FILTERS
        self.n_residual_blocks = n_residual_blocks
        self.dtype = dtype
        # The per-phase norm of the packed tail is a ChannelNorm of a view.
        self.d2s_tail = d2s_tail and norm_type == "channel"
        self.noise_dim = noise_dim if sample_noise else 0
        self.use_remat = use_remat
        trunk = f[0] + self.noise_dim
        self.norm_in = Norm(C, norm_type=norm_type)
        self.conv_head = Conv(C, f[0], 3, dtype=dtype)
        self.norm_head = Norm(f[0], norm_type=norm_type)
        for m in range(n_residual_blocks):
            self.add_module(f"resblock_{m}",
                            ResidualBlock(trunk, norm_type, dtype))
        for i in range(4):
            self.add_module(f"upconv{i}", ConvTranspose(
                trunk if i == 0 else f[i], f[i + 1], 3, dtype=dtype))
            self.add_module(f"norm_up{i}", Norm(f[i + 1], "relu", norm_type))
        self.conv_out = Conv(f[4], 3, 7, dtype=dtype)

    def forward(self, y, generator: Optional[torch.Generator] = None):
        """y: quantized latents (N, C, h, w). With `sample_noise` the noise
        is drawn from `generator` (`generator_noise`)."""
        head = self.norm_head(self.conv_head(reflect_pad(self.norm_in(y), 1)))
        if self.noise_dim:
            n, _, h, w = head.shape
            noise = generator_noise((n, h, w, self.noise_dim), generator,
                                    head.dtype, head.device)
            head = torch.cat([head, noise.permute(0, 3, 1, 2)], dim=1
                             ).contiguous(memory_format=torch.channels_last)
        x = head
        remat = self.use_remat and torch.is_grad_enabled()
        for m in range(self.n_residual_blocks):
            block = getattr(self, f"resblock_{m}")
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    block, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x)
        x = x + head  # global skip
        for i in range(3 if self.d2s_tail else 4):
            x = getattr(self, f"norm_up{i}")(getattr(self, f"upconv{i}")(x))
        if self.d2s_tail:
            return generator_tail_d2s(
                x, self.upconv3.weight, self.upconv3.bias, self.norm_up3,
                self.conv_out.weight, self.conv_out.bias, self.dtype)
        return self.conv_out(reflect_pad(x, 3))
