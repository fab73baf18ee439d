"""HiFiC facade: Encoder -> Hyperprior -> Generator.

Counterpart of the JAX package's `models/hific.py`: the training forward
(`HiFiC.__call__`, here `forward`) and the codec-side methods (`encode`,
`code_hyper`, `synth_stats`, `latent_symbols`, `compress_front`,
`generate`). Tensors are NCHW, stored channels-last.
"""

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from hific_tpu_torch.config import Config
from hific_tpu_torch.models.density import HyperlatentDensity, latent_likelihood
from hific_tpu_torch.models.encoder import Encoder
from hific_tpu_torch.models.generator import Generator
from hific_tpu_torch.models.hyperprior import HyperInfo, Hyperprior
from hific_tpu_torch.models.layers import Conv, ConvTranspose
from hific_tpu_torch.ops.padding import pad_factor


class Intermediates(NamedTuple):
    input_image: torch.Tensor      # [0, 1] (or [-1, 1] if normalized)
    reconstruction: torch.Tensor
    latents_quantized: torch.Tensor
    n_bpp: torch.Tensor            # differential-entropy estimate
    q_bpp: torch.Tensor            # Shannon-entropy estimate


def _bits(likelihood) -> torch.Tensor:
    return -torch.sum(torch.log(likelihood + 1e-9)) / math.log(2.0)


class HiFiC(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        unsupported = [name for name, bad in (
            ("instance norm", not config.use_channel_norm),
            ("the DLMM hyperprior", config.use_latent_mixture_model),
            ("sample_noise", config.sample_noise)) if bad]
        if unsupported:
            raise NotImplementedError(
                f"hific_tpu_torch does not port {', '.join(unsupported)} yet")
        self.config = config
        C = config.effective_latent_channels
        self.encoder = Encoder(C)
        self.generator = Generator(C, config.n_residual_blocks)
        self.hyperprior = Hyperprior(C, config.hyperlatent_filters,
                                     likelihood_type=config.likelihood_type)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                training: bool = True):
        """Compression forward of training (and validation, with
        `training=False`): x (N, 3, H, W), H and W multiples of 64, no
        padding. The quantization noise comes from `generator`. Returns
        (Intermediates, HyperInfo)."""
        spatial_shape = tuple(x.shape[2:])
        y = self.encoder(x)
        info: HyperInfo = self.hyperprior(y, spatial_shape, generator,
                                          training)
        reconstruction = self.generator(info.decoded)
        if self.config.normalize_input_image:
            reconstruction = torch.tanh(reconstruction)
        return Intermediates(x, reconstruction, info.decoded,
                             info.total_nbpp, info.total_qbpp), info

    def encode(self, x):
        """Image (N, 3, H, W) -> latents padded for the hyperprior, and the
        image's (H, W)."""
        spatial_shape = tuple(x.shape[2:])
        x = pad_factor(x, 2 ** self.encoder.n_downsampling_layers)
        y = self.encoder(x)
        y = pad_factor(
            y, 2 ** self.hyperprior.analysis_net.n_downsampling_layers)
        return y, spatial_shape

    def code_hyper(self, y):
        """y -> (hyperlatent symbols int16, hyperlatent Shannon bits)."""
        z = self.hyperprior.analyze(y)
        z_q = torch.floor(z + 0.5)
        bits = _bits(self.hyperprior.hyperlatent_density(z_q))
        return z_q.to(torch.int16), bits

    def synth_stats(self, z_sym, scale_table):
        """Decoded hyperlatent symbols -> (mu, sigma, scale-table indices).

        The one function both coder sides take the CDF-row indices from. A
        sigma that differs in its last bits between encoder and decoder can
        move an index across a table boundary and desynchronize the rANS
        lanes, so the encoder and the decoder run this same function, on
        the same device, in fp32, with cuDNN deterministic and without TF32
        (`codec.py` sets both).
        index = number of entries of scale_table[:-1] strictly below sigma.
        """
        mu, sigma = self.hyperprior.synthesize(z_sym.to(torch.float32))
        # On the (N, H, W, C) view, which channels-last makes contiguous.
        idx = torch.bucketize(sigma.permute(0, 2, 3, 1), scale_table[:-1])
        idx = idx.to(torch.uint8).permute(0, 3, 1, 2)
        return mu, sigma, idx

    def latent_symbols(self, y, mu, sigma):
        """(latent symbols int16, latent Shannon bits)."""
        y_sym = torch.floor(y + 0.5 - mu)
        lik = latent_likelihood(y_sym + mu, mu, sigma,
                                self.config.likelihood_type)
        return y_sym.to(torch.int16), _bits(lik)

    def compress_front(self, x):
        """x -> (padded latents y, z_sym int16, hyperlatent bits): every
        stage upstream of `synth_stats`."""
        y, _ = self.encode(x)
        z_sym, hyper_bits = self.code_hyper(y)
        return y, z_sym, hyper_bits

    def generate(self, latents, spatial_shape):
        """Quantized latents -> reconstruction in [0, 1], cropped to the
        image's (H, W)."""
        r = self.generator(latents)
        if self.config.normalize_input_image:
            r = torch.tanh(r)
        r = r[:, :, : spatial_shape[0], : spatial_shape[1]]
        if self.config.normalize_input_image:
            r = (r + 1.0) / 2.0
        return torch.clamp(r, 0.0, 1.0)


@torch.no_grad()
def init_random_(model: HiFiC, generator: torch.Generator) -> HiFiC:
    """Seeded random weights, drawn like the JAX package's initializers:
    conv weights N(0, 1/fan_in), zero biases, unit norm scales, and the
    density's b ~ U(-0.5, 0.5) beside its constant H and zero a."""
    for m in model.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            w = m.weight
            in_features = w.shape[0] if isinstance(m, ConvTranspose) else w.shape[1]
            fan_in = in_features * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))
            m.bias.zero_()
        elif isinstance(m, HyperlatentDensity):
            for _, a, b in m.layers():
                a.zero_()
                b.copy_(torch.rand(b.shape, generator=generator) - 0.5)
    return model
