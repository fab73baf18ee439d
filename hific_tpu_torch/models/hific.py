"""HiFiC facade: Encoder -> Hyperprior -> Generator (+ Discriminator).

Counterpart of the JAX package's `models/hific.py`: the training forward
(`HiFiC.__call__`, here `forward`), the codec-side methods (`encode`,
`code_hyper`, `synth_stats`, `latent_symbols`, `compress_front`,
`compress_front_from_latents`, `generate`) and `discriminator_forward`.
Tensors are NCHW, stored channels-last.

Every model configuration of the JAX package's `HiFiC` builds: channel or
instance norm (`use_channel_norm`), the Gaussian or DLMM hyperprior
(`use_latent_mixture_model`, a training-only estimate whose codec-side
methods do not exist), `sample_noise`, `use_remat`, and the compute dtype
(`dtype`: every conv stack in bfloat16 under "bfloat16", the transposed
convs' parameters bfloat16 leaves). The rates and the losses see the
tensors' own dtypes, as in the JAX package: a bfloat16 latent rate is
summed in bfloat16 and meets the float32 hyperlatent rate in float32.

The discriminator is a module of its own, not a submodule of `HiFiC`: the
codec's `state_dict` (and so `export_params_npz`, `Codec` and a
compression checkpoint) holds the codec only, as the JAX package's
`split_params` takes the discriminator out of the codec tree.
"""

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from hific_tpu_torch.config import Config
from hific_tpu_torch.models.density import HyperlatentDensity, latent_likelihood
from hific_tpu_torch.models.discriminator import Discriminator
from hific_tpu_torch.models.encoder import Encoder
from hific_tpu_torch.models.generator import Generator
from hific_tpu_torch.models.hyperprior import (
    HyperInfo,
    Hyperprior,
    HyperpriorDLMM,
)
from hific_tpu_torch.models.layers import (
    Conv,
    ConvTranspose,
    SNConv,
    compute_dtype,
)
from hific_tpu_torch.ops.padding import pad_factor


class Intermediates(NamedTuple):
    input_image: torch.Tensor      # [0, 1] (or [-1, 1] if normalized)
    reconstruction: torch.Tensor
    latents_quantized: torch.Tensor
    n_bpp: torch.Tensor            # differential-entropy estimate
    q_bpp: torch.Tensor            # Shannon-entropy estimate


class DiscOut(NamedTuple):
    d_real: torch.Tensor
    d_gen: torch.Tensor
    d_real_logits: torch.Tensor
    d_gen_logits: torch.Tensor


def _bits(likelihood) -> torch.Tensor:
    return -torch.sum(torch.log(likelihood + 1e-9)) / math.log(2.0)


class HiFiC(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        C = config.effective_latent_channels
        dtype = compute_dtype(config.dtype)
        self.encoder = Encoder(C, norm_type=config.norm_type, dtype=dtype,
                               s2d_front=config.s2d_encoder_front)
        self.generator = Generator(
            C, config.n_residual_blocks, norm_type=config.norm_type,
            sample_noise=config.sample_noise, noise_dim=config.noise_dim,
            use_remat=config.use_remat, dtype=dtype,
            d2s_tail=config.d2s_generator_tail)
        if config.use_latent_mixture_model:
            self.hyperprior = HyperpriorDLMM(
                C, config.hyperlatent_filters,
                likelihood_type=config.likelihood_type, dtype=dtype)
        else:
            self.hyperprior = Hyperprior(
                C, config.hyperlatent_filters,
                likelihood_type=config.likelihood_type, dtype=dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                training: bool = True):
        """Compression forward of training (and validation, with
        `training=False`): x (N, 3, H, W), H and W multiples of 64, no
        padding. The quantization noise, and the generator's with
        `sample_noise`, come from `generator`. Returns (Intermediates,
        HyperInfo)."""
        spatial_shape = tuple(x.shape[2:])
        y = self.encoder(x)
        info: HyperInfo = self.hyperprior(y, spatial_shape, generator,
                                          training)
        reconstruction = self.generator(info.decoded, generator)
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
        the same device, in the config's dtype, with cuDNN deterministic and
        without TF32 (`codec.py` sets both).
        index = number of entries of scale_table[:-1] strictly below sigma.
        """
        mu, sigma = self.hyperprior.synthesize(z_sym.to(torch.float32))
        # On the (N, H, W, C) view, which channels-last makes contiguous;
        # a bfloat16 sigma widens exactly, as the JAX package compares it.
        idx = torch.bucketize(sigma.float().permute(0, 2, 3, 1),
                              scale_table[:-1])
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
        return self.compress_front_from_latents(self.encode(x)[0])

    def compress_front_from_latents(self, y):
        """`compress_front` downstream of the encoder, on latents assembled
        elsewhere (encode-side tiling): pads y to the hyperprior's factor
        as `encode` does (a no-op on padded latents)."""
        y = pad_factor(
            y, 2 ** self.hyperprior.analysis_net.n_downsampling_layers)
        z_sym, hyper_bits = self.code_hyper(y)
        return y, z_sym, hyper_bits

    def generate(self, latents, spatial_shape):
        """Quantized latents -> reconstruction in [0, 1], cropped to the
        image's (H, W)."""
        return self.reconstruction(self.generator(latents), spatial_shape)

    def reconstruction(self, r, spatial_shape):
        """The generator's output -> the image in [0, 1], cropped to
        (H, W)."""
        if self.config.normalize_input_image:
            r = torch.tanh(r)
        r = r[:, :, : spatial_shape[0], : spatial_shape[1]]
        if self.config.normalize_input_image:
            r = (r + 1.0) / 2.0
        return torch.clamp(r, 0.0, 1.0)


def discriminator_forward(intermediates: Intermediates, disc: Discriminator,
                          train_generator: bool, update_stats: bool = True
                          ) -> DiscOut:
    """Real and generated images through the conditional discriminator in
    one pass, real first (so `u` advances once a call), on the detached
    latents; the generated images are detached unless `train_generator`."""
    x_gen = intermediates.reconstruction
    if not train_generator:
        x_gen = x_gen.detach()
    d_in = torch.cat([intermediates.input_image, x_gen], dim=0)
    latents = intermediates.latents_quantized.detach()
    d_out, logits = disc(d_in, torch.cat([latents, latents], dim=0),
                         update_stats)
    d_out, logits = d_out.squeeze(-1), logits.squeeze(-1)
    n = d_out.shape[0] // 2
    return DiscOut(d_out[:n], d_out[n:], logits[:n], logits[n:])


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights of a `HiFiC` or a `Discriminator`, drawn like
    the JAX package's initializers: conv weights N(0, 1/fan_in), zero
    biases, unit norm scales, the density's b ~ U(-0.5, 0.5) beside its
    constant H and zero a, and each SNConv's u ~ N(0, 1)."""
    for m in model.modules():
        if isinstance(m, (Conv, ConvTranspose, SNConv)):
            w = m.weight
            in_features = w.shape[0] if isinstance(m, ConvTranspose) else w.shape[1]
            fan_in = in_features * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))
            m.bias.zero_()
            if isinstance(m, SNConv):
                m.u.copy_(torch.randn(m.u.shape, generator=generator))
        elif isinstance(m, HyperlatentDensity):
            for _, a, b in m.layers():
                a.zero_()
                b.copy_(torch.rand(b.shape, generator=generator) - 0.5)
    return model
