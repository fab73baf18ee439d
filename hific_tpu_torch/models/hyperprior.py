"""Hyperprior bottleneck; counterpart of the JAX package's
`models/hyperprior.py` (`analyze`, `synthesize`, the hyperlatent density,
and the training forward).

The training forward computes both the noisy (differential-entropy) and the
quantized (Shannon-entropy) bpp estimates of latents and hyperlatents,
feeds the noisy hyperlatents to the synthesis transforms while training,
and returns the straight-through-quantized latents for the generator. Its
uniform noise comes from the `torch.Generator` the caller passes.

`HyperpriorDLMM` is the JAX package's discretized logistic mixture variant
of the latent prior: the same hyperlatent path, latent rates from a
K-component mixture whose parameters the DLMM synthesis emits. It is a
training-only estimate, with no compress path, as in the JAX package.
"""

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from hific_tpu_torch.models.density import (
    MIN_SCALE,
    HyperlatentDensity,
    dlmm_log_likelihood,
    latent_likelihood,
)
from hific_tpu_torch.models.hyper import (
    HyperpriorAnalysis,
    HyperpriorSynthesis,
    HyperpriorSynthesisDLMM,
)
from hific_tpu_torch.ops.maths import lower_bound_toward
from hific_tpu_torch.ops.quantize import (
    estimate_entropy,
    estimate_entropy_log,
    quantize_noise,
    quantize_round,
    quantize_ste,
)

# The largest latent width the DLMM hyperprior takes (the JAX package's).
DLMM_MAX_CHANNELS = 128


class HyperInfo(NamedTuple):
    decoded: torch.Tensor           # STE-quantized latents for the generator
    latent_nbpp: torch.Tensor       # noisy (differential) bpp, latents
    hyperlatent_nbpp: torch.Tensor
    total_nbpp: torch.Tensor
    latent_qbpp: torch.Tensor       # quantized (Shannon) bpp
    hyperlatent_qbpp: torch.Tensor
    total_qbpp: torch.Tensor
    latent_means: torch.Tensor      # (mu, sigma) of the conditional prior
    latent_scales: torch.Tensor
    hyperlatents: torch.Tensor      # before quantization


def _hyper_rates(module, latents, spatial_shape, generator, training):
    """The hyperlatent half of both hyperpriors' training forward:
    (hyperlatents, their noisy and quantized bpp, the decoded hyperlatents
    for the synthesis: noisy while training, rounded otherwise). The
    hyperlatents are noised before the latents, as in the JAX package."""
    hyperlatents = module.analysis_net(latents)
    noisy_hyper = quantize_noise(hyperlatents, generator)
    _, hyper_nbpp = estimate_entropy(
        module.hyperlatent_density(noisy_hyper), spatial_shape)
    quant_hyper = quantize_round(hyperlatents)
    _, hyper_qbpp = estimate_entropy(
        module.hyperlatent_density(quant_hyper), spatial_shape)
    return (hyperlatents, hyper_nbpp, hyper_qbpp,
            noisy_hyper if training else quant_hyper)


class Hyperprior(nn.Module):
    def __init__(self, C: int = 220, hyperlatent_filters: int = 320,
                 scale_lower_bound: float = MIN_SCALE,
                 likelihood_type: str = "gaussian",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale_lower_bound = scale_lower_bound
        self.likelihood_type = likelihood_type
        self.analysis_net = HyperpriorAnalysis(C, hyperlatent_filters, dtype)
        self.synthesis_mu = HyperpriorSynthesis(C, hyperlatent_filters, dtype)
        self.synthesis_std = HyperpriorSynthesis(C, hyperlatent_filters,
                                                 dtype)
        self.hyperlatent_density = HyperlatentDensity(hyperlatent_filters)

    def analyze(self, latents):
        return self.analysis_net(latents)

    def synthesize(self, hyperlatents_decoded):
        """(mu, sigma) of the conditional latent prior; one function for the
        training forward, the encoder and the decoder side."""
        mu = self.synthesis_mu(hyperlatents_decoded)
        scale = self.synthesis_std(hyperlatents_decoded)
        return mu, lower_bound_toward(scale, self.scale_lower_bound)

    def forward(self, latents, spatial_shape: Sequence[int],
                generator: Optional[torch.Generator] = None,
                training: bool = True) -> HyperInfo:
        """Training/validation forward; spatial_shape is the (H, W) of the
        ORIGINAL image, the bpp normalizer."""
        hyperlatents, hyper_nbpp, hyper_qbpp, decoded_hyper = _hyper_rates(
            self, latents, spatial_shape, generator, training)
        mu, scale = self.synthesize(decoded_hyper)

        noisy_latents = quantize_noise(latents, generator)
        _, latent_nbpp = estimate_entropy(latent_likelihood(
            noisy_latents, mu, scale, self.likelihood_type), spatial_shape)
        quant_latents = quantize_round(latents, means=mu)
        _, latent_qbpp = estimate_entropy(latent_likelihood(
            quant_latents, mu, scale, self.likelihood_type), spatial_shape)

        return HyperInfo(
            decoded=quantize_ste(latents, means=mu),
            latent_nbpp=latent_nbpp,
            hyperlatent_nbpp=hyper_nbpp,
            total_nbpp=latent_nbpp + hyper_nbpp,
            latent_qbpp=latent_qbpp,
            hyperlatent_qbpp=hyper_qbpp,
            total_qbpp=latent_qbpp + hyper_qbpp,
            latent_means=mu,
            latent_scales=scale,
            hyperlatents=hyperlatents,
        )


class HyperpriorDLMM(nn.Module):
    """The discretized logistic mixture latent prior (training-only
    estimate; no compress path)."""

    def __init__(self, C: int = 64, hyperlatent_filters: int = 320,
                 likelihood_type: str = "gaussian",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if C > DLMM_MAX_CHANNELS:
            raise ValueError(f"the DLMM hyperprior takes at most "
                             f"{DLMM_MAX_CHANNELS} latent channels, got {C}")
        self.likelihood_type = likelihood_type
        self.analysis_net = HyperpriorAnalysis(C, hyperlatent_filters, dtype)
        self.synthesis_dlmm = HyperpriorSynthesisDLMM(C, hyperlatent_filters,
                                                      dtype)
        self.hyperlatent_density = HyperlatentDensity(hyperlatent_filters)

    def analyze(self, latents):
        return self.analysis_net(latents)

    def forward(self, latents, spatial_shape: Sequence[int],
                generator: Optional[torch.Generator] = None,
                training: bool = True) -> HyperInfo:
        """As `Hyperprior.forward`, the latent rates from the mixture; the
        latents are rounded without means, and the returned means and
        scales are zeros and ones."""
        hyperlatents, hyper_nbpp, hyper_qbpp, decoded_hyper = _hyper_rates(
            self, latents, spatial_shape, generator, training)
        dlmm_params = self.synthesis_dlmm(decoded_hyper)

        noisy_latents = quantize_noise(latents, generator)
        _, latent_nbpp = estimate_entropy_log(dlmm_log_likelihood(
            noisy_latents, dlmm_params, self.likelihood_type), spatial_shape)
        quant_latents = quantize_round(latents)
        _, latent_qbpp = estimate_entropy_log(dlmm_log_likelihood(
            quant_latents, dlmm_params, self.likelihood_type), spatial_shape)

        decoded = quantize_ste(latents) if training else quant_latents
        return HyperInfo(
            decoded=decoded,
            latent_nbpp=latent_nbpp,
            hyperlatent_nbpp=hyper_nbpp,
            total_nbpp=latent_nbpp + hyper_nbpp,
            latent_qbpp=latent_qbpp,
            hyperlatent_qbpp=hyper_qbpp,
            total_qbpp=latent_qbpp + hyper_qbpp,
            latent_means=torch.zeros_like(decoded),
            latent_scales=torch.ones_like(decoded),
            hyperlatents=hyperlatents,
        )
