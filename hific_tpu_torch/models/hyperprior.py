"""Hyperprior bottleneck, evaluation part; counterpart of the JAX package's
`models/hyperprior.py` (`analyze`, `synthesize`, the hyperlatent density).
The training forward (noisy quantization, bpp estimates) belongs to the
training slice."""

from torch import nn

from hific_tpu_torch.models.density import MIN_SCALE, HyperlatentDensity
from hific_tpu_torch.models.hyper import HyperpriorAnalysis, HyperpriorSynthesis
from hific_tpu_torch.ops.maths import lower_bound_toward


class Hyperprior(nn.Module):
    def __init__(self, C: int = 220, hyperlatent_filters: int = 320,
                 scale_lower_bound: float = MIN_SCALE):
        super().__init__()
        self.scale_lower_bound = scale_lower_bound
        self.analysis_net = HyperpriorAnalysis(C, hyperlatent_filters)
        self.synthesis_mu = HyperpriorSynthesis(C, hyperlatent_filters)
        self.synthesis_std = HyperpriorSynthesis(C, hyperlatent_filters)
        self.hyperlatent_density = HyperlatentDensity(hyperlatent_filters)

    def analyze(self, latents):
        return self.analysis_net(latents)

    def synthesize(self, hyperlatents_decoded):
        """(mu, sigma) of the conditional latent prior; one function for the
        encoder and the decoder side."""
        mu = self.synthesis_mu(hyperlatents_decoded)
        scale = self.synthesis_std(hyperlatents_decoded)
        return mu, lower_bound_toward(scale, self.scale_lower_bound)
