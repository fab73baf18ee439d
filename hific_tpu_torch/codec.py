"""The codec: image <-> `.hfc` bitstream, on one device plus the host coder.

Counterpart of the JAX package's `Codec` on its host-coder path
(`compress`, `decompress`, `compress_file`, `decompress_file`). Public
tensors are NHWC like the JAX package's; inside, activations are NCHW in
`torch.channels_last` memory, so every ChannelNorm reads contiguous
(pixel, channel) rows.

Encode: pixels -> `HiFiC.compress_front` -> `synth_stats` ->
`latent_symbols` -> host rANS -> `.hfc`. Decode: host rANS of z -> the same
`synth_stats` -> host rANS of y -> `generate`. The coding indices of both
sides come from `HiFiC.synth_stats` on the decoded hyperlatent symbols,
which is what keeps the two sides' CDF rows identical.
"""

from typing import Tuple

import numpy as np
import torch

from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy.container import (
    CompressionOutput,
    load_compressed,
    save_compressed,
)
from hific_tpu_torch.entropy.entropy_models import (
    ConditionalEntropyModel,
    FactorizedEntropyModel,
)
from hific_tpu_torch.models.hific import HiFiC
from hific_tpu_torch.runtime import fp32_numerics, resolve_device


# The device work of the codec's methods runs in fp32 with TF32 off and
# deterministic cuDNN. TF32 keeps ~3 digits, enough to move sigma across a
# scale-table boundary, and an index that differs between encoder and decoder
# desyncs the rANS lanes; deterministic algorithms keep the encoder's and the
# decoder's synth_stats bit-identical on one card. The settings hold for the
# call only, so a trainer in the same process keeps its own.
_codec_numerics = fp32_numerics(deterministic=True)


def _numpy(t: torch.Tensor, dtype) -> np.ndarray:
    return t.cpu().numpy().astype(dtype)


class Codec:
    """Evaluation-mode compression/decompression engine."""

    def __init__(self, config: Config, state_dict, device=None):
        self.device = resolve_device(device)
        self.config = config
        model = HiFiC(config)
        model.load_state_dict(state_dict)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self.model.eval().requires_grad_(False)
        self.factorized = FactorizedEntropyModel(
            self.model.hyperprior.hyperlatent_density)
        self.conditional = ConditionalEntropyModel(config.likelihood_type)
        self.scale_table = torch.tensor(self.conditional.scale_table,
                                        dtype=torch.float32,
                                        device=self.device)
        self._tables_built = False

    def build_tables(self):
        """Build the hyperlatent probability tables (once per model)."""
        self.factorized.build_tables()
        self._tables_built = True

    def _model_input(self, x) -> torch.Tensor:
        """NHWC uint8 or float image -> NCHW channels-last float32 on the
        codec's device (uint8 maps to [0, 1] as the JAX package does)."""
        x = torch.as_tensor(x).to(self.device)
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected an NHWC RGB image, got {tuple(x.shape)}")
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
            if self.config.normalize_input_image:
                x = x * 2.0 - 1.0
        else:
            x = x.to(torch.float32)
        return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    @_codec_numerics
    @torch.inference_mode()
    def encode_symbols(self, x):
        """Image -> numpy (z_sym, y_sym, idx) in NCHW int32, the hyperlatent
        and latent Shannon bits, and the image's (H, W)."""
        x = self._model_input(x)
        spatial_shape = tuple(int(s) for s in x.shape[2:])
        y, z_sym, hyper_bits = self.model.compress_front(x)
        mu, sigma, idx = self.model.synth_stats(z_sym, self.scale_table)
        y_sym, latent_bits = self.model.latent_symbols(y, mu, sigma)
        return (_numpy(z_sym, np.int32), _numpy(y_sym, np.int32),
                _numpy(idx, np.int32), float(hyper_bits), float(latent_bits),
                spatial_shape)

    def compress(self, x) -> CompressionOutput:
        """x: (N, H, W, 3) uint8, or float in the model's input range."""
        if not self._tables_built:
            self.build_tables()
        z_sym, y_sym, idx, hyper_bits, latent_bits, spatial_shape = \
            self.encode_symbols(x)
        z_encoded, hyper_coding_shape = self.factorized.compress_symbols(z_sym)
        y_encoded, latent_coding_shape = self.conditional.compress_symbols(
            y_sym, idx)
        n_pixels = float(np.prod(spatial_shape))
        return CompressionOutput(
            hyperlatents_encoded=z_encoded,
            latents_encoded=y_encoded,
            hyperlatent_spatial_shape=tuple(z_sym.shape[2:]),
            spatial_shape=spatial_shape,
            hyper_coding_shape=tuple(hyper_coding_shape),
            latent_coding_shape=tuple(latent_coding_shape),
            batch_shape=z_sym.shape[0],
            hyperlatent_bits=hyper_bits,
            latent_bits=latent_bits,
            total_bits=hyper_bits + latent_bits,
            hyperlatent_bpp=hyper_bits / n_pixels,
            latent_bpp=latent_bits / n_pixels,
            total_bpp=(hyper_bits + latent_bits) / n_pixels,
        )

    @_codec_numerics
    @torch.inference_mode()
    def decode_symbols(self, out: CompressionOutput
                       ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
        """rANS-decode both streams -> (z_sym, y_sym) NCHW int32 and the
        latent means mu on the device."""
        if not self._tables_built:
            self.build_tables()
        z_np = self.factorized.decompress_symbols(
            out.hyperlatents_encoded, out.batch_shape,
            out.hyperlatent_spatial_shape)
        z_sym = torch.from_numpy(z_np).to(self.device, torch.int16).contiguous(
            memory_format=torch.channels_last)
        # The same function the encoder took its indices from.
        mu, _, idx = self.model.synth_stats(z_sym, self.scale_table)
        y_np = self.conditional.decompress_symbols(out.latents_encoded,
                                                   _numpy(idx, np.int32))
        return z_np, y_np, mu

    @_codec_numerics
    @torch.inference_mode()
    def decompress(self, out: CompressionOutput, as_uint8: bool = False
                   ) -> np.ndarray:
        """Reconstruction (N, H, W, 3): float in [0, 1], or uint8
        round(x * 255) when `as_uint8`."""
        _, y_np, mu = self.decode_symbols(out)
        y_hat = torch.from_numpy(y_np).to(self.device, torch.float32).contiguous(
            memory_format=torch.channels_last) + mu
        recon = self.model.generate(y_hat, out.spatial_shape)
        if as_uint8:
            recon = (recon * 255.0 + 0.5).to(torch.uint8)
        return recon.permute(0, 2, 3, 1).cpu().numpy()

    def compress_file(self, x, path: str) -> Tuple[float, float]:
        """Compress to a `.hfc` file; returns (actual_bpp, theoretical_bpp)."""
        return save_compressed(self.compress(x), path)

    def decompress_file(self, path: str, as_uint8: bool = False
                        ) -> np.ndarray:
        return self.decompress(load_compressed(path), as_uint8=as_uint8)
