"""The codec: image <-> `.hfc` bitstream, on one device plus the host coder.

Counterpart of the JAX package's `Codec` (`compress`, `decompress`,
`compress_file`, `decompress_file`, `compress_many`, `decompress_many`).
Public tensors are NHWC like the JAX package's; inside, activations are NCHW
in `torch.channels_last` memory, so every ChannelNorm reads contiguous
(pixel, channel) rows.

Encode: pixels -> `HiFiC.compress_front` -> `synth_stats` ->
`latent_symbols` -> rANS of z and y -> `.hfc`. Decode: rANS of z on the
host -> the same `synth_stats` -> rANS of y -> `generate`. The coding
indices of both sides come from `HiFiC.synth_stats` on the hyperlatent
symbols, which is what keeps the two sides' CDF rows identical.

Two coders write the same bytes. The host coder (`entropy/coding.py`, the
native `rans.cc`) fetches the symbol planes; the device coders
(`entropy/device_encode.py`, `device_decode.py`, CUDA kernels on the card)
code where the symbols are, a batch of streams per kernel launch. On a CUDA
codec every batch-1 input, tiled or not, takes the device encoder
(`compress`; `compress_many` codes the y and z streams of all its images in
one launch) and every batch-1 payload the device decoder (`decompress`,
`decompress_many`: the y streams of all of them in one launch). A payload
of a larger batch takes the host coder, as does a CPU codec unless asked
(`device_encode=True`, `device_decode=True` run the kernels' plain
versions); `device_encode=False` / `device_decode=False` ask for the host
coder. The JAX package's `compress` takes its host coder by default, a
choice made for its accelerator's wire. The streams that overrun a device
buffer's default capacity are launched again on the device with buffers of
the demand they reported.

Tiling (`compress(tile_image=)`, `decompress(tile_latents=)`,
`decompress_many(tile_latents=)`): the encoder runs on clamped image tiles
whose assembled latents equal the whole image's, and the generator on
reflect-padded latent tiles whose cores cross to the host while later
tiles run (`tiling.py`). The coders are the untiled encode's and decode's.
`reconstruct` is the round trip without entropy coding. Not ported yet:
`pipeline_chunk`, `wire_chunk` and the packed host-coder wire,
`coder_threads` (container v2) and the spatial methods.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy.container import (
    CompressionOutput,
    load_compressed,
    save_compressed,
)
from hific_tpu_torch.entropy.device_decode import (
    DecodeJob,
    decode_scan_many,
    words_tensor,
)
from hific_tpu_torch.entropy.device_encode import (
    Z_SPILL_BITS,
    EncodeJob,
    default_caps,
    encode_scan_many,
)
from hific_tpu_torch.entropy.entropy_models import (
    ConditionalEntropyModel,
    FactorizedEntropyModel,
)
from hific_tpu_torch.entropy.rans_tables import rans_tables
from hific_tpu_torch.models.hific import HiFiC
from hific_tpu_torch.ops.padding import pad_factor
from hific_tpu_torch.runtime import Fetch, fp32_numerics, resolve_device
from hific_tpu_torch.tiling import tiled_downsample_apply, tiled_upsample_apply

# The encoder's downsampling factor (and the generator's upsampling one).
ENC_SCALE = 16


# The device work of the codec's methods runs with TF32 off and
# deterministic cuDNN, in the config's dtype. TF32 keeps ~3 digits, enough
# to move sigma across a scale-table boundary, and an index that differs
# between encoder and decoder desyncs the rANS lanes; deterministic
# algorithms keep the encoder's and the decoder's synth_stats bit-identical
# on one card, in bfloat16 as in float32. The settings hold for the call
# only, so a trainer in the same process keeps its own.
_codec_numerics = fp32_numerics(deterministic=True)


def _numpy(t: torch.Tensor, dtype) -> np.ndarray:
    return t.cpu().numpy().astype(dtype)


def _lanes(t: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W) -> (H * W, C) int32: channels as lanes, positions in
    row-major order (the host coder's lane layout)."""
    _, c, h, w = t.shape
    return t.permute(0, 2, 3, 1).reshape(h * w, c).to(torch.int32).contiguous()


def _output(z_encoded, y_encoded, hyper_spatial, spatial_shape, hyper_coding,
            latent_coding, batch, hyper_bits, latent_bits, compute_dtype
            ) -> CompressionOutput:
    n_pixels = float(np.prod(spatial_shape))
    return CompressionOutput(
        hyperlatents_encoded=z_encoded,
        latents_encoded=y_encoded,
        hyperlatent_spatial_shape=tuple(hyper_spatial),
        spatial_shape=tuple(spatial_shape),
        hyper_coding_shape=tuple(hyper_coding),
        latent_coding_shape=tuple(latent_coding),
        batch_shape=batch,
        hyperlatent_bits=hyper_bits,
        latent_bits=latent_bits,
        total_bits=hyper_bits + latent_bits,
        hyperlatent_bpp=hyper_bits / n_pixels,
        latent_bpp=latent_bits / n_pixels,
        total_bpp=(hyper_bits + latent_bits) / n_pixels,
        compute_dtype=compute_dtype,
    )


def _split_streams(fetched: np.ndarray, jobs):
    """A fetched encode buffer -> the uint32 words [counts (3), stream (2 L
    + spill_cap)] of each job, and the words after them."""
    words, parts, at = fetched.view(np.uint32), [], 0
    for job in jobs:
        n = 3 + 2 * job.sym_l.shape[1] + job.spill_cap
        parts.append(words[at:at + n])
        at += n
    return parts, words[at:]


class _StagedEncode(NamedTuple):
    """One image's device work up to its symbols, enqueued: the y and z
    jobs of the encode kernel at the default caps, and the Shannon bits."""
    jobs: tuple          # (y EncodeJob, z EncodeJob)
    bits: torch.Tensor   # int32 view of float32 (hyperlatent, latent)
    z_chw: tuple
    y_channels: int


class Codec:
    """Evaluation-mode compression/decompression engine, in the config's
    compute dtype (`Config.dtype`) as the JAX package's `Codec`. A DLMM
    or `sample_noise` config is refused: the JAX package has no compress
    path for either (the DLMM prior is a training-only estimate, and its
    codec draws no generator noise)."""

    def __init__(self, config: Config, state_dict, device=None):
        refused = [name for name, on in (
            ("use_latent_mixture_model", config.use_latent_mixture_model),
            ("sample_noise", config.sample_noise)) if on]
        if refused:
            raise ValueError(f"no codec for a config with {' and '.join(refused)}"
                             f": the JAX package has no compress path for it "
                             f"either")
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
        self._rans_tables = None  # (y, z) RansTables on the device
        # Images whose device encode overran a buffer's default cap and
        # were launched again with larger buffers (compress and
        # compress_many).
        self.device_relaunches = 0

    def build_tables(self):
        """Build the hyperlatent probability tables (once per model) and
        ship both coders' tables to the device."""
        self.factorized.build_tables()
        self._rans_tables = tuple(
            rans_tables(t.cdf, t.cdf_length, t.cdf_offset, t.precision,
                        inverse=t.inverse).to(self.device)
            for t in (self.conditional.tables, self.factorized.tables))
        self._tables_built = True

    def _model_input(self, x, shape_bucket: Optional[int] = None
                     ) -> torch.Tensor:
        """NHWC uint8 or float image -> NCHW channels-last float32 on the
        codec's device (uint8 maps to [0, 1] as the JAX package does),
        reflect-padded to multiples of `shape_bucket`."""
        x = torch.as_tensor(x).to(self.device)
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"expected an NHWC RGB image, got {tuple(x.shape)}")
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
            if self.config.normalize_input_image:
                x = x * 2.0 - 1.0
        else:
            x = x.to(torch.float32)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return pad_factor(x, shape_bucket) if shape_bucket else x

    def _front(self, x: torch.Tensor, tile_image: Optional[int] = None,
               halo_image: int = 64):
        """`compress_front` of the model input, its encoder on image tiles
        when `tile_image` is given."""
        if tile_image is None:
            return self.model.compress_front(x)
        y = tiled_downsample_apply(self.model.encoder, x, scale=ENC_SCALE,
                                   tile=tile_image, halo=halo_image)
        return self.model.compress_front_from_latents(y)

    @_codec_numerics
    @torch.inference_mode()
    def _symbols(self, x: torch.Tensor, tile_image: Optional[int] = None,
                 halo_image: int = 64):
        """Model input -> numpy (z_sym, y_sym, idx) in NCHW int32 and the
        hyperlatent and latent Shannon bits."""
        y, z_sym, hyper_bits = self._front(x, tile_image, halo_image)
        mu, sigma, idx = self.model.synth_stats(z_sym, self.scale_table)
        y_sym, latent_bits = self.model.latent_symbols(y, mu, sigma)
        return (_numpy(z_sym, np.int32), _numpy(y_sym, np.int32),
                _numpy(idx, np.int32), float(hyper_bits), float(latent_bits))

    def encode_symbols(self, x):
        """Image -> numpy (z_sym, y_sym, idx) in NCHW int32, the hyperlatent
        and latent Shannon bits, and the image's (H, W)."""
        x = self._model_input(x)
        return self._symbols(x) + (tuple(int(s) for s in x.shape[2:]),)

    def _host_compress(self, x: torch.Tensor, spatial_shape,
                       tile_image: Optional[int] = None,
                       halo_image: int = 64) -> CompressionOutput:
        """Host rANS coding of the model input's symbol planes."""
        z_sym, y_sym, idx, hyper_bits, latent_bits = self._symbols(
            x, tile_image, halo_image)
        z_encoded, hyper_coding_shape = self.factorized.compress_symbols(z_sym)
        y_encoded, latent_coding_shape = self.conditional.compress_symbols(
            y_sym, idx)
        return _output(z_encoded, y_encoded, z_sym.shape[2:], spatial_shape,
                       hyper_coding_shape, latent_coding_shape,
                       z_sym.shape[0], hyper_bits, latent_bits,
                       self.config.dtype)

    # ------------------------------------------------------------------ #
    # The device encoder

    @staticmethod
    def _device_encode_eligible(x: torch.Tensor) -> bool:
        """Batch 1: the lane layout of the device coders (channels as lanes
        over positions)."""
        return int(x.shape[0]) == 1

    def _use_device_encode(self, x: torch.Tensor,
                           device_encode: Optional[bool]) -> bool:
        eligible = self._device_encode_eligible(x)
        if device_encode and not eligible:
            raise ValueError("device_encode=True but the input is not "
                             "eligible for the device encoder (batch 1)")
        if device_encode is None:
            return self.device.type == "cuda" and eligible
        return device_encode

    @_codec_numerics
    @torch.inference_mode()
    def _stage_device_compress(self, x: torch.Tensor,
                               tile_image: Optional[int] = None,
                               halo_image: int = 64) -> _StagedEncode:
        """Enqueue one model input's device work up to the symbols: front
        (its encoder on image tiles when `tile_image` is given) -> the one
        shared synth_stats -> latent symbols, laid out for the encode
        kernel. Blocks on nothing."""
        y, z_sym, hyper_bits = self._front(x, tile_image, halo_image)
        mu, sigma, idx = self.model.synth_stats(z_sym, self.scale_table)
        y_sym, latent_bits = self.model.latent_symbols(y, mu, sigma)
        (_, cy, hy, wy), (_, cz, hz, wz) = y_sym.shape, z_sym.shape
        z_idx = torch.arange(cz, dtype=torch.int32, device=x.device)
        y_tables, z_tables = self._rans_tables
        jobs = (EncodeJob(_lanes(y_sym), _lanes(idx), y_tables,
                          *default_caps(hy * wy, cy)),
                EncodeJob(_lanes(z_sym), z_idx.expand(hz * wz, cz).contiguous(),
                          z_tables, *default_caps(hz * wz, cz, Z_SPILL_BITS)))
        bits = torch.stack([hyper_bits.float(),
                            latent_bits.float()]).view(torch.int32)
        return _StagedEncode(jobs, bits, (cz, hz, wz), cy)

    @staticmethod
    @torch.inference_mode()
    def _encode(jobs, extra=()) -> Fetch:
        """One launch of the encode kernel over `jobs` and the enqueued
        fetch of one int32 buffer: [counts (3), stream (2 L + spill_cap)]
        per job, then the `extra` tensors."""
        outs = encode_scan_many(jobs)
        return Fetch(torch.cat([t for stream, _, counts in outs
                                 for t in (counts, stream)] + list(extra)))

    def _device_compress(self, staged, spatial_shapes) -> list:
        """The y and z streams of every staged image in one encode launch.
        The streams that overran their buffers are coded again, in one
        more launch, with caps at the demand the kernel reported (writes
        past a cap are dropped but counted), so it writes every word."""
        jobs = [job for item in staged for job in item.jobs]
        streams, bits = _split_streams(self._encode(
            jobs, [item.bits for item in staged]).result(), jobs)
        bits = bits.view(np.float32).reshape(-1, 2)
        overran = [k for k, (w, job) in enumerate(zip(streams, jobs))
                   if w[0] > job.spill_cap or w[1] > job.lens_cap]
        if overran:
            self.device_relaunches += len({k // 2 for k in overran})
            again = [jobs[k]._replace(
                spill_cap=max(int(streams[k][0]), jobs[k].spill_cap),
                lens_cap=max(int(streams[k][1]), jobs[k].lens_cap))
                for k in overran]
            for k, words in zip(overran, _split_streams(
                    self._encode(again).result(), again)[0]):
                streams[k] = words
        bad = sum(int(w[2]) for w in streams)
        if bad:
            raise RuntimeError(f"device encode read {bad} CDF row indices "
                               f"outside the tables")
        encoded = [w[3:3 + 2 * job.sym_l.shape[1] + int(w[0])].copy()
                   for w, job in zip(streams, jobs)]
        outputs = []
        for i, (item, spatial_shape) in enumerate(zip(staged, spatial_shapes)):
            cz, hz, wz = item.z_chw
            hyper_bits, latent_bits = (float(b) for b in bits[i])
            outputs.append(_output(
                encoded[2 * i + 1], encoded[2 * i], (hz, wz), spatial_shape,
                (cz, 1, 1), (item.y_channels, 1, 1), 1, hyper_bits,
                latent_bits, self.config.dtype))
        return outputs

    def compress(self, x, shape_bucket: Optional[int] = None,
                 tile_image: Optional[int] = None, halo_image: int = 64,
                 device_encode: Optional[bool] = None) -> CompressionOutput:
        """x: (N, H, W, 3) uint8, or float in the model's input range.

        shape_bucket: reflect-pad H and W up to multiples of this before
        encoding (the decoder crops back to the image's size).
        tile_image: run the encoder on image tiles of this size with
        `halo_image` pixels of context (both multiples of 16), bounding
        the encoder's device memory for large images; the bytes equal the
        whole-image encode's when halo_image is at least the encoder's
        one-sided receptive extent (49 px; default 64).
        device_encode: code on the device. By default a CUDA codec does for
        a batch-1 input, tiled or not, and a CPU codec takes the host
        coder; True codes on any device (the kernel's plain version on the
        CPU) and raises on a larger batch; False takes the host coder. The
        bytes are the same either way."""
        if not self._tables_built:
            self.build_tables()
        spatial_shape = tuple(int(s) for s in np.shape(x)[1:3])
        x = self._model_input(x, shape_bucket)
        if self._use_device_encode(x, device_encode):
            return self._device_compress(
                [self._stage_device_compress(x, tile_image, halo_image)],
                [spatial_shape])[0]
        return self._host_compress(x, spatial_shape, tile_image, halo_image)

    def compress_many(self, images, shape_bucket: Optional[int] = None,
                      device_encode: Optional[bool] = None) -> list:
        """Batch compression. On a CUDA codec every batch-1 image takes the
        device encoder: each image's device work is enqueued, then the y
        and z streams of all of them are coded in one launch and fetched in
        one buffer, the streams whole. An image of a larger batch
        takes the host coder, as in the JAX package: its stream's lanes are
        every (channel, pixel) of a position, a layout the device coders do
        not have. device_encode: True takes the device encoder on any
        device (its plain version on the CPU) and raises on a larger batch;
        False takes the host coder. shape_bucket: as in `compress`."""
        if not self._tables_built:
            self.build_tables()
        staged = []
        for image in images:
            spatial_shape = tuple(int(s) for s in np.shape(image)[1:3])
            x = self._model_input(image, shape_bucket)
            if self._use_device_encode(x, device_encode):
                staged.append((spatial_shape, self._stage_device_compress(x)))
            else:
                staged.append((spatial_shape, x))
        on_device = [k for k, (_, item) in enumerate(staged)
                     if isinstance(item, _StagedEncode)]
        results = dict(zip(on_device, self._device_compress(
            [staged[k][1] for k in on_device],
            [staged[k][0] for k in on_device]) if on_device else []))
        return [results[k] if k in results
                else self._host_compress(item, spatial_shape)
                for k, (spatial_shape, item) in enumerate(staged)]

    # ------------------------------------------------------------------ #
    # Decoding

    @_codec_numerics
    @torch.inference_mode()
    def decode_symbols(self, out: CompressionOutput
                       ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
        """rANS-decode both streams on the host -> (z_sym, y_sym) NCHW int32
        and the latent means mu on the device."""
        if not self._tables_built:
            self.build_tables()
        self._check_compute_dtype(out)
        z_np, mu, idx = self._hyper_stats(out)
        y_np = self.conditional.decompress_symbols(out.latents_encoded,
                                                   _numpy(idx, np.int32))
        return z_np, y_np, mu

    def _hyper_stats(self, out: CompressionOutput):
        """Host rANS of z (~1 ms) -> (z_sym numpy, mu, idx on the device):
        the same synth_stats the encoder took its indices from."""
        z_np = self.factorized.decompress_symbols(
            out.hyperlatents_encoded, out.batch_shape,
            out.hyperlatent_spatial_shape)
        z_sym = torch.from_numpy(z_np).to(self.device, torch.int16).contiguous(
            memory_format=torch.channels_last)
        mu, _, idx = self.model.synth_stats(z_sym, self.scale_table)
        return z_np, mu, idx

    def _generate(self, y_hat, spatial_shape, as_uint8: bool) -> torch.Tensor:
        """Latents -> NHWC reconstruction on the device: uint8, mapped in
        the model's dtype as the JAX package maps it, or float32."""
        recon = self.model.generate(y_hat, spatial_shape)
        if as_uint8:
            recon = (recon * 255.0 + 0.5).to(torch.uint8)
        else:
            recon = recon.float()
        return recon.permute(0, 2, 3, 1)

    def _host_latents(self, out: CompressionOutput) -> torch.Tensor:
        """Host rANS of both streams -> the quantized latents y + mu on
        the device."""
        _, y_np, mu = self.decode_symbols(out)
        return torch.from_numpy(y_np).to(self.device, torch.float32).contiguous(
            memory_format=torch.channels_last) + mu

    def _device_latents(self, outs):
        """Enqueue the device decode of a batch of payloads: per image the
        host rANS of z, the stream's upload and the shared synth_stats; the
        y streams of all of them in one decode launch. Returns (the
        quantized latents y + mu of each, the kernel's counts of bad
        indices), all on the device; blocks on nothing."""
        stats = [self._hyper_stats(o) for o in outs]
        decoded = decode_scan_many([
            DecodeJob(words_tensor(o.latents_encoded, self.device),
                      _lanes(idx), self._rans_tables[0])
            for o, (_, _, idx) in zip(outs, stats)])
        y_hats = []
        for (_, mu, idx), (y_sym, _) in zip(stats, decoded):
            _, cy, hy, wy = idx.shape
            y_hats.append(
                y_sym.view(1, hy, wy, cy).permute(0, 3, 1, 2).float() + mu)
        return y_hats, torch.cat([bad for _, bad in decoded])

    def _tiled_generate(self, y_hat, spatial_shape, tile: int, halo: int,
                        as_uint8: bool) -> np.ndarray:
        """The generator on latent tiles of `tile` with `halo` latents of
        context, assembled on the host."""
        ext = (tile + 2 * halo) * ENC_SCALE
        recon = tiled_upsample_apply(
            lambda lat: self._generate(lat, (ext, ext), as_uint8),
            y_hat, scale=ENC_SCALE, tile=tile, halo=halo)
        h, w = spatial_shape
        return recon[:, :h, :w]

    def _check_compute_dtype(self, out: CompressionOutput) -> None:
        """Raise for a payload coded in another compute dtype: its coding
        indices came from another hyper synthesis, so decoding it here
        could desync the rANS lanes without an error."""
        if out.compute_dtype != self.config.dtype:
            raise ValueError(
                f"payload coded by a {out.compute_dtype} codec; this codec "
                f"computes in {self.config.dtype} (Config.dtype), whose "
                f"coding indices may differ")

    @staticmethod
    def _device_decode_eligible(out: CompressionOutput) -> bool:
        """Batch 1 (unsharded, which is all the port reads)."""
        return int(out.batch_shape) == 1

    @staticmethod
    def _check_bad(bad: Optional[Fetch]) -> None:
        """Raise if the device decoder read an index outside the tables
        (waits for the fetch of its counts)."""
        n = 0 if bad is None else int(bad.result().sum())
        if n:
            raise RuntimeError(f"device decode read {n} CDF row indices "
                               f"outside the tables")

    def _use_device_decode(self, outs,
                           device_decode: Optional[bool]) -> bool:
        eligible = all(self._device_decode_eligible(o) for o in outs)
        if device_decode and not eligible:
            raise ValueError("device_decode=True but a payload is not "
                             "eligible: the device decoder covers "
                             "single-image payloads")
        if device_decode is None:
            return eligible and self.device.type == "cuda"
        return device_decode

    def decompress(self, out: CompressionOutput,
                   tile_latents: Optional[int] = None,
                   halo_latents: int = 16, as_uint8: bool = False,
                   device_decode: Optional[bool] = None) -> np.ndarray:
        """Reconstruction (N, H, W, 3): float in [0, 1], or uint8
        round(x * 255) when `as_uint8`. tile_latents: run the generator on
        latent tiles of this size with `halo_latents` of context, its
        output assembled on the host (on the H100 this does not lower the
        peak: see ROADMAP.md section 1). device_decode: rANS-decode the
        latents on the device; by default a CUDA codec does for a batch-1
        payload, tiled or not, and a CPU codec takes the host coder; True
        decodes on any device (the kernel's plain version on the CPU) and
        raises on a larger batch. The result is the same either way."""
        return self.decompress_many(
            [out], as_uint8=as_uint8, tile_latents=tile_latents,
            halo_latents=halo_latents, device_decode=device_decode)[0]

    @_codec_numerics
    @torch.inference_mode()
    def decompress_many(self, outs, as_uint8: bool = True,
                        as_numpy: bool = True,
                        tile_latents: Optional[int] = None,
                        halo_latents: int = 16,
                        device_decode: Optional[bool] = None) -> list:
        """Batch decompression. On the device decoder (chosen as in
        `decompress`) the y streams of all payloads are decoded in one
        launch, and every image's generation and copy to the host are
        enqueued before the host waits for the first. as_numpy=False
        returns NHWC tensors on the codec's device (after one wait for the
        kernel's index checks). tile_latents: each payload's generator run
        on latent tiles as in `decompress` (numpy results)."""
        if not self._tables_built:
            self.build_tables()
        if not outs:
            return []
        for out in outs:
            self._check_compute_dtype(out)
        bad = None
        if self._use_device_decode(outs, device_decode):
            y_hats, bad = self._device_latents(outs)
            bad = Fetch(bad)
        else:
            y_hats = [self._host_latents(o) for o in outs]
        if tile_latents is not None:
            imgs = [self._tiled_generate(y, o.spatial_shape, tile_latents,
                                         halo_latents, as_uint8)
                    for o, y in zip(outs, y_hats)]
            self._check_bad(bad)
            return imgs
        imgs = [self._generate(y, o.spatial_shape, as_uint8)
                for o, y in zip(outs, y_hats)]
        if not as_numpy:
            self._check_bad(bad)
            return imgs
        fetches = [Fetch(img) for img in imgs]
        self._check_bad(bad)
        return [img.result() for img in fetches]

    @_codec_numerics
    @torch.inference_mode()
    def reconstruct(self, x) -> np.ndarray:
        """Reconstruction without entropy coding (the reference's
        `--reconstruct` mode): pad -> encode -> hard quantization ->
        generate. x as in `compress`; returns NHWC float in [0, 1] on the
        host."""
        spatial_shape = tuple(int(s) for s in np.shape(x)[1:3])
        y, _ = self.model.encode(self._model_input(x))
        z_q = torch.floor(self.model.hyperprior.analyze(y) + 0.5)
        mu, _ = self.model.hyperprior.synthesize(z_q)
        y_q = torch.floor(y - mu + 0.5) + mu
        return self._generate(y_q, spatial_shape, False).cpu().numpy()

    def compress_file(self, x, path: str) -> Tuple[float, float]:
        """Compress to a `.hfc` file; returns (actual_bpp, theoretical_bpp)."""
        return save_compressed(self.compress(x), path)

    def decompress_file(self, path: str, as_uint8: bool = False
                        ) -> np.ndarray:
        return self.decompress(load_compressed(path), as_uint8=as_uint8)
