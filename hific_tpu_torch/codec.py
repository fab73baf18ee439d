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
code where the symbols are. As in the JAX package on its accelerator, on a
CUDA codec `compress` uses the host coder unless asked, `compress_many` the
device encoder for every batch-1 image, and `decompress(as_uint8=True)` and
`decompress_many` the device decoder wherever the payload is batch 1; a CPU
codec takes the host coder unless asked (`device_encode=True`,
`device_decode=True` run the kernels' plain versions). An encode that
overruns a device buffer's default capacity is launched again on the device
with buffers of the demand it reported. Not ported yet: `pipeline_chunk`, `wire_chunk` and the packed host-coder
wire, tiling, `coder_threads` (container v2) and the spatial methods.
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
    build_device_tables,
    decode_scan,
    words_tensor,
)
from hific_tpu_torch.entropy.device_encode import (
    Z_SPILL_BITS,
    assemble_stream,
    default_caps,
    encode_scan,
    encode_tables,
)
from hific_tpu_torch.entropy.entropy_models import (
    ConditionalEntropyModel,
    FactorizedEntropyModel,
)
from hific_tpu_torch.models.hific import HiFiC
from hific_tpu_torch.ops.padding import pad_factor
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


def _lanes(t: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W) -> (H * W, C) int32: channels as lanes, positions in
    row-major order (the host coder's lane layout)."""
    _, c, h, w = t.shape
    return t.permute(0, 2, 3, 1).reshape(h * w, c).to(torch.int32).contiguous()


class _Fetch:
    """A device tensor's copy to the host, enqueued now on the current
    stream (into pinned memory) and waited for only by `result`."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _output(z_encoded, y_encoded, hyper_spatial, spatial_shape, hyper_coding,
            latent_coding, batch, hyper_bits, latent_bits
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
    )


class _PendingEncode(NamedTuple):
    """One image's enqueued device encode: the buffer's fetch, and what a
    relaunch at larger caps needs."""
    fetch: _Fetch
    lanes: tuple    # (y symbols, y indices, z symbols, z indices), (P, L)
    bits: torch.Tensor
    caps: tuple     # (y spill, y events, z spill, z events)
    z_chw: tuple
    y_chw: tuple


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
        self._enc_tables = None   # (y, z) EncodeTables on the device
        self._dec_tables = None   # y DeviceTables on the device
        # Device encodes that overran a buffer's default cap and were
        # launched again with larger buffers (compress and compress_many).
        self.device_relaunches = 0

    def build_tables(self):
        """Build the hyperlatent probability tables (once per model) and
        ship both coders' tables to the device."""
        self.factorized.build_tables()
        y, z = self.conditional.tables, self.factorized.tables
        self._enc_tables = tuple(
            encode_tables(t.cdf, t.cdf_length, t.cdf_offset, self.device)
            for t in (y, z))
        self._dec_tables = build_device_tables(
            y.cdf, y.cdf_length, y.cdf_offset, y.inverse).to(self.device)
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

    @_codec_numerics
    @torch.inference_mode()
    def _symbols(self, x: torch.Tensor):
        """Model input -> numpy (z_sym, y_sym, idx) in NCHW int32 and the
        hyperlatent and latent Shannon bits."""
        y, z_sym, hyper_bits = self.model.compress_front(x)
        mu, sigma, idx = self.model.synth_stats(z_sym, self.scale_table)
        y_sym, latent_bits = self.model.latent_symbols(y, mu, sigma)
        return (_numpy(z_sym, np.int32), _numpy(y_sym, np.int32),
                _numpy(idx, np.int32), float(hyper_bits), float(latent_bits))

    def encode_symbols(self, x):
        """Image -> numpy (z_sym, y_sym, idx) in NCHW int32, the hyperlatent
        and latent Shannon bits, and the image's (H, W)."""
        x = self._model_input(x)
        return self._symbols(x) + (tuple(int(s) for s in x.shape[2:]),)

    def _host_compress(self, x: torch.Tensor, spatial_shape
                       ) -> CompressionOutput:
        """Host rANS coding of the model input's symbol planes."""
        z_sym, y_sym, idx, hyper_bits, latent_bits = self._symbols(x)
        z_encoded, hyper_coding_shape = self.factorized.compress_symbols(z_sym)
        y_encoded, latent_coding_shape = self.conditional.compress_symbols(
            y_sym, idx)
        return _output(z_encoded, y_encoded, z_sym.shape[2:], spatial_shape,
                       hyper_coding_shape, latent_coding_shape,
                       z_sym.shape[0], hyper_bits, latent_bits)

    # ------------------------------------------------------------------ #
    # The device encoder

    @staticmethod
    def _device_encode_eligible(x: torch.Tensor) -> bool:
        """Batch 1: the lane layout of the device coders (channels as
        lanes over positions)."""
        return int(x.shape[0]) == 1

    def _use_device_encode(self, x: torch.Tensor,
                           device_encode: Optional[bool]) -> bool:
        if device_encode and not self._device_encode_eligible(x):
            raise ValueError("device_encode=True but the input is not "
                             "eligible for the device encoder (batch 1)")
        if device_encode is None:
            return (self.device.type == "cuda"
                    and self._device_encode_eligible(x))
        return device_encode

    @_codec_numerics
    @torch.inference_mode()
    def _enqueue_device_compress(self, x: torch.Tensor) -> _PendingEncode:
        """Enqueue the device encode of one model input: front -> the one
        shared synth_stats -> latent symbols -> the rANS kernels of y and z,
        at the default caps. Blocks on nothing."""
        y, z_sym, hyper_bits = self.model.compress_front(x)
        mu, sigma, idx = self.model.synth_stats(z_sym, self.scale_table)
        y_sym, latent_bits = self.model.latent_symbols(y, mu, sigma)
        (_, cy, hy, wy), (_, cz, hz, wz) = y_sym.shape, z_sym.shape
        z_idx = torch.arange(cz, dtype=torch.int32, device=x.device)
        lanes = (_lanes(y_sym), _lanes(idx), _lanes(z_sym),
                 z_idx.expand(hz * wz, cz).contiguous())
        bits = torch.stack([hyper_bits, latent_bits]).float().view(torch.int32)
        caps = (*default_caps(hy * wy, cy),
                *default_caps(hz * wz, cz, Z_SPILL_BITS))
        return _PendingEncode(self._launch_encode(lanes, bits, caps), lanes,
                              bits, caps, (cz, hz, wz), (cy, hy, wy))

    @torch.inference_mode()
    def _launch_encode(self, lanes, bits, caps) -> _Fetch:
        """The rANS kernels of y and z at `caps` (y spill, y events, z
        spill, z events), and the enqueued fetch of one packed int32 buffer:
        [y counts (3), z counts (3), bits (2, float32), y heads, z heads,
        y lens, z lens, y spill, z spill], not the symbol planes."""
        y_tables, z_tables = self._enc_tables
        y_out = encode_scan(lanes[0], lanes[1], y_tables, caps[0], caps[1])
        z_out = encode_scan(lanes[2], lanes[3], z_tables, caps[2], caps[3])
        return _Fetch(torch.cat([
            y_out[3], z_out[3], bits, y_out[0].reshape(-1),
            z_out[0].reshape(-1), y_out[2], z_out[2], y_out[1], z_out[1]]))

    def _finish_device_compress(self, pending: _PendingEncode, spatial_shape
                                ) -> CompressionOutput:
        """Wait for the fetched buffer and assemble the streams. A stream
        that overran its buffers is coded again on the device with caps at
        the demand the kernels reported (writes past a cap are dropped but
        counted), so the second launch writes every word."""
        (cz, hz, wz), (cy, hy, wy) = pending.z_chw, pending.y_chw
        words = pending.fetch.result().view(np.uint32)
        caps = pending.caps
        demand = tuple(int(v) for v in words[[0, 1, 3, 4]])
        if any(d > c for d, c in zip(demand, caps)):
            self.device_relaunches += 1
            caps = tuple(max(d, c) for d, c in zip(demand, caps))
            words = self._launch_encode(pending.lanes, pending.bits,
                                        caps).result().view(np.uint32)
        y_s, y_e, y_bad, z_s, z_e, z_bad = (int(v) for v in words[:6])
        if y_bad or z_bad:
            raise RuntimeError(f"device encode read {y_bad + z_bad} CDF row "
                               f"indices outside the tables")
        hyper_bits, latent_bits = (float(v) for v in words[6:8].view(
            np.float32))
        y_sp, y_le, z_sp, z_le = caps
        sizes = (2 * cy, 2 * cz, y_le, z_le, y_sp, z_sp)
        y_heads, z_heads, y_lens, z_lens, y_spill, z_spill = np.split(
            words[8:], np.cumsum(sizes)[:-1])
        return _output(assemble_stream(z_heads, z_spill, z_lens, z_s, z_e),
                       assemble_stream(y_heads, y_spill, y_lens, y_s, y_e),
                       (hz, wz), spatial_shape, (cz, 1, 1), (cy, 1, 1), 1,
                       hyper_bits, latent_bits)

    def compress(self, x, shape_bucket: Optional[int] = None,
                 device_encode: Optional[bool] = None) -> CompressionOutput:
        """x: (N, H, W, 3) uint8, or float in the model's input range.

        shape_bucket: reflect-pad H and W up to multiples of this before
        encoding (the decoder crops back to the image's size).
        device_encode: code on the device (batch 1 only; True on a larger
        batch raises). The default is the host coder, as the JAX package's;
        the bytes are the same either way."""
        if not self._tables_built:
            self.build_tables()
        spatial_shape = tuple(int(s) for s in np.shape(x)[1:3])
        x = self._model_input(x, shape_bucket)
        if device_encode and self._use_device_encode(x, device_encode):
            return self._finish_device_compress(
                self._enqueue_device_compress(x), spatial_shape)
        return self._host_compress(x, spatial_shape)

    def compress_many(self, images, shape_bucket: Optional[int] = None,
                      device_encode: Optional[bool] = None) -> list:
        """Batch compression. On a CUDA codec every batch-1 image takes the
        device encoder, and its device work is enqueued before the host
        waits for the first image's buffer, so the card codes later images
        while the host assembles earlier ones. An image of a larger batch
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
                staged.append((spatial_shape, self._enqueue_device_compress(x)))
            else:
                staged.append((spatial_shape, x))
        return [self._finish_device_compress(item, spatial_shape)
                if isinstance(item, _PendingEncode)
                else self._host_compress(item, spatial_shape)
                for spatial_shape, item in staged]

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
        """Latents -> NHWC reconstruction on the device."""
        recon = self.model.generate(y_hat, spatial_shape)
        if as_uint8:
            recon = (recon * 255.0 + 0.5).to(torch.uint8)
        return recon.permute(0, 2, 3, 1)

    @_codec_numerics
    @torch.inference_mode()
    def _host_decode(self, out: CompressionOutput, as_uint8: bool
                     ) -> torch.Tensor:
        _, y_np, mu = self.decode_symbols(out)
        y_hat = torch.from_numpy(y_np).to(self.device, torch.float32).contiguous(
            memory_format=torch.channels_last) + mu
        return self._generate(y_hat, out.spatial_shape, as_uint8)

    @staticmethod
    def _device_decode_eligible(out: CompressionOutput) -> bool:
        """Batch 1 (unsharded, which is all the port reads)."""
        return int(out.batch_shape) == 1

    @_codec_numerics
    @torch.inference_mode()
    def _device_decode_u8(self, out: CompressionOutput):
        """Enqueue one image's device decode: host rANS of z, the stream's
        upload, the shared synth_stats, the decode kernel, `generate` to
        uint8. Returns (NHWC uint8, the kernel's count of bad indices),
        both on the device; blocks on nothing."""
        _, mu, idx = self._hyper_stats(out)
        y_sym, bad = decode_scan(words_tensor(out.latents_encoded,
                                              self.device),
                                 _lanes(idx), self._dec_tables)
        _, cy, hy, wy = idx.shape
        y_hat = y_sym.view(1, hy, wy, cy).permute(0, 3, 1, 2).float() + mu
        return self._generate(y_hat, out.spatial_shape, True), bad

    @staticmethod
    def _check_bad(bad: np.ndarray) -> None:
        if int(bad.sum()):
            raise RuntimeError(f"device decode read {int(bad.sum())} CDF row "
                               f"indices outside the tables")

    def _check_device_decode(self, outs, as_uint8: bool,
                             device_decode: Optional[bool]) -> bool:
        eligible = as_uint8 and all(self._device_decode_eligible(o)
                                    for o in outs)
        if device_decode and not eligible:
            raise ValueError("device_decode=True but a payload is not "
                             "eligible: the device decoder covers uint8 "
                             "output of single-image payloads")
        if device_decode is None:
            return eligible and self.device.type == "cuda"
        return device_decode

    def decompress(self, out: CompressionOutput, as_uint8: bool = False,
                   device_decode: Optional[bool] = None) -> np.ndarray:
        """Reconstruction (N, H, W, 3): float in [0, 1], or uint8
        round(x * 255) when `as_uint8`. device_decode: rANS-decode the
        latents on the device; by default a CUDA codec does wherever it can
        (uint8 output of a batch-1 payload) and a CPU codec takes the host
        coder; True decodes on any device (the kernel's plain version on
        the CPU) and raises on an ineligible payload. The result is the same
        either way."""
        if not self._tables_built:
            self.build_tables()
        if self._check_device_decode([out], as_uint8, device_decode):
            img, bad = self._device_decode_u8(out)
            img, bad = _Fetch(img), _Fetch(bad)
            self._check_bad(bad.result())
            return img.result()
        return self._host_decode(out, as_uint8).cpu().numpy()

    def decompress_many(self, outs, as_uint8: bool = True,
                        as_numpy: bool = True,
                        device_decode: Optional[bool] = None) -> list:
        """Batch decompression. On the device decoder (chosen as in
        `decompress`) each image's decode
        and its copy to the host are enqueued before the host waits for the
        first. as_numpy=False returns NHWC tensors on the codec's device
        (after one wait for the kernels' index checks)."""
        if not self._tables_built:
            self.build_tables()
        if not self._check_device_decode(outs, as_uint8, device_decode):
            imgs = [self._host_decode(o, as_uint8) for o in outs]
            return [i.cpu().numpy() for i in imgs] if as_numpy else imgs
        if not as_numpy:
            pending = [self._device_decode_u8(o) for o in outs]
            self._check_bad(_Fetch(torch.cat([b for _, b in pending])).result())
            return [img for img, _ in pending]
        fetches = [tuple(_Fetch(t) for t in self._device_decode_u8(o))
                   for o in outs]
        results = []
        for img, bad in fetches:
            self._check_bad(bad.result())
            results.append(img.result())
        return results

    def compress_file(self, x, path: str) -> Tuple[float, float]:
        """Compress to a `.hfc` file; returns (actual_bpp, theoretical_bpp)."""
        return save_compressed(self.compress(x), path)

    def decompress_file(self, path: str, as_uint8: bool = False
                        ) -> np.ndarray:
        return self.decompress(load_compressed(path), as_uint8=as_uint8)
