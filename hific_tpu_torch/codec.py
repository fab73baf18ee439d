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
`decompress_many`: the y streams of all of them in one launch), where the
streams are vectorized and unsharded. A payload of a larger batch, a
sharded or a scalar one takes the host coder, as does a CPU codec unless
asked (`device_encode=True`, `device_decode=True` run the kernels' plain
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
`reconstruct` is the round trip without entropy coding.

The spatially partitioned codec (`compress_spatial`, `decompress_spatial`)
runs one image's encoder and generator in row bands over a mesh of
devices (`parallel/spatial.py`), with a replica of the model on each
distinct device; the hyper stages, the one shared `synth_stats` and the
coders are `compress`'s and `decompress`'s, on the codec's device.

The coders' options are the JAX package's (`Codec.__init__`): `vectorize`
(False: scalar streams), `coder_threads` (lane-sharded streams, container
v2), and in the batch codec `pipeline_chunk` (one copy of several
same-shape reconstructions to the host) and `wire_chunk` (the host coder's
copies and native calls in chunks and threads). The device coders take
vectorized, unsharded, batch-1 streams; everything else takes the host
coder.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy.container import (
    CompressionOutput,
    load_compressed,
    save_compressed,
)
from hific_tpu_torch.entropy.coding import map_threads
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
from hific_tpu_torch.ops.padding import pad_factor, pad_hw
from hific_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from hific_tpu_torch.parallel.spatial import (
    replicate,
    spatial_encode_fn,
    spatial_generate_fn,
)
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


def _lanes(t: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W) -> (H * W, C) int32: channels as lanes, positions in
    row-major order (the host coder's lane layout)."""
    _, c, h, w = t.shape
    return t.permute(0, 2, 3, 1).reshape(h * w, c).to(torch.int32).contiguous()


def _output(z_encoded, y_encoded, hyper_spatial, spatial_shape, hyper_coding,
            latent_coding, batch, hyper_bits, latent_bits, compute_dtype,
            sharded: bool) -> CompressionOutput:
    n_pixels = float(np.prod(spatial_shape))
    return CompressionOutput(
        hyperlatents_encoded=z_encoded,
        latents_encoded=y_encoded,
        hyperlatent_spatial_shape=tuple(hyper_spatial),
        spatial_shape=tuple(spatial_shape),
        hyper_coding_shape=tuple(hyper_coding),
        latent_coding_shape=tuple(latent_coding),
        batch_shape=batch,
        sharded=sharded,
        hyperlatent_bits=hyper_bits,
        latent_bits=latent_bits,
        total_bits=hyper_bits + latent_bits,
        hyperlatent_bpp=hyper_bits / n_pixels,
        latent_bpp=latent_bits / n_pixels,
        total_bpp=(hyper_bits + latent_bits) / n_pixels,
        compute_dtype=compute_dtype,
    )


def _runs(items, key, limit: int) -> list:
    """`items` in order, cut into runs of consecutive items with the same
    `key`, at most `limit` a run."""
    runs = []
    for item in items:
        if runs and len(runs[-1]) < limit and key(runs[-1][0]) == key(item):
            runs[-1].append(item)
        else:
            runs.append([item])
    return runs


def _split_streams(fetched: np.ndarray, jobs):
    """A fetched encode buffer -> the uint32 words [counts (3), stream (2 L
    + spill_cap)] of each job, and the words after them."""
    words, parts, at = fetched.view(np.uint32), [], 0
    for job in jobs:
        n = 3 + 2 * job.sym_l.shape[1] + job.spill_cap
        parts.append(words[at:at + n])
        at += n
    return parts, words[at:]


class _Staged(NamedTuple):
    """One input's device work up to its symbols, enqueued: NCHW symbol
    planes and coding indices on the device, its (hyperlatent, latent)
    Shannon bits as float32, and the image's (H, W)."""
    z_sym: torch.Tensor   # int16
    y_sym: torch.Tensor   # int16
    idx: torch.Tensor     # uint8
    bits: torch.Tensor    # float32 (2,)
    spatial_shape: tuple


class _Symbols(NamedTuple):
    """A staged input's symbols on the host: NCHW int32 planes and the
    bits."""
    z_sym: np.ndarray
    y_sym: np.ndarray
    idx: np.ndarray
    hyper_bits: float
    latent_bits: float


class Codec:
    """Evaluation-mode compression/decompression engine, in the config's
    compute dtype (`Config.dtype`) as the JAX package's `Codec`. A DLMM
    or `sample_noise` config is refused: the JAX package has no compress
    path for either (the DLMM prior is a training-only estimate, and its
    codec draws no generator noise).

    vectorize: code the streams with the vectorized coder (one lane a
    channel); False writes scalar streams (one lane, the smallest stream,
    serial; host coder only), which only a codec with vectorize=False
    decodes.
    coder_threads: above 1, lane-shard each host-coded payload into that
    many streams coded in host threads (container v2; a few words more a
    shard). The device coders take unsharded streams only. Decoding reads
    the shard count from the file, so any codec decodes any v1 or v2 file.
    pipeline_chunk: in `decompress_many`, the reconstructions of this many
    consecutive same-shape images come to the host in one copy. Their
    device programs run image by image, as those of `compress_many` do
    whatever the chunk: batched convolutions do not give an image the bits
    it gets alone, and the bytes and pixels must be the per-image ones.
    The device encoder already fetches once a call.
    wire_chunk: on the host-coder paths of `compress_many` /
    `decompress_many`, one stacked device-to-host copy (the symbols to
    code, or the coding indices to decode with) per this many consecutive
    same-shape images, and their native rANS calls in a pool of this many
    host threads, closed before the call returns. The device coders'
    paths already fetch once per call: there it changes nothing."""

    def __init__(self, config: Config, state_dict, device=None,
                 vectorize: bool = True, coder_threads: int = 1,
                 pipeline_chunk: int = 1, wire_chunk: int = 1):
        refused = [name for name, on in (
            ("use_latent_mixture_model", config.use_latent_mixture_model),
            ("sample_noise", config.sample_noise)) if on]
        if refused:
            raise ValueError(f"no codec for a config with {' and '.join(refused)}"
                             f": the JAX package has no compress path for it "
                             f"either")
        self.vectorize = bool(vectorize)
        self.coder_threads = max(1, int(coder_threads))
        self.pipeline_chunk = max(1, int(pipeline_chunk))
        self.wire_chunk = max(1, int(wire_chunk))
        if self.coder_threads > 1 and not self.vectorize:
            raise ValueError("coder_threads > 1 shards the vectorized coder's "
                             "lanes: it needs vectorize=True")
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
        # The spatial codec's model replicas and partitioned maps, by mesh.
        self._sp_cache = {}
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

    def tiled_encoder(self, tile_image: Optional[int], halo_image: int = 64
                      ) -> Optional[Callable]:
        """The encoder on image tiles of `tile_image` with `halo_image`
        pixels of context (None: the whole image's)."""
        if tile_image is None:
            return None
        return lambda x: tiled_downsample_apply(
            self.model.encoder, x, scale=ENC_SCALE, tile=tile_image,
            halo=halo_image)

    def _front(self, x: torch.Tensor, encode: Optional[Callable] = None):
        """`compress_front` of the model input, with latents from `encode`
        (model input -> latents: tiled or partitioned) when given."""
        if encode is None:
            return self.model.compress_front(x)
        return self.model.compress_front_from_latents(encode(x))

    @_codec_numerics
    @torch.inference_mode()
    def _stage(self, x: torch.Tensor, spatial_shape,
               encode: Optional[Callable] = None) -> _Staged:
        """Enqueue one model input's device work up to its symbols: the
        encoder front (latents from `encode` when given), the one shared
        synth_stats and the latent symbols. Blocks on nothing."""
        y, z_sym, hyper_bits = self._front(x, encode)
        mu, sigma, idx = self.model.synth_stats(z_sym, self.scale_table)
        y_sym, latent_bits = self.model.latent_symbols(y, mu, sigma)
        return _Staged(z_sym, y_sym, idx,
                       torch.stack([hyper_bits.float(), latent_bits.float()]),
                       spatial_shape)

    def _fetch_symbols(self, staged) -> list:
        """The host copy of staged inputs' symbols: one device-to-host copy
        per `wire_chunk` consecutive inputs of one shape, all enqueued
        before the first wait. Returns a `_Symbols` a staged input."""
        fetches = []
        for run in _runs(staged, lambda s: (s.z_sym.shape, s.y_sym.shape),
                         self.wire_chunk):
            fetches.append((run, Fetch(torch.cat([
                t for s in run for t in (
                    s.z_sym.flatten().to(torch.int32),
                    s.y_sym.flatten().to(torch.int32),
                    s.idx.flatten().to(torch.int32),
                    s.bits.view(torch.int32))]))))
        symbols = []
        for run, fetch in fetches:
            words, at = fetch.result(), 0
            for s in run:
                planes = []
                for t in (s.z_sym, s.y_sym, s.idx):
                    planes.append(words[at:at + t.numel()].reshape(t.shape))
                    at += t.numel()
                hyper_bits, latent_bits = words[at:at + 2].view(np.float32)
                at += 2
                symbols.append(_Symbols(*planes, float(hyper_bits),
                                        float(latent_bits)))
        return symbols

    def _symbols(self, x: torch.Tensor, encode: Optional[Callable] = None
                 ) -> _Symbols:
        """Model input -> numpy (z_sym, y_sym, idx) in NCHW int32 and the
        hyperlatent and latent Shannon bits."""
        return self._fetch_symbols(
            [self._stage(x, tuple(x.shape[2:]), encode)])[0]

    def encode_symbols(self, x):
        """Image -> numpy (z_sym, y_sym, idx) in NCHW int32, the hyperlatent
        and latent Shannon bits, and the image's (H, W)."""
        x = self._model_input(x)
        return tuple(self._symbols(x)) + (tuple(int(s) for s in x.shape[2:]),)

    def _host_encode_row(self, symbols: _Symbols, spatial_shape
                         ) -> CompressionOutput:
        """One input's host rANS coding: the vectorized, sharded (container
        v2) or scalar coder, as the codec is set. Thread-safe: the native
        coder keeps no state between calls."""
        z_encoded, hyper_coding_shape = self.factorized.compress_symbols(
            symbols.z_sym, self.vectorize, self.coder_threads)
        y_encoded, latent_coding_shape = self.conditional.compress_symbols(
            symbols.y_sym, symbols.idx, self.vectorize, self.coder_threads)
        return _output(z_encoded, y_encoded, symbols.z_sym.shape[2:],
                       spatial_shape, hyper_coding_shape, latent_coding_shape,
                       symbols.z_sym.shape[0], symbols.hyper_bits,
                       symbols.latent_bits, self.config.dtype,
                       self.coder_threads > 1)

    def _host_compress(self, staged) -> list:
        """The host coder over staged inputs: their symbols fetched
        `wire_chunk` at a time, each input coded in a pool of `wire_chunk`
        threads."""
        return map_threads(
            lambda item: self._host_encode_row(*item),
            zip(self._fetch_symbols(staged),
                [s.spatial_shape for s in staged]),
            self.wire_chunk)

    # ------------------------------------------------------------------ #
    # The device encoder

    def _device_encode_eligible(self, x: torch.Tensor) -> bool:
        """Batch 1 (the lane layout of the device coders: channels as lanes
        over positions), unsharded vectorized streams."""
        return (self.vectorize and self.coder_threads == 1
                and int(x.shape[0]) == 1)

    def _use_device_encode(self, x: torch.Tensor,
                           device_encode: Optional[bool]) -> bool:
        eligible = self._device_encode_eligible(x)
        if device_encode and not eligible:
            raise ValueError("device_encode=True but the input is not "
                             "eligible for the device encoder (batch 1, "
                             "vectorize, coder_threads == 1)")
        if device_encode is None:
            return self.device.type == "cuda" and eligible
        return device_encode

    @staticmethod
    @torch.inference_mode()
    def _encode(jobs, extra=()) -> Fetch:
        """One launch of the encode kernel over `jobs` and the enqueued
        fetch of one int32 buffer: [counts (3), stream (2 L + spill_cap)]
        per job, then the `extra` tensors."""
        outs = encode_scan_many(jobs)
        return Fetch(torch.cat([t for stream, _, counts in outs
                                 for t in (counts, stream)] + list(extra)))

    def _encode_jobs(self, item: _Staged) -> tuple:
        """A staged batch-1 input's (y, z) jobs of the encode kernel at the
        default caps."""
        (_, cy, hy, wy), (_, cz, hz, wz) = item.y_sym.shape, item.z_sym.shape
        z_idx = torch.arange(cz, dtype=torch.int32, device=item.z_sym.device)
        y_tables, z_tables = self._rans_tables
        return (EncodeJob(_lanes(item.y_sym), _lanes(item.idx), y_tables,
                          *default_caps(hy * wy, cy)),
                EncodeJob(_lanes(item.z_sym),
                          z_idx.expand(hz * wz, cz).contiguous(), z_tables,
                          *default_caps(hz * wz, cz, Z_SPILL_BITS)))

    def _device_compress(self, staged) -> list:
        """The y and z streams of every staged input in one encode launch.
        The streams that overran their buffers are coded again, in one
        more launch, with caps at the demand the kernel reported (writes
        past a cap are dropped but counted), so it writes every word."""
        jobs = [job for item in staged for job in self._encode_jobs(item)]
        streams, bits = _split_streams(self._encode(
            jobs, [item.bits.view(torch.int32) for item in staged]).result(),
            jobs)
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
        for i, item in enumerate(staged):
            _, cz, hz, wz = item.z_sym.shape
            hyper_bits, latent_bits = (float(b) for b in bits[i])
            outputs.append(_output(
                encoded[2 * i + 1], encoded[2 * i], (hz, wz),
                item.spatial_shape, (cz, 1, 1), (item.y_sym.shape[1], 1, 1),
                1, hyper_bits, latent_bits, self.config.dtype, False))
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
        a batch-1 input, tiled or not, when its streams are vectorized and
        unsharded, and a CPU codec takes the host coder; True codes on any
        device (the kernel's plain version on the CPU) and raises on an
        input it does not take; False takes the host coder. The bytes are
        the same either way."""
        if not self._tables_built:
            self.build_tables()
        spatial_shape = tuple(int(s) for s in np.shape(x)[1:3])
        x = self._model_input(x, shape_bucket)
        return self._compress_input(x, spatial_shape,
                                    self.tiled_encoder(tile_image, halo_image),
                                    device_encode)

    def _compress_input(self, x: torch.Tensor, spatial_shape,
                        encode: Optional[Callable],
                        device_encode: Optional[bool]) -> CompressionOutput:
        """The model input's `.hfc` payload, on the device encoder or the
        host coder as `compress` chooses."""
        on_device = self._use_device_encode(x, device_encode)
        staged = [self._stage(x, spatial_shape, encode)]
        if on_device:
            return self._device_compress(staged)[0]
        return self._host_compress(staged)[0]

    def compress_many(self, images, shape_bucket: Optional[int] = None,
                      device_encode: Optional[bool] = None) -> list:
        """Batch compression, in order. Every image's device work is
        enqueued first, image by image. Then the images the
        device encoder takes (on a CUDA codec every batch-1 image of a
        vectorized, unsharded codec) have their y and z streams coded in
        one launch and fetched in one buffer; the rest take the host coder
        (`wire_chunk`), as in the JAX package: a larger batch's stream has
        every (channel, pixel) of a position as lanes, a layout the device
        coders do not have. device_encode: True takes the device encoder
        on any device (its plain version on the CPU) and raises on an
        image it does not take; False takes the host coder. shape_bucket:
        as in `compress`."""
        if not self._tables_built:
            self.build_tables()
        staged, on_device = [], []
        for image in images:
            x = self._model_input(image, shape_bucket)
            on_device.append(self._use_device_encode(x, device_encode))
            staged.append(self._stage(
                x, tuple(int(s) for s in np.shape(image)[1:3])))
        device = [k for k, on in enumerate(on_device) if on]
        host = [k for k, on in enumerate(on_device) if not on]
        results = dict(zip(device, self._device_compress(
            [staged[k] for k in device]) if device else []))
        results.update(zip(host, self._host_compress(
            [staged[k] for k in host])))
        return [results[k] for k in range(len(staged))]

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
        y_np = self.conditional.decompress_symbols(
            out.latents_encoded, idx.cpu().numpy().astype(np.int32),
            self.vectorize, out.sharded)
        return z_np, y_np, mu

    def _hyper_stats(self, out: CompressionOutput):
        """Host rANS of z (~1 ms) -> (z_sym numpy, mu, idx on the device):
        the same synth_stats the encoder took its indices from."""
        z_np = self.factorized.decompress_symbols(
            out.hyperlatents_encoded, out.batch_shape,
            out.hyperlatent_spatial_shape, self.vectorize, out.sharded)
        z_sym = torch.from_numpy(z_np).to(self.device, torch.int16).contiguous(
            memory_format=torch.channels_last)
        mu, _, idx = self.model.synth_stats(z_sym, self.scale_table)
        return z_np, mu, idx

    def _generate(self, y_hat, spatial_shape, as_uint8: bool) -> torch.Tensor:
        """Latents -> NHWC reconstruction on the device: uint8, mapped in
        the model's dtype as the JAX package maps it, or float32."""
        return self._image(self.model.generate(y_hat, spatial_shape),
                           as_uint8)

    @staticmethod
    def _image(recon: torch.Tensor, as_uint8: bool) -> torch.Tensor:
        """NCHW [0, 1] generator output -> the NHWC reconstruction. uint8
        saturates as XLA's conversion does: in bfloat16 a pixel at 1.0 maps
        to 255.5, which rounds to 256, and torch's cast would wrap it to
        0."""
        if as_uint8:
            recon = (recon * 255.0 + 0.5).clamp(max=255.0).to(torch.uint8)
        else:
            recon = recon.float()
        return recon.permute(0, 2, 3, 1)

    def _host_latents(self, outs) -> list:
        """The host coder over payloads -> the quantized latents y + mu of
        each on the device. Every payload's z decode and synth_stats are
        enqueued first; then per `wire_chunk` consecutive payloads of one
        shape one copy of their coding indices to the host, their y streams
        decoded in a pool of `wire_chunk` threads, and one upload of their
        symbols."""
        stats = [self._hyper_stats(o) for o in outs]
        runs = _runs(list(zip(outs, stats)), lambda item: item[1][2].shape,
                     self.wire_chunk)
        fetches = [Fetch(torch.cat([idx.flatten() for _, (_, _, idx) in run]))
                   for run in runs]
        y_hats = []
        for run, fetch in zip(runs, fetches):
            idx_all, at, jobs = fetch.result(), 0, []
            for out, (_, _, idx) in run:
                jobs.append((out, idx_all[at:at + idx.numel()].reshape(
                    idx.shape).astype(np.int32)))
                at += idx.numel()
            y_np = map_threads(
                lambda job: self.conditional.decompress_symbols(
                    job[0].latents_encoded, job[1], self.vectorize,
                    job[0].sharded), jobs, self.wire_chunk)
            y_all = torch.from_numpy(np.concatenate(
                [y.reshape(-1) for y in y_np])).to(self.device, torch.float32)
            at = 0
            for (_, (_, mu, _)), y in zip(run, y_np):
                y_hats.append(y_all[at:at + y.size].view(y.shape).contiguous(
                    memory_format=torch.channels_last) + mu)
                at += y.size
        return y_hats

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

    def _device_decode_eligible(self, out: CompressionOutput) -> bool:
        """Batch 1, an unsharded stream, and a vectorized codec (a scalar
        stream is no lane layout of the device decoder)."""
        return (self.vectorize and not out.sharded
                and int(out.batch_shape) == 1)

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
                             "single-image, unsharded payloads of a "
                             "vectorized codec")
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
        latents on the device; by default a CUDA codec does for a payload
        it takes (batch 1, unsharded, a vectorized codec), tiled or not,
        and a CPU codec takes the host coder; True decodes on any device
        (the kernel's plain version on the CPU) and raises on a payload it
        does not take. The result is the same either way."""
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
        """Batch decompression, in order. On the device decoder (chosen as
        in `decompress`) the y streams of all payloads are decoded in one
        launch, otherwise on the host coder (`wire_chunk`); then every
        image's generation, and per `pipeline_chunk` consecutive payloads
        of one shape one copy of their images to the host, are enqueued
        before the host waits for the first.
        as_numpy=False returns NHWC tensors on the codec's device (after
        one wait for the kernel's index checks). tile_latents: each
        payload's generator run on latent tiles as in `decompress` (numpy
        results)."""
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
            y_hats = self._host_latents(outs)
        if tile_latents is not None:
            imgs = [self._tiled_generate(y, o.spatial_shape, tile_latents,
                                         halo_latents, as_uint8)
                    for o, y in zip(outs, y_hats)]
            self._check_bad(bad)
            return imgs
        # Image by image: at a batch of several, cuDNN's convolutions (and
        # oneDNN's on the CPU) do not give every image the bits it gets
        # alone, in either dtype (PERF.md section 6,
        # `scripts/chunk_modes.py --layers`).
        imgs = [self._generate(y, o.spatial_shape, as_uint8)
                for o, y in zip(outs, y_hats)]
        if not as_numpy:
            self._check_bad(bad)
            return imgs
        fetches = [(run, Fetch(run[0] if len(run) == 1 else torch.cat(run)))
                   for run in _runs(imgs, lambda t: t.shape,
                                    self.pipeline_chunk)]
        self._check_bad(bad)
        return [img for run, fetch in fetches for img in np.split(
            fetch.result(), np.cumsum([t.shape[0] for t in run])[:-1])]

    # ------------------------------------------------------------------ #
    # The spatially partitioned codec: ONE image in row bands over a mesh
    # of devices (`parallel/spatial.py`), composed with the standard hyper,
    # symbol and coding stages on the codec's device.

    def _spatial(self, mesh: Mesh, kind: str, halo: int):
        """The partitioned encoder or generator over `mesh` with `halo`,
        and the model's replicas, one per distinct device (the model
        itself on the codec's device), built once per mesh."""
        key = (id(mesh), kind, halo)
        if key not in self._sp_cache:
            replicas = self._sp_cache.setdefault(
                (id(mesh), "replicas"), replicate(self.model, mesh))
            if kind == "encode":
                fn = spatial_encode_fn(lambda m, t: m.encoder(t), mesh,
                                       halo=halo)
            else:
                fn = spatial_generate_fn(
                    lambda m, t: m.generate(
                        t, (t.shape[2] * ENC_SCALE, t.shape[3] * ENC_SCALE)),
                    mesh, halo_latents=halo)
            self._sp_cache[key] = (fn, replicas)
        return self._sp_cache[key]

    def compress_spatial(self, x, mesh: Mesh, halo_image: int = 64
                         ) -> CompressionOutput:
        """Compress ONE image with the encoder partitioned in row bands over
        `mesh`'s data axis. H is reflect-padded to a multiple of n * 16
        (n bands); the streams equal `compress(x)`'s whenever that leaves
        the padded height unchanged, i.e. H % (n * 16) == 0; otherwise the
        extra bottom rows are coded too (a valid file with more latent
        rows). The latents are gathered on the codec's device, and the
        hyper stages, the one shared synth_stats and the coder (the device
        encoder on a CUDA codec) are `compress`'s. Each band's device holds one
        window's activations, so the largest image grows with the
        devices."""
        if not self._tables_built:
            self.build_tables()
        spatial_shape = tuple(int(s) for s in np.shape(x)[1:3])
        x = self._model_input(x)
        n = mesh.shape[DATA_AXIS]
        h, w = x.shape[2:]
        x = pad_hw(x, 0, -h % (n * ENC_SCALE), 0, -w % ENC_SCALE)
        fn, replicas = self._spatial(mesh, "encode", halo_image)
        return self._compress_input(x, spatial_shape,
                                    lambda t: fn(replicas, t), None)

    @_codec_numerics
    @torch.inference_mode()
    def decompress_spatial(self, out: CompressionOutput, mesh: Mesh,
                           halo_latents: int = 16, as_uint8: bool = False
                           ) -> np.ndarray:
        """Decompress with the generator partitioned in row bands over
        `mesh`'s data axis. The latents come from `decompress`'s decode
        (the device decoder on a CUDA codec: one launch), then the bands
        run the generator. Files whose latent rows do not band evenly over
        the mesh, or are too few for the halo'd windows (not written by
        `compress_spatial`), decode through the single-device generator:
        the result is then `decompress(out)`'s. Same symbols as
        `decompress(out)` by construction and exact windows: the pixels
        agree to float noise (cuDNN picks its algorithms by shape)."""
        if not self._tables_built:
            self.build_tables()
        self._check_compute_dtype(out)
        bad = None
        if self._use_device_decode([out], None):
            y_hats, bad = self._device_latents([out])
            y_hat, bad = y_hats[0], Fetch(bad)
        else:
            y_hat = self._host_latents([out])[0]
        n = mesh.shape[DATA_AXIS]
        rows = int(y_hat.shape[2])
        if rows % n or (n > 1 and (rows // n) * (n - 1) < 2 * halo_latents):
            # The single-device generator: the program decompress() runs.
            # Padding rows here instead would move bottom-edge pixels
            # through the generator's receptive field.
            img = self._generate(y_hat, out.spatial_shape, as_uint8)
        else:
            fn, replicas = self._spatial(mesh, "generate", halo_latents)
            h, w = out.spatial_shape
            img = self._image(fn(replicas, y_hat)[:, :, :h, :w], as_uint8)
        fetch = Fetch(img)
        self._check_bad(bad)
        return fetch.result()

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
