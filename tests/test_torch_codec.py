"""The slice as a whole: the PyTorch port's codec against the JAX `Codec`.

For the same weights and image, the port's `.hfc` bytes equal the JAX
package's, each side decodes the other's file, and the reconstructions
agree within 1e-3 on [0, 1]. The device coders' paths (`compress(
device_encode=True)`, `compress_many`, the device decoder of `decompress`
and `decompress_many`) write the same bytes as the JAX package's and as the
host coder, and decode to the host decoder's images; on the CPU, asked for
with `device_encode=True` / `device_decode=True`, they run the kernels'
plain versions. Two models: the tiny config of the JAX codec
tests with JAX-initialised parameters, and the flagship artifact at a small
crop, both fp32 on the CPU.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hific_tpu.codec import Codec as JaxCodec
from hific_tpu.config import mse_lpips_config
from hific_tpu.models.hific import HiFiC as JaxHiFiC
from hific_tpu.training.checkpoints import load_params_npz
from hific_tpu.entropy import container as jax_container
from hific_tpu_torch import codec as codec_module
from hific_tpu_torch.codec import Codec
from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy import container
from hific_tpu_torch.weights import leaf_to_float32, load_npz, state_dict_from_jax

ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "flagship_rd30k_f16.npz")
RECON_ATOL = 1e-3


def _smooth_image(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    img = np.stack([0.5 + 0.3 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * yy
                                                     + rng.uniform(0.5, 2) * xx)
                                       + rng.uniform(0, 6))
                    for _ in range(3)], -1)
    img += rng.normal(0, 0.02, img.shape)
    return np.clip(img, 0, 1).astype(np.float32)[None]


@pytest.fixture(scope="module")
def tiny():
    cfg = mse_lpips_config(latent_channels=8, n_residual_blocks=1,
                           hyperlatent_filters=16, crop_size=64)
    rng = jax.random.PRNGKey(0)
    variables = JaxHiFiC(cfg).init({"params": rng, "quantize": rng},
                                   jnp.zeros((1, 64, 64, 3)), training=True)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    jax_codec = JaxCodec(cfg, variables["params"])
    port = Codec(Config.from_json(cfg.to_json()), state_dict_from_jax(params),
                 device="cpu")
    return jax_codec, port


@pytest.fixture(scope="module")
def flagship():
    """The flagship artifact, loaded once per module for each stack, fp32."""
    config, params = load_params_npz(ARTIFACT)
    # The JAX loader passes the 16 bfloat16 (|V2) leaves through unconverted.
    params = jax.tree_util.tree_map(
        lambda a: leaf_to_float32(a) if a.dtype.kind == "V" else a, params)
    jax_codec = JaxCodec(config.replace(dtype="float32"), params)
    del params
    port_config, state = load_npz(ARTIFACT)
    port = Codec(port_config, state, device="cpu")
    return jax_codec, port


def _round_trip_both_ways(pair, x, tmp_path, as_uint8=False):
    jax_codec, port = pair
    p_jax, p_port = tmp_path / "jax.hfc", tmp_path / "port.hfc"
    jax_codec.compress_file(x, str(p_jax))
    port.compress_file(x, str(p_port))
    assert p_port.read_bytes() == p_jax.read_bytes()
    r_jax = np.asarray(jax_codec.decompress_file(str(p_port),
                                                 as_uint8=as_uint8))
    r_port = port.decompress_file(str(p_jax), as_uint8=as_uint8)
    assert r_port.shape == r_jax.shape == x.shape[:3] + (3,)
    assert r_port.dtype == r_jax.dtype
    return r_port, r_jax


def test_tiny_hfc_bytes_equal_and_cross_decode(tiny, tmp_path):
    """Measured reconstruction max abs diff 3.9e-6 (limit 1e-3)."""
    x = np.random.RandomState(0).rand(1, 80, 96, 3).astype(np.float32)
    r_port, r_jax = _round_trip_both_ways(tiny, x, tmp_path)
    np.testing.assert_allclose(r_port, r_jax, atol=RECON_ATOL, rtol=0)


def test_tiny_uint8_in_and_out(tiny, tmp_path):
    """uint8 images in, uint8 round(x * 255) out. The float reconstructions
    agree within 3.9e-6, so a pixel can differ by one level where they
    straddle a rounding boundary (measured: 1 level at most)."""
    x = (np.random.RandomState(1).rand(1, 48, 64, 3) * 255).astype(np.uint8)
    r_port, r_jax = _round_trip_both_ways(tiny, x, tmp_path, as_uint8=True)
    assert r_port.dtype == np.uint8
    assert np.abs(r_port.astype(int) - r_jax.astype(int)).max() <= 1


def test_flagship_crop_hfc_bytes_equal_and_cross_decode(flagship, tmp_path):
    """48x64 crop (3x4 latents padded to 4x4, one hyperlatent pixel).
    Measured reconstruction max abs diff 2.6e-6 (limit 1e-3)."""
    x = _smooth_image(48, 64, seed=0)
    r_port, r_jax = _round_trip_both_ways(flagship, x, tmp_path)
    np.testing.assert_allclose(r_port, r_jax, atol=RECON_ATOL, rtol=0)


def _hfc(out, writer=container) -> bytes:
    f = io.BytesIO()
    writer._save_to(f, out)
    return f.getvalue()


def _u8(h, w, seed):
    return (_smooth_image(h, w, seed) * 255 + 0.5).astype(np.uint8)


@pytest.mark.parametrize("model", ["tiny", "flagship"])
def test_device_encode_bytes_equal_jax_and_host(model, request):
    """compress(device_encode=True) writes the JAX package's
    compress(device_encode=True) bytes, which are the host coder's; the
    device decoder returns the host decoder's uint8 image."""
    jax_codec, port = request.getfixturevalue(model)
    x = _u8(48, 64, seed=2)
    before = port.device_relaunches
    dev = port.compress(x, device_encode=True)
    assert port.device_relaunches == before
    want = _hfc(jax_codec.compress(x, device_encode=True), jax_container)
    assert _hfc(dev) == want == _hfc(port.compress(x))
    r_dev = port.decompress(dev, as_uint8=True, device_decode=True)
    r_host = port.decompress(dev, as_uint8=True, device_decode=False)
    assert r_dev.dtype == np.uint8 and r_dev.shape == x.shape
    np.testing.assert_array_equal(r_dev, r_host)


def test_capacity_overrun_relaunches_the_device_encoder(tiny, monkeypatch):
    """Caps of 8 spill words and 16 events overrun on every stream: the
    device encoder runs again with the demand it reported as its caps and
    writes the host coder's bytes."""
    _, port = tiny
    x = _u8(48, 64, seed=3)
    want = _hfc(port.compress(x))
    monkeypatch.setattr(codec_module, "default_caps",
                        lambda p, lanes, bits_per_symbol=2: (8, 16))
    before = port.device_relaunches
    assert _hfc(port.compress(x, device_encode=True)) == want
    assert [_hfc(o) for o in port.compress_many(
        [x, x], device_encode=True)] == [want, want]
    assert port.device_relaunches - before == 3


def test_device_coders_refuse_batch_2(tiny):
    """Batch 2 is not the device coders' lane layout: asking for them
    raises, the defaults take the host coder."""
    _, port = tiny
    x = np.concatenate([_u8(32, 48, seed=4), _u8(32, 48, seed=5)])
    with pytest.raises(ValueError, match="device_encode"):
        port.compress(x, device_encode=True)
    out = port.compress(x)
    assert out.batch_shape == 2
    with pytest.raises(ValueError, match="device_decode"):
        port.decompress(out, as_uint8=True, device_decode=True)
    with pytest.raises(ValueError, match="device_decode"):
        port.decompress_many([out], device_decode=True)
    r = port.decompress(out, as_uint8=True)
    assert r.shape == x.shape and r.dtype == np.uint8
    with pytest.raises(ValueError, match="device_encode"):
        port.compress_many([x], device_encode=True)
    (many,) = port.compress_many([x])
    assert _hfc(many) == _hfc(out)


@pytest.mark.parametrize("bucket", [None, 32])
def test_many_bytes_equal_jax_and_per_image(tiny, bucket):
    """Three uint8 images of two shapes, one of them not a multiple of 16:
    compress_many's files, from the device encoder (its plain version here)
    and from the CPU codec's default host coder, equal the JAX package's
    compress_many and the port's per-image compress; decompress_many on the
    device decoder returns the host decoder's images, and with
    as_numpy=False the same pixels as tensors on the codec's device."""
    jax_codec, port = tiny
    images = [_u8(48, 64, seed=6), _u8(40, 56, seed=7), _u8(48, 64, seed=8)]
    before = port.device_relaunches
    outs = port.compress_many(images, shape_bucket=bucket, device_encode=True)
    assert port.device_relaunches == before
    got = [_hfc(o) for o in outs]
    want = [_hfc(o, jax_container)
            for o in jax_codec.compress_many(images, shape_bucket=bucket)]
    assert got == want
    assert got == [_hfc(port.compress(x, shape_bucket=bucket))
                   for x in images]
    assert got == [_hfc(o) for o in port.compress_many(
        images, shape_bucket=bucket)]
    recons = port.decompress_many(outs, device_decode=True)
    tensors = port.decompress_many(outs, as_numpy=False, device_decode=True)
    for x, out, r, t in zip(images, outs, recons, tensors):
        assert tuple(out.spatial_shape) == x.shape[1:3]
        assert r.shape == x.shape and r.dtype == np.uint8
        np.testing.assert_array_equal(
            r, port.decompress(out, as_uint8=True, device_decode=False))
        assert isinstance(t, torch.Tensor) and t.device == port.device
        np.testing.assert_array_equal(t.numpy(), r)


def test_many_code_every_stream_in_one_batch(tiny, monkeypatch):
    """compress_many of three images of three sizes makes one batched
    encode call for all six y and z streams, and decompress_many one
    batched decode call for the three y streams (the kernels' plain
    versions here, the same entry points that launch once on the card);
    the bytes equal the host coder's, the images the host decoder's."""
    from hific_tpu_torch.entropy import device_decode, device_encode

    _, port = tiny
    images = [_u8(48, 64, seed=9), _u8(32, 80, seed=10), _u8(64, 48, seed=11)]
    calls = []

    def counted(fn):
        def call(jobs):
            calls.append((fn.__name__, len(jobs)))
            return fn(jobs)
        return call

    monkeypatch.setattr(codec_module, "encode_scan_many",
                        counted(device_encode.encode_scan_many))
    monkeypatch.setattr(codec_module, "decode_scan_many",
                        counted(device_decode.decode_scan_many))
    outs = port.compress_many(images, device_encode=True)
    recons = port.decompress_many(outs, device_decode=True)
    assert calls == [("encode_scan_many", 6), ("decode_scan_many", 3)]
    for x, out, r in zip(images, outs, recons):
        assert _hfc(out) == _hfc(port.compress(x))
        np.testing.assert_array_equal(
            r, port.decompress(out, as_uint8=True, device_decode=False))


@pytest.mark.parametrize("as_uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("shape", [(75, 93), (33, 47), (17, 130), (100, 61)])
def test_hfc_bytes_equal_jax_at_sizes_not_multiples_of_16(tiny, shape,
                                                          as_uint8):
    """Sizes the encoder pads (to 16) and the hyperprior pads again (to
    4 latents), down to one latent row: the port's `.hfc` bytes equal the
    JAX `Codec`'s for float and uint8 input, and the uint8 reconstructions
    are within one level (floats ~4e-6 apart round apart)."""
    jax_codec, port = tiny
    x = _smooth_image(*shape, seed=sum(shape))
    if as_uint8:
        x = (x * 255 + 0.5).astype(np.uint8)
    out = port.compress(x)
    assert tuple(out.spatial_shape) == shape
    jax_out = jax_codec.compress(x)
    assert _hfc(out) == _hfc(jax_out, jax_container)
    got = port.decompress(out, as_uint8=True)
    want = np.asarray(jax_codec.decompress(jax_out, as_uint8=True,
                                           device_decode=False))
    assert got.shape == want.shape == (1,) + shape + (3,)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_reconstruct_matches_jax(tiny):
    """`reconstruct` (no entropy coding) against the JAX `Codec`'s on a
    size that is not a multiple of 16, within the codec's 1e-3."""
    jax_codec, port = tiny
    x = _smooth_image(75, 93, seed=12)
    got = port.reconstruct(x)
    want = np.asarray(jax_codec.reconstruct(x))
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RECON_ATOL, rtol=0)
