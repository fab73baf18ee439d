"""Tiling in the port (`hific_tpu_torch/tiling.py` and the codec's
`tile_image` / `tile_latents`) against whole-image coding and the JAX
package's tiling, on the tiny config with JAX-initialised weights carried
across by `weights.state_dict_from_jax`, all in fp32 on the CPU.

A tiled encode with a halo of at least the encoder's one-sided receptive
extent (49 px) writes the whole image's `.hfc` bytes, which are the JAX
package's tiled bytes; a halo of 16 does not. A tiled decode agrees with
the JAX package's tiled decode within 1e-4 (float) and one level (uint8).
The device coders (their plain versions here) code tiled input and decode
tiled output to the host coder's bytes and images.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hific_tpu.codec import Codec as JaxCodec
from hific_tpu.config import mse_lpips_config
from hific_tpu.entropy import container as jax_container
from hific_tpu.models.hific import HiFiC as JaxHiFiC
from hific_tpu_torch.codec import Codec
from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy import container
from hific_tpu_torch.tiling import tiled_apply, tiled_upsample_apply
from hific_tpu_torch.weights import state_dict_from_jax

FLOAT_ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    cfg = mse_lpips_config(latent_channels=8, n_residual_blocks=1,
                           hyperlatent_filters=16)
    model = JaxHiFiC(cfg)
    init = jax.jit(lambda r: model.init({"params": r, "quantize": r},
                                        jnp.zeros((1, 64, 64, 3)),
                                        training=True)["params"])
    params = init(jax.random.PRNGKey(0))
    jax_codec = JaxCodec(cfg, params)
    port = Codec(Config.from_json(cfg.to_json()),
                 state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            params)),
                 device="cpu")
    return jax_codec, port


def _hfc(out, writer=container) -> bytes:
    f = io.BytesIO()
    writer._save_to(f, out)
    return f.getvalue()


def _box_blur(radius):
    k = 2 * radius + 1

    def blur(x):  # NHWC, reflect-padded, same size out
        x = x.permute(0, 3, 1, 2)
        x = F.pad(x, (radius,) * 4, mode="reflect")
        w = torch.ones(3, 1, k, k, dtype=x.dtype) / (k * k)
        return F.conv2d(x, w, groups=3).permute(0, 2, 3, 1)

    return blur


def test_tiled_apply_exact_for_local_operator():
    """With halo >= the operator's radius, tiling is exact."""
    blur = _box_blur(8)
    x = torch.from_numpy(
        np.random.RandomState(0).rand(1, 100, 140, 3).astype(np.float32))
    whole = blur(x)
    tiled = tiled_apply(blur, x, tile=48, halo=8)
    assert tiled.shape == whole.shape
    torch.testing.assert_close(tiled, whole, atol=1e-6, rtol=0)
    # A halo below the radius is not exact (the test can tell).
    assert (tiled_apply(blur, x, tile=48, halo=2) - whole).abs().max() > 1e-4


def test_tiled_apply_single_tile_identity():
    x = torch.ones(1, 32, 32, 3)
    torch.testing.assert_close(tiled_apply(lambda t: 2.0 * t, x, tile=64,
                                           halo=8), 2.0 * x)


@pytest.mark.parametrize("shape", [(152, 136), (232, 264)])
def test_tiled_encode_bytes_equal_whole_and_jax(tiny, shape):
    """152x136 (the JAX test's size: its 64 + 2 x 64 windows cover the
    padded image, so one window) and 232x264 (windows clamped inside the
    image on a 4 x 5 grid of 64-pixel cores). Neither size is a multiple
    of 16 or of the tile."""
    jax_codec, port = tiny
    x = np.random.RandomState(1).rand(1, *shape, 3).astype(np.float32)
    whole = _hfc(port.compress(x))
    tiled = port.compress(x, tile_image=64, halo_image=64)
    assert _hfc(tiled) == whole
    assert whole == _hfc(jax_codec.compress(x, tile_image=64, halo_image=64),
                         jax_container)


def test_insufficient_halo_differs(tiny):
    """The encoder's one-sided receptive extent is 49 px, so a halo of 16
    changes the latents."""
    _, port = tiny
    x = np.random.RandomState(1).rand(1, 152, 136, 3).astype(np.float32)
    bad = port.compress(x, tile_image=64, halo_image=16)
    assert (bad.latents_encoded.tobytes()
            != port.compress(x).latents_encoded.tobytes())


def test_tile_and_halo_must_be_multiples_of_16(tiny):
    _, port = tiny
    x = np.zeros((1, 200, 200, 3), np.float32)
    with pytest.raises(ValueError, match="multiples"):
        port.compress(x, tile_image=40, halo_image=64)


@pytest.mark.parametrize("as_uint8", [False, True])
def test_tiled_decode_matches_jax(tiny, as_uint8):
    """Latent tiles of 4 with halo 4 on a 10 x 9 latent grid (12 x 12
    padded): against the JAX package's tiled decode of the same payload
    (float within 1e-4; uint8 within one level, the rounding of floats
    ~4e-6 apart), and `decompress_many` equal to `decompress`."""
    jax_codec, port = tiny
    x = np.random.RandomState(2).rand(1, 152, 136, 3).astype(np.float32)
    out = port.compress(x)
    got = port.decompress(out, tile_latents=4, halo_latents=4,
                          as_uint8=as_uint8)
    want = np.asarray(jax_codec.decompress(
        jax_container.loads_compressed(_hfc(out)), tile_latents=4,
        halo_latents=4, as_uint8=as_uint8))
    assert got.shape == want.shape == x.shape and got.dtype == want.dtype
    if as_uint8:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, atol=FLOAT_ATOL, rtol=0)
    many = port.decompress_many([out, out], as_uint8=as_uint8,
                                tile_latents=4, halo_latents=4)
    for img in many:
        np.testing.assert_array_equal(img, got)


@pytest.mark.parametrize("as_uint8", [False, True])
def test_device_coders_take_tiling(tiny, as_uint8):
    """A tiled encode and a tiled decode run on the device coders (their
    plain versions here, the entry points that launch the kernels on the
    card): the tiled encode writes the host coder's bytes, and the tiled
    decode, one device decode of the whole payload, returns the host
    decoder's tiled image."""
    _, port = tiny
    x = np.random.RandomState(4).rand(1, 152, 136, 3).astype(np.float32)
    host = port.compress(x, tile_image=64, halo_image=64,
                         device_encode=False)
    dev = port.compress(x, tile_image=64, halo_image=64, device_encode=True)
    assert _hfc(dev) == _hfc(host)
    kw = dict(tile_latents=4, halo_latents=4, as_uint8=as_uint8)
    want = port.decompress(host, device_decode=False, **kw)
    np.testing.assert_array_equal(
        port.decompress(host, device_decode=True, **kw), want)
    for img in port.decompress_many([host, dev], device_decode=True, **kw):
        np.testing.assert_array_equal(img, want)


def test_upsample_inflight_window_does_not_change_the_image():
    """A core's copy waited for at once (inflight 1) or four tiles later:
    the same image; a single tile is fn itself."""
    lat = torch.from_numpy(
        np.random.RandomState(3).rand(1, 2, 9, 11).astype(np.float32))

    def fn(t):  # nearest x4 upsampling plus a 3x3 mean: NCHW -> NHWC
        up = F.interpolate(t, scale_factor=4.0, mode="nearest")
        return F.avg_pool2d(up, 3, 1, 1).permute(0, 2, 3, 1)

    serial = tiled_upsample_apply(fn, lat, scale=4, out_channels=2, tile=4,
                                  halo=2, inflight=1)
    windowed = tiled_upsample_apply(fn, lat, scale=4, out_channels=2, tile=4,
                                    halo=2, inflight=4)
    assert serial.shape == (1, 36, 44, 2)
    np.testing.assert_array_equal(serial, windowed)
    # Away from the seams the cores equal the whole map.
    whole = fn(lat).numpy()
    np.testing.assert_allclose(serial[:, 4:12, 4:12], whole[:, 4:12, 4:12],
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        tiled_upsample_apply(fn, lat, scale=4, out_channels=2, tile=16), whole)
