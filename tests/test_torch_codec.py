"""The slice as a whole: the PyTorch port's codec against the JAX `Codec`.

For the same weights and image, the port's `.hfc` bytes equal the JAX
package's, each side decodes the other's file, and the reconstructions
agree within 1e-3 on [0, 1]. Two models: the tiny config of the JAX codec
tests with JAX-initialised parameters, and the flagship artifact at a small
crop, both fp32 on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hific_tpu.codec import Codec as JaxCodec
from hific_tpu.config import mse_lpips_config
from hific_tpu.models.hific import HiFiC as JaxHiFiC
from hific_tpu.training.checkpoints import load_params_npz
from hific_tpu_torch.codec import Codec
from hific_tpu_torch.config import Config
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
