"""Transforms of the PyTorch port against the JAX package, tiny config.

JAX-initialised parameters of the tiny model the JAX codec tests use are
carried across with `weights.state_dict_from_jax`; the same seeded image
goes through both stacks, fp32 on the CPU. Float stages agree within
rtol/atol 1e-4; the integer stages (symbols, scale-table indices) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hific_tpu.config import mse_lpips_config
from hific_tpu.models.hific import HiFiC as JaxHiFiC
from hific_tpu.ops import padding as jax_padding
from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy.tables import prior_scale_table
from hific_tpu_torch.models.hific import HiFiC
from hific_tpu_torch.ops import padding
from hific_tpu_torch.weights import state_dict_from_jax

TINY = dict(latent_channels=8, n_residual_blocks=1, hyperlatent_filters=16,
            crop_size=64)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    cfg = mse_lpips_config(**TINY)
    jmodel = JaxHiFiC(cfg)
    rng = jax.random.PRNGKey(0)
    variables = jmodel.init({"params": rng, "quantize": rng},
                            jnp.zeros((1, 64, 64, 3)), training=True)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = HiFiC(Config.from_json(cfg.to_json()))
    model.load_state_dict(state_dict_from_jax(params))
    model.eval().requires_grad_(False)
    x = np.random.RandomState(0).rand(1, 80, 96, 3).astype(np.float32)
    table = np.maximum(prior_scale_table(), 0.11).astype(np.float32)
    return jmodel, {"params": params}, model, x, table


def _jax(pair, method, *args):
    jmodel, variables = pair[0], pair[1]
    return jmodel.apply(variables, *args, method=method)


def _t(a) -> torch.Tensor:
    """NHWC numpy -> NCHW channels-last tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _n(t) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def test_encoder_latents(pair):
    """Measured max abs diff 2.7e-6 (limits rtol 1e-4, atol 1e-4)."""
    y_j, shape_j = _jax(pair, JaxHiFiC.encode, jnp.asarray(pair[3]))
    y_t, shape_t = pair[2].encode(_t(pair[3]))
    assert tuple(shape_t) == tuple(shape_j) == (80, 96)
    assert tuple(y_t.shape) == (1, 8, 8, 8)  # 5x6 latents padded to 8x8
    np.testing.assert_allclose(_n(y_t), np.asarray(y_j), **TOL)


def test_hyper_analysis(pair):
    """Measured max abs diff 1.6e-7."""
    y_j, _ = _jax(pair, JaxHiFiC.encode, jnp.asarray(pair[3]))
    z_j = _jax(pair, JaxHiFiC.hyper_analyze, y_j)
    z_t = pair[2].hyperprior.analyze(_t(np.asarray(y_j)))
    np.testing.assert_allclose(_n(z_t), np.asarray(z_j), **TOL)


def test_hyper_synthesis_and_indices(pair):
    """Random hyperlatent symbols (the tiny model's own are all zero at
    initialisation). mu and sigma within tolerance (measured max abs diff
    1.8e-7); the synth_stats indices exact."""
    z = np.round(np.random.RandomState(2).randn(1, 2, 2, 16) * 3)
    z = z.astype(np.int16)
    mu_j, sigma_j, idx_j = _jax(pair, JaxHiFiC.synth_stats, jnp.asarray(z),
                                jnp.asarray(pair[4]))
    mu_t, sigma_t, idx_t = pair[2].synth_stats(_t(z),
                                               torch.from_numpy(pair[4]))
    np.testing.assert_allclose(_n(mu_t), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(_n(sigma_t), np.asarray(sigma_j), **TOL)
    np.testing.assert_array_equal(_n(idx_t), np.asarray(idx_j))
    assert len(np.unique(np.asarray(idx_j))) > 3
    assert idx_t.is_contiguous(memory_format=torch.channels_last)


def test_code_hyper_symbols(pair):
    y_j, _ = _jax(pair, JaxHiFiC.encode, jnp.asarray(pair[3]))
    z_j, bits_j = _jax(pair, JaxHiFiC.code_hyper, y_j)
    z_t, bits_t = pair[2].code_hyper(_t(np.asarray(y_j)))
    np.testing.assert_array_equal(_n(z_t), np.asarray(z_j))
    np.testing.assert_allclose(float(bits_t), float(bits_j), rtol=1e-4)


def test_latent_symbols(pair):
    y_j, _ = _jax(pair, JaxHiFiC.encode, jnp.asarray(pair[3]))
    z_j, _ = _jax(pair, JaxHiFiC.code_hyper, y_j)
    mu_j, sigma_j, _ = _jax(pair, JaxHiFiC.synth_stats, z_j,
                            jnp.asarray(pair[4]))
    sym_j, bits_j = _jax(pair, JaxHiFiC.latent_symbols, y_j, mu_j, sigma_j,
                         None)
    sym_t, bits_t = pair[2].latent_symbols(
        _t(np.asarray(y_j)), _t(np.asarray(mu_j)), _t(np.asarray(sigma_j)))
    np.testing.assert_array_equal(_n(sym_t), np.asarray(sym_j))
    np.testing.assert_allclose(float(bits_t), float(bits_j), rtol=1e-4)


def test_generator(pair):
    """Measured max abs diff 3.9e-6 over [0, 1] pixels."""
    rng = np.random.RandomState(1)
    latents = np.round(rng.randn(1, 8, 8, 8) * 3).astype(np.float32)
    r_j = _jax(pair, JaxHiFiC.generate, jnp.asarray(latents), (80, 96))
    r_t = pair[2].generate(
        _t(latents).contiguous(memory_format=torch.channels_last), (80, 96))
    assert tuple(r_t.shape) == (1, 3, 80, 96)
    np.testing.assert_allclose(_n(r_t), np.asarray(r_j), **TOL)


@pytest.mark.parametrize("h,w,pad", [(5, 6, 1), (2, 2, 3), (1, 3, 2),
                                     (7, 4, 3)])
def test_reflect_padding_matches_jax(h, w, pad):
    """Includes pads wider than the axis, which numpy/jnp reflect by
    repetition."""
    x = np.arange(2 * h * w * 3, dtype=np.float32).reshape(2, h, w, 3)
    pairs = [
        (jax_padding.reflect_pad(jnp.asarray(x), pad),
         padding.reflect_pad(_t(x), pad)),
        (jax_padding.asymmetric_pad_2x(jnp.asarray(x)),
         padding.asymmetric_pad_2x(_t(x))),
        (jax_padding.pad_factor(jnp.asarray(x), 4),
         padding.pad_factor(_t(x), 4)),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(_n(got), np.asarray(want))
        assert got.is_contiguous(memory_format=torch.channels_last)
