"""Weights carried from the JAX package's layout to the PyTorch port's.

bfloat16 leaves (stored by numpy as raw `|V2` records) must widen to the
float32 values ml_dtypes/JAX give them, and the Conv / ConvTranspose layout
conversions must reproduce the JAX layers' outputs on random weights.
"""

import io
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from hific_tpu.models import layers as jax_layers
from hific_tpu_torch.models import layers
from hific_tpu_torch.weights import (
    bf16_bits_to_float32,
    convert_leaf,
    leaf_to_float32,
    state_dict_from_jax,
)

ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "flagship_rd30k_f16.npz")
ATOL = 1e-5


def test_bf16_leaves_decode_like_ml_dtypes():
    rng = np.random.RandomState(0)
    values = np.concatenate([
        rng.randn(1000).astype(np.float32) * 10.0 ** rng.randint(-8, 8, 1000),
        np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, 3.4e38], np.float32)])
    bf16 = values.astype(ml_dtypes.bfloat16)
    buf = io.BytesIO()
    np.savez(buf, leaf=bf16)  # numpy writes bfloat16 as raw |V2 records
    buf.seek(0)
    stored = np.load(buf)["leaf"]
    assert stored.dtype.kind == "V" and stored.dtype.itemsize == 2
    want = bf16.astype(np.float32)
    np.testing.assert_array_equal(leaf_to_float32(stored), want)
    np.testing.assert_array_equal(leaf_to_float32(bf16), want)
    np.testing.assert_array_equal(bf16_bits_to_float32(bf16), want)


def test_artifact_bf16_leaves_decode_like_ml_dtypes():
    """The flagship artifact's 16 |V2 leaves (upconvs and hyper-synthesis
    transposed convs) widen to JAX's bfloat16 values."""
    with np.load(ARTIFACT) as z:
        names = [n for n in z.files if n.startswith("p:generator/upconv")
                 or (n.startswith("p:hyperprior/synthesis_")
                     and "/conv3/" not in n)]
        assert len(names) == 16
        for name in names:
            leaf = z[name]
            assert leaf.dtype.kind == "V" and leaf.dtype.itemsize == 2, name
            want = leaf.view(ml_dtypes.bfloat16).astype(np.float32)
            np.testing.assert_array_equal(leaf_to_float32(leaf), want)


def _jax_apply(module, x, seed=0):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    out = module.apply(params, jnp.asarray(x))
    return np.asarray(out), jax.tree_util.tree_map(np.asarray,
                                                   params["params"])


def _load(module, params, prefix):
    """Carry a JAX layer's params (under `prefix`) into a port module."""
    state = state_dict_from_jax({prefix: params})
    module.load_state_dict({k[len(prefix) + 1:]: v for k, v in state.items()})
    return module


@pytest.mark.parametrize("k,stride,padding,mode", [
    (7, 1, 3, "reflect"), (3, 2, 0, "zeros"), (3, 1, 1, "zeros"),
    (5, 2, 2, "reflect")])
def test_conv_layout_reproduces_jax(k, stride, padding, mode):
    rng = np.random.RandomState(k + stride)
    x = rng.randn(1, 13, 11, 6).astype(np.float32)
    want, params = _jax_apply(
        jax_layers.Conv(features=5, kernel_size=k, stride=stride,
                        padding=padding, padding_mode=mode), x)
    conv = layers.Conv(6, 5, k, stride=stride, padding=padding,
                       padding_mode=mode)
    _load(conv, params, "conv")
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("k,padding", [(3, 1), (5, 2)])
def test_conv_transpose_layout_reproduces_jax(k, padding):
    """The JAX kernel is the flipped HWIO kernel of an input-dilated
    correlation; converted, F.conv_transpose2d gives the same output."""
    rng = np.random.RandomState(k)
    x = rng.randn(1, 5, 7, 6).astype(np.float32)
    want, params = _jax_apply(
        jax_layers.ConvTranspose(features=4, kernel_size=k, stride=2,
                                 padding=padding, output_padding=1), x)
    conv = layers.ConvTranspose(6, 4, k, stride=2, padding=padding)
    _load(conv, params, "up")
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 10, 14, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL, rtol=0)


def test_convert_leaf_paths():
    kernel = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    key, conv = convert_leaf("encoder/conv_stem/Conv_0/kernel", kernel)
    assert key == "encoder.conv_stem.weight"
    np.testing.assert_array_equal(conv, kernel.transpose(3, 2, 0, 1))
    key, convt = convert_leaf("generator/upconv0/kernel", kernel)
    assert key == "generator.upconv0.weight"
    np.testing.assert_array_equal(convt[:, :, 0, 0], kernel[1, 2])
    key, _ = convert_leaf("generator/norm_in/gamma", np.ones(3, np.float16))
    assert key == "generator.norm_in.gamma"
