"""ChannelNorm of the PyTorch port against the JAX package.

The port's plain `channel_norm` and `channel_norm_fused_reference` (the CUDA
kernel's plain version) are held against the JAX package's `channel_norm`
and its Pallas kernel `channel_norm_fused` (interpret mode on the CPU) on
the same seeded inputs. The CUDA kernel itself runs only on a card: its test
is marked `cuda` and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hific_tpu.ops.channel_norm import channel_norm as jax_channel_norm
from hific_tpu.ops.pallas_norm import channel_norm_fused as jax_fused
from hific_tpu_torch.ops import fused_norm
from hific_tpu_torch.ops.channel_norm import channel_norm

ATOL = 1e-5


def _data(c, seed=0, shape=(2, 5, 7)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape, c) * 2.0 + 0.5).astype(np.float32)  # NHWC
    gamma = (1.0 + 0.3 * rng.randn(c)).astype(np.float32)
    beta = (0.2 * rng.randn(c)).astype(np.float32)
    return x, gamma, beta


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor stored channels-last (a permuted view)."""
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("c", [60, 220, 960])
def test_plain_and_reference_match_jax(c, act):
    """Measured max abs error 1.4e-6 over the six cases (limit 1e-5)."""
    x, gamma, beta = _data(c)
    want = jax_channel_norm(jnp.asarray(x), jnp.asarray(gamma),
                            jnp.asarray(beta))
    if act == "relu":
        want = jax.nn.relu(want)
    want_fused = jax_fused(jnp.asarray(x), jnp.asarray(gamma),
                           jnp.asarray(beta), act=act)
    xt, gt, bt = _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta)
    plain = channel_norm(xt, gt, bt)
    if act == "relu":
        plain = torch.relu(plain)
    ref = fused_norm.channel_norm_fused_reference(xt, gt, bt, act=act)
    for got in (plain, ref):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want_fused),
                                   atol=ATOL, rtol=0)


def test_wrapper_on_cpu_takes_the_plain_path():
    x, gamma, beta = _data(60, seed=1)
    xt, gt, bt = _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta)
    before = fused_norm.KERNEL.launches
    got = fused_norm.channel_norm_fused(xt, gt, bt, act="relu")
    assert fused_norm.KERNEL.launches == before
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(
        got, fused_norm.channel_norm_fused_reference(xt, gt, bt, act="relu"),
        rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, gamma, beta = _data(60, seed=2)
    gt, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
    nchw_contiguous = _nchw(x).contiguous()  # the layout slip to catch
    with pytest.raises(ValueError, match="channels_last"):
        fused_norm.channel_norm_fused(nchw_contiguous, gt, bt)
    with pytest.raises(ValueError, match="gamma"):
        fused_norm.channel_norm_fused(_nchw(x), gt[:10], bt)
    with pytest.raises(ValueError, match="act"):
        fused_norm.channel_norm_fused(_nchw(x), gt, bt, act="elu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("m,c", [(1536, 960), (1536, 220), (6144, 480),
                                 (24576, 240), (98304, 120), (393216, 60),
                                 (777, 50)])
def test_kernel_matches_plain_on_the_card(cuda_device, m, c, act, dtype):
    """Kernel vs its plain version: fp32 within 1e-5; bf16 within one ulp
    of the output plus 1e-5, since where gamma * x_hat and beta nearly
    cancel, the two fp32 computations differ by a few fp32 ulps of the terms,
    more than a bf16 ulp of the small result (chip_smoke.py measured 9 of
    2.4e7 values beyond one ulp on an H100, by at most 3.0e-8)."""
    gen = torch.Generator().manual_seed(m + c)
    x = torch.randn((1, m, 1, c), generator=gen).permute(0, 3, 1, 2)
    x = x.to(cuda_device, dtype).contiguous(memory_format=torch.channels_last)
    gamma = (1.0 + 0.1 * torch.randn(c, generator=gen)).to(cuda_device)
    beta = (0.1 * torch.randn(c, generator=gen)).to(cuda_device)
    before = fused_norm.KERNEL.launches
    got = fused_norm.channel_norm_fused(x, gamma, beta, act=act)
    torch.cuda.synchronize()
    assert fused_norm.KERNEL.launches == before + 1
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = fused_norm.channel_norm_fused_reference(x, gamma, beta, act=act)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= ATOL
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp_min(2.0 ** -126))) - 7.0)
        assert bool((diff <= ulp + ATOL).all())
