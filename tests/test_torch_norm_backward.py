"""ChannelNorm's backward in the PyTorch port against the JAX package.

The port's plain backward (`channel_norm_backward_reference`, the CUDA
backward kernel's plain version) is held against `jax.vjp` of the JAX
package's `channel_norm_fused` (its Pallas kernel in interpret mode on the
CPU, with the closed-form `_cn_bwd`), and against torch autograd of the
plain forward. `channel_norm_fused`'s autograd edge is checked on the CPU,
where both of its directions take the plain versions. The kernel's own
tests are marked `cuda` and skip here.

Tolerances: dx within 1e-5 of the row's scale r * max_C |g * gamma|, the
size of the terms whose difference dx is (at C=2 dx cancels to ~1e-5 of
them); dgamma and dbeta within 1e-5 of the column's sum of |terms|, the
bound of a reordered fp32 sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hific_tpu.ops.pallas_norm import channel_norm_fused as jax_fused
from hific_tpu_torch.ops import fused_norm

REL = 1e-5
# (M rows as (N, H, W), C): C=2 is the smallest the norm takes.
SHAPES = [((2, 5, 7), 60), ((1, 3, 4), 2), ((2, 4, 4), 220), ((1, 2, 3), 960),
          ((3, 3, 5), 37)]


def _data(shape, c, seed, negative_shift=0.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape, c) * 2.0 + 0.5).astype(np.float32)  # NHWC
    gamma = (1.0 + 0.3 * rng.randn(c)).astype(np.float32)
    beta = (0.2 * rng.randn(c) + negative_shift).astype(np.float32)
    g = rng.randn(*shape, c).astype(np.float32)
    return x, gamma, beta, g


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _jax_vjp(x, gamma, beta, g, act):
    _, vjp = jax.vjp(lambda a, b, c: jax_fused(a, b, c, act=act),
                     jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _row_scale(x, gamma, g):
    """r * max_C |g * gamma| per row (NHWC numpy)."""
    c = x.shape[-1]
    centered = x - x.mean(axis=-1, keepdims=True)
    var = (centered * centered).sum(axis=-1, keepdims=True) / (c - 1)
    r = 1.0 / np.sqrt(var + 1e-3)
    return r * np.abs(g * gamma).max(axis=-1, keepdims=True)


def _assert_grads(got, want, x, gamma, g):
    dx, dgamma, dbeta = got
    want_dx, want_dgamma, want_dbeta = want
    assert np.all(np.abs(dx - want_dx) <= REL * _row_scale(x, gamma, g))
    c = x.shape[-1]
    g2 = np.abs(g.reshape(-1, c))
    centered = np.abs(x - x.mean(axis=-1, keepdims=True)).reshape(-1, c)
    x_hat_bound = centered * _row_scale(x, np.ones(c), np.ones_like(x)
                                        ).reshape(-1, 1)
    np.testing.assert_array_less(np.abs(dgamma - want_dgamma),
                                 REL * (g2 * x_hat_bound).sum(axis=0) + 1e-30)
    np.testing.assert_array_less(np.abs(dbeta - want_dbeta),
                                 REL * g2.sum(axis=0) + 1e-30)


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("shape,c", SHAPES)
def test_plain_backward_matches_jax_vjp(shape, c, act):
    x, gamma, beta, g = _data(shape, c, seed=c)
    want = _jax_vjp(x, gamma, beta, g, act)
    dx, dgamma, dbeta = fused_norm.channel_norm_backward_reference(
        _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta), _nchw(g),
        act=act)
    _assert_grads((_nhwc(dx), dgamma.numpy(), dbeta.numpy()), want, x,
                  gamma, g)


def test_relu_mask_with_mostly_negative_preactivations():
    """beta shifted down: about 85% of the ReLU's inputs are negative, so
    most of g is masked, from the recomputed x_hat * gamma + beta."""
    x, gamma, beta, g = _data((2, 6, 6), 48, seed=7, negative_shift=-1.0)
    pre = jax_fused(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    assert float(jnp.mean(pre <= 0)) > 0.8
    want = _jax_vjp(x, gamma, beta, g, "relu")
    dx, dgamma, dbeta = fused_norm.channel_norm_backward_reference(
        _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta), _nchw(g),
        act="relu")
    _assert_grads((_nhwc(dx), dgamma.numpy(), dbeta.numpy()), want, x,
                  gamma, g)


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("shape,c", SHAPES[:3])
def test_plain_backward_matches_torch_autograd(shape, c, act):
    x, gamma, beta, g = _data(shape, c, seed=c + 1)
    xt = _nchw(x).clone().requires_grad_(True)
    gt = torch.from_numpy(gamma).clone().requires_grad_(True)
    bt = torch.from_numpy(beta).clone().requires_grad_(True)
    y = fused_norm.channel_norm_fused_reference(xt, gt, bt, act=act)
    want = torch.autograd.grad(y, (xt, gt, bt), _nchw(g))
    got = fused_norm.channel_norm_backward_reference(
        xt.detach(), gt.detach(), bt.detach(), _nchw(g), act=act)
    _assert_grads([_nhwc(got[0]), got[1].numpy(), got[2].numpy()],
                  [_nhwc(want[0]), want[1].numpy(), want[2].numpy()], x,
                  gamma, g)


def test_autograd_edge_on_the_cpu_takes_the_plain_backward():
    x, gamma, beta, g = _data((2, 4, 5), 60, seed=3)
    xt = _nchw(x).clone().requires_grad_(True)
    gt = torch.from_numpy(gamma).clone().requires_grad_(True)
    bt = torch.from_numpy(beta).clone().requires_grad_(True)
    before = (fused_norm.KERNEL.launches,
              fused_norm.BACKWARD_KERNEL.launches)
    y = fused_norm.channel_norm_fused(xt, gt, bt, act="relu")
    assert y.grad_fn is not None
    y.backward(_nchw(g))
    assert (fused_norm.KERNEL.launches,
            fused_norm.BACKWARD_KERNEL.launches) == before
    want = fused_norm.channel_norm_backward_reference(
        xt.detach(), gt.detach(), bt.detach(), _nchw(g), act="relu")
    for got, w in zip((xt.grad, gt.grad, bt.grad), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    assert xt.grad.is_contiguous(memory_format=torch.channels_last)


def test_no_grad_records_no_edge():
    x, gamma, beta, _ = _data((1, 3, 3), 16, seed=4)
    gt = torch.from_numpy(gamma).clone().requires_grad_(True)
    with torch.no_grad():
        y = fused_norm.channel_norm_fused(_nchw(x), gt, torch.from_numpy(beta))
    assert y.grad_fn is None and not y.requires_grad


def test_backward_takes_a_gradient_in_any_layout():
    """Autograd decides g's layout; a plain NCHW gradient is accepted."""
    x, gamma, beta, g = _data((2, 3, 4), 24, seed=5)
    args = (_nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta))
    a = fused_norm.channel_norm_backward(*args, _nchw(g))
    b = fused_norm.channel_norm_backward(*args, _nchw(g).contiguous())
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# The kernel's paths: C a multiple of 4 takes chunks of 4, one per thread
# at C <= 32 (16: 8 threads per row) and else two, with 8 to 128 threads
# per row (60/64 -> 8, 120/128 -> 16, 220 -> 32, 480 -> 64, 960/1024 ->
# 128); other C take one element per chunk (2, 3: 32 threads per row; 50,
# 61: 64; 129: 256; 1023: 256 threads with 4 chunks each). M = 1 and 7
# leave most rows of a block empty; M = 2048 and the training step's M
# take full blocks and, beyond 264 blocks, blocks that stride over rows.
KERNEL_SHAPES = ([(m, c) for c in (2, 3, 16, 60, 61, 64, 120, 128, 129, 220,
                                   960, 1023, 1024) for m in (1, 7, 2048)]
                 + [(524288, 60), (131072, 120), (32768, 240), (8192, 480),
                    (65537, 61), (100003, 1024), (777, 50), (5, 2)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("m,c", KERNEL_SHAPES)
def test_backward_kernel_matches_plain_on_the_card(cuda_device, m, c, act,
                                                   dtype):
    """fp32: dx within 1e-5 of the row's scale r * max_C |g * gamma|,
    dgamma/dbeta within 1e-5 of the column's sum of |terms|, where a term
    g * x_hat counts as |g| * r * (|x - mu| + |mu|): x_hat = (x - mu) * r
    carries the rounding of mu, a sum of C values, whatever the order of
    the sum over rows (at M = 1 a column has one term, and that rounding
    alone reached 3e-5 of it at C = 60). bf16: dx within
    one bf16 ulp more, the sums as in fp32 (both sides read the same bf16
    inputs and accumulate in fp32). For the ReLU, where its input
    x_hat * gamma + beta is within 1e-5 of its terms' size of 0, the two
    sides may take either side of the kink: the rows holding such inputs
    (at most 1e-4 of the inputs) are left out of the dx check, and their
    |terms| are added to the sums' limits. Two runs give the same bits."""
    gen = torch.Generator().manual_seed(m + c)
    def rows(scale=1.0):
        t = torch.randn((1, m, 1, c), generator=gen) * scale
        return t.permute(0, 3, 1, 2).to(cuda_device, dtype).contiguous(
            memory_format=torch.channels_last)
    x, g = rows(2.0), rows()
    gamma = (1.0 + 0.1 * torch.randn(c, generator=gen)).to(cuda_device)
    beta = (0.1 * torch.randn(c, generator=gen)).to(cuda_device)
    before = fused_norm.BACKWARD_KERNEL.launches
    dx, dgamma, dbeta = fused_norm.channel_norm_backward(x, gamma, beta, g,
                                                         act=act)
    again = fused_norm.channel_norm_backward(x, gamma, beta, g, act=act)
    torch.cuda.synchronize()
    assert fused_norm.BACKWARD_KERNEL.launches == before + 2
    for u, v in zip((dx, dgamma, dbeta), again):
        assert torch.equal(u, v)
    assert dx.dtype == dtype
    assert dx.is_contiguous(memory_format=torch.channels_last)
    want_dx, want_dgamma, want_dbeta = \
        fused_norm.channel_norm_backward_reference(x, gamma, beta, g, act=act)
    xf, gf = x.float(), g.float()
    gam, bet = gamma.view(1, c, 1, 1), beta.view(1, c, 1, 1)
    centered = xf - xf.mean(1, keepdim=True)
    r = torch.rsqrt((centered * centered).sum(1, keepdim=True) / (c - 1)
                    + 1e-3)
    x_hat = centered * r
    near = torch.zeros_like(xf, dtype=torch.bool)
    if act == "relu":
        near = (x_hat * gam + bet).abs() <= REL * ((x_hat * gam).abs()
                                                   + bet.abs())
    assert float(near.float().mean()) <= 1e-4
    near_row = near.any(dim=1, keepdim=True)
    row_scale = r * (gf * gam).abs().amax(1, keepdim=True)
    diff = (dx.float() - want_dx).abs()
    limit = REL * row_scale
    if dtype == torch.bfloat16:
        limit = limit + torch.exp2(torch.floor(torch.log2(
            want_dx.abs().clamp_min(2.0 ** -126))) - 7.0)
    assert bool(((diff <= limit) | near_row).all())
    kink_g = (gf.abs() * x_hat.abs() * near).sum(dim=(0, 2, 3))
    kink_b = (gf.abs() * near).sum(dim=(0, 2, 3))
    x_hat_terms = r * (centered.abs() + xf.mean(1, keepdim=True).abs())
    assert bool(((dgamma - want_dgamma).abs()
                 <= REL * (gf.abs() * x_hat_terms).sum(dim=(0, 2, 3))
                 + kink_g + 1e-30).all())
    assert bool(((dbeta - want_dbeta).abs()
                 <= REL * gf.abs().sum(dim=(0, 2, 3)) + kink_b + 1e-30).all())
