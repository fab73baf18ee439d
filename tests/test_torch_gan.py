"""The PyTorch port's GAN modules against the JAX package's: the spectrally
normalised conv, the conditional patchGAN discriminator, the GAN losses,
and the discriminator's weights carried across both ways.

Inputs are made from seeds with numpy; everything runs in fp32 on the CPU.
Tolerances are stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hific_tpu.config import hific_config as jax_hific_config
from hific_tpu.models.discriminator import Discriminator as JaxDiscriminator
from hific_tpu.models.hific import DiscOut as JaxDiscOut
from hific_tpu.models.layers import SNConv as JaxSNConv
from hific_tpu.training import losses as jax_losses
from hific_tpu_torch.config import Config, hific_config
from hific_tpu_torch.models.discriminator import Discriminator
from hific_tpu_torch.models.hific import (
    DiscOut,
    Intermediates,
    discriminator_forward,
    init_random_,
)
from hific_tpu_torch.models.layers import SNConv
from hific_tpu_torch.training import losses
from hific_tpu_torch.training.train_step import create_train_state
from hific_tpu_torch.weights import (
    disc_state_dict_from_jax,
    flatten_tree,
    jax_disc_from_model,
)

TINY = dict(latent_channels=8, n_residual_blocks=1, hyperlatent_filters=16,
            crop_size=64, batch_size=2)


def _t(a) -> torch.Tensor:
    """NHWC numpy -> NCHW channels-last tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).permute(
        0, 3, 1, 2)


def _n(t) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _jax_sigma(kernel, u, eps=1e-12):
    """sigma of the JAX package's SNConv (`models/layers.py`), its lines."""
    w_mat = kernel.transpose(3, 2, 0, 1).reshape(kernel.shape[-1], -1)
    l2n = lambda a: a / (jnp.linalg.norm(a) + eps)  # noqa: E731
    v = l2n(w_mat.T @ u)
    return jnp.dot(l2n(w_mat @ v), w_mat @ v)


def _sn_module(kernel, bias, u) -> SNConv:
    m = SNConv(kernel.shape[2], kernel.shape[3])
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        m.bias.copy_(torch.from_numpy(bias))
        m.u.copy_(torch.from_numpy(u))
    return m


@pytest.mark.parametrize("update_stats", [True, False])
def test_snconv_matches_jax(update_stats):
    """Output within 1e-5 of its largest magnitude, sigma within rtol 1e-6,
    u' within 1e-6 (a unit vector); u moves only with update_stats."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 20, 15).astype(np.float32)
    kernel = (rng.randn(4, 4, 15, 64) * 0.1).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    u = rng.randn(64).astype(np.float32)
    out_j, mutated = JaxSNConv(64, 4).apply(
        {"params": {"kernel": kernel, "bias": bias}, "spectral": {"u": u}},
        jnp.asarray(x), update_stats=update_stats, mutable=["spectral"])
    u_j = np.asarray(mutated["spectral"]["u"])
    sigma_j = float(_jax_sigma(jnp.asarray(kernel), jnp.asarray(u)))

    m = _sn_module(kernel, bias, u)
    assert float(m.sigma(update_stats=False).detach()) == pytest.approx(
        sigma_j, rel=1e-6)
    assert torch.equal(m.u, torch.from_numpy(u))
    out_t = m(_t(x), update_stats=update_stats)
    assert out_t.shape == (2, 64, 8, 10)
    out_j = np.asarray(out_j)
    np.testing.assert_allclose(_n(out_t), out_j,
                               atol=1e-5 * np.abs(out_j).max())
    np.testing.assert_allclose(m.u.numpy(), u_j, atol=1e-6)
    if not update_stats:
        np.testing.assert_array_equal(m.u.numpy(), u)


def test_snconv_backward_through_sigma_and_u_update():
    """The weight's gradient goes through sigma (the JAX package's, within
    1e-5 of its largest), and the buffer's update in the forward does not
    disturb the backward (no version-counter error)."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 15).astype(np.float32)
    kernel = (rng.randn(4, 4, 15, 64) * 0.1).astype(np.float32)
    bias = np.zeros(64, np.float32)
    u = rng.randn(64).astype(np.float32)
    w_out = rng.randn(2, 4, 4, 64).astype(np.float32)

    def loss_j(k):
        y, _ = JaxSNConv(64, 4).apply(
            {"params": {"kernel": k, "bias": bias}, "spectral": {"u": u}},
            jnp.asarray(x), mutable=["spectral"])
        return jnp.sum(y * w_out)

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(kernel)))
    m = _sn_module(kernel, bias, u)
    (m(_t(x)) * _t(w_out)).sum().backward()
    g_t = m.weight.grad.numpy().transpose(2, 3, 1, 0)
    np.testing.assert_allclose(g_t, g_j, atol=1e-5 * np.abs(g_j).max())
    # Through sigma: the gradient of the conv with W / sigma held constant
    # differs from it.
    m2 = _sn_module(kernel, bias, u)
    sigma = m2.sigma(update_stats=False).detach()
    y = torch.nn.functional.conv2d(
        torch.nn.functional.pad(_t(x), (1, 1, 1, 1), mode="reflect"),
        m2.weight / sigma, m2.bias, stride=2)
    (y * _t(w_out)).sum().backward()
    assert not np.allclose(m2.weight.grad.numpy().transpose(2, 3, 1, 0), g_j,
                           atol=1e-3 * np.abs(g_j).max())


@pytest.fixture(scope="module")
def jax_disc():
    rng = np.random.RandomState(2)
    x = rng.rand(4, 64, 48, 3).astype(np.float32)
    y = rng.randn(4, 4, 3, 8).astype(np.float32)
    variables = jax.jit(lambda k: JaxDiscriminator().init(
        k, jnp.asarray(x), jnp.asarray(y)))(jax.random.PRNGKey(3))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return x, y, variables["params"], variables["spectral"]


def _port_disc(params, spectral) -> Discriminator:
    disc = Discriminator(8)
    disc.load_state_dict(disc_state_dict_from_jax(params, spectral))
    return disc.to(memory_format=torch.channels_last)


def test_discriminator_matches_jax(jax_disc):
    """Probabilities and logits within 1e-5 (logits: of their largest
    magnitude), in (N, h, w) order; every parameter's gradient of a random
    projection of the logits within 1e-4 of its leaf's largest; u after
    the call within 1e-6."""
    x, y, params, spectral = jax_disc
    w_out = np.random.RandomState(4).randn(4 * 4 * 3, 1).astype(np.float32)

    def loss_j(p):
        (probs, logits), mutated = JaxDiscriminator().apply(
            {"params": p, "spectral": spectral}, jnp.asarray(x),
            jnp.asarray(y), mutable=["spectral"])
        return jnp.sum(logits * w_out), (probs, logits, mutated["spectral"])

    (_, (probs_j, logits_j, spectral_j)), grads_j = jax.jit(
        jax.value_and_grad(loss_j, has_aux=True))(params)
    disc = _port_disc(params, spectral)
    probs_t, logits_t = disc(_t(x).contiguous(memory_format=torch.channels_last),
                             _t(y))
    assert probs_t.shape == logits_t.shape == (48, 1)
    logits_j = np.asarray(logits_j)
    np.testing.assert_allclose(logits_t.detach().numpy(), logits_j,
                               atol=1e-5 * np.abs(logits_j).max())
    np.testing.assert_allclose(probs_t.detach().numpy(), np.asarray(probs_j),
                               atol=1e-5)
    (logits_t * torch.from_numpy(w_out)).sum().backward()
    want = disc_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads_j), {})
    got = {n: p.grad for n, p in disc.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    u_j = disc_state_dict_from_jax({}, jax.tree_util.tree_map(np.asarray,
                                                              spectral_j))
    for name, u in u_j.items():
        np.testing.assert_allclose(disc.state_dict()[name].numpy(), u.numpy(),
                                   atol=1e-6, err_msg=name)


def test_discriminator_forward_matches_jax(jax_disc):
    """Real first, one pass: DiscOut within 1e-5 (logits: of their largest
    magnitude) and u advanced once; the latents are detached, the
    generated images only without train_generator. With update_stats=False
    the same DiscOut and u left as it was, bit for bit (JAX's SNConv
    computes sigma from u' either way and mutates nothing)."""
    x, y, params, spectral = jax_disc
    real, gen, latents = x[:2], x[2:], y[:2]
    from hific_tpu.models.hific import HiFiC as JaxHiFiC
    from hific_tpu.models.hific import Intermediates as JaxIntermediates

    cfg = jax_hific_config(**TINY)
    inter_j = JaxIntermediates(jnp.asarray(real), jnp.asarray(gen),
                               jnp.asarray(latents), None, None)
    out_j, mutated = JaxHiFiC(cfg).apply(
        {"params": {"discriminator": params},
         "spectral": {"discriminator": spectral}},
        inter_j, train_generator=True,
        method=JaxHiFiC.discriminator_forward, mutable=["spectral"])
    disc = _port_disc(params, spectral)
    gen_t = _t(gen).requires_grad_(True)
    lat_t = _t(latents).requires_grad_(True)
    for train_generator in (False, True):
        disc.load_state_dict(disc_state_dict_from_jax(params, spectral))
        out_t = discriminator_forward(
            Intermediates(_t(real), gen_t, lat_t, None, None), disc,
            train_generator)
        for field in DiscOut._fields:
            want = np.asarray(getattr(out_j, field))
            np.testing.assert_allclose(
                getattr(out_t, field).detach().numpy(), want,
                atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=field)
        u_j = disc_state_dict_from_jax({}, jax.tree_util.tree_map(
            np.asarray, mutated["spectral"]))
        for name, u in u_j.items():
            np.testing.assert_allclose(disc.state_dict()[name].numpy(),
                                       u.numpy(), atol=1e-6)
        out_t.d_gen_logits.sum().backward()
        assert (gen_t.grad is not None) == train_generator
        assert lat_t.grad is None

    loaded = disc_state_dict_from_jax(params, spectral)
    disc.load_state_dict(loaded)
    out_t = discriminator_forward(
        Intermediates(_t(real), _t(gen), _t(latents), None, None), disc,
        train_generator=False, update_stats=False)
    for field in DiscOut._fields:
        want = np.asarray(getattr(out_j, field))
        np.testing.assert_allclose(
            getattr(out_t, field).detach().numpy(), want,
            atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=field)
    for name in u_j:
        assert torch.equal(disc.state_dict()[name], loaded[name]), name


@pytest.mark.parametrize("kind", ["non_saturating", "least_squares"])
def test_gan_losses_match_jax(kind):
    """D and G losses within rtol 1e-6 on the same logits."""
    rng = np.random.RandomState(5)
    logits = [(rng.randn(96) * 3).astype(np.float32) for _ in range(2)]
    probs = [1 / (1 + np.exp(-a)) for a in logits]
    out_j = JaxDiscOut(*(jnp.asarray(a) for a in probs + logits))
    out_t = DiscOut(*(torch.from_numpy(a) for a in probs + logits))
    d_j, g_j = jax_losses.gan_loss(kind, out_j)
    d_t, g_t = losses.gan_loss(kind, out_t)
    assert float(d_t) == pytest.approx(float(d_j), rel=1e-6)
    assert float(g_t) == pytest.approx(float(g_j), rel=1e-6)
    with pytest.raises(ValueError):
        losses.gan_loss("wasserstein", out_t)


def test_disc_weights_round_trip_bit_for_bit(jax_disc):
    """JAX -> port -> JAX and port -> JAX -> port: every leaf and u equal,
    bit for bit, in the JAX train state's layout (`disc_params`, and
    `spectral` under `discriminator/`); the SNConv kernels are transposed,
    not flipped."""
    _, _, disc_params, spectral = jax_disc
    spectral = {"discriminator": spectral}
    disc = Discriminator(8)
    disc.load_state_dict(disc_state_dict_from_jax(disc_params, spectral))
    params, got_spectral = jax_disc_from_model(disc)
    for got, want in ((params, flatten_tree(disc_params)),
                      (got_spectral, flatten_tree(spectral))):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    k1 = flatten_tree(disc_params)["conv1/kernel"]
    np.testing.assert_array_equal(disc.conv1.weight.detach().numpy(),
                                  k1.transpose(3, 2, 0, 1))

    seeded = init_random_(Discriminator(8), torch.Generator().manual_seed(7))
    back = disc_state_dict_from_jax(*jax_disc_from_model(seeded))
    assert set(back) == set(seeded.state_dict())
    for k, v in seeded.state_dict().items():
        assert torch.equal(back[k], v), k


def test_seeded_discriminator_and_codec_state_dict():
    """init_random_ draws the discriminator: N(0, 1/fan_in) weights, zero
    biases, u ~ N(0, 1). The GAN train state keeps it out of the codec's
    state_dict, whose keys are the compression stage's."""
    disc = init_random_(Discriminator(8), torch.Generator().manual_seed(0))
    for name, p in disc.state_dict().items():
        if name.endswith("bias"):
            assert not p.any(), name
        elif name.endswith("weight") and p.numel() > 1000:
            fan_in = p[0].numel()
            assert abs(float(p.std()) * fan_in ** 0.5 - 1) < 0.1, name
    us = torch.cat([disc.state_dict()[f"conv{i}.u"] for i in range(1, 5)])
    assert abs(float(us.std()) - 1) < 0.1 and abs(float(us.mean())) < 0.1
    gan = create_train_state(hific_config(**TINY), seed=1, device="cpu")
    comp = create_train_state(Config(**TINY), seed=1, device="cpu")
    assert gan.model.state_dict().keys() == comp.model.state_dict().keys()
    assert not any(k.startswith("disc") for k in gan.model.state_dict())
    for a, b in zip(gan.model.state_dict().values(),
                    comp.model.state_dict().values()):
        assert torch.equal(a, b)  # the codec's draws come first
    assert set(gan.disc.state_dict()) == set(disc.state_dict())
    assert comp.disc is None
