"""The PyTorch port's GAN training steps against the JAX package's.

Tiny GAN config (`hific_config`: latent 8, 1 residual block, hyperlatent
16, crop 64, batch 2). The JAX package's `create_train_state` makes the
initial state; its codec parameters, discriminator parameters and
spectral state (`u`), and its LPIPS parameters, are carried across to the
port. Both sides get the same quantization noise: the tests replace each
package's `hyperprior.quantize_noise` with one that adds the same seeded
numpy arrays. Gradients of JAX's steps are recovered from its Adam's first
moment (g = mu' / (1 - b1) from mu = 0). Everything runs in fp32 on the
CPU; tolerances are stated at each test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hific_tpu.models.hyperprior as jax_hyperprior_module
import hific_tpu_torch.models.hyperprior as hyperprior_module
from hific_tpu.config import hific_config as jax_hific_config
from hific_tpu.models.lpips import LPIPS as JaxLPIPS
from hific_tpu.models.lpips import default_lpips_params
from hific_tpu.training import schedules as jax_schedules
from hific_tpu.training import train_step as jax_train_step
from hific_tpu_torch.config import Config, hific_config, mse_lpips_config
from hific_tpu_torch.models.discriminator import Discriminator
from hific_tpu_torch.models.hific import HiFiC
from hific_tpu_torch.models.lpips import LPIPS
from hific_tpu_torch.training import checkpoints
from hific_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_disc_optimizer,
    make_optimizers,
    make_train_step_d,
    make_train_step_g,
)
from hific_tpu_torch.weights import (
    disc_state_dict_from_jax,
    lpips_state_dict_from_jax,
    state_dict_from_jax,
)
from test_torch_train import _OPTAX_ADAM, _adam_limit, _jax_adam_state

TINY = dict(latent_channels=8, n_residual_blocks=1, hyperlatent_filters=16,
            crop_size=64, batch_size=2)
BATCH = (2, 64, 64, 3)
# Gradients: each leaf within GRAD_REL of the leaf's largest |gradient|,
# as the compression step's (tests/test_torch_train.py).
GRAD_REL = 1e-4
# Losses and diagnostics.
LOSS_RTOL = 1e-4
# u, a unit vector.
U_ATOL = 1e-6
B1 = _OPTAX_ADAM["b1"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tiny steps on one CPU thread, so that they do not crowd
    out the test processes beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gan():
    cfg = jax_hific_config(**TINY)
    jstate = jax.jit(lambda key: jax_train_step.create_train_state(
        cfg, key))(jax.random.PRNGKey(0))
    lpips_params = default_lpips_params("alex", backbone_seed=0)
    rng = np.random.RandomState(0)
    xg = rng.randint(0, 256, BATCH).astype(np.uint8)
    xd = rng.randint(0, 256, BATCH).astype(np.uint8)
    noise = {  # NHWC shape -> U(-1/2, 1/2)
        (2, 1, 1, 16): rng.uniform(-0.5, 0.5, (2, 1, 1, 16)),
        (2, 4, 4, 8): rng.uniform(-0.5, 0.5, (2, 4, 4, 8)),
    }
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    return cfg, jstate, lpips_params, xg, xd, noise


@pytest.fixture
def shared_noise(gan, monkeypatch):
    noise = gan[5]
    monkeypatch.setattr(jax_hyperprior_module, "quantize_noise",
                        lambda x, rng: x + jnp.asarray(noise[tuple(x.shape)]))

    def port_noise(x, generator):
        nhwc = (x.shape[0], x.shape[2], x.shape[3], x.shape[1])
        return x + torch.from_numpy(noise[nhwc]).permute(0, 3, 1, 2)

    monkeypatch.setattr(hyperprior_module, "quantize_noise", port_noise)


def _port_state(cfg, jstate):
    """The port's train state at JAX's initial one: codec, discriminator
    with its u, fresh Adam moments of both, step 0."""
    pcfg = Config.from_json(cfg.to_json())
    model = HiFiC(pcfg)
    model.load_state_dict(state_dict_from_jax(_np_tree(jstate.params)))
    model = model.to(memory_format=torch.channels_last)
    disc = Discriminator(pcfg.latent_channels)
    disc.load_state_dict(disc_state_dict_from_jax(
        _np_tree(jstate.disc_params), _np_tree(jstate.spectral)))
    disc = disc.to(memory_format=torch.channels_last)
    state = TrainState(0, model, make_optimizers(pcfg, model),
                       torch.Generator(), disc,
                       make_disc_optimizer(pcfg, disc))
    return pcfg, state


def _lpips(lpips_params):
    net = JaxLPIPS(net="alex")
    port = LPIPS()
    port.load_state_dict(lpips_state_dict_from_jax(_np_tree(lpips_params)))
    return (lambda g, r: net.apply({"params": lpips_params}, g, r,
                                   normalize=True),
            lambda g, r: port(g, r, normalize=True))


def _snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _assert_gradients(got, mu_after, what):
    """Port gradients {name: tensor} against JAX's recovered from its first
    moment after one step from zero: within GRAD_REL of each leaf's
    largest |g|, plus the float32 rounding of mu' (4 ulps / (1 - b1))."""
    assert set(got) == set(mu_after), what
    worst = 0.0
    for name, g in got.items():
        mu = mu_after[name].double().numpy()
        want = mu / (1 - B1)
        scale = np.abs(want).max()
        assert scale > 0, (what, name)
        rounding = 4 * np.spacing(np.abs(mu).astype(np.float32)) / (1 - B1)
        err = np.abs(g.double().numpy() - want)
        assert np.all(err <= GRAD_REL * scale + rounding), (
            what, name, float(err.max()), scale)
        worst = max(worst, float(err.max() / (GRAD_REL * scale)))
    return worst


def _assert_after_step(params, adam_after, want_params, lr, what):
    """Parameters after one Adam step from zero moments, each within the
    move `_adam_limit` derives (tests/test_torch_train.py) from JAX's
    moments, with the port's gradients within GRAD_REL of JAX's."""
    count, mu, nu = adam_after
    assert count == 1, what
    for name, p in params.items():
        w = want_params[name].double().numpy()
        m = mu[name].double().numpy()
        g = m / (1 - B1)
        zero = np.zeros_like(m)
        spread, rounding = _adam_limit(zero, zero, m, g, 0, lr, w, GRAD_REL)
        err = np.abs(p.detach().double().numpy() - w)
        assert np.all(err <= spread + rounding), (
            what, name, float((err - spread - rounding).max()))


def _lr(cfg, count):
    return float(jax_schedules.scheduled_param(cfg.learning_rate,
                                               cfg.lr_schedule, count))


def test_g_step_matches_jax(gan, shared_noise):
    """One G step from JAX's initial GAN state: every diagnostic (gen_loss,
    weighted_gen_loss, weighted_compression_loss among them) within rtol
    1e-4; every codec gradient within GRAD_REL; u after the step within
    1e-6; the parameters within the Adam move. The discriminator's
    parameters and Adam state are left bit for bit, with no gradient;
    state.step moves to 1 and the D count stays 0."""
    cfg, jstate, lpips_params, xg, _, _ = gan
    lpips_j, lpips_t = _lpips(lpips_params)
    s1, diag_j = jax.jit(jax_train_step.make_train_step_g(cfg, lpips_j))(
        jstate, jnp.asarray(xg))
    pcfg, state = _port_state(cfg, jstate)
    disc_before = _snapshot(state.disc)
    diag_t = make_train_step_g(pcfg, lpips_t)(state, xg)

    assert set(diag_t) == set(diag_j)
    assert {"gen_loss", "weighted_gen_loss"} <= set(diag_t)
    for k in diag_j:
        np.testing.assert_allclose(float(diag_t[k]), float(diag_j[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    adam = _jax_adam_state(s1.opt_state)
    share = _assert_gradients(
        {n: p.grad for n, p in state.model.named_parameters()}, adam[1],
        "G step")
    _assert_after_step(dict(state.model.named_parameters()), adam,
                       state_dict_from_jax(_np_tree(s1.params)), _lr(cfg, 0),
                       "G step")
    u_j = disc_state_dict_from_jax({}, _np_tree(s1.spectral))
    for name, u in u_j.items():
        np.testing.assert_allclose(state.disc.state_dict()[name].numpy(),
                                   u.numpy(), atol=U_ATOL, err_msg=name)
        assert not np.array_equal(
            u.numpy(), disc_state_dict_from_jax(
                {}, _np_tree(jstate.spectral))[name].numpy())
    for name, v in disc_before.items():
        if not name.endswith(".u"):
            assert torch.equal(state.disc.state_dict()[name], v), name
    assert all(p.grad is None for p in state.disc.parameters())
    assert not state.disc_optimizer.state
    assert state.step == 1 and state.disc_steps == 0
    print("G step: worst gradient error as a share of GRAD_REL:", share)


def test_d_step_matches_jax(gan, shared_noise):
    """One D step from JAX's initial GAN state: disc_loss, D_real and
    D_gen within rtol 1e-4; every discriminator gradient within GRAD_REL;
    u within 1e-6; the discriminator's parameters within the Adam move.
    The codec's parameters and Adam state are left bit for bit, with no
    gradient computed; state.step stays 0 and the D count moves to 1."""
    cfg, jstate, _, _, xd, _ = gan
    s_d, diag_j = jax.jit(jax_train_step.make_train_step_d(cfg))(
        jstate, jnp.asarray(xd))
    pcfg, state = _port_state(cfg, jstate)
    codec_before = _snapshot(state.model)
    diag_t = make_train_step_d(pcfg)(state, xd)

    assert set(diag_t) == set(diag_j) == {"disc_loss", "D_real", "D_gen"}
    for k in diag_j:
        np.testing.assert_allclose(float(diag_t[k]), float(diag_j[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    adam_j = s_d.disc_opt_state[0]
    adam = (int(adam_j.count),
            disc_state_dict_from_jax(_np_tree(adam_j.mu), {}),
            disc_state_dict_from_jax(_np_tree(adam_j.nu), {}))
    share = _assert_gradients(
        {n: p.grad for n, p in state.disc.named_parameters()}, adam[1],
        "D step")
    _assert_after_step(dict(state.disc.named_parameters()), adam,
                       disc_state_dict_from_jax(_np_tree(s_d.disc_params), {}),
                       _lr(cfg, 0), "D step")
    for name, u in disc_state_dict_from_jax({}, _np_tree(s_d.spectral)).items():
        np.testing.assert_allclose(state.disc.state_dict()[name].numpy(),
                                   u.numpy(), atol=U_ATOL, err_msg=name)
    for name, v in codec_before.items():
        assert torch.equal(state.model.state_dict()[name], v), name
    assert all(p.grad is None for p in state.model.parameters())
    assert not state.optimizer.state
    assert state.step == 0 and state.disc_steps == 1
    print("D step: worst gradient error as a share of GRAD_REL:", share)


def test_disc_lr_follows_its_own_count_after_warmstart(tmp_path):
    """A GAN run warmstarted from a compression checkpoint at step 500,000:
    the codec, its Adam state and the step come back, the discriminator
    starts fresh; the generator's learning rate is the schedule's at
    500,000 (1e-5) and the discriminator's at its own count, 0 (1e-4), as
    in the JAX package. A source whose codec differs from the target's
    (its likelihood here) is refused, naming the field, and so is one
    without its config.json."""
    comp, gan_cfg = mse_lpips_config(**TINY), hific_config(**TINY)
    x = np.random.RandomState(1).randint(0, 256, BATCH).astype(np.uint8)
    src = create_train_state(comp, seed=3, device="cpu")
    make_train_step_g(comp)(src, x)
    src.step = 500_000
    path = checkpoints.save_checkpoint(str(tmp_path), src, comp)
    state = checkpoints.restore_train_state(path, gan_cfg, device="cpu",
                                            warmstart=True, seed=3)
    assert state.step == 500_000 and state.disc_steps == 0
    for a, b in zip(src.model.state_dict().values(),
                    state.model.state_dict().values()):
        assert torch.equal(a, b)
    assert (state.optimizer.state_dict()["state"].keys()
            == src.optimizer.state_dict()["state"].keys())
    fresh = create_train_state(gan_cfg, seed=3, device="cpu")
    for name, v in fresh.disc.state_dict().items():
        assert torch.equal(state.disc.state_dict()[name], v), name
    assert not state.disc_optimizer.state

    make_train_step_g(gan_cfg)(state, x)
    make_train_step_d(gan_cfg)(state, x)
    (g_lr,) = {g["lr"] for g in state.optimizer.param_groups}
    (d_lr,) = {g["lr"] for g in state.disc_optimizer.param_groups}
    assert g_lr == _lr(gan_cfg, 500_000) == pytest.approx(1e-5)
    assert d_lr == _lr(gan_cfg, 0) == pytest.approx(1e-4)
    assert state.step == 500_001 and state.disc_steps == 1

    with pytest.raises(ValueError, match="likelihood_type: 'gaussian' in "
                                         "the source, 'logistic' here"):
        checkpoints.restore_train_state(
            path, hific_config(**TINY, likelihood_type="logistic"),
            device="cpu", warmstart=True)
    os.remove(tmp_path / checkpoints.CONFIG_FILENAME)
    with pytest.raises(FileNotFoundError, match="config"):
        checkpoints.restore_train_state(path, gan_cfg, device="cpu",
                                        warmstart=True)
