"""The PyTorch port's compression training against the JAX package's.

Tiny config (latent 8, 1 residual block, hyperlatent 16, crop 64, batch
2). The JAX package's initial parameters, and its LPIPS parameters (the
seeded random backbone with the packaged lin heads), are carried across
with `weights.state_dict_from_jax` / `lpips_state_dict_from_jax`. Both
sides get the same quantization noise: the tests replace each package's
`hyperprior.quantize_noise` with one that adds the same seeded numpy
arrays. Everything runs in fp32 on the CPU; tolerances are stated at each
test.
"""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hific_tpu.models.hyperprior as jax_hyperprior_module
import hific_tpu_torch.models.hyperprior as hyperprior_module
from hific_tpu.config import mse_lpips_config as jax_mse_lpips_config
from hific_tpu.models.hific import HiFiC as JaxHiFiC
from hific_tpu.models.hific import Intermediates as JaxIntermediates
from hific_tpu.models.layers import Norm as JaxNorm
from hific_tpu.models.lpips import LPIPS as JaxLPIPS
from hific_tpu.models.lpips import default_lpips_params
from hific_tpu.ops import d2s as jax_d2s
from hific_tpu.ops import maths as jax_maths
from hific_tpu.ops import quantize as jax_quantize
from hific_tpu.training import checkpoints as jax_checkpoints
from hific_tpu.training import losses as jax_losses
from hific_tpu.training import schedules as jax_schedules
from hific_tpu.training import train_step as jax_train_step
from hific_tpu_torch import runtime
from hific_tpu_torch.cli import train as train_cli
from hific_tpu_torch.config import Config, Schedule
from hific_tpu_torch.kinks import KinkSides
from hific_tpu_torch.models.hific import HiFiC, Intermediates
from hific_tpu_torch.models.lpips import LPIPS
from hific_tpu_torch.ops import maths, quantize
from hific_tpu_torch.training import checkpoints, losses, schedules
from hific_tpu_torch.training.data import TrainDataset
from hific_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_optimizers,
    make_train_step_g,
)
from hific_tpu_torch.weights import (
    flatten_tree,
    jax_params_from_model,
    lpips_state_dict_from_jax,
    state_dict_from_jax,
)

TINY = dict(latent_channels=8, n_residual_blocks=1, hyperlatent_filters=16,
            crop_size=64, batch_size=2)
BATCH = (2, 64, 64, 3)
# Gradients: each leaf within GRAD_REL of the leaf's largest |gradient|
# (measured: 3.0e-5 at worst, encoder.norm_stem.gamma).
GRAD_REL = 1e-4
# Loss and diagnostics.
LOSS_RTOL = 1e-4
# Forward activations: the tolerance the port's transforms are held to
# (tests/test_torch_transforms.py, 1e-4), here as a share of a layer's
# largest |pre-activation|. A pre-activation within it of a ReLU's kink may
# fall on either side in the two stacks.
KINK_REL = 1e-4


def _t(a) -> torch.Tensor:
    """NHWC numpy -> NCHW channels-last tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _n(t) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def tiny():
    cfg = jax_mse_lpips_config(**TINY)
    jstate = jax.jit(lambda key: jax_train_step.create_train_state(
        cfg, key))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    lpips_params = default_lpips_params("alex", backbone_seed=0)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, BATCH).astype(np.uint8)
    noise = {  # NHWC shape -> U(-1/2, 1/2)
        (2, 1, 1, 16): rng.uniform(-0.5, 0.5, (2, 1, 1, 16)),
        (2, 4, 4, 8): rng.uniform(-0.5, 0.5, (2, 4, 4, 8)),
    }
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    return cfg, jstate, params, lpips_params, x, noise


@pytest.fixture
def shared_noise(tiny, monkeypatch):
    noise = tiny[5]
    monkeypatch.setattr(jax_hyperprior_module, "quantize_noise",
                        lambda x, rng: x + jnp.asarray(noise[tuple(x.shape)]))

    def port_noise(x, generator):
        nhwc = (x.shape[0], x.shape[2], x.shape[3], x.shape[1])
        return x + _t(noise[nhwc])

    monkeypatch.setattr(hyperprior_module, "quantize_noise", port_noise)


def _port_config(cfg) -> Config:
    return Config.from_json(cfg.to_json())


def _port_model(cfg, params) -> HiFiC:
    model = HiFiC(_port_config(cfg))
    model.load_state_dict(state_dict_from_jax(params))
    return model.to(memory_format=torch.channels_last)


def _port_lpips(lpips_params) -> LPIPS:
    lpips = LPIPS()
    lpips.load_state_dict(lpips_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, lpips_params)))
    return lpips


def _jax_lpips_apply(lpips_params):
    net = JaxLPIPS(net="alex")
    return lambda g, r: net.apply({"params": lpips_params}, g, r,
                                  normalize=True)


@pytest.mark.parametrize("name", ["identity", "toward"])
def test_bound_gradient_rules_match_jax(name):
    """Values and gradients exactly equal, including g < 0 below the
    bound (passed by `toward`) and g > 0 below it (blocked)."""
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, 64).astype(np.float32)
    g = rng.randn(64).astype(np.float32)
    bound = 0.11
    jax_fn = getattr(jax_maths, f"lower_bound_{name}")
    y_j, vjp = jax.vjp(lambda a: jax_fn(a, bound), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = getattr(maths, f"lower_bound_{name}")(xt, bound)
    (dx_t,) = torch.autograd.grad(y_t, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(dx_t.numpy(), np.asarray(dx_j))
    below = x < bound
    assert (below & (g < 0)).any() and (below & (g > 0)).any()
    if name == "toward":
        assert np.all(dx_t.numpy()[below & (g > 0)] == 0)
        assert np.all(dx_t.numpy()[below & (g < 0)] == g[below & (g < 0)])


def test_quantizers_and_entropy_match_jax():
    """Rounding and straight-through values and gradients exact; the
    entropy estimate within rtol 1e-6."""
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 3, 4, 5) * 3).astype(np.float32)
    means = rng.randn(2, 3, 4, 5).astype(np.float32)
    for fn in ("quantize_round", "quantize_ste"):
        want = getattr(jax_quantize, fn)(jnp.asarray(x), jnp.asarray(means))
        got = getattr(quantize, fn)(torch.from_numpy(x),
                                    torch.from_numpy(means))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(quantize.quantize_ste(xt).sum(), xt)
    assert torch.equal(g, torch.ones_like(g))
    lik = rng.uniform(1e-6, 1, (2, 3, 4, 5)).astype(np.float32)
    bits_j, bpp_j = jax_quantize.estimate_entropy(jnp.asarray(lik), (64, 64))
    bits_t, bpp_t = quantize.estimate_entropy(torch.from_numpy(lik), (64, 64))
    np.testing.assert_allclose(float(bits_t), float(bits_j), rtol=1e-6)
    np.testing.assert_allclose(float(bpp_t), float(bpp_j), rtol=1e-6)
    noisy = quantize.quantize_noise(torch.zeros(4000),
                                    torch.Generator().manual_seed(0))
    assert float(noisy.min()) >= -0.5 and float(noisy.max()) < 0.5


def test_hyperprior_training_forward_matches_jax(tiny, shared_noise):
    """All four bpp estimates within rtol 1e-4; the STE-decoded latents,
    means and scales within atol 1e-4."""
    cfg, _, params, _, x, _ = tiny
    y = np.random.RandomState(3).randn(2, 4, 4, 8).astype(np.float32) * 4
    info_j = jax.jit(lambda a: JaxHiFiC(cfg).apply(
        {"params": params}, a, (64, 64),
        method=lambda m, a, s: m.hyperprior(a, s, rng=jax.random.PRNGKey(1),
                                            training=True)))(jnp.asarray(y))
    model = _port_model(cfg, params)
    with torch.no_grad():
        info_t = model.hyperprior(_t(y), (64, 64), None, training=True)
    for field in ("latent_nbpp", "hyperlatent_nbpp", "total_nbpp",
                  "latent_qbpp", "hyperlatent_qbpp", "total_qbpp"):
        np.testing.assert_allclose(float(getattr(info_t, field)),
                                   float(getattr(info_j, field)), rtol=1e-4,
                                   err_msg=field)
    for field in ("decoded", "latent_means", "latent_scales", "hyperlatents"):
        np.testing.assert_allclose(_n(getattr(info_t, field)),
                                   np.asarray(getattr(info_j, field)),
                                   atol=1e-4, rtol=1e-4, err_msg=field)


def test_hific_training_forward_matches_jax(tiny, shared_noise):
    """Reconstruction within atol 1e-4; bpp estimates within rtol 1e-4."""
    cfg, _, params, _, x, _ = tiny
    xf = x.astype(np.float32) / 255.0
    inter_j, _ = jax.jit(lambda a: JaxHiFiC(cfg).apply(
        {"params": params}, a, training=True,
        rngs={"quantize": jax.random.PRNGKey(1)}))(jnp.asarray(xf))
    with torch.no_grad():
        inter_t, _ = _port_model(cfg, params)(
            _t(xf).contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(_n(inter_t.reconstruction),
                               np.asarray(inter_j.reconstruction), atol=1e-4)
    np.testing.assert_allclose(_n(inter_t.latents_quantized),
                               np.asarray(inter_j.latents_quantized),
                               atol=1e-4)
    for field in ("n_bpp", "q_bpp"):
        np.testing.assert_allclose(float(getattr(inter_t, field)),
                                   float(getattr(inter_j, field)), rtol=1e-4)


def test_lpips_matches_jax(tiny):
    """Distances within rtol 1e-5, input gradients within 1e-4 of their
    largest magnitude; no gradient reaches LPIPS's own parameters."""
    lpips_params = tiny[3]
    rng = np.random.RandomState(4)
    a = rng.rand(2, 64, 64, 3).astype(np.float32)
    b = rng.rand(2, 64, 64, 3).astype(np.float32)
    apply_j = jax.jit(_jax_lpips_apply(lpips_params))
    want = np.asarray(apply_j(jnp.asarray(a), jnp.asarray(b)))
    grad_j = np.asarray(jax.jit(jax.grad(
        lambda u: jnp.sum(apply_j(u, jnp.asarray(b)))))(jnp.asarray(a)))
    lpips = _port_lpips(lpips_params)
    at = _t(a).clone().requires_grad_(True)
    got = lpips(at, _t(b), normalize=True)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy().reshape(-1),
                               want.reshape(-1), rtol=1e-5)
    np.testing.assert_allclose(_n(at.grad), grad_j,
                               atol=1e-4 * np.abs(grad_j).max())
    assert all(p.grad is None and not p.requires_grad
               for p in lpips.parameters())


@pytest.mark.parametrize("step", [0, 60_000])
@pytest.mark.parametrize("q_bpp", [0.05, 0.9])
def test_compression_loss_on_both_sides_of_the_target(tiny, step, q_bpp):
    """Loss and every diagnostic within rtol 1e-5, with q_bpp below and
    above the scheduled target, before and after the schedules' boundary
    (lambda_A and the target change at 50k steps)."""
    cfg = tiny[0]
    rng = np.random.RandomState(5)
    a = rng.rand(*BATCH).astype(np.float32)
    b = rng.rand(*BATCH).astype(np.float32)
    ij = JaxIntermediates(jnp.asarray(a), jnp.asarray(b), None,
                          jnp.float32(0.3), jnp.float32(q_bpp))
    it = Intermediates(_t(a), _t(b), None, torch.tensor(0.3),
                       torch.tensor(q_bpp))
    apply_j = _jax_lpips_apply(tiny[3])
    lpips = _port_lpips(tiny[3])
    loss_j, diag_j = jax_losses.compression_loss(cfg, ij, apply_j, step)
    loss_t, diag_t = losses.compression_loss(
        _port_config(cfg), it, lambda g, r: lpips(g, r, normalize=True), step)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert set(diag_t) == set(diag_j)
    for k in diag_j:
        np.testing.assert_allclose(float(diag_t[k]), float(diag_j[k]),
                                   rtol=1e-5, err_msg=k)
    lambda_a = cfg.lambda_A * (2.0 if step < 50_000 else 1.0)
    assert float(diag_t["rate_penalty"]) == pytest.approx(
        lambda_a if q_bpp > 0.2 else cfg.lambda_B * (
            2.0 if step < 50_000 else 1.0))


@pytest.mark.parametrize("step", [0, 1, 49_999, 50_000, 499_999, 500_000,
                                  700_000])
def test_schedules_match_jax(step):
    for sched in (Schedule(vals=(2.0, 1.0), steps=(50_000,)),
                  Schedule(vals=(1.0, 0.1), steps=(500_000,)),
                  Schedule(vals=(0.2 / 0.14, 1.0), steps=(50_000,)),
                  Schedule(vals=(3.0,), steps=())):
        want = float(jax_schedules.scheduled_param(0.14, sched, step))
        assert schedules.scheduled_param(0.14, sched, step) == want
        assert schedules.scheduled_param(0.14, sched, step, True) == 0.14


def _jax_grads(cfg, params, lpips_params, x_u8, step):
    apply_j = _jax_lpips_apply(lpips_params)
    model = JaxHiFiC(cfg)

    def loss_fn(p, x):
        inter, _ = model.apply({"params": p}, x, training=True,
                               rngs={"quantize": jax.random.PRNGKey(1)})
        loss, diag = jax_losses.compression_loss(cfg, inter, apply_j, step)
        return loss, diag

    x = jax_train_step.ingest_batch(jnp.asarray(x_u8), cfg)
    (loss, diag), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, x)
    return float(loss), diag, jax.tree_util.tree_map(np.asarray, grads)


def _port_state(cfg, params, lpips_params):
    model = _port_model(cfg, params)
    state = TrainState(0, model, make_optimizers(_port_config(cfg), model),
                       torch.Generator())
    lpips = _port_lpips(lpips_params)
    step_fn = make_train_step_g(_port_config(cfg),
                                lambda g, r: lpips(g, r, normalize=True))
    return state, step_fn


def test_train_step_gradients_match_jax(tiny, shared_noise):
    """One step: loss and diagnostics within rtol 1e-4 (measured 3e-7 and
    1.5e-6); every gradient leaf within GRAD_REL (1e-4) of that leaf's
    largest |gradient|. Holds the
    ChannelNorm backward, the bound rules, LPIPS and the rate loss against
    the JAX package."""
    cfg, _, params, lpips_params, x, _ = tiny
    loss_j, diag_j, grads_j = _jax_grads(cfg, params, lpips_params, x, 0)
    state, step_fn = _port_state(cfg, params, lpips_params)
    diag_t = step_fn(state, x)
    assert state.step == 1
    np.testing.assert_allclose(float(diag_t["weighted_compression_loss"]),
                               loss_j, rtol=LOSS_RTOL)
    for k in diag_j:
        np.testing.assert_allclose(float(diag_t[k]), float(diag_j[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    want = state_dict_from_jax(grads_j)
    got = {n: p.grad for n, p in state.model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        scale = np.abs(w).max()
        assert scale > 0, name
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * scale, (name, err, scale)


# optax.adam's defaults, which the JAX package's two groups use
# (`hific_tpu/training/train_step.py:make_optimizers`).
_OPTAX_ADAM = {k: v.default for k, v in
               inspect.signature(optax.adam).parameters.items()
               if k in ("b1", "b2", "eps")}


def _jax_adam_state(opt_state):
    """Both groups' optax Adam state -> (count, mu, nu), the moments as
    port state_dicts."""
    mu, nu, counts = {}, {}, set()
    for group in opt_state.inner_states.values():
        adam = group.inner_state[0]
        counts.add(int(adam.count))
        for tree, out in ((adam.mu, mu), (adam.nu, nu)):
            out.update({k: np.asarray(v) for k, v in flatten_tree(tree).items()
                        if hasattr(v, "shape")})  # not the other group's
    (count,) = counts
    return count, state_dict_from_jax(mu), state_dict_from_jax(nu)


def _port_state_from_jax(cfg, jstate, lpips_params):
    """The port's train state at JAX's: parameters, Adam's mu and nu as
    exp_avg and exp_avg_sq, and the step count."""
    count, mu, nu = _jax_adam_state(jstate.opt_state)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    state, step_fn = _port_state(cfg, params, lpips_params)
    assert count == int(jstate.step)
    for name, p in state.model.named_parameters():
        state.optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
    state.step = count
    return state, step_fn


def _jax_state_from_port(cfg, jstate, state):
    """`jstate` with the port's parameters, Adam moments and step count."""
    by_name = dict(state.model.named_parameters())

    def jax_flat(tensor_of):
        model = HiFiC(_port_config(cfg))
        model.load_state_dict({n: tensor_of(p) for n, p in by_name.items()})
        return jax_params_from_model(model)

    flat = {"params": jax_flat(lambda p: p.detach()),
            "mu": jax_flat(lambda p: state.optimizer.state[p]["exp_avg"]),
            "nu": jax_flat(lambda p: state.optimizer.state[p]["exp_avg_sq"])}

    def leaf(path, x, tree="params"):
        names = [str(getattr(k, "key", getattr(k, "name", getattr(k, "idx",
                                                                    None))))
                 for k in path]
        for field in ("mu", "nu"):
            if field in names:
                tree, names = field, names[names.index(field) + 1:]
        if tree == "params" and names[-1] == "count":
            return jnp.asarray(state.step, x.dtype)
        return jnp.asarray(flat[tree]["/".join(names)], x.dtype)

    return jstate.replace(
        step=jnp.asarray(state.step, jstate.step.dtype),
        params=jax.tree_util.tree_map_with_path(leaf, jstate.params),
        opt_state=jax.tree_util.tree_map_with_path(leaf, jstate.opt_state))


def _step_gradients(before, after):
    """The gradients JAX's step took, from its Adam state `before` and
    `after` it (count, mu, nu as port state_dicts): g = (mu' - b1 mu) /
    (1 - b1), float64, up to the float32 rounding of mu' (a few ulps of
    |mu| + |mu'|, which `_adam_limit` adds to its interval)."""
    b1 = _OPTAX_ADAM["b1"]
    return {n: (after[1][n].double() - b1 * before[1][n].double()) / (1 - b1)
            for n in before[1]}


def _adam_limit(mu, nu, mu_next, g, count, lr, w, grad_rel):
    """Per-element limit on |port - JAX| after one Adam step of both sides
    from the same state (mu, nu at `count`), JAX's taking the gradient g and
    leaving mu_next; float64 numpy throughout.

    - How far optax's update u(g) = lr * m_hat / (sqrt(v_hat) + eps) moves
      while the gradient moves by d: `grad_rel` of the leaf's largest |g|
      (the two sides' gradients differ by that much where each takes its
      own), plus the rounding of g's recovery (`_step_gradients`). du/dg is
      not constant over [g - d, g + d] where |g| is as small as d, so this
      is du/dg integrated over it: the largest |u(g') - u(g)| there. As a
      function of g' (eps aside) u is (A + a g') / sqrt(B + c g'^2), with
      a = 1 - b1, A = b1 mu, c = 1 - b2, B = b2 nu: monotone but for one
      turning point, g' = a B / (A c), so the interval's ends and that
      point, where it lies inside, give the range.
    - The bias corrections: optax computes 1 - b^t in float32 (at t = 1,
      1 - 0.999f is 1.3e-5 from 0.001), torch in double, which moves u by
      up to 6.4e-6 of itself.
    - The float32 arithmetic, counted (returned apart from the first two): each side rounds its moments (two
      operations each) and u (about six: the corrections, the square root,
      eps, the quotient, lr), each within half an ulp, so eight ulps of u
      for the two sides; and each rounds the sum p + u, so two ulps of the
      parameter."""
    b1, b2, eps = (_OPTAX_ADAM[k] for k in ("b1", "b2", "eps"))
    t = count + 1
    ulp = lambda x: np.spacing(np.abs(x).astype(np.float32))  # noqa: E731
    d = (grad_rel * np.abs(g).max()
         + 4 * ulp(np.abs(mu) + np.abs(mu_next)) / (1 - b1))

    def update(gp, float32_corrections=False):
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        if float32_corrections:
            c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(t))
                      for b in (b1, b2))
        m = (b1 * mu + (1 - b1) * gp) / c1
        v = (b2 * nu + (1 - b2) * gp * gp) / c2
        return lr * m / (np.sqrt(v) + eps)

    u = update(g)
    with np.errstate(divide="ignore", invalid="ignore"):
        turn = (1 - b1) * b2 * nu / (b1 * mu * (1 - b2))
    turn = np.where(np.abs(turn - g) <= d, turn, g)
    moved = np.maximum.reduce([np.abs(update(gp) - u)
                               for gp in (g - d, g + d, turn)])
    corrections = np.abs(update(g, float32_corrections=True) - u)
    return moved + corrections, 2 * ulp(w) + 8 * ulp(u)


def _assert_step_within(state, jax_before, jax_after, lr, grad_rel):
    """The port's parameters after its step from `jax_before`'s state
    against JAX's step from it, `jax_after`; returns the largest share of
    the rounding allowance that an error takes beyond the rest of its
    limit."""
    before = _jax_adam_state(jax_before.opt_state)
    after = _jax_adam_state(jax_after.opt_state)
    g = _step_gradients(before, after)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                      jax_after.params))
    worst = 0.0
    for name, p in state.model.named_parameters():
        w = want[name].numpy()
        spread, rounding = _adam_limit(
            before[1][name].double().numpy(), before[2][name].double().numpy(),
            after[1][name].double().numpy(), g[name].numpy(), before[0], lr,
            w, grad_rel)
        err = np.abs(p.detach().numpy().astype(np.float64) - w)
        assert np.all(err <= spread + rounding), (
            after[0], name, float((err - spread - rounding).max()))
        worst = max(worst, float(((err - spread) / rounding).max()))
    return worst


def _jax_relu_outputs(cfg, params, x_u8):
    """The outputs of JAX's ChannelNorm + ReLU layers in the training
    forward at `params`: {port module name: NCHW tensor}. The generator's
    last one runs inside `ops.d2s.generator_tail_d2s`, on the packed
    half-resolution grid; a wrapper takes its ReLU output with the ops
    that function runs and hands it out through a host callback, laid out
    as the port's `norm_up3` sees it in its own packed tail: the
    (N, 60, h, 4w) per-phase view of the packed (N, h, w, 240) tensor."""
    model = JaxHiFiC(cfg)
    out = {}
    tail = jax_d2s.generator_tail_d2s

    def tail_taking_relu(x, w_up, b_up, gamma, beta, *rest, eps=1e-3,
                         dtype=None, **kw):
        compute = dtype or x.dtype
        y = jax_d2s._conv_valid(
            jnp.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0))).astype(compute),
            jax_d2s.upconv_kernel_d2s(w_up).astype(compute))
        y = y + jax_d2s.upconv_bias_d2s(b_up).astype(y.dtype)
        n, hh, ww, _ = y.shape
        y = jax_d2s.channel_norm(y.reshape(n, hh, ww, 4, -1),
                                 gamma.astype(y.dtype), beta.astype(y.dtype),
                                 eps=eps)
        y = jax.nn.relu(y).reshape(n, hh, 4 * ww, -1)
        jax.debug.callback(
            lambda v: out.__setitem__("generator.norm_up3",
                                      _t(np.asarray(v))), y)
        return tail(x, w_up, b_up, gamma, beta, *rest, eps=eps, dtype=dtype,
                    **kw)

    @jax.jit
    def forward(p, x):
        return model.apply(
            {"params": p}, x, training=True,
            rngs={"quantize": jax.random.PRNGKey(1)}, mutable=["intermediates"],
            capture_intermediates=lambda m, method: (
                isinstance(m, JaxNorm) and m.activation == "relu"
                and method == "__call__"))[1]["intermediates"]

    def walk(tree, path):
        for key, value in tree.items():
            if key == "__call__":
                (y,) = value  # each layer runs once in the forward
                out[".".join(path)] = _t(np.asarray(y))
            else:
                walk(value, path + [key])

    jax_d2s.generator_tail_d2s = tail_taking_relu
    try:
        captured = forward(
            params, jax_train_step.ingest_batch(jnp.asarray(x_u8), cfg))
        jax.effects_barrier()
    finally:
        jax_d2s.generator_tail_d2s = tail
    walk(captured, [])
    return out


def _step_with_gradients(state, step_fn, x, grads, jax_relu):
    """One port step whose backward delivers `grads` (float64, by
    parameter name) to Adam in place of the port's own gradients. Returns
    the port's own gradients, and the port's sides (`KinkSides`): where the
    port's and JAX's ReLU outputs `jax_relu` take different sides of the
    kink, the port takes JAX's side; `apart` lists each such layer."""
    own, handles = {}, []
    theirs = KinkSides()
    for name, y in jax_relu.items():
        theirs.pre[name], theirs.side[name] = y, y > 0

    def deliver(g, name):
        own[name] = g.detach().double().clone()
        return grads[name].to(g.dtype)

    for name, p in state.model.named_parameters():
        handles.append(p.register_hook(lambda g, n=name: deliver(g, n)))
    try:
        with KinkSides().hooked(state.model, theirs) as sides:
            step_fn(state, x)
    finally:
        for h in handles:
            h.remove()
    return own, sides


def _assert_own_gradients(own, sides, jax_before, jax_after):
    """The port's own gradients against those of JAX's step (recovered from
    its mu): each leaf within GRAD_REL of its largest |g|, plus the rounding
    of the recovery, with the ReLU elements the two stacks decided apart
    taking JAX's side; each of those lies within KINK_REL of the kink on
    both sides. Returns the largest error as a share of GRAD_REL."""
    sides.check(KINK_REL)
    before = _jax_adam_state(jax_before.opt_state)
    after = _jax_adam_state(jax_after.opt_state)
    want = _step_gradients(before, after)
    ulp = lambda t: np.spacing(np.abs(t).astype(np.float32))  # noqa: E731
    worst = 0.0
    for name, w in want.items():
        w = w.numpy()
        scale = np.abs(w).max()
        rounding = 4 * ulp(np.abs(before[1][name].numpy())
                           + np.abs(after[1][name].numpy())) / (
            1 - _OPTAX_ADAM["b1"])
        err = np.abs(own[name].numpy() - w)
        assert np.all(err <= GRAD_REL * scale + rounding), (
            after[0], name, float(err.max()), scale)
        worst = max(worst, float(err.max() / (GRAD_REL * scale)))
    return worst


def test_two_train_steps_match_jax(tiny, shared_noise):
    """Two steps of JAX's jitted train_step_g and the port's. Step 1 holds
    the port's own step; step 2 holds that Adam's state carries over from
    step 1, and the port's own gradients once the parameters have moved.

    Each parameter is held to `_adam_limit`, derived from optax's update:
    - step 1, from the shared initial state: each side with its own
      gradients, within GRAD_REL of the leaf's largest |g| (what
      `test_train_step_gradients_match_jax` holds at this point);
    - step 2 from JAX's step-1 state (parameters, mu and nu as exp_avg and
      exp_avg_sq, count), and the port's chained step 2 against JAX's step 2
      from the port's step-1 state carried into JAX: both sides step from
      one state with the gradients JAX's step took (recovered from its mu),
      so only the two optimizers' arithmetic parts them.
    The port's own step-2 gradients, from both states, are held to
    GRAD_REL of each leaf's largest |g| against those JAX's step took,
    with the ReLU elements where the two stacks take different sides of
    the kink given JAX's side in the port's step (`KinkSides`), each
    found from the two stacks' activations and each within KINK_REL of the
    kink on both sides. Nothing in the limits is fitted to a host.

    Why: at step 1 Adam moves every parameter by about lr, so the norms'
    beta become +-lr, and a pre-activation x_hat * gamma + beta can then
    sit within float32 noise of a ReLU's kink, where either side is right.
    On an 8-core AVX-512 host one element of generator.norm_up0 does
    (|pre-activation| 5.9e-7, its limit 4.4e-4): left in, the step-2
    gradients of that norm's beta and of upconv0 differ by 0.65% and 1.2%
    of their leaves' largest |g|, and those of the encoder and the
    generator's earlier layers by 0.04-0.14%, against GRAD_REL = 0.01%.
    The limit this replaces (5e-6 where both steps' |g| exceeded 1% and
    agreed in sign) failed there by 1.7e-6 at generator.upconv2.weight.
    Measured on that host: beyond the rest of its limit, an error takes at
    most 0.51 of the rounding allowance (step 1 0.504; step 2 carried
    0.498, chained 0.499); the step-2 gradients reach 0.32 (carried, one
    element left out) and 0.35 (chained, none) of GRAD_REL."""
    cfg, jstate, params, lpips_params, x, _ = tiny
    step_j = jax.jit(jax_train_step.make_train_step_g(
        cfg, _jax_lpips_apply(lpips_params)))

    def lr(step):
        return float(jax_schedules.scheduled_param(cfg.learning_rate,
                                                   cfg.lr_schedule, step))

    s1, _ = step_j(jstate, jnp.asarray(x))
    s2, _ = step_j(s1, jnp.asarray(x))
    assert int(s2.step) == 2

    # Step 1, the start of the port's chained run.
    chained, step_fn = _port_state(cfg, params, lpips_params)
    step_fn(chained, x)
    assert chained.step == 1
    worst = [_assert_step_within(chained, jstate, s1, lr(0), GRAD_REL)]

    # Step 2 from JAX's step-1 state, and the chained step 2 against JAX's
    # step 2 from the port's step-1 state: Adam with JAX's gradients, and
    # the port's own gradients.
    s1_port = _jax_state_from_port(cfg, s1, chained)
    s2_port, _ = step_j(s1_port, jnp.asarray(x))
    carried, step_fn = _port_state_from_jax(cfg, s1, lpips_params)
    grad_shares, left_out = [], []
    for state, before, after in ((carried, s1, s2),
                                 (chained, s1_port, s2_port)):
        own, sides = _step_with_gradients(
            state, step_fn, x,
            _step_gradients(_jax_adam_state(before.opt_state),
                            _jax_adam_state(after.opt_state)),
            _jax_relu_outputs(cfg, before.params, x))
        assert state.step == 2
        worst.append(_assert_step_within(state, before, after, lr(1), 0.0))
        grad_shares.append(_assert_own_gradients(own, sides, before, after))
        left_out.append(sides.apart)
    print("largest share of the rounding allowance, per check:", worst)
    print("step-2 gradients, largest error as a share of GRAD_REL "
          "(carried, chained):", grad_shares)
    print("ReLU elements given JAX's side (layer: count, nearest the kink, "
          "the layer's largest |pre-activation|):", left_out)


def test_eval_step_uses_rounded_hyperlatents(tiny, shared_noise):
    """Validation forward matches JAX's `make_eval_step` within rtol 1e-4
    and leaves the parameters unchanged."""
    cfg, jstate, params, lpips_params, x, _ = tiny
    diag_j, _ = jax.jit(jax_train_step.make_eval_step(
        cfg, _jax_lpips_apply(lpips_params)))(jstate, jnp.asarray(x),
                                              jax.random.PRNGKey(2))
    state, _ = _port_state(cfg, params, lpips_params)
    before = [p.detach().clone() for p in state.model.parameters()]
    lpips = _port_lpips(lpips_params)
    diag_t, _ = make_eval_step(_port_config(cfg),
                               lambda g, r: lpips(g, r, normalize=True))(
        state, x, torch.Generator())
    for k in diag_j:
        np.testing.assert_allclose(float(diag_t[k]), float(diag_j[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert all(torch.equal(a, p) for a, p in
               zip(before, state.model.parameters()))


def test_export_params_npz_round_trips_into_jax(tiny, tmp_path):
    """JAX params -> the port -> export_params_npz -> the JAX package's
    load_params_npz: the same tree, every leaf bit-equal."""
    cfg, _, params, _, _, _ = tiny
    model = _port_model(cfg, params)
    path = checkpoints.export_params_npz(str(tmp_path / "p.npz"), model,
                                         _port_config(cfg))
    config_j, params_j = jax_checkpoints.load_params_npz(path)
    assert config_j.to_json() == cfg.to_json()
    want, got = flatten_tree(params), flatten_tree(params_j)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k],
                                                         np.float32))


def test_checkpoint_restores_the_train_state(tiny, tmp_path):
    cfg = _port_config(tiny[0])
    state = create_train_state(cfg, seed=3, device="cpu")
    make_train_step_g(cfg)(state, tiny[4])
    path = checkpoints.save_checkpoint(str(tmp_path), state, cfg)
    assert checkpoints.latest_checkpoint(str(tmp_path)) == path
    assert checkpoints.load_config(str(tmp_path)) == cfg
    back = checkpoints.restore_train_state(path, cfg, device="cpu")
    assert back.step == 1
    for a, b in zip(state.model.state_dict().values(),
                    back.model.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(back.generator.get_state(), state.generator.get_state())
    assert (back.optimizer.state_dict()["state"].keys()
            == state.optimizer.state_dict()["state"].keys())


def _write_pngs(directory, n=3):
    from PIL import Image

    rng = np.random.RandomState(6)
    os.makedirs(directory, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (72 + 8 * i, 90, 3),
                                    dtype=np.uint8)).save(
            os.path.join(directory, f"im{i}.png"))


def test_train_cli_two_steps_on_the_cpu(tmp_path):
    """The CLI over a directory of PNGs: 2 steps, a checkpoint, then a
    resume to step 3."""
    data = tmp_path / "data"
    _write_pngs(str(data))
    flags = ["-d", str(data), "-bs", "2", "-crop", "64",
             "--latent_channels", "8", "--n_residual_blocks", "1",
             "--hyperlatent_filters", "16", "--log_interval", "2",
             "--uncalibrated_lpips_ok", "--device", "cpu",
             "--experiments_dir", str(tmp_path / "exp")]
    assert train_cli.main(flags + ["--steps", "2"]) == 0
    ckpt_dir = tmp_path / "exp" / "hific_tpu_torch_v0.1_compression_low" \
        / "checkpoints"
    path = checkpoints.latest_checkpoint(str(ckpt_dir))
    assert path.endswith("step_2.pt")
    state = train_cli.run(train_cli.parse_args(
        flags + ["--steps", "3", "--resume_ckpt", path]))
    assert state.step == 3
    with open(ckpt_dir.parent / "tensorboard" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows and all(np.isfinite(r["train/weighted_compression_loss"])
                        for r in rows)
    with pytest.raises(SystemExit, match="uncalibrated"):
        train_cli.main([f for f in flags if f != "--uncalibrated_lpips_ok"]
                       + ["--steps", "5"])


def test_dataset_needs_pillow(tmp_path, monkeypatch):
    """uint8 crops of the asked size; without Pillow it raises instead of
    skipping every file."""
    _write_pngs(str(tmp_path))
    x, bpp = next(TrainDataset(str(tmp_path), crop_size=64).batches(3))
    assert x.shape == (3, 64, 64, 3) and x.dtype == np.uint8
    assert bpp.shape == (3,) and np.all(bpp > 0)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ImportError):
        next(TrainDataset(str(tmp_path), crop_size=64).batches(1))


def test_numerics_are_scoped():
    """fp32_numerics sets TF32 off and cuDNN's determinism for its block
    only; the previous settings come back."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    try:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = \
            True, False, True
        with runtime.fp32_numerics(deterministic=True):
            assert not cudnn.allow_tf32 and not matmul.allow_tf32
            assert cudnn.deterministic and not cudnn.benchmark
        assert cudnn.allow_tf32 and not cudnn.deterministic
        assert cudnn.benchmark
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved
