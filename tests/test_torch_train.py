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

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hific_tpu.models.hyperprior as jax_hyperprior_module
import hific_tpu_torch.models.hyperprior as hyperprior_module
from hific_tpu.config import mse_lpips_config as jax_mse_lpips_config
from hific_tpu.models.hific import HiFiC as JaxHiFiC
from hific_tpu.models.hific import Intermediates as JaxIntermediates
from hific_tpu.models.lpips import LPIPS as JaxLPIPS
from hific_tpu.models.lpips import default_lpips_params
from hific_tpu.ops import maths as jax_maths
from hific_tpu.ops import quantize as jax_quantize
from hific_tpu.training import checkpoints as jax_checkpoints
from hific_tpu.training import losses as jax_losses
from hific_tpu.training import schedules as jax_schedules
from hific_tpu.training import train_step as jax_train_step
from hific_tpu_torch import runtime
from hific_tpu_torch.cli import train as train_cli
from hific_tpu_torch.config import Config, Schedule
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


def test_two_train_steps_match_jax(tiny, shared_noise):
    """Two steps of JAX's jitted train_step_g and the port's. Adam moves
    every parameter by about lr * sign(g) on its first step, so where |g| is
    near the gradients' noise the two sides move apart by up to 2 lr, and
    the second step's gradients then differ by a few percent. So: after
    step 1 the parameters agree within two float32 ulps where |g1| exceeds
    1% of the
    leaf's largest; after step 2 within 5e-6 (5% of lr = 1e-4; measured
    2.1e-6) where both steps' |g| exceed 1% of the leaf's largest and agree
    in sign (where they disagree, Adam's second move is a difference of
    nearly equal terms)."""
    cfg, jstate, params, lpips_params, x, _ = tiny
    step_j = jax.jit(jax_train_step.make_train_step_g(
        cfg, _jax_lpips_apply(lpips_params)))
    _, _, g1 = _jax_grads(cfg, params, lpips_params, x, 0)
    s1, _ = step_j(jstate, jnp.asarray(x))
    p1 = jax.tree_util.tree_map(np.asarray, s1.params)
    _, _, g2 = _jax_grads(cfg, p1, lpips_params, x, 1)
    s2, _ = step_j(s1, jnp.asarray(x))
    assert int(s2.step) == 2
    g1, g2 = state_dict_from_jax(g1), state_dict_from_jax(g2)

    def big(g):
        return np.abs(g) > 1e-2 * np.abs(g).max()

    state, step_fn = _port_state(cfg, params, lpips_params)
    for step, want in enumerate(
            (p1, jax.tree_util.tree_map(np.asarray, s2.params)), 1):
        step_fn(state, x)
        assert state.step == step
        want = state_dict_from_jax(want)
        compared = 0
        for name, p in state.model.named_parameters():
            a, b = g1[name].numpy(), g2[name].numpy()
            mask = big(a) if step == 1 else (
                big(a) & big(b) & (np.sign(a) == np.sign(b)))
            w = want[name].numpy()
            tol = (2 * np.spacing(np.abs(w)) + 1e-9 if step == 1
                   else 5e-6)
            excess = (np.abs(p.detach().numpy() - w) - tol)[mask]
            assert excess.max(initial=0.0) <= 0, (step, name, excess.max())
            compared += int(mask.sum())
        assert compared > 0.1 * sum(p.numel()
                                    for p in state.model.parameters())


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
    with open(ckpt_dir.parent / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert rows and all(np.isfinite(r["weighted_compression_loss"])
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
