"""The model variants of the JAX package's `HiFiC` in the port, against it.

Tiny config (latent 8, 1 residual block, hyperlatent 16, crop 64, batch
2), fp32 on the CPU, each variant's JAX-initialised parameters carried
across with `weights.state_dict_from_jax`: instance norm
(`use_channel_norm=False`), the DLMM hyperprior
(`use_latent_mixture_model`), the generator's noise (`sample_noise`, the
same numpy noise handed to both sides) and the logistic likelihood (its
tables and `.hfc` bytes). Both sides get the same quantization noise, as in
`tests/test_torch_train.py`. Tolerances are stated at each test; they are
test_torch_train.py's: losses within rtol 1e-4, gradients within 1e-4 of
each leaf's largest |gradient|, bytes identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hific_tpu.models.hyperprior as jax_hyperprior_module
import hific_tpu_torch.models.generator as generator_module
import hific_tpu_torch.models.hyperprior as hyperprior_module
from hific_tpu.codec import Codec as JaxCodec
from hific_tpu.config import mse_lpips_config as jax_mse_lpips_config
from hific_tpu.models.density import dlmm_log_likelihood as jax_dlmm_ll
from hific_tpu.models.hific import HiFiC as JaxHiFiC
from hific_tpu.ops.channel_norm import instance_norm as jax_instance_norm
from hific_tpu.ops import quantize as jax_quantize
from hific_tpu.training import losses as jax_losses
from hific_tpu.training import train_step as jax_train_step
from hific_tpu_torch.codec import Codec
from hific_tpu_torch.config import Config
from hific_tpu_torch.models.density import dlmm_log_likelihood
from hific_tpu_torch.models.hific import HiFiC
from hific_tpu_torch.ops import quantize
from hific_tpu_torch.ops.channel_norm import instance_norm
from hific_tpu_torch.training import losses
from hific_tpu_torch.training.train_step import (
    TrainState,
    make_optimizers,
    make_train_step_g,
)
from hific_tpu_torch.weights import flatten_tree, state_dict_from_jax
from hific_tpu_torch.kinks import KinkSides

# The JAX side computes the generator's plain tail (no depth-to-space
# rewrite, a TPU layout choice the port does not make), so that every ReLU
# of both stacks is a module whose side `_jax_sides` can read.
TINY = dict(latent_channels=8, n_residual_blocks=1, hyperlatent_filters=16,
            crop_size=64, batch_size=2, d2s_generator_tail=False)
VARIANTS = {
    "instance_norm": dict(use_channel_norm=False),
    "dlmm": dict(use_latent_mixture_model=True, latent_channels_dlmm=8),
    "sample_noise": dict(sample_noise=True, noise_dim=4),
    "logistic": dict(likelihood_type="logistic"),
}
BATCH = (2, 64, 64, 3)
GRAD_REL = 1e-4   # each gradient leaf, of its largest |gradient|
LOSS_RTOL = 1e-4  # loss and every diagnostic
# The port takes JAX's side of each ReLU and rounding tie (`_jax_sides`);
# where the two stacks' sides differ, the element must lie within this
# share of its layer's largest |input| of the kink (tests/test_torch_train.py's
# KINK_REL), or of its magnitude of the half-integer.
KINK_REL = 1e-4


def _t(a) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _n(t) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def variants():
    """name -> (JAX config, JAX-initialised params as numpy), built once
    each (jitted: the tiny model's init is slow outside jit)."""
    built = {}

    def init(cfg):
        variables = jax.jit(lambda key: JaxHiFiC(cfg).init(
            {"params": key, "quantize": key, "noise": key},
            jnp.zeros((1, 64, 64, 3)), training=True))(jax.random.PRNGKey(0))
        return jax.tree_util.tree_map(np.asarray, variables["params"])

    def get(name):
        if name not in built:
            cfg = jax_mse_lpips_config(**TINY, **VARIANTS[name])
            # Instance norm and the logistic likelihood have the base
            # model's parameter tree: one init (and compile) serves both.
            same_tree = name in ("instance_norm", "logistic")
            key = "base" if same_tree else name
            if key not in built:
                built[key] = init(jax_mse_lpips_config(**TINY) if same_tree
                                  else cfg)
            built[name] = cfg, built[key]
        return built[name]

    return get


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, BATCH).astype(np.uint8)
    noise = {shape: rng.uniform(-0.5, 0.5, shape).astype(np.float32)
             for shape in ((2, 1, 1, 16), (2, 4, 4, 8))}
    gen_noise = rng.randn(2, 4, 4, 4).astype(np.float32)  # noise_dim 4
    return x, noise, gen_noise


@pytest.fixture
def shared_noise(inputs, monkeypatch):
    """Both packages' quantization noise is the same numpy array, and both
    generators' normal draw is `gen_noise`."""
    _, noise, gen_noise = inputs
    jax_noise = jax_hyperprior_module.quantize_noise
    jax_normal = jax.random.normal

    def jax_quantize_noise(x, rng):  # a JAX init's batch-1 shapes draw
        if tuple(x.shape) not in noise:
            return jax_noise(x, rng)
        return x + jnp.asarray(noise[tuple(x.shape)])

    def jax_generator_normal(key, shape, dtype=jnp.float32):
        if tuple(shape) != gen_noise.shape:
            return jax_normal(key, shape, dtype)
        return jnp.asarray(gen_noise, dtype)

    monkeypatch.setattr(jax_hyperprior_module, "quantize_noise",
                        jax_quantize_noise)
    monkeypatch.setattr(
        hyperprior_module, "quantize_noise",
        lambda x, generator: x + _t(noise[(x.shape[0], x.shape[2],
                                           x.shape[3], x.shape[1])]))
    monkeypatch.setattr(jax.random, "normal", jax_generator_normal)
    monkeypatch.setattr(generator_module, "generator_noise",
                        lambda shape, generator, dtype, device:
                        torch.from_numpy(gen_noise).to(device, dtype))


def _port_config(cfg) -> Config:
    return Config.from_json(cfg.to_json())


def _port_model(cfg, params) -> HiFiC:
    model = HiFiC(_port_config(cfg))
    model.load_state_dict(state_dict_from_jax(params))
    return model.to(memory_format=torch.channels_last)


def _jax_step(cfg, params, x_u8):
    """JAX's compression loss (no LPIPS), diagnostics, intermediates and
    gradients at `params` on the batch."""
    model = JaxHiFiC(cfg)

    def loss_fn(p, x):
        (inter, info), captured = model.apply(
            {"params": p}, x, training=True,
            rngs={"quantize": jax.random.PRNGKey(1),
                  "noise": jax.random.PRNGKey(2)},
            capture_intermediates=True, mutable=["intermediates"])
        loss, diag = jax_losses.compression_loss(cfg, inter, None, 0)
        return loss, (diag, inter, info, captured["intermediates"])

    x = jax_train_step.ingest_batch(jnp.asarray(x_u8), cfg)
    (loss, (diag, inter, info, captured)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, x)
    return (float(loss), {k: float(v) for k, v in diag.items()}, inter, info,
            state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads)),
            _jax_sides(captured, info))


def _jax_sides(captured, info) -> KinkSides:
    """JAX's side of each ReLU kink (the norms with a fused ReLU: their
    output; the hyper transforms' ReLUs: conv1 and conv2's output) and the
    input of the straight-through rounding of the latents (y - mu), for
    the port's modules: a ReLU input or latent within rounding of the kink
    or the half-integer may fall on either side in the two stacks, and in
    the tiny model one such element moves the gradients of the layers
    before it by ~1e-3 of their largest, ten times GRAD_REL."""
    sides = KinkSides()
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, captured))
    for path, outs in flat.items():
        parts = path.split("/")
        if parts[-1] != "__call__" or len(parts) < 3:
            continue
        module = parts[:-1]
        if (module[-1] in ("norm_stem", "norm1")
                or module[-1].startswith(("norm_down", "norm_up"))):
            name = ".".join(module)
        elif module[-1] in ("conv1", "conv2") and module[0] == "hyperprior":
            name = ".".join(module[:-1] + ["act" + module[-1][-1]])
        else:
            continue
        sides.pre[name] = _t(np.asarray(outs[0]))
        sides.side[name] = sides.pre[name] > 0
    y = np.asarray(flat["encoder/__call__"][0])
    sides.rounding.append(_t(y - np.asarray(info.latent_means)))
    return sides


def _assert_gradients(model, want, zero=()):
    """Every gradient leaf within GRAD_REL of its leaf's largest |gradient|
    of JAX's. `zero`: (bias, weight) leaves where the bias feeds an
    instance norm, so its exact gradient is 0 and both stacks' are rounding
    noise: held against the weight's largest |gradient|."""
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    zero = dict(zero)
    for name, g in got.items():
        w = want[name].numpy()
        scale = np.abs(want[zero.get(name, name)].numpy()).max()
        assert scale > 0, name
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * scale, (name, err, scale)


def _instance_norm_zero_gradients():
    """(bias, weight) pairs of the instance-norm variant whose bias feeds
    an instance norm directly (and norm_in's beta, which conv_head carries
    to norm_head as a per-channel constant): zero in exact arithmetic."""
    convs = (["encoder.conv_stem"] + [f"encoder.conv_down{i}"
                                      for i in range(4)]
             + ["generator.conv_head", "generator.resblock_0.conv1",
                "generator.resblock_0.conv2"]
             + [f"generator.upconv{i}" for i in range(4)])
    return ([(f"{c}.bias", f"{c}.weight") for c in convs]
            + [("generator.norm_in.beta", "generator.norm_in.gamma")])


def _assert_diagnostics(loss, diag, loss_j, diag_j):
    np.testing.assert_allclose(loss, loss_j, rtol=LOSS_RTOL)
    assert set(diag) >= set(diag_j)
    for k, v in diag_j.items():
        np.testing.assert_allclose(float(diag[k]), v, rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)


def test_instance_norm_matches_jax():
    """The plain instance norm (biased variance, eps 1e-5, over H and W per
    (N, C)) against the JAX package's, within 1e-6."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 5, 7, 6) * 3 + 1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    beta = rng.randn(6).astype(np.float32)
    want = np.asarray(jax_instance_norm(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)))
    got = instance_norm(_t(x), torch.from_numpy(gamma),
                        torch.from_numpy(beta))
    np.testing.assert_allclose(_n(got), want, atol=1e-6, rtol=0)


def test_dlmm_log_likelihood_and_entropy_match_jax():
    """The mixture log-likelihood of latents under random mixture
    parameters (log-scales reaching below the bound), within 1e-5 of its
    largest magnitude; the entropy from log-likelihoods within rtol 1e-6."""
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 3, 5, 4) * 3).astype(np.float32)
    params = (rng.randn(2, 3, 5, 4 * 4 * 3) * 2).astype(np.float32)
    for likelihood_type in ("gaussian", "logistic"):
        want = np.asarray(jax_dlmm_ll(jnp.asarray(x), jnp.asarray(params),
                                      likelihood_type))
        got = _n(dlmm_log_likelihood(_t(x), _t(params), likelihood_type))
        np.testing.assert_allclose(got, want,
                                   atol=1e-5 * np.abs(want).max(), rtol=0)
    bits_j, bpp_j = jax_quantize.estimate_entropy_log(jnp.asarray(want),
                                                      (64, 64))
    bits_t, bpp_t = quantize.estimate_entropy_log(torch.from_numpy(want.copy()),
                                                  (64, 64))
    np.testing.assert_allclose(float(bits_t), float(bits_j), rtol=1e-6)
    np.testing.assert_allclose(float(bpp_t), float(bpp_j), rtol=1e-6)


@pytest.mark.parametrize("name", ["instance_norm", "dlmm"])
def test_variant_forward_and_training_step_match_jax(variants, inputs,
                                                     shared_noise, name):
    """The training forward (reconstruction within 1e-4; every bpp term
    within rtol 1e-4) and one step of the port's trainer (no LPIPS): loss
    and diagnostics within rtol 1e-4, every gradient leaf within 1e-4 of
    its largest |gradient| (see `_assert_gradients` for the biases instance
    norm zeroes), the port taking JAX's side of each tie (`_jax_sides`)."""
    cfg, params = variants(name)
    x = inputs[0]
    loss_j, diag_j, inter_j, info_j, grads_j, sides = _jax_step(cfg, params,
                                                                x)
    model = _port_model(cfg, params)
    with torch.no_grad(), KinkSides().hooked(model, sides):
        xf = _t(x.astype(np.float32) / 255.0).contiguous(
            memory_format=torch.channels_last)
        inter_t, info_t = model(xf, None, training=True)
    np.testing.assert_allclose(_n(inter_t.reconstruction),
                               np.asarray(inter_j.reconstruction), atol=1e-4)
    for field in ("latent_nbpp", "hyperlatent_nbpp", "latent_qbpp",
                  "hyperlatent_qbpp"):
        np.testing.assert_allclose(float(getattr(info_t, field)),
                                   float(getattr(info_j, field)), rtol=1e-4,
                                   err_msg=field)
    state = TrainState(0, model, make_optimizers(_port_config(cfg), model),
                       torch.Generator())
    with KinkSides().hooked(model, sides) as port:
        diag = make_train_step_g(_port_config(cfg))(state, x)
    port.check(KINK_REL)
    _assert_diagnostics(float(diag["weighted_compression_loss"]), diag,
                        loss_j, diag_j)
    _assert_gradients(model, grads_j, _instance_norm_zero_gradients()
                      if name == "instance_norm" else ())


def test_sample_noise_generator_matches_jax(variants, inputs, shared_noise):
    """The generator's noise (4 channels after norm_head, widening the
    residual trunk to 964), the same on both sides: reconstruction within
    1e-4, loss within rtol 1e-4, every gradient leaf within 1e-4 of its
    largest."""
    cfg, params = variants("sample_noise")
    x = inputs[0]
    loss_j, diag_j, inter_j, _, grads_j, sides = _jax_step(cfg, params, x)
    model = _port_model(cfg, params)
    assert model.generator.resblock_0.conv1.weight.shape[:2] == (964, 964)
    xf = _t(x.astype(np.float32) / 255.0).contiguous(
        memory_format=torch.channels_last)
    with KinkSides().hooked(model, sides) as port:
        inter_t, _ = model(xf, None, training=True)
    port.check(KINK_REL)
    np.testing.assert_allclose(_n(inter_t.reconstruction),
                               np.asarray(inter_j.reconstruction), atol=1e-4)
    loss, diag = losses.compression_loss(_port_config(cfg), inter_t, None, 0)
    loss.backward()
    _assert_diagnostics(float(loss.detach()), diag, loss_j, diag_j)
    _assert_gradients(model, grads_j)


def test_sample_noise_draws_from_the_generator_it_is_given(variants):
    """The same seed gives the same noise, and so the same reconstruction;
    another seed another one."""
    cfg, params = variants("sample_noise")
    model = _port_model(cfg, params)
    x = _t(np.random.RandomState(6).rand(1, 64, 64, 3).astype(np.float32)
           ).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        a, b, c = (model(x, torch.Generator().manual_seed(seed))[0]
                   .reconstruction for seed in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_logistic_tables_and_hfc_bytes_equal_jax(variants, tmp_path):
    """The logistic likelihood's scale tables and the hyperlatent tables
    byte-identical to the JAX codec's; the `.hfc` files of one image
    byte-identical; each side decodes the other's file to within 1e-3."""
    cfg, params = variants("logistic")
    jax_codec = JaxCodec(cfg, params)
    port = Codec(_port_config(cfg), state_dict_from_jax(params),
                 device="cpu")
    port.build_tables()
    jax_codec.build_tables()
    for model in ("conditional", "factorized"):
        want, got = (getattr(c, model).tables for c in (jax_codec, port))
        for field in ("cdf", "cdf_length", "cdf_offset"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field),
                                          err_msg=f"{model}.{field}")
    x = np.random.RandomState(3).rand(1, 64, 80, 3).astype(np.float32)
    p_jax, p_port = tmp_path / "jax.hfc", tmp_path / "port.hfc"
    jax_codec.compress_file(x, str(p_jax))
    port.compress_file(x, str(p_port))
    assert p_port.read_bytes() == p_jax.read_bytes()
    r_port = port.decompress_file(str(p_jax))
    r_jax = np.asarray(jax_codec.decompress_file(str(p_port)))
    np.testing.assert_allclose(r_port, r_jax, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name", ["dlmm", "sample_noise"])
def test_codec_refuses_what_jax_cannot_compress(name):
    """The DLMM prior is a training-only estimate and the JAX codec draws
    no generator noise: the port's Codec refuses both configs."""
    cfg = Config(**TINY, **VARIANTS[name])
    with pytest.raises(ValueError, match="no compress path"):
        Codec(cfg, HiFiC(cfg).state_dict(), device="cpu")
