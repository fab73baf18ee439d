"""`dtype="bfloat16"` in the port against the JAX package, on the CPU.

Tiny config (latent 8, 1 residual block, hyperlatent 16, crop 64, batch
2). The JAX package's bfloat16 train state is carried across with
`weights.state_dict_from_jax(keep_bf16=True)`, and both sides get the same
quantization noise, in the noised tensor's dtype. A bfloat16-to-bfloat16
difference has no natural scale, so each tensor of the port's bfloat16 run
is judged against the JAX package's float32 run at the same parameter
values: |port_bf16 - fp32| <= 2 |jax_bf16 - fp32| + one bfloat16 ulp of
the tensor's largest |fp32 value| (2**-7 of it rounded down to a power of
two), per tensor, per gradient leaf, per loss term. The floor is the
rounding of a bfloat16 result itself, which either stack may land near or
far from by chance: measured, the port's quantized rate is 0.95 of its
limit (2.2e-3 from fp32, JAX's 1.8e-4, the floor 2.0e-3), the gradient of
generator.norm_in.gamma 0.87, the perceptual term 0.67, every other tensor,
leaf and term at most 0.6 of it. Parameter and Adam-moment dtypes equal JAX's leaf by
leaf. The port's bfloat16 codec decodes its own files losslessly; the
count of coding indices where its bfloat16 `synth_stats` differs from the
JAX package's is reported (printed), not gated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hific_tpu.models.hyperprior as jax_hyperprior_module
import hific_tpu_torch.models.hyperprior as hyperprior_module
from hific_tpu.config import mse_lpips_config as jax_mse_lpips_config
from hific_tpu.models.hific import HiFiC as JaxHiFiC
from hific_tpu.models.layers import Norm as JaxNorm
from hific_tpu.models.lpips import LPIPS as JaxLPIPS
from hific_tpu.models.lpips import default_lpips_params
from hific_tpu.training import losses as jax_losses
from hific_tpu.training import train_step as jax_train_step
from hific_tpu_torch.codec import Codec
from hific_tpu_torch.config import Config
from hific_tpu_torch.models.hific import HiFiC
from hific_tpu_torch.models.layers import Norm
from hific_tpu_torch.models.lpips import LPIPS
from hific_tpu_torch.training import losses
from hific_tpu_torch.training.train_step import (
    TrainState,
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
BF16_EPS = 2.0 ** -7  # a bfloat16 ulp relative to its binade's base


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _n(t) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture(scope="module")
def setup():
    cfg = jax_mse_lpips_config(**TINY, dtype="bfloat16")
    jstate = jax.jit(lambda key: jax_train_step.create_train_state(
        cfg, key))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, BATCH).astype(np.uint8)
    noise = {shape: rng.uniform(-0.5, 0.5, shape).astype(np.float32)
             for shape in ((2, 1, 1, 16), (2, 4, 4, 8))}
    lpips_params = default_lpips_params("alex", backbone_seed=0)
    return cfg, jstate, x, noise, lpips_params


@pytest.fixture
def shared_noise(setup, monkeypatch):
    noise = setup[3]
    jax_noise = jax_hyperprior_module.quantize_noise

    def jax_quantize_noise(x, rng):  # a JAX init's batch-1 shapes draw
        if tuple(x.shape) not in noise:
            return jax_noise(x, rng)
        return x + jnp.asarray(noise[tuple(x.shape)], x.dtype)

    monkeypatch.setattr(jax_hyperprior_module, "quantize_noise",
                        jax_quantize_noise)
    monkeypatch.setattr(
        hyperprior_module, "quantize_noise",
        lambda x, generator: x + _t(noise[(x.shape[0], x.shape[2],
                                           x.shape[3], x.shape[1])]
                                    ).to(x.dtype))


def _port_config(cfg) -> Config:
    return Config.from_json(cfg.to_json())


def _port_lpips(lpips_params) -> LPIPS:
    lpips = LPIPS()
    lpips.load_state_dict(lpips_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, lpips_params)))
    return lpips


def _jax_run(cfg, params, x_u8, lpips_params):
    """JAX's y, mu, sigma, reconstruction, loss, diagnostics and gradients
    (float32 numpy, gradients as a port state_dict)."""
    model = JaxHiFiC(cfg)
    lpips = JaxLPIPS(net="alex")

    def loss_fn(p, x):
        inter, info = model.apply({"params": p}, x, training=True,
                                  rngs={"quantize": jax.random.PRNGKey(1)})
        loss, diag = jax_losses.compression_loss(
            cfg, inter, lambda g, r: lpips.apply({"params": lpips_params},
                                                 g, r, normalize=True), 0)
        y = model.apply({"params": p}, x, method=lambda m, a: m.encoder(a))
        return loss, (diag, y, info.latent_means, info.latent_scales,
                      inter.reconstruction)

    x = jax_train_step.ingest_batch(jnp.asarray(x_u8), cfg)
    (loss, (diag, *tensors)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, x)
    grads = jax.tree_util.tree_map(_f32, grads)
    return (float(loss), {k: float(v) for k, v in diag.items()},
            [_f32(t) for t in tensors], state_dict_from_jax(grads))


def _within(name, port, jax_bf16, ref):
    """The per-tensor rule of the module docstring."""
    port, jax_bf16, ref = (np.asarray(a, np.float64)
                           for a in (port, jax_bf16, ref))
    top = np.abs(ref).max()
    floor = 2.0 ** np.floor(np.log2(top)) * BF16_EPS if top > 0 else 0.0
    err_port = np.abs(port - ref).max()
    err_jax = np.abs(jax_bf16 - ref).max()
    assert err_port <= 2 * err_jax + floor, (name, err_port, err_jax, floor)
    return err_port, err_jax


def test_parameter_and_adam_dtypes_equal_jax_leaf_by_leaf(setup):
    """The transposed convs' kernels and biases (the generator's upconvs,
    both hyper synthesis nets' conv1 and conv2) are bfloat16, with
    bfloat16 Adam moments; every other leaf is float32 — in JAX's train
    state and in the port's, leaf by leaf."""
    cfg, jstate, x, _, _ = setup
    jax_dtypes = {k: v.dtype == torch.bfloat16 for k, v in
                  state_dict_from_jax(jax.tree_util.tree_map(
                      np.asarray, jstate.params), keep_bf16=True).items()}
    pcfg = _port_config(cfg)
    model = HiFiC(pcfg)
    port_dtypes = {n: p.dtype == torch.bfloat16
                   for n, p in model.named_parameters()}
    assert port_dtypes == jax_dtypes
    bf16 = {n for n, is_bf16 in port_dtypes.items() if is_bf16}
    assert bf16 == {f"{m}.{leaf}" for leaf in ("weight", "bias") for m in (
        [f"generator.upconv{i}" for i in range(4)]
        + [f"hyperprior.synthesis_{s}.conv{j}" for s in ("mu", "std")
           for j in (1, 2)])}
    for group in jstate.opt_state.inner_states.values():
        adam = group.inner_state[0]
        for moments in (adam.mu, adam.nu):
            flat = {k: np.asarray(v) for k, v in flatten_tree(moments).items()
                    if hasattr(v, "dtype")}  # not the other group's
            for name, m in state_dict_from_jax(flat, keep_bf16=True).items():
                assert (m.dtype == torch.bfloat16) == port_dtypes[name], name
    state = TrainState(0, model, make_optimizers(pcfg, model),
                       torch.Generator())
    make_train_step_g(pcfg)(state, x)
    for name, p in model.named_parameters():
        moments = state.optimizer.state[p]
        assert moments["exp_avg"].dtype == p.dtype, name
        assert moments["exp_avg_sq"].dtype == p.dtype, name


def test_bf16_forward_losses_and_gradients_against_jax(setup, shared_noise):
    """y, mu, sigma, the reconstruction, the loss and each diagnostic, and
    every gradient leaf of one step, by the per-tensor rule. The losses and
    rates are float32 in both stacks (the latent rate is summed in
    bfloat16 and meets the float32 hyperlatent rate in float32)."""
    cfg, jstate, x, _, lpips_params = setup
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    ref_cfg = cfg.replace(dtype="float32")
    ref_params = jax.tree_util.tree_map(_f32, params)
    loss_b, diag_b, tensors_b, grads_b = _jax_run(cfg, params, x,
                                                  lpips_params)
    loss_r, diag_r, tensors_r, grads_r = _jax_run(ref_cfg, ref_params, x,
                                                  lpips_params)

    pcfg = _port_config(cfg)
    model = HiFiC(pcfg)
    model.load_state_dict(state_dict_from_jax(params, keep_bf16=True))
    model = model.to(memory_format=torch.channels_last)
    lpips = _port_lpips(lpips_params)
    xf = _t(x.astype(np.float32) / 255.0).contiguous(
        memory_format=torch.channels_last)
    inter, info = model(xf, None, training=True)
    loss, diag = losses.compression_loss(
        pcfg, inter, lambda g, r: lpips(g, r, normalize=True), 0)
    assert loss.dtype == torch.float32 and inter.n_bpp.dtype == torch.float32
    assert inter.reconstruction.dtype == torch.bfloat16
    loss.backward()
    with torch.no_grad():
        y = model.encoder(xf)
    port = [y, info.latent_means, info.latent_scales, inter.reconstruction]
    for name, p, b, r in zip(("y", "mu", "sigma", "reconstruction"), port,
                             tensors_b, tensors_r):
        _within(name, _n(p), b, r)
    _within("loss", float(loss), loss_b, loss_r)
    for k in diag_r:
        _within(k, float(diag[k]), diag_b[k], diag_r[k])
    for name, p in model.named_parameters():
        _within(name, p.grad.float().numpy(), grads_b[name].numpy(),
                grads_r[name].numpy())


def test_bf16_norm_statistics_in_float32():
    """The port hands a bfloat16 input to the norm with float32 gamma and
    beta and float32 statistics, rounding once; the JAX package casts gamma
    and beta to bfloat16 and rounds at each step. Against the float32 norm
    of the same bfloat16 input, the port is within one bfloat16 ulp of
    every value (half an ulp of rounding, plus float32 noise where gamma
    x_hat and beta nearly cancel), and its largest error is no larger than
    JAX's (measured here: JAX up to several ulps)."""
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 6, 5, 96) * 2 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 96).astype(np.float32)
    beta = (rng.randn(96) * 0.1).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    variables = {"params": {"gamma": jnp.asarray(gamma),
                            "beta": jnp.asarray(beta)}}
    jax_out = _f32(JaxNorm("channel").apply(variables, xb))
    ref = _f32(JaxNorm("channel").apply(variables, jnp.asarray(xb,
                                                               jnp.float32)))
    norm = Norm(96)
    norm.gamma.data.copy_(torch.from_numpy(gamma))
    norm.beta.data.copy_(torch.from_numpy(beta))
    xt = _t(np.asarray(jnp.asarray(xb, jnp.float32))).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = norm(xt)
    assert out.dtype == torch.bfloat16
    port_out = _n(out)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(port_out - ref) <= ulp + 1e-6)
    assert np.abs(port_out - ref).max() <= np.abs(jax_out - ref).max()


def test_bf16_codec_round_trip_is_lossless(setup):
    """The port's bfloat16 codec (JAX's bfloat16 parameters) decodes its
    own `.hfc` to the symbols it encoded; the reconstruction is finite and
    in [0, 1]. Prints the count of coding indices where its bfloat16
    synth_stats differs from the JAX package's on the same hyperlatents
    (reported, not gated: the two stacks' bfloat16 convs round apart)."""
    cfg, jstate, _, _, _ = setup
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    codec = Codec(_port_config(cfg), state_dict_from_jax(params,
                                                         keep_bf16=True),
                  device="cpu")
    assert codec.model.generator.upconv0.weight.dtype == torch.bfloat16
    x = (np.random.RandomState(5).rand(1, 80, 96, 3) * 255).astype(np.uint8)
    out = codec.compress(x)
    z_enc, y_enc, idx, *_ = codec.encode_symbols(x)
    z_dec, y_dec, _ = codec.decode_symbols(out)
    np.testing.assert_array_equal(z_dec, z_enc)
    np.testing.assert_array_equal(y_dec, y_enc)
    recon = codec.decompress(out)
    assert recon.dtype == np.float32 and recon.shape == (1, 80, 96, 3)
    assert np.isfinite(recon).all() and recon.min() >= 0 and recon.max() <= 1
    u8 = codec.decompress(out, as_uint8=True)
    assert u8.dtype == np.uint8
    _, _, idx_jax = JaxHiFiC(cfg).apply(
        {"params": params}, jnp.asarray(z_enc.transpose(0, 2, 3, 1)),
        jnp.asarray(codec.conditional.scale_table, jnp.float32),
        method=JaxHiFiC.synth_stats)
    flipped = int((np.asarray(idx_jax).transpose(0, 3, 1, 2) != idx).sum())
    print(f"bf16 synth_stats: {flipped} of {idx.size} coding indices differ "
          f"from the JAX package's")


def test_hfc_records_the_compute_dtype_and_decoders_refuse_another(
        setup, tmp_path):
    """A bfloat16 codec's `.hfc` carries the bfloat16 prefix and decodes
    under it; a float32 codec of the same weights refuses it (file and
    bytes), and the bfloat16 codec refuses the float32 codec's file, which
    has no prefix (the JAX package's format byte for byte). The JAX
    package's reader refuses the prefixed file as corrupt (its header
    assertion): no decoder
    reads a payload with coding indices of another dtype."""
    from hific_tpu.entropy.container import load_compressed as jax_load
    from hific_tpu_torch.entropy.container import (
        BF16_MAGIC,
        dumps_compressed,
        loads_compressed,
    )

    cfg, jstate, _, _, _ = setup
    state = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params), keep_bf16=True)
    port_cfg = _port_config(cfg)
    bf16 = Codec(port_cfg, state, device="cpu")
    fp32 = Codec(port_cfg.replace(dtype="float32"), state, device="cpu")
    x = (np.random.RandomState(6).rand(1, 64, 64, 3) * 255).astype(np.uint8)
    p16, p32 = str(tmp_path / "bf16.hfc"), str(tmp_path / "fp32.hfc")
    bf16.compress_file(x, p16)
    fp32.compress_file(x, p32)
    data16, data32 = open(p16, "rb").read(), open(p32, "rb").read()
    assert data16.startswith(BF16_MAGIC)
    assert not data32.startswith(BF16_MAGIC)
    out16 = loads_compressed(data16)
    assert out16.compute_dtype == "bfloat16"
    assert dumps_compressed(out16)[0] == data16
    assert bf16.decompress_file(p16).shape == (1, 64, 64, 3)
    for codec, path in ((fp32, p16), (bf16, p32)):
        with pytest.raises(ValueError, match="payload coded by a"):
            codec.decompress_file(path)
    with pytest.raises(ValueError, match="payload coded by a"):
        fp32.decode_symbols(out16)
    with pytest.raises(AssertionError, match="corrupt container"):
        jax_load(p16)
