"""The port's depth-to-space generator tail and space-to-depth encoder front
(`ops/d2s.py`, `ops/s2d.py`) against the JAX package's, and against the
plain layers they rewrite.

- The packed kernels, built from the torch layouts, equal the JAX
  package's (converted to OIHW) bit for bit; so do `depth_to_space2`,
  `space_to_depth2` and `packed_reflect_pad2`.
- In float64 the tail and the front, and their gradients, equal the plain
  layers within 1e-12, as `tests/test_d2s.py` and `tests/test_s2d.py` hold
  the JAX package's.
- The tiny generator and encoder with each flag equal the JAX package's
  with the same flag within rtol/atol 2e-5; the fall-backs (instance norm,
  an odd H or W for s2d) compute the plain layers' exact bits.
- Through the tiny codec with both flags on: the `.hfc` bytes equal the JAX
  `Codec`'s, and the reconstruction is within 1e-4 (float) and one level
  (uint8) of JAX's.
- One tiny training step with both flags on: every gradient leaf within
  GRAD_REL (1e-4) of its largest |gradient| of JAX's, and no incoming
  gradient of a norm copied to channels-last.
- The codec's uint8 mapping saturates at 255 as the JAX package's does,
  in bfloat16 too (found comparing the tail in bfloat16 on the card).

Everything on the CPU; ~65 s alone (most of it the JAX codec's and the JAX
step's compiles).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hific_tpu.codec import Codec as JaxCodec
from hific_tpu.config import mse_lpips_config
from hific_tpu.entropy import container as jax_container
from hific_tpu.models.encoder import Encoder as JaxEncoder
from hific_tpu.models.generator import Generator as JaxGenerator
from hific_tpu.ops import d2s as jax_d2s
from hific_tpu.ops import s2d as jax_s2d
from hific_tpu.training.checkpoints import load_params_npz
from hific_tpu_torch.codec import Codec
from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy import container
from hific_tpu_torch.models.encoder import Encoder
from hific_tpu_torch.models.generator import Generator
from hific_tpu_torch.models.hific import HiFiC, init_random_
from hific_tpu_torch.ops import d2s, fused_norm, s2d
from hific_tpu_torch.ops.channel_norm import channel_norm
from hific_tpu_torch.ops.padding import asymmetric_pad_2x, reflect_pad
from hific_tpu_torch.training import checkpoints
from hific_tpu_torch.weights import state_dict_from_jax
from tests.test_torch_train import (  # noqa: F401 (fixtures)
    GRAD_REL,
    _jax_grads,
    _port_state,
    shared_noise,
    tiny,
)

TINY = dict(latent_channels=8, n_residual_blocks=1, hyperlatent_filters=16)
MODULE_TOL = dict(rtol=2e-5, atol=2e-5)
FP64_TOL = dict(rtol=1e-12, atol=1e-12)


def _t(a) -> torch.Tensor:
    """NHWC numpy -> NCHW channels-last tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _n(t) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _hwio(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0)


def _oihw(w) -> np.ndarray:
    return np.asarray(w).transpose(3, 2, 0, 1)


# (name, port function, JAX function, torch weight shape, torch -> JAX
# layout). The transposed conv's JAX kernel is the flipped HWIO
# correlation kernel of `weights.convert_leaf`.
KERNELS = {
    "upconv_kernel_d2s": (d2s.upconv_kernel_d2s, jax_d2s.upconv_kernel_d2s,
                          (5, 4, 3, 3),
                          lambda w: w.transpose(2, 3, 0, 1)[::-1, ::-1]),
    "proj_kernel_d2s": (d2s.proj_kernel_d2s, jax_d2s.proj_kernel_d2s,
                        (3, 6, 7, 7), _hwio),
    "stem_kernel_s2d": (s2d.stem_kernel_s2d, jax_s2d.stem_kernel_s2d,
                        (5, 3, 7, 7), _hwio),
    "down0_kernel_s2d": (s2d.down0_kernel_s2d, jax_s2d.down0_kernel_s2d,
                         (7, 6, 3, 3), _hwio),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_packed_kernels_equal_jax_bit_for_bit(name):
    port_fn, jax_fn, shape, to_jax = KERNELS[name]
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = _oihw(jax_fn(jnp.asarray(np.ascontiguousarray(to_jax(w)))))
    got = port_fn(torch.from_numpy(w)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(2, 2), (2, 5), (3, 3), (6, 4), (7, 9)])
def test_layouts_equal_jax_exactly(hw):
    """depth_to_space2, space_to_depth2 and packed_reflect_pad2 (every
    phase shuffle, and the clamped placeholders at H = 2)."""
    h, w = hw
    rng = np.random.RandomState(1)
    packed = rng.randn(2, h, w, 12).astype(np.float32)
    full = rng.randn(2, 2 * h, 2 * w, 3).astype(np.float32)
    for port_fn, jax_fn, a in (
            (d2s.depth_to_space2, jax_d2s.depth_to_space2, packed),
            (s2d.space_to_depth2, jax_s2d.space_to_depth2, full),
            (d2s.packed_reflect_pad2, jax_d2s.packed_reflect_pad2, packed)):
        np.testing.assert_array_equal(port_fn(torch.from_numpy(a)).numpy(),
                                      np.asarray(jax_fn(jnp.asarray(a))))


def _relu_norm(gamma, beta):
    return lambda v: torch.relu(channel_norm(v, gamma, beta))


def _fp64_inputs(rng, shapes):
    return [torch.from_numpy(rng.randn(*s) * sc).requires_grad_(True)
            for s, sc in shapes]


def _assert_same_and_same_gradients(plain, rewrite, inputs, seed):
    """Outputs and the gradients of every input for one seeded cotangent
    within FP64_TOL (relative to the largest |value|)."""
    want, got = plain(*inputs), rewrite(*inputs)
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    cot = torch.from_numpy(np.random.RandomState(seed).randn(*want.shape))
    g_want = torch.autograd.grad(want, inputs, cot)
    g_got = torch.autograd.grad(got, inputs, cot)
    for a, b in [(got, want)] + list(zip(g_got, g_want)):
        a, b = a.detach(), b.detach()
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   rtol=FP64_TOL["rtol"],
                                   atol=FP64_TOL["atol"] * max(scale, 1.0))


@pytest.mark.parametrize("hw", [(2, 2), (2, 5), (3, 3), (6, 4), (7, 9)])
def test_tail_equals_plain_layers_fp64(hw):
    """ConvTranspose -> ChannelNorm + ReLU -> reflect_pad(3) -> conv 7x7,
    the plain layers' ops in float64, against `generator_tail_d2s`."""
    h, w = hw
    c1, c2 = 10, 6
    rng = np.random.RandomState(0)
    x, w_up, b_up, g, b, w_out, b_out = _fp64_inputs(rng, [
        ((2, h, w, c1), 1.0), ((c1, c2, 3, 3), 0.2), ((c2,), 1.0),
        ((c2,), 0.5), ((c2,), 1.0), ((3, c2, 7, 7), 0.1), ((3,), 1.0)])
    g = (g + 1.0)  # gamma around 1
    x_cl = x.permute(0, 3, 1, 2)

    def plain(*_):
        y = F.conv_transpose2d(x_cl, w_up, b_up, stride=2, padding=1,
                               output_padding=1)
        y = _relu_norm(g, b)(y.contiguous(memory_format=torch.channels_last))
        return F.conv2d(reflect_pad(y, 3), w_out, b_out)

    def rewrite(*_):
        return d2s.generator_tail_d2s(x_cl, w_up, b_up, _relu_norm(g, b),
                                      w_out, b_out)

    _assert_same_and_same_gradients(plain, rewrite,
                                    [x, w_up, b_up, g, b, w_out, b_out], 1)


@pytest.mark.parametrize("hw", [(2, 4), (6, 10), (16, 12)])
def test_front_equals_plain_layers_fp64(hw):
    """reflect_pad(3) -> conv 7x7 -> ChannelNorm + ReLU -> asymmetric pad
    -> conv 3x3 s2, the plain layers' ops in float64, against
    `encoder_front_s2d`."""
    h, w = hw
    rng = np.random.RandomState(2)
    x, w_s, b_s, g, b, w_d, b_d = _fp64_inputs(rng, [
        ((1, h, w, 3), 1.0), ((5, 3, 7, 7), 0.2), ((5,), 1.0), ((5,), 0.5),
        ((5,), 1.0), ((4, 5, 3, 3), 0.2), ((4,), 1.0)])
    g = (g + 1.0)
    x_cl = x.permute(0, 3, 1, 2)

    def plain(*_):
        y = _relu_norm(g, b)(F.conv2d(reflect_pad(x_cl, 3), w_s, b_s))
        return F.conv2d(asymmetric_pad_2x(y), w_d, b_d, stride=2)

    def rewrite(*_):
        return s2d.encoder_front_s2d(x_cl, w_s, b_s, _relu_norm(g, b), w_d,
                                     b_d)

    _assert_same_and_same_gradients(plain, rewrite,
                                    [x, w_s, b_s, g, b, w_d, b_d], 3)


@pytest.fixture(scope="module")
def modules():
    """The JAX package's tiny generator and encoder (one parameter tree
    each, shared by both settings of the flag) and the port's of both
    settings on those parameters."""
    key = jax.random.PRNGKey(3)
    jax_gen = JaxGenerator(C=8, n_residual_blocks=1)
    gen_params = jax.jit(lambda k: jax_gen.init(
        k, jnp.zeros((1, 4, 4, 8))))(key)["params"]
    jax_enc = JaxEncoder(C=8)
    enc_params = jax.jit(lambda k: jax_enc.init(
        k, jnp.zeros((1, 32, 32, 3))))(key)["params"]

    def port(cls, params, **kw):
        m = cls(8, **kw) if cls is Encoder else cls(8, 1, **kw)
        m.load_state_dict(state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
        return m.eval().requires_grad_(False)

    return {
        "generator": (JaxGenerator, gen_params, "d2s_tail",
                      lambda **kw: port(Generator, gen_params, **kw),
                      np.random.RandomState(4).randn(2, 3, 5, 8)),
        "encoder": (JaxEncoder, enc_params, "s2d_front",
                    lambda **kw: port(Encoder, enc_params, **kw),
                    np.random.RandomState(4).rand(2, 48, 32, 3)),
    }


@pytest.mark.parametrize("which", ["generator", "encoder"])
def test_modules_with_the_flag_match_jax(modules, which):
    """The port's module with the flag against JAX's with it (measured
    max abs diff ~1e-6; limits rtol/atol 2e-5)."""
    jax_cls, params, flag, port, x = modules[which]
    x = x.astype(np.float32)
    jax_model = jax_cls(C=8, **({"n_residual_blocks": 1}
                                if jax_cls is JaxGenerator else {}),
                        **{flag: True})
    want = np.asarray(jax.jit(lambda p, a: jax_model.apply(
        {"params": p}, a))(params, jnp.asarray(x)))
    model = port(**{flag: True})
    assert getattr(model, flag)
    got = _n(model(_t(x).contiguous(memory_format=torch.channels_last)))
    np.testing.assert_allclose(got, want, **MODULE_TOL)


@pytest.mark.parametrize("case", ["generator_instance", "encoder_instance",
                                  "encoder_odd"])
def test_fallbacks_compute_the_plain_layers(modules, case):
    """Instance norm cannot take the per-phase norm, and an odd H or W
    cannot pack: the flag then runs the plain layers, bit for bit, as the
    JAX package's does (`tests/test_d2s.py`, `tests/test_s2d.py`)."""
    which, kind = case.split("_")
    _, _, flag, _, x = modules[which]
    norm_type = "instance" if kind == "instance" else "channel"
    if kind == "odd":
        x = np.random.RandomState(5).rand(1, 33, 31, 3)
    cls = Generator if which == "generator" else Encoder
    args = (8,) if cls is Encoder else (8, 1)
    plain = init_random_(cls(*args, norm_type=norm_type),
                         torch.Generator().manual_seed(0)).eval()
    flagged = cls(*args, norm_type=norm_type, **{flag: True}).eval()
    flagged.load_state_dict(plain.state_dict())
    xt = _t(x.astype(np.float32)).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want, got = plain(xt), flagged(xt)
    assert getattr(flagged, flag) == (kind == "odd")
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def codecs(tmp_path_factory):
    """The tiny codec with both flags on: the port's seeded weights,
    exported in the JAX artifact layout and loaded by the JAX `Codec`."""
    config = Config.from_json(mse_lpips_config(
        s2d_encoder_front=True, **TINY).to_json())
    assert config.d2s_generator_tail and config.s2d_encoder_front
    model = init_random_(HiFiC(config), torch.Generator().manual_seed(0))
    npz = checkpoints.export_params_npz(
        str(tmp_path_factory.mktemp("rewrites") / "tiny.npz"), model, config)
    jax_config, params = load_params_npz(npz)
    assert jax_config.s2d_encoder_front and jax_config.d2s_generator_tail
    port = Codec(config, model.state_dict(), device="cpu")
    assert port.model.encoder.s2d_front and port.model.generator.d2s_tail
    return JaxCodec(jax_config, params), port


def test_codec_bytes_and_decode_with_both_flags_match_jax(codecs, tmp_path):
    """`.hfc` bytes equal the JAX `Codec`'s (the s2d front's latents round
    to JAX's symbols); the d2s decode of them within 1e-4 (float) and one
    level (uint8) of JAX's."""
    jax_codec, port = codecs
    x = np.random.RandomState(6).rand(1, 80, 96, 3).astype(np.float32)
    out_j, out_t = jax_codec.compress(x), port.compress(x)
    p_jax, p_port = tmp_path / "jax.hfc", tmp_path / "port.hfc"
    jax_container.save_compressed(out_j, str(p_jax))
    container.save_compressed(out_t, str(p_port))
    assert p_port.read_bytes() == p_jax.read_bytes()
    for as_uint8 in (False, True):
        want = np.asarray(jax_codec.decompress(out_j, as_uint8=as_uint8,
                                               device_decode=False))
        got = port.decompress(out_t, as_uint8=as_uint8)
        assert got.shape == want.shape == x.shape and got.dtype == want.dtype
        if as_uint8:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_uint8_reconstruction_saturates_as_jax():
    """A bfloat16 reconstruction's uint8 pixels are the JAX package's
    `(img * 255 + 0.5).astype(uint8)` in bfloat16, which saturates: at 1.0
    (and 0.999, which rounds to 1.0 in bfloat16) the product rounds to 256,
    which torch's cast alone would wrap to 0. float32 is unchanged."""
    vals = np.array([1.0, 0.999, 0.998, 0.9961, 0.5, 0.0019, 0.0],
                    np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        want = np.asarray((jnp.asarray(vals, jdt) * 255.0 + 0.5).astype(
            jnp.uint8))
        img = torch.from_numpy(vals).to(tdt).view(1, 1, 1, -1)
        got = Codec._image(img, as_uint8=True).reshape(-1).numpy()
        np.testing.assert_array_equal(got, want)
    assert want[0] == 255


def test_train_step_with_both_flags_matches_jax(tiny, shared_noise):
    """One compression step of the tiny model with the d2s tail (the
    default) and the s2d front on, in both stacks: every gradient leaf
    within GRAD_REL of its largest |gradient| of JAX's, and every incoming
    gradient of a norm channels-last (none copied), the per-phase views'
    included."""
    cfg, _, params, lpips_params, x, _ = tiny
    cfg = dataclasses.replace(cfg, s2d_encoder_front=True)
    assert cfg.d2s_generator_tail
    _, _, grads_j = _jax_grads(cfg, params, lpips_params, x, 0)
    state, step_fn = _port_state(cfg, params, lpips_params)
    assert state.model.encoder.s2d_front and state.model.generator.d2s_tail
    copies = fused_norm.BACKWARD_KERNEL.g_copies
    step_fn(state, x)
    assert fused_norm.BACKWARD_KERNEL.g_copies == copies
    want = state_dict_from_jax(grads_j)
    for name, p in state.model.named_parameters():
        w = want[name].numpy()
        scale = np.abs(w).max()
        assert scale > 0, name
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= GRAD_REL * scale, (name, err, scale)
