"""The entropy models' value-level API and pinned tables, against the JAX
package.

- `quantile_gaussian` / `quantile_logistic` equal the JAX package's.
- Value-level `compress` / `decompress` of both entropy models: the uint32
  streams equal the JAX package's and the decoded arrays are equal, in
  both likelihood types, vectorized and scalar, at batch 1 and 2.
- `estimate_bits` within rtol 1e-5 of the JAX package's, and the coded
  length under the JAX tests' bound: bits x 1.1 (conditional) or x 1.2
  (factorized) plus 64 bits a lane.
- `import_cdf_tables` from int32 and int64 arrays; a caller's
  `scale_table`; `import_tables` before and after `build_tables`, the
  tables equal to the JAX package's after each; the per-density cache
  never hands imported tables to another model.
- A `Codec` whose entropy models hold imported tables (the factorized
  tables of a second seeded density of the same width, scale tables at
  another tail mass), and one whose conditional model has a caller's scale
  table: the `.hfc` bytes equal the JAX `Codec`'s with the same tables on
  the host coders (v1, v2, scalar) and on the device coders' paths (their
  plain versions on the CPU; the JAX side on its host coder), and differ
  from the default tables' bytes.

The tiny config with the port's seeded weights (and seeded biases of the
scale synthesis, so the coding indices spread), handed to the JAX `Codec`
in its layout (`weights.jax_params_from_model`); everything on the CPU.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from hific_tpu.codec import Codec as JaxCodec
from hific_tpu.config import mse_lpips_config
from hific_tpu.entropy import container as jax_container
from hific_tpu.entropy.entropy_models import (
    ConditionalEntropyModel as JaxConditional,
    import_cdf_tables as jax_import_cdf_tables,
)
from hific_tpu.ops import maths as jax_maths
from hific_tpu_torch import ops
from hific_tpu_torch.codec import Codec
from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy import container
from hific_tpu_torch.entropy.entropy_models import (
    ConditionalEntropyModel,
    FactorizedEntropyModel,
    import_cdf_tables,
)
from hific_tpu_torch.models.density import HyperlatentDensity
from hific_tpu_torch.models.hific import HiFiC, init_random_
from hific_tpu_torch.weights import jax_params_from_model

TABLE_FIELDS = ("cdf", "cdf_length", "cdf_offset", "inverse")
BITS_RTOL = 1e-5
LANE_BITS = 64  # the JAX tests' allowance for a lane's final state


def _nested(flat):
    tree = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(leaf)
    return tree


@pytest.fixture(scope="module")
def pair():
    """The JAX `Codec` and the port's on the same seeded tiny weights, both
    with their tables built."""
    cfg = mse_lpips_config(latent_channels=8, n_residual_blocks=1,
                           hyperlatent_filters=16)
    config = Config.from_json(cfg.to_json())
    model = init_random_(HiFiC(config), torch.Generator().manual_seed(0))
    # Seeded scale biases, so the coding indices spread over the table
    # (with zero biases every sigma here sits at the bound: index 0).
    bias = model.hyperprior.synthesis_std.conv3.bias
    with torch.no_grad():
        bias.copy_(2.0 * torch.rand(bias.shape,
                                    generator=torch.Generator().manual_seed(1)))
    jax_codec = JaxCodec(cfg, _nested(jax_params_from_model(model)))
    jax_codec.build_tables()
    port = Codec(config, model.state_dict(), device="cpu")
    port.build_tables()
    return jax_codec, port


def _assert_tables_equal(got, want):
    for name in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.precision == want.precision


def _latents(shape, seed):
    """Seeded y, means and scales (N, C, H, W), float32, with a few values
    far in the tails (escapes)."""
    rng = np.random.RandomState(seed)
    y = (rng.randn(*shape) * 3).astype(np.float32)
    y.flat[rng.choice(y.size, 3, replace=False)] = [90.3, -250.7, 41.2]
    means = rng.randn(*shape).astype(np.float32)
    scales = np.exp(rng.uniform(-3, 3, shape)).astype(np.float32)
    return y, means, scales


@pytest.mark.parametrize("name", ["gaussian", "logistic"])
def test_quantiles_equal_jax(name):
    rng = np.random.RandomState(0)
    q = rng.uniform(1e-6, 1 - 1e-6, 200)
    mean, scale = rng.randn(200), np.exp(rng.randn(200))
    got = getattr(ops, f"quantile_{name}")(q, mean, scale)
    want = getattr(jax_maths, f"quantile_{name}")(q, mean, scale)
    np.testing.assert_array_equal(got, want)
    dist = scipy.stats.norm if name == "gaussian" else scipy.stats.logistic
    np.testing.assert_allclose(dist.cdf(got, loc=mean, scale=scale), q,
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("vectorize", [True, False],
                         ids=["vectorized", "scalar"])
@pytest.mark.parametrize("likelihood_type", ["gaussian", "logistic"])
def test_conditional_value_api_equals_jax(likelihood_type, vectorize, batch):
    """Streams identical, decoded arrays equal; bits within rtol 1e-5 and
    the coded length within the JAX test's bound."""
    ours = ConditionalEntropyModel(likelihood_type)
    theirs = JaxConditional(likelihood_type)
    shape = (batch, 6, 5, 7)
    y, means, scales = _latents(shape, seed=batch + 2 * vectorize)
    got, got_shape = ours.compress(y, means, scales, vectorize)
    want, want_shape = theirs.compress(y, means, scales, vectorize)
    assert got.tobytes() == want.tobytes()
    assert tuple(got_shape) == tuple(want_shape)
    decoded = ours.decompress(got, means, scales, vectorize)
    assert decoded.dtype == np.float32
    np.testing.assert_array_equal(
        decoded, theirs.decompress(want, means, scales, vectorize))
    np.testing.assert_array_equal(decoded,
                                  np.floor(y + 0.5 - means) + means)
    bits = ours.estimate_bits(y, means, scales, shape[2:])
    np.testing.assert_allclose(
        bits, theirs.estimate_bits(y, means, scales, shape[2:]),
        rtol=BITS_RTOL)
    if vectorize:
        assert 32 * got.size <= bits[0] * 1.1 + LANE_BITS * np.prod(got_shape)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("vectorize", [True, False],
                         ids=["vectorized", "scalar"])
def test_factorized_value_api_equals_jax(pair, vectorize, batch):
    """The codecs' factorized models (one density): streams identical,
    decoded arrays equal; bits within rtol 1e-5 and the coded length within
    the JAX test's bound."""
    theirs, ours = pair[0].factorized, pair[1].factorized
    _assert_tables_equal(ours.tables, theirs.tables)
    shape = (batch, ours.n_channels, 9, 11)
    rng = np.random.RandomState(10 + batch)
    z = (rng.randn(*shape) * 4).astype(np.float32)
    z.flat[:2] = [75.2, -301.9]
    got, got_shape = ours.compress(z, vectorize)
    want, want_shape = theirs.compress(z, vectorize)
    assert got.tobytes() == want.tobytes()
    assert tuple(got_shape) == tuple(want_shape)
    decoded = ours.decompress(got, batch, shape[2:], vectorize)
    assert decoded.dtype == np.float32
    np.testing.assert_array_equal(
        decoded, theirs.decompress(want, batch, shape[2:], vectorize))
    np.testing.assert_array_equal(decoded, np.floor(z + 0.5))
    bits = ours.estimate_bits(z, shape[2:])
    np.testing.assert_allclose(bits, theirs.estimate_bits(z, shape[2:]),
                               rtol=BITS_RTOL)
    if vectorize:
        assert 32 * got.size <= bits[0] * 1.2 + LANE_BITS * np.prod(got_shape)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_import_cdf_tables_equals_jax(dtype):
    t = ConditionalEntropyModel("gaussian", tail_mass=2 ** -4).tables
    args = (t.cdf.astype(dtype), t.cdf_length.astype(dtype),
            t.cdf_offset.astype(dtype), t.precision)
    got = import_cdf_tables(*args)
    _assert_tables_equal(got, jax_import_cdf_tables(*args))
    _assert_tables_equal(got, t)
    assert got.cdf.dtype == np.uint32 and got.inverse.dtype == np.int32


def test_caller_scale_table_equals_jax():
    """A caller's (shorter, coarser) scale table: its tables, indices and
    streams are the JAX package's."""
    table = np.geomspace(0.2, 40.0, 24)
    ours = ConditionalEntropyModel("logistic", scale_table=table)
    theirs = JaxConditional("logistic", scale_table=table)
    np.testing.assert_array_equal(ours.scale_table, theirs.scale_table)
    _assert_tables_equal(ours.tables, theirs.tables)
    assert ours.tables.cdf.shape[0] == 24
    y, means, scales = _latents((1, 5, 6, 4), seed=7)
    got, _ = ours.compress(y, means, scales)
    assert got.tobytes() == theirs.compress(y, means, scales)[0].tobytes()
    default, _ = ConditionalEntropyModel("logistic").compress(y, means,
                                                              scales)
    assert got.tobytes() != default.tobytes()
    np.testing.assert_array_equal(ours.decompress(got, means, scales),
                                  np.floor(y + 0.5 - means) + means)


def _second_density_tables(n_channels: int):
    """The factorized tables of a second seeded density of that width."""
    density = init_random_(HyperlatentDensity(n_channels),
                           torch.Generator().manual_seed(1))
    return FactorizedEntropyModel(density).build_tables()


def _raw(t):
    return t.cdf, t.cdf_length, t.cdf_offset, t.precision


def test_import_and_build_tables_in_either_order(pair):
    """An import after `build_tables` stays in force; `build_tables` after
    an import gives the density's own tables back; both as in the JAX
    package. Another model of the same density never sees the import."""
    jax_codec, port = pair
    theirs, ours = jax_codec.factorized, port.factorized
    own, jax_own = ours.tables, theirs.tables  # both built by the fixture
    other = _second_density_tables(ours.n_channels)
    try:
        ours.build_tables()
        for model in (ours, theirs):
            model.import_tables(*_raw(other))
        _assert_tables_equal(ours.tables, theirs.tables)
        _assert_tables_equal(ours.tables, other)
        fresh = FactorizedEntropyModel(port.model.hyperprior
                                       .hyperlatent_density)
        assert fresh.build_tables() is own
        for model in (ours, theirs):
            model.build_tables()
        _assert_tables_equal(ours.tables, theirs.tables)
        assert ours.tables is own
    finally:
        ours.tables, theirs.tables = own, jax_own
    cond = ConditionalEntropyModel("gaussian")
    cond.import_tables(*_raw(ConditionalEntropyModel(
        "gaussian", tail_mass=2 ** -4).tables))
    jax_cond = JaxConditional("gaussian")
    jax_cond.import_tables(*_raw(JaxConditional("gaussian",
                                                tail_mass=2 ** -4).tables))
    _assert_tables_equal(cond.tables, jax_cond.tables)


def _hfc(out, writer=container) -> bytes:
    f = io.BytesIO()
    writer._save_to(f, out)
    return f.getvalue()


def _images():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 256, (1, 48, 64, 3), dtype=np.uint8)
            for _ in range(2)]


HOST_CODERS = {"v1": dict(vectorize=True, coder_threads=1),
               "v2": dict(vectorize=True, coder_threads=4),
               "scalar": dict(vectorize=False, coder_threads=1)}


def _coded(jax_codec, port, imgs):
    """{path: (port's bytes, JAX's bytes)} of `imgs` on every coding path;
    the port's files decode to the symbols they coded, on the host decoder
    and (vectorized v1) the device decoder's plain version."""
    got = {}
    for name, options in HOST_CODERS.items():
        for codec in (jax_codec, port):
            codec.vectorize = options["vectorize"]
            codec.coder_threads = options["coder_threads"]
        try:
            outs = [port.compress(x) for x in imgs]
            got[name] = ([_hfc(o) for o in outs],
                         [_hfc(jax_codec.compress(x), jax_container)
                          for x in imgs])
            for x, out in zip(imgs, outs):
                z, y, _ = port.decode_symbols(out)
                z_enc, y_enc, *_ = port.encode_symbols(x)
                np.testing.assert_array_equal(z, z_enc)
                np.testing.assert_array_equal(y, y_enc)
        finally:
            for codec in (jax_codec, port):
                codec.vectorize, codec.coder_threads = True, 1
    host = got["v1"][1]
    device = [port.compress(imgs[0], device_encode=True)]
    device += port.compress_many(imgs, device_encode=True)
    got["device_encode"] = ([_hfc(o) for o in device], host[:1] + host)
    on_device = port.decompress_many(device[1:], device_decode=True)
    on_host = port.decompress_many(device[1:], device_decode=False)
    for a, b in zip(on_device, on_host):
        np.testing.assert_array_equal(a, b)
    return got


def test_codec_with_imported_tables_writes_jax_bytes(pair):
    """Tables imported after `build_tables` (a second density's factorized
    tables, scale tables at tail mass 2**-4) reach every coding path of the
    port's `Codec`, the device coders' included: the JAX `Codec`'s bytes
    with the same imports, other than the default tables' bytes; and
    `build_tables` brings the density's own back, on the device coders
    too."""
    jax_codec, port = pair
    imgs = _images()
    assert len(np.unique(port.encode_symbols(imgs[0])[2])) > 1
    default = _coded(jax_codec, port, imgs)
    fact = _second_density_tables(port.factorized.n_channels)
    cond = ConditionalEntropyModel(port.conditional.likelihood_type,
                                   tail_mass=2 ** -4).tables
    saved = (port.conditional.tables, jax_codec.conditional.tables,
             jax_codec.factorized.tables)
    shipped = port._device_tables()
    try:
        for codec in (port, jax_codec):
            codec.factorized.import_tables(*_raw(fact))
            codec.conditional.import_tables(*_raw(cond))
        imported = _coded(jax_codec, port, imgs)
        assert all(t is not s for t, s in zip(port._device_tables(), shipped))
    finally:
        (port.conditional.tables, jax_codec.conditional.tables,
         jax_codec.factorized.tables) = saved
        port.build_tables()
    for name, (ours, theirs) in imported.items():
        assert ours == theirs, name
        assert all(a != b for a, b in zip(ours, default[name][0])), name
    for name, (ours, theirs) in default.items():
        assert ours == theirs, name
    restored = _hfc(port.compress(imgs[0], device_encode=True))
    assert restored == default["device_encode"][0][0]


def test_codec_follows_a_caller_scale_table(pair):
    """A conditional model with a caller's scale table: `synth_stats`
    takes its indices from it on both sides, and the bytes are the JAX
    `Codec`'s with the same table (given to its device copy), other than
    the default table's."""
    jax_codec, port = pair
    x = _images()[0]
    table = np.geomspace(0.11, 64.0, 40)
    default = _hfc(port.compress(x))
    saved = (port.conditional, jax_codec.conditional,
             jax_codec._scale_table_dev)
    try:
        port.conditional = ConditionalEntropyModel(
            port.conditional.likelihood_type, scale_table=table)
        jax_codec.conditional = JaxConditional(
            port.conditional.likelihood_type, scale_table=table)
        jax_codec._scale_table_dev = jnp.asarray(table, jnp.float32)
        np.testing.assert_array_equal(port.scale_table.numpy(),
                                      table.astype(np.float32))
        out = port.compress(x)
        got = _hfc(out)
        assert got == _hfc(jax_codec.compress(x), jax_container)
        assert got == _hfc(port.compress(x, device_encode=True))
        assert got != default
        _, _, idx, *_ = port.encode_symbols(x)
        assert len(np.unique(idx)) > 1 and idx.max() <= len(table) - 1
        np.testing.assert_array_equal(
            port.decompress(out, device_decode=True),
            port.decompress(out, device_decode=False))
    finally:
        (port.conditional, jax_codec.conditional,
         jax_codec._scale_table_dev) = saved
    assert _hfc(port.compress(x)) == default
    with pytest.raises(ValueError, match="ascending"):
        port.conditional = ConditionalEntropyModel(
            "gaussian", scale_table=table[::-1])
        try:
            port.scale_table
        finally:
            port.conditional = saved[0]
