"""The PyTorch port's host entropy coder against the JAX package's.

Tables (scale tables, and factorized tables from the tiny model's and the
flagship artifact's densities), rANS streams, the golden bitstream and the
`.hfc` container must be byte-identical between the two packages.
"""

import copy
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from hific_tpu.config import mse_lpips_config
from hific_tpu.entropy import coding as jax_coding
from hific_tpu.entropy import container as jax_container
from hific_tpu.entropy.entropy_models import (
    ConditionalEntropyModel as JaxConditional,
    FactorizedEntropyModel as JaxFactorized,
)
from hific_tpu.models.density import HyperlatentDensity as JaxDensity
from hific_tpu.models.hific import HiFiC as JaxHiFiC
from hific_tpu.ops.maths import pmf_to_quantized_cdf as jax_pmf_to_cdf
from hific_tpu_torch.entropy import coding, container, host_math
from hific_tpu_torch.entropy.entropy_models import (
    ConditionalEntropyModel,
    FactorizedEntropyModel,
)
from hific_tpu_torch.models.density import HyperlatentDensity
from hific_tpu_torch.ops.maths import pmf_to_quantized_cdf

HERE = os.path.dirname(__file__)
ARTIFACT = os.path.join(HERE, "..", "artifacts", "flagship_rd30k_f16.npz")
TABLE_FIELDS = ("cdf", "cdf_length", "cdf_offset", "inverse")


def _assert_tables_equal(got, want):
    for name in TABLE_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        diff = np.argwhere(a != b)
        assert diff.size == 0, (
            f"{name}: {len(diff)} entries differ, first at {tuple(diff[0])}: "
            f"port {a[tuple(diff[0])]} vs JAX {b[tuple(diff[0])]}")


def _jax_factorized(params, n_channels):
    """The JAX package's factorized model built as its Codec builds it."""
    density = JaxDensity(n_channels=n_channels)
    variables = {"params": params}
    cdf_logits_fn = lambda t: density.apply(
        variables, t, stop_gradient=True, method=JaxDensity.cdf_logits)
    likelihood_fn = jax.jit(lambda t: density.apply(
        variables, t, method=JaxDensity.likelihood_collapsed))
    model = JaxFactorized(cdf_logits_fn, likelihood_fn, n_channels)
    model.build_tables()
    return model


def _port_factorized(params, n_channels):
    density = HyperlatentDensity(n_channels)
    density.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                             for k, v in params.items()})
    model = FactorizedEntropyModel(density)
    model.build_tables()
    return model


def test_scale_tables_byte_identical():
    _assert_tables_equal(ConditionalEntropyModel("gaussian").tables,
                         JaxConditional("gaussian").tables)


def test_factorized_tables_tiny_model_byte_identical():
    cfg = mse_lpips_config(latent_channels=8, n_residual_blocks=1,
                           hyperlatent_filters=16)
    rng = jax.random.PRNGKey(0)
    variables = JaxHiFiC(cfg).init({"params": rng, "quantize": rng},
                                   jnp.zeros((1, 64, 64, 3)), training=True)
    params = jax.tree_util.tree_map(
        np.asarray, variables["params"]["hyperprior"]["hyperlatent_density"])
    _assert_tables_equal(_port_factorized(params, 16).tables,
                         _jax_factorized(params, 16).tables)


def test_factorized_tables_flagship_density_byte_identical():
    """The trained density of the flagship artifact (320 channels)."""
    prefix = "p:hyperprior/hyperlatent_density/"
    with np.load(ARTIFACT) as z:
        params = {n[len(prefix):]: z[n].astype(np.float32)
                  for n in z.files if n.startswith(prefix)}
    _assert_tables_equal(_port_factorized(params, 320).tables,
                         _jax_factorized(params, 320).tables)


def _golden_fixture():
    """tests/test_golden_bitstream.py's fixed tables and symbols, built with
    the port's own pmf quantizer."""
    rng = np.random.RandomState(1234)
    n_rows = 5
    lengths = np.array([6, 8, 10, 7, 9], np.int32)
    cdf = np.zeros((n_rows, lengths.max()), np.uint32)
    offsets = np.array([-3, -2, 0, -5, 1], np.int32)
    for r in range(n_rows):
        support = lengths[r] - 2
        pmf = rng.rand(support) + 0.01
        pmf = pmf / pmf.sum() * 0.99
        pmf = np.concatenate([pmf, [0.01]])
        cdf[r, : support + 2] = pmf_to_quantized_cdf(pmf, 16)
    shape = (1, 5, 6, 6)
    indices = rng.randint(0, n_rows, size=shape).astype(np.int32)
    symbols = (rng.randint(0, 5, size=shape) + offsets[indices]).astype(np.int32)
    symbols[0, 0, 0, 0] = 57
    symbols[0, 1, 2, 3] = -41
    return symbols, indices, cdf, lengths, offsets


@pytest.mark.parametrize("native", ["1", "0"])
def test_golden_bitstream_reproduced(native, monkeypatch):
    """Both the C++ coder and the numpy coder write the frozen bytes."""
    monkeypatch.setenv("HIFIC_TPU_TORCH_NATIVE", native)
    symbols, indices, cdf, lengths, offsets = _golden_fixture()
    encoded, _ = coding.encode_indexed(symbols, indices, cdf, lengths,
                                       offsets, 16)
    with open(os.path.join(HERE, "golden.sha256")) as f:
        golden = f.read().strip()
    assert hashlib.sha256(encoded.tobytes()).hexdigest() == golden
    decoded = coding.decode_indexed(encoded, indices, cdf, lengths, offsets, 16)
    np.testing.assert_array_equal(decoded, symbols)


@pytest.mark.parametrize("native", ["1", "0"])
def test_streams_equal_the_jax_coder(native, monkeypatch):
    """Scale-table coding with escapes (|symbol| up to 3000, multi-nibble
    payloads): same bytes as the JAX package's coder, and each decodes the
    other's stream."""
    monkeypatch.setenv("HIFIC_TPU_TORCH_NATIVE", native)
    tables = ConditionalEntropyModel("gaussian").tables
    rng = np.random.RandomState(7)
    shape = (1, 12, 9, 7)
    indices = rng.randint(0, 64, size=shape).astype(np.int32)
    symbols = np.round(rng.randn(*shape) * 4).astype(np.int32)
    symbols.flat[rng.choice(symbols.size, 20, replace=False)] = \
        rng.randint(-3000, 3000, 20)
    args = (tables.cdf, tables.cdf_length, tables.cdf_offset, 16)
    ours, shape_ours = coding.encode_indexed(symbols, indices, *args)
    theirs, shape_theirs = jax_coding.encode_indexed(symbols, indices, *args)
    assert shape_ours == shape_theirs
    assert ours.tobytes() == theirs.tobytes()
    np.testing.assert_array_equal(
        coding.decode_indexed(theirs, indices, *args,
                              inverse_table=tables.inverse), symbols)
    np.testing.assert_array_equal(
        jax_coding.decode_indexed(ours, indices, *args,
                                  inverse_table=tables.inverse), symbols)


def test_container_bytes_round_trip():
    rng = np.random.RandomState(3)
    fields = dict(
        hyperlatents_encoded=rng.randint(0, 2 ** 32, 37, dtype=np.uint64
                                         ).astype(np.uint32),
        latents_encoded=rng.randint(0, 2 ** 32, 411, dtype=np.uint64
                                    ).astype(np.uint32),
        hyperlatent_spatial_shape=(2, 3), spatial_shape=(100, 150),
        hyper_coding_shape=(320, 1, 1), latent_coding_shape=(220, 1, 1),
        batch_shape=1, total_bpp=0.25)
    ours, actual_bpp, est_bpp = container.dumps_compressed(
        container.CompressionOutput(**fields))
    theirs, _, _ = jax_container.dumps_compressed(
        jax_container.CompressionOutput(**fields))
    assert ours == theirs
    assert actual_bpp == 8.0 * len(ours) / (100 * 150) and est_bpp == 0.25
    back = container.loads_compressed(theirs)
    for name in ("hyperlatents_encoded", "latents_encoded"):
        np.testing.assert_array_equal(getattr(back, name), fields[name])
    assert back.spatial_shape == (100, 150)
    assert back.latent_coding_shape == (220, 1, 1)
    corrupt = bytearray(ours)
    corrupt[22] ^= 0xFF  # the header magic follows 22 bytes of shapes
    with pytest.raises(ValueError, match="corrupt"):
        container.loads_compressed(bytes(corrupt))


def test_pmf_to_quantized_cdf_matches_jax():
    rng = np.random.RandomState(5)
    for n in (2, 7, 40, 300):
        pmf = rng.rand(n) ** 4
        pmf[rng.rand(n) < 0.2] = 0.0  # zero-mass symbols
        pmf[0] = 1e-9  # a tiny mass forces a frequency steal
        np.testing.assert_array_equal(pmf_to_quantized_cdf(pmf, 16),
                                      jax_pmf_to_cdf(pmf, 16))


def _flagship_density_params():
    prefix = "p:hyperprior/hyperlatent_density/"
    with np.load(ARTIFACT) as z:
        return {n[len(prefix):]: z[n].astype(np.float32)
                for n in z.files if n.startswith(prefix)}


def test_estimate_tails_finds_quantiles():
    """Two searches side by side, each to its own quantile of the flagship
    density: the CDF logits cross each target within 0.05 of its tail."""
    params = _flagship_density_params()
    qs = np.array([0.42, 0.93])
    targets = np.log(qs / (1.0 - qs))
    tails = host_math.factorized_tails(params, list(targets))
    assert tails.shape == (2, 320)
    for target, t in zip(targets, tails):
        below, above = (host_math.factorized_cdf_logits(
            params, (t + d).reshape(320, 1, 1).astype(np.float32))
            .reshape(-1) for d in (-0.05, 0.05))
        assert np.all(below < target) and np.all(above > target)


def test_side_by_side_searches_equal_separate_ones():
    """Stopping a finished search leaves each result as a search of its own
    gives it, on the flagship density (searches of 135 to 1.2e3 steps)."""
    params = _flagship_density_params()
    targets = [-6.0, 0.0]
    together = host_math.factorized_tails(params, targets)
    for target, got in zip(targets, together):
        (alone,) = host_math.factorized_tails(params, [target])
        np.testing.assert_array_equal(got.view(np.uint32),
                                      alone.view(np.uint32))


def test_scale_indices_match_jax_and_synth_stats_rule():
    """compute_scale_indices equals the JAX package's, and the bucketize rule
    `HiFiC.synth_stats` codes with (count of scale_table[:-1] below sigma)."""
    from hific_tpu.entropy.tables import compute_scale_indices as jax_indices
    from hific_tpu_torch.entropy.tables import (compute_scale_indices,
                                                prior_scale_table)

    table = np.maximum(prior_scale_table(), 0.11)
    rng = np.random.RandomState(11)
    scales = np.concatenate([np.exp(rng.uniform(-3, 6, 5000)),
                             table, [0.05, 1e4]]).astype(np.float32)
    np.testing.assert_array_equal(compute_scale_indices(scales, table),
                                  jax_indices(scales, table))
    # synth_stats compares in float32, against the float32 table.
    t32 = table.astype(np.float32)
    bucket = torch.bucketize(torch.from_numpy(np.maximum(scales, 0.11)),
                             torch.from_numpy(t32[:-1]))
    np.testing.assert_array_equal(compute_scale_indices(scales, t32),
                                  bucket.numpy())


def test_factorized_tables_built_once_per_density(monkeypatch):
    """A second entropy model of an equal density takes the first one's
    tables without searching; a density that differs in one parameter
    searches again."""
    torch.manual_seed(0)
    density = HyperlatentDensity(8)
    first = FactorizedEntropyModel(density)
    first.build_tables()
    real = host_math.factorized_tails
    calls = []
    monkeypatch.setattr(host_math, "factorized_tails",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    again = FactorizedEntropyModel(copy.deepcopy(density))
    assert again.build_tables() is first.tables and calls == []
    np.testing.assert_array_equal(again.medians, first.medians)
    with torch.no_grad():
        density.b_0[0, 0, 0] += 0.25
    other = FactorizedEntropyModel(density)
    other.build_tables()
    assert calls == [1]
    assert not np.array_equal(other.medians, first.medians)
