"""Factorized CDF tables of densities whose first layer XLA folds.

When every entry of softplus(H_0) is equal (a density at its
initialisation), XLA folds the first density layer into a scalar multiply,
and LLVM computes the leading samples of each row as an unfused product and
add (`host_math.xla_unfused_samples`); the last sample of a row whose
length is 1 mod 8 has an unfused last-layer product. These tests build the
tables of such densities with both packages' `build_factorized_tables`,
the JAX side's likelihood jitted over the parameters as its `Codec` does,
and require them byte-identical over row lengths 3..300: each length where
the rule changes, and lengths between. Densities have 16, 64 or 128
channels; at 320 channels and 256 samples or more XLA splits the fusion
across threads differently (ROADMAP.md, section 3).
"""

import jax
import numpy as np
import pytest

from hific_tpu.entropy.tables import (
    build_factorized_tables as jax_build_factorized_tables,
)
from hific_tpu.models.density import HyperlatentDensity as JaxDensity
from hific_tpu_torch.entropy import host_math
from hific_tpu_torch.entropy.tables import build_factorized_tables

DIMS = (1, 3, 3, 3, 1)
TABLE_FIELDS = ("cdf", "cdf_length", "cdf_offset", "inverse")
# (channels, row length): every boundary of the rule, on both sides.
CASES = ([(64, m) for m in (3, 9, 17, 27, 28, 31, 32, 33, 47, 48, 49, 63,
                            64, 65, 100, 129, 200, 255, 256, 257, 300)]
         + [(16, 40), (16, 73), (128, 58), (128, 145)])


def _uniform_h0_density(c: int, seed: int):
    """softplus(H_0) equal everywhere; the other layers and a, b random."""
    rng = np.random.RandomState(seed)
    params = {}
    for k in range(4):
        shape = (c, DIMS[k + 1], DIMS[k])
        h = float(np.log(np.expm1(1.0 / 10.0 ** 0.25 / DIMS[k + 1])))
        params[f"H_{k}"] = np.full(shape, h, np.float32)
        if k:
            params[f"H_{k}"] += rng.uniform(-0.3, 0.3, shape).astype(
                np.float32)
        params[f"a_{k}"] = rng.uniform(-1, 1, (c, DIMS[k + 1], 1)).astype(
            np.float32)
        params[f"b_{k}"] = rng.uniform(-0.5, 0.5, (c, DIMS[k + 1], 1)).astype(
            np.float32)
    params["H_0"] += np.float32(rng.uniform(-0.5, 0.5))
    return params


def _tails(c: int, m: int, seed: int):
    """Per-channel tails whose longest pmf has m samples."""
    rng = np.random.RandomState(seed + 1)
    lengths = rng.randint(max(1, m // 2), m + 1, c)
    lengths[rng.randint(c)] = m
    lower = -(lengths // 2).astype(np.float64) + 0.25
    upper = (lengths - 1 - lengths // 2).astype(np.float64) - 0.25
    return lower, upper


@pytest.mark.parametrize("c,m", CASES)
def test_uniform_h0_tables_byte_identical(c, m):
    params = _uniform_h0_density(c, seed=m)
    lower, upper = _tails(c, m, seed=m)
    density = JaxDensity(n_channels=c)
    variables = {"params": params}
    jax_lik = jax.jit(lambda t: density.apply(
        variables, t, method=JaxDensity.likelihood_collapsed))
    want = jax_build_factorized_tables(jax_lik, lower, upper)
    got = build_factorized_tables(
        lambda t: host_math.factorized_likelihood(params, t, 1e-9),
        lower, upper)
    assert want.cdf.shape[1] == m + 2
    for name in TABLE_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        diff = np.argwhere(a != b)
        assert diff.size == 0, (
            f"{name}: {len(diff)} entries differ, first at "
            f"{tuple(diff[0])}: port {a[tuple(diff[0])]} vs JAX "
            f"{b[tuple(diff[0])]}")


@pytest.mark.parametrize("c,m", [(64, 33), (64, 65), (64, 200)])
def test_uniform_h0_likelihood_bit_exact(c, m):
    """The pmf itself, on non-integer samples: every float32 bit equal."""
    params = _uniform_h0_density(c, seed=m)
    x = np.random.RandomState(m).uniform(-8, 8, (c, 1, m)).astype(np.float32)
    density = JaxDensity(n_channels=c)
    want = np.asarray(jax.jit(lambda t: density.apply(
        {"params": params}, t, method=JaxDensity.likelihood_collapsed))(x))
    got = host_math.factorized_likelihood(params, x, 1e-9)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_rule_read_from_the_host():
    """The split is that of 8-lane vectors, which XLA gets on AVX hosts."""
    lanes = host_math.xla_vector_lanes()
    assert lanes in (4, 8)
    if lanes == 8:
        assert [host_math.xla_unfused_samples(m)
                for m in (2, 3, 27, 28, 31, 32, 47, 48, 63, 64, 255, 256)] \
            == [0, 1, 1, 8, 8, 32, 32, 16, 16, 32, 32, 0]
