"""The tail search behind the factorized tables, against the JAX package.

`host_math.factorized_tails` follows the JAX package's `estimate_tails`
(an Adam search inside a jitted `lax.while_loop`) step for step in XLA's
CPU float32 arithmetic. Its tails and medians must equal the JAX search's
bit for bit, and the factorized tables of freshly JAX-initialised
320-channel densities, whose tails land near integers, byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hific_tpu.entropy.entropy_models import (
    FactorizedEntropyModel as JaxFactorized,
)
from hific_tpu.entropy.tables import estimate_tails as jax_estimate_tails
from hific_tpu.models.density import HyperlatentDensity as JaxDensity
from hific_tpu_torch.entropy import host_math
from hific_tpu_torch.entropy.entropy_models import FactorizedEntropyModel
from hific_tpu_torch.models.density import HyperlatentDensity

TARGET = float(np.log(2.0 / 2 ** -8 - 1.0))  # the tail mass 2**-8
TABLE_FIELDS = ("cdf", "cdf_length", "cdf_offset", "inverse")


def _jax_init(c: int, seed: int):
    variables = JaxDensity(n_channels=c).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, 4, c)))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _random_64():
    """Random H, a and b: every tanh term and product of the search live."""
    rng = np.random.RandomState(64)
    dims, params = (1, 3, 3, 3, 1), {}
    for k in range(4):
        params[f"H_{k}"] = rng.uniform(-3, 2, (64, dims[k + 1], dims[k]))
        params[f"a_{k}"] = rng.uniform(-2, 2, (64, dims[k + 1], 1))
        params[f"b_{k}"] = rng.uniform(-1, 1, (64, dims[k + 1], 1))
    return {k: v.astype(np.float32) for k, v in params.items()}


def _jax_cdf_logits(params):
    density = JaxDensity(n_channels=params["b_0"].shape[0])
    return lambda t: density.apply({"params": params}, t, stop_gradient=True,
                                   method=JaxDensity.cdf_logits)


def _port_model(params):
    density = HyperlatentDensity(params["b_0"].shape[0])
    density.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                             for k, v in params.items()})
    return FactorizedEntropyModel(density)


def _assert_bits_equal(got, want, what):
    diff = np.argwhere(got.view(np.uint32) != want.view(np.uint32))
    assert diff.size == 0, (f"{what}: {len(diff)} values differ, first at "
                            f"{tuple(diff[0])}: port {got[tuple(diff[0])]!r} "
                            f"vs JAX {want[tuple(diff[0])]!r}")


@pytest.mark.parametrize("name,make", [
    ("jax_init_16", lambda: _jax_init(16, 0)), ("random_64", _random_64)])
def test_tails_bit_equal_to_the_jax_search(name, make):
    """Lower and upper tails and medians, three searches side by side,
    against three jitted JAX searches: a JAX-initialised density of the tiny
    model's width (a = 0, so the tanh terms vanish) and a random one."""
    params = make()
    c = params["b_0"].shape[0]
    targets = [-TARGET, TARGET, 0.0]
    got = host_math.factorized_tails(params, targets)
    for target, tails in zip(targets, got):
        want = np.asarray(jax_estimate_tails(
            _jax_cdf_logits(params), target, (c, 1, 1))).reshape(-1)
        _assert_bits_equal(tails, want, f"{name}, target {target}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_factorized_tables_jax_init_320_byte_identical(seed):
    """A freshly JAX-initialised density at the flagship's width: tails and
    medians bit-equal, tables byte-identical. At PRNGKey(0) the upper tail
    of channel 61 is 66.99774, 2.3e-3 below an integer."""
    params = _jax_init(320, seed)
    want = JaxFactorized(_jax_cdf_logits(params), jax.jit(
        lambda t: JaxDensity(n_channels=320).apply(
            {"params": params}, t,
            method=JaxDensity.likelihood_collapsed)), 320)
    want.build_tables()
    got = _port_model(params)
    got.build_tables()
    _assert_bits_equal(got.medians, want.medians.astype(np.float32),
                       "medians")
    for name in TABLE_FIELDS:
        a, b = getattr(got.tables, name), getattr(want.tables, name)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        diff = np.argwhere(a != b)
        assert diff.size == 0, (
            f"{name}: {len(diff)} entries differ, first at {tuple(diff[0])}: "
            f"port {a[tuple(diff[0])]} vs JAX {b[tuple(diff[0])]}")
