"""The tail search behind the factorized tables, against the JAX package.

`host_math.factorized_tails` follows the JAX package's `estimate_tails`
(an Adam search inside a jitted `lax.while_loop`) step for step in XLA's
CPU float32 arithmetic. Its tails and medians must equal the JAX search's
bit for bit, and the factorized tables of freshly JAX-initialised
320-channel densities, whose tails land near integers, byte for byte.
Counts that are not multiples of 8 run part of the first layer in XLA's
scalar remainder loop, or all of it below 16 channels: their tails and
tables are held too. A one-channel density, which XLA compiles to another
program, is refused, not written differently.
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
from hific_tpu_torch.codec import Codec
from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy.entropy_models import FactorizedEntropyModel
from hific_tpu_torch.models.hific import HiFiC
from hific_tpu_torch.models.density import HyperlatentDensity

TARGET = float(np.log(2.0 / 2 ** -8 - 1.0))  # the tail mass 2**-8
TABLE_FIELDS = ("cdf", "cdf_length", "cdf_offset", "inverse")


def _jax_init(c: int, seed: int):
    variables = JaxDensity(n_channels=c).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, 4, c)))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _random(c: int):
    """Random H, a and b of c channels (seed c): every tanh term and
    product of the search live."""
    rng = np.random.RandomState(c)
    dims, params = (1, 3, 3, 3, 1), {}
    for k in range(4):
        params[f"H_{k}"] = rng.uniform(-3, 2, (c, dims[k + 1], dims[k]))
        params[f"a_{k}"] = rng.uniform(-2, 2, (c, dims[k + 1], 1))
        params[f"b_{k}"] = rng.uniform(-1, 1, (c, dims[k + 1], 1))
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
    ("jax_init_16", lambda: _jax_init(16, 0)),
    ("random_64", lambda: _random(64)),
    ("jax_init_12", lambda: _jax_init(12, 0)),
    ("random_5", lambda: _random(5)),
    ("random_12", lambda: _random(12)),
    ("random_20", lambda: _random(20)),
    ("random_36", lambda: _random(36))])
def test_tails_bit_equal_to_the_jax_search(name, make):
    """Lower and upper tails and medians, three searches side by side,
    against three jitted JAX searches: JAX-initialised densities (a = 0, so
    the tanh terms vanish) and random ones. Off multiples of 8: below 16
    channels XLA's first layer is all scalar code (5, 12), at 20 and 36 it
    runs 4-channel vectors; before the remainder loop was followed, 2 of
    the 36 values differed at jax_init_12, 4 of 15 at random_5 and 15 of 36
    at random_12."""
    params = make()
    c = params["b_0"].shape[0]
    targets = [-TARGET, TARGET, 0.0]
    got = host_math.factorized_tails(params, targets)
    for target, tails in zip(targets, got):
        want = np.asarray(jax_estimate_tails(
            _jax_cdf_logits(params), target, (c, 1, 1))).reshape(-1)
        _assert_bits_equal(tails, want, f"{name}, target {target}")


def _assert_tables_identical(params):
    """The port's factorized tables of `params` against the JAX package's:
    medians bit-equal, every table field byte-identical."""
    c = params["b_0"].shape[0]
    want = JaxFactorized(_jax_cdf_logits(params), jax.jit(
        lambda t: JaxDensity(n_channels=c).apply(
            {"params": params}, t,
            method=JaxDensity.likelihood_collapsed)), c)
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_factorized_tables_jax_init_320_byte_identical(seed):
    """A freshly JAX-initialised density at the flagship's width: tails and
    medians bit-equal, tables byte-identical. At PRNGKey(0) the upper tail
    of channel 61 is 66.99774, 2.3e-3 below an integer."""
    _assert_tables_identical(_jax_init(320, seed))


@pytest.mark.parametrize("name,make", [
    ("jax_init_12", lambda: _jax_init(12, 0)),
    ("random_12", lambda: _random(12)),
    ("jax_init_20", lambda: _jax_init(20, 0)),
    ("random_20", lambda: _random(20))])
def test_factorized_tables_off_multiples_of_8_byte_identical(name, make):
    """Hyperlatent widths that are not multiples of 8 (12: the first layer
    all scalar code; 20: 4-channel vectors): tables byte-identical."""
    _assert_tables_identical(make())


@pytest.mark.parametrize("c", [1])
def test_tables_refused_where_the_search_is_not_followed(c):
    """A one-channel density, whose tail search XLA compiles to another
    program: the table builder and a codec of that width refuse, naming
    the open item, before any search."""
    with pytest.raises(ValueError, match="ROADMAP.md section 3"):
        FactorizedEntropyModel(HyperlatentDensity(c)).build_tables()
    cfg = Config(latent_channels=8, n_residual_blocks=1,
                 hyperlatent_filters=c)
    codec = Codec(cfg, HiFiC(cfg).state_dict(), device="cpu")
    with pytest.raises(ValueError, match="one-channel density"):
        codec.compress(np.zeros((1, 64, 64, 3), np.uint8))
