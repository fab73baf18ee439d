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
channels in-process.

At 320 channels and 256 samples or more, the JAX package's own result
depends on the host: XLA partitions that fusion by the number of cores the
process may use, and each part hoists its own first iteration. Given one
core, XLA computes it as one partition, which is the arithmetic the port
follows on every host. The 320-channel tests therefore run the JAX side in
a subprocess pinned to one core (ROADMAP.md, section 3), and hold the
port's own result equal under two CPU affinities.
"""

import os
import subprocess
import sys

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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H0_320_LENGTHS = (256, 264, 300)
SUBPROCESS_TIMEOUT_S = 300

# Reads the densities, samples and tails of each row length from argv[1];
# writes the JAX package's pmf and table for each to argv[2].
_JAX_SIDE = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[3])
import jax
jax.config.update("jax_platforms", "cpu")
from hific_tpu.entropy.tables import build_factorized_tables
from hific_tpu.models.density import HyperlatentDensity
inputs, out = np.load(sys.argv[1]), {}
for m in inputs["lengths"]:
    params = {k[len(f"{m}/p/"):]: inputs[k] for k in inputs.files
              if k.startswith(f"{m}/p/")}
    density = HyperlatentDensity(n_channels=320)
    lik = jax.jit(lambda t: density.apply(
        {"params": params}, t, method=HyperlatentDensity.likelihood_collapsed))
    out[f"{m}/pmf"] = np.asarray(lik(inputs[f"{m}/x"]))
    tables = build_factorized_tables(lik, inputs[f"{m}/lower"],
                                     inputs[f"{m}/upper"])
    for name in ("cdf", "cdf_length", "cdf_offset", "inverse"):
        out[f"{m}/{name}"] = getattr(tables, name)
np.savez(sys.argv[2], **out)
"""

# Prints a digest of the port's pmf for the densities of argv[1].
_PORT_SIDE = """
import hashlib, sys
import numpy as np
sys.path.insert(0, sys.argv[2])
from hific_tpu_torch.entropy import host_math
inputs, digest = np.load(sys.argv[1]), hashlib.sha256()
for m in inputs["lengths"]:
    params = {k[len(f"{m}/p/"):]: inputs[k] for k in inputs.files
              if k.startswith(f"{m}/p/")}
    digest.update(host_math.factorized_likelihood(
        params, inputs[f"{m}/x"], 1e-9).tobytes())
print(len(__import__("os").sched_getaffinity(0)), digest.hexdigest())
"""


def _h0_320_case(m: int):
    params = _uniform_h0_density(320, seed=m)
    x = np.random.RandomState(m).uniform(-8, 8, (320, 1, m)).astype(
        np.float32)
    lower, upper = _tails(320, m, seed=m)
    return params, x, lower, upper


def _run_pinned(code: str, args, cores):
    """Runs `code` in a new interpreter that first sets its CPU affinity to
    `cores`, before it imports anything, so XLA sizes its thread pool from
    them."""
    pin = ("import os, sys\n"
           "os.sched_setaffinity(0, {int(c) for c in sys.argv.pop(1)"
           ".split(',')})\n")
    proc = subprocess.run(
        [sys.executable, "-c", pin + code, ",".join(map(str, sorted(cores))),
         *args], capture_output=True, text=True,
        timeout=SUBPROCESS_TIMEOUT_S, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def h0_320_inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("h0_320") / "inputs.npz"
    arrays = {"lengths": np.array(H0_320_LENGTHS)}
    for m in H0_320_LENGTHS:
        params, x, lower, upper = _h0_320_case(m)
        arrays.update({f"{m}/p/{k}": v for k, v in params.items()})
        arrays.update({f"{m}/x": x, f"{m}/lower": lower, f"{m}/upper": upper})
    np.savez(path, **arrays)
    return path


@pytest.fixture(scope="module")
def jax_on_one_core(h0_320_inputs):
    """The JAX package's pmf and tables of the 320-channel cases, computed
    in a subprocess pinned to the first core this process may use."""
    out = h0_320_inputs.parent / "jax_one_core.npz"
    core = min(os.sched_getaffinity(0))
    _run_pinned(_JAX_SIDE, [str(h0_320_inputs), str(out), ROOT], {core})
    with np.load(out) as z:
        return dict(z)


@pytest.mark.parametrize("m", H0_320_LENGTHS)
def test_uniform_h0_320_matches_single_core_jax(m, jax_on_one_core):
    """The pmf on non-integer samples, every float32 bit, and the table built
    from it, byte for byte, against the JAX package run on one core."""
    params, x, lower, upper = _h0_320_case(m)
    got = host_math.factorized_likelihood(params, x, 1e-9)
    want = jax_on_one_core[f"{m}/pmf"]
    diff = np.argwhere(got.view(np.uint32) != want.view(np.uint32))
    assert diff.size == 0, (f"{len(diff)} pmf values differ, first at "
                            f"{tuple(diff[0])}")
    tables = build_factorized_tables(
        lambda t: host_math.factorized_likelihood(params, t, 1e-9),
        lower, upper)
    for name in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(tables, name),
                                      jax_on_one_core[f"{m}/{name}"],
                                      err_msg=name)


def test_port_pmf_independent_of_cpu_affinity(h0_320_inputs):
    """The port's single-partition arithmetic does not read the host: its
    pmf of the 320-channel cases has the same bytes on one core as on every
    core this process may use."""
    cores = os.sched_getaffinity(0)
    one = _run_pinned(_PORT_SIDE, [str(h0_320_inputs), ROOT],
                      {min(cores)}).split()
    every = _run_pinned(_PORT_SIDE, [str(h0_320_inputs), ROOT],
                        cores).split()
    assert one[0] == "1" and every[0] == str(len(cores))
    assert one[1] == every[1]
