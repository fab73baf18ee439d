"""The port's device rANS coders against the JAX package's and the host
coder.

The plain versions of the kernels (`encode_scan_reference`,
`decode_scan_reference`, which `encode_scan` / `decode_scan` run for CPU
tensors) are held byte for byte against the JAX package's `encode_scan` +
`assemble_stream` / `decode_scan` (XLA on the CPU) and against the port's
host coder (`coding.encode_indexed` / `decode_indexed`), over the cases of
the JAX package's `tests/test_device_encode.py` and `test_device_decode.py`.
The
CUDA kernels run only on a card: their tests are marked `cuda`, hold each
kernel against its plain version over the same cases, and skip here. (Flax,
which the JAX models need, is imported inside the one test that builds
their tables, and the random tables are made here, so the card's tests
collect without flax and without the JAX package's test modules.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hific_tpu.entropy import device_decode as jax_dd
from hific_tpu.entropy import device_encode as jax_de
from hific_tpu.entropy.coding import build_inverse_table as jax_inverse
from hific_tpu_torch.entropy import coding, device_rans
from hific_tpu_torch.entropy.device_decode import decode_scan, words_tensor
from hific_tpu_torch.entropy.device_encode import default_caps, encode_scan
from hific_tpu_torch.entropy.rans_tables import rans_tables, table_lookup
from hific_tpu_torch.ops.maths import pmf_to_quantized_cdf

PRECISION = 16
CASES = ["seed0_escapes0", "seed1_escapes0.08", "seed2_escapes0.3",
         "multi_nibble_and_edge"]


def _random_tables(n_rows, rng, max_support=12):
    """Random quantized CDFs with an overflow slot: cdf rows, lengths,
    offsets (the JAX package's tests/test_entropy_coding.py helper)."""
    lengths = rng.randint(3, max_support, size=n_rows) + 2  # cdf_length
    cdf = np.zeros((n_rows, lengths.max()), dtype=np.uint32)
    offsets = rng.randint(-8, 2, size=n_rows).astype(np.int32)
    for r in range(n_rows):
        support = lengths[r] - 2          # tracked symbols
        pmf = rng.rand(support) + 1e-3
        pmf = pmf / pmf.sum() * 0.995
        pmf = np.concatenate([pmf, [0.005]])  # overflow mass
        cdf[r, : support + 2] = pmf_to_quantized_cdf(pmf, PRECISION)
    return cdf, lengths.astype(np.int32), offsets


def _random_symbols(shape, indices, lengths, offsets, rng, p_overflow):
    """Symbols mostly inside the tracked range, some outside (the same
    helper's)."""
    max_values = lengths[indices] - 2
    inside = rng.randint(0, np.maximum(max_values, 1))
    symbols = inside + offsets[indices]
    outliers = rng.rand(*shape) < p_overflow
    symbols = np.where(outliers, symbols + rng.randint(-40, 40, size=shape),
                       symbols)
    return symbols.astype(np.int32)


def _case(name):
    """(symbols, indices) (1, C, H, W) int32 and tables (cdf, lengths,
    offsets): the JAX device coders' test cases."""
    if name == "multi_nibble_and_edge":
        rng = np.random.RandomState(3)
        cdf, lengths, offsets = _random_tables(5, rng)
        shape = (1, 6, 4, 4)
        indices = rng.randint(0, 5, size=shape).astype(np.int32)
        symbols = _random_symbols(shape, indices, lengths, offsets, rng, 0)
        symbols[0, 0, 0, 0] = 30_000
        symbols[0, 1, 1, 1] = -30_000
        symbols[0, 2, 2, 2] = 999_999   # several nibbles, marker rounds
        symbols[0, 4, 2, 1] = -999_999
        r = indices[0, 3, 3, 3]         # the overflow code, zero-width payload
        symbols[0, 3, 3, 3] = (lengths[r] - 2) + offsets[r]
        return symbols, indices, (cdf, lengths, offsets)
    seed = int(name[4])
    rng = np.random.RandomState(seed)
    cdf, lengths, offsets = _random_tables(12, rng)
    shape = (1, 9, 8, 6)
    indices = rng.randint(0, 12, size=shape).astype(np.int32)
    symbols = _random_symbols(shape, indices, lengths, offsets, rng,
                              float(name.split("escapes")[1]))
    return symbols, indices, (cdf, lengths, offsets)


def _lay(x):
    """(1, C, H, W) -> (H * W, C) int32: channels as lanes."""
    _, c, h, w = x.shape
    return np.ascontiguousarray(x[0].transpose(1, 2, 0).reshape(h * w, c),
                                np.int32)


def _port_encode(symbols, indices, tables, device="cpu", **caps):
    """(stream, lens, counts) of the port's encode_scan."""
    t = rans_tables(*tables, precision=PRECISION).to(device)
    sym_l, idx_l = (torch.from_numpy(_lay(a)).to(device)
                    for a in (symbols, indices))
    caps = caps or dict(zip(("spill_cap", "lens_cap"),
                            default_caps(*sym_l.shape)))
    return encode_scan(sym_l, idx_l, t, **caps)


def _jax_encode(symbols, indices, tables, **caps):
    cdf, lengths, offsets = tables
    return [np.asarray(a) for a in jax_de.encode_scan(
        jnp.asarray(_lay(symbols)), jnp.asarray(_lay(indices)),
        jnp.asarray(cdf.astype(np.int64), jnp.int32),
        jnp.asarray(lengths, jnp.int32), jnp.asarray(offsets, jnp.int32),
        PRECISION, **caps)]


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _port_decode(stream, indices, tables, device="cpu"):
    dt = rans_tables(*tables, precision=PRECISION).to(device)
    out, bad = decode_scan(words_tensor(stream, device),
                           torch.from_numpy(_lay(indices)).to(device), dt)
    assert int(bad) == 0
    _, c, h, w = indices.shape
    return out.cpu().numpy().reshape(h, w, c).transpose(2, 0, 1)[None]


@pytest.mark.parametrize("name", CASES)
def test_encode_matches_jax_and_host(name):
    """The stream (heads, then the tail newest chunk first) equals JAX's
    encode_scan + assemble_stream and the host coder's; event counts and
    cursors equal JAX's."""
    symbols, indices, tables = _case(name)
    stream, lens, counts = _port_encode(symbols, indices, tables)
    hi, lo, j_spill, j_lens, s_cur, e_cur = _jax_encode(symbols, indices,
                                                        tables)
    s, e, bad = (int(v) for v in counts)
    assert (s, e, bad) == (int(s_cur), int(e_cur), 0)
    np.testing.assert_array_equal(_u32(lens)[:e], j_lens[:e])
    stream = _u32(stream)
    assert not stream[2 * len(hi) + s:].any()
    stream = stream[:2 * len(hi) + s]
    host, _ = coding.encode_indexed(symbols, indices, *tables, PRECISION)
    np.testing.assert_array_equal(stream, host)
    np.testing.assert_array_equal(
        stream, jax_de.assemble_stream(hi, lo, j_spill, j_lens, s_cur, e_cur))


@pytest.mark.parametrize("name", CASES)
def test_decode_matches_jax_and_host(name):
    """The host coder's stream decodes to the symbols, as JAX's
    decode_scan and the host decoder decode it."""
    symbols, indices, tables = _case(name)
    stream, _ = coding.encode_indexed(symbols, indices, *tables, PRECISION)
    got = _port_decode(stream, indices, tables)
    np.testing.assert_array_equal(got, symbols)
    np.testing.assert_array_equal(
        coding.decode_indexed(stream, indices, *tables, PRECISION), symbols)
    cdf, lengths, offsets = tables
    dt = jax_dd.build_device_tables(cdf, lengths, offsets,
                                    jax_inverse(cdf, lengths, PRECISION))
    want = jax_dd.decode_scan(jnp.asarray(stream), jnp.asarray(_lay(indices)),
                              *(jnp.asarray(a) for a in dt))
    np.testing.assert_array_equal(got[0].transpose(1, 2, 0).reshape(
        -1, symbols.shape[1]), np.asarray(want))


def test_decode_padded_stream():
    """Zero words past the stream's end are never read."""
    rng = np.random.RandomState(4)
    cdf, lengths, offsets = _random_tables(8, rng)
    shape = (1, 7, 5, 5)
    indices = rng.randint(0, 8, size=shape).astype(np.int32)
    symbols = _random_symbols(shape, indices, lengths, offsets, rng, 0.1)
    stream, _ = coding.encode_indexed(symbols, indices, cdf, lengths,
                                      offsets, PRECISION)
    padded = np.concatenate([stream, np.zeros(513, np.uint32)])
    np.testing.assert_array_equal(
        _port_decode(padded, indices, (cdf, lengths, offsets)), symbols)


def test_decode_empty_tail():
    """One position pushes no word out of a lane: the stream is the heads
    alone, and decoding it reads no tail."""
    rng = np.random.RandomState(6)
    cdf, lengths, offsets = _random_tables(4, rng)
    shape = (1, 5, 1, 1)
    indices = rng.randint(0, 4, size=shape).astype(np.int32)
    symbols = _random_symbols(shape, indices, lengths, offsets, rng, 0)
    stream, _ = coding.encode_indexed(symbols, indices, cdf, lengths,
                                      offsets, PRECISION)
    assert len(stream) == 2 * shape[1]
    got, lens, counts = _port_encode(symbols, indices,
                                     (cdf, lengths, offsets))
    assert [int(v) for v in counts] == [0, 1, 0]
    np.testing.assert_array_equal(_u32(got)[:2 * shape[1]], stream)
    np.testing.assert_array_equal(
        _port_decode(stream, indices, (cdf, lengths, offsets)), symbols)


def test_encode_reports_demand_past_caps():
    """Caps of 8 spill words and 16 events: the buffers drop what does not
    fit (the tail keeps its first 8 words, newest chunk first; lens the
    first 16 events), the cursors report the true demand, as JAX's do."""
    rng = np.random.RandomState(4)
    cdf, lengths, offsets = _random_tables(6, rng)
    shape = (1, 8, 16, 16)
    indices = rng.randint(0, 6, size=shape).astype(np.int32)
    symbols = _random_symbols(shape, indices, lengths, offsets, rng, 0.05)
    tables = (cdf, lengths, offsets)
    stream, lens, counts = _port_encode(symbols, indices, tables,
                                        spill_cap=8, lens_cap=16)
    hi, lo, j_spill, j_lens, s_cur, e_cur = _jax_encode(
        symbols, indices, tables, spill_cap=8, lens_cap=16)
    assert stream.shape == (2 * 8 + 8,) and lens.shape == (16,)
    assert [int(v) for v in counts] == [int(s_cur), int(e_cur), 0]
    assert int(s_cur) > 8 and int(e_cur) > 16
    np.testing.assert_array_equal(_u32(lens), j_lens)
    whole = jax_de.assemble_stream(*_jax_encode(symbols, indices, tables))
    np.testing.assert_array_equal(_u32(stream), whole[:2 * 8 + 8])
    np.testing.assert_array_equal(_u32(stream)[:16], np.concatenate([hi, lo]))


@pytest.mark.parametrize("tables", ["scale", "tiny_factorized"])
def test_device_tables_byte_equal(tables):
    """What the port's decoder reads for every (row, cum_freq) of its own
    tables, (start << 16 | freq, symbol) through the packed rows' bucket
    lookup, and each row's overflow code and offset, equal the JAX
    package's device tables built from its tables, byte for byte."""
    from hific_tpu.entropy.entropy_models import (
        ConditionalEntropyModel as JaxCond)
    from hific_tpu_torch.entropy.entropy_models import (
        ConditionalEntropyModel)
    from tests.test_torch_entropy import (
        JaxHiFiC, _jax_factorized, _port_factorized, jax, mse_lpips_config)

    if tables == "scale":
        port, want = ConditionalEntropyModel("gaussian").tables, \
            JaxCond("gaussian").tables
    else:
        cfg = mse_lpips_config(latent_channels=8, n_residual_blocks=1,
                               hyperlatent_filters=16)
        rng = jax.random.PRNGKey(0)
        variables = JaxHiFiC(cfg).init({"params": rng, "quantize": rng},
                                       jnp.zeros((1, 64, 64, 3)),
                                       training=True)
        params = jax.tree_util.tree_map(
            np.asarray,
            variables["params"]["hyperprior"]["hyperlatent_density"])
        port = _port_factorized(params, 16).tables
        want = _jax_factorized(params, 16).tables
    packed = rans_tables(port.cdf, port.cdf_length, port.cdf_offset,
                         PRECISION)
    rows = np.repeat(np.arange(len(port.cdf_length)), 1 << PRECISION)
    cf = np.tile(np.arange(1 << PRECISION), len(port.cdf_length))
    sym, start, freq = (t.numpy() for t in table_lookup(
        packed, torch.from_numpy(rows), torch.from_numpy(cf)))
    t_pair = np.stack([((start << 16) | freq).astype(np.uint32).view(np.int32),
                       sym.astype(np.int32)], axis=-1)
    got = (t_pair, packed.cdf_length - 2, packed.cdf_offset)
    ref = jax_dd.build_device_tables(want.cdf, want.cdf_length,
                                     want.cdf_offset, want.inverse)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_cpu_path_refuses_bad_indices():
    """The plain versions raise on a CDF row outside the tables."""
    symbols, indices, tables = _case("seed0_escapes0")
    indices = indices.copy()
    indices[0, 0, 0, 0] = 12
    with pytest.raises(ValueError, match="outside"):
        _port_encode(symbols, indices, tables)
    stream, _ = coding.encode_indexed(symbols, indices % 12, *tables,
                                      PRECISION)
    with pytest.raises(ValueError, match="outside"):
        _port_decode(stream, indices, tables)


# ---------------------------------------------------------------- card ---


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES + ["caps"])
def test_kernels_match_plain_versions(cuda_device, name):
    """rans_encode and rans_decode on the card against their plain
    versions on the CPU: every word and symbol equal, and one launch
    each."""
    caps = {}
    if name == "caps":
        symbols, indices, tables = _case("seed1_escapes0.08")
        caps = dict(spill_cap=8, lens_cap=16)
    else:
        symbols, indices, tables = _case(name)
    launches = (device_rans.ENCODE_KERNEL.launches,
                device_rans.DECODE_KERNEL.launches)
    got = _port_encode(symbols, indices, tables, cuda_device, **caps)
    torch.cuda.synchronize()
    want = _port_encode(symbols, indices, tables, **caps)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    stream, _ = coding.encode_indexed(symbols, indices, *tables, PRECISION)
    np.testing.assert_array_equal(
        _port_decode(stream, indices, tables, cuda_device), symbols)
    assert (device_rans.ENCODE_KERNEL.launches - launches[0],
            device_rans.DECODE_KERNEL.launches - launches[1]) == (1, 1)


@pytest.mark.cuda
def test_kernels_count_bad_indices(cuda_device):
    """An index outside the tables is read as row 0 and counted."""
    symbols, indices, tables = _case("seed0_escapes0")
    indices = indices.copy()
    indices[0, 0, 0, 0] = 12
    indices[0, 1, 2, 3] = -1
    *_, counts = _port_encode(symbols, indices, tables, cuda_device)
    assert int(counts[2]) == 2
    dt = rans_tables(*tables, precision=PRECISION).to(cuda_device)
    stream, _ = coding.encode_indexed(symbols, indices % 12, *tables,
                                      PRECISION)
    _, bad = decode_scan(words_tensor(stream, cuda_device),
                         torch.from_numpy(_lay(indices)).to(cuda_device), dt)
    assert int(bad) == 2
