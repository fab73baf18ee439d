"""Batches of streams through the port's device rANS coders.

`encode_scan_many` and `decode_scan_many` code several streams, each with
its own positions, lanes, tables and capacities, in one kernel launch on the
card; on the CPU they run the plain versions stream by stream. Here, with
seeded numpy inputs at small sizes:

- the plan pass (each position's nibble and marker rounds, the event
  numbering) against the JAX package's `prepare_encode` and its scan's
  event count;
- the decoder's shared-memory lookup (`rans_tables.table_lookup`: bucket
  index, then a binary search) against `coding.build_inverse_table` for
  every (row, cum_freq) of the flagship-width scale tables and of a
  320-channel hyperlatent density's tables;
- a batch of y and z streams with mixed positions and escape rates 0, 0.08
  and 0.3: every stream equal to its single-stream call, to the JAX
  package's `encode_scan` + `assemble_stream` and to the host coder, and
  decoded as JAX's `decode_scan` decodes it;
- a cap overrun in one stream of a batch, reported for that stream alone;
- tables too large for a block's shared memory (the kernels then read them
  from device memory): a batch coded to the host coder's bytes and back.

The kernels run only on a card: the `cuda` tests hold them against the
plain versions on the same batches, with the tables in shared memory and in
device memory, and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hific_tpu.entropy import device_decode as jax_dd
from hific_tpu.entropy import device_encode as jax_de
from hific_tpu_torch.entropy import device_rans, native
from hific_tpu_torch.entropy.coding import build_inverse_table
from hific_tpu_torch.entropy.device_decode import (
    DecodeJob,
    decode_scan,
    decode_scan_many,
    words_tensor,
)
from hific_tpu_torch.entropy.device_encode import (
    EncodeJob,
    default_caps,
    encode_scan,
    encode_scan_many,
    prepare_encode,
)
from hific_tpu_torch.entropy.entropy_models import (
    ConditionalEntropyModel,
    FactorizedEntropyModel,
)
from hific_tpu_torch.entropy.rans_tables import (
    DECODE_TABLE_BUDGET_WORDS,
    rans_tables,
    table_lookup,
)
from hific_tpu_torch.models.density import HyperlatentDensity
from hific_tpu_torch.ops.maths import pmf_to_quantized_cdf

PRECISION = 16
# (kind, positions, lanes, escape rate): y lanes index the scale tables, z
# lanes are the density's channels.
STREAMS = [("y", 40, 24, 0.0), ("z", 12, 320, 0.08), ("y", 17, 40, 0.3),
           ("z", 9, 320, 0.3), ("y", 30, 24, 0.08)]
SHARED_BYTES = 232448  # a block's shared memory (rans_device.cu)


@pytest.fixture(scope="module")
def tables():
    """Host CDF tables: the flagship's 64 scale rows (y) and the tables of
    a 320-channel density whose parameters are perturbed by seeded noise
    (z)."""
    rng = np.random.RandomState(0)
    density = HyperlatentDensity(320)
    with torch.no_grad():
        for p in density.parameters():
            p.add_(torch.from_numpy(
                rng.normal(0, 0.3, tuple(p.shape)).astype(np.float32)))
    z = FactorizedEntropyModel(density).build_tables()
    return {"y": ConditionalEntropyModel("gaussian").tables, "z": z}


def _stream_inputs(kind, p, lanes, rate, host, rng):
    """Seeded (P, L) int32 symbols and rows: y from a Gaussian at each
    row's scale, z around 0; a share `rate` pushed past the rows' tracked
    ranges, with a multi-nibble payload where the rate is 0.3."""
    rows = len(host.cdf_length)
    if kind == "y":
        idx = rng.randint(0, rows, (p, lanes))
        scale = ConditionalEntropyModel("gaussian").scale_table[idx]
        sym = np.round(rng.randn(p, lanes) * scale)
    else:
        idx = np.broadcast_to(np.arange(lanes), (p, lanes))
        sym = np.round(rng.randn(p, lanes) * 1.5)
    lo = host.cdf_offset[idx]
    hi = lo + host.cdf_length[idx] - 3
    sym = np.clip(sym, lo, hi)
    esc = rng.rand(p, lanes) < rate
    far = rng.randint(1, 300, (p, lanes))
    sym = np.where(esc & (rng.rand(p, lanes) < 0.5), lo - far, sym)
    sym = np.where(esc & (sym >= lo), hi + far, sym)
    if rate >= 0.3:
        sym[rng.randint(p), rng.randint(lanes)] = 999_999
        sym[rng.randint(p), rng.randint(lanes)] = -30_000
    return (np.ascontiguousarray(sym, np.int32),
            np.ascontiguousarray(idx, np.int32))


@pytest.fixture(scope="module")
def batch(tables):
    """The STREAMS' inputs, packed tables and CPU encode jobs."""
    rng = np.random.RandomState(1)
    packed = {k: rans_tables(t.cdf, t.cdf_length, t.cdf_offset,
                             PRECISION).to("cpu") for k, t in tables.items()}
    streams = []
    for kind, p, lanes, rate in STREAMS:
        sym, idx = _stream_inputs(kind, p, lanes, rate, tables[kind], rng)
        bits = 2 if kind == "y" else 8
        job = EncodeJob(torch.from_numpy(sym), torch.from_numpy(idx),
                        packed[kind], *default_caps(p, lanes, bits))
        streams.append((kind, sym, idx, job))
    return streams


@pytest.fixture(scope="module")
def encoded(batch):
    return encode_scan_many([job for *_, job in batch])


def _jax_encode(sym, idx, host, **caps):
    return [np.asarray(a) for a in jax_de.encode_scan(
        jnp.asarray(sym), jnp.asarray(idx),
        jnp.asarray(host.cdf.astype(np.int64), jnp.int32),
        jnp.asarray(host.cdf_length, jnp.int32),
        jnp.asarray(host.cdf_offset, jnp.int32), PRECISION, **caps)]


def _host_encode(sym, idx, host):
    return native.encode_lanes(sym, idx, host.cdf, host.cdf_length,
                               host.cdf_offset, PRECISION)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


def _event_offsets(max_w, n_marker):
    """The lane pass's event numbering, positions back to front: each
    position's first push event and the total. A position has one event,
    or max_w + n_marker + 1 with escapes."""
    n_events = np.where(n_marker > 0, max_w + n_marker + 1, 1)
    after = np.cumsum(n_events[::-1])[::-1]
    return after - n_events, int(n_events.sum())


@pytest.mark.parametrize("k", range(len(STREAMS)))
def test_plan_matches_jax_prepare_encode(k, batch, tables):
    """max_w and n_marker of every position (the plan pass's output) equal
    JAX's prepare_encode; the event numbering they give, counted back to
    front, equals one counted position by position from JAX's and ends at
    the event count of JAX's scan and of the port's plain encode."""
    kind, sym, idx, job = batch[k]
    host = tables[kind]
    plan = prepare_encode(job.sym_l, job.idx_l, job.tables)
    want = jax_de.prepare_encode(
        jnp.asarray(sym), jnp.asarray(idx),
        jnp.asarray(host.cdf.astype(np.int64), jnp.int32),
        jnp.asarray(host.cdf_length, jnp.int32),
        jnp.asarray(host.cdf_offset, jnp.int32))
    max_w = np.asarray(want.max_w)[::-1].astype(np.int64)
    n_marker = np.asarray(want.n_marker)[::-1].astype(np.int64)
    np.testing.assert_array_equal(plan.max_w.numpy(), max_w)
    np.testing.assert_array_equal(plan.n_marker.numpy(), n_marker)
    offsets, total = _event_offsets(plan.max_w.numpy(), plan.n_marker.numpy())
    count, want_offsets = 0, np.zeros(len(max_w), np.int64)
    for i in range(len(max_w) - 1, -1, -1):
        want_offsets[i] = count
        count += max_w[i] + n_marker[i] + 1 if n_marker[i] else 1
    np.testing.assert_array_equal(offsets, want_offsets)
    e_cur = _jax_encode(sym, idx, host, spill_cap=job.spill_cap,
                        lens_cap=job.lens_cap)[5]
    assert total == count == int(e_cur) == int(encode_scan(*job)[2][1])
    if k == 2:  # the 0.3 stream has escape rounds and a marker round
        assert max_w.max() >= 5 and n_marker.max() == 1


def _push_head(h, start, f, precision):
    """The encode kernel's push (`rans_device.cu:push_head`) in numpy: the
    quotient by f estimated as trunc(x * RN(1 / f)) in float64, high word
    then remainder and low word, each followed by one correction."""
    rcp = 1.0 / f.astype(np.float64)
    hi, lo = h >> np.uint64(32), h & np.uint64(0xFFFFFFFF)
    q1 = (hi.astype(np.float64) * rcp).astype(np.uint64)
    r1 = hi - q1 * f
    fix = r1 >= f
    q1, r1 = q1 + fix, np.where(fix, r1 - f, r1)
    # r1 * 2^32 + lo < 2^48: exact in float64, as the kernel's fma.
    x = r1.astype(np.float64) * 4294967296.0 + lo.astype(np.float64)
    q2 = (x * rcp).astype(np.uint64)
    r2 = ((r1 << np.uint64(32)) | lo) - q2 * f
    fix = r2 >= f
    q2, r2 = q2 + fix, np.where(fix, r2 - f, r2)
    return (((q1 << np.uint64(32)) | q2) << np.uint64(precision)) + r2 + start


def test_push_division_exact_for_every_frequency():
    """The encode kernel divides a head by a frequency with a float64
    reciprocal and one correction a step. For every f in [1, 2^16) and
    heads across [2^31, f << 47) (the range a push sees at precision 16):
    multiples of f, one below and f - 1 above them, the top of the range,
    high words that f divides, and seeded random heads, it equals exact
    integer division."""
    rng = np.random.RandomState(0)
    f = np.arange(1, 1 << 16, dtype=np.uint64)[:, None]
    top = f << np.uint64(47)
    span = (top - np.uint64(1 << 31)).astype(np.float64)
    frac = rng.rand(len(f), 8)
    h = np.uint64(1 << 31) + (frac * span).astype(np.uint64)
    h = np.minimum(h, top - np.uint64(1))
    multiples = h // f * f
    hi_mult = ((h >> np.uint64(32)) // f * f) << np.uint64(32)
    h = np.concatenate([h, multiples, multiples - np.uint64(1),
                        multiples + f - np.uint64(1), top - np.uint64(1),
                        top - f, hi_mult, hi_mult - np.uint64(1),
                        hi_mult + np.uint64(0xFFFFFFFF)], axis=1)
    h = np.where((h >= np.uint64(1 << 31)) & (h < top), h, top - np.uint64(1))
    start = rng.randint(0, 1 << 16, h.shape).astype(np.uint64)
    want = ((h // f) << np.uint64(16)) + h % f + start
    np.testing.assert_array_equal(_push_head(h, start, f, 16), want)


@pytest.mark.parametrize("kind,budget", [("y", None), ("y", 0), ("z", None)])
def test_lookup_equals_inverse_everywhere(kind, budget, tables):
    """For every row and every cum_freq in [0, 2^16): the bucket lookup's
    symbol is the inverse table's, and its (start, freq) the row's. The
    default shift is the smallest whose blob fits in shared memory (6 for
    the scale tables); budget 0 forces one bucket a row, the whole row
    searched."""
    host = tables[kind]
    kwargs = {} if budget is None else {"budget_words": budget}
    packed = rans_tables(host.cdf, host.cdf_length, host.cdf_offset,
                         PRECISION, **kwargs)
    if budget is None:
        assert len(packed.blob) <= DECODE_TABLE_BUDGET_WORDS
        assert kind == "z" or packed.shift == 6
    else:
        assert packed.shift == PRECISION
    inverse = build_inverse_table(host.cdf, host.cdf_length, PRECISION)
    cdf = host.cdf.astype(np.int64)
    cf = torch.arange(1 << PRECISION)
    for row in range(len(host.cdf_length)):
        sym, start, freq = (t.numpy() for t in table_lookup(
            packed, torch.full_like(cf, row), cf))
        np.testing.assert_array_equal(sym, inverse[row])
        np.testing.assert_array_equal(start, cdf[row, inverse[row]])
        np.testing.assert_array_equal(
            freq, cdf[row, inverse[row] + 1] - cdf[row, inverse[row]])


@pytest.mark.parametrize("k", range(len(STREAMS)))
def test_batch_encode_equals_single_stream_call(k, batch, encoded):
    """Each stream's (stream, lens, counts) from the batched entry point
    equals its own encode_scan call."""
    *_, job = batch[k]
    for got, want in zip(encoded[k], encode_scan(*job)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("k", range(len(STREAMS)))
def test_batch_encode_equals_jax_and_host(k, batch, encoded, tables):
    """The stream equals JAX's encode_scan + assemble_stream and the host
    coder's; the event counts and cursors equal JAX's."""
    kind, sym, idx, job = batch[k]
    stream, lens, counts = encoded[k]
    hi, lo, spill, j_lens, s_cur, e_cur = _jax_encode(
        sym, idx, tables[kind], spill_cap=job.spill_cap,
        lens_cap=job.lens_cap)
    s, e, bad = (int(v) for v in counts)
    assert (s, e, bad) == (int(s_cur), int(e_cur), 0)
    assert s <= job.spill_cap and e <= job.lens_cap
    np.testing.assert_array_equal(_u32(lens), j_lens)
    want = jax_de.assemble_stream(hi, lo, spill, j_lens, s_cur, e_cur)
    np.testing.assert_array_equal(_u32(stream)[:len(want)], want)
    assert not _u32(stream)[len(want):].any()
    np.testing.assert_array_equal(want, _host_encode(sym, idx, tables[kind]))


def test_batch_decode_equals_jax_and_symbols(batch, tables):
    """The host coder's streams, decoded as one batch, give back the
    symbols, stream by stream equal to single-stream calls and to JAX's
    decode_scan."""
    jobs, want = [], []
    for kind, sym, idx, job in batch:
        host = tables[kind]
        words = _host_encode(sym, idx, host)
        jobs.append(DecodeJob(words_tensor(words), job.idx_l, job.tables))
        dt = jax_dd.build_device_tables(
            host.cdf, host.cdf_length, host.cdf_offset, host.inverse)
        want.append(np.asarray(jax_dd.decode_scan(
            jnp.asarray(words), jnp.asarray(idx),
            *(jnp.asarray(a) for a in dt))))
    for (kind, sym, *_), job, (got, bad), jax_sym in zip(
            batch, jobs, decode_scan_many(jobs), want):
        assert int(bad) == 0
        np.testing.assert_array_equal(got.numpy(), sym)
        np.testing.assert_array_equal(jax_sym, sym)
        assert torch.equal(decode_scan(*job)[0], got)


def _overrun_batch(batch):
    """Streams 0, 2 and 4 of the batch, stream 2 at caps of 8 tail words
    and 16 events."""
    jobs = [batch[k][-1] for k in (0, 2, 4)]
    return [jobs[0], jobs[1]._replace(spill_cap=8, lens_cap=16), jobs[2]]


def test_cap_overrun_reported_per_stream(batch, encoded):
    """One stream past its caps: its counts report the demand and its
    buffers hold what fits, as its single-stream call's do; the other
    streams of the batch are coded whole."""
    jobs = _overrun_batch(batch)
    got = encode_scan_many(jobs)
    s, e, _ = (int(v) for v in got[1][2])
    assert s > 8 and e > 16
    assert got[1][0].shape == (2 * 40 + 8,) and got[1][1].shape == (16,)
    for a, b in zip(got[1], encode_scan(*jobs[1])):
        assert torch.equal(a, b)
    whole = _u32(encoded[2][0])
    np.testing.assert_array_equal(_u32(got[1][0]), whole[:2 * 40 + 8])
    for k, j in ((0, 0), (2, 4)):
        for a, b in zip(got[k], encoded[j]):
            assert torch.equal(a, b)
        assert int(got[k][2][0]) <= jobs[k].spill_cap


def _wide_tables(rng, rows=96, support=1500):
    """Host tables of `rows` rows with `support` tracked symbols each and
    an overflow slot: 144K CDF entries, more than a block's shared memory
    holds, so both kernels read them from device memory."""
    cdf = np.zeros((rows, support + 2), np.uint32)
    for r in range(rows):
        pmf = rng.rand(support) + 1e-3
        pmf = np.concatenate([pmf / pmf.sum() * 0.995, [0.005]])
        cdf[r] = pmf_to_quantized_cdf(pmf, PRECISION)
    return cdf, np.full(rows, support + 2, np.int32), \
        rng.randint(-support, 0, rows).astype(np.int32)


def _device_memory_batch(tables):
    """Streams whose tables exceed shared memory, as (kind, sym, idx, job)
    and the host tables by kind: y against the scale tables packed one
    bucket per cum_freq (the decoder's blob past shared memory, the
    encoder's rows inside it), w against wide tables (both past it)."""
    rng = np.random.RandomState(2)
    y = tables["y"]
    cdf, length, offset = _wide_tables(rng)
    host = {"y": y, "w": y._replace(
        cdf=cdf, cdf_length=length, cdf_offset=offset,
        inverse=build_inverse_table(cdf, length, PRECISION))}
    packed = {
        "y": rans_tables(y.cdf, y.cdf_length, y.cdf_offset, PRECISION,
                         budget_words=1 << 40, inverse=y.inverse).to("cpu"),
        "w": rans_tables(cdf, length, offset, PRECISION).to("cpu")}
    assert packed["y"].shift == 0
    assert 4 * len(packed["y"].blob) > SHARED_BYTES
    assert 4 * packed["y"].encode_words < SHARED_BYTES
    assert 4 * packed["w"].encode_words > SHARED_BYTES
    streams = []
    for kind, p, lanes, rate in (("y", 23, 40, 0.3), ("w", 19, 56, 0.08),
                                 ("y", 11, 24, 0.0), ("w", 7, 33, 0.3)):
        # Wide-table lanes take rows 0..lanes-1, as z lanes do.
        sym, idx = _stream_inputs("y" if kind == "y" else "z", p, lanes,
                                  rate, host[kind], rng)
        # Caps that hold every push: 32 bits a symbol, 10 events a position.
        job = EncodeJob(torch.from_numpy(sym), torch.from_numpy(idx),
                        packed[kind], p * lanes + 4096, 10 * p + 64)
        streams.append((kind, sym, idx, job))
    return streams, host


def test_tables_past_shared_memory_round_trip(tables):
    """A batch against tables too large for shared memory: each stream
    equals the host coder's, single-stream calls equal the batch's, and the
    host coder's streams decode, as one batch, to the symbols."""
    streams, host = _device_memory_batch(tables)
    encoded = encode_scan_many([job for *_, job in streams])
    jobs = []
    for (kind, sym, idx, job), got in zip(streams, encoded):
        words = _host_encode(sym, idx, host[kind])
        stream, counts = _u32(got[0]), got[2]
        np.testing.assert_array_equal(stream[:len(words)], words)
        assert not stream[len(words):].any() and int(counts[2]) == 0
        for a, b in zip(encode_scan(*job), got):
            assert torch.equal(a, b)
        jobs.append(DecodeJob(words_tensor(words), job.idx_l, job.tables))
    for (_, sym, *_), (got, bad) in zip(streams, decode_scan_many(jobs)):
        assert int(bad) == 0
        np.testing.assert_array_equal(got.numpy(), sym)


# ---------------------------------------------------------------- card ---


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _to(job, device):
    return type(job)(*(t.to(device) if hasattr(t, "to") else t for t in job))


@pytest.mark.cuda
@pytest.mark.parametrize("overrun", [False, True])
def test_kernels_match_plain_on_batches(cuda_device, batch, encoded, overrun,
                                        tables):
    """rans_encode on the card over the whole batch (or the batch with one
    stream past its caps) in one launch: every buffer of every stream equal
    to the plain version's; rans_decode over the host coder's streams in one
    launch: the symbols."""
    jobs = _overrun_batch(batch) if overrun else [job for *_, job in batch]
    want = encode_scan_many(jobs) if overrun else encoded
    launches = (device_rans.ENCODE_KERNEL.launches,
                device_rans.DECODE_KERNEL.launches)
    got = encode_scan_many([_to(job, cuda_device) for job in jobs])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    rows = (0, 2, 4) if overrun else range(len(batch))
    djobs = [DecodeJob(words_tensor(_host_encode(*batch[k][1:3],
                                                 tables[batch[k][0]]),
                                    cuda_device),
                       batch[k][3].idx_l.to(cuda_device),
                       batch[k][3].tables.to(cuda_device)) for k in rows]
    for k, (sym, bad) in zip(rows, decode_scan_many(djobs)):
        assert int(bad) == 0
        np.testing.assert_array_equal(sym.cpu().numpy(), batch[k][1])
    assert (device_rans.ENCODE_KERNEL.launches - launches[0],
            device_rans.DECODE_KERNEL.launches - launches[1]) == (1, 1)


@pytest.mark.cuda
def test_kernels_match_plain_with_tables_past_shared_memory(cuda_device,
                                                             tables):
    """The kernels' device-memory table variants: a batch whose decode
    blobs (and, for the wide tables, encode rows) exceed shared memory, in
    one launch each, every encoder buffer equal to the plain version's and
    the host coder's streams decoded to the symbols."""
    streams, host = _device_memory_batch(tables)
    jobs = [job for *_, job in streams]
    want = encode_scan_many(jobs)
    got = encode_scan_many([_to(job, cuda_device) for job in jobs])
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    djobs = [DecodeJob(words_tensor(_host_encode(sym, idx, host[kind]),
                                    cuda_device),
                       job.idx_l.to(cuda_device), job.tables.to(cuda_device))
             for kind, sym, idx, job in streams]
    for (_, sym, *_), (out, bad) in zip(streams, decode_scan_many(djobs)):
        assert int(bad) == 0
        np.testing.assert_array_equal(out.cpu().numpy(), sym)
