"""ChannelNorm of the PyTorch port against the JAX package.

The port's plain `channel_norm` and `channel_norm_fused_reference` (the CUDA
kernel's plain version) are held against the JAX package's `channel_norm`
and its Pallas kernel `channel_norm_fused` (interpret mode on the CPU) on
the same seeded inputs. The forward kernel's launch plan
(`fused_norm.forward_plan`) is held to its invariants at every width, and
`chip_smoke.py`'s library yardstick (`F.layer_norm` and its backward with
the weight and eps rescaled) to the plain versions. The CUDA kernel itself
runs only on a card: its tests are marked `cuda` and skip here.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hific_tpu.ops.channel_norm import channel_norm as jax_channel_norm
from hific_tpu.ops.pallas_norm import channel_norm_fused as jax_fused
from hific_tpu_torch.ops import fused_norm
from hific_tpu_torch.ops.channel_norm import channel_norm

ATOL = 1e-5


def _data(c, seed=0, shape=(2, 5, 7)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape, c) * 2.0 + 0.5).astype(np.float32)  # NHWC
    gamma = (1.0 + 0.3 * rng.randn(c)).astype(np.float32)
    beta = (0.2 * rng.randn(c)).astype(np.float32)
    return x, gamma, beta


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor stored channels-last (a permuted view)."""
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("c", [60, 220, 960])
def test_plain_and_reference_match_jax(c, act):
    """Measured max abs error 1.4e-6 over the six cases (limit 1e-5)."""
    x, gamma, beta = _data(c)
    want = jax_channel_norm(jnp.asarray(x), jnp.asarray(gamma),
                            jnp.asarray(beta))
    if act == "relu":
        want = jax.nn.relu(want)
    want_fused = jax_fused(jnp.asarray(x), jnp.asarray(gamma),
                           jnp.asarray(beta), act=act)
    xt, gt, bt = _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta)
    plain = channel_norm(xt, gt, bt)
    if act == "relu":
        plain = torch.relu(plain)
    ref = fused_norm.channel_norm_fused_reference(xt, gt, bt, act=act)
    for got in (plain, ref):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want_fused),
                                   atol=ATOL, rtol=0)


def test_wrapper_on_cpu_takes_the_plain_path():
    x, gamma, beta = _data(60, seed=1)
    xt, gt, bt = _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta)
    before = fused_norm.KERNEL.launches
    got = fused_norm.channel_norm_fused(xt, gt, bt, act="relu")
    assert fused_norm.KERNEL.launches == before
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(
        got, fused_norm.channel_norm_fused_reference(xt, gt, bt, act="relu"),
        rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, gamma, beta = _data(60, seed=2)
    gt, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
    nchw_contiguous = _nchw(x).contiguous()  # the layout slip to catch
    with pytest.raises(ValueError, match="channels_last"):
        fused_norm.channel_norm_fused(nchw_contiguous, gt, bt)
    with pytest.raises(ValueError, match="gamma"):
        fused_norm.channel_norm_fused(_nchw(x), gt[:10], bt)
    with pytest.raises(ValueError, match="act"):
        fused_norm.channel_norm_fused(_nchw(x), gt, bt, act="elu")


# Widths that reach every threads-per-row variant of the forward kernel
# (1 at C <= 16, 2 at 17-32, 4, 8, 16, 32, 64 at 513-1024).
CARD_WIDTHS = [2, 30, 50, 60, 120, 220, 240, 480, 960, 1024]
PLAN_ROWS = [0, 1, 7, 777, 1536, 2048, 4096, 6144, 24576, 98304, 393216,
             1048576, 3000017]


def _plans(itemsize, align=16):
    for c in range(2, fused_norm.MAX_CHANNELS + 1):
        for m in PLAN_ROWS:
            yield m, c, fused_norm.forward_plan(m, c, itemsize, align=align)


@pytest.mark.parametrize("align", [16, 8, 2])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_moves_16_byte_chunks(itemsize, align):
    """Rows whose bytes are a multiple of 16 go straight to registers in
    16-byte chunks where the pointers allow it; every other plan moves tiles
    of whole 16-byte chunks through shared memory (within its limit), but
    for few rows of 8 x n bytes, which take 8-byte chunks in registers."""
    for m, c, plan in _plans(itemsize, align):
        row = c * itemsize
        if plan.via_smem:
            assert fused_norm.rows_plan(m, c, itemsize, align) is None or (
                (row % 16 or align < 16)
                and m > fused_norm.FWD_FEW_ROWS), (m, c, plan)
            tile = plan.rows * c * itemsize
            assert tile % 16 == 0, (m, c, plan)
            assert 1 <= plan.stages <= fused_norm.FWD_MAX_STAGES, (m, c)
            units = fused_norm.forward_units(plan.tpr)
            assert units * plan.stages * (tile + 16) <= (
                fused_norm.FWD_MAX_SMEM), (m, c, plan)
        else:
            chunk = 16 if row % 16 == 0 and align == 16 else 8
            assert row % chunk == 0 and align % chunk == 0, (m, c, plan)
            assert align % min(16, 4 * chunk // itemsize) == 0, (m, c)
            assert chunk == 16 or m <= fused_norm.FWD_FEW_ROWS, (m, c, plan)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_spreads_each_row_over_the_fewest_threads(itemsize):
    """Every width from 2 to 1024 is planned. Tiles: a power of two threads
    per row from 1 to 64, each taking at most 16 columns, and half as many
    would not hold the row (so at C = 60 in bf16 four threads take 15 each).
    Rows: the fewest lanes (a power of two up to 32) that hold the row's
    chunks one each, or 32 with up to 8."""
    most = fused_norm.FWD_MAX_COLUMNS
    for m, c, plan in _plans(itemsize):
        tpr = plan.tpr
        if plan.via_smem:
            assert tpr in (1, 2, 4, 8, 16, 32, 64), (c, plan)
            assert math.ceil(c / tpr) <= most, (c, plan)
            assert tpr == 1 or math.ceil(c / (tpr // 2)) > most, (c, plan)
        else:
            chunks = c * itemsize // (16 if c * itemsize % 16 == 0 else 8)
            assert tpr in (1, 2, 4, 8, 16, 32), (c, plan)
            assert chunks <= 8 * tpr and (tpr == 32 or chunks <= tpr), (
                c, plan)
            assert tpr == 1 or chunks > tpr // 2, (c, plan)
    assert fused_norm.forward_plan(393216, 60, 2).tpr == 4
    assert fused_norm.forward_plan(98304, 120, 2).tpr == 16
    assert fused_norm.forward_plan(1536, 960, itemsize).tpr == 32


@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_is_one_wave_up_to_4096_rows(itemsize):
    """At M <= 4096 (the generator's C = 960 layers at 768x512, a batch-8
    step and 1024x1024) every row's loads are issued at once: the rows path
    gives each row its lanes within the card's 270,336 resident threads,
    the tiles path gives each unit one tile with two blocks per SM. Above,
    a tiles grid never exceeds that and a ring tile holds ~2 KB (or the
    fewest rows a unit reduces at a time)."""
    for m, c, plan in _plans(itemsize):
        if not plan.via_smem:
            assert plan.rows == fused_norm.FWD_THREADS // plan.tpr
            assert plan.blocks == max(1, math.ceil(m / plan.rows)), (m, c)
            if m <= 4096:
                assert plan.blocks * fused_norm.FWD_THREADS <= (
                    fused_norm.H100_SMS * 2048), (m, c, plan)
            continue
        units = fused_norm.forward_units(plan.tpr)
        tiles = max(1, math.ceil(m / plan.rows))
        needed = math.ceil(tiles / units)
        assert 1 <= plan.blocks <= min(
            needed, fused_norm.H100_SMS * fused_norm.FWD_BLOCKS_PER_SM), (
            m, c, plan)
        if m <= 4096:
            assert plan.stages == 1 and plan.blocks == needed, (m, c, plan)
        if plan.stages > 1:
            step = max(32, plan.tpr) // plan.tpr
            assert (plan.rows * c * itemsize <= fused_norm.FWD_RING_TILE
                    or plan.rows <= max(step, 16 // itemsize)), (m, c, plan)


@pytest.mark.parametrize("c", [50, 60, 220, 960])
def test_layer_norm_yardstick_is_the_same_function(c):
    """`chip_smoke.py`'s library yardstick, `F.layer_norm` on the
    channels-last view with gamma * sqrt((C-1)/C) and eps * (C-1)/C,
    equals the plain version without the ReLU within 1e-5 (measured at
    most 9.5e-7)."""
    x, gamma, beta = _data(c, seed=3)
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    gt, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
    got = torch.nn.functional.layer_norm(
        *chip_smoke.layer_norm_args(xt, gt, bt))
    want = fused_norm.channel_norm_fused_reference(xt, gt, bt)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("c", [50, 60, 220, 960])
def test_layer_norm_backward_yardstick_is_the_same_function(c):
    """`native_layer_norm_backward` with the same rescaled weight and eps
    gives the plain backward's dx, and dgamma = dw * sqrt((C-1)/C), dbeta
    = db, each within 1e-5 of its largest magnitude."""
    x, gamma, beta = _data(c, seed=4)
    g = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    gt = _nchw(g).contiguous(memory_format=torch.channels_last)
    gam, bet = torch.from_numpy(gamma), torch.from_numpy(beta)
    dx, dw, db = torch.ops.aten.native_layer_norm_backward(
        *chip_smoke.layer_norm_backward_args(xt, gam, bet, gt))
    want = fused_norm.channel_norm_backward_reference(xt, gam, bet, gt)
    got = (dx.permute(0, 3, 1, 2), dw * math.sqrt((c - 1) / c), db)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=ATOL * float(b.abs().max()))


def _card_inputs(m, c, dtype, device, seed=None, offset=0):
    """Seeded (x, gamma, beta); x an NCHW channels-last view of m rows that
    starts `offset` elements into its storage."""
    gen = torch.Generator(device=device).manual_seed(
        m + c if seed is None else seed)
    flat = torch.randn(offset + m * c, generator=gen, device=device)
    x = flat.to(dtype)[offset:].view(1, m, 1, c).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=device)
    beta = 0.1 * torch.randn(c, generator=gen, device=device)
    return x, gamma, beta


def _assert_matches_plain(got, x, gamma, beta, act):
    """fp32 within 1e-5; bf16 within one ulp of the output plus 1e-5, since
    where gamma * x_hat and beta nearly cancel, the two fp32 computations
    differ by a few fp32 ulps of the terms, more than a bf16 ulp of the
    small result (chip_smoke.py measured 9 of 2.4e7 values beyond one ulp
    on an H100, by at most 3.0e-8)."""
    assert got.dtype == x.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = fused_norm.channel_norm_fused_reference(x, gamma, beta, act=act)
    diff = (got.float() - want.float()).abs()
    if x.dtype == torch.float32:
        assert diff.numel() == 0 or float(diff.max()) <= ATOL
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.float().abs().clamp_min(2.0 ** -126))) - 7.0)
        assert bool((diff <= ulp + ATOL).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu"])
@pytest.mark.parametrize("m,c", [(1536, 960), (1536, 220), (6144, 480),
                                 (24576, 240), (98304, 120), (393216, 60),
                                 (777, 50)]
                         + [(m, c) for c in CARD_WIDTHS
                            for m in (0, 3, 1531, 100003)])
def test_kernel_matches_plain_on_the_card(cuda_device, m, c, act, dtype):
    """Kernel vs its plain version at the round trip's shapes and at every
    threads-per-row variant with no rows, fewer rows than one tile, and
    rows that end in a ragged tile (one wave at 1531; at 100003 the ring
    from C = 120 in bf16, C = 50 in fp32); two calls give the same bits."""
    x, gamma, beta = _card_inputs(m, c, dtype, cuda_device)
    before = fused_norm.KERNEL.launches
    got = fused_norm.channel_norm_fused(x, gamma, beta, act=act)
    again = fused_norm.channel_norm_fused(x, gamma, beta, act=act)
    torch.cuda.synchronize()
    assert fused_norm.KERNEL.launches == before + 2
    assert torch.equal(got, again)
    _assert_matches_plain(got, x, gamma, beta, act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("c", CARD_WIDTHS)
def test_kernel_ring_at_every_stage_count_on_the_card(cuda_device, c,
                                                      stages, dtype):
    """The tiles path with explicit plans: the fewest rows whose bytes are
    16 x n and 3 blocks, so each unit walks ~8-17 tiles through a ring of
    1-4 slots, the last ragged; the bits equal the default tiles plan's (a
    row's sums do not depend on the tile, unit or plan it falls in)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = 16 // math.gcd(c * itemsize, 16)
    m = 200 * rows - 3
    x, gamma, beta = _card_inputs(m, c, dtype, cuda_device)
    default = fused_norm.tiles_plan(m, c, itemsize)
    plan = fused_norm.ForwardPlan(1, default.tpr, rows, stages, 3)
    got = torch.empty_like(x)
    fused_norm.KERNEL.launch(x, gamma, beta, got, 1e-3, True, plan=plan)
    want = torch.empty_like(x)
    fused_norm.KERNEL.launch(x, gamma, beta, want, 1e-3, True, plan=default)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _assert_matches_plain(got, x, gamma, beta, "relu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("same_offset", [False, True])
@pytest.mark.parametrize("offset_bytes", [4, 8, 12])
@pytest.mark.parametrize("m,c", [(1531, 60), (1531, 120), (40009, 120),
                                 (2048, 960)])
def test_kernel_off_16_bytes_on_the_card(cuda_device, m, c, offset_bytes,
                                         same_offset, dtype):
    """x starts 4-12 bytes off a 16-byte boundary (fp32 8 bytes off: few
    rows take the rows path with 8-byte chunks; else the tiles path); the
    output is fresh (aligned) or off by the same amount (16-byte stores
    straight from shared memory). Matches the plain version, and two calls
    give the same bits."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if offset_bytes % itemsize:
        pytest.skip("fp32 views start on 4-byte boundaries")
    offset = offset_bytes // itemsize
    x, gamma, beta = _card_inputs(m, c, dtype, cuda_device, offset=offset)
    assert x.data_ptr() % 16 == offset_bytes
    outs = []
    for _ in range(2):
        if same_offset:
            out = torch.empty(offset + m * c, dtype=dtype, device=cuda_device)
            out = out[offset:].view(1, m, 1, c).permute(0, 3, 1, 2)
        else:
            out = torch.empty_like(x)
        fused_norm.KERNEL.launch(x, gamma, beta, out, 1e-3, False)
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    _assert_matches_plain(outs[0], x, gamma, beta, "none")


@pytest.mark.cuda
@pytest.mark.parametrize("plan,runs", [
    (fused_norm.ForwardPlan(1, 4, 4, 1, 4), True),     # 480-byte tiles
    (fused_norm.ForwardPlan(0, 16, 16, 1, 63), True),  # 8-byte chunks
    (fused_norm.ForwardPlan(1, 3, 8, 1, 4), False),    # threads a row not 2^k
    (fused_norm.ForwardPlan(1, 2, 8, 1, 4), False),    # 30 columns a thread
    (fused_norm.ForwardPlan(1, 4, 1, 1, 4), False),    # 120-byte tiles
    (fused_norm.ForwardPlan(1, 4, 8, 5, 4), False),    # too many stages
    (fused_norm.ForwardPlan(1, 4, 512, 2, 4), False),  # rings over the limit
    (fused_norm.ForwardPlan(1, 4, 8, 1, 0), False),    # no block
    (fused_norm.ForwardPlan(0, 64, 4, 1, 250), False),  # rows: 64 lanes
    (fused_norm.ForwardPlan(0, 16, 16, 1, 62), False),  # rows left over
    (fused_norm.ForwardPlan(0, 2, 128, 1, 8), False),   # 8 chunks a lane
    (fused_norm.ForwardPlan(2, 4, 4, 1, 4), False)])    # no such path
def test_kernel_rejects_a_plan_it_cannot_run(cuda_device, plan, runs):
    """At M = 1000, C = 60 in bf16 (120-byte rows) the entry point runs any
    plan within its limits and refuses the rest with cudaErrorInvalidValue
    (1), launching nothing."""
    x, gamma, beta = _card_inputs(1000, 60, torch.bfloat16, cuda_device)
    out = torch.empty_like(x)
    if runs:
        fused_norm.KERNEL.launch(x, gamma, beta, out, 1e-3, False, plan=plan)
        torch.cuda.synchronize()
        _assert_matches_plain(out, x, gamma, beta, "none")
    else:
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            fused_norm.KERNEL.launch(x, gamma, beta, out, 1e-3, False,
                                     plan=plan)
