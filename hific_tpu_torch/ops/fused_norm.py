"""Fused ChannelNorm (+ReLU): the CUDA kernels of `csrc/channel_norm.cu`
(forward and backward) and their plain PyTorch versions.

The kernels replace the Pallas TPU kernel `hific_tpu/ops/pallas_norm.py`:
its forward (`_channel_norm_fwd_pallas`) and the closed-form backward of
its `custom_vjp` (`_cn_bwd`). The forward reads the channels-last rows of
an NCHW tensor, so the wrapper takes only tensors that are contiguous in
`torch.channels_last` and raises on anything else instead of copying. In
the backward autograd decides the layout of the incoming gradient, so a
gradient that is not channels-last is copied, and counted.

`channel_norm_fused` records an autograd edge only where a gradient is
wanted: then `_ChannelNormFn` runs the forward and, in the backward, the
backward kernel. Under `torch.no_grad()` or `torch.inference_mode()` only
the forward runs and nothing is saved. A tensor on the CPU takes the plain
versions; a CUDA tensor launches the kernels or raises. The forward's
launch plan (`forward_plan`: rows straight to registers, or tiles through
shared memory) is computed here, from the shape, the dtype, the pointers'
alignment and the card's SM count, and passed to the kernel.
"""

import collections
import ctypes
import functools
import math
import os
import threading
from typing import NamedTuple

import torch

from hific_tpu_torch import native_build
from hific_tpu_torch.ops.channel_norm import channel_norm

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "channel_norm.cu")
MAX_CHANNELS = 1024
ACTS = ("none", "relu")
BWD_MAX_BLOCKS = 264   # kBwdMaxBlocks in channel_norm.cu
# The forward's limits, as in channel_norm.cu.
FWD_THREADS = 256      # kFwdThreads
FWD_MAX_COLUMNS = 16   # kFwdNv: columns of a row one thread takes
FWD_MAX_STAGES = 4     # kFwdMaxStages
FWD_MAX_SMEM = 96 * 1024  # kFwdMaxSmem, per block
# The forward's plan.
FWD_BLOCKS_PER_SM = 2     # resident at once (__launch_bounds__(256, 2))
FWD_RING_TILE = 2048      # bytes of a unit's tile walked through its ring
FWD_RING_STAGES = 2
FWD_WAVE_BLOCK = 65536    # the most tile bytes a block holds in one wave
H100_SMS = 132

_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_void_p]


class ChannelNormLibrary:
    """The built library of `channel_norm.cu`, shared by both kernels."""

    def __init__(self):
        self.built = None
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.built = native_build.build_library(
                    "channel_norm", [SOURCE],
                    [native_build.nvcc()] + native_build.NVCC_FLAGS)
                lib = ctypes.CDLL(self.built.path)
                for name, argtypes in (
                        ("hific_channel_norm_f32", _FWD_ARGTYPES),
                        ("hific_channel_norm_bf16", _FWD_ARGTYPES),
                        ("hific_channel_norm_bwd_f32", _BWD_ARGTYPES),
                        ("hific_channel_norm_bwd_bf16", _BWD_ARGTYPES),
                        ("hific_empty_kernel", [ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p])):
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = argtypes
                self._lib = lib
            return self._lib


LIBRARY = ChannelNormLibrary()


def _raise_on(err: int, what: str, x: torch.Tensor) -> None:
    if err != 0:
        n, c, h, w = x.shape
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"(M={n * h * w}, C={c}, dtype={x.dtype})")


class ForwardPlan(NamedTuple):
    via_smem: int  # 0: rows straight to registers; 1: tiles through smem
    tpr: int       # threads per row, a power of two (1-32 rows, 1-64 tiles)
    rows: int      # rows a block (rows path) or a unit's tile (tiles path)
    stages: int    # ring slots a unit walks its tiles through (tiles path)
    blocks: int    # grid size


# Rows whose bytes are a multiple of 8 but not of 16 take 8-byte chunks in
# registers up to this many rows, where a launch is latency-bound; above it
# they go through shared memory in 16-byte chunks.
FWD_FEW_ROWS = 8192


def forward_units(tpr: int) -> int:
    """Units per block of the tiles path: warps, or warp pairs where a row
    takes 64 threads."""
    return FWD_THREADS // max(tpr, 32)


def _rows_chunk(row_bytes: int, itemsize: int, align: int):
    """Bytes of the rows path's chunks: 16 or 8, as the rows and the
    pointers (x, out, gamma and beta, `align` bytes aligned) allow, or
    None; a chunk's gamma and beta come in vector loads of up to 16
    bytes."""
    return next((v for v in (16, 8) if row_bytes % v == 0 and align % v == 0
                 and align % min(16, 4 * v // itemsize) == 0), None)


def rows_plan(m: int, c: int, itemsize: int, align: int = 16):
    """The rows path's plan, or None where the rows do not allow it: chunks
    of 16 bytes where a row's bytes are a multiple of 16 (8 where of 8 and
    the pointers, `align` bytes aligned, allow only that), the fewest lanes
    a row (a power of two up to 32) that hold them with one chunk each, or
    32 lanes with up to 8 chunks and 32 values each; one lane group a row,
    every row in the grid."""
    row_bytes = c * itemsize
    v = _rows_chunk(row_bytes, itemsize, align)
    if v is None:
        return None
    chunks = row_bytes // v
    tpr = 1
    while tpr < min(chunks, 32):
        tpr *= 2
    per_lane = -(-chunks // tpr)
    if per_lane > 8 or per_lane * (v // itemsize) > 32:
        return None
    rows = FWD_THREADS // tpr
    return ForwardPlan(0, tpr, rows, 1, max(1, -(-m // rows)))


def tiles_plan(m: int, c: int, itemsize: int, sms: int = H100_SMS,
               ring_tile: int = FWD_RING_TILE,
               ring_stages: int = FWD_RING_STAGES) -> ForwardPlan:
    """The tiles path's plan (channel_norm.cu's design note). A row goes to
    the fewest threads (a power of two) that hold it with at most 16
    columns each; a unit (a warp, or the two warps of a 64-thread row)
    walks its own tiles of `rows` rows, whose bytes are a multiple of 16 so
    that they move as 16-byte chunks. Where one wave of units (two blocks
    per SM, each unit one tile) holds every row in at most 64 KB a block,
    that is the plan, with no ring: all loads are issued at once. Else ~2 KB
    tiles, a multiple of the rows a unit reduces at a time, walked through a
    ring of 2 slots (1 where the block's rings would pass 96 KB); 2 slots
    of 2 KB measured fastest at C = 60 in bf16 (`scripts/norm_plans.py`)."""
    tpr = 1
    while -(-c // tpr) > FWD_MAX_COLUMNS:
        tpr *= 2
    row_bytes = c * itemsize
    align = 16 // math.gcd(row_bytes, 16)  # rows whose bytes are 16 x n
    units = forward_units(tpr)
    capacity = sms * FWD_BLOCKS_PER_SM
    rows = -(-max(m, 1) // (capacity * units))
    rows = -(-rows // align) * align
    if units * rows * row_bytes <= FWD_WAVE_BLOCK:
        return ForwardPlan(1, tpr, rows, 1, max(1, -(-m // (rows * units))))
    step = max(align, max(tpr, 32) // tpr)
    rows = max(step, ring_tile // row_bytes // step * step)
    stages = min(ring_stages,
                 FWD_MAX_SMEM // (units * (rows * row_bytes + 16)))
    return ForwardPlan(1, tpr, rows, max(1, stages),
                       min(-(-m // (rows * units)), capacity))


@functools.lru_cache(maxsize=1024)
def forward_plan(m: int, c: int, itemsize: int, sms: int = H100_SMS,
                 align: int = 16) -> ForwardPlan:
    """The forward kernel's launch plan for M rows of C channels of
    `itemsize` bytes, x, the output, gamma and beta all `align` bytes
    aligned (16, or the largest power of two below that divides all four),
    on a card of `sms` SMs.

    Rows whose bytes are a multiple of 16 go straight to registers in
    16-byte chunks, every row at once (the generator's and the encoder's
    layers from C = 120 in bf16, C = 60 in fp32). The others (C = 60 and
    220 in bf16, odd widths, views off a 16-byte boundary) go through
    shared memory as tiles of whole 16-byte chunks, except few rows whose
    bytes are a multiple of 8, which take 8-byte chunks in registers."""
    plan = rows_plan(m, c, itemsize, align)
    if plan is not None and (_rows_chunk(c * itemsize, itemsize, align) == 16
                             or m <= FWD_FEW_ROWS):
        return plan
    return tiles_plan(m, c, itemsize, sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class ChannelNormKernel:
    """The forward kernel and its launch count (kernel launches only), in
    all and by input dtype."""

    def __init__(self):
        self.launches = 0
        self.by_dtype = collections.Counter()

    def launch(self, x, gamma, beta, out, eps: float, relu: bool,
               plan: ForwardPlan = None) -> None:
        """Writes out; `plan` defaults to `forward_plan` for x on its card
        (the tests pass others to reach every path of the kernel)."""
        lib = LIBRARY.load()
        fn = (lib.hific_channel_norm_f32 if x.dtype == torch.float32
              else lib.hific_channel_norm_bf16)
        n, c, h, w = x.shape
        m = n * h * w
        if plan is None:
            plan = forward_plan(
                m, c, x.element_size(), _sm_count(x.device.index),
                math.gcd(x.data_ptr(), out.data_ptr(), gamma.data_ptr(),
                         beta.data_ptr(), 16))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                     out.data_ptr(), m, c, eps, int(relu), *plan, stream)
        _raise_on(err, "channel_norm", x)
        self.launches += 1
        self.by_dtype[x.dtype] += 1


class ChannelNormBackwardKernel:
    """The backward kernel, its launch count (in all and by input dtype),
    and the count of incoming gradients that were not channels-last and had
    to be copied (on any device)."""

    def __init__(self):
        self.launches = 0
        self.by_dtype = collections.Counter()
        self.g_copies = 0

    def launch(self, x, g, gamma, beta, dx, eps: float, relu: bool,
               stages: int = 3):
        """Writes dx; returns the (2, C) fp32 tensor (dgamma, dbeta).

        The backward is two kernels: the row kernel (dx, and one row of
        column sums per block) and the column sum of those rows. `stages`
        1 or 2 launches only the first or the second, to time each; the
        second alone then sums whatever its scratch holds."""
        lib = LIBRARY.load()
        fn = (lib.hific_channel_norm_bwd_f32 if x.dtype == torch.float32
              else lib.hific_channel_norm_bwd_bf16)
        n, c, h, w = x.shape
        m = n * h * w
        blocks = max(1, min(m, BWD_MAX_BLOCKS))  # the kernel may take fewer
        partial = torch.empty((blocks, 2, c), dtype=torch.float32,
                              device=x.device)
        dgb = torch.empty((2, c), dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), g.data_ptr(), gamma.data_ptr(),
                     beta.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                     dgb.data_ptr(), m, c, eps, int(relu), blocks, stages,
                     stream)
        _raise_on(err, "channel_norm backward", x)
        self.launches += 1
        self.by_dtype[x.dtype] += 1
        return dgb


KERNEL = ChannelNormKernel()
BACKWARD_KERNEL = ChannelNormBackwardKernel()


def channel_norm_fused_reference(x, gamma, beta, eps: float = 1e-3,
                                 act: str = "none"):
    """Plain PyTorch version of the forward kernel: fp32 math, output in x's
    dtype."""
    y = channel_norm(x.float(), gamma.float(), beta.float(), eps)
    if act == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


def channel_norm_backward_reference(x, gamma, beta, g, eps: float = 1e-3,
                                    act: str = "none"):
    """Plain PyTorch version of the backward kernel, the closed form of the
    JAX package's `_cn_bwd`: (dx, dgamma, dbeta), all fp32."""
    c = x.shape[1]
    x = x.float()
    g = g.float()
    gamma = gamma.float().view(1, c, 1, 1)
    beta = beta.float().view(1, c, 1, 1)
    centered = x - x.mean(dim=1, keepdim=True)
    var = (centered * centered).sum(dim=1, keepdim=True) / (c - 1)
    r = torch.rsqrt(var + eps)
    x_hat = centered * r
    if act == "relu":
        g = g * (x_hat * gamma + beta > 0.0)
    dgamma = (g * x_hat).sum(dim=(0, 2, 3))
    dbeta = g.sum(dim=(0, 2, 3))
    d = g * gamma
    dx = r * (d - d.mean(dim=1, keepdim=True)
              - x_hat * (d * x_hat).sum(dim=1, keepdim=True) / (c - 1))
    return dx, dgamma, dbeta


def _check(x, gamma, beta, act: str) -> None:
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("channel_norm_fused takes an NCHW tensor that is "
                         "contiguous in torch.channels_last")
    c = x.shape[1]
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma/beta must have shape ({c},), got "
                         f"{tuple(gamma.shape)} and {tuple(beta.shape)}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"no channel_norm_fused for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"channel_norm_fused takes float32 or bfloat16, "
                         f"got {x.dtype}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{x.device}")
    if not 2 <= c <= MAX_CHANNELS:
        raise ValueError(f"channel_norm_fused takes 2 <= C <= {MAX_CHANNELS}"
                         f", got C={c}")


def _forward(x, gamma, beta, eps: float, act: str):
    if x.device.type == "cpu":
        return channel_norm_fused_reference(x, gamma, beta, eps, act)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    KERNEL.launch(x, gamma, beta, out, float(eps), act == "relu")
    return out


def channel_norm_backward(x, gamma, beta, g, eps: float = 1e-3,
                          act: str = "none"):
    """(dx, dgamma, dbeta) of `channel_norm_fused` at x for the incoming
    gradient g: the backward kernel on a CUDA tensor, its plain version on a
    CPU tensor. dx has x's dtype and layout; dgamma and dbeta are fp32."""
    _check(x, gamma, beta, act)
    if g.shape != x.shape:
        raise ValueError(f"gradient shape {tuple(g.shape)} != input shape "
                         f"{tuple(x.shape)}")
    if g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"gradient {g.dtype} on {g.device} for an input "
                         f"{x.dtype} on {x.device}")
    if not g.is_contiguous(memory_format=torch.channels_last):
        g = g.contiguous(memory_format=torch.channels_last)
        BACKWARD_KERNEL.g_copies += 1
    if x.device.type == "cpu":
        dx, dgamma, dbeta = channel_norm_backward_reference(
            x, gamma, beta, g, eps, act)
        return (dx.to(x.dtype).contiguous(memory_format=torch.channels_last),
                dgamma, dbeta)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device,
                     memory_format=torch.channels_last)
    dgb = BACKWARD_KERNEL.launch(x, g, gamma, beta, dx, float(eps),
                                 act == "relu")
    return dx, dgb[0], dgb[1]


class _ChannelNormFn(torch.autograd.Function):
    """ChannelNorm(+act) with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.act = eps, act
        return _forward(x, gamma, beta, eps, act)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        dx, dgamma, dbeta = channel_norm_backward(x, gamma, beta, g, ctx.eps,
                                                  ctx.act)
        return dx, dgamma, dbeta, None, None


def channel_norm_fused(x, gamma, beta, eps: float = 1e-3, act: str = "none"):
    """ChannelNorm(+act) of NCHW `x` stored channels-last; gamma, beta (C,)."""
    _check(x, gamma, beta, act)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _ChannelNormFn.apply(x, gamma, beta, float(eps), act)
    return _forward(x, gamma, beta, float(eps), act)
