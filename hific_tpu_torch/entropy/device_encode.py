"""rANS encode on the device: the CUDA kernel `rans_encode` of
`csrc/rans_device.cu` and its plain PyTorch version.

Counterpart of the JAX package's `entropy/device_encode.py` (`encode_scan`,
an XLA scan with uint32-pair heads and long division). Both write bit for
bit the v1 stream of `coding.py` and the native coder, so either decoder
reads it. Positions are walked back to front. Each push first spills the
low words of the lanes whose head h >= freq << (63 - precision), in lane
order, at the spill cursor, and records that event's count; then
h = (h / freq) << precision + h % freq + start. A position's escape pushes
(freq 1 in a 4-bit identity CDF, spill threshold 2^59) come before its main
push: nibbles from high to low, then width markers from last to first, in
the closed forms the JAX package derived:
    marker round k:  clamp(width - 15 k, 0, 15)
    nibble round j:  width > 0 ? nibble(min(j, width - 1)) : last marker
Writes past a buffer's capacity are dropped but counted, so the caller sees
the true demand and relaunches with buffers that hold it (`codec.py`).

`encode_scan` launches the kernel for CUDA tensors and runs the plain
version, `encode_scan_reference`, for CPU tensors. The kernel maps symbols
to pushes itself; the plain version maps them with `prepare_encode`, the
JAX package's vectorized gathers and closed forms. `assemble_stream`
flattens the result on the host, newest spill chunk first.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from hific_tpu_torch.entropy import device_rans

RANS_L = 1 << 31
OVERFLOW_WIDTH = 4
MAX_OVERFLOW = (1 << OVERFLOW_WIDTH) - 1
WORD = 0xFFFFFFFF
# Spill threshold of the 4-bit escape pushes: ((2^31 >> 4) << 32) * 1.
X_MAX_ESCAPE = 1 << 59
Z_SPILL_BITS = 8  # hyperlatent-stream spill allowance (bits/symbol)


def default_caps(p: int, lanes: int,
                 bits_per_symbol: int = 2) -> Tuple[int, int]:
    """(spill_cap, lens_cap), the JAX package's: `bits_per_symbol` of
    stream allowance and 4 push events per position. The latent stream
    takes 2 bits/symbol (~5x a 0.45 bpp image's ~0.4), the hyperlatent
    stream `Z_SPILL_BITS` (a random-init factorized density needs ~5.3).
    The codec relaunches an encode that exceeds them with the reported
    demand as its caps."""
    return p * lanes * bits_per_symbol // 32 + 4096, 4 * p + 64


class EncodeTables(NamedTuple):
    """CDF rows for the encoder, int32, on one device."""
    cdf: torch.Tensor         # [rows, max_len]
    cdf_length: torch.Tensor  # [rows]
    cdf_offset: torch.Tensor  # [rows]


def encode_tables(cdf, cdf_length, cdf_offset, device=None) -> EncodeTables:
    """Checked host tables -> `EncodeTables` on `device`. Every row must
    hold a CDF of at most 16 bits with 3 <= cdf_length <= the row width (at
    least one tracked symbol beside the overflow code, so no frequency
    reaches 2^16), which keeps the kernel's gathers inside the table."""
    cdf = np.asarray(cdf)
    cdf_length = np.asarray(cdf_length)
    rows, max_len = cdf.shape
    if (cdf_length.shape != (rows,) or np.asarray(cdf_offset).shape != (rows,)
            or cdf_length.min() < 3 or cdf_length.max() > max_len
            or cdf.min() < 0 or cdf.max() > 1 << 16):
        raise ValueError("not a table of CDF rows of at most 16 bits")
    return EncodeTables(*(torch.from_numpy(
        np.ascontiguousarray(a, np.int64).astype(np.int32)).to(device)
        for a in (cdf, cdf_length, cdf_offset)))


class EncodePlan(NamedTuple):
    """Per-position push data of `prepare_encode`, all int64 [P, L] but
    the per-position [P] maxima."""
    starts: torch.Tensor
    freqs: torch.Tensor
    of: torch.Tensor        # bool: the lane emits an escape payload
    widths: torch.Tensor    # payload nibble count
    payload: torch.Tensor   # non-negative payload, < 2^32
    max_w: torch.Tensor     # [P]: nibble rounds of the position
    n_marker: torch.Tensor  # [P]: width-marker rounds of the position


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as two's-complement int32 arithmetic leaves them."""
    return ((x + (1 << 31)) & WORD) - (1 << 31)


def prepare_encode(sym_l, idx_l, tables: EncodeTables) -> EncodePlan:
    """Vectorized symbols -> pushes (`coding.py:_prepare` and the escape
    rounds' closed forms), as the JAX package's `prepare_encode` computes
    them in int32."""
    idx = idx_l.long()
    max_value = tables.cdf_length.long()[idx] - 2
    value = _wrap32(sym_l.long() - tables.cdf_offset.long()[idx])
    lower = value < 0
    upper = value >= max_value
    of = lower | upper
    payload = torch.where(lower, -2 * value - 1,
                          torch.where(upper, 2 * (value - max_value),
                                      torch.zeros_like(value))) & WORD
    value = torch.where(of, max_value, value)
    flat = tables.cdf.long().reshape(-1)
    base = idx * tables.cdf.shape[1] + value
    starts = flat[base]
    freqs = flat[base + 1] - starts
    # Nibbles of the payload: the count of j with payload >= 16^j.
    widths = sum((payload >= 1 << (4 * j)).long() for j in range(8))
    widths = torch.where(of, widths, torch.zeros_like(widths))
    any_of = of.any(dim=1)
    max_w = widths.amax(dim=1)
    n_marker = torch.where(any_of, (widths // 15).amax(dim=1) + 1,
                           torch.zeros_like(max_w))
    return EncodePlan(starts, freqs, of, widths, payload, max_w, n_marker)


class _Buffers:
    """The plain version's spill and event buffers and their cursors."""

    def __init__(self, spill_cap: int, lens_cap: int, device):
        self.spill = torch.zeros(spill_cap, dtype=torch.long, device=device)
        self.lens = torch.zeros(lens_cap, dtype=torch.long, device=device)
        self.s_cur = 0
        self.e_cur = 0

    def push(self, h, mask, x_max, starts, freqs, precision: int):
        """One push event on `mask` lanes: spills in lane order, then the
        state update. Writes past a capacity are dropped and counted."""
        sp = mask & (h >= x_max)
        n = int(sp.sum())
        if n:
            pos = self.s_cur + torch.cumsum(sp, 0) - 1
            keep = sp & (pos < self.spill.shape[0])
            self.spill[pos[keep]] = h[keep] & WORD
            h = torch.where(sp, h >> 32, h)
        if self.e_cur < self.lens.shape[0]:
            self.lens[self.e_cur] = n
        self.s_cur += n
        self.e_cur += 1
        pushed = ((h // freqs) << precision) + h % freqs + starts
        return torch.where(mask, pushed, h)


def encode_scan_reference(sym_l, idx_l, tables: EncodeTables,
                          spill_cap: int, lens_cap: int,
                          precision: int = 16):
    """The plain version of the kernel; returns what `encode_scan` does."""
    p, lanes = sym_l.shape
    device = sym_l.device
    buf = _Buffers(spill_cap, lens_cap, device)
    plan = prepare_encode(sym_l, idx_l, tables)
    n_marker, max_w = plan.n_marker.tolist(), plan.max_w.tolist()
    h = torch.full((lanes,), RANS_L, dtype=torch.long, device=device)
    every = torch.ones(lanes, dtype=torch.bool, device=device)
    one = torch.ones(lanes, dtype=torch.long, device=device)
    for i in range(p - 1, -1, -1):
        if n_marker[i]:
            of, widths, payload = plan.of[i], plan.widths[i], plan.payload[i]
            last_marker = (widths - 15 * (n_marker[i] - 1)).clamp(0, 15)
            for j in range(max_w[i] - 1, -1, -1):
                jj = torch.clamp(widths - 1, max=j).clamp_min(0)
                nib = (payload >> (4 * jj)) & MAX_OVERFLOW
                v = torch.where(widths > 0, nib, last_marker)
                h = buf.push(h, of, X_MAX_ESCAPE, v, one, OVERFLOW_WIDTH)
            for k in range(n_marker[i] - 1, -1, -1):
                m = (widths - 15 * k).clamp(0, 15)
                h = buf.push(h, of, X_MAX_ESCAPE, m, one, OVERFLOW_WIDTH)
        h = buf.push(h, every, plan.freqs[i] << (63 - precision),
                     plan.starts[i], plan.freqs[i], precision)
    heads = torch.stack([h >> 32, h & WORD]).to(torch.int64)
    counts = torch.tensor([buf.s_cur, buf.e_cur, 0], dtype=torch.long)
    return tuple(_wrap32(t).to(torch.int32).to(device)
                 for t in (heads, buf.spill, buf.lens, counts))


def encode_scan(sym_l, idx_l, tables: EncodeTables, spill_cap: int,
                lens_cap: int, precision: int = 16):
    """Encode laid-out (P, L) int32 symbols against the CDF rows idx_l.

    Returns int32 tensors of uint32 bits: (heads [2, L] (hi row, lo row),
    spill [spill_cap], lens [lens_cap], counts [3]): counts holds the spill
    and event cursors, which may exceed the caps (the caller MUST check
    them: `assemble_stream` reads the buffers only up to them), and the
    number of indices outside the tables' rows, which the kernel reads as
    row 0 (always 0 from the plain version, which raises on them instead).
    Relaunched with caps at least the reported cursors, it writes every
    word. CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    p, lanes = _check(sym_l, idx_l, tables, precision)
    if spill_cap < 1 or lens_cap < 1:
        raise ValueError("spill_cap and lens_cap must be positive")
    device = sym_l.device
    if device.type == "cpu":
        rows = tables.cdf.shape[0]
        if idx_l.numel() and (int(idx_l.min()) < 0
                              or int(idx_l.max()) >= rows):
            raise ValueError(f"CDF row index outside [0, {rows})")
        return encode_scan_reference(sym_l, idx_l, tables, spill_cap,
                                     lens_cap, precision)
    if device.type != "cuda":
        raise ValueError(f"no encode_scan for device {device}")
    heads = torch.empty((2, lanes), dtype=torch.int32, device=device)
    spill = torch.zeros(spill_cap, dtype=torch.int32, device=device)
    lens = torch.zeros(lens_cap, dtype=torch.int32, device=device)
    counts = torch.zeros(3, dtype=torch.int32, device=device)
    device_rans.ENCODE_KERNEL.launch(sym_l, idx_l, tables, precision, heads,
                                     spill, lens, counts)
    return heads, spill, lens, counts


def _check(sym_l, idx_l, tables: EncodeTables, precision: int):
    if not 1 <= precision <= 16:
        raise ValueError(f"precision must lie in [1, 16], got {precision}")
    if (sym_l.dim() != 2 or sym_l.shape != idx_l.shape
            or sym_l.dtype != torch.int32 or idx_l.dtype != torch.int32):
        raise ValueError("sym_l and idx_l must be int32 (positions, lanes) "
                         "tensors of one shape")
    p, lanes = sym_l.shape
    if not 1 <= lanes <= device_rans.MAX_LANES:
        raise ValueError(f"1 to {device_rans.MAX_LANES} lanes, got {lanes}")
    if not isinstance(tables, EncodeTables):
        raise ValueError("tables must come from encode_tables()")
    for name, t in (("sym_l", sym_l), ("idx_l", idx_l),
                    *zip(EncodeTables._fields, tables)):
        if t.device != sym_l.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {sym_l.device}")
    return p, lanes


def assemble_stream(heads, spill, lens, spill_count: int,
                    event_count: int) -> np.ndarray:
    """Host flatten: [head_hi | head_lo | spill chunks NEWEST first] (lane
    order kept within a chunk), exactly `ans.flatten_message`."""
    heads = np.asarray(heads).astype(np.uint32).reshape(-1)
    spill = np.asarray(spill).astype(np.uint32)[:spill_count]
    lens = np.asarray(lens).astype(np.uint32).astype(np.int64)[:event_count]
    if int(lens.sum()) != spill_count:
        raise ValueError("spill counts do not add up to the spill cursor")
    bounds = np.cumsum(lens)
    chunks = [spill[b - n:b] for b, n in zip(bounds, lens) if n]
    tail = (np.concatenate(chunks[::-1]) if chunks
            else np.zeros((0,), np.uint32))
    return np.concatenate([heads, tail])
