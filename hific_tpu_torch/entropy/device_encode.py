"""rANS encode on the device: the CUDA kernel `rans_encode` of
`csrc/rans_device.cu` and its plain PyTorch version.

Counterpart of the JAX package's `entropy/device_encode.py` (`encode_scan`,
an XLA scan with uint32-pair heads and long division, and `assemble_stream`,
its host flatten). Both write bit for bit the v1 stream of `coding.py` and
the native coder, so either decoder reads it. Positions are walked back to
front. Each push first spills the low words of the lanes whose head
h >= freq << (63 - precision), in lane order, and records that event's
count; then h = (h / freq) << precision + h % freq + start. A position's
escape pushes (freq 1 in a 4-bit identity CDF, spill threshold 2^59) come
before its main push: nibbles from high to low, then width markers from last
to first, in the closed forms the JAX package derived:
    marker round k:  clamp(width - 15 k, 0, 15)
    nibble round j:  width > 0 ? nibble(min(j, width - 1)) : last marker
The stream is [heads hi | heads lo | tail], the tail holding the spilled
words chunk by chunk, newest push event first, lane order kept within a
chunk. Writes past a buffer's capacity are dropped but counted, so the
caller sees the true demand and relaunches with buffers that hold it
(`codec.py`).

`encode_scan_many` codes a batch of streams, each with its own positions,
lanes, tables and capacities: one kernel launch for CUDA tensors, the plain
version, `encode_scan_reference`, stream by stream for CPU tensors.
`encode_scan` is a batch of one. The kernel maps symbols to pushes itself;
the plain version maps them with `prepare_encode`, the JAX package's
vectorized gathers and closed forms, and lays out the tail with
`assemble_stream`.
"""

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from hific_tpu_torch.entropy import device_rans
from hific_tpu_torch.entropy.rans_tables import RansTables

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


class EncodeJob(NamedTuple):
    """One stream of a batch: int32 (P, L) symbols and CDF rows, the
    tables (`rans_tables(...).to(device)`) and the tail's and the event
    counts' capacities."""
    sym_l: torch.Tensor
    idx_l: torch.Tensor
    tables: RansTables
    spill_cap: int
    lens_cap: int


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


def prepare_encode(sym_l, idx_l, tables: RansTables) -> EncodePlan:
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


class _Spills:
    """The plain version's push events: each event's spilled words (lane
    order) and count, in push order, none dropped."""

    def __init__(self):
        self.chunks: List[torch.Tensor] = []
        self.lens: List[int] = []

    def push(self, h, mask, x_max, starts, freqs, precision: int):
        """One push event on `mask` lanes: spills in lane order, then the
        state update."""
        sp = mask & (h >= x_max)
        self.chunks.append(h[sp] & WORD)
        self.lens.append(int(sp.sum()))
        h = torch.where(sp, h >> 32, h)
        pushed = ((h // freqs) << precision) + h % freqs + starts
        return torch.where(mask, pushed, h)


def encode_scan_reference(sym_l, idx_l, tables: RansTables, spill_cap: int,
                          lens_cap: int):
    """The plain version of the kernel for one stream; returns what
    `encode_scan` does."""
    p, lanes = sym_l.shape
    device = sym_l.device
    precision = tables.precision
    spills = _Spills()
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
                h = spills.push(h, of, X_MAX_ESCAPE, v, one, OVERFLOW_WIDTH)
            for k in range(n_marker[i] - 1, -1, -1):
                m = (widths - 15 * k).clamp(0, 15)
                h = spills.push(h, of, X_MAX_ESCAPE, m, one, OVERFLOW_WIDTH)
        h = spills.push(h, every, plan.freqs[i] << (63 - precision),
                        plan.starts[i], plan.freqs[i], precision)
    n_spilled, n_events = sum(spills.lens), len(spills.lens)
    spill = (torch.cat(spills.chunks) if spills.chunks
             else torch.zeros(0, dtype=torch.long)).cpu().numpy()
    whole = assemble_stream(torch.stack([h >> 32, h & WORD]).cpu().numpy(),
                            spill, np.asarray(spills.lens, np.int64),
                            n_spilled, n_events)
    stream = np.zeros(2 * lanes + spill_cap, np.uint32)
    kept = whole[:len(stream)]
    stream[:len(kept)] = kept
    lens = np.zeros(lens_cap, np.uint32)
    kept = np.asarray(spills.lens[:lens_cap], np.uint32)
    lens[:len(kept)] = kept
    counts = np.asarray([n_spilled, n_events, 0], np.uint32)
    return tuple(torch.from_numpy(a.view(np.int32)).to(device)
                 for a in (stream, lens, counts))


def encode_scan_many(jobs: List[EncodeJob]):
    """Encode a batch of laid-out (P, L) int32 symbol planes, each against
    its CDF rows.

    Returns, per job, int32 tensors of uint32 bits: (stream [2 L +
    spill_cap]: heads hi (L), heads lo (L), then the tail, newest chunk
    first, zero past its end; lens [lens_cap]: each push event's spill
    count in push order; counts [3]: the tail's length and the event count,
    which may exceed the caps (the caller MUST check them: past a cap the
    buffers hold a prefix), and the number of indices outside the tables'
    rows, which the kernel reads as row 0 (always 0 from the plain version,
    which raises on them instead)). Relaunched with caps at least the
    reported counts, a job writes every word. CUDA tensors launch the kernel
    once for the batch; CPU tensors run the plain version."""
    jobs = [EncodeJob(*job) for job in jobs]
    if not jobs:
        return []
    device = jobs[0].sym_l.device
    for job in jobs:
        _check(job, device)
    if len({job.tables.precision for job in jobs}) != 1:
        raise ValueError("one precision for every stream of a batch")
    if device.type == "cpu":
        for job in jobs:
            rows = job.tables.rows
            if job.idx_l.numel() and (int(job.idx_l.min()) < 0
                                      or int(job.idx_l.max()) >= rows):
                raise ValueError(f"CDF row index outside [0, {rows})")
        return [encode_scan_reference(*job) for job in jobs]
    if device.type != "cuda":
        raise ValueError(f"no encode_scan for device {device}")
    outs = [(torch.zeros(2 * job.sym_l.shape[1] + job.spill_cap,
                         dtype=torch.int32, device=device),
             torch.zeros(job.lens_cap, dtype=torch.int32, device=device),
             torch.zeros(3, dtype=torch.int32, device=device))
            for job in jobs]
    device_rans.ENCODE_KERNEL.launch(jobs, outs)
    return outs


def encode_scan(sym_l, idx_l, tables: RansTables, spill_cap: int,
                lens_cap: int):
    """`encode_scan_many` of one stream: (stream, lens, counts)."""
    return encode_scan_many([EncodeJob(sym_l, idx_l, tables, spill_cap,
                                       lens_cap)])[0]


def _check(job: EncodeJob, device) -> None:
    sym_l, idx_l, tables = job.sym_l, job.idx_l, job.tables
    if (sym_l.dim() != 2 or sym_l.shape != idx_l.shape
            or sym_l.dtype != torch.int32 or idx_l.dtype != torch.int32):
        raise ValueError("sym_l and idx_l must be int32 (positions, lanes) "
                         "tensors of one shape")
    lanes = sym_l.shape[1]
    if not 1 <= lanes <= device_rans.MAX_LANES:
        raise ValueError(f"1 to {device_rans.MAX_LANES} lanes, got {lanes}")
    if job.spill_cap < 1 or job.lens_cap < 1:
        raise ValueError("spill_cap and lens_cap must be positive")
    if not isinstance(tables, RansTables):
        raise ValueError("tables must come from rans_tables()")
    for name, t in (("sym_l", sym_l), ("idx_l", idx_l),
                    ("tables.blob", tables.blob), ("tables.cdf", tables.cdf)):
        if (not isinstance(t, torch.Tensor) or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous tensor on "
                             f"{device}")


def assemble_stream(heads, spill, lens, spill_count: int,
                    event_count: int) -> np.ndarray:
    """Host flatten: [head_hi | head_lo | spill chunks NEWEST first] (lane
    order kept within a chunk), exactly `ans.flatten_message`; the plain
    version of the kernel's scatter."""
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
