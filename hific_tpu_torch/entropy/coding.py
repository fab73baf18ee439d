"""Indexed rANS coding with unbounded-overflow escape codes (host-side).

This package's own copy of the JAX package's `entropy/coding.py`: the
vectorized coder, the lane-sharded coder of container v2 and the scalar
coder. tests/test_torch_entropy.py and tests/test_torch_coders.py hold
their bytes equal to that package's (golden hash included).

Codes integer symbol tensors against per-element CDF rows selected by an
`indices` tensor. Values inside a row's tracked range [offset, offset + m -
2) are ANS-coded with the row CDF; values outside emit the row's overflow
code followed by a variable-length sequence of `OVERFLOW_WIDTH`-bit nibbles.
The vectorized coder runs one rANS lane per channel, looping over spatial
positions (batch 1), or one lane per (C, H, W) element looping over the
batch (batch > 1). The sharded coder splits those lanes into K contiguous
groups, each coded to a stream of its own in a host thread. The scalar
coder is one lane over every element: the smallest stream, fully serial.
Each runs the native `rans.cc` unless HIFIC_TPU_TORCH_NATIVE=0 selects the
numpy version; both write the same bytes.

Symbol lookup on decode is O(1) via precomputed inverse tables (cum_freq ->
symbol, 2^precision entries per row). The encoder runs the position loop
backward, pushing directly into the rANS state.
"""

from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

from hific_tpu_torch.entropy import ans, native

OVERFLOW_WIDTH = 4
MAX_OVERFLOW = (1 << OVERFLOW_WIDTH) - 1


def build_inverse_table(cdf: np.ndarray, cdf_length: np.ndarray,
                        precision: int) -> np.ndarray:
    """Map cumulative frequency -> symbol for each CDF row.

    Returns int32 [n_rows, 2**precision]; row r maps cf to the s with
    cdf[r, s] <= cf < cdf[r, s+1]. Decode becomes a gather.
    """
    n_rows, _ = cdf.shape
    size = 1 << precision
    inv = np.zeros((n_rows, size), dtype=np.int32)
    for r in range(n_rows):
        row = cdf[r, : cdf_length[r]].astype(np.int64)
        # np.diff(row) are the frequencies; repeat each symbol freq times.
        freqs = np.diff(row)
        inv[r] = np.repeat(np.arange(len(freqs), dtype=np.int32), freqs)
    return inv


def _nibble_widths(overflow: np.ndarray) -> np.ndarray:
    """Number of OVERFLOW_WIDTH-bit nibbles needed per value (0 for 0)."""
    overflow = overflow.astype(np.int64)
    widths = np.zeros(overflow.shape, dtype=np.int64)
    shifted = overflow.copy()
    while np.any(shifted != 0):
        widths += shifted != 0
        shifted >>= OVERFLOW_WIDTH
    return widths


def _prepare(symbols, indices, cdf, cdf_length, cdf_offset):
    """Shared symbol -> (in-range value, overflow payload) mapping."""
    symbols = symbols.astype(np.int64)
    indices = indices.astype(np.int64)

    max_value = cdf_length[indices].astype(np.int64) - 2
    values = symbols - cdf_offset[indices].astype(np.int64)

    overflow = np.zeros_like(values)
    lower = values < 0
    upper = values >= max_value
    overflow = np.where(lower, -2 * values - 1, overflow)
    overflow = np.where(upper, 2 * (values - max_value), overflow)
    values = np.where(lower | upper, max_value, values)
    return values, overflow, max_value


def _lane_layout(x: np.ndarray) -> np.ndarray:
    """(1,C,H,W) -> (H*W, C): loop over spatial positions, lanes = channels
    (the reference's PATCH_SIZE=(1,1) decomposition)."""
    _, c, h, w = x.shape
    return x[0].transpose(1, 2, 0).reshape(h * w, c)


def _lane_unlayout(flat: np.ndarray, shape) -> np.ndarray:
    _, c, h, w = shape
    return flat.reshape(h, w, c).transpose(2, 0, 1)[None]


def _gather_start_freq(cdf_rows, values):
    """cdf_rows: (..., L) uint; values: (...) int -> (start, freq) uint64."""
    lower = np.take_along_axis(cdf_rows, values[..., None], axis=-1)[..., 0]
    upper = np.take_along_axis(cdf_rows, values[..., None] + 1, axis=-1)[..., 0]
    return lower.astype(np.uint64), (upper - lower).astype(np.uint64)


def _push_masked(msg, starts, freqs, precision, mask):
    """rANS push restricted to lanes where mask is True."""
    sub = ans.Message(msg.head[mask], stack=msg.stack)
    ans.rans_push(sub, starts, freqs, precision)
    head = msg.head.copy()
    head[mask] = sub.head
    msg.head = head
    msg.stack = sub.stack


def _pop_masked(msg, precision, mask):
    """rANS pop (identity CDF: symbol == cum_freq, freq 1) on masked lanes."""
    sub = ans.Message(msg.head[mask], stack=msg.stack, cursor=msg.cursor)
    cf, complete = ans.rans_pop(sub, precision)
    complete(cf, np.ones_like(cf))
    head = msg.head.copy()
    head[mask] = sub.head
    msg.head = head
    msg.stack = sub.stack
    msg.cursor = sub.cursor
    return cf.astype(np.int64)


def _encode_overflow_position(msg, overflow_i, widths_i, of_mask):
    """Push one position's overflow payload (reverse of decode order).

    Decode order: width marker round(s), then nibble rounds j=0..max_w-1,
    every round over ALL overflow lanes of this position (lanes whose
    payload is exhausted re-push their stale value, matching the reference
    lane protocol). Pushed here in reverse: nibbles high->low, then markers
    last->first.
    """
    ow = np.uint64(OVERFLOW_WIDTH)
    of_overflow = overflow_i[of_mask].astype(np.uint64)
    of_widths = widths_i[of_mask]

    # Width markers, generation order: m_k = min(remaining, 15) until all
    # lanes are done and no round emitted a 15 (decode's continue signal).
    rem = of_widths.copy()
    marker_rounds = []
    while True:
        m = np.minimum(rem, MAX_OVERFLOW)
        marker_rounds.append(m.astype(np.uint64))
        rem = rem - m
        if not np.any(rem > 0) and not np.any(m >= MAX_OVERFLOW):
            break

    # Nibble rounds, generation order. `val` carries the stale value for
    # exhausted lanes (initially the last marker each lane popped).
    val = marker_rounds[-1].copy()
    nibble_rounds = []
    for j in range(int(of_widths.max()) if of_widths.size else 0):
        nib = (of_overflow >> (ow * np.uint64(j))) & np.uint64(MAX_OVERFLOW)
        val = np.where(of_widths > j, nib, val)
        nibble_rounds.append(val.copy())

    for val_j in reversed(marker_rounds + nibble_rounds):
        _push_masked(msg, val_j, np.ones_like(val_j, np.uint64),
                     OVERFLOW_WIDTH, of_mask)


def _encode_layout(sym_l, idx_l, cdf, cdf_length, cdf_offset, precision
                   ) -> np.ndarray:
    """Encode laid-out (n_pos, n_lanes) symbols/indices to one uint32
    stream: the native coder unless HIFIC_TPU_TORCH_NATIVE=0."""
    if native.enabled():
        return native.encode_lanes(sym_l, idx_l, cdf, cdf_length, cdf_offset,
                                   precision)
    values_l, overflow_l, max_value_l = _prepare(sym_l, idx_l, cdf,
                                                 cdf_length, cdf_offset)
    indices_l = idx_l.astype(np.int64)

    # Fully vectorized start/freq for the main symbols.
    cdf_rows = cdf[indices_l]                    # (P, lanes, L)
    starts, freqs = _gather_start_freq(cdf_rows, values_l)
    of_masks = values_l == max_value_l           # lanes emitting overflow
    widths = _nibble_widths(overflow_l)

    msg = ans.empty_message(values_l.shape[1:])
    # LIFO: walk positions backward, pushing each position's instructions in
    # reverse (overflow payload first, then the symbol).
    for i in range(values_l.shape[0] - 1, -1, -1):
        of_mask = of_masks[i]
        if np.any(of_mask):
            _encode_overflow_position(msg, overflow_l[i], widths[i], of_mask)
        ans.rans_push(msg, starts[i], freqs[i], precision)

    return ans.flatten_message(msg)


def _check_indices(indices: np.ndarray, n_rows: int) -> None:
    """The native coder indexes tables with these unchecked: check first."""
    if indices.size and (indices.min() < 0 or indices.max() >= n_rows):
        raise ValueError(f"CDF row index outside [0, {n_rows})")


def _layout(symbols, indices):
    """(N,C,H,W) -> laid-out (n_pos, n_lanes) pair + coding_shape."""
    n, c = symbols.shape[:2]
    if n == 1:
        return (_lane_layout(symbols), _lane_layout(indices), (c, 1, 1))
    return (symbols.reshape(n, -1), indices.reshape(n, -1), symbols.shape[1:])


def encode_indexed(symbols, indices, cdf, cdf_length, cdf_offset, precision
                   ) -> Tuple[np.ndarray, tuple]:
    """Vectorized encode of (N,C,H,W) int symbols. Returns (uint32 stream,
    coding_shape)."""
    symbols = np.asarray(symbols)
    indices = np.asarray(indices)
    cdf = np.asarray(cdf, dtype=np.uint32)
    if symbols.shape != indices.shape:
        raise ValueError(f"symbols {symbols.shape} and indices "
                         f"{indices.shape} differ in shape")
    _check_indices(indices, cdf.shape[0])
    sym_l, idx_l, coding_shape = _layout(symbols, indices)
    return (_encode_layout(sym_l, idx_l, cdf, cdf_length, cdf_offset,
                           precision), coding_shape)


def _decode_layout(encoded, idx_l, cdf, cdf_length, cdf_offset, precision,
                   inverse_table) -> np.ndarray:
    """Decode one stream against laid-out (n_pos, n_lanes) indices."""
    if native.enabled():
        return native.decode_lanes(encoded, idx_l, cdf, cdf_length,
                                   cdf_offset, inverse_table, precision)
    indices_l = idx_l.astype(np.int64)
    max_values = cdf_length[indices_l].astype(np.int64) - 2
    offsets = cdf_offset[indices_l].astype(np.int64)
    msg = ans.unflatten_message(encoded, (indices_l.shape[1],))

    decoded = np.empty_like(indices_l)
    ow = OVERFLOW_WIDTH
    for i in range(indices_l.shape[0]):
        idx_i = indices_l[i]
        cf, complete = ans.rans_pop(msg, precision)
        value = inverse_table[idx_i, cf.astype(np.int64)].astype(np.int64)
        starts, freqs = _gather_start_freq(cdf[idx_i], value)
        complete(starts, freqs)

        max_value_i = max_values[i]
        of_mask = value == max_value_i
        if np.any(of_mask):
            val = _pop_masked(msg, ow, of_mask)
            widths = val.copy()
            while np.any(val == MAX_OVERFLOW):
                val = _pop_masked(msg, ow, of_mask)
                widths = widths + val
            overflow = np.zeros_like(val)
            max_w = int(widths.max())
            for j in range(max_w):
                val = _pop_masked(msg, ow, of_mask)
                overflow = np.where(widths > j,
                                    overflow | (val << (j * ow)), overflow)
            # Map non-negative payload back to signed value.
            of_value = overflow >> 1
            of_value = np.where(overflow & 1, -of_value - 1,
                                of_value + max_value_i[of_mask])
            value[of_mask] = of_value
        decoded[i] = value + offsets[i]
    return decoded


def decode_indexed(encoded, indices, cdf, cdf_length, cdf_offset, precision,
                   inverse_table=None) -> np.ndarray:
    """Vectorized decode; `indices` must match the encoder's. Returns int32
    symbols shaped like `indices`."""
    indices = np.asarray(indices)
    cdf = np.asarray(cdf, dtype=np.uint32)
    if inverse_table is None:
        inverse_table = build_inverse_table(cdf, cdf_length, precision)
    _check_indices(indices, cdf.shape[0])

    n = indices.shape[0]
    idx_l = _lane_layout(indices) if n == 1 else indices.reshape(n, -1)
    decoded = _decode_layout(encoded, idx_l, cdf, cdf_length, cdf_offset,
                             precision, inverse_table)
    if n == 1:
        return _lane_unlayout(decoded, indices.shape).astype(np.int32)
    return decoded.reshape(indices.shape).astype(np.int32)


def map_threads(fn, items, threads: int) -> list:
    """`fn` over `items` in order, in a pool of `threads` host threads that
    is closed before this returns (in the caller's thread where `threads`
    is 1). The native coder releases the interpreter lock while it runs."""
    items = list(items)
    if threads <= 1 or len(items) <= 1:
        return [fn(item) for item in items]
    with ThreadPoolExecutor(max_workers=min(threads, len(items))) as pool:
        return list(pool.map(fn, items))


# --------------------------------------------------------------------------
# Lane-sharded coding (container v2 payloads).
#
# The rANS lanes (channels at batch 1) are independent except for the
# shared spill stack, so K contiguous groups of them, each coded to a stream
# of its own, code in parallel host threads with a few words of overhead a
# shard. The payload:
#
#   uint32 K | uint32 len_0 .. len_{K-1} | stream_0 | ... | stream_{K-1}
#
# Each stream_k is the vectorized coder's stream of that lane group alone.
# --------------------------------------------------------------------------


def _lane_splits(n_lanes: int, shards: int):
    """K = min(shards, n_lanes) contiguous lane groups. Integer arithmetic
    only: the bounds are part of the persisted format (the decoder derives
    them again from K), so they must not depend on float rounding."""
    shards = max(1, min(int(shards), n_lanes))
    bounds = [k * n_lanes // shards for k in range(shards + 1)]
    return [(bounds[k], bounds[k + 1]) for k in range(shards)]


def encode_indexed_sharded(symbols, indices, cdf, cdf_length, cdf_offset,
                           precision, shards: int
                           ) -> Tuple[np.ndarray, tuple]:
    """Encode with the lanes sharded into `shards` streams, coded in a pool
    of host threads. Returns (self-describing uint32 payload,
    coding_shape)."""
    symbols = np.asarray(symbols)
    indices = np.asarray(indices)
    cdf = np.asarray(cdf, dtype=np.uint32)
    if symbols.shape != indices.shape:
        raise ValueError(f"symbols {symbols.shape} and indices "
                         f"{indices.shape} differ in shape")
    _check_indices(indices, cdf.shape[0])
    sym_l, idx_l, coding_shape = _layout(symbols, indices)
    splits = _lane_splits(sym_l.shape[1], shards)

    def one(span):
        lo, hi = span
        return _encode_layout(np.ascontiguousarray(sym_l[:, lo:hi]),
                              np.ascontiguousarray(idx_l[:, lo:hi]),
                              cdf, cdf_length, cdf_offset, precision)

    streams = map_threads(one, splits, len(splits))
    header = np.array([len(streams)] + [len(s) for s in streams], np.uint32)
    return np.concatenate([header] + streams), coding_shape


def decode_indexed_sharded(encoded, indices, cdf, cdf_length, cdf_offset,
                           precision, inverse_table=None) -> np.ndarray:
    """Decode a sharded payload. The shard count is read from the payload
    and the lane split derived from it, so any codec decodes any shard
    count."""
    indices = np.asarray(indices)
    cdf = np.asarray(cdf, dtype=np.uint32)
    if inverse_table is None:
        inverse_table = build_inverse_table(cdf, cdf_length, precision)
    _check_indices(indices, cdf.shape[0])

    encoded = np.asarray(encoded, np.uint32)
    if encoded.size < 1:
        raise ValueError("corrupt sharded payload: empty")
    k = int(encoded[0])
    n = indices.shape[0]
    idx_l = _lane_layout(indices) if n == 1 else indices.reshape(n, -1)
    n_lanes = idx_l.shape[1]
    if not 1 <= k <= n_lanes:
        raise ValueError(
            f"corrupt sharded payload: shard count {k} not in [1, {n_lanes}]")
    if encoded.size < 1 + k:
        raise ValueError("corrupt sharded payload: truncated shard-length header")
    lens = encoded[1:1 + k].astype(np.int64)
    if 1 + k + int(lens.sum()) != encoded.size:
        raise ValueError(
            f"corrupt sharded payload: header promises {1 + k + int(lens.sum())}"
            f" words, payload has {encoded.size}")
    offs = np.concatenate([[1 + k], 1 + k + np.cumsum(lens)]).astype(np.int64)

    def one(job):
        (lo, hi), stream = job
        return _decode_layout(stream, np.ascontiguousarray(idx_l[:, lo:hi]),
                              cdf, cdf_length, cdf_offset, precision,
                              inverse_table)

    jobs = [(span, encoded[offs[i]:offs[i + 1]])
            for i, span in enumerate(_lane_splits(n_lanes, k))]
    decoded = np.concatenate(map_threads(one, jobs, k), axis=1)
    if n == 1:
        return _lane_unlayout(decoded, indices.shape).astype(np.int32)
    return decoded.reshape(indices.shape).astype(np.int32)


# --------------------------------------------------------------------------
# The scalar coder: one lane over every element, in (N, C, H, W) order.
# --------------------------------------------------------------------------


def encode_indexed_scalar(symbols, indices, cdf, cdf_length, cdf_offset,
                          precision) -> Tuple[np.ndarray, tuple]:
    """Scalar encode of (N, C, H, W) int symbols. Returns (uint32 stream,
    coding_shape (C, H, W)); the native coder runs it as one lane of N C H W
    positions, the same pushes in the same order."""
    symbols = np.asarray(symbols)
    indices = np.asarray(indices)
    cdf = np.asarray(cdf, dtype=np.uint32)
    if symbols.shape != indices.shape:
        raise ValueError(f"symbols {symbols.shape} and indices "
                         f"{indices.shape} differ in shape")
    _check_indices(indices, cdf.shape[0])
    coding_shape = symbols.shape[1:]
    if native.enabled():
        return native.encode_lanes(symbols.reshape(-1, 1),
                                   indices.reshape(-1, 1), cdf, cdf_length,
                                   cdf_offset, precision), coding_shape
    values, overflow, max_value = _prepare(symbols, indices, cdf, cdf_length,
                                           cdf_offset)
    values_f = values.reshape(-1)
    overflow_f = overflow.reshape(-1)
    indices_f = indices.reshape(-1).astype(np.int64)
    max_value_f = max_value.reshape(-1)
    widths_f = _nibble_widths(overflow_f)

    msg = ans.empty_message(())
    one = np.uint64(1)
    for i in range(len(values_f) - 1, -1, -1):
        v = int(values_f[i])
        if v == max_value_f[i]:  # overflow payload, pushed in reverse
            w = int(widths_f[i])
            ov = int(overflow_f[i])
            for j in range(w - 1, -1, -1):
                nib = (ov >> (j * OVERFLOW_WIDTH)) & MAX_OVERFLOW
                ans.rans_push(msg, np.uint64(nib), one, OVERFLOW_WIDTH)
            rem = w
            markers = []
            while rem >= MAX_OVERFLOW:
                markers.append(MAX_OVERFLOW)
                rem -= MAX_OVERFLOW
            markers.append(rem)
            for m in reversed(markers):
                ans.rans_push(msg, np.uint64(m), one, OVERFLOW_WIDTH)
        row = cdf[indices_f[i]]
        ans.rans_push(msg, np.uint64(row[v]), np.uint64(row[v + 1] - row[v]),
                      precision)
    return ans.flatten_message(msg), coding_shape


def decode_indexed_scalar(encoded, indices, cdf, cdf_length, cdf_offset,
                          precision, inverse_table=None) -> np.ndarray:
    """Scalar decode; `indices` must match the encoder's. Returns int32
    symbols shaped like `indices`."""
    indices = np.asarray(indices)
    cdf = np.asarray(cdf, dtype=np.uint32)
    if inverse_table is None:
        inverse_table = build_inverse_table(cdf, cdf_length, precision)
    _check_indices(indices, cdf.shape[0])
    indices_f = indices.reshape(-1).astype(np.int64)
    if native.enabled():
        decoded = native.decode_lanes(encoded, indices_f.reshape(-1, 1), cdf,
                                      cdf_length, cdf_offset, inverse_table,
                                      precision)
        return decoded.reshape(indices.shape).astype(np.int32)
    msg = ans.unflatten_message_scalar(encoded)
    decoded = np.empty(len(indices_f), dtype=np.int64)
    one = np.uint64(1)

    def pop_nibble() -> int:
        cf, complete = ans.rans_pop(msg, OVERFLOW_WIDTH)
        complete(cf, one)
        return int(cf)

    for i in range(len(indices_f)):
        idx = indices_f[i]
        cf, complete = ans.rans_pop(msg, precision)
        value = int(inverse_table[idx, int(cf)])
        row = cdf[idx]
        complete(np.uint64(row[value]), np.uint64(row[value + 1] - row[value]))
        max_value = int(cdf_length[idx]) - 2
        if value == max_value:
            val = pop_nibble()
            widths = val
            while val == MAX_OVERFLOW:
                val = pop_nibble()
                widths += val
            ov = 0
            for j in range(widths):
                ov |= pop_nibble() << (j * OVERFLOW_WIDTH)
            value = ov >> 1
            value = -value - 1 if ov & 1 else value + max_value
        decoded[i] = value + cdf_offset[idx]
    return decoded.reshape(indices.shape).astype(np.int32)
