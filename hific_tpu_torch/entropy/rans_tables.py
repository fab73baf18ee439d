"""CDF tables of the device rANS coders, packed for shared memory.

One blob of uint32 words per table set (the latent scale tables, or a
hyperlatent density's), read by both kernels of `csrc/rans_device.cu`:

    row meta     int32 [rows, 4]: (cdf start, cdf_length, cdf_offset,
                 bucket start), the starts in 16-bit entries of their areas
    CDF area     uint16, the rows' CDFs back to back, cdf_length entries
                 each; the last entry, 2^16, is stored as 0 (a frequency is
                 read as (next - start) mod 2^16)
    bucket area  uint16, (1 << (precision - shift)) + 1 entries a row:
                 entry b < 2^(precision - shift) is the symbol of
                 cf = b << shift, the last one the symbol of the largest cf

The y scale tables take 13,014 CDF entries (26 KB) and, at shift 6, 128 KB
of buckets: both fit in a block's shared memory, where the decoder looks a
symbol up among its bucket's candidates, from the bucket's symbol to the
next bucket's, by a binary search (`table_lookup` is its plain version).
The encoder stages the meta and CDF areas only. A blob is padded to a
multiple of 4 words.

Beside the blob a table set keeps the rows it was packed from and their
inverse table (`coding.build_inverse_table`), the plain versions' input:
the plain decoder looks symbols up there, not through the blob.
"""

from typing import NamedTuple

import numpy as np
import torch

from hific_tpu_torch.entropy.coding import build_inverse_table

# Shared memory left for a decode table beside the kernel's slots and its
# ring of tail words (rans_device.cu: kMaxSharedBytes, kRing).
DECODE_TABLE_BUDGET_WORDS = (232448 - 4 * 4 * 32) // 4 - 4096


class RansTables(NamedTuple):
    """A packed table set: the blob and the padded rows it was built from
    (the plain versions' input), numpy as built or tensors after `to`; the
    inverse table stays a numpy array on the host."""
    blob: object        # int32 [words]: the uint32 words above
    cdf: object         # int32 [rows, max_len], as built by tables.py
    cdf_length: object  # int32 [rows]
    cdf_offset: object  # int32 [rows]
    inverse: np.ndarray  # int32 [rows, 2^precision]: cf -> symbol
    precision: int
    shift: int          # bucket width 2^shift cumulative frequencies
    cdf_word: int       # word offset of the CDF area
    bucket_word: int    # word offset of the bucket area
    encode_words: int   # words the encoder stages (meta + CDF area, padded)
    search_steps: int   # the longest binary search of any bucket

    @property
    def rows(self) -> int:
        return int(self.cdf.shape[0])

    def to(self, device) -> "RansTables":
        return self._replace(**{
            name: torch.as_tensor(np.asarray(getattr(self, name))).to(device)
            for name in ("blob", "cdf", "cdf_length", "cdf_offset")})


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def rans_tables(cdf, cdf_length, cdf_offset, precision: int = 16,
                budget_words: int = DECODE_TABLE_BUDGET_WORDS,
                inverse=None) -> RansTables:
    """Pack checked host CDF rows. Each row holds a CDF of `precision` bits
    with 3 <= cdf_length <= the row width (at least one tracked symbol
    beside the overflow code) and no frequency of 2^16, which keeps the
    kernels' reads inside the table. The bucket shift is the smallest whose
    blob fits in `budget_words` (the whole blob then goes to shared memory),
    or `precision` if none does. `inverse`: the rows' inverse table where
    the caller holds it (built here otherwise)."""
    cdf = np.asarray(cdf).astype(np.int64)
    cdf_length = np.asarray(cdf_length).astype(np.int64)
    cdf_offset = np.asarray(cdf_offset).astype(np.int64)
    rows, max_len = cdf.shape
    if not 1 <= precision <= 16:
        raise ValueError(f"precision must lie in [1, 16], got {precision}")
    if (rows < 1 or cdf_length.shape != (rows,)
            or cdf_offset.shape != (rows,) or cdf_length.min() < 3
            or cdf_length.max() > max_len or cdf.min() < 0
            or cdf.max() > 1 << precision):
        raise ValueError("not a table of CDF rows of at most "
                         f"{precision} bits")
    total = 1 << precision
    valid = np.arange(max_len)[None, :] < cdf_length[:, None]
    diffs = np.diff(cdf, axis=1)
    inside = valid[:, 1:]
    if (diffs[inside] < 0).any() or (diffs[inside] >= 1 << 16).any():
        raise ValueError("CDF rows must be non-decreasing, with no "
                         "frequency of 2^16")
    cdf_start = np.concatenate([[0], np.cumsum(cdf_length)[:-1]])
    flat = (cdf[valid] & 0xFFFF).astype(np.uint16)
    meta_words = 4 * rows
    cdf_words = -(-len(flat) // 2)
    for shift in range(precision + 1):
        per_row = (total >> shift) + 1
        words = _pad4(meta_words + cdf_words + -(-rows * per_row // 2))
        if words <= budget_words:
            break
    cf = np.minimum(np.arange(per_row, dtype=np.int64) << shift, total - 1)
    buckets = np.stack([
        np.searchsorted(cdf[r, :cdf_length[r]], cf, side="right") - 1
        for r in range(rows)])
    bucket_start = np.arange(rows, dtype=np.int64) * per_row
    # The longest search: ceil(log2(candidates)) of the widest bucket.
    span = int((buckets[:, 1:] - buckets[:, :-1]).max()) + 1
    search_steps = int(np.ceil(np.log2(span))) if span > 1 else 0

    blob = np.zeros(_pad4(meta_words + cdf_words + -(-buckets.size // 2)),
                    np.uint32)
    blob[:meta_words] = np.stack(
        [cdf_start, cdf_length, cdf_offset, bucket_start], axis=1
    ).astype(np.int32).view(np.uint32).reshape(-1)
    halves = blob.view(np.uint16)
    halves[2 * meta_words:2 * meta_words + len(flat)] = flat
    bucket_word = meta_words + cdf_words
    halves[2 * bucket_word:2 * bucket_word + buckets.size] = \
        buckets.astype(np.uint16).reshape(-1)
    if inverse is None:
        inverse = build_inverse_table(cdf, cdf_length, precision)
    inverse = np.asarray(inverse)
    if inverse.shape != (rows, total) or inverse.dtype != np.int32:
        raise ValueError(f"inverse must be int32 [{rows}, {total}]")
    return RansTables(
        blob=blob.view(np.int32), cdf=cdf.astype(np.int32),
        cdf_length=cdf_length.astype(np.int32),
        cdf_offset=cdf_offset.astype(np.int32), inverse=inverse,
        precision=precision, shift=shift, cdf_word=meta_words, bucket_word=bucket_word,
        encode_words=_pad4(bucket_word), search_steps=search_steps)


def table_lookup(tables: RansTables, rows: torch.Tensor, cf: torch.Tensor):
    """The plain version of the decoder's lookup: (symbol, start, freq) of
    cumulative frequency `cf` in CDF row `rows`, through the blob's bucket
    index and a binary search over its candidates, step for step as the
    kernel does."""
    blob = torch.as_tensor(tables.blob)
    meta = blob[:4 * tables.rows].long().view(tables.rows, 4)
    halves = blob.view(torch.int16).long() & 0xFFFF
    cdf = halves[2 * tables.cdf_word:2 * tables.bucket_word]
    buckets = halves[2 * tables.bucket_word:]
    rows, cf = rows.long(), cf.long()
    at = meta[rows, 3] + (cf >> tables.shift)
    lo, hi = buckets[at], buckets[at + 1]
    base = meta[rows, 0]
    for _ in range(tables.search_steps):
        mid = (lo + hi + 1) >> 1
        active = lo < hi
        le = cdf[base + torch.where(active, mid, lo)] <= cf
        lo = torch.where(active & le, mid, lo)
        hi = torch.where(active & ~le, mid - 1, hi)
    start = cdf[base + lo]
    return lo, start, (cdf[base + lo + 1] - start) & 0xFFFF
