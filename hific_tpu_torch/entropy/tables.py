"""Probability tables for the entropy coders; counterpart of the JAX
package's `entropy/tables.py`.

- `build_factorized_tables`: per-channel quantized CDFs of the learned
  hyperlatent density, between tails found by `host_math.factorized_tails`
  (the JAX package's `estimate_tails` search in its float32 arithmetic).
  `check_factorized_channels` refuses the one channel count (1) whose
  search it does not reproduce.
- `build_scale_tables`: one CDF row per entry of the log-spaced scale table
  of the conditional latent prior.
"""

from typing import Callable, NamedTuple

import numpy as np

from hific_tpu_torch.entropy.coding import build_inverse_table
from hific_tpu_torch.models.density import PRECISION_P, TAIL_MASS
from hific_tpu_torch.ops.maths import pmf_to_quantized_cdf

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def check_factorized_channels(n_channels: int) -> None:
    """Raise for a hyperlatent density of one channel: XLA compiles its
    tail search to another program (the products become fusions of their
    own), which `host_math.factorized_tails` does not follow, so its tails
    could differ from the JAX package's in their last bits, and so could
    the tables. Refused rather than written differently; the open item is
    ROADMAP.md section 3."""
    if n_channels < 2:
        raise ValueError(
            f"factorized tables of {n_channels} hyperlatent channel: the "
            f"tail search of a one-channel density is not followed, so its "
            f"tables could differ from the JAX package's (see ROADMAP.md "
            f"section 3)")


class CdfTables(NamedTuple):
    """Quantized-CDF bundle consumed by the indexed rANS coder."""

    cdf: np.ndarray          # uint32 [n_rows, max_length + 2]
    cdf_length: np.ndarray   # int32 [n_rows]
    cdf_offset: np.ndarray   # int32 [n_rows]
    inverse: np.ndarray      # int32 [n_rows, 2**precision] cf -> symbol
    precision: int


def prior_scale_table(scales_min=SCALES_MIN, scales_max=SCALES_MAX,
                      levels=SCALES_LEVELS) -> np.ndarray:
    """Log-spaced static scale table."""
    return np.exp(np.linspace(np.log(scales_min), np.log(scales_max), levels))


def _quantize_rows(pmf: np.ndarray, pmf_length: np.ndarray,
                   overflow: np.ndarray, precision: int) -> np.ndarray:
    """Quantize per-row float pmfs (+ explicit overflow mass) to CDF rows."""
    n_rows = pmf.shape[0]
    cdf = np.zeros((n_rows, int(pmf_length.max()) + 2), dtype=np.uint32)
    for r in range(n_rows):
        p = np.concatenate([pmf[r, : pmf_length[r]], [overflow[r]]])
        q = pmf_to_quantized_cdf(np.maximum(p, 0.0), precision)
        cdf[r, : len(q)] = q.astype(np.uint32)
    return cdf


def build_factorized_tables(likelihood_fn: Callable, lower_tail, upper_tail,
                            precision: int = PRECISION_P) -> CdfTables:
    """Tables of the learned factorized (hyperlatent) density.

    likelihood_fn: float32 samples (C, 1, M) -> likelihoods (C, 1, M), as
    numpy arrays. lower_tail/upper_tail: per-channel quantiles (C,).
    """
    lower_tail = np.asarray(lower_tail, np.float64)
    upper_tail = np.asarray(upper_tail, np.float64)

    minima = np.clip(np.ceil(-lower_tail), 0, None).astype(np.int32)
    maxima = np.clip(np.ceil(upper_tail), 0, None).astype(np.int32)
    pmf_start = (-minima).astype(np.float64)
    pmf_length = (maxima + minima + 1).astype(np.int32)
    max_length = int(pmf_length.max())

    samples = pmf_start[:, None] + np.arange(max_length)[None, :]
    pmf = np.asarray(likelihood_fn(samples[:, None, :].astype(np.float32)),
                     np.float64)[:, 0, :]

    # Mask samples beyond each channel's pmf_length; the leftover mass goes
    # to the overflow slot.
    valid = np.arange(max_length)[None, :] < pmf_length[:, None]
    pmf = np.where(valid, pmf, 0.0)
    overflow = np.clip(1.0 - pmf.sum(axis=1), 0.0, None)

    cdf = _quantize_rows(pmf, pmf_length, overflow, precision)
    cdf_length = (pmf_length + 2).astype(np.int32)
    cdf_offset = (-minima).astype(np.int32)
    return CdfTables(cdf, cdf_length, cdf_offset,
                     build_inverse_table(cdf, cdf_length, precision), precision)


def build_scale_tables(standardized_cdf: Callable,
                       standardized_quantile: Callable,
                       scale_table=None, tail_mass: float = TAIL_MASS,
                       precision: int = PRECISION_P) -> CdfTables:
    """Tables of the mean-scale conditional prior: one row per table scale,
    a symmetric pmf around 0 with closed-form tails. standardized_cdf maps
    float32 numpy arrays to float32 numpy arrays."""
    if scale_table is None:
        scale_table = prior_scale_table()
    scale_table = np.maximum(np.asarray(scale_table, np.float64), SCALES_MIN)

    multiplier = -standardized_quantile(tail_mass / 2)
    pmf_center = np.ceil(scale_table * multiplier).astype(np.int32)
    pmf_length = (2 * pmf_center + 1).astype(np.int32)
    max_length = int(pmf_length.max())

    samples = np.abs(np.arange(max_length)[None, :] - pmf_center[:, None])
    samples_scale = scale_table[:, None]
    upper = np.asarray(standardized_cdf(
        ((0.5 - samples) / samples_scale).astype(np.float32)), np.float64)
    lower = np.asarray(standardized_cdf(
        ((-0.5 - samples) / samples_scale).astype(np.float32)), np.float64)
    pmf = upper - lower

    # The overflow slot takes the two-sided tail mass.
    overflow = 2.0 * lower[:, 0]
    valid = np.arange(max_length)[None, :] < pmf_length[:, None]
    pmf = np.where(valid, pmf, 0.0)

    cdf = _quantize_rows(pmf, pmf_length, overflow, precision)
    cdf_length = (pmf_length + 2).astype(np.int32)
    cdf_offset = (-pmf_center).astype(np.int32)
    return CdfTables(cdf, cdf_length, cdf_offset,
                     build_inverse_table(cdf, cdf_length, precision), precision)


def compute_scale_indices(scales: np.ndarray, scale_table: np.ndarray
                          ) -> np.ndarray:
    """Index of the smallest table scale >= predicted scale: the count of
    strictly smaller table entries."""
    scales = np.maximum(np.asarray(scales), SCALES_MIN)
    indices = np.full(scales.shape, len(scale_table) - 1, np.int32)
    for s in scale_table[:-1]:
        indices -= (scales <= s).astype(np.int32)
    return indices
