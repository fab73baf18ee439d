"""Host-side entropy models: select CDF rows and run the rANS coder.

Counterpart of the JAX package's `entropy/entropy_models.py`. Symbols and
indices here are numpy arrays in NCHW, so the lane layout (channels as
lanes, row-major spatial walk) is that of the JAX package's bitstream.
Tables are built on the host whatever device the codec runs on, with the
float32 arithmetic of `host_math`, which makes them byte-identical to the
JAX package's.
"""

import collections
import copy
from typing import Optional, Tuple

import numpy as np

from hific_tpu_torch.entropy import coding, host_math
from hific_tpu_torch.entropy.tables import (
    CdfTables,
    SCALES_MIN,
    build_factorized_tables,
    build_scale_tables,
    check_factorized_channels,
    prior_scale_table,
)
from hific_tpu_torch.models.density import (
    PRECISION_P,
    TAIL_MASS,
    HyperlatentDensity,
)
from hific_tpu_torch.ops import maths


# Factorized tables by density: a codec built again in one process on the
# same weights (the compress and decompress tools, the server, a test
# module) takes them from here instead of searching again (~8 s for 320
# channels). A pure function of the key, so a hit is the same tables.
_TABLES_KEPT = 8
_tables_by_density: "collections.OrderedDict" = collections.OrderedDict()


def encode_symbols(symbols, indices, tables: CdfTables, vectorize: bool,
                   shards: int) -> Tuple[np.ndarray, tuple]:
    """The vectorized coder, its lanes sharded into `shards` streams where
    `shards` > 1 (a container v2 payload), or the scalar coder where not
    `vectorize`."""
    args = (symbols, indices, tables.cdf, tables.cdf_length,
            tables.cdf_offset, tables.precision)
    if shards > 1:
        if not vectorize:
            raise ValueError("sharded coding shards the vectorized coder's "
                             "lanes: it needs vectorize=True")
        return coding.encode_indexed_sharded(*args, shards)
    if vectorize:
        return coding.encode_indexed(*args)
    return coding.encode_indexed_scalar(*args)


def decode_symbols(encoded, indices, tables: CdfTables, vectorize: bool,
                   sharded: bool) -> np.ndarray:
    """Decode what `encode_symbols` wrote: a sharded payload (which says
    how many shards it holds), or else the vectorized or scalar stream."""
    args = (encoded, indices, tables.cdf, tables.cdf_length,
            tables.cdf_offset, tables.precision, tables.inverse)
    if sharded:
        return coding.decode_indexed_sharded(*args)
    if vectorize:
        return coding.decode_indexed(*args)
    return coding.decode_indexed_scalar(*args)


class FactorizedEntropyModel:
    """Entropy model of the learned factorized hyperlatent density: one CDF
    row per channel, independent of the data."""

    def __init__(self, density: HyperlatentDensity,
                 tail_mass: float = TAIL_MASS, precision: int = PRECISION_P):
        # A CPU copy of the (tiny) density: tables are host data.
        self.density = copy.deepcopy(density).to("cpu").requires_grad_(False)
        self.n_channels = self.density.n_channels
        self.tail_mass = float(tail_mass)
        self.precision = int(precision)
        self.tables: Optional[CdfTables] = None
        self.medians: Optional[np.ndarray] = None

    def build_tables(self) -> CdfTables:
        """The tails and medians come from the JAX package's search, step
        for step in its float32 arithmetic (`host_math.factorized_tails`),
        so the rows are its rows; a channel count whose search it does not
        follow is refused (`check_factorized_channels`). Built once: the
        density is this model's own frozen copy; and once per process for
        a density, tail mass and precision (the last few kept)."""
        if self.tables is not None:
            return self.tables
        check_factorized_channels(self.n_channels)
        params = {name: p.numpy() for name, p in
                  self.density.named_parameters()}
        key = (tuple((name, v.tobytes()) for name, v in params.items()),
               self.tail_mass, self.precision, self.density.min_likelihood)
        if key in _tables_by_density:
            _tables_by_density.move_to_end(key)
            self.tables, self.medians = _tables_by_density[key]
            return self.tables
        target = float(np.log(2.0 / self.tail_mass - 1.0))
        lower, upper, self.medians = host_math.factorized_tails(
            params, [-target, target, 0.0])

        def likelihood_fn(samples: np.ndarray) -> np.ndarray:
            return host_math.factorized_likelihood(
                params, samples, self.density.min_likelihood)

        self.tables = build_factorized_tables(likelihood_fn, lower, upper,
                                              self.precision)
        _tables_by_density[key] = (self.tables, self.medians)
        while len(_tables_by_density) > _TABLES_KEPT:
            _tables_by_density.popitem(last=False)
        return self.tables

    def _indices(self, batch: int, broadcast_shape) -> np.ndarray:
        idx = np.arange(self.n_channels, dtype=np.int32).reshape(-1, 1, 1)
        idx = np.broadcast_to(idx, (self.n_channels, *broadcast_shape))
        return np.broadcast_to(idx[None], (batch, *idx.shape))

    def compress_symbols(self, symbols: np.ndarray, vectorize: bool = True,
                         shards: int = 1) -> Tuple[np.ndarray, tuple]:
        """Integer symbols (N, C, H, W) -> (uint32 stream, coding_shape), as
        `encode_symbols` codes them."""
        if self.tables is None:
            raise RuntimeError("call build_tables() first")
        symbols = np.asarray(symbols, np.int32)
        indices = self._indices(symbols.shape[0], symbols.shape[2:])
        return encode_symbols(symbols, indices, self.tables, vectorize,
                              shards)

    def decompress_symbols(self, encoded: np.ndarray, batch: int,
                           broadcast_shape, vectorize: bool = True,
                           sharded: bool = False) -> np.ndarray:
        if self.tables is None:
            raise RuntimeError("call build_tables() first")
        indices = self._indices(batch, broadcast_shape)
        return decode_symbols(encoded, indices, self.tables, vectorize,
                              sharded)


class ConditionalEntropyModel:
    """Entropy model of the mean-scale conditional latent prior: a static
    log-spaced scale table, one CDF row per table scale; the means are the
    quantization offsets."""

    def __init__(self, likelihood_type: str = "gaussian",
                 min_scale: float = SCALES_MIN, tail_mass: float = TAIL_MASS,
                 precision: int = PRECISION_P):
        if likelihood_type == "gaussian":
            std_cdf = host_math.standardized_cdf_gaussian
            std_q = maths.standardized_quantile_gaussian
        elif likelihood_type == "logistic":
            std_cdf = host_math.logistic
            std_q = maths.standardized_quantile_logistic
        else:
            raise ValueError(likelihood_type)
        self.likelihood_type = likelihood_type
        self.precision = int(precision)
        self.scale_table = np.maximum(prior_scale_table(), min_scale)
        self.tables = build_scale_tables(std_cdf, std_q, self.scale_table,
                                         tail_mass, precision)

    def compress_symbols(self, symbols: np.ndarray, indices: np.ndarray,
                         vectorize: bool = True, shards: int = 1
                         ) -> Tuple[np.ndarray, tuple]:
        """Integer symbols + scale-table indices, both (N, C, H, W), coded
        as `encode_symbols` codes them."""
        return encode_symbols(np.asarray(symbols, np.int32),
                              np.asarray(indices, np.int32), self.tables,
                              vectorize, shards)

    def decompress_symbols(self, encoded: np.ndarray, indices: np.ndarray,
                           vectorize: bool = True, sharded: bool = False
                           ) -> np.ndarray:
        return decode_symbols(encoded, np.asarray(indices, np.int32),
                              self.tables, vectorize, sharded)
