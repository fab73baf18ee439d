"""Host-side entropy models: quantize values, select CDF rows and run the
rANS coder.

Counterpart of the JAX package's `entropy/entropy_models.py`. Symbols and
indices here are numpy arrays in NCHW, so the lane layout (channels as
lanes, row-major spatial walk) is that of the JAX package's bitstream.
Tables are built on the host whatever device the codec runs on, with the
float32 arithmetic of `host_math`, which makes them byte-identical to the
JAX package's. `import_tables` pins a model to tables built elsewhere
(the sender's), as the JAX package's does; the codec's coders, host and
device, code with whatever tables the models hold when a call starts.
"""

import collections
import copy
from typing import Optional, Tuple

import numpy as np
import torch

from hific_tpu_torch.entropy import coding, host_math
from hific_tpu_torch.entropy.tables import (
    CdfTables,
    SCALES_MIN,
    build_factorized_tables,
    build_scale_tables,
    check_factorized_channels,
    compute_scale_indices,
    prior_scale_table,
)
from hific_tpu_torch.models.density import (
    PRECISION_P,
    TAIL_MASS,
    HyperlatentDensity,
    latent_likelihood,
)
from hific_tpu_torch.ops import maths


# Factorized tables by density: a codec built again in one process on the
# same weights (the compress and decompress tools, the server, a test
# module) takes them from here instead of searching again (~8 s for 320
# channels). A pure function of the key, so a hit is the same tables.
_TABLES_KEPT = 8
_tables_by_density: "collections.OrderedDict" = collections.OrderedDict()


def import_cdf_tables(cdf, cdf_length, cdf_offset, precision: int
                      ) -> CdfTables:
    """Raw quantized-CDF arrays of any integer dtype (the JAX package's
    layout) -> `CdfTables`, with the inverse decode table rebuilt."""
    cdf = np.ascontiguousarray(np.asarray(cdf), dtype=np.uint32)
    cdf_length = np.asarray(cdf_length, np.int32)
    return CdfTables(cdf, cdf_length, np.asarray(cdf_offset, np.int32),
                     coding.build_inverse_table(cdf, cdf_length, precision),
                     int(precision))


def _bits(likelihood: np.ndarray, spatial_shape, batch: int
          ) -> Tuple[float, float, float]:
    """(total bits, bpp, bits per image) of float64 likelihoods."""
    bits = float(-np.sum(np.log(likelihood + 1e-9)) / np.log(2.0))
    return bits, bits / float(np.prod(spatial_shape)), bits / batch


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
        # The density's own (tables, medians), once built.
        self._own: Optional[tuple] = None

    def _params(self) -> dict:
        return {name: p.numpy() for name, p in self.density.named_parameters()}

    def build_tables(self) -> CdfTables:
        """The density's own tables, as the JAX package's `build_tables`
        gives them: also after `import_tables`, whose tables they replace.
        The tails and medians come from the JAX package's search, step
        for step in its float32 arithmetic (`host_math.factorized_tails`),
        so the rows are its rows; a channel count whose search it does not
        follow is refused (`check_factorized_channels`). Searched once: the
        density is this model's own frozen copy; and once per process for
        a density, tail mass and precision (the last few kept)."""
        if self._own is None:
            self._own = self._search()
        self.tables, self.medians = self._own
        return self.tables

    def _search(self) -> tuple:
        check_factorized_channels(self.n_channels)
        params = self._params()
        key = (tuple((name, v.tobytes()) for name, v in params.items()),
               self.tail_mass, self.precision, self.density.min_likelihood)
        if key in _tables_by_density:
            _tables_by_density.move_to_end(key)
            return _tables_by_density[key]
        target = float(np.log(2.0 / self.tail_mass - 1.0))
        lower, upper, medians = host_math.factorized_tails(
            params, [-target, target, 0.0])

        def likelihood_fn(samples: np.ndarray) -> np.ndarray:
            return host_math.factorized_likelihood(
                params, samples, self.density.min_likelihood)

        own = (build_factorized_tables(likelihood_fn, lower, upper,
                                       self.precision), medians)
        _tables_by_density[key] = own
        while len(_tables_by_density) > _TABLES_KEPT:
            _tables_by_density.popitem(last=False)
        return own

    def import_tables(self, cdf, cdf_length, cdf_offset,
                      precision: Optional[int] = None) -> CdfTables:
        """Install quantized CDF tables built elsewhere: the sender's, or
        tables shipped with the model. Sender and receiver must code
        against identical tables, and importing pins them instead of
        trusting two float stacks to round alike. They stay in force until
        the next `build_tables`, and only in this model."""
        self.tables = import_cdf_tables(cdf, cdf_length, cdf_offset,
                                        precision or self.precision)
        return self.tables

    def _indices(self, batch: int, broadcast_shape) -> np.ndarray:
        idx = np.arange(self.n_channels, dtype=np.int32).reshape(-1, 1, 1)
        idx = np.broadcast_to(idx, (self.n_channels, *broadcast_shape))
        return np.broadcast_to(idx[None], (batch, *idx.shape))

    def compress(self, z: np.ndarray, vectorize: bool = True
                 ) -> Tuple[np.ndarray, tuple]:
        """Float hyperlatents (N, C, H, W), rounded -> (uint32 stream,
        coding_shape)."""
        return self.compress_symbols(np.floor(z + 0.5).astype(np.int32),
                                     vectorize)

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

    def decompress(self, encoded: np.ndarray, batch: int, broadcast_shape,
                   vectorize: bool = True) -> np.ndarray:
        """The rounded hyperlatents `compress` coded, float32."""
        return self.decompress_symbols(encoded, batch, broadcast_shape,
                                       vectorize).astype(np.float32)

    def estimate_bits(self, z: np.ndarray, spatial_shape
                      ) -> Tuple[float, float, float]:
        """(total bits, bpp, bits per image) of the rounded hyperlatents
        under the density (`host_math.factorized_likelihood`, the
        likelihood the tables are built from)."""
        q = np.floor(np.asarray(z) + 0.5)
        flat = q.transpose(1, 0, 2, 3).reshape(q.shape[1], 1, -1)
        lik = host_math.factorized_likelihood(
            self._params(), flat.astype(np.float32),
            self.density.min_likelihood)
        return _bits(np.asarray(lik, np.float64), spatial_shape, q.shape[0])


class ConditionalEntropyModel:
    """Entropy model of the mean-scale conditional latent prior: a static
    log-spaced scale table, one CDF row per table scale; the means are the
    quantization offsets."""

    def __init__(self, likelihood_type: str = "gaussian",
                 min_scale: float = SCALES_MIN, tail_mass: float = TAIL_MASS,
                 precision: int = PRECISION_P, scale_table=None):
        """scale_table: the table scales, one CDF row each (ascending);
        by default the log-spaced prior table bounded below by
        `min_scale`."""
        if likelihood_type == "gaussian":
            std_cdf = host_math.standardized_cdf_gaussian
            std_q = maths.standardized_quantile_gaussian
        elif likelihood_type == "logistic":
            std_cdf = host_math.logistic
            std_q = maths.standardized_quantile_logistic
        else:
            raise ValueError(likelihood_type)
        self.likelihood_type = likelihood_type
        self.min_scale = float(min_scale)
        self.precision = int(precision)
        self.scale_table = (np.maximum(prior_scale_table(), min_scale)
                            if scale_table is None
                            else np.asarray(scale_table, np.float64))
        self.tables = build_scale_tables(std_cdf, std_q, self.scale_table,
                                         tail_mass, precision)

    def compress(self, y: np.ndarray, means: np.ndarray, scales: np.ndarray,
                 vectorize: bool = True) -> Tuple[np.ndarray, tuple]:
        """Float latents, their means and scales (N, C, H, W) -> (uint32
        stream, coding_shape): the symbols round(y - means), the rows the
        scale table's indices of the scales."""
        return self.compress_symbols(
            np.floor(y + 0.5 - means).astype(np.int32),
            compute_scale_indices(scales, self.scale_table), vectorize)

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

    def decompress(self, encoded: np.ndarray, means: np.ndarray,
                   scales: np.ndarray, vectorize: bool = True) -> np.ndarray:
        """The quantized latents `compress` coded: symbols + means."""
        symbols = self.decompress_symbols(
            encoded, compute_scale_indices(scales, self.scale_table),
            vectorize)
        return symbols.astype(np.float32) + means

    def import_tables(self, cdf, cdf_length, cdf_offset,
                      precision: Optional[int] = None) -> CdfTables:
        """Install scale tables built elsewhere (see
        `FactorizedEntropyModel.import_tables`); one row per entry of
        `scale_table`."""
        self.tables = import_cdf_tables(cdf, cdf_length, cdf_offset,
                                        precision or self.precision)
        return self.tables

    def estimate_bits(self, y, means, scales, spatial_shape
                      ) -> Tuple[float, float, float]:
        """(total bits, bpp, bits per image) of the hard-quantized latents
        under the boxcar likelihood of the prior, the scales bounded below
        by `min_scale`."""
        q = np.floor(np.asarray(y) - means + 0.5) + means
        with torch.no_grad():
            lik = latent_likelihood(
                *(torch.from_numpy(np.asarray(a, np.float32))
                  for a in (q, means, np.maximum(scales, self.min_scale))),
                self.likelihood_type)
        return _bits(lik.numpy().astype(np.float64), spatial_shape,
                     q.shape[0])
