"""Float32 functions for the CDF tables, reproducible to the last bit.

The quantized CDF tables are part of the bitstream contract: an encoder and
a decoder must hold the same integers, and a CDF entry moves whenever a
float32 pmf value moves by one ulp near a rounding boundary. The JAX
package builds its tables with JAX on the host CPU, so its tables are
defined by XLA's CPU arithmetic. This module reproduces that arithmetic
with numpy, so that this package's tables are byte-identical to the JAX
package's whatever device the codec runs on. It uses IEEE operations only
(float64 products and sums, which hold a float32 fused multiply-add
exactly, floor, exponent arithmetic), except for the parameter transforms
that XLA folds into constants at compile time, where it calls the host C
library as XLA's constant folder does:

- exp: the Cephes polynomial with fused multiply-adds and denormals flushed
  to zero;
- tanh: the rational approximation with fused multiply-adds, its input
  clamped at +-7.99881172180175781;
- erfc: the Cephes polynomials of the erfc expansion, with fused
  multiply-adds;
- logistic: 1 / (exp(-x) + 1);
- small batched matrix products: a fused multiply-add chain over k in order;
- folded constants: softplus(H) with the C library's expf and log1pf, and a
  correctly rounded tanh(a);
- the products that LLVM hoists out of a loop, which XLA's CPU code then
  computes unfused (`xla_unfused_samples`, below).

tests/test_torch_entropy.py holds the tables built from these against the
JAX package's, for the tiny model and for the flagship artifact's density.
"""

import ctypes
import ctypes.util
import functools

import numpy as np

try:  # numpy >= 2
    from numpy._core._multiarray_umath import __cpu_features__ as _CPU
except ImportError:  # numpy 1.x
    from numpy.core._multiarray_umath import __cpu_features__ as _CPU

F32 = np.float32
F64 = np.float64
_TINY = F32(np.finfo(np.float32).tiny)


def _both_branches(fn):
    """The functions below evaluate both sides of each select, as XLA does;
    the side not taken may overflow, which numpy would warn about."""
    @functools.wraps(fn)
    def quiet(*args):
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            return fn(*args)
    return quiet


def _ftz(a) -> np.ndarray:
    a = np.asarray(a, F32)
    return np.where(np.abs(a) < _TINY, F32(0) * a, a).astype(F32)


def fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (the float64 product is exact)."""
    return _ftz(np.asarray(a, F64) * np.asarray(b, F64) + np.asarray(c, F64))


def mul(a, b) -> np.ndarray:
    return _ftz(np.asarray(a, F32) * np.asarray(b, F32))


def add(a, b) -> np.ndarray:
    return _ftz(np.asarray(a, F32) + np.asarray(b, F32))


def div(a, b) -> np.ndarray:
    return _ftz(np.asarray(a, F32) / np.asarray(b, F32))


@_both_branches
def exp(x) -> np.ndarray:
    x_in = np.asarray(x, F32)
    x = np.clip(x_in, F32(-88.0), F32(88.0))
    fx = np.floor(fma(x, F32(1.44269504088896341), F32(0.5)))
    x = fma(fx, F32(-0.693359375), x)
    x = fma(fx, F32(2.12194440e-4), x)
    z = mul(x, x)
    y = fma(x, F32(1.9875691500e-4), F32(1.3981999507e-3))
    for c in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
              5.0000001201e-1):
        y = fma(y, x, F32(c))
    y = add(F32(1.0), fma(y, z, x))
    two_n = ((fx.astype(np.int32) + 127) << 23).view(F32)
    return _ftz(np.maximum(mul(y, two_n), x_in))


_TANH_NUM = (-2.76076847742355e-16, 2.00018790482477e-13,
             -8.60467152213735e-11, 5.12229709037114e-08,
             1.48572235717979e-05, 6.37261928875436e-04,
             4.89352455891786e-03)
_TANH_DEN = (1.19825839466702e-06, 1.18534705686654e-04,
             2.26843463243900e-03, 4.89352518554385e-03)


@_both_branches
def tanh(x_in) -> np.ndarray:
    x_in = np.asarray(x_in, F32)
    clamp = F32(7.99881172180175781)
    x = np.minimum(np.maximum(x_in, -clamp), clamp)
    x2 = mul(x, x)
    num = np.full_like(x, F32(_TANH_NUM[0]))
    for c in _TANH_NUM[1:]:
        num = fma(x2, num, F32(c))
    den = np.full_like(x, F32(_TANH_DEN[0]))
    for c in _TANH_DEN[1:]:
        den = fma(x2, den, F32(c))
    return np.where(np.abs(x_in) < F32(0.0004), x_in, div(mul(x, num), den))


def _poly(y, coeffs) -> np.ndarray:
    p = fma(y, F32(coeffs[0]), F32(coeffs[1]))
    for c in coeffs[2:]:
        p = fma(p, y, F32(c))
    return p


_ERF_SMALL = (7.85386146e-05, -0.000801019371, 0.00518832775, -0.0268538129,
              0.112835854, -0.37612626, 1.12837911)
_ERFC_P = (0.0232682, -0.138703942, 0.368742466, -0.582473278, 0.621000469,
           -0.494451523, 0.340488, -0.274112701, 0.563825965)
_ERFC_R = (-10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523,
           0.42184633, -0.282076746, 0.564189494)


@_both_branches
def erfc(x) -> np.ndarray:
    x = np.asarray(x, F32)
    ax = np.abs(x)
    x2 = mul(x, x)
    small = fma(-x, _poly(x2, _ERF_SMALL), F32(1.0))
    y = div(F32(1.0), x2)
    p = np.where(ax < F32(2.0), _poly(y, _ERFC_P), _poly(y, _ERFC_R))
    r = mul(mul(exp(-x2), div(F32(1.0), ax)), p)
    r = np.where(-x2 < F32(-88.7228394), F32(0.0), r)
    large = np.where(x < 0, add(F32(2.0), -r), r)
    return np.where(ax < F32(1.0), small, large)


def standardized_cdf_gaussian(v) -> np.ndarray:
    return mul(F32(0.5), erfc(mul(v, F32(-1.0 / np.sqrt(2.0)))))


@_both_branches
def logistic(v) -> np.ndarray:
    return div(F32(1.0), add(exp(-np.asarray(v, F32)), F32(1.0)))


class _Libm:
    """The C library's float functions, as the constant folder calls them."""

    def __init__(self):
        self._lib = None

    def call(self, name: str, x) -> np.ndarray:
        if self._lib is None:
            lib = ctypes.CDLL(ctypes.util.find_library("m"))
            for fn in ("expf", "log1pf"):
                getattr(lib, fn).restype = ctypes.c_float
                getattr(lib, fn).argtypes = [ctypes.c_float]
            self._lib = lib
        fn = getattr(self._lib, name)
        x = np.asarray(x, F32)
        return np.array([fn(float(v)) for v in x.reshape(-1)],
                        F32).reshape(x.shape)


_LIBM = _Libm()


def softplus_folded(h) -> np.ndarray:
    """softplus(h) = max(h, 0) + log1p(exp(-|h|)) with the C library's expf
    and log1pf."""
    h = np.asarray(h, F32)
    e = _LIBM.call("expf", -np.abs(h))
    return add(np.maximum(h, F32(0.0)), _LIBM.call("log1pf", e))


def tanh_folded(a) -> np.ndarray:
    """Correctly rounded float32 tanh."""
    return np.tanh(np.asarray(a, F64)).astype(F32)


def xla_vector_lanes() -> int:
    """float32 lanes of the vectors XLA's CPU code uses on this host: XLA
    asks LLVM for 256-bit vectors ("prefer-vector-width"="256") and gets
    them wherever the host CPU has AVX (CPUID, read here through numpy's
    own detection, as LLVM reads it for XLA)."""
    return 8 if _CPU.get("AVX", False) else 4


def xla_unfused_samples(m: int) -> int:
    """How many leading samples of a row of m XLA computes as an unfused
    c * x, then + b, in the first density layer, when that layer's
    softplus(H_0) is one value for every channel.

    XLA then folds the layer into a scalar multiply ahead of the broadcast
    over its three output rows. The fusion loops over channels, over the
    three rows and, innermost, over the m samples; LLVM vectorizes the
    sample loop (8 lanes, interleaved 1, 2 or 4 times by the trip count),
    unrolls it fully below 256 samples, and hoists the products of its
    first (vector) iteration out of the loop over the rows, where they are
    no longer next to the add they would fuse with. Read from the LLVM
    code XLA dumps for that fusion (`--xla_dump_to`) and measured over
    m = 3..300 on an AVX-512 host, which XLA also runs with 8 lanes. Not
    measured on a host without AVX, where the vectors have 4 lanes: there
    this returns 0, the fused arithmetic of a trained density.
    """
    if xla_vector_lanes() != 8 or m < 3 or m >= 256:
        return 0
    if m < 28:
        return 1   # scalar loop: its first iteration is hoisted
    if m < 32:
        return 8   # one 8-lane vector
    if m < 48:
        return 32  # 8 lanes x 4
    if m < 64:
        return 16  # 8 lanes x 2
    return 32


def _unfused_last_dot_sample(m: int) -> bool:
    """Whether XLA computes the last sample of a row of m unfused in the
    last layer's product (3 -> 1 filters): measured for m % 8 == 1, m >= 9,
    where that sample is the single-element remainder of the 8-lane loop."""
    return xla_vector_lanes() == 8 and m >= 9 and m % 8 == 1


def factorized_cdf_logits(params, x) -> np.ndarray:
    """CDF logits of the factorized density at x (C, 1, M) float32.

    params: {'H_k', 'a_k', 'b_k'} float32 numpy arrays, k = 0..K-1.
    """
    logits = np.asarray(x, F32)
    m = logits.shape[-1]
    n_layers = sum(1 for name in params if name.startswith("H_"))
    for k in range(n_layers):
        h = softplus_folded(params[f"H_{k}"])      # (C, f_out, f_in)
        b = np.asarray(params[f"b_{k}"], F32)      # (C, f_out, 1)
        if h.shape[2] == 1:
            fused = fma(h, logits, b)
            n = xla_unfused_samples(m) if np.all(h == h.flat[0]) else 0
            if n:
                unfused = add(mul(h, logits[..., :n]), b)
                fused[..., :n] = unfused
            logits = fused
        else:
            acc = mul(h[:, :, 0:1], logits[:, 0:1, :])
            for j in range(1, h.shape[2]):
                acc_j = fma(h[:, :, j:j + 1], logits[:, j:j + 1, :], acc)
                if h.shape[1] == 1 and _unfused_last_dot_sample(m):
                    acc_j[..., -1:] = add(
                        mul(h[:, :, j:j + 1], logits[:, j:j + 1, -1:]),
                        acc[..., -1:])
                acc = acc_j
            logits = add(acc, b)
        logits = fma(tanh(logits), tanh_folded(params[f"a_{k}"]), logits)
    return logits


def factorized_likelihood(params, x, min_likelihood: float) -> np.ndarray:
    """Likelihood of the factorized density at x (C, 1, M) float32."""
    x = np.asarray(x, F32)
    upper = factorized_cdf_logits(params, add(x, F32(0.5)))
    lower = factorized_cdf_logits(params, add(x, F32(-0.5)))
    sign = -np.sign(add(upper, lower)).astype(F32)
    lik = np.abs(add(logistic(mul(sign, upper)), -logistic(mul(sign, lower))))
    return np.maximum(lik, F32(min_likelihood))
