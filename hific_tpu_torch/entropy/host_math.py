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
  computes unfused (`xla_unfused_samples`, below);
- the tail search (`factorized_tails`, at the end): the JAX package's Adam
  loop, whose softplus and tanh are computed by the compiled program, step
  for step.

The pmf follows XLA's code as it runs on one core (one partition of its
fusions), whatever the host: at 320 channels and 256 samples or more the
JAX package's own pmf changes with the number of cores it may use.

tests/test_torch_entropy.py holds the tables built from these against the
JAX package's, for the tiny model and for the flagship artifact's density;
tests/test_torch_tables_fold.py and tests/test_torch_tails.py hold the
folded first layer and the tail search.
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


# The tail search of the factorized tables. The JAX package runs it as one
# `lax.while_loop` whose density parameters are arguments of the compiled
# program, so softplus(H) and tanh(a) are computed by that program (once,
# hoisted out of the loop) and not folded by the C library; its body is the
# forward CDF logits, their gradient and an Adam step. The functions below
# follow XLA's CPU code of that program (`--xla_dump_to`: the optimized HLO
# and each fusion's object code), operation by operation. Where LLVM fuses
# a product into the add that uses it, so do they; where the vector code
# keeps them apart (the third filter of the first layer in the vector
# loop, the products with more than one use), so do they. Measured
# bit-equal, every step, for densities of 2 to 72 channels and of 79 to
# 333 (a sample), and of 8 to 320 in multiples of 8, on AVX-512 hosts. A
# density of one channel compiles to another program, which this does not
# follow (the table builder refuses it).

_LOG1P_RATIONAL = 0.41421357  # |e| below: the rational form of log1p


def first_layer_vector_channels(c: int) -> int:
    """How many leading channels of c the tail search's first layer runs in
    vector code; the rest run in the scalar remainder loop.

    The layer's fusion loops over the channels, the three filters of each
    unrolled inside. LLVM vectorizes that loop with 4 or 8 channels a
    vector by the trip count, and the vector code computes the third
    filter's softplus(H) * x and + b apart, where the scalar code fuses all
    three. Read from the object code XLA dumps (`--xla_dump_to`) for c = 2
    to 400 on an AVX-512 host: no vector loop below 16 channels except at
    4 and 8; 4-channel vectors from 20 to 39 channels where c % 8 >= 4;
    8-channel vectors otherwise."""
    if c % 8 == 0 or c == 4:
        return c
    if c < 16:
        return 0
    if c < 40 and c % 8 >= 4:
        return c - c % 4
    return c - c % 8


def _exp_compiled(x) -> np.ndarray:
    """exp(x) as the loop fusions compute it: Cephes' polynomial with fused
    multiply-adds, x clamped to [-87.8, 88.8], the exponent to +-127."""
    x = np.asarray(x, F32)
    x = np.minimum(np.maximum(x, F32(-87.8)), F32(88.8))
    n = np.floor(fma(x, F32(1.44269502), F32(0.5)))
    n = np.minimum(np.maximum(n, F32(-127.0)), F32(127.0))
    r = fma(-n, F32(0.693359375), x)
    r = fma(-n, F32(-2.12194440e-4), r)
    p = fma(r, F32(1.9875691500e-4), F32(1.3981999507e-3))
    for c in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 0.5):
        p = fma(p, r, F32(c))
    y = add(fma(p, mul(r, r), r), F32(1.0))
    return mul(y, ((n.astype(np.int32) + 127) << 23).view(F32))


_LOG_P = ((7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1),
          (-1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1),
          (2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG1P_DEN = (15.062909186, 83.047565967, 221.76239823, 309.09872225,
              216.42788614, 60.118660497)
_LOG1P_NUM = (4.5270000862e-5, 0.49854102823, 6.5787325942, 29.911919328,
              60.949667980, 57.112963590, 20.039553499)


@_both_branches
def _log1p_compiled(e) -> np.ndarray:
    """log1p(e) for e >= 0 as the loop fusions compute it: Cephes' rational
    form below 0.41421357, else Cephes' log of 1 + e."""
    e = np.asarray(e, F32)
    bits = np.maximum(add(e, F32(1.0)), _TINY).view(np.int32)
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(F32)  # in [0.5, 1)
    low = mant < F32(0.707106769)
    k = add(add(((bits >> 23) - 127).astype(F32), F32(1.0)),
            np.where(low, F32(-1.0), F32(-0.0)))
    x = add(add(mant, F32(-1.0)), np.where(low, mant, F32(0.0)))
    z = mul(x, x)
    x3 = mul(z, x)
    y1, y2, y3 = (fma(fma(x, F32(a), F32(b)), x, F32(c)) for a, b, c in _LOG_P)
    y = fma(fma(fma(y1, x3, y2), x3, y3), x3, mul(k, F32(-2.12194440e-4)))
    log = fma(k, F32(0.693359375), add(add(x, -mul(z, F32(0.5))), y))
    den = np.full_like(e, F32(1.0))
    for c in _LOG1P_DEN:
        den = fma(den, e, F32(c))
    num = np.full_like(e, F32(_LOG1P_NUM[0]))
    for c in _LOG1P_NUM[1:]:
        num = fma(num, e, F32(c))
    e2 = mul(e, e)
    rational = add(e, fma(e2, F32(-0.5), mul(mul(e, e2), div(num, den))))
    return np.where(np.abs(e) < F32(_LOG1P_RATIONAL), rational, log)


def softplus_compiled(h) -> np.ndarray:
    """softplus(h) = max(h, 0) + log1p(exp(-|h|)) as XLA's compiled code
    computes it (the tail search; `softplus_folded` is the folded form)."""
    h = np.asarray(h, F32)
    return add(np.maximum(h, F32(0.0)),
               _log1p_compiled(_exp_compiled(-np.abs(h))))


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, without the flush to zero of `fma`,
    which doubles the search's time: its products and sums stay far from the
    subnormal range, except the Adam moments, which `factorized_tails`
    flushes itself."""
    return (np.multiply(a, b, dtype=F64) + c).astype(F32)


def _tanh32(x) -> np.ndarray:
    """`tanh` without the flush to zero, for the search's logits."""
    clamp = F32(7.99881172180175781)
    xc = np.minimum(np.maximum(x, -clamp), clamp)
    x2 = xc * xc
    num = np.full_like(x, F32(_TANH_NUM[0]))
    for c in _TANH_NUM[1:]:
        num = _fma32(x2, num, F32(c))
    den = np.full_like(x, F32(_TANH_DEN[0]))
    for c in _TANH_DEN[1:]:
        den = _fma32(x2, den, F32(c))
    return np.where(np.abs(x) < F32(0.0004), x, (xc * num) / den)


def _tanh_grad(g, tanh_a, t) -> np.ndarray:
    """Gradient through l = x + tanh(a) * tanh(x), given g = dL/dl and
    t = tanh(x): g + p + t * p with p = tanh(a) * g * (1 - t); the last
    product is fused into its add."""
    p = (tanh_a * g) * (F32(1.0) - t)
    return _fma32(t, p, g + p)


def factorized_tails(params, targets, max_iters: int = 200_000,
                     extra_counts: int = 24) -> np.ndarray:
    """For each target, the x (C,) where the factorized density's CDF logits
    reach it: the JAX package's `estimate_tails` search, step for step.

    Adam (lr 1e-2, betas 0.9 and 0.99, eps 1e-8) on sum |logits(x) -
    target| from x = 0, until every channel has overshot the optimum
    `extra_counts` times after its first overshoot (`max_iters` is only a
    runaway backstop). The searches run side by side; one whose rule has
    fired stops, so each gives what a search of its own would.
    params: {'H_k', 'a_k', 'b_k'} float32 numpy arrays, k = 0..3, with the
    filters (1, 3, 3, 3, 1). Returns float32 (len(targets), C).
    """
    sp = [softplus_compiled(params[f"H_{k}"]) for k in range(4)]
    ta = [tanh(params[f"a_{k}"])[..., 0] for k in range(4)]
    b = [np.asarray(params[f"b_{k}"], F32)[..., 0] for k in range(4)]
    c = b[0].shape[0]
    vec = first_layer_vector_channels(c)
    sp0, sp3 = sp[0][..., 0], sp[3][:, 0, :]     # (C, 3) and (C, 3)
    ta3, b3 = ta[3][:, 0], b[3][:, 0]
    n = len(targets)
    tails = np.zeros((n, c), F32)
    m = np.zeros((n, c), F32)
    v = np.ones((n, c), F32)
    counts = np.zeros((n, c), np.int32)
    target = np.asarray(targets, F32)[:, None]
    live = np.arange(n)
    for _ in range(max_iters):
        live = live[counts[live].min(axis=1) < extra_counts]
        if live.size == 0:
            break
        t, tg = tails[live], target[live]
        # Forward: x_k the layer's input to tanh, l_k its output.
        x1 = _fma32(sp0, t[..., None], b[0])
        x1[..., :vec, 2] = sp0[:vec, 2] * t[..., :vec] + b[0][:vec, 2]
        t1 = _tanh32(x1)
        l1 = _fma32(ta[0], t1, x1)
        x2 = _matvec(sp[1], l1) + b[1]
        t2 = _tanh32(x2)
        l2 = _fma32(ta[1], t2, x2)
        x3 = _matvec(sp[2], l2) + b[2]
        t3 = _tanh32(x3)
        l3 = _fma32(ta[2], t3, x3)
        x4 = _dot3(sp3, l3) + b3
        t4 = _tanh32(x4)
        logits = _fma32(ta3, t4, x4)
        # Backward: the sign of |logits - target|, then each layer's
        # tanh term and transposed product.
        s = np.where(logits - tg >= 0, F32(1.0), F32(-1.0))
        q = (F32(1.0) - t4) * (ta3 * s)
        g4 = _fma32(t4, q, s + q)
        gx3 = _tanh_grad(g4[..., None] * sp3, ta[2], t3)
        gx2 = _tanh_grad(_matvec_t(gx3, sp[2]), ta[1], t2)
        gx1 = _tanh_grad(_matvec_t(gx2, sp[1]), ta[0], t1)
        grad = _dot3(gx1, sp0)
        # Adam.
        m_new = _ftz(_fma32(m[live], F32(0.9), grad * F32(1.0 - 0.9)))
        v_new = _ftz(_fma32(v[live], F32(0.99),
                            _ftz(grad * grad) * F32(1.0 - 0.99)))
        t = t - (m_new * F32(1e-2)) / (np.sqrt(v_new) + F32(1e-8))
        cnt = counts[live]
        counts[live] = np.where((cnt > 0) | (grad * t > 0), cnt + 1, cnt)
        tails[live], m[live], v[live] = t, m_new, v_new
    return tails


def _matvec(h, l) -> np.ndarray:
    """(C, o, f) x (..., C, f) -> (..., C, o): per output, the products over
    f chained in fused multiply-adds, in order (XLA's row-major gemv)."""
    acc = h[..., 0] * l[..., None, 0]
    for j in range(1, h.shape[2]):
        acc = _fma32(h[..., j], l[..., None, j], acc)
    return acc + F32(0.0)


def _matvec_t(g, h) -> np.ndarray:
    """(..., C, o) x (C, o, f) -> (..., C, f), the transposed product: over
    o, in order, with fused multiply-adds (XLA's column-major gemv)."""
    acc = g[..., 0:1] * h[:, 0, :]
    for o in range(1, h.shape[1]):
        acc = _fma32(h[:, o, :], g[..., o:o + 1], acc)
    return acc


def _dot3(a, b) -> np.ndarray:
    """sum over the last axis of a * b, in order, each product rounded
    before its add (XLA's gemv of one output row)."""
    acc = a[..., 0] * b[..., 0]
    for j in range(1, a.shape[-1]):
        acc = a[..., j] * b[..., j] + acc
    return acc
