"""ctypes bindings for the native rANS coder (csrc/rans.cc).

The library is built with g++ at first use into `hific_tpu_torch/_build/`
(see `native_build.py`). A failed build raises: nothing falls back to the
numpy coder behind the caller's back. `HIFIC_TPU_TORCH_NATIVE=0` chooses the
numpy coder of `coding.py` explicitly; both write the same bytes.
"""

import ctypes
import os
import threading

import numpy as np

from hific_tpu_torch import native_build

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "rans.cc")


def enabled() -> bool:
    return os.environ.get("HIFIC_TPU_TORCH_NATIVE", "1") != "0"


class _Library:
    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                built = native_build.build_library(
                    "rans", [SOURCE], ["g++"] + native_build.GXX_FLAGS)
                lib = ctypes.CDLL(built.path)
                i64 = ctypes.c_int64
                i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
                u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
                lib.rans_encode_indexed.restype = ctypes.c_int64
                lib.rans_encode_indexed.argtypes = [
                    i32p, i32p, i64, i64, u32p, i32p, i32p, i64,
                    ctypes.c_int, u32p, i64]
                lib.rans_decode_indexed.restype = None
                lib.rans_decode_indexed.argtypes = [
                    u32p, i64, i32p, i64, i64, u32p, i32p, i32p, i64, i32p,
                    ctypes.c_int, i32p]
                self._lib = lib
            return self._lib


_LIBRARY = _Library()


def encode_lanes(symbols_l, indices_l, cdf, cdf_length, cdf_offset,
                 precision: int) -> np.ndarray:
    """symbols_l/indices_l: (n_pos, n_lanes), lane layout applied."""
    lib = _LIBRARY.get()
    n_pos, n_lanes = symbols_l.shape
    symbols_l = np.ascontiguousarray(symbols_l, np.int32)
    indices_l = np.ascontiguousarray(indices_l, np.int32)
    cdf = np.ascontiguousarray(cdf, np.uint32)
    cdf_length = np.ascontiguousarray(cdf_length, np.int32)
    cdf_offset = np.ascontiguousarray(cdf_offset, np.int32)
    cap = 2 * n_lanes + 4 * n_pos * n_lanes + 1024
    for _ in range(2):  # a negative return is the capacity it needs
        out = np.empty(cap, np.uint32)
        n = lib.rans_encode_indexed(symbols_l, indices_l, n_pos, n_lanes,
                                    cdf, cdf_length, cdf_offset, cdf.shape[1],
                                    precision, out, cap)
        if n >= 0:
            return out[:n].copy()
        cap = -n
    raise RuntimeError("rans_encode_indexed: capacity retry failed")


def decode_lanes(encoded, indices_l, cdf, cdf_length, cdf_offset, inverse,
                 precision: int) -> np.ndarray:
    lib = _LIBRARY.get()
    n_pos, n_lanes = indices_l.shape
    encoded = np.ascontiguousarray(encoded, np.uint32)
    indices_l = np.ascontiguousarray(indices_l, np.int32)
    out = np.empty((n_pos, n_lanes), np.int32)
    lib.rans_decode_indexed(
        encoded, len(encoded), indices_l, n_pos, n_lanes,
        np.ascontiguousarray(cdf, np.uint32),
        np.ascontiguousarray(cdf_length, np.int32),
        np.ascontiguousarray(cdf_offset, np.int32), cdf.shape[1],
        np.ascontiguousarray(inverse, np.int32), precision, out)
    return out
