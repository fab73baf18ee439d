"""ctypes bindings of the device rANS kernels (`csrc/rans_device.cu`).

The library is built with plain nvcc for sm_90a at first use into
`hific_tpu_torch/_build/` (`native_build.py`); a failed build raises. Each
kernel keeps a count of its launches, so that a run can show which path
went through it. `device_encode.py` and `device_decode.py` check their
arguments and call these; the launchers check only what ctypes needs.
"""

import ctypes
import os
import threading

import torch

from hific_tpu_torch import native_build

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "rans_device.cu")
MAX_LANES = 1024  # kMaxLanes in rans_device.cu: one thread per lane

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ENCODE_ARGTYPES = [_P, _P, _I64, _INT, _P, _INT, _P, _P, _INT, _INT,
                    _P, _P, _I64, _P, _I64, _P, _P]
_DECODE_ARGTYPES = [_P, _I64, _P, _I64, _INT, _P, _P, _P, _INT, _INT,
                    _P, _P, _P]


class RansLibrary:
    """The built library of `rans_device.cu`, shared by both kernels."""

    def __init__(self):
        self.built = None
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.built = native_build.build_library(
                    "rans_device", [SOURCE],
                    [native_build.nvcc()] + native_build.NVCC_FLAGS)
                lib = ctypes.CDLL(self.built.path)
                for name, argtypes in (("hific_rans_encode", _ENCODE_ARGTYPES),
                                       ("hific_rans_decode", _DECODE_ARGTYPES)):
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = argtypes
                self._lib = lib
            return self._lib


LIBRARY = RansLibrary()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str, p: int, lanes: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"(P={p}, L={lanes})")


class RansEncodeKernel:
    """`rans_encode`: one thread block per stream, one thread per lane."""

    def __init__(self):
        self.launches = 0

    def launch(self, sym_l, idx_l, tables, precision: int, heads, spill,
               lens, counts) -> None:
        lib = LIBRARY.load()
        p, lanes = sym_l.shape
        with torch.cuda.device(sym_l.device):
            err = lib.hific_rans_encode(
                sym_l.data_ptr(), idx_l.data_ptr(), p, lanes,
                tables.cdf.data_ptr(), tables.cdf.shape[1],
                tables.cdf_length.data_ptr(), tables.cdf_offset.data_ptr(),
                tables.cdf.shape[0], precision, heads.data_ptr(),
                spill.data_ptr(), spill.shape[0], lens.data_ptr(),
                lens.shape[0], counts.data_ptr(), _stream(sym_l))
        _raise_on(err, "rans_encode", p, lanes)
        self.launches += 1


class RansDecodeKernel:
    """`rans_decode`: one thread block per stream, one thread per lane."""

    def __init__(self):
        self.launches = 0

    def launch(self, stream, idx_l, tables, precision: int, out, bad
               ) -> None:
        lib = LIBRARY.load()
        p, lanes = idx_l.shape
        with torch.cuda.device(stream.device):
            err = lib.hific_rans_decode(
                stream.data_ptr(), stream.shape[0], idx_l.data_ptr(), p,
                lanes, tables.t_pair.data_ptr(), tables.maxv.data_ptr(),
                tables.offs.data_ptr(), tables.maxv.shape[0], precision,
                out.data_ptr(), bad.data_ptr(), _stream(stream))
        _raise_on(err, "rans_decode", p, lanes)
        self.launches += 1


ENCODE_KERNEL = RansEncodeKernel()
DECODE_KERNEL = RansDecodeKernel()
