"""ctypes bindings of the device rANS kernels (`csrc/rans_device.cu`).

The library is built with plain nvcc for sm_90a at first use into
`hific_tpu_torch/_build/` (`native_build.py`); a failed build raises. Each
entry point codes a batch of streams in one call, described by a row of
int64 fields per stream (the `EncodeStream` / `DecodeStream` structs of the
source), which the launcher packs in pinned memory, copies to the device on
the current stream and passes with its host copy; it allocates the
encoder's scratch. Each kernel keeps a count of its launches, one per call,
so that a run can show which path went through it. `device_encode.py` and
`device_decode.py` check their arguments and call these; the launchers
check only what ctypes needs.
"""

import ctypes
import os
import threading

import torch

from hific_tpu_torch import native_build

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "rans_device.cu")
MAX_LANES = 1024  # kMaxLanes in rans_device.cu: one thread per lane
# kMaxEventsPerPosition: 1 + 8 nibble rounds + 1 marker round.
MAX_EVENTS_PER_POSITION = 10

_P, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _INT, _INT, _P]


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
                for name in ("hific_rans_encode", "hific_rans_decode"):
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = _ARGTYPES
                self._lib = lib
            return self._lib


LIBRARY = RansLibrary()


def encode_descriptors(jobs, outs):
    """The `EncodeStream` rows of a batch and the scratch they point to
    (allocated here, on the jobs' device): per stream the plan [P], the
    events' (ballot, warp cursor) pairs and chunk places [10 P, W], and each
    warp's ring of spilled words [W, spill_cap + 32]."""
    device = jobs[0].sym_l.device
    rows, scratch, block_base = [], [], 0
    for job, (stream, lens, counts) in zip(jobs, outs):
        p, lanes = job.sym_l.shape
        warps = -(-lanes // 32)
        ring = job.spill_cap + 32
        entries = MAX_EVENTS_PER_POSITION * p * warps
        plan, events, base, words = (
            torch.empty(n, dtype=torch.int32, device=device)
            for n in (max(p, 1), max(2 * entries, 2), max(entries, 1),
                      warps * ring))
        scratch += [plan, events, base, words]
        t = job.tables
        rows.append([
            job.sym_l.data_ptr(), job.idx_l.data_ptr(), t.blob.data_ptr(),
            plan.data_ptr(), events.data_ptr(), base.data_ptr(),
            words.data_ptr(), stream.data_ptr(), lens.data_ptr(),
            counts.data_ptr(), p, lanes, t.rows, t.encode_words, t.cdf_word,
            job.spill_cap, job.lens_cap, ring, block_base])
        block_base += warps
    return rows, scratch


def decode_descriptors(jobs, outs, bad):
    """The `DecodeStream` rows of a batch."""
    rows = []
    for k, (job, out) in enumerate(zip(jobs, outs)):
        t = job.tables
        rows.append([
            job.stream.data_ptr(), job.idx_l.data_ptr(), t.blob.data_ptr(),
            out.data_ptr(), bad.data_ptr() + 4 * k, job.stream.shape[0],
            job.idx_l.shape[0], job.idx_l.shape[1], t.rows, t.blob.shape[0],
            t.cdf_word, t.bucket_word, t.shift])
    return rows


def _launch(fn, rows, device, precision: int, what: str) -> None:
    """Descriptors to the device (from pinned memory, on the current
    stream), then the entry point; raises on its CUDA error."""
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    dev = host.to(device, non_blocking=True)
    with torch.cuda.device(device):
        err = fn(host.data_ptr(), dev.data_ptr(), len(rows), precision,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        shapes = [(r[10], r[11]) if what == "rans_encode" else (r[6], r[7])
                  for r in rows]
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"((P, L) of the streams: {shapes})")


class RansEncodeKernel:
    """`rans_encode`: a plan grid (a warp per position), a lane grid (a
    warp per block, a thread per lane), an offsets grid (a block per
    stream) and a scatter grid; one call for a batch of streams."""

    def __init__(self):
        self.launches = 0

    def launch(self, jobs, outs) -> None:
        """jobs: `device_encode.EncodeJob`s; outs: their (stream, lens,
        counts) tensors, zeroed."""
        lib = LIBRARY.load()
        # The scratch tensors go back to the caching allocator when this
        # returns; their memory is reused only by later work on the stream.
        rows, scratch = encode_descriptors(jobs, outs)
        _launch(lib.hific_rans_encode, rows, jobs[0].sym_l.device,
                jobs[0].tables.precision, "rans_encode")
        del scratch
        self.launches += 1


class RansDecodeKernel:
    """`rans_decode`: one thread block per stream, one thread per lane;
    one call for a batch of streams."""

    def __init__(self):
        self.launches = 0

    def launch(self, jobs, outs, bad) -> None:
        """jobs: `device_decode.DecodeJob`s; outs: their (P, L) int32
        symbols; bad: int32 [len(jobs)], zeroed."""
        lib = LIBRARY.load()
        _launch(lib.hific_rans_decode, decode_descriptors(jobs, outs, bad),
                jobs[0].stream.device, jobs[0].tables.precision,
                "rans_decode")
        self.launches += 1


ENCODE_KERNEL = RansEncodeKernel()
DECODE_KERNEL = RansDecodeKernel()
