"""Fused ChannelNorm (+ReLU): the CUDA kernel `csrc/channel_norm.cu` and its
plain PyTorch version.

The kernel replaces the Pallas TPU kernel `hific_tpu/ops/pallas_norm.py`
(forward). It reads the channels-last rows of an NCHW tensor, so the
wrapper takes only tensors that are contiguous in `torch.channels_last`
and raises on anything else instead of copying. A tensor on the CPU takes
the plain version; a CUDA tensor launches the kernel or raises.
"""

import ctypes
import os
import threading

import torch

from hific_tpu_torch import native_build
from hific_tpu_torch.ops.channel_norm import channel_norm

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "channel_norm.cu")
MAX_CHANNELS = 1024
ACTS = ("none", "relu")


class ChannelNormKernel:
    """The built library and its launch count (kernel launches only)."""

    def __init__(self):
        self.launches = 0
        self.built = None
        self._lib = None
        self._lock = threading.Lock()

    def library(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.built = native_build.build_library(
                    "channel_norm", [SOURCE],
                    [native_build.nvcc()] + native_build.NVCC_FLAGS)
                lib = ctypes.CDLL(self.built.path)
                for fn in (lib.hific_channel_norm_f32,
                           lib.hific_channel_norm_bf16):
                    fn.restype = ctypes.c_int
                    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_int,
                                   ctypes.c_void_p]
                self._lib = lib
            return self._lib

    def launch(self, x, gamma, beta, out, eps: float, relu: bool) -> None:
        lib = self.library()
        fn = (lib.hific_channel_norm_f32 if x.dtype == torch.float32
              else lib.hific_channel_norm_bf16)
        n, c, h, w = x.shape
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                     out.data_ptr(), n * h * w, c, eps, int(relu), stream)
        if err != 0:
            raise RuntimeError(f"channel_norm kernel launch failed: CUDA "
                               f"error {err} (M={n * h * w}, C={c}, "
                               f"dtype={x.dtype})")
        self.launches += 1


KERNEL = ChannelNormKernel()


def channel_norm_fused_reference(x, gamma, beta, eps: float = 1e-3,
                                 act: str = "none"):
    """Plain PyTorch version of the kernel: fp32 math, output in x's dtype."""
    y = channel_norm(x.float(), gamma.float(), beta.float(), eps)
    if act == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


def channel_norm_fused(x, gamma, beta, eps: float = 1e-3, act: str = "none"):
    """ChannelNorm(+act) of NCHW `x` stored channels-last; gamma, beta (C,)."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("channel_norm_fused takes an NCHW tensor that is "
                         "contiguous in torch.channels_last")
    n, c, h, w = x.shape
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"gamma/beta must have shape ({c},), got "
                         f"{tuple(gamma.shape)} and {tuple(beta.shape)}")
    if x.device.type == "cpu":
        return channel_norm_fused_reference(x, gamma, beta, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"no channel_norm_fused for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"channel_norm_fused takes float32 or bfloat16, "
                         f"got {x.dtype}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{x.device}")
    if not 2 <= c <= MAX_CHANNELS:
        raise ValueError(f"channel_norm_fused takes 2 <= C <= {MAX_CHANNELS}"
                         f", got C={c}")
    out = torch.empty((n, c, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    KERNEL.launch(x, gamma, beta, out, float(eps), act == "relu")
    return out
