"""Where and under which numerics the port's entry points run.

`resolve_device`: the card unless the caller names another device; no
silent CPU. `fp32_numerics`: the settings a piece of device work states for
itself, restored when it ends, so that one process can run the codec and
the trainer (PyTorch keeps these flags process-wide). `Fetch`: a device
tensor's copy to the host, enqueued without waiting for it.
"""

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names another device."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "hific_tpu_torch on the CPU")
    return device


@contextlib.contextmanager
def fp32_numerics(deterministic: bool):
    """Full fp32 convolutions and matrix products (TF32 off: cuDNN would
    otherwise run fp32 convolutions in TF32, ~3 digits), with cuDNN's
    autotuner off and its algorithms deterministic or not. The previous
    settings come back on exit.

    A bfloat16 config runs under the same settings: its convs compute in
    bfloat16 (cuDNN accumulates them in fp32, as XLA does), and its fp32
    parts (the density, the losses, the codec's hyper synthesis of the
    fp32 symbols) need TF32 off as a float32 config's do. No bfloat16
    product of the model goes to cuBLAS, so its reduced-precision
    reduction setting is never read."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    cudnn.deterministic = deterministic
    cudnn.benchmark = False
    try:
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved


class Fetch:
    """A device tensor's copy to the host, enqueued now on the current
    stream (into pinned memory) and waited for only by `result`."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
