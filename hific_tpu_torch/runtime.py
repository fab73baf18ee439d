"""Where and under which numerics the port's entry points run.

`resolve_device`: the card unless the caller names another device; no
silent CPU. `fp32_numerics`: the settings a piece of device work states for
itself, restored when it ends, so that one process can run the codec and
the trainer (PyTorch keeps these flags process-wide).
"""

import contextlib

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
    settings come back on exit."""
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
