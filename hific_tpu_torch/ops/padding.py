"""Spatial reflect padding of NCHW tensors.

Same semantics as the JAX package's `ops/padding.py`, which pads NHWC arrays
with `jnp.pad(mode="reflect")`: numpy's reflect, which repeats the
reflection when a pad is wider than the axis (a 2x2 latent grid padded to
4x4, say), where `F.pad` refuses. The pad is one gather over the
channels-last tensor's (N, H, W, C) view, so a channels-last input gives a
channels-last output, which is what the norm kernel reads.
"""

import torch


def _reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source row of each padded row: numpy 'reflect' is the periodic
    extension of 0..n-1..1 (period 2(n-1))."""
    idx = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = idx.abs() % period
    return torch.where(idx >= n, period - idx, idx)


def pad_hw(x: torch.Tensor, top: int, bottom: int, left: int, right: int
           ) -> torch.Tensor:
    """Reflect-pad the H and W axes of NCHW `x`."""
    if top == bottom == left == right == 0:
        return x
    _, _, h, w = x.shape
    hi = _reflect_index(h, top, bottom, x.device)
    wi = _reflect_index(w, left, right, x.device)
    nhwc = x.permute(0, 2, 3, 1)
    return nhwc[:, hi[:, None], wi[None, :], :].permute(0, 3, 1, 2)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Symmetric reflect pad of H and W by `pad` (ReflectionPad2d(pad))."""
    return pad_hw(x, pad, pad, pad, pad)


def asymmetric_pad_2x(x: torch.Tensor) -> torch.Tensor:
    """Reflect pad top 1 and right 1 before a stride-2 VALID 3x3 conv, so
    the spatial dims halve exactly (ReflectionPad2d((0, 1, 1, 0)))."""
    return pad_hw(x, 1, 0, 0, 1)


def pad_factor(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Reflect pad H and W (bottom/right) up to multiples of `factor`."""
    h, w = x.shape[2], x.shape[3]
    return pad_hw(x, 0, (factor - h % factor) % factor,
                  0, (factor - w % factor) % factor)
