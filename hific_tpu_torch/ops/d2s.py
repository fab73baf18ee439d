"""Depth-to-space rewrite of the generator's full-resolution tail;
counterpart of the JAX package's `ops/d2s.py`.

The generator ends with ConvTranspose(3x3, s2, p1, op1) 120 -> 60,
ChannelNorm + ReLU, a reflect pad of 3 and a 7x7 projection to RGB, all at
the full image resolution. This module computes the same function from the
same parameters on the half-resolution grid with four times the channels,
and forms the full-resolution image only in the final reshape:

    zero pad (bottom 1, right 1) -> conv 2x2 (120 -> 240, VALID)   [upconv]
        -> per-phase ChannelNorm + ReLU                   [60 channels a phase]
        -> phase-shuffled reflect pad of 2 -> conv 5x5 (240 -> 12) [projection]
        -> depth-to-space by 2                            [reshape only]

A packed tensor's channels are ordered (s, t, c): s and t are the row and
column phase of the full-resolution pixel (2i + s, 2j + t) that packed
pixel (i, j) holds in its channels [(2s + t) C, (2s + t + 1) C).

Derivation (rows; columns alike). The transposed conv, with the torch
weight w (I, O, 3, 3), computes out[r] = sum_k w[k] x[u] over r = 2u - 1 + k.
Writing r = 2i + s and u = i + e:

  upconv: k = 1 + s - 2e, in [0, 3)
          -> phase s = 0 reads tap 1 from x[i];
             phase s = 1 reads tap 2 from x[i] and tap 0 from x[i + 1].
          The packed 2x2 kernel's (e = 1, s = 0) taps are zero, and the
          read of x[i + 1] at i = H - 1 falls in the transposed conv's zero
          padding: one zero row and column appended at the bottom and right.

  proj:   out[r] = sum_{d in [0, 7)} w7[d] y[r + d - 3] on the
          reflect(3)-padded full-resolution y. Reading y's packed row
          i + e - 2 at phase a: d = 2e + a - s - 1, in [0, 7) for e in
          [0, 5) -> a 5x5 packed kernel (49 of the 100 (e, a) x (f, b) taps
          nonzero for each output phase), reading packed rows i - 2 .. i + 2.

The full-resolution reflect pad becomes a phase-shuffled pad of the packed
tensor: full row -q reflects to q, so packed row -1 = full rows (-2, -1) =
full rows (2, 1) = [packed row 1 phase 0 | packed row 0 phase 1], a
permutation of channel blocks of existing rows. Packed slots read only by
zero weights (packed row -2 phase 0 is full row -4, beyond the pad) hold a
clamped placeholder, the JAX package's, so the padded tensors agree bit for
bit.

Layouts: the tensors of the model are NCHW stored channels-last, so their
memory is the (N, H, W, C) array the JAX package computes on.
`depth_to_space2`, `packed_reflect_pad2` and `space_to_depth2`
(`ops/s2d.py`) take and return that NHWC view, in the JAX package's axis
order. The packed kernels are built from the torch layouts the model stores
(`(I, O, kh, kw)` for the transposed conv, OIHW for the convs) by
differentiable indexing, in every forward, so gradients and optimizer state
stay on the stored parameters and nothing cached can go stale.
"""

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW stored channels-last -> its contiguous (N, H, W, C) view."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> the NCHW view, channels-last when x is contiguous."""
    return x.permute(0, 3, 1, 2)


def phase_view(y: torch.Tensor, c: int) -> torch.Tensor:
    """Packed NCHW (N, 4C, H, W) channels-last -> (N, C, H, 4W), the same
    memory: each row of C channels is one full-resolution pixel, so a
    ChannelNorm of this view is the per-phase norm. A view, never a copy:
    `view` raises where the memory is not channels-last."""
    n, _, h, w = y.shape
    return nchw(nhwc(y).view(n, h, 4 * w, c))


def packed_from_phases(v: torch.Tensor) -> torch.Tensor:
    """Inverse of `phase_view`: (N, C, H, 4W) channels-last -> the packed
    NHWC view (N, H, W, 4C)."""
    n, c, h, w4 = v.shape
    return nhwc(v).view(n, h, w4 // 4, 4 * c)


def depth_to_space2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 4C) -> (N, 2H, 2W, C); channel order (s, t, c) with s/t
    the output row/col phases."""
    n, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 2 * h, 2 * w, c)


def phase_packed_kernel(w: torch.Tensor, n_taps: int, pad: int
                        ) -> torch.Tensor:
    """(O, C, k, k) stride-1 OIHW kernel -> (4O, 4C, n_taps, n_taps), the
    same conv between packed tensors: in-channel order (a, b, c),
    out-channel order (s, t, o), packed tap e reading kernel row
    2e + a - s + 1 - pad (zero outside [0, k)). The projection here
    (k = 7, 5 taps, pad 2) and the encoder's stem (`ops/s2d.py`, k = 7, 4
    taps, pad 1)."""
    o, c = w.shape[:2]
    w_pad = F.pad(w, (pad, pad, pad, pad))
    e = torch.arange(n_taps, device=w.device)[:, None, None]
    a = torch.arange(2, device=w.device)[None, :, None]
    s = torch.arange(2, device=w.device)[None, None, :]
    ih = 2 * e + a - s + 1                    # (e, a, s) into w_pad
    w2 = w_pad[:, :, ih][..., ih]             # (O, C, e, a, s, f, b, t)
    w2 = w2.permute(4, 7, 0, 3, 6, 1, 2, 5)   # (s, t, O, a, b, C, e, f)
    return w2.reshape(4 * o, 4 * c, n_taps, n_taps)


def upconv_kernel_d2s(w: torch.Tensor) -> torch.Tensor:
    """(I, O, 3, 3) ConvTranspose weight (torch layout) -> (4O, I, 2, 2)
    packed stride-1 OIHW kernel.

    Out-channel order (s, t, o). Tap map: k = 1 + s - 2e (rows), 1 + t - 2f
    (cols); the out-of-range tap k = -1 gets zero weight."""
    i, o, k, _ = w.shape
    assert k == 3
    w_pad = F.pad(w, (1, 0, 1, 0))            # index 0 -> zero
    e = torch.arange(2, device=w.device)[:, None]
    s = torch.arange(2, device=w.device)[None, :]
    ih = 2 + s - 2 * e                        # (e, s) in {0..3}, 0 == zero
    w2 = w_pad[:, :, ih][:, :, :, :, ih]      # (I, O, e, s, f, t)
    w2 = w2.permute(3, 5, 1, 0, 2, 4)         # (s, t, O, I, e, f)
    return w2.reshape(4 * o, i, 2, 2)


def upconv_bias_d2s(b: torch.Tensor) -> torch.Tensor:
    """(O,) -> (4O,): each output phase carries the same bias."""
    return b.repeat(4)


def proj_kernel_d2s(w: torch.Tensor) -> torch.Tensor:
    """(O, C, 7, 7) stride-1 OIHW kernel -> (4O, 4C, 5, 5) packed kernel.

    In-channel order (a, b, c); out-channel order (s, t, o). Tap map:
    d = 2e + a - s - 1 (rows, e in [0, 5)), in [0, 7) else zero."""
    assert w.shape[2] == 7
    return phase_packed_kernel(w, 5, 2)


def proj_bias_d2s(b: torch.Tensor) -> torch.Tensor:
    return b.repeat(4)


def _packed_reflect(y: torch.Tensor, axis: int) -> torch.Tensor:
    """Pad packed axis `axis` (1 rows, 2 columns) of y (N, H, W, 2, 2, C),
    whose phase axis is axis + 2, by 2 on each side with the
    phase-shuffled slots that reproduce a full-resolution reflect(3) pad."""
    n = y.shape[axis]
    ph = axis + 2

    def slot(phase0_src: int, phase1_src: int) -> torch.Tensor:
        return torch.cat([y.narrow(axis, phase0_src, 1).narrow(ph, 0, 1),
                          y.narrow(axis, phase1_src, 1).narrow(ph, 1, 1)],
                         dim=ph)

    # packed -p, phase a = full -2p + a -> reflect -> full 2p - a:
    #   a = 0 -> packed p phase 0; a = 1 -> packed p - 1 phase 1.
    # Slot -2 phase 0 (full -4) lies beyond the reflect(3) pad: zero
    # weighted, a clamped placeholder.
    # packed n + p, phase a = full 2(n + p) + a -> reflect (2n - 1 + q ->
    # 2n - 1 - q): slot n: a = 0 -> packed n - 1 phase 0, a = 1 -> packed
    # n - 2 phase 1; slot n + 1: a = 0 -> packed n - 2 phase 0, a = 1 beyond
    # the pad (zero weighted).
    return torch.cat([slot(min(2, n - 1), 1), slot(1, 0), y,
                      slot(n - 1, n - 2), slot(n - 2, max(n - 2, 0))],
                     dim=axis)


def packed_reflect_pad2(y: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 4C) packed tensor (channel order (a, b, c)) -> (N, H + 4,
    W + 4, 4C): the packed image of a reflect pad of 3 of the
    full-resolution tensor. Needs H, W >= 2. Rows, then columns: reflect
    is separable per axis, so the corners are the double reflections."""
    n, h, w, c4 = y.shape
    assert h >= 2 and w >= 2, "packed reflect pad needs H, W >= 2"
    y = y.reshape(n, h, w, 2, 2, c4 // 4)
    y = _packed_reflect(_packed_reflect(y, 1), 2)
    return y.reshape(n, h + 4, w + 4, c4)


def generator_tail_d2s(x: torch.Tensor, w_up: torch.Tensor,
                       b_up: torch.Tensor,
                       norm: Callable[[torch.Tensor], torch.Tensor],
                       w_out: torch.Tensor, b_out: torch.Tensor,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The generator's last upsample and RGB projection on the packed
    half-resolution grid.

    x: (N, C, H, W) channels-last, the activations entering the last
    transposed conv (w_up (C, O, 3, 3), b_up (O,)); norm: the ChannelNorm +
    ReLU of its O channels, applied to the (N, O, H, 4W) per-phase view
    (`phase_view`) in one call; w_out (3, O, 7, 7), b_out (3,): the
    projection. Computes in `dtype` (x's without one). Returns
    (N, 3, 2H, 2W) channels-last: the function of ConvTranspose ->
    ChannelNorm + ReLU -> reflect_pad(3) -> Conv7x7.
    """
    compute = dtype or x.dtype
    o_up = w_up.shape[1]
    # The (s = 1, e = 1) taps read x[i + 1], which at the last row and
    # column falls in the transposed conv's zero padding.
    xp = nchw(F.pad(nhwc(x), (0, 0, 0, 1, 0, 1)))
    y = F.conv2d(xp.to(compute), upconv_kernel_d2s(w_up).to(compute),
                 upconv_bias_d2s(b_up).to(compute))
    y = packed_from_phases(norm(phase_view(y, o_up)))
    yp = nchw(packed_reflect_pad2(y))
    z = F.conv2d(yp, proj_kernel_d2s(w_out).to(yp.dtype),
                 proj_bias_d2s(b_out).to(yp.dtype))
    return nchw(depth_to_space2(nhwc(z)))
