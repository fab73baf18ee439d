"""Space-to-depth rewrite of the encoder's full-resolution front;
counterpart of the JAX package's `ops/s2d.py`.

The encoder opens with a 7x7 stride-1 conv on the 3 input channels and a
3x3 stride-2 conv on 60 channels. This module computes the same function
from the same parameters on the half-resolution space-to-depth grid:

    reflect_pad(3) -> conv 7x7 (3 -> 60) -> ChannelNorm + ReLU
        -> asymmetric reflect pad -> conv 3x3 s2 (60 -> 120)

becomes

    reflect_pad(3) -> space-to-depth by 2 -> conv 4x4 (12 -> 240, VALID)  [stem]
        -> per-phase ChannelNorm + ReLU                    [60 channels a phase]
        -> edge pad (top 1, right 1) -> conv 2x2 (240 -> 120)             [down0]

The packed stem's output channel (s, t, o) holds full-resolution pixel
(2u + s, 2v + t) channel o, so the stride-2 down conv reads the packed
tensor directly and lands at its own half resolution: no depth-to-space at
all. The norm after the down conv (`norm_down0`) stays with the caller.

Derivation (indices in padded-image space; a/b the input row/col phase,
s/t the output row/col phase, e/f the half-resolution kernel taps):

  stem:  y[2u + s] = sum_di w[di] x_p[2u + s + di]; substituting
         x_p[2(u + e) + a] gives di = 2e + a - s, in [0, 7) -> e in [0, 4)
  down0: z[i] = sum_di w[di] y[2i + di - 1] (the top reflect pad), so the
         packed tap (e, a) maps to di = 2e + a - 1, in [0, 3) -> e in [0, 2);
         columns dj = 2f + b (the right reflect pad). Out-of-range taps get
         zero weight.

The reflect pads survive as an edge pad of the packed tensor: packed row -1
is read only at phase a = 1 (full row -1 = reflected full row 1 = phase 1
of packed row 0), and packed column W/2 only at phase b = 0 (full column W
= reflected column W - 2 = phase 0 of packed column W/2 - 1), so repeating
the edge packed row and column gives the values the nonzero weights read.

Layouts as in `ops/d2s.py`: `space_to_depth2` takes and returns the NHWC
view of a channels-last NCHW tensor; the packed kernels are built from the
OIHW weights in every forward.
"""

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from hific_tpu_torch.ops.d2s import (nchw, nhwc, packed_from_phases,
                                     phase_packed_kernel, phase_view)
from hific_tpu_torch.ops.padding import reflect_pad


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C); channel order (a, b, c) with a/b
    the row/col phases. H and W must be even."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def stem_kernel_s2d(w: torch.Tensor) -> torch.Tensor:
    """(O, C, 7, 7) stride-1 OIHW kernel -> (4O, 4C, 4, 4) packed kernel.

    In-channel order (a, b, c); out-channel order (s, t, o)."""
    assert w.shape[2] == 7
    return phase_packed_kernel(w, 4, 1)


def stem_bias_s2d(b: torch.Tensor) -> torch.Tensor:
    """(O,) -> (4O,): each output phase carries the same bias."""
    return b.repeat(4)


def down0_kernel_s2d(w: torch.Tensor) -> torch.Tensor:
    """(O, C, 3, 3) stride-2 OIHW kernel -> (O, 4C, 2, 2) packed stride-1
    kernel reading the packed (a, b, c) channel order."""
    o, c, k, _ = w.shape
    assert k == 3
    # Rows: di = 2e + a - 1, so one zero row in front makes index 2e + a
    # hit w[2e + a - 1]; columns: dj = 2f + b, one zero column behind for
    # the (f = 1, b = 1) -> dj = 3 tap.
    w_pad = F.pad(w, (0, 1, 1, 0))
    e = torch.arange(2, device=w.device)[:, None]
    a = torch.arange(2, device=w.device)[None, :]
    ih = 2 * e + a                            # (e, a) and (f, b) into w_pad
    w2 = w_pad[:, :, ih][..., ih]             # (O, C, e, a, f, b)
    w2 = w2.permute(0, 3, 5, 1, 2, 4)         # (O, a, b, C, e, f)
    return w2.reshape(o, 4 * c, 2, 2)


def edge_pad_top_right(y: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H + 1, W + 1, C), the first row repeated above
    and the last column repeated on the right."""
    y = torch.cat([y[:, :1], y], dim=1)
    return torch.cat([y, y[:, :, -1:]], dim=2)


def encoder_front_s2d(x: torch.Tensor, w_stem: torch.Tensor,
                      b_stem: torch.Tensor,
                      norm: Callable[[torch.Tensor], torch.Tensor],
                      w_d0: torch.Tensor, b_d0: torch.Tensor,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The encoder's first two stages on the packed half-resolution grid.

    x: (N, 3, H, W) channels-last with H, W even (the codec pads to
    multiples of 16 first); w_stem (O, 3, 7, 7), b_stem (O,); norm: the
    ChannelNorm + ReLU of the stem's O channels, applied to the
    (N, O, H/2, 2W) per-phase view (`ops.d2s.phase_view`) in one call;
    w_d0 (O1, O, 3, 3), b_d0 (O1,). Computes in `dtype` (x's without one).
    Returns (N, O1, H/2, W/2) channels-last: the function of reflect_pad ->
    conv_stem -> ChannelNorm + ReLU -> asymmetric pad -> conv_down0 (the
    norm after it is the caller's).
    """
    compute = dtype or x.dtype
    xp = nchw(space_to_depth2(nhwc(reflect_pad(x, 3))))
    y = F.conv2d(xp.to(compute), stem_kernel_s2d(w_stem).to(compute),
                 stem_bias_s2d(b_stem).to(compute))
    y = packed_from_phases(norm(phase_view(y, w_stem.shape[0])))
    y = nchw(edge_pad_top_right(y))
    return F.conv2d(y, down0_kernel_s2d(w_d0).to(y.dtype),
                    b_d0.to(y.dtype))
