"""Tiling with halo overlap: a map applied tile by tile to an image of any
size, so that its activations are one tile's; counterpart of the JAX
package's `tiling.py`. (Its workspaces need not shrink with the tile: on
an H100 the codec's tiled encode lowers its peak device memory and the
tiled decode hardly does, ROADMAP.md section 1.)

Each tile is processed with `halo` pixels of real context on every side
and only its core is kept, so boundary effects stay `halo` pixels away
from every seam. `tiled_apply` and `tiled_upsample_apply` sweep a
reflect-padded grid of fixed-size tiles (a single-tile image reproduces
`fn(x)` exactly); `tiled_downsample_apply` clamps its windows inside the
image, so the encoder's own border padding fires as it does on the whole
image and the assembled latents are exact wherever the halo covers the
encoder's receptive field.

Layouts: `tiled_apply` maps NHWC images to NHWC images, as the JAX
function does. The codec's two maps take the model's NCHW layout in:
`tiled_downsample_apply` returns NCHW latents on the device, and
`tiled_upsample_apply` takes NCHW latents and an `fn` that returns NHWC
image tiles (the codec's output layout), assembled on the host.
"""

import collections
import math
from typing import Callable

import numpy as np
import torch

from hific_tpu_torch.ops.padding import pad_factor, pad_hw
from hific_tpu_torch.runtime import Fetch


def _grid_pad(x: torch.Tensor, tile: int, halo: int):
    """NCHW `x` -> (x reflect-padded by `halo` on every side and up to a
    whole number of tiles at the bottom and right, tile rows, tile
    columns). numpy's reflect, repeated where a pad is wider than the
    axis, as the JAX package's chunked `jnp.pad` gives."""
    _, _, h, w = x.shape
    n_th, n_tw = math.ceil(h / tile), math.ceil(w / tile)
    return (pad_hw(x, halo, halo + n_th * tile - h, halo,
                   halo + n_tw * tile - w), n_th, n_tw)


def tiled_apply(fn: Callable, x, tile: int = 768, halo: int = 128
                ) -> torch.Tensor:
    """Apply `fn` ((1, h, w, C) -> (1, h, w, C), same spatial size) tile by
    tile to an NHWC image (1, H, W, C). Every tile is (tile + 2 halo)
    square; the cores are assembled on the host into a float32 CPU
    tensor. An image within one tile is `fn(x)` itself."""
    x = torch.as_tensor(x)
    if x.shape[0] != 1:
        raise ValueError("tiled_apply is per image")
    _, h, w, c = x.shape
    if h <= tile and w <= tile:
        return fn(x)
    xp, n_th, n_tw = _grid_pad(x.permute(0, 3, 1, 2), tile, halo)
    xp = xp.permute(0, 2, 3, 1)
    out = torch.zeros((1, h, w, c), dtype=torch.float32)
    ext = tile + 2 * halo
    for ti in range(n_th):
        for tj in range(n_tw):
            y0, x0 = ti * tile, tj * tile
            core = fn(xp[:, y0:y0 + ext, x0:x0 + ext, :])[
                :, halo:halo + tile, halo:halo + tile, :]
            ch, cw = min(tile, h - y0), min(tile, w - x0)
            out[:, y0:y0 + ch, x0:x0 + cw, :] = core[:, :ch, :cw, :].cpu()
    return out


def reconstruct_tiled(model_apply_fn: Callable, x, tile: int = 768,
                      halo: int = 128) -> torch.Tensor:
    """Evaluation-mode reconstruction of an NHWC image of any size, tile
    by tile. model_apply_fn: (1, h, w, 3) -> (1, h, w, 3) (pad ->
    encode -> quantise -> generate -> crop)."""
    return tiled_apply(model_apply_fn, x, tile=tile, halo=halo)


def tiled_downsample_apply(fn: Callable, x: torch.Tensor, scale: int,
                           tile: int = 1024, halo: int = 64) -> torch.Tensor:
    """Tile by tile application of a downsampling map (the HiFiC encoder:
    NCHW image (1, 3, h, w) -> latents (1, C, h / scale, w / scale)).
    Returns the latents (1, C, ceil(H / scale), ceil(W / scale)) on fn's
    device.

    The image is first reflect-padded at the bottom and right to a
    multiple of `scale`, as the whole-image encode pads it. Tile windows
    are clamped inside the padded image: near a border a window slides
    inward so that its edge is the image's edge, and interior cores stay
    at least `halo` from every window edge. With `halo` at least the
    encoder's one-sided receptive extent (49 px for the HiFiC stack) the
    assembled latents equal the whole-image encode's.

    tile and halo must be multiples of `scale` (cores are cut in latent
    units)."""
    if x.shape[0] != 1:
        raise ValueError("tiled_downsample_apply is per image")
    if tile % scale or halo % scale:
        raise ValueError(f"tile {tile} and halo {halo} must be multiples of "
                         f"{scale}")
    x = pad_factor(x, scale)
    _, _, h, w = x.shape
    ext = tile + 2 * halo
    ext_h, ext_w = min(ext, h), min(ext, w)
    n_th = math.ceil(h / tile) if h > ext_h else 1
    n_tw = math.ceil(w / tile) if w > ext_w else 1
    if n_th == 1 and n_tw == 1:
        return fn(x)
    rows = []
    for ti in range(n_th):
        c_h0 = ti * tile
        c_h1 = min(c_h0 + tile, h)
        s_h = min(max(c_h0 - halo, 0), h - ext_h)
        row = []
        for tj in range(n_tw):
            c_w0 = tj * tile
            c_w1 = min(c_w0 + tile, w)
            s_w = min(max(c_w0 - halo, 0), w - ext_w)
            window = x[:, :, s_h:s_h + ext_h, s_w:s_w + ext_w].contiguous(
                memory_format=torch.channels_last)
            row.append(fn(window)[
                :, :, (c_h0 - s_h) // scale:(c_h1 - s_h) // scale,
                (c_w0 - s_w) // scale:(c_w1 - s_w) // scale])
        rows.append(torch.cat(row, dim=3))
    return torch.cat(rows, dim=2).contiguous(memory_format=torch.channels_last)


def tiled_upsample_apply(fn: Callable, x: torch.Tensor, scale: int,
                         out_channels: int = 3, tile: int = 48,
                         halo: int = 16, inflight: int = 4) -> np.ndarray:
    """Tile by tile application of an upsampling map (the HiFiC generator:
    NCHW latents (1, C, hl, wl) -> NHWC image (1, hl scale, wl scale,
    out_channels)) on a reflect-padded latent grid with `halo` latents of
    context. Returns the assembled image as a numpy array of fn's dtype.

    Each tile's core is cut on the device and its copy to the host is
    enqueued without waiting (pinned memory); the host waits for a core
    only `inflight` tiles later, so the device computes the next tiles
    while earlier cores cross to the host. The cores not yet waited for
    hold at most inflight (tile scale)^2 out_channels elements of pinned
    host memory; 1 is strictly serial."""
    if x.shape[0] != 1:
        raise ValueError("tiled_upsample_apply is per image")
    _, _, h, w = x.shape
    if h <= tile and w <= tile:
        return Fetch(fn(x)).result()
    xp, n_th, n_tw = _grid_pad(x, tile, halo)
    ext = tile + 2 * halo
    lo, hi = halo * scale, (halo + tile) * scale
    out = None
    pending = collections.deque()  # (y0, x0, core's fetch)

    def drain(y0, x0, fetch):
        nonlocal out
        core = fetch.result()
        if out is None:
            out = np.zeros((1, h * scale, w * scale, out_channels),
                           core.dtype)
        ch, cw = min(tile, h - y0) * scale, min(tile, w - x0) * scale
        out[:, y0 * scale:y0 * scale + ch,
            x0 * scale:x0 * scale + cw, :] = core[:, :ch, :cw, :]

    for ti in range(n_th):
        for tj in range(n_tw):
            y0, x0 = ti * tile, tj * tile
            window = xp[:, :, y0:y0 + ext, x0:x0 + ext].contiguous(
                memory_format=torch.channels_last)
            pending.append((y0, x0, Fetch(fn(window)[:, lo:hi, lo:hi, :])))
            if len(pending) >= max(1, int(inflight)):
                drain(*pending.popleft())
    while pending:
        drain(*pending.popleft())
    return out
