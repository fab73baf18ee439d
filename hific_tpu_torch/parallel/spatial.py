"""Spatial partitioning: ONE image's conv stack over a mesh of devices in
row bands with halo context; counterpart of the JAX package's
`parallel/spatial.py`.

The image (or latent map) is split into n row bands, band i on the mesh's
device i. Each band's window, its rows and `halo` rows of true context on
each side, is built on its device from its own rows and its neighbours'
rows, moved there by `tensor.to(device, non_blocking=True)`: the
single-controller analog of the JAX package's chained `ppermute`. The map
runs on the window with the module's replica on that device, and only the
band's core is kept; the cores are gathered in band order. One process
drives every band: launches are asynchronous, so bands on distinct
devices run at once, and bands on one device (a list that names it
several times) run in turn, each at one window's activations.

Exactness is the JAX package's argument: windows are CLAMPED inside the
(padded) image, so a window edge is a true image edge whenever it lies
within `halo` of one and the stack's own border padding fires as it does
on the whole image, while every core sits at least `halo` rows from a
window edge that is not. The encoder needs halo >= 64 pixels (one-sided
receptive extent 49), the generator halo >= ~2 + n_residual_blocks latent
rows (16 is ample). Tensors are NCHW (channels-last), H on axis 2.
"""

import contextlib
import copy
import math
from typing import Callable, Dict

import torch
from torch import nn

from hific_tpu_torch.ops.padding import pad_hw
from hific_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def _on(device: torch.device):
    """The current CUDA device set to `device` while a band runs there."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def band_devices(mesh: Mesh, axis_name: str = DATA_AXIS) -> list:
    """The devices along `axis_name`, in band order (the first member of
    every other axis)."""
    axis = mesh.axis_names.index(axis_name)
    members = mesh.members
    index = [0] * members.ndim
    index[axis] = slice(None)
    return list(members[tuple(index)])


def replicate(module: nn.Module, mesh: Mesh,
              axis_name: str = DATA_AXIS) -> Dict[torch.device, nn.Module]:
    """One replica of `module` per distinct device of the mesh's bands:
    the module itself on its own device, a copy on each other one."""
    home = next(module.parameters()).device
    replicas = {}
    for dev in band_devices(mesh, axis_name):
        if dev not in replicas:
            replicas[dev] = (module if dev == home else
                             copy.deepcopy(module).to(dev))
    return replicas


def make_spatial_map(fn: Callable, mesh: Mesh, scale: int, halo: int,
                     axis_name: str = DATA_AXIS, downsample: bool = True):
    """Wrap `fn(module, window) -> mapped window` (a conv stack that down-
    or up-samples H and W by `scale`) into `sharded(replicas, x)`, which
    applies it to the FULL NCHW `x` in row bands over the mesh's
    `axis_name` devices and returns the assembled output on x's device.
    `replicas` maps each device to its module (`replicate`).

    Requirements (AssertionError, with the JAX package's messages): H % n
    == 0; with `downsample` the band and the halo multiples of `scale`;
    and H >= band + 2 * halo, so that the clamped window fits in the
    image."""
    devices = band_devices(mesh, axis_name)
    n = len(devices)
    h2 = 2 * halo

    def sharded(replicas, x):
        H = x.shape[2]
        if H % n:
            raise AssertionError(f"H={H} not divisible by {n} devices")
        band = H // n
        if downsample and (band % scale or halo % scale):
            raise AssertionError(f"band {band} and halo {halo} must be "
                                 f"multiples of {scale}")
        if n > 1 and band * (n - 1) < h2:
            raise AssertionError(
                f"band {band} too small for halo {halo}: window does not "
                f"fit in the image (need H >= band + 2*halo)")

        if n == 1:
            dev = devices[0]
            with _on(dev):
                return fn(replicas[dev], x.to(dev)).to(x.device)

        bands = [x[:, :, i * band:(i + 1) * band].to(dev, non_blocking=True)
                 for i, dev in enumerate(devices)]
        cores = []
        for i, dev in enumerate(devices):
            start = i * band
            w = min(max(start - halo, 0), H - band - h2)
            end = w + band + h2
            parts = [bands[j][:, :, max(w, j * band) - j * band:
                              min(end, (j + 1) * band) - j * band]
                     .to(dev, non_blocking=True)
                     for j in range(w // band, math.ceil(end / band))]
            with _on(dev):
                y_win = fn(replicas[dev], torch.cat(parts, dim=2))
            if downsample:
                off, size = (start - w) // scale, band // scale
            else:
                off, size = (start - w) * scale, band * scale
            cores.append(y_win[:, :, off:off + size])
        return torch.cat([c.to(x.device, non_blocking=True) for c in cores],
                         dim=2)

    return sharded


def spatial_encode_fn(model_apply: Callable, mesh: Mesh, halo: int = 64,
                      axis_name: str = DATA_AXIS):
    """The partitioned HiFiC encoder (16x downsample). model_apply:
    (module, x) -> latents (e.g. `lambda m, x: m.encoder(x)`)."""
    return make_spatial_map(model_apply, mesh, scale=16, halo=halo,
                            axis_name=axis_name, downsample=True)


def spatial_generate_fn(model_apply: Callable, mesh: Mesh,
                        halo_latents: int = 16, axis_name: str = DATA_AXIS):
    """The partitioned HiFiC generator (16x upsample). model_apply:
    (module, latents) -> image rows (no final crop inside)."""
    return make_spatial_map(model_apply, mesh, scale=16, halo=halo_latents,
                            axis_name=axis_name, downsample=False)


def pad_rows_for_mesh(x: torch.Tensor, mesh: Mesh, factor: int,
                      axis_name: str = DATA_AXIS):
    """Reflect-pad H (bottom) of NCHW `x` to a multiple of n_devices *
    factor; returns (padded, original_h). numpy's reflect, as the JAX
    package's chunked pad and `ops.padding.pad_factor` give it."""
    n = mesh.shape[axis_name]
    h = x.shape[2]
    target = math.ceil(h / (n * factor)) * (n * factor)
    return pad_hw(x, 0, target - h, 0, 0), h
