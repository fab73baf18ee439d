"""LPIPS perceptual distance (net-lin, AlexNet backbone); counterpart of
the JAX package's `models/lpips.py` (`LPIPS`, `AlexNetFeatures`).

Backbone features at five taps (after each ReLU of torchvision AlexNet's
`.features`), each unit-normalized over channels as
f / sqrt(sum_C f^2 + 1e-10), squared differences weighted by the 1x1 "lin"
heads (applied raw, as at the reference's evaluation), averaged over space
and summed over taps. Inputs in [-1, 1], or in [0, 1] with
`normalize=True`.

The lin heads are the calibrated ones packaged in `assets/` (a copy of the
JAX package's). The backbone here is a seeded random initialisation, the
one the JAX trainer uses under `--uncalibrated_lpips_ok`: the architecture
is exact, the features are not perceptually calibrated. Carry calibrated
or JAX parameters across with `weights.lpips_state_dict_from_jax`;
`load_lpips` reads the two files the JAX package's evaluation CLIs take
(a full LPIPS `.npz`, or a torchvision AlexNet `.features` state_dict).
Parameters never train: gradients flow through LPIPS to the
reconstruction, not into LPIPS.
"""

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ImageNet scaling constants of the reference's ScalingLayer.
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
ALEX_CHNS = (64, 192, 384, 256, 256)
ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
EPS = 1e-10


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet `.features`, tapped after each ReLU."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 11, stride=4, padding=2)
        self.conv2 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv3 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv4 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv5 = nn.Conv2d(256, 256, 3, padding=1)

    def forward(self, x):
        taps = []
        x = torch.relu(self.conv1(x))
        taps.append(x)
        x = torch.relu(self.conv2(F.max_pool2d(x, 3, 2)))
        taps.append(x)
        x = torch.relu(self.conv3(F.max_pool2d(x, 3, 2)))
        taps.append(x)
        x = torch.relu(self.conv4(x))
        taps.append(x)
        x = torch.relu(self.conv5(x))
        taps.append(x)
        return taps


class LPIPS(nn.Module):
    """net-lin LPIPS distance of two NCHW images: (N, 1, 1, 1)."""

    def __init__(self):
        super().__init__()
        self.backbone = AlexNetFeatures()
        for k, c in enumerate(ALEX_CHNS):
            self.register_parameter(f"lin{k}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.requires_grad_(False)

    def forward(self, in0, in1, normalize: bool = False):
        if normalize:  # [0, 1] -> [-1, 1]
            in0 = 2.0 * in0 - 1.0
            in1 = 2.0 * in1 - 1.0
        feats0 = self.backbone((in0 - self.shift) / self.scale)
        feats1 = self.backbone((in1 - self.shift) / self.scale)
        val = 0.0
        for k, (f0, f1) in enumerate(zip(feats0, feats1)):
            n0 = f0 * torch.rsqrt(torch.sum(f0 * f0, dim=1, keepdim=True) + EPS)
            n1 = f1 * torch.rsqrt(torch.sum(f1 * f1, dim=1, keepdim=True) + EPS)
            w = getattr(self, f"lin{k}").view(1, -1, 1, 1)
            lin_out = torch.sum((n0 - n1) ** 2 * w, dim=1, keepdim=True)
            val = val + torch.mean(lin_out, dim=(2, 3), keepdim=True)
        return val


@torch.no_grad()
def default_lpips(seed: int = 0) -> LPIPS:
    """The packaged lin heads and a seeded random backbone (truncated-normal
    fan-in init with zero biases, the distribution of the JAX package's
    flax initialisation; the draws differ)."""
    model = LPIPS()
    gen = torch.Generator().manual_seed(seed)
    for conv in model.backbone.children():
        fan_in = conv.weight[0].numel()
        # flax's lecun_normal: a unit-variance normal truncated at +-2.
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std,
                              generator=gen)
        conv.bias.zero_()
    with np.load(os.path.join(ASSETS_DIR, "lpips_lin_alex.npz")) as lin:
        for k in range(len(ALEX_CHNS)):
            getattr(model, f"lin{k}").copy_(
                torch.from_numpy(lin[f"lin{k}"].astype(np.float32)))
    return model


# torchvision AlexNet `.features` index of each backbone conv.
_TORCHVISION_ALEX = (0, 3, 6, 8, 10)


@torch.no_grad()
def load_lpips(params_npz: Optional[str] = None,
               backbone_path: Optional[str] = None,
               lin_path: Optional[str] = None,
               seed: int = 0) -> Tuple[LPIPS, bool]:
    """(LPIPS, calibrated). params_npz: the JAX package's full LPIPS
    parameter snapshot (`save_lpips_npz`, '/'-joined leaves), calibrated.
    backbone_path: a torchvision AlexNet `.features` state_dict,
    calibrated. lin_path: the lin heads as released with LPIPS v0.1
    (`alex.pth`, keys `lin{k}.model.1.weight`) in place of the packaged
    ones. Without params_npz or backbone_path the backbone is
    `default_lpips(seed)`'s, not calibrated."""
    from hific_tpu_torch.weights import lpips_state_dict_from_jax

    model = default_lpips(seed)
    if params_npz is not None:
        with np.load(params_npz) as z:
            model.load_state_dict(
                lpips_state_dict_from_jax({k: z[k] for k in z.files}))
        return model, True
    if lin_path is not None:
        lin = torch.load(lin_path, map_location="cpu", weights_only=True)
        for k in range(len(ALEX_CHNS)):
            getattr(model, f"lin{k}").copy_(
                lin[f"lin{k}.model.1.weight"].reshape(-1))
    if backbone_path is not None:
        state = torch.load(backbone_path, map_location="cpu",
                           weights_only=True)
        for k, idx in enumerate(_TORCHVISION_ALEX):
            conv = getattr(model.backbone, f"conv{k + 1}")
            conv.weight.copy_(state[f"{idx}.weight"])
            conv.bias.copy_(state[f"{idx}.bias"])
    return model, backbone_path is not None
