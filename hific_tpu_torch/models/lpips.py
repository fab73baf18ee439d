"""LPIPS perceptual distance (net-lin, AlexNet or VGG16 backbone);
counterpart of the JAX package's `models/lpips.py` (`LPIPS`,
`AlexNetFeatures`, `VGG16Features`, `Dist2LogitLayer`,
`bce_ranking_loss`).

Backbone features at five taps (after each ReLU of torchvision AlexNet's
`.features`, or at VGG16's relu1_2, 2_2, 3_3, 4_3 and 5_3), each
unit-normalized over channels as f / sqrt(sum_C f^2 + 1e-10), squared
differences weighted by the 1x1 "lin" heads (applied raw, as at the
reference's evaluation), averaged over space and summed over taps. Inputs
in [-1, 1], or in [0, 1] with `normalize=True`.

The lin heads are the calibrated ones packaged in `assets/` (copies of the
JAX package's, one file a net). The backbone here is a seeded random
initialisation, the one the JAX trainer uses under
`--uncalibrated_lpips_ok`: the architecture is exact, the features are not
perceptually calibrated. Carry calibrated or JAX parameters across with
`weights.lpips_state_dict_from_jax`; `load_lpips` reads the two files the
JAX package's evaluation CLIs take (a full LPIPS `.npz`, or a torchvision
`.features` state_dict), and `save_lpips_npz` writes the first.
Parameters never train: gradients flow through LPIPS to the
reconstruction, not into LPIPS. The CLIs use AlexNet, as the JAX
package's do.
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
VGG_CHNS = (64, 128, 256, 512, 512)
LIN_CHANNELS = {"alex": ALEX_CHNS, "vgg": VGG_CHNS}
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


class VGG16Features(nn.Module):
    """torchvision VGG16 `.features` (13 3x3 convs, `conv0` .. `conv12`),
    tapped at relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, with a 2x2
    max-pool between blocks."""

    BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self):
        super().__init__()
        idx, c_in = 0, 3
        for c, n_convs in self.BLOCKS:
            for _ in range(n_convs):
                self.add_module(f"conv{idx}", nn.Conv2d(c_in, c, 3,
                                                        padding=1))
                idx, c_in = idx + 1, c

    def forward(self, x):
        taps = []
        convs = iter(self.children())
        for block, (_, n_convs) in enumerate(self.BLOCKS):
            if block:
                x = F.max_pool2d(x, 2, 2)
            for _ in range(n_convs):
                x = torch.relu(next(convs)(x))
            taps.append(x)
        return taps


class LPIPS(nn.Module):
    """net-lin LPIPS distance of two NCHW images: (N, 1, 1, 1)."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        if net not in LIN_CHANNELS:
            raise ValueError(f"LPIPS net must be one of "
                             f"{tuple(LIN_CHANNELS)}, got {net!r}")
        self.backbone = AlexNetFeatures() if net == "alex" else VGG16Features()
        for k, c in enumerate(LIN_CHANNELS[net]):
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


class Dist2LogitLayer(nn.Module):
    """Two per-image LPIPS distances -> a [0, 1] preference score, the
    reference's Dist2LogitLayer: 1x1 convs over the channel vector (d0, d1,
    d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)) with leaky ReLUs between.
    d0, d1: (N, 1, H, W), as `LPIPS` returns them."""

    def __init__(self, chn_mid: int = 32, use_sigmoid: bool = True):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        self.fc0 = nn.Conv2d(5, chn_mid, 1)
        self.fc1 = nn.Conv2d(chn_mid, chn_mid, 1)
        self.fc2 = nn.Conv2d(chn_mid, 1, 1)

    def forward(self, d0, d1, eps: float = 0.1):
        x = torch.cat([d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)],
                      dim=1)
        x = F.leaky_relu(self.fc0(x), 0.2)
        x = F.leaky_relu(self.fc1(x), 0.2)
        x = self.fc2(x)
        return torch.sigmoid(x) if self.use_sigmoid else x


def bce_ranking_loss(logit, judge):
    """The reference's BCERankingLoss: binary cross-entropy of the
    Dist2Logit preference `logit` (the sigmoid output) against human 2AFC
    judgements in [-1, 1], mapped to [0, 1]."""
    per = (judge + 1.0) / 2.0
    eps = 1e-12
    return -torch.mean(per * torch.log(logit + eps)
                       + (1.0 - per) * torch.log(1.0 - logit + eps))


@torch.no_grad()
def load_torch_dist2logit_weights(layer: Dist2LogitLayer, torch_state
                                  ) -> Dist2LogitLayer:
    """Copy the reference Dist2LogitLayer's state_dict (1x1 convs
    `model.0`, `model.2`, `model.4`) into `layer`; returns it."""
    for ours, theirs in (("fc0", "model.0"), ("fc1", "model.2"),
                         ("fc2", "model.4")):
        conv = getattr(layer, ours)
        conv.weight.copy_(torch.as_tensor(torch_state[f"{theirs}.weight"]))
        conv.bias.copy_(torch.as_tensor(torch_state[f"{theirs}.bias"]))
    return layer


@torch.no_grad()
def default_lpips(seed: int = 0, net: str = "alex") -> LPIPS:
    """The packaged lin heads and a seeded random backbone (truncated-normal
    fan-in init with zero biases, the distribution of the JAX package's
    flax initialisation; the draws differ)."""
    model = LPIPS(net)
    gen = torch.Generator().manual_seed(seed)
    for conv in model.backbone.children():
        fan_in = conv.weight[0].numel()
        # flax's lecun_normal: a unit-variance normal truncated at +-2.
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std,
                              generator=gen)
        conv.bias.zero_()
    with np.load(os.path.join(ASSETS_DIR, f"lpips_lin_{net}.npz")) as lin:
        for k in range(len(LIN_CHANNELS[net])):
            getattr(model, f"lin{k}").copy_(
                torch.from_numpy(lin[f"lin{k}"].astype(np.float32)))
    return model


# torchvision `.features` index of each backbone conv.
TORCHVISION_FEATURES = {
    "alex": (0, 3, 6, 8, 10),
    "vgg": (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
}


@torch.no_grad()
def load_lpips(params_npz: Optional[str] = None,
               backbone_path: Optional[str] = None,
               lin_path: Optional[str] = None,
               seed: int = 0, net: str = "alex") -> Tuple[LPIPS, bool]:
    """(LPIPS, calibrated). params_npz: the JAX package's full LPIPS
    parameter snapshot (`save_lpips_npz`, '/'-joined leaves), calibrated.
    backbone_path: a torchvision AlexNet or VGG16 `.features` state_dict,
    calibrated. lin_path: the lin heads as released with LPIPS v0.1
    (`alex.pth` / `vgg.pth`, keys `lin{k}.model.1.weight`) in place of the
    packaged ones. Without params_npz or backbone_path the backbone is
    `default_lpips(seed, net)`'s, not calibrated."""
    from hific_tpu_torch.weights import lpips_state_dict_from_jax

    model = default_lpips(seed, net)
    if params_npz is not None:
        with np.load(params_npz) as z:
            model.load_state_dict(
                lpips_state_dict_from_jax({k: z[k] for k in z.files}))
        return model, True
    if lin_path is not None:
        lin = torch.load(lin_path, map_location="cpu", weights_only=True)
        for k in range(len(LIN_CHANNELS[net])):
            getattr(model, f"lin{k}").copy_(
                lin[f"lin{k}.model.1.weight"].reshape(-1))
    if backbone_path is not None:
        state = torch.load(backbone_path, map_location="cpu",
                           weights_only=True)
        for conv, idx in zip(model.backbone.children(),
                             TORCHVISION_FEATURES[net]):
            conv.weight.copy_(state[f"{idx}.weight"])
            conv.bias.copy_(state[f"{idx}.bias"])
    return model, backbone_path is not None


def save_lpips_npz(path: str, model: LPIPS) -> None:
    """The JAX package's `save_lpips_npz` file of `model`'s parameters:
    '/'-joined leaves, HWIO kernels, float32, so `load_lpips` here and the
    JAX package's `load_lpips_npz` both read it."""
    from hific_tpu_torch.weights import jax_lpips_params_from_model

    np.savez(path, **jax_lpips_params_from_model(model))
