"""Image quality metrics: PSNR, SSIM, MS-SSIM over NHWC tensors;
counterpart of the JAX package's `utils/metrics.py`.

The same Gaussian window, the same separable valid blur per channel (here a
depthwise `F.conv2d` along H, then along W), the same 2x2 average pool and
MS-SSIM weights. Inputs may be numpy arrays or tensors on any device; every
function computes in float32 with TF32 off, whatever the images' dtype, and
returns one value per image on the images' device.
"""

import math

import torch
import torch.nn.functional as F

from hific_tpu_torch.runtime import fp32_numerics

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)

# Metrics are reported numbers: a TF32 blur keeps ~3 digits.
_metric_numerics = fp32_numerics(deterministic=True)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def psnr(a, b, max_val: float = 1.0) -> torch.Tensor:
    """Per-image PSNR in dB of NHWC batches."""
    a = _f32(a)
    mse = torch.mean(torch.square(a - _f32(b).to(a.device)), dim=(1, 2, 3))
    return 20.0 * math.log10(max_val) - 10.0 * torch.log10(mse)


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / torch.sum(g)


def _blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable valid blur of NCHW `x` with a 1-D window along H, then W,
    per channel."""
    c, k = x.shape[1], window.shape[0]
    x = F.conv2d(x, window.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, window.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def _ssim_per_channel(a, b, max_val, filter_size, filter_sigma,
                      k1=0.01, k2=0.03):
    """NCHW float32 -> (mean SSIM, mean contrast-structure), each (N, C)."""
    window = _gaussian_window(filter_size, filter_sigma, a.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_a, mu_b = _blur(a, window), _blur(b, window)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa = _blur(a * a, window) - mu_aa
    sigma_bb = _blur(b * b, window) - mu_bb
    sigma_ab = _blur(a * b, window) - mu_ab
    luminance = (2.0 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    cs = (2.0 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    return (torch.mean(luminance * cs, dim=(2, 3)),
            torch.mean(cs, dim=(2, 3)))


def _nchw(a, b):
    a = _f32(a)
    return a.permute(0, 3, 1, 2), _f32(b).to(a.device).permute(0, 3, 1, 2)


@_metric_numerics
def ssim(a, b, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM per image, NHWC in [0, max_val]."""
    s, _ = _ssim_per_channel(*_nchw(a, b), max_val, filter_size,
                             filter_sigma)
    return torch.mean(s, dim=-1)


@_metric_numerics
def ms_ssim(a, b, max_val: float = 1.0, filter_size: int = 11,
            filter_sigma: float = 1.5, weights=MS_SSIM_WEIGHTS
            ) -> torch.Tensor:
    """Multi-scale SSIM per image. H and W must be >= filter_size * 2^4."""
    a, b = _nchw(a, b)
    weights = torch.tensor(weights, dtype=torch.float32, device=a.device)
    levels = weights.shape[0]
    mcs = []
    for i in range(levels):
        s, cs = _ssim_per_channel(a, b, max_val, filter_size, filter_sigma)
        if i < levels - 1:
            mcs.append(torch.mean(torch.relu(cs), dim=-1))
            a, b = F.avg_pool2d(a, 2), F.avg_pool2d(b, 2)
    s = torch.mean(torch.relu(s), dim=-1)
    mcs = torch.stack(mcs, dim=0)  # (levels - 1, N)
    return torch.prod(mcs ** weights[:-1, None], dim=0) * s ** weights[-1]
