"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--weights artifacts/flagship_rd30k_f16.npz]

Drives the port's paths at the flagship's full width: the codec round trip
(image -> .hfc -> image) through `hific_tpu_torch.codec.Codec`, the batch
codec (`compress_many` / `decompress_many` on the device rANS coders), a
6 MP image whole and on tiles, the serving daemon `cli/serve.py` under
concurrent clients, the compress and decompress CLIs, and both stages of
training through the trainer `hific_tpu_torch.cli.train` (compression
steps, then GAN steps warmstarted from them); and holds every kernel of
those paths against its plain PyTorch version:

1. the card's name, power limit and count;
2. builds the kernels from the sources in this checkout, all compilers
   started together (nvcc for `csrc/channel_norm.cu`, which holds the
   ChannelNorm forward and backward kernels, and for `csrc/rans_device.cu`,
   which holds the rANS encode and decode kernels; g++ for the host rANS
   coder);
3. runs the ChannelNorm forward kernel at each of the round trip's 29
   (M, C, act) shapes against its plain version (fp32 within 1e-5; bf16
   within one ulp plus 1e-5 at two shapes), with its time, the plain
   version's time and the memory bound;
4. runs the ChannelNorm backward kernels (the row kernel and the column
   sum of its per-block partial sums) at each of the 29 norm shapes of a
   batch-8, 256x256 flagship training step against their plain version,
   dx, dgamma and dbeta, in fp32 (within 1e-5 of the row's or column's
   scale) and bf16 (dx within one bf16 ulp more), twice with the same bits,
   with the same timings, each kernel also timed alone;
5. loads the flagship weights (seeded random weights of the same
   configuration where the artifact is absent) and builds the codec and
   its tables; then runs rans_encode and rans_decode against their plain
   versions, bit for bit, on seeded symbol planes at the path's shapes (y
   of 1024x1024 and 768x512 images, z of a 1024x1024 one; escape rates 0,
   0.08 and 0.3 and a multi-nibble payload), streams equal to the host
   coder's, with the kernels' times (and us a position), the plain
   versions' and host coder's times and the bound; then a batch of nine
   streams (four 1024x1024 images' y and z, one 768x512 y) in one launch
   of each kernel, every buffer against the plain versions and the host
   coder, with the batch's time and the same streams' one launch each;
6. compress_file -> .hfc -> decompress_file of a seeded smooth 768x512
   image: decoded symbols equal the encoded ones, the forward kernel ran
   exactly once per ChannelNorm (29 launches) and each rANS kernel once
   (the encoder once more where the uncalibrated image overruns its caps),
   and the card's encoder/generator agree with the plain CPU path on a
   64x64 crop (within 1e-3); then, at bench.py's operating point (four
   seeded 1024x1024 images, the encoder's output scaled into 0.20-0.45
   bpp), compress_many and decompress_many: no encode past the default
   caps, one encode launch (all y and z streams) and one decode launch
   (all y streams) for the four images, `.hfc` bytes equal to the host
   coder's and images equal to the host decoder's, and the serial,
   pipelined and device-resident times with the rANS kernels' device time
   in a profiled pass; and the count of coding indices
   where the card's synth_stats differs from the CPU's on one image's
   hyperlatents (reported, not gated); then a seeded 2000x3000 image
   compressed whole and with tile_image=1024, halo_image=64, each file
   decoding on the host coder to the symbols it encoded, the symbols where
   the two encodes differ (measured), decompress(as_uint8) whole against
   tile_latents=64 and 32 (largest pixel difference, measured), one rANS
   launch per leg, each leg's time and peak device memory, and the
   generator's peak on one tile-32 window under deterministic cuDNN and
   with cuDNN free; then `cli/serve.py` in-process on 127.0.0.1 (port 0,
   max_batch 8, batch window 2 ms, the encoder calibrated as in the batch
   phase, one batch of each kind run before the timed window):
   4 client threads POST 4 seeded 768x512 PNGs each to /compress, then
   the bodies to /decompress; each body equals the same codec's
   compress_many([x]) bytes, each PNG its decompress_many pixels, some
   batch holds 2 or more requests and each rANS kernel launched once per
   batch of its kind; requests/s, p50 and p99 per leg and the device busy
   share of one profiled batch of each kind; then `cli.compress.main` on
   two seeded PNGs (768x512, 75x93) per image and with --pipeline 2 (the
   same .hfc bytes, the host coder's, finite PSNR) and `cli.decompress.main` on the files
   (the served codec's pixels); the serving and CLI phases read the
   artifact, or the seeded weights written to a temporary `.npz`;
7. one tiny-config training step on the card against the same step on the
   CPU's plain path (same weights, same noise): loss within 1e-4, every
   gradient within 1e-3 of its leaf's largest;
8. five flagship-width compression steps (batch 8 of seeded 256x256 uint8
   crops, seeded random weights and LPIPS backbone) through the trainer:
   finite losses, a nonzero gradient for every codec parameter, 29
   forward and 29 backward launches per step, the count of incoming
   gradients that were not channels-last, the warm step time and a
   profile of one more step; the final checkpoint is kept for phase 10;
9. one tiny-config G step and then one D step (`hific_config`) on the card
   against the same steps on the CPU's plain path (same weights, noise
   and u): losses within 1e-4, every gradient within 1e-3 of its leaf's
   largest, u after each step within 1e-5;
10. four flagship-width G/D step pairs through the trainer with `-mt
   compression_gan`, warmstarted from phase 8's checkpoint (batch 8 of
   other seeded crops): each step checked as it is called (finite
   losses; a nonzero gradient for every codec parameter in a G step and
   no discriminator gradient after it; a nonzero gradient for every
   discriminator parameter in a D step and the codec's parameters
   unchanged by it; u changed by each call; 29 forward and 29 backward
   launches a G step, 29 and 0 a D step), the warm G and D step times,
   the peak device memory and a profile of one more pair;
11. prints the kernels' JSON line and, last, the device line.

Any failure exits non-zero; no phase catches an error. Needs one CUDA card.
"""

import argparse
import concurrent.futures
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
IMAGE_H, IMAGE_W = 512, 768
FP32_TOL = 1e-5
TIMING_REPS = 20
SEED = 0  # weights (without the artifact), image and kernel inputs
TRAIN_BATCH, TRAIN_CROP, TRAIN_STEPS = 8, 256, 5


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main_path_norm_shapes(config, h: int, w: int):
    """(M, C, act) of every ChannelNorm of one round trip of an h x w
    image, in call order: 5 in the encoder, 2 + 2 per residual block + 4 in
    the generator."""
    from hific_tpu_torch.models.encoder import ENCODER_FILTERS
    from hific_tpu_torch.models.generator import GENERATOR_FILTERS

    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    shapes = [(hp * wp, ENCODER_FILTERS[0], "relu")]
    for i in range(1, 5):
        shapes.append((hp * wp >> (2 * i), ENCODER_FILTERS[i], "relu"))
    hy, wy = -(-(hp // 16) // 4) * 4, -(-(wp // 16) // 4) * 4
    m = hy * wy
    shapes += [(m, config.latent_channels, "none"),
               (m, GENERATOR_FILTERS[0], "none")]
    for _ in range(config.n_residual_blocks):
        shapes += [(m, GENERATOR_FILTERS[0], "relu"),
                   (m, GENERATOR_FILTERS[0], "none")]
    for i in range(1, 5):
        shapes.append((m << (2 * i), GENERATOR_FILTERS[i], "relu"))
    return shapes


def cuda_time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Device time of one call of fn: `reps` calls captured in a CUDA graph,
    replayed between two events, so host launch gaps are not counted."""
    fn()  # warm up (and build) outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bf16_ulp(r: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each value of r (8 significant bits)."""
    a = r.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7.0)


def check_channel_norm(shapes, gen):
    """Kernel vs plain version at every shape; returns the summary."""
    from hific_tpu_torch.ops import fused_norm

    rows, timed = [], {}
    max_err = 0.0
    for m, c, act in shapes:
        x = torch.randn((1, m, 1, c), generator=gen).permute(0, 3, 1, 2)
        x = x.cuda().contiguous(memory_format=torch.channels_last)
        gamma = (1.0 + 0.1 * torch.randn(c, generator=gen)).cuda()
        beta = (0.1 * torch.randn(c, generator=gen)).cuda()
        got = fused_norm.channel_norm_fused(x, gamma, beta, act=act)
        want = fused_norm.channel_norm_fused_reference(x, gamma, beta, act=act)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= FP32_TOL:
            raise AssertionError(f"channel_norm M={m} C={c} act={act}: max "
                                 f"abs err {err} > {FP32_TOL}")
        max_err = max(max_err, err)
        if (m, c, act) not in timed:
            k_ms = cuda_time_ms(
                lambda: fused_norm.channel_norm_fused(x, gamma, beta, act=act))
            p_ms = cuda_time_ms(lambda: fused_norm.channel_norm_fused_reference(
                x, gamma, beta, act=act))
            bound_ms = (2 * m * c * 4 + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
            timed[(m, c, act)] = (k_ms, p_ms, bound_ms)
            log(f"channel_norm M={m:6d} C={c:3d} {act:4s}: err {err:.2e} "
                f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound "
                f"{bound_ms:.4f} ms ({bound_ms / k_ms:.0%} of HBM roofline)")
        rows.append(timed[(m, c, act)])
    for m, c, act in (shapes[0], shapes[-5]):  # bf16 at two shapes
        x = torch.randn((1, m, 1, c), generator=gen).permute(0, 3, 1, 2)
        x = x.cuda().to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        gamma = (1.0 + 0.1 * torch.randn(c, generator=gen)).cuda()
        beta = (0.1 * torch.randn(c, generator=gen)).cuda()
        got = fused_norm.channel_norm_fused(x, gamma, beta, act=act)
        want = fused_norm.channel_norm_fused_reference(x, gamma, beta, act=act)
        diff = (got.float() - want.float()).abs()
        ulp = bf16_ulp(want)
        # One bf16 ulp of the output, plus the fp32 limit: where gamma * x_hat
        # and beta nearly cancel, the two fp32 computations differ by a few
        # fp32 ulps of the terms, which is more than a bf16 ulp of the small
        # result.
        if not bool((diff <= ulp + FP32_TOL).all()):
            raise AssertionError(f"bf16 channel_norm M={m} C={c}: off by "
                                 f"{float((diff - ulp).max())} beyond one ulp")
        beyond = int((diff > ulp).sum())
        log(f"channel_norm bf16 M={m} C={c} {act}: {beyond} of {diff.numel()} "
            f"values beyond one bf16 ulp, by at most "
            f"{float((diff - ulp).clamp_min(0).max()):.2e}")
    return {
        "ms": sum(r[0] for r in rows),
        "plain_ms": sum(r[1] for r in rows),
        "bound_ms": sum(r[2] for r in rows),
        "max_abs_err": max_err,
    }



def train_step_norm_shapes(config, batch: int, crop: int):
    """(M, C, act) of every ChannelNorm of one training step on batch x
    crop x crop crops (no padding: crop is a multiple of 64)."""
    from hific_tpu_torch.models.encoder import ENCODER_FILTERS
    from hific_tpu_torch.models.generator import GENERATOR_FILTERS

    m0 = batch * crop * crop
    shapes = [(m0 >> (2 * i), ENCODER_FILTERS[i], "relu") for i in range(5)]
    m = m0 >> 8
    shapes += [(m, config.latent_channels, "none"),
               (m, GENERATOR_FILTERS[0], "none")]
    for _ in range(config.n_residual_blocks):
        shapes += [(m, GENERATOR_FILTERS[0], "relu"),
                   (m, GENERATOR_FILTERS[0], "none")]
    for i in range(1, 5):
        shapes.append((m << (2 * i), GENERATOR_FILTERS[i], "relu"))
    return shapes


def _norm_inputs(m, c, gen, dtype):
    def rows(scale):
        t = torch.randn((1, m, 1, c), generator=gen) * scale
        return t.permute(0, 3, 1, 2).cuda().to(dtype).contiguous(
            memory_format=torch.channels_last)
    x, g = rows(2.0), rows(1.0)
    gamma = (1.0 + 0.1 * torch.randn(c, generator=gen)).cuda()
    beta = (0.1 * torch.randn(c, generator=gen)).cuda()
    return x, g, gamma, beta


def _backward_error(x, g, gamma, beta, act, got):
    """(max dx err / row scale, max dgamma or dbeta err / column scale, max
    abs dx err, bf16 values beyond one ulp, rows at the ReLU's kink) against
    the plain version. Row scale r * max_C |g * gamma| (dx is a difference
    of such terms); column scale the sum of |terms| of the column. Where
    the ReLU's input is within 1e-5 of its terms' size of 0 either side of
    the kink is right: such rows are left out of the dx error and their
    |terms| out of the sums' error."""
    from hific_tpu_torch.ops import fused_norm

    dx, dgamma, dbeta = got
    c = x.shape[1]
    want_dx, want_dgamma, want_dbeta = \
        fused_norm.channel_norm_backward_reference(x, gamma, beta, g, act=act)
    xf, gf = x.float(), g.float()
    gam, bet = gamma.view(1, c, 1, 1), beta.view(1, c, 1, 1)
    centered = xf - xf.mean(1, keepdim=True)
    r = torch.rsqrt((centered * centered).sum(1, keepdim=True) / (c - 1)
                    + 1e-3)
    x_hat = centered * r
    near = torch.zeros_like(xf, dtype=torch.bool)
    if act == "relu":
        near = (x_hat * gam + bet).abs() <= FP32_TOL * (
            (x_hat * gam).abs() + bet.abs())
    near_row = near.any(dim=1, keepdim=True)
    row = r * (gf * gam).abs().amax(1, keepdim=True)
    diff = (dx.float() - want_dx).abs()
    if x.dtype == torch.bfloat16:
        ulp = bf16_ulp(want_dx)
        beyond = int(((diff > ulp) & ~near_row).sum())
        diff = (diff - ulp).clamp_min(0)
    else:
        beyond = 0
    diff = diff.masked_fill(near_row, 0.0)
    dx_rel = float((diff / row.clamp_min(1e-30)).max())
    kink_g = (gf.abs() * x_hat.abs() * near).sum(dim=(0, 2, 3))
    kink_b = (gf.abs() * near).sum(dim=(0, 2, 3))
    col_g = (gf.abs() * x_hat.abs()).sum(dim=(0, 2, 3))
    col_b = gf.abs().sum(dim=(0, 2, 3))
    sums_rel = max(
        float((((dgamma - want_dgamma).abs() - kink_g).clamp_min(0)
               / col_g.clamp_min(1e-30)).max()),
        float((((dbeta - want_dbeta).abs() - kink_b).clamp_min(0)
               / col_b.clamp_min(1e-30)).max()))
    abs_err = float((dx.float() - want_dx).abs().masked_fill(near_row, 0.0)
                    .max())
    return (dx_rel, sums_rel, abs_err, beyond, int(near_row.sum()),
            float(near.float().mean()))


def check_channel_norm_backward(shapes, gen):
    """Backward kernel vs plain version at every shape (fp32 and bf16);
    timings at each distinct fp32 shape, of the forward kernel too (after a
    check against its plain version), since a training step launches both.
    Returns the summary."""
    from hific_tpu_torch.ops import fused_norm

    timed_shapes, max_err, worst = {}, 0.0, (0.0, 0.0)
    for m, c, act in shapes:
        if (m, c, act) in timed_shapes:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            x, g, gamma, beta = _norm_inputs(m, c, gen, dtype)
            got = fused_norm.channel_norm_backward(x, gamma, beta, g, act=act)
            again = fused_norm.channel_norm_backward(x, gamma, beta, g,
                                                     act=act)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"backward M={m} C={c}: two runs differ")
            dx_rel, sums_rel, abs_err, beyond, kink_rows, kink_share = \
                _backward_error(x, g, gamma, beta, act, got)
            if not (dx_rel <= FP32_TOL and sums_rel <= FP32_TOL
                    and kink_share <= 1e-4):
                raise AssertionError(
                    f"channel_norm backward M={m} C={c} {act} {dtype}: dx "
                    f"off by {dx_rel:.2e} of its row scale, dgamma/dbeta by "
                    f"{sums_rel:.2e} of their column scale (limit "
                    f"{FP32_TOL}); {kink_share:.1e} of the inputs at the "
                    f"ReLU's kink (limit 1e-4)")
            if dtype == torch.float32:
                max_err = max(max_err, abs_err)
                worst = (max(worst[0], dx_rel), max(worst[1], sums_rel))
                k_ms = cuda_time_ms(lambda: fused_norm.channel_norm_backward(
                    x, gamma, beta, g, act=act))
                # The two kernels of the backward, each alone.
                dx_buf = torch.empty_like(x)
                row_ms, col_ms = (cuda_time_ms(
                    lambda: fused_norm.BACKWARD_KERNEL.launch(
                        x, g, gamma, beta, dx_buf, 1e-3, act == "relu",
                        stages=stages)) for stages in (1, 2))
                p_ms = cuda_time_ms(
                    lambda: fused_norm.channel_norm_backward_reference(
                        x, gamma, beta, g, act=act))
                bound_ms = ((3 * m * c * 4 + 4 * c * 4) / HBM_BYTES_PER_S
                            * 1e3)
                y = fused_norm.channel_norm_fused(x, gamma, beta, act=act)
                y_err = float((y - fused_norm.channel_norm_fused_reference(
                    x, gamma, beta, act=act)).abs().max())
                if not y_err <= FP32_TOL:
                    raise AssertionError(f"channel_norm M={m} C={c} {act}: "
                                         f"max abs err {y_err}")
                f_ms = cuda_time_ms(lambda: fused_norm.channel_norm_fused(
                    x, gamma, beta, act=act))
                fp_ms = cuda_time_ms(
                    lambda: fused_norm.channel_norm_fused_reference(
                        x, gamma, beta, act=act))
                f_bound = (2 * m * c * 4 + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
                timed_shapes[(m, c, act)] = (k_ms, p_ms, bound_ms, f_ms,
                                             fp_ms, f_bound, row_ms, col_ms)
                log(f"backward M={m:6d} C={c:3d} {act:4s}: dx err "
                    f"{dx_rel:.1e} of row scale, sums {sums_rel:.1e}, "
                    f"{kink_rows} rows at the kink")
                print(f"    backward M={m} C={c} {act}: kernel {k_ms:.4f} ms "
                      f"(row kernel {row_ms:.4f}, column sum {col_ms:.4f}), "
                      f"plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms, "
                      f"kernel/bound {k_ms / bound_ms:.2f}; forward kernel "
                      f"{f_ms:.4f} ms, plain {fp_ms:.4f} ms, bound "
                      f"{f_bound:.4f} ms", flush=True)
            else:
                log(f"backward bf16 M={m:6d} C={c:3d} {act:4s}: dx beyond "
                    f"one ulp by {dx_rel:.1e} of row scale at most ({beyond} "
                    f"values beyond one ulp), sums {sums_rel:.1e}, "
                    f"{kink_rows} rows at the kink")
    rows = [timed_shapes[s] for s in shapes]
    return {
        "ms": sum(r[0] for r in rows),
        "plain_ms": sum(r[1] for r in rows),
        "bound_ms": sum(r[2] for r in rows),
        "fwd_ms": sum(r[3] for r in rows),
        "fwd_plain_ms": sum(r[4] for r in rows),
        "fwd_bound_ms": sum(r[5] for r in rows),
        "max_abs_err": max_err,
        "worst": worst,
        "per_shape": [
            {"m": m, "c": c, "act": act,
             "launches_per_step": sum(1 for s in shapes if s == (m, c, act)),
             "ms": r[0], "row_kernel_ms": r[6], "column_sum_ms": r[7],
             "plain_ms": r[1], "bound_ms": r[2]}
            for (m, c, act), r in timed_shapes.items()],
    }


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profiled(fn):
    """One call of fn under torch.profiler: (wall ms, the device's kernels
    by self time, longest first, and their sum in ms)."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        _, wall_ms = timed(fn)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    return wall_ms, rows, sum(e.self_device_time_total for e in rows) / 1e3


def print_top(rows, n: int) -> None:
    for e in rows[:n]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


def warm_round_trip(codec, x, card: str) -> None:
    """Steady-state legs of the round trip, their split between the device
    transforms and the host coder, and the device's kernels from
    torch.profiler over one more round trip."""
    from hific_tpu_torch.entropy.container import load_compressed

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "warm.hfc")
        _, enc_ms = timed(lambda: codec.compress_file(x, path))
        _, dec_ms = timed(lambda: codec.decompress_file(path, as_uint8=True))
        _, host_ms = timed(lambda: codec.compress(x, device_encode=False))
        _, sym_ms = timed(lambda: codec.encode_symbols(x))
        out = load_compressed(path)
        _, dsym_ms = timed(lambda: codec.decode_symbols(out))
        log(f"warm round trip: compress_file {enc_ms:.1f} ms (device "
            f"encoder; compress on the host coder {host_ms:.1f} ms, of which "
            f"device transforms + symbol fetch {sym_ms:.1f} ms); "
            f"decompress_file {dec_ms:.1f} ms (device decoder; host rANS + "
            f"synth_stats {dsym_ms:.1f} ms) ({card})")
        def round_trip():
            codec.compress_file(x, path)
            return codec.decompress_file(path, as_uint8=True)

        wall_ms, rows, busy_ms = profiled(round_trip)
    log(f"profiled round trip: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.0%}); top kernels by device "
        f"time:")
    print_top(rows, 10)



def tiny_step_card_vs_cpu() -> str:
    """One tiny-config training step on the card (the kernels) and on the
    CPU (the plain versions), same weights and same noise: loss within
    1e-4, every gradient within 1e-3 of its leaf's largest |gradient|."""
    import hific_tpu_torch.models.hyperprior as hyperprior_module
    from hific_tpu_torch.config import mse_lpips_config
    from hific_tpu_torch.models.hific import HiFiC, init_random_
    from hific_tpu_torch.training.train_step import (
        TrainState, make_optimizers, make_train_step_g)

    cfg = mse_lpips_config(latent_channels=8, n_residual_blocks=1,
                           hyperlatent_filters=16, crop_size=64)
    rng = np.random.RandomState(SEED)
    x = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    noise = {}

    def shared_noise(t, generator):
        key = tuple(t.shape)
        if key not in noise:
            noise[key] = torch.from_numpy(
                rng.uniform(-0.5, 0.5, key).astype(np.float32))
        return t + noise[key].to(t.device)

    init = init_random_(HiFiC(cfg), torch.Generator().manual_seed(SEED))
    grads, losses = [], []
    saved = hyperprior_module.quantize_noise
    hyperprior_module.quantize_noise = shared_noise
    try:
        for device in ("cpu", "cuda"):
            model = HiFiC(cfg)
            model.load_state_dict(init.state_dict())
            model = model.to(device, memory_format=torch.channels_last)
            state = TrainState(0, model, make_optimizers(cfg, model), None)
            diag = make_train_step_g(cfg)(state, x)
            losses.append(float(diag["weighted_compression_loss"]))
            grads.append({n: p.grad.cpu() for n, p in
                          model.named_parameters()})
    finally:
        hyperprior_module.quantize_noise = saved
    loss_rel = abs(losses[1] - losses[0]) / abs(losses[0])
    grad_rel = max(float((grads[1][n] - g).abs().max()
                         / g.abs().max().clamp_min(1e-30))
                   for n, g in grads[0].items())
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-3):
        raise AssertionError(f"tiny training step, card vs CPU: loss off by "
                             f"{loss_rel:.2e}, gradients by {grad_rel:.2e} "
                             f"of their leaf's largest")
    return (f"tiny training step, card vs CPU plain path: loss rel diff "
            f"{loss_rel:.2e} (limit 1e-4), worst gradient leaf "
            f"{grad_rel:.2e} of its largest (limit 1e-3)")


def train_crops(seed: int):
    """Endless (uint8 batch, bpp) pairs of seeded smooth 256x256 crops."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, TRAIN_CROP),
                         np.linspace(0, 1, TRAIN_CROP), indexing="ij")
    while True:
        batch = np.empty((TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3), np.uint8)
        for i in range(TRAIN_BATCH):
            img = np.zeros((TRAIN_CROP, TRAIN_CROP, 3))
            for ch in range(3):
                fy, fx, phase = rng.uniform(0.5, 6.0), rng.uniform(0.5, 6.0), \
                    rng.uniform(0, 2 * np.pi)
                img[..., ch] = 0.5 + 0.3 * np.sin(
                    2 * np.pi * (fy * yy + fx * xx) + phase)
            img += rng.normal(0, 0.03, img.shape)
            batch[i] = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
        yield batch, np.zeros(TRAIN_BATCH, np.float32)


def train_flagship(card: str, n_norms: int, exp_dir: str):
    """TRAIN_STEPS flagship-width compression steps through the trainer,
    its experiments under `exp_dir`; returns (launches of the forward and
    backward kernels, summary, path of the final checkpoint)."""
    from hific_tpu_torch.cli import train as train_cli
    from hific_tpu_torch.ops import fused_norm
    from hific_tpu_torch.training import checkpoints
    from hific_tpu_torch.training.train_step import make_train_step_g

    steps = []

    def on_step(state, diag):
        torch.cuda.synchronize()
        now = time.perf_counter()
        loss = float(diag["weighted_compression_loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"step {state.step}: loss {loss}")
        dead = [n for n, p in state.model.named_parameters()
                if p.grad is None or not bool(p.grad.ne(0).any())]
        if dead:
            raise AssertionError(f"step {state.step}: no gradient for "
                                 f"{len(dead)} parameters, e.g. {dead[:4]}")
        counts = (fused_norm.KERNEL.launches,
                  fused_norm.BACKWARD_KERNEL.launches,
                  fused_norm.BACKWARD_KERNEL.g_copies)
        # A step's time runs from the end of the previous step's checks.
        steps.append((now, time.perf_counter(), loss, float(diag["q_rate"]),
                      counts))

    args = train_cli.parse_args([
        "--steps", str(TRAIN_STEPS), "-bs", str(TRAIN_BATCH),
        "-crop", str(TRAIN_CROP), "--uncalibrated_lpips_ok",
        "--device", "cuda", "--seed", str(SEED),
        "--log_interval", "1000", "--save_interval", "1000",
        "--experiments_dir", exp_dir])
    crops = train_crops(SEED)  # made ahead: not in the step times
    batches = [next(crops) for _ in range(TRAIN_STEPS + 1)]
    fused_norm.KERNEL.launches = 0
    fused_norm.BACKWARD_KERNEL.launches = 0
    fused_norm.BACKWARD_KERNEL.g_copies = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train_cli.run(args, batches=iter(batches[:TRAIN_STEPS]),
                          on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd = fused_norm.KERNEL.launches
    bwd = fused_norm.BACKWARD_KERNEL.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ckpt = checkpoints.latest_checkpoint(os.path.join(
        exp_dir, f"{args.name}_compression_low", "checkpoints"))

    # One more step under the profiler (not counted above, not saved).
    step_fn = make_train_step_g(state.model.config, train_cli.make_lpips_fn(
        args, next(state.model.parameters()).device))
    batch = batches[-1][0]
    step_ms, rows, busy_ms = profiled(lambda: step_fn(state, batch))

    per_step = []
    prev = (0, 0, 0)
    for i, (_, _, loss, q, counts) in enumerate(steps):
        delta = tuple(a - b for a, b in zip(counts, prev))
        prev = counts
        per_step.append(delta)
        if delta[:2] != (n_norms, n_norms):
            raise AssertionError(f"step {i + 1}: {delta[0]} forward and "
                                 f"{delta[1]} backward launches, expected "
                                 f"{n_norms} each")
        log(f"train step {i + 1}: loss {loss:.4f}, q_bpp {q:.4f}, launches "
            f"fwd {delta[0]} bwd {delta[1]}, non-channels-last g copied "
            f"{delta[2]}")
    times = [b[0] - a[1] for a, b in zip(steps, steps[1:])]
    warm_ms = 1e3 * sum(times) / len(times)
    log(f"{TRAIN_STEPS} flagship steps (bs {TRAIN_BATCH}, {TRAIN_CROP}x"
        f"{TRAIN_CROP}, fp32, TF32 off) in {wall:.1f} s through the trainer "
        f"(model build, steps, final checkpoint); warm step {warm_ms:.1f} ms "
        f"(mean of steps 2-{TRAIN_STEPS}, host clock after synchronize; "
        f"{', '.join(f'{1e3 * t:.1f}' for t in times)}); peak device memory "
        f"{peak:.1f} GiB ({card})")
    norm_ms = sum(e.self_device_time_total for e in rows
                  if "channel_norm" in e.key) / 1e3
    log(f"profiled step: wall {step_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / step_ms:.0%}); ChannelNorm kernels {norm_ms:.2f} ms; "
        f"top kernels by device time:")
    print_top(rows, 12)
    return fwd, bwd, {"warm_ms": warm_ms,
                      "copies_per_step": per_step[-1][2]}, ckpt


GAN_PAIRS = 4  # G/D step pairs of the flagship GAN phase


def tiny_gan_steps_card_vs_cpu() -> str:
    """One tiny-config G step and then one D step on the card (the kernels)
    and on the CPU (the plain versions), same weights, noise and u: losses
    within 1e-4, every gradient within 1e-3 of its leaf's largest
    |gradient|, u after each step within 1e-5."""
    import hific_tpu_torch.models.hyperprior as hyperprior_module
    from hific_tpu_torch.config import hific_config
    from hific_tpu_torch.training.train_step import (
        create_train_state, make_train_step_d, make_train_step_g)

    cfg = hific_config(latent_channels=8, n_residual_blocks=1,
                       hyperlatent_filters=16, crop_size=64)
    rng = np.random.RandomState(SEED + 1)
    xg, xd = (rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
              for _ in range(2))
    noise = {}

    def shared_noise(t, generator):
        key = tuple(t.shape)
        if key not in noise:
            noise[key] = torch.from_numpy(
                rng.uniform(-0.5, 0.5, key).astype(np.float32))
        return t + noise[key].to(t.device)

    def grads(module):
        return {n: p.grad.cpu() for n, p in module.named_parameters()}

    def us(state):
        return {n: b.cpu().clone() for n, b in state.disc.named_buffers()}

    runs = []
    saved = hyperprior_module.quantize_noise
    hyperprior_module.quantize_noise = shared_noise
    try:
        for device in ("cpu", "cuda"):
            state = create_train_state(cfg, SEED, device)
            diag_g = make_train_step_g(cfg)(state, xg)
            out = {"losses": [float(diag_g["weighted_compression_loss"]),
                              float(diag_g["gen_loss"])],
                   "grads": grads(state.model), "u": us(state)}
            diag_d = make_train_step_d(cfg)(state, xd)
            out["losses"].append(float(diag_d["disc_loss"]))
            out["grads"].update(
                {f"disc.{n}": g for n, g in grads(state.disc).items()})
            out["u"].update({f"d.{n}": u for n, u in us(state).items()})
            runs.append(out)
    finally:
        hyperprior_module.quantize_noise = saved
    cpu, card = runs
    loss_rel = max(abs(b - a) / abs(a)
                   for a, b in zip(cpu["losses"], card["losses"]))
    grad_rel = max(float((card["grads"][n] - g).abs().max()
                         / g.abs().max().clamp_min(1e-30))
                   for n, g in cpu["grads"].items())
    u_err = max(float((card["u"][n] - u).abs().max())
                for n, u in cpu["u"].items())
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-3 and u_err <= 1e-5):
        raise AssertionError(
            f"tiny G and D steps, card vs CPU: losses off by {loss_rel:.2e}, "
            f"gradients by {grad_rel:.2e} of their leaf's largest, u by "
            f"{u_err:.2e}")
    return (f"tiny G step then D step, card vs CPU plain path: losses "
            f"(G loss, gen_loss, disc_loss) rel diff {loss_rel:.2e} (limit "
            f"1e-4), worst gradient leaf {grad_rel:.2e} of its largest "
            f"(limit 1e-3), u max abs diff {u_err:.2e} (limit 1e-5)")


def train_gan_flagship(card: str, n_norms: int, warmstart: str,
                       exp_dir: str):
    """GAN_PAIRS flagship-width G/D step pairs through the trainer, with
    `-mt compression_gan` warmstarted from the compression checkpoint
    `warmstart`. Each step is checked as it is called: finite losses; in a
    G step a nonzero gradient for every codec parameter and no
    discriminator gradient; in a D step a nonzero gradient for every
    discriminator parameter and the codec's parameters unchanged; u changed
    by each call; n_norms forward and n_norms (G) or 0 (D) backward
    launches. Returns (forward and backward launches, summary)."""
    from hific_tpu_torch.cli import train as train_cli
    from hific_tpu_torch.ops import fused_norm

    def launches():
        return (fused_norm.KERNEL.launches,
                fused_norm.BACKWARD_KERNEL.launches)

    def nonzero(module):
        return [n for n, p in module.named_parameters()
                if p.grad is None or not bool(p.grad.ne(0).any())]

    records = []

    def checked(make, kind):
        def factory(*args, **kw):
            step = make(*args, **kw)

            def run_step(state, x):
                u0 = [b.clone() for b in state.disc.buffers()]
                codec0 = ([p.detach().clone()
                           for p in state.model.parameters()]
                          if kind == "D" else None)
                c0 = launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                diag = step(state, x)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                delta = tuple(b - a for a, b in zip(c0, launches()))
                losses = {k: float(v) for k, v in diag.items()
                          if k in ("disc_loss", "gen_loss",
                                   "weighted_compression_loss")}
                faults = [f"{k} {v}" for k, v in losses.items()
                          if not math.isfinite(v)]
                if kind == "G":
                    dead = nonzero(state.model)
                    faults += [f"no gradient for {len(dead)} codec "
                               f"parameters, e.g. {dead[:3]}"] if dead else []
                    if any(p.grad is not None
                           for p in state.disc.parameters()):
                        faults.append("a discriminator .grad after a G step")
                    want = (n_norms, n_norms)
                else:
                    dead = nonzero(state.disc)
                    faults += [f"no gradient for {dead}"] if dead else []
                    if not all(torch.equal(p, q) for p, q in
                               zip(state.model.parameters(), codec0)):
                        faults.append("the D step moved codec parameters")
                    want = (n_norms, 0)
                if any(torch.equal(a, b)
                       for a, b in zip(u0, state.disc.buffers())):
                    faults.append("u unchanged by the call")
                if delta != want:
                    faults.append(f"norm launches {delta}, expected {want}")
                if faults:
                    raise AssertionError(f"GAN {kind} step {state.step}: "
                                         + "; ".join(faults))
                records.append((kind, ms, losses, delta))
                return diag
            return run_step
        return factory

    args = train_cli.parse_args([
        "-mt", "compression_gan", "--warmstart_ckpt", warmstart,
        "--steps", str(TRAIN_STEPS + GAN_PAIRS), "-bs", str(TRAIN_BATCH),
        "-crop", str(TRAIN_CROP), "--uncalibrated_lpips_ok",
        "--device", "cuda", "--seed", str(SEED),
        "--log_interval", "1000", "--save_interval", "1000",
        "--experiments_dir", exp_dir])
    crops = train_crops(SEED + 1)  # made ahead: not in the step times
    batches = [next(crops) for _ in range(2 * GAN_PAIRS + 2)]
    make_g, make_d = train_cli.make_train_step_g, train_cli.make_train_step_d
    train_cli.make_train_step_g = checked(make_g, "G")
    train_cli.make_train_step_d = checked(make_d, "D")
    try:
        torch.cuda.reset_peak_memory_stats()
        fused_norm.KERNEL.launches = 0
        fused_norm.BACKWARD_KERNEL.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = train_cli.run(args, batches=iter(batches[:2 * GAN_PAIRS]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train_cli.make_train_step_g, train_cli.make_train_step_d = \
            make_g, make_d
    fwd, bwd = launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kinds = "".join(r[0] for r in records)
    if kinds != "GD" * GAN_PAIRS or state.step != TRAIN_STEPS + GAN_PAIRS \
            or state.disc_steps != GAN_PAIRS:
        raise AssertionError(f"GAN phase ran steps {kinds!r} to step "
                             f"{state.step}, D count {state.disc_steps}")
    for i, (kind, ms, losses, delta) in enumerate(records):
        log(f"GAN {kind} step {i // 2 + 1}: {ms:.1f} ms, "
            + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
            + f", launches fwd {delta[0]} bwd {delta[1]}")
    g_ms = [r[1] for r in records if r[0] == "G"][1:]
    d_ms = [r[1] for r in records if r[0] == "D"][1:]
    summary = {"warm_g_step_ms": sum(g_ms) / len(g_ms),
               "warm_d_step_ms": sum(d_ms) / len(d_ms),
               "g_step_ms": [r[1] for r in records if r[0] == "G"],
               "d_step_ms": [r[1] for r in records if r[0] == "D"],
               "peak_gib": peak, "wall_s": wall}
    log(f"{GAN_PAIRS} flagship GAN pairs (bs {TRAIN_BATCH}, {TRAIN_CROP}x"
        f"{TRAIN_CROP}, fp32, TF32 off, warmstarted from "
        f"{os.path.basename(warmstart)}) in {wall:.1f} s through the "
        f"trainer (warmstart load, steps, final checkpoint); warm G step {summary['warm_g_step_ms']:.1f} ms, warm "
        f"D step {summary['warm_d_step_ms']:.1f} ms (means of pairs 2-"
        f"{GAN_PAIRS}, host clock after synchronize); peak device memory "
        f"{peak:.1f} GiB ({card})")

    # One more pair under the profiler (not counted above, not saved).
    device = next(state.model.parameters()).device
    step_g = make_g(state.model.config, train_cli.make_lpips_fn(args, device))
    step_d = make_d(state.model.config)
    (xg, _), (xd, _) = batches[-2:]
    pair_ms, rows, busy_ms = profiled(
        lambda: (step_g(state, xg), step_d(state, xd)))
    summary.update(profiled_pair_ms=pair_ms, profiled_busy_ms=busy_ms)
    log(f"profiled G+D pair: wall {pair_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / pair_ms:.0%}); top kernels by device "
        f"time:")
    print_top(rows, 12)
    return fwd, bwd, summary


def event_ms(fn, reps: int) -> float:
    """Median device time of `reps` calls of fn, each between two CUDA
    events (a serial kernel's time varies with its data, so each call is
    timed alone)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def rans_symbols(codec, kind, p, rate, rng):
    """Seeded (P, L) int32 symbol planes and rows for one stream: y (220
    lanes against the scale tables) from a Gaussian at each row's scale, z
    (320 lanes, the model's factorized tables) around 0; a share `rate`
    pushed past the rows' tracked ranges, or a multi-nibble payload."""
    tables = (codec.conditional.tables if kind == "y"
              else codec.factorized.tables)
    lanes = 220 if kind == "y" else tables.cdf.shape[0]
    if kind == "y":
        idx = rng.randint(0, 40, (p, lanes))
        sym = np.round(rng.randn(p, lanes)
                       * codec.conditional.scale_table[idx])
    else:
        idx = np.broadcast_to(np.arange(lanes), (p, lanes))
        sym = np.round(rng.randn(p, lanes) * 1.5)
    lo = tables.cdf_offset[idx]
    hi = lo + tables.cdf_length[idx] - 3   # the last tracked value
    sym = np.clip(sym, lo, hi)
    if rate == "multi-nibble":
        for v in (30_000, -30_000, 999_999, -999_999):
            sym[rng.randint(p), rng.randint(lanes)] = v
    elif rate:
        esc = rng.rand(p, lanes) < rate
        far = rng.randint(1, 300, (p, lanes))
        sym = np.where(esc & (rng.rand(p, lanes) < 0.5), lo - far, sym)
        sym = np.where(esc & (sym >= lo), hi + far, sym)
    return (np.ascontiguousarray(sym, np.int32),
            np.ascontiguousarray(idx, np.int32))


RANS_SHAPES = [("y 1024x1024", "y", 4096, (0.0, 0.08)),
               ("y 768x512", "y", 1536, (0.0, 0.08, 0.3, "multi-nibble")),
               ("z 1024x1024", "z", 256, (0.0, 0.08, 0.3))]
# The multi-stream batch: four 1024x1024 images' y and z, one 768x512 y.
RANS_BATCH = ([("y", 4096, r) for r in (0.0, 0.08, 0.3, 0.0)]
              + [("z", 256, r) for r in (0.0, 0.08, 0.3, 0.0)]
              + [("y", 1536, 0.0)])


def rans_cases(codec, rng):
    """Seeded symbol planes at the device coders' main-path shapes: y of a
    1024x1024 image (P = 4096), y of a 768x512 one (P = 1536), both 220
    lanes against the scale tables, and z of a 1024x1024 image (P = 256,
    320 lanes) against the model's factorized tables; escape rates 0, 0.08
    and 0.3, and a multi-nibble payload. Yields (label, kind, sym, idx)."""
    for label, kind, p, rates in RANS_SHAPES:
        for rate in rates:
            yield (f"{label} escapes {rate}", kind,
                   *rans_symbols(codec, kind, p, rate, rng))


def check_rans_kernels(codec, card: str):
    """rans_encode and rans_decode against their plain versions on the card,
    bit for bit, at each case of `rans_cases` (one stream a launch), then
    over RANS_BATCH in one launch each: every buffer of the encoder equal,
    its stream equal to the host coder's, and the host coder's stream
    decoded to the symbols by both. Times (escape rate 0): the kernel's ms
    (CUDA events, median of 20) and us a position, the plain version's
    (median of 3), the native host coder's for the same stream (median of
    5) and the bound; and the batch's launch. Returns ({(kernel, shape
    label): timings}, {kernel: max abs error of any output word or
    symbol}, the batch's timings)."""
    from hific_tpu_torch.entropy import native
    from hific_tpu_torch.entropy.device_decode import (
        DecodeJob, decode_scan, decode_scan_many, decode_scan_reference,
        words_tensor)
    from hific_tpu_torch.entropy.device_encode import (
        EncodeJob, encode_scan, encode_scan_many, encode_scan_reference)

    packed = dict(zip("yz", codec._rans_tables))
    host_tables = {"y": codec.conditional.tables, "z": codec.factorized.tables}
    timed, max_err = {}, {"rans_encode": 0, "rans_decode": 0}

    def caps_of(sym):
        p, lanes = sym.shape
        return dict(spill_cap=p * lanes + 4096, lens_cap=64 * p + 64)

    def host_encode(kind, sym, idx):
        t = host_tables[kind]
        return native.encode_lanes(sym, idx, t.cdf, t.cdf_length,
                                   t.cdf_offset, t.precision)

    def check_encode(label, got, want, host, lanes):
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        max_err["rans_encode"] = max(max_err["rans_encode"], err)
        if err:
            raise AssertionError(f"rans_encode {label}: differs from its "
                                 f"plain version by {err}")
        stream, _, counts = (a.cpu().numpy().view(np.uint32) for a in got)
        if not (np.array_equal(stream[:len(host)], host)
                and not stream[len(host):].any()
                and int(counts[0]) == len(host) - 2 * lanes):
            raise AssertionError(f"rans_encode {label}: stream differs from "
                                 f"the host coder's")

    def check_decode(label, decoded, bad, plain, sym):
        err = int((decoded.long() - plain.long()).abs().max())
        max_err["rans_decode"] = max(max_err["rans_decode"], err)
        if not (int(bad) == 0 and err == 0
                and np.array_equal(decoded.cpu().numpy(), sym)):
            raise AssertionError(f"rans_decode {label}: differs from its "
                                 f"plain version or the symbols")

    for label, kind, sym, idx in rans_cases(codec, np.random.RandomState(SEED)):
        p, lanes = sym.shape
        t = host_tables[kind]
        sym_d = torch.from_numpy(sym).cuda()
        idx_d = torch.from_numpy(idx).cuda()
        job = EncodeJob(sym_d, idx_d, packed[kind], **caps_of(sym))
        got = encode_scan(*job)
        want = encode_scan_reference(*job)
        host = host_encode(kind, sym, idx)
        check_encode(label, got, want, host, lanes)
        counts = got[2].cpu().numpy()
        words = words_tensor(host, "cuda")
        decoded, bad = decode_scan(words, idx_d, packed[kind])
        check_decode(label, decoded, bad,
                     decode_scan_reference(words, idx_d, packed[kind]), sym)
        log(f"rans {label}: P={p} L={lanes}, {len(host)} words "
            f"({32 * len(host) / sym.size:.3f} bits/symbol), "
            f"{int(counts[1])} push events: kernels equal their plain "
            f"versions and the host coder")
        if not label.endswith("escapes 0.0"):
            continue
        shape = label.split(" escapes")[0]
        n = p * lanes
        k_ms = event_ms(lambda: encode_scan(*job), 20)
        p_ms = event_ms(lambda: encode_scan_reference(*job), 3)
        h_ms = host_ms(lambda: host_encode(kind, sym, idx), 5)
        # Bytes, each read once: the symbols and indices; of the CDF rows
        # the two words a symbol gathers or the whole table, whichever is
        # less; the rows' lengths and offsets whole. Written: the heads,
        # the spill words and the event counts.
        rows, max_len = t.cdf.shape
        e_bytes = (n * 8 + min(n * 8, rows * max_len * 4) + rows * 8
                   + (2 * lanes + int(counts[0]) + int(counts[1]) + 3) * 4)
        timed[("rans_encode", shape)] = dict(
            p=p, lanes=lanes, ms=k_ms, us_per_position=1e3 * k_ms / p,
            plain_ms=p_ms, host_coder_ms=h_ms,
            bound_ms=e_bytes / HBM_BYTES_PER_S * 1e3)
        if kind == "y":
            k_ms = event_ms(lambda: decode_scan(words, idx_d, packed[kind]),
                            20)
            p_ms = event_ms(lambda: decode_scan_reference(
                words, idx_d, packed[kind]), 3)
            h_ms = host_ms(lambda: native.decode_lanes(
                host, idx, t.cdf, t.cdf_length, t.cdf_offset, t.inverse,
                t.precision), 5)
            # Bytes, each read once: the stream and the indices; of the
            # CDF rows the two words a symbol's start and frequency take or
            # the whole table, whichever is less (as for the encoder); the
            # rows' lengths and offsets whole. Written: the symbols.
            d_bytes = (len(host) * 4 + n * 4
                       + min(n * 8, rows * max_len * 4) + rows * 8 + n * 4)
            timed[("rans_decode", shape)] = dict(
                p=p, lanes=lanes, ms=k_ms, us_per_position=1e3 * k_ms / p,
                plain_ms=p_ms, host_coder_ms=h_ms,
                bound_ms=d_bytes / HBM_BYTES_PER_S * 1e3)
    for (name, shape), r in timed.items():
        print(f"    {name} {shape} (P={r['p']}, L={r['lanes']}): kernel "
              f"{r['ms']:.3f} ms ({r['us_per_position']:.3f} us a position), "
              f"plain {r['plain_ms']:.1f} ms, host coder "
              f"{r['host_coder_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"(bytes; a serial scan sits far above it) ({card})",
              flush=True)

    # The multi-stream batch: one launch of each kernel for all streams.
    rng = np.random.RandomState(SEED + 1)
    streams = [(kind, *rans_symbols(codec, kind, p, rate, rng))
               for kind, p, rate in RANS_BATCH]
    jobs = [EncodeJob(torch.from_numpy(sym).cuda(),
                      torch.from_numpy(idx).cuda(), packed[kind],
                      **caps_of(sym)) for kind, sym, idx in streams]
    hosts = [host_encode(kind, sym, idx) for kind, sym, idx in streams]
    djobs = [DecodeJob(words_tensor(h, "cuda"), job.idx_l, job.tables)
             for h, job in zip(hosts, jobs)]
    got = encode_scan_many(jobs)
    decoded = decode_scan_many(djobs)
    for k, ((kind, sym, idx), job, host) in enumerate(zip(streams, jobs,
                                                          hosts)):
        label = f"batch stream {k} ({kind}, P={sym.shape[0]})"
        check_encode(label, got[k], encode_scan_reference(*job), host,
                     sym.shape[1])
        check_decode(label, *decoded[k], decode_scan_reference(*djobs[k]),
                     sym)
    positions = sum(sym.shape[0] for _, sym, _ in streams)
    batch = {
        "streams": len(streams), "positions": positions,
        "encode_ms": event_ms(lambda: encode_scan_many(jobs), 20),
        "decode_ms": event_ms(lambda: decode_scan_many(djobs), 20),
        "encode_ms_one_by_one": sum(
            event_ms(lambda: encode_scan(*job), 5) for job in jobs),
        "decode_ms_one_by_one": sum(
            event_ms(lambda: decode_scan(*job), 5) for job in djobs),
    }
    log(f"rans batch of {len(streams)} streams (4 x (y P=4096, z P=256), y "
        f"P=1536; escape rates 0-0.3): every buffer equal to the plain "
        f"versions and the host coder; one launch: encode "
        f"{batch['encode_ms']:.3f} ms, decode {batch['decode_ms']:.3f} ms "
        f"(stream by stream: {batch['encode_ms_one_by_one']:.3f} and "
        f"{batch['decode_ms_one_by_one']:.3f} ms) ({card})")
    return timed, max_err, batch


def bench_image(seed: int, h: int = 1024, w: int = 1024) -> np.ndarray:
    """(1, h, w, 3) uint8 as bench.py makes them: seeded low-resolution
    noise upsampled bicubically (torch here), plus 5% fine noise,
    stretched to [0, 255]."""
    rng = np.random.RandomState(seed)
    low = torch.from_numpy(rng.rand(h // 32, w // 32, 3).astype(np.float32))
    img = torch.nn.functional.interpolate(
        low.permute(2, 0, 1)[None], size=(h, w), mode="bicubic",
        align_corners=False)[0].permute(1, 2, 0).numpy()
    img = img + 0.05 * rng.rand(h, w, 3).astype(np.float32)
    img = (img - img.min()) / (img.max() - img.min())
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)[None]


def calibrate(codec, x, band=(0.20, 0.45), probes: int = 12):
    """Scale the encoder's output conv (y -> alpha y) by log-space
    bisection until the host coder's bpp lies in `band`, as bench.py
    does; raises if it does not get there."""
    conv = codec.model.encoder.conv_out
    base = (conv.weight.detach().clone(), conv.bias.detach().clone())
    lo, hi = 1e-3, 2.0
    for _ in range(probes):
        alpha = float(np.sqrt(lo * hi))
        with torch.no_grad():
            conv.weight.copy_(base[0] * alpha)
            conv.bias.copy_(base[1] * alpha)
        bpp = codec.compress(x).total_bpp
        log(f"calibrate: alpha {alpha:.5f} -> {bpp:.3f} bpp")
        if band[0] <= bpp <= band[1]:
            return alpha, bpp
        lo, hi = (lo, alpha) if bpp > band[1] else (alpha, hi)
    raise AssertionError(f"calibration did not reach {band} bpp")


def batch_path(codec, card: str):
    """compress_many / decompress_many on four seeded 1024x1024 images at
    bench.py's operating point, through the device coders. Returns the
    launch counts of each path and the summary."""
    from hific_tpu_torch import codec as codec_module
    from hific_tpu_torch.entropy import device_rans
    from hific_tpu_torch.entropy.container import (load_compressed,
                                                   save_compressed)

    kernels = (device_rans.ENCODE_KERNEL, device_rans.DECODE_KERNEL)
    x0 = bench_image(0)
    alpha, bpp = calibrate(codec, x0)
    imgs = [bench_image(s) for s in (1, 2, 3, 4)]
    mp = imgs[0].shape[1] * imgs[0].shape[2] / 1e6

    # The main path, counted: compress_many, then decompress_many to uint8.
    relaunches = codec.device_relaunches
    for k in kernels:
        k.launches = 0
    outs = codec.compress_many(imgs)
    enc_launches = kernels[0].launches
    kernels[1].launches = 0
    recons = codec.decompress_many(outs, as_uint8=True)
    dec_launches = kernels[1].launches
    if codec.device_relaunches != relaunches:
        raise AssertionError(f"{codec.device_relaunches - relaunches} of 4 "
                             f"images overran the default caps")
    if (enc_launches, dec_launches) != (1, 1):
        raise AssertionError(f"{enc_launches} encode and {dec_launches} "
                             f"decode launches for 4 images; expected 1 and 1")
    with tempfile.TemporaryDirectory() as tmp:
        def hfc(out, name):
            path = os.path.join(tmp, name)
            save_compressed(out, path)
            with open(path, "rb") as f:
                return path, f.read()

        for i, (x, out, recon) in enumerate(zip(imgs, outs, recons)):
            path, got = hfc(out, f"{i}.hfc")
            if got != hfc(codec.compress(x, device_encode=False),
                          f"{i}_host.hfc")[1]:
                raise AssertionError(f"image {i}: compress_many's .hfc "
                                     f"differs from the host coder's")
            host_recon = codec.decompress(load_compressed(path), as_uint8=True,
                                          device_decode=False)
            if not (recon.shape == x.shape
                    and np.array_equal(recon, host_recon)):
                raise AssertionError(f"image {i}: the device decoder's image "
                                     f"differs from the host decoder's")
        # An encode past its caps (8 spill words, 16 events) is launched
        # again on the card at the demand it reported: the host's bytes.
        default_caps = codec_module.default_caps
        codec_module.default_caps = lambda p, lanes, bits_per_symbol=2: (8, 16)
        try:
            relaunches = codec.device_relaunches
            forced = hfc(codec.compress(imgs[0], device_encode=True),
                         "forced.hfc")[1]
        finally:
            codec_module.default_caps = default_caps
        if (codec.device_relaunches - relaunches != 1
                or forced != hfc(codec.compress(imgs[0], device_encode=False),
                                 "0_host.hfc")[1]):
            raise AssertionError("an encode past its caps was not relaunched "
                                 "on the card to the host coder's bytes")
    bpps = [o.total_bpp for o in outs]
    log(f"batch path: alpha {alpha:.5f} ({bpp:.3f} bpp on the probe image); "
        f"4 images at {np.mean(bpps):.4f} bpp, none past the caps; 1 "
        f"encode and 1 decode launch; .hfc bytes equal the host coder's, uint8 images "
        f"the host decoder's; an encode past forced caps of 8 words and 16 "
        f"events relaunched on the card to the same bytes")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serial.hfc")
        codec.compress_file(x0, path)
        codec.decompress_file(path, as_uint8=True)
        t_enc, t_dec = [], []
        for _ in range(5):
            _, e = timed(lambda: codec.compress_file(x0, path))
            _, d = timed(lambda: codec.decompress_file(path, as_uint8=True))
            t_enc.append(e)
            t_dec.append(d)
        enc, dec = float(np.median(t_enc)), float(np.median(t_dec))
        paths = [os.path.join(tmp, f"b{i}.hfc") for i in range(4)]

        def one_pass():
            outs = codec.compress_many(imgs)
            for o, p in zip(outs, paths):
                save_compressed(o, p)
            recons = codec.decompress_many([load_compressed(p)
                                            for p in paths], as_uint8=True)
            return [int(r[0, 0, 0, 0]) for r in recons]

        one_pass()
        pipelined = float(np.median([timed(one_pass)[1] for _ in range(7)]))
    imgs_dev = [torch.from_numpy(x).cuda() for x in imgs]

    def device_pass():
        outs = codec.compress_many(imgs_dev)
        recons = codec.decompress_many(outs, as_uint8=True, as_numpy=False)
        return [int(r[0, 0, 0, 0]) for r in recons]

    device_pass()
    resident = float(np.median([timed(device_pass)[1] for _ in range(7)]))
    wall_ms, rows, busy_ms = profiled(device_pass)
    rans_ms = {k: sum(e.self_device_time_total for e in rows if k in e.key)
               / 1e3 for k in ("rans_encode", "rans_decode")}
    for e in rows:
        if "rans_" in e.key:
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
                  f"{e.key[:90]}")
    log(f"profiled device-resident pass (4 images): wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.0%}); "
        f"rans_encode {rans_ms['rans_encode']:.2f} ms, rans_decode "
        f"{rans_ms['rans_decode']:.2f} ms; top kernels by device time:")
    print_top(rows, 8)
    summary = {
        "bpp": float(np.mean(bpps)),
        "device_busy_share": busy_ms / wall_ms,
        "serial_ms_per_image": enc + dec,
        "serial_mp_s": mp / ((enc + dec) / 1e3),
        "pipelined_ms_per_image": pipelined / 4,
        "pipelined_mp_s": 4 * mp / (pipelined / 1e3),
        "device_resident_mp_s": 4 * mp / (resident / 1e3),
        "profiled_rans_encode_ms": rans_ms["rans_encode"],
        "profiled_rans_decode_ms": rans_ms["rans_decode"],
    }
    log(f"batch path, 1024x1024 at {summary['bpp']:.4f} bpp: serial "
        f"compress_file {enc:.1f} + decompress_file {dec:.1f} ms per image "
        f"({summary['serial_mp_s']:.3f} MP/s); pipelined x4 "
        f"{summary['pipelined_ms_per_image']:.1f} ms per image "
        f"({summary['pipelined_mp_s']:.3f} MP/s); device-resident x4 "
        f"{summary['device_resident_mp_s']:.3f} MP/s (host clock after "
        f"synchronize, medians of 5 and 7; {card})")
    return (enc_launches, dec_launches), outs[0], summary


def indices_card_vs_cpu(codec, cpu, out):
    """Scale indices where the card's synth_stats differs from the CPU's on
    the same decoded hyperlatents (no limit: a measurement)."""
    from hific_tpu_torch.runtime import fp32_numerics

    if not cpu._tables_built:
        cpu.build_tables()
    z_np = cpu.factorized.decompress_symbols(
        out.hyperlatents_encoded, out.batch_shape,
        out.hyperlatent_spatial_shape)
    idx = []
    with torch.inference_mode(), fp32_numerics(deterministic=True):
        for c in (codec, cpu):
            z = torch.from_numpy(z_np).to(c.device, torch.int16).contiguous(
                memory_format=torch.channels_last)
            idx.append(c.model.synth_stats(z, c.scale_table)[2].cpu())
    return int((idx[0] != idx[1]).sum()), idx[0].numel()


def smooth_image(seed: int) -> np.ndarray:
    """(1, H, W, 3) uint8: a few low-frequency waves per channel plus mild
    noise, made with numpy from `seed`."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, IMAGE_H), np.linspace(0, 1, IMAGE_W),
                         indexing="ij")
    img = np.zeros((IMAGE_H, IMAGE_W, 3))
    for ch in range(3):
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 4.0, 2)
            phase = rng.uniform(0, 2 * np.pi)
            img[..., ch] += rng.uniform(0.1, 0.3) * np.sin(
                2 * np.pi * (fy * yy + fx * xx) + phase)
    img = 0.5 + img / 2.0 + rng.normal(0, 0.01, img.shape)
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)[None]


def load_weights(path: str, seed: int):
    from hific_tpu_torch.config import Config
    from hific_tpu_torch.models.hific import HiFiC, init_random_
    from hific_tpu_torch.weights import load_npz

    if os.path.exists(path):
        config, state = load_npz(path)
        return config, state, f"artifact {path}"
    # The flagship configuration (C=220, 9 residual blocks, hyperlatent
    # filters 320) is Config's default.
    config = Config()
    gen = torch.Generator().manual_seed(seed)
    state = init_random_(HiFiC(config), gen).state_dict()
    return config, state, f"seeded random weights (seed {seed}); {path} absent"


RANS_REPLACES = {"rans_encode": "hific_tpu/entropy/device_encode.py:222",
                 "rans_decode": "hific_tpu/entropy/device_decode.py:147"}


def rans_entry(name: str, timed_rans, max_err: int, launches_by_path, batch):
    """The kernels line's entry of a rANS kernel: its times per 1024x1024
    image (y, and for the encoder z too), per shape and for the
    multi-stream batch in one launch."""
    rows = {shape: r for (kernel, shape), r in timed_rans.items()
            if kernel == name}
    image = [r for shape, r in rows.items() if "1024x1024" in shape]
    return {
        "name": name, "route": "cuda",
        "source": "hific_tpu_torch/csrc/rans_device.cu",
        "replaces": RANS_REPLACES[name],
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": max_err,
        **{key: sum(r[key] for r in image)
           for key in ("ms", "plain_ms", "host_coder_ms", "bound_ms")},
        "bound_by": "bytes", "library_ms": None,
        "per_shape": rows,
        "batch": {"streams": batch["streams"],
                  "positions": batch["positions"],
                  "ms": batch[f"{name[5:]}_ms"],
                  "ms_one_by_one": batch[f"{name[5:]}_ms_one_by_one"]},
    }


SERVE_CLIENTS, SERVE_PER_CLIENT = 4, 4
TILE_H, TILE_W = 2000, 3000  # a 6 MP camera photo; W not a multiple of 16
TILE_IMAGE, TILE_LATENTS = 1024, (64, 32)  # halos: 64 pixels, 16 latents
CLI_SIZES = ((IMAGE_H, IMAGE_W), (75, 93))


def kernel_counts():
    """(ChannelNorm forward, rans_encode, rans_decode) launch counts."""
    from hific_tpu_torch.entropy import device_rans
    from hific_tpu_torch.ops import fused_norm

    return (fused_norm.KERNEL.launches, device_rans.ENCODE_KERNEL.launches,
            device_rans.DECODE_KERNEL.launches)


def zero_kernel_counts() -> None:
    from hific_tpu_torch.entropy import device_rans
    from hific_tpu_torch.ops import fused_norm

    fused_norm.KERNEL.launches = 0
    device_rans.ENCODE_KERNEL.launches = 0
    device_rans.DECODE_KERNEL.launches = 0


def params_npz(weights: str, state, config, tmp: str) -> str:
    """The `-ckpt` of the serving and CLI phases: the artifact where it is
    present, else the seeded weights written to an uncompressed `.npz` in
    the artifact's layout (compressing 0.7 GB would take most of a
    minute)."""
    from hific_tpu_torch.models.hific import HiFiC
    from hific_tpu_torch.weights import (NPZ_CONFIG_KEY, NPZ_LEAF_PREFIX,
                                         jax_params_from_model)

    if os.path.exists(weights):
        return weights
    model = HiFiC(config)
    model.load_state_dict(state)
    entries = {NPZ_LEAF_PREFIX + k: v
               for k, v in jax_params_from_model(model).items()}
    entries[NPZ_CONFIG_KEY] = np.frombuffer(config.to_json().encode("utf-8"),
                                            dtype=np.uint8)
    path = os.path.join(tmp, "params.npz")
    np.savez(path, **entries)
    return path


def latency_summary(times_ms, wall_s):
    return {"requests": len(times_ms),
            "requests_per_s": len(times_ms) / wall_s,
            "p50_ms": float(np.percentile(times_ms, 50)),
            "p99_ms": float(np.percentile(times_ms, 99))}


def build_server(npz: str):
    """`cli/serve.py`'s server in-process on 127.0.0.1, port 0, with its
    defaults (max_batch 8, batch window 2 ms), serving from a thread of its
    own; the caller shuts it down and closes it."""
    import logging
    import threading

    from hific_tpu_torch.cli import serve as serve_cli

    t0 = time.perf_counter()
    quiet = logging.getLogger("chip_smoke.serve")
    quiet.setLevel(logging.WARNING)
    server = serve_cli.make_server(serve_cli.parse_args(
        ["-ckpt", npz, "--host", "127.0.0.1", "--port", "0"]), quiet)
    service = server.service
    log(f"server built in {time.perf_counter() - t0:.1f} s (weights, model, "
        f"tables; max_batch {service.max_batch}, window "
        f"{service.batch_window_s * 1e3:.0f} ms)")
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="http").start()
    return server


def serve_path(server, card: str):
    """The server of `build_server` serving: SERVE_CLIENTS threads POST
    SERVE_PER_CLIENT seeded 768x512 PNGs each to /compress, then, after
    all have their files, the returned bodies to /decompress. Gates: each
    body is the same codec's compress_many([x]) bytes, each PNG its
    decompress_many pixels, max_batch_seen >= 2, one encode launch per
    compress batch and one decode launch per decompress batch. Returns
    (kernel counts, summary)."""
    import threading
    import urllib.request

    from hific_tpu_torch.cli import serve as serve_cli
    from hific_tpu_torch.entropy.container import dumps_compressed
    from hific_tpu_torch.utils.image_io import decode_image, encode_png

    service = server.service
    codec = service.codec
    # The batch phase's operating point, before any request.
    alpha, bpp = calibrate(codec, bench_image(0))
    # One request of each kind at the served shape through the dispatcher
    # first, so that the timed window sees the steady state: the dispatcher
    # thread's own cuDNN and cuBLAS handles (PyTorch keeps them per thread)
    # are made by its first batch. The counters below are read from here.
    service._submit("decompress", service._submit("compress",
                                                  smooth_image(90)))
    warm = service.stats_snapshot()
    base = "http://%s:%d" % server.server_address[:2]

    n = SERVE_CLIENTS * SERVE_PER_CLIENT
    images = [smooth_image(100 + i) for i in range(n)]
    pngs = [encode_png(x[0]) for x in images]
    bodies, recons = [None] * n, [None] * n
    times = {"compress": [None] * n, "decompress": [None] * n}
    legs = {}
    errors = []
    barrier = threading.Barrier(SERVE_CLIENTS + 1)

    def post(path, body):
        req = urllib.request.Request(base + path, data=body, method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read(), (time.perf_counter() - t) * 1e3

    def client(c):
        mine = range(c * SERVE_PER_CLIENT, (c + 1) * SERVE_PER_CLIENT)
        try:
            for leg, inputs, outputs in (("compress", pngs, bodies),
                                         ("decompress", bodies, recons)):
                barrier.wait(timeout=600)  # the leg starts
                for i in mine:
                    outputs[i], times[leg][i] = post("/" + leg, inputs[i])
                barrier.wait(timeout=600)  # every client has its answers
        except Exception as e:  # noqa: BLE001 -- raised by the main thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    zero_kernel_counts()
    relaunches = codec.device_relaunches
    for leg in ("compress", "decompress"):
        try:
            barrier.wait(timeout=600)
            t0 = time.perf_counter()
            barrier.wait(timeout=600)
        except threading.BrokenBarrierError:
            break
        legs[leg] = time.perf_counter() - t0
    for t in threads:
        t.join(timeout=600)
    counts = kernel_counts()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve clients failed: {errors}")
    stats = {k: v - warm[k] if k != "max_batch_seen" else v
             for k, v in service.stats_snapshot().items()}

    if codec.device_relaunches != relaunches:
        raise AssertionError("a served encode overran the default caps")
    if (counts[1], counts[2]) != (stats["compress_batches"],
                                  stats["decompress_batches"]):
        raise AssertionError(f"{counts[1]} encode and {counts[2]} decode "
                             f"launches for {stats['compress_batches']} "
                             f"compress and {stats['decompress_batches']} "
                             f"decompress batches; expected one each")
    if counts[0] == 0:
        raise AssertionError("serve: the ChannelNorm kernel never launched")
    if stats["max_batch_seen"] < 2 or stats["errors"]:
        raise AssertionError(f"serve stats {stats}: no batch of 2 or more, "
                             f"or errors")
    bpps = []
    for i, x in enumerate(images):
        out = codec.compress_many([x])[0]
        bpps.append(out.total_bpp)
        if bodies[i] != dumps_compressed(out)[0]:
            raise AssertionError(f"request {i}: the served .hfc differs from "
                                 f"compress_many([x])")
        if not np.array_equal(decode_image(recons[i]),
                              codec.decompress_many([out])[0][0]):
            raise AssertionError(f"request {i}: the served PNG differs from "
                                 f"decompress_many's pixels")

    # One batch of each kind through the dispatcher's own runner, profiled.
    jobs = [serve_cli._Job("compress", x) for x in images[:SERVE_CLIENTS]]
    c_wall, _, c_busy = profiled(lambda: service._run_batch(jobs))
    djobs = [serve_cli._Job("decompress", j.result) for j in jobs]
    d_wall, _, d_busy = profiled(lambda: service._run_batch(djobs))
    summary = {
        "clients": SERVE_CLIENTS, "alpha": alpha,
        "bpp": float(np.mean(bpps)),
        "compress": latency_summary(times["compress"], legs["compress"]),
        "decompress": latency_summary(times["decompress"],
                                      legs["decompress"]),
        "stats": stats,
        "profiled_compress_batch": {"images": len(jobs), "wall_ms": c_wall,
                                    "device_busy_ms": c_busy,
                                    "busy_share": c_busy / c_wall},
        "profiled_decompress_batch": {"images": len(djobs),
                                      "wall_ms": d_wall,
                                      "device_busy_ms": d_busy,
                                      "busy_share": d_busy / d_wall},
    }
    for leg in ("compress", "decompress"):
        s = summary[leg]
        log(f"serve /{leg}: {s['requests']} requests from {SERVE_CLIENTS} "
            f"clients, {s['requests_per_s']:.2f} requests/s, p50 "
            f"{s['p50_ms']:.1f} ms, p99 {s['p99_ms']:.1f} ms (client clock; "
            f"{IMAGE_W}x{IMAGE_H} at {summary['bpp']:.4f} bpp, encoder output "
            f"scaled by "
            f"{alpha:.5f}; {card})")
    log(f"serve: {stats['compress_batches']} compress and "
        f"{stats['decompress_batches']} decompress batches, max batch "
        f"{stats['max_batch_seen']}; launches norm {counts[0]}, rans_encode "
        f"{counts[1]}, rans_decode {counts[2]} (one of each rANS kernel per "
        f"batch); bodies equal compress_many's bytes, PNGs "
        f"decompress_many's pixels")
    log(f"profiled dispatcher batches of {len(jobs)}: compress wall "
        f"{c_wall:.1f} ms, device busy {c_busy:.1f} ms ({c_busy / c_wall:.0%});"
        f" decompress wall {d_wall:.1f} ms, device busy {d_busy:.1f} ms "
        f"({d_busy / d_wall:.0%}) ({card})")
    return counts, summary


def generator_peaks(codec, side: int):
    """Peak device memory (GiB) of the generator on one side x side latent
    window under the codec's numerics (deterministic cuDNN) and with cuDNN
    free to pick its algorithms, and the peak reached by the end of
    upconv0 (its first transposed convolution) in each."""
    from hific_tpu_torch.runtime import fp32_numerics

    generator = codec.model.generator
    lat = torch.randn(1, codec.config.latent_channels, side, side,
                      device=codec.device).contiguous(
                          memory_format=torch.channels_last)
    marks, peaks = [], {}
    hook = generator.upconv0.register_forward_hook(
        lambda *_: marks.append(torch.cuda.max_memory_allocated() / 2 ** 30))
    for name, deterministic in (("deterministic", True), ("free", False)):
        with torch.inference_mode(), fp32_numerics(deterministic):
            generator(lat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks.clear()
            generator(lat)
            torch.cuda.synchronize()
        peaks[name] = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "peak_after_upconv0_gib": marks[0]}
    hook.remove()
    return peaks


def tiling_path(codec, card: str):
    """A seeded 2000x3000 image: whole-image compress against
    compress(tile_image=1024, halo_image=64), both on the device encoder,
    each file decoded on the host coder to the symbols it encoded (gated),
    the symbols where the two encodes differ (measured);
    decompress(as_uint8) against decompress(tile_latents=64) and (32), all
    on the device decoder, the largest pixel differences (measured); one
    rANS launch per leg (gated); each leg's time and peak device memory,
    and the generator's peak on one tile-32 window by cuDNN mode. Returns
    (kernel counts, summary)."""
    x = bench_image(7, TILE_H, TILE_W)
    x_in = codec._model_input(x)
    legs, peaks = {}, {}

    def leg(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, legs[name] = timed(fn)
        peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        return out

    # Each leg once first: cuDNN picks its algorithms for new shapes.
    warm = codec.compress(x)
    codec.compress(x, tile_image=TILE_IMAGE, halo_image=64)
    for tile in (None, *TILE_LATENTS):
        codec.decompress(warm, tile_latents=tile, as_uint8=True)
    zero_kernel_counts()
    relaunched = codec.device_relaunches
    whole = leg("compress", lambda: codec.compress(x))
    tiled = leg("compress_tiled", lambda: codec.compress(
        x, tile_image=TILE_IMAGE, halo_image=64))
    r_whole = leg("decompress", lambda: codec.decompress(whole,
                                                         as_uint8=True))
    r_tiled = {tile: leg(f"decompress_tiled_{tile}", lambda: codec.decompress(
        whole, tile_latents=tile, as_uint8=True)) for tile in TILE_LATENTS}
    counts = kernel_counts()
    # One launch per leg, and one more for an encode past the default caps.
    want = (2 + codec.device_relaunches - relaunched, 1 + len(TILE_LATENTS))
    if counts[0] == 0 or counts[1:] != want:
        raise AssertionError(f"tiling legs: launches (norm, rans_encode, "
                             f"rans_decode) {counts}; expected (>0, "
                             f"{want[0]}, {want[1]})")
    enc_whole = codec._symbols(x_in)
    enc_tiled = codec._symbols(x_in, TILE_IMAGE, 64)
    for name, out, enc in (("whole", whole, enc_whole),
                           ("tiled", tiled, enc_tiled)):
        z_dec, y_dec, _ = codec.decode_symbols(out)
        if not (np.array_equal(z_dec, enc[0])
                and np.array_equal(y_dec, enc[1])):
            raise AssertionError(f"the {name} 2000x3000 file does not decode "
                                 f"to the symbols it encoded")
    if any(r.shape != x.shape for r in (r_whole, *r_tiled.values())):
        raise AssertionError(f"reconstructions {r_whole.shape}, "
                             f"{[r.shape for r in r_tiled.values()]}")
    y_diff = int((enc_whole[1] != enc_tiled[1]).sum())
    z_diff = int((enc_whole[0] != enc_tiled[0]).sum())
    pixel = {tile: int(np.abs(r_whole.astype(int) - r.astype(int)).max())
             for tile, r in r_tiled.items()}
    window = TILE_LATENTS[-1] + 2 * 16  # the smallest tile's window
    gen_peaks = generator_peaks(codec, window)
    summary = {
        "shape": [TILE_H, TILE_W], "bpp": whole.total_bpp,
        "tiled_bpp": tiled.total_bpp,
        "y_symbols_differ": y_diff, "y_symbols": int(enc_whole[1].size),
        "z_symbols_differ": z_diff, "z_symbols": int(enc_whole[0].size),
        "hfc_bytes_equal": bool(
            np.array_equal(whole.latents_encoded, tiled.latents_encoded)
            and np.array_equal(whole.hyperlatents_encoded,
                               tiled.hyperlatents_encoded)),
        "max_pixel_diff_tiled_decode": pixel,
        "ms": legs, "peak_gib": peaks,
        f"generator_{window}x{window}_latents": gen_peaks,
    }
    log(f"tiling {TILE_W}x{TILE_H} ({whole.total_bpp:.4f} bpp): tiled encode "
        f"(tile {TILE_IMAGE}, halo 64) vs whole: {y_diff} of {enc_whole[1].size} y and "
        f"{z_diff} of {enc_whole[0].size} z symbols differ; both files "
        f"decode to their symbols; tiled decode (halo 16) vs whole: largest "
        f"pixel difference " + ", ".join(f"{d} at {t} latents"
                                         for t, d in pixel.items()))
    log("tiling legs: " + "; ".join(
        f"{k} {summary['ms'][k]:.1f} ms, peak {summary['peak_gib'][k]:.2f} GiB"
        for k in summary["ms"]) + f" (host clock after synchronize; "
        f"max_memory_allocated; {card})")
    log(f"generator on {window}x{window} latents: " + "; ".join(
        f"cuDNN {k}: peak {v['peak_gib']:.2f} GiB, by the end of upconv0 "
        f"{v['peak_after_upconv0_gib']:.2f} GiB" for k, v in gen_peaks.items())
        + f" ({card})")
    return counts, summary


def cli_path(codec, npz: str, card: str):
    """Two seeded PNGs (768x512, 75x93) through `cli.compress.main` per
    image and with --pipeline 2, then `cli.decompress.main` on the
    per-image files. Gates: the two modes' .hfc files byte-equal and equal
    to `codec`'s host coder's bytes (both modes take the device encoder),
    finite PSNR in metrics.json, the decoded PNGs `codec`'s pixels. `codec`
    holds the weights of `npz` as they are (not calibrated). Returns
    (kernel counts, summary)."""
    from hific_tpu_torch.cli import compress as compress_cli
    from hific_tpu_torch.cli import decompress as decompress_cli
    from hific_tpu_torch.entropy.container import (dumps_compressed,
                                                   load_compressed)
    from hific_tpu_torch.training.data import EvalDataset
    from hific_tpu_torch.utils.image_io import read_image, write_png

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "images")
        os.makedirs(src)
        for i, (h, w) in enumerate(CLI_SIZES):
            write_png(os.path.join(src, f"img_{i}.png"),
                      smooth_image(200 + i)[0, :h, :w])
        one, grouped, dec = (os.path.join(tmp, d)
                             for d in ("single", "pipeline", "decoded"))
        zero_kernel_counts()
        t0 = time.perf_counter()
        rows = compress_cli.main(["-ckpt", npz, "-i", src, "-o", one])
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        compress_cli.main(["-ckpt", npz, "-i", src, "-o", grouped,
                           "--pipeline", "2", "--no_lpips"])
        t_grouped = time.perf_counter() - t0
        t0 = time.perf_counter()
        written = decompress_cli.main(["-ckpt", npz, "-i", one, "-o", dec])
        t_dec = time.perf_counter() - t0
        counts = kernel_counts()
        if min(counts) == 0:
            raise AssertionError(f"CLIs: launches (norm, rans_encode, "
                                 f"rans_decode) {counts}; a kernel never ran")
        with open(os.path.join(one, "metrics.json")) as f:
            metrics = json.load(f)
        if not all(math.isfinite(r["psnr"]) for r in metrics):
            raise AssertionError(f"metrics.json: {metrics}")
        for i in range(len(CLI_SIZES)):
            with open(os.path.join(one, f"img_{i}.hfc"), "rb") as f:
                a = f.read()
            with open(os.path.join(grouped, f"img_{i}.hfc"), "rb") as f:
                b = f.read()
            if a != b:
                raise AssertionError(f"img_{i}: --pipeline 2 wrote other "
                                     f".hfc bytes than the per-image run")
        for x, _, path in EvalDataset(src):
            name = os.path.splitext(os.path.basename(path))[0]
            with open(os.path.join(one, name + ".hfc"), "rb") as f:
                if f.read() != dumps_compressed(
                        codec.compress(x, device_encode=False))[0]:
                    raise AssertionError(f"{name}: the CLI's .hfc differs "
                                         f"from the host coder's")
        for i, png in enumerate(written):
            want = codec.decompress(load_compressed(
                os.path.join(one, f"img_{i}.hfc")), as_uint8=True)[0]
            if not np.array_equal(read_image(png), want):
                raise AssertionError(f"{png}: not the codec's pixels")
    summary = {"rows": rows, "compress_per_image_s": t_one,
               "compress_pipeline_s": t_grouped, "decompress_s": t_dec}
    log(f"CLIs: compress per image {t_one:.1f} s, --pipeline 2 "
        f"{t_grouped:.1f} s, decompress {t_dec:.1f} s (each loads the "
        f"weights and builds its tables); the two modes' .hfc equal the host "
        f"coder's; PSNR "
        + ", ".join(f"{r['psnr']:.2f}" for r in rows) + " dB; decoded PNGs "
        f"equal the codec's pixels; launches norm {counts[0]}, rans_encode "
        f"{counts[1]}, rans_decode {counts[2]} ({card})")
    return counts, summary


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--weights", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "artifacts",
        "flagship_rd30k_f16.npz"))
    args = parser.parse_args()

    # Phase 1: the card.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(card, flush=True)
    log(f"device {kind} x{count}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")

    from hific_tpu_torch.entropy import device_rans, native
    from hific_tpu_torch import native_build
    from hific_tpu_torch.codec import Codec
    from hific_tpu_torch.entropy.container import load_compressed
    from hific_tpu_torch.models.layers import Norm
    from hific_tpu_torch.ops import fused_norm
    from hific_tpu_torch.runtime import fp32_numerics

    # Phase 2: build, all compilers at once.
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        norm_job = pool.submit(fused_norm.LIBRARY.load)
        device_rans_job = pool.submit(device_rans.LIBRARY.load)
        rans_job = pool.submit(native_build.build_library, "rans",
                               [native.SOURCE],
                               ["g++"] + native_build.GXX_FLAGS)
        norm_job.result()
        device_rans_job.result()
        rans = rans_job.result()
    for name, built in (("channel_norm.cu (forward + backward)",
                         fused_norm.LIBRARY.built),
                        ("rans_device.cu (rans_encode, rans_decode)",
                         device_rans.LIBRARY.built)):
        log(f"built {name} in {built.seconds:.1f} s (plain nvcc) -> "
            f"{os.path.relpath(built.path)}")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("  ptxas:", line.strip())
    log(f"built rans.cc in {rans.seconds:.1f} s (g++); builds took "
        f"{time.perf_counter() - t0:.1f} s")

    # Phase 3: the kernel against its plain version at the path's shapes.
    config, state, source = load_weights(args.weights, SEED)
    shapes = main_path_norm_shapes(config, IMAGE_H, IMAGE_W)
    gen = torch.Generator().manual_seed(SEED)
    summary = check_channel_norm(shapes, gen)
    log(f"channel_norm: {len(shapes)} shapes, max abs err "
        f"{summary['max_abs_err']:.2e}; per round trip kernel "
        f"{summary['ms']:.3f} ms, plain {summary['plain_ms']:.3f} ms, bound "
        f"{summary['bound_ms']:.3f} ms ({card})")

    # Phase 4: the backward kernel at a flagship training step's shapes.
    train_shapes = train_step_norm_shapes(config, TRAIN_BATCH, TRAIN_CROP)
    bwd_summary = check_channel_norm_backward(train_shapes, gen)
    log(f"channel_norm backward: {len(train_shapes)} shapes per step, worst "
        f"dx err {bwd_summary['worst'][0]:.2e} of row scale, dgamma/dbeta "
        f"{bwd_summary['worst'][1]:.2e} of column scale; per step kernel "
        f"{bwd_summary['ms']:.3f} ms, plain {bwd_summary['plain_ms']:.3f} "
        f"ms, bound {bwd_summary['bound_ms']:.3f} ms; forward per step "
        f"kernel {bwd_summary['fwd_ms']:.3f} ms, plain "
        f"{bwd_summary['fwd_plain_ms']:.3f} ms, bound "
        f"{bwd_summary['fwd_bound_ms']:.3f} ms ({card})")

    # Phase 5: weights, codec, tables.
    log(f"weights: {source}")
    t0 = time.perf_counter()
    codec = Codec(config, state, device="cuda")
    torch.cuda.synchronize()
    log(f"codec on cuda built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    codec.build_tables()
    log(f"tables built in {time.perf_counter() - t0:.1f} s")

    # Phase 5b: the device rANS kernels against their plain versions.
    rans_timed, rans_err, rans_batch = check_rans_kernels(codec, card)

    # Phase 6: the round trip.
    x = smooth_image(SEED)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.append((inp[0].shape[0] * inp[0].shape[2]
                                      * inp[0].shape[3], inp[0].shape[1],
                                      mod.activation)))
        for m in codec.model.modules() if isinstance(m, Norm)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.hfc")
        fused_norm.KERNEL.launches = 0
        device_rans.ENCODE_KERNEL.launches = 0
        device_rans.DECODE_KERNEL.launches = 0
        relaunched = codec.device_relaunches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        actual_bpp, estimated_bpp = codec.compress_file(x, path)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        recon = codec.decompress_file(path, as_uint8=True)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        launches = fused_norm.KERNEL.launches
        rt_rans = (device_rans.ENCODE_KERNEL.launches,
                   device_rans.DECODE_KERNEL.launches)
        # An encode whose streams overran the default caps (the image is
        # uncalibrated: several bpp) is coded again in one more launch.
        relaunched = codec.device_relaunches - relaunched
        for h in hooks:
            h.remove()
        out = load_compressed(path)
        z_enc, y_enc, *_ = codec.encode_symbols(x)
        z_dec, y_dec, _ = codec.decode_symbols(out)
    if launches != len(shapes) or seen != shapes:
        raise AssertionError(f"channel_norm kernel launched {launches} times "
                             f"on shapes {seen}; expected {shapes}")
    if rt_rans != (1 + relaunched, 1):
        raise AssertionError(f"round trip: {rt_rans} rans_encode/rans_decode "
                             f"launches; expected ({1 + relaunched}, 1)")
    if not (np.array_equal(z_enc, z_dec) and np.array_equal(y_enc, y_dec)):
        raise AssertionError("decoded symbols differ from the encoded ones")
    if recon.shape != x.shape or recon.dtype != np.uint8:
        raise AssertionError(f"reconstruction {recon.shape} {recon.dtype}")
    mse = np.mean((recon.astype(np.float64) - x.astype(np.float64)) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    log(f"round trip {IMAGE_W}x{IMAGE_H}: {launches} channel_norm launches, "
        f"rans_encode {rt_rans[0]} ({relaunched} relaunch past the default "
        f"caps), rans_decode {rt_rans[1]}; symbols equal (z {z_enc.shape}, y {y_enc.shape}); {actual_bpp:.4f} "
        f"bpp (estimate {estimated_bpp:.4f}); PSNR {psnr:.2f} dB")
    log(f"first round trip: compress_file {t_enc * 1e3:.1f} ms, "
        f"decompress_file {t_dec * 1e3:.1f} ms (host clock after synchronize;"
        f" {card})")
    warm_round_trip(codec, x, card)

    # The card's transforms against the plain CPU path on a small crop.
    crop = x[:, :64, :64]
    cpu = Codec(config, state, device="cpu")
    with torch.inference_mode(), fp32_numerics(deterministic=True):
        y_gpu, _ = codec.model.encode(codec._model_input(crop))
        y_cpu, _ = cpu.model.encode(cpu._model_input(crop))
    # Latents are unnormalized (trained ones reach tens): compare relative
    # to their largest magnitude; pixels live in [0, 1].
    enc_err = float((y_gpu.cpu() - y_cpu).abs().max()
                    / y_cpu.abs().max().clamp_min(1.0))
    y_hat = torch.from_numpy(y_dec[:, :, :4, :4]).float()
    with torch.inference_mode(), fp32_numerics(deterministic=True):
        r_gpu = codec.model.generate(
            y_hat.cuda().contiguous(memory_format=torch.channels_last),
            (64, 64)).cpu()
        r_cpu = cpu.model.generate(
            y_hat.contiguous(memory_format=torch.channels_last), (64, 64))
    gen_err = float((r_gpu - r_cpu).abs().max())
    if not (np.isfinite(enc_err) and enc_err <= 1e-3 and gen_err <= 1e-3):
        raise AssertionError(f"card vs CPU on a 64x64 crop: latents differ by "
                             f"{enc_err} (relative), reconstructions by "
                             f"{gen_err}")
    log(f"card vs CPU plain path, 64x64 crop: latents max diff {enc_err:.2e} "
        f"of their largest magnitude, reconstruction max abs diff "
        f"{gen_err:.2e} (limits 1e-3)")

    # Phase 6b: compress_many / decompress_many at bench.py's operating point.
    (enc_launches, dec_launches), batch_out, batch = batch_path(codec, card)
    # Phase 6c: the coding indices of one image, card against the CPU.
    flipped, n_idx = indices_card_vs_cpu(codec, cpu, batch_out)
    log(f"coding indices of a 1024x1024 image, card vs CPU synth_stats on "
        f"the same hyperlatents: {flipped} of {n_idx} differ (measured, not "
        f"gated)")
    print("batch path:", json.dumps(batch), flush=True)

    # Phase 6d: a 6 MP image whole and on tiles.
    tile_counts, tiling = tiling_path(codec, card)
    print("tiling:", json.dumps(tiling), flush=True)

    # Phase 6e: the compress and decompress CLIs, compared with the served
    # codec before its calibration; phase 6f: the serving daemon under
    # concurrent clients.
    with tempfile.TemporaryDirectory() as tmp:
        npz = params_npz(args.weights, state, config, tmp)
        server = build_server(npz)
        try:
            cli_counts, cli = cli_path(server.service.codec, npz, card)
            serve_counts, serve = serve_path(server, card)
        finally:
            server.shutdown()
            server.server_close()
    print("serve:", json.dumps(serve), flush=True)
    print("cli:", json.dumps(cli), flush=True)

    del codec, cpu, server
    torch.cuda.empty_cache()

    # Phase 7: a tiny training step, card against the CPU's plain path.
    log(tiny_step_card_vs_cpu())

    with tempfile.TemporaryDirectory() as train_dir:
        # Phase 8: flagship-width training steps through the trainer.
        torch.cuda.reset_peak_memory_stats()
        fwd_launches, bwd_launches, train, ckpt = train_flagship(
            card, len(train_shapes), train_dir)

        # Phase 9: a tiny G step and D step, card against the CPU's plain
        # path; phase 10: the GAN stage at flagship width through the
        # trainer, warmstarted from phase 8's checkpoint.
        log(tiny_gan_steps_card_vs_cpu())
        gan_fwd, gan_bwd, gan = train_gan_flagship(
            card, len(train_shapes), ckpt, train_dir)
    print("gan:", json.dumps(gan), flush=True)

    log(f"total wall time {time.perf_counter() - T_START:.1f} s ({card})")
    print(json.dumps({"kernels": [{
        "name": "channel_norm",
        "route": "cuda",
        "source": "hific_tpu_torch/csrc/channel_norm.cu",
        "replaces": "hific_tpu/ops/pallas_norm.py:49",
        "launches": (launches + fwd_launches + serve_counts[0]
                     + tile_counts[0] + cli_counts[0] + gan_fwd),
        "launches_by_path": {"codec_round_trip": launches,
                             "serve": serve_counts[0],
                             "tiling": tile_counts[0],
                             "cli": cli_counts[0],
                             "train_steps": fwd_launches,
                             "gan_train_steps": gan_fwd},
        "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"],
        "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "train_step_ms": bwd_summary["fwd_ms"],
        "train_step_plain_ms": bwd_summary["fwd_plain_ms"],
        "train_step_bound_ms": bwd_summary["fwd_bound_ms"],
    }, {
        "name": "channel_norm_backward",
        "route": "cuda",
        "source": "hific_tpu_torch/csrc/channel_norm.cu",
        "replaces": "hific_tpu/ops/pallas_norm.py:74",
        "launches": bwd_launches + gan_bwd,
        "launches_by_path": {"train_steps": bwd_launches,
                             "gan_train_steps": gan_bwd},
        "max_abs_err": bwd_summary["max_abs_err"],
        "ms": bwd_summary["ms"],
        "plain_ms": bwd_summary["plain_ms"],
        "bound_ms": bwd_summary["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "per_shape": bwd_summary["per_shape"],
        "g_copies_per_step": train["copies_per_step"],
        "warm_train_step_ms": train["warm_ms"],
    }] + [rans_entry(name, rans_timed, rans_err[name], launches_by_path,
                     rans_batch)
          for name, launches_by_path in (
              ("rans_encode", {"codec_round_trip": rt_rans[0],
                               "compress_many": enc_launches,
                               "serve": serve_counts[1],
                               "tiling": tile_counts[1],
                               "cli": cli_counts[1]}),
              ("rans_decode", {"codec_round_trip": rt_rans[1],
                               "decompress_many": dec_launches,
                               "serve": serve_counts[2],
                               "tiling": tile_counts[2],
                               "cli": cli_counts[2]}))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
