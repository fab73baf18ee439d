"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--weights artifacts/flagship_rd30k_f16.npz]

Drives the port's paths at the flagship's full width: the codec round trip
(image -> .hfc -> image) through `hific_tpu_torch.codec.Codec`, the batch
codec (`compress_many` / `decompress_many` on the device rANS coders), a
6 MP image whole and on tiles, the serving daemon `cli/serve.py` under
concurrent clients, the compress and decompress CLIs, and both stages of
training through the trainer `hific_tpu_torch.cli.train` (compression
steps, then GAN steps warmstarted from them), in fp32; then the same
flagship in bf16 (`dtype="bfloat16"`): the codec round trip, the batch
codec, and the trainer with remat, the corpus on the card and the
profiler, with the model variants' tiny steps; then multi-GPU on the one
card (DDP steps under NCCL and gloo, the data-parallel trainer CLI under
`torch.distributed.run`, `dryrun_multichip(2)` and a 6 MP image through
the partitioned codec over 4 bands); and holds every kernel of those
paths against its plain PyTorch version:

1. the card's name, power limit and count;
2. builds the kernels from the sources in this checkout, all compilers
   started together (nvcc for `csrc/channel_norm.cu`, which holds the
   ChannelNorm forward and backward kernels, and for `csrc/rans_device.cu`,
   which holds the rANS encode and decode kernels; g++ for the host rANS
   coder);
3. runs the ChannelNorm forward kernel at each distinct (M, C, act) shape
   of three sets: the 768x512 round trip's 29 and a batch-8, 256x256
   training step's 29 in fp32 and in bf16, and one 1024x1024 image's 29
   at bench.py's operating point in bf16 (norm_in fp32); against its plain
   version (fp32 within 1e-5; bf16 within one ulp plus 1e-5), two calls
   with the same bits, with its time, the plain version's, the library
   call's (`F.layer_norm` on the channels-last view with the weight and
   eps rescaled to the unbiased variance, without the ReLU) and the
   memory bound, summed per set; and the time of an empty kernel, what a
   launch alone costs;
4. runs the ChannelNorm backward kernels (the row kernel and the column
   sum of its per-block partial sums) at each of the 29 norm shapes of a
   batch-8, 256x256 flagship training step against their plain version,
   dx, dgamma and dbeta, in fp32 (within 1e-5 of the row's or column's
   scale) and bf16 (dx within one bf16 ulp more), twice with the same bits,
   with the same timings and the library call's
   (`native_layer_norm_backward`, without the ReLU mask) in both dtypes,
   each fp32 kernel also timed alone;
5. loads the flagship weights (seeded random weights of the same
   configuration where the artifact is absent) and builds the codec and
   its tables; then runs rans_encode and rans_decode against their plain
   versions, bit for bit, on seeded symbol planes at the path's shapes (y
   of 1024x1024 and 768x512 images, z of a 1024x1024 one; escape rates 0,
   0.08 and 0.3 and a multi-nibble payload; the 1024x1024 y at rate 0
   only since PR 15), streams equal to the host coder's, with the
   kernels' times (and us a position), the plain versions' and host
   coder's times and the bound; then a batch of nine streams (four
   images' y and z, one 768x512 y) in one launch of each kernel, every
   buffer against the plain versions and the host coder, with the
   batch's time and the same streams' one launch each (the batch takes
   the cases' planes: the y of the images at escape rates 0.08 and 0.3
   are the 768x512 ones, the fourth image repeats the first; it is held
   against their plain outputs);
6. compress_file -> .hfc -> decompress_file of a seeded smooth 768x512
   image: decoded symbols equal the encoded ones, the forward kernel ran
   exactly once per ChannelNorm (29 launches) and each rANS kernel once
   (the encoder once more where the uncalibrated image overruns its caps),
   and the card's encoder/generator agree with the plain CPU path on a
   64x64 crop (within 1e-3; the generator with its default depth-to-space
   tail, the encoder also with the space-to-depth front on), and LPIPS with
   the VGG16 backbone on one seeded 256x256 pair with the CPU's (1e-4
   relative); then, at bench.py's operating point (four
   seeded 1024x1024 images, the encoder's output scaled into 0.20-0.45
   bpp), compress_many and decompress_many: no encode past the default
   caps, one encode launch (all y and z streams) and one decode launch
   (all y streams) for the four images, `.hfc` bytes equal to the host
   coder's and images equal to the host decoder's, and the serial,
   pipelined and device-resident times with the rANS kernels' device time
   in a profiled pass; on the same images the generator with the
   depth-to-space tail on against off (reconstructions within 1e-4 and one
   uint8 level) and the encoder with the space-to-depth front on against
   off (the y symbols that differ, reported), one norm launch a layer in
   each, with each setting's time; and the count of coding indices
   where the card's synth_stats differs from the CPU's on one image's
   hyperlatents (reported, not gated); then the same four images at
   pipeline_chunk 4 (the transforms image by image, the reconstructions in
   one copy a chunk): `.hfc` bytes, pixels and coding indices equal chunk
   1's, one rANS launch of each kind a call (one more past the caps) and
   the norm kernel once a layer an image, with the pipelined MP/s at
   chunk 1 and 4; then the host coders on the
   calibrated codec and 768x512 images: coder_threads 4 (container v2)
   decoding to the v1 file's symbols and pixels at most 46 bytes larger
   with no rANS launch, the scalar coder (vectorize=False) decoding to the
   same symbols and pixels, and compress_many / decompress_many on the
   host coder at wire_chunk 4 against wire_chunk 1 (same bytes and pixels,
   no thread left); then a seeded 2000x3000 image
   compressed whole and with tile_image=1024, halo_image=64, each file
   decoding on the host coder to the symbols it encoded, the symbols where
   the two encodes differ (measured), decompress(as_uint8) whole against
   tile_latents=64 (largest pixel difference, measured), one rANS
   launch per leg, each leg's time and peak device memory, and the
   generator's peak on one tile-32 window under deterministic cuDNN and
   with cuDNN free; then `cli/serve.py` in-process on 127.0.0.1 (port 0,
   max_batch 8, batch window 2 ms, pipeline_chunk 4, the encoder
   calibrated as in the batch phase, one batch of each kind run before
   the timed window):
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
   CPU's plain path (same weights, same noise, the CPU taking the card's
   side of each ReLU kink as in phase 11): loss within 1e-4, every
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
10. three flagship-width G/D step pairs (four until PR 13) through the
   trainer with `-mt compression_gan`, warmstarted from phase 8's
   checkpoint (batch 8 of other seeded crops): each step checked as it
   is called (finite losses; a nonzero gradient for every codec
   parameter in a G step and no discriminator gradient after it; a
   nonzero gradient for every discriminator parameter in a D step and
   the codec's parameters unchanged by it; u changed by each call; 29
   forward and 29 backward launches a G step, 29 and 0 a D step), the
   warm G and D step times, the peak device memory and a profile of one
   more pair;
11. this slice. Tiny-config steps card vs CPU of the variants, the CPU
   step taking the card's side of each ReLU and latent rounding the two
   decided apart (`hific_tpu_torch.kinks`): bf16 (loss within 1e-3; each
   ReLU layer's pre-activations, each rounding's input and each gradient
   leaf no further from the CPU's fp32 step than twice the CPU bf16
   step plus one bf16 ulp), instance norm, sample_noise with the same
   noise and the DLMM hyperprior (1e-4; 1e-3; each tie within 1e-4 of
   the kink on both sides). The flagship codec in bf16 on the same
   weights: compress_file -> .hfc -> decompress_file of the 768x512 image
   (symbols lossless; 29 norm launches, norm_in's on the fp32 decoded
   latents and the rest bf16; one launch of each rANS kernel), then the
   batch path of phase 6 (bytes equal to the host coder's; serial,
   pipelined and device-resident MP/s; pipeline_chunk 4 with its gates;
   the d2s and s2d settings' launches gated, their differences and times
   reported),
   and 16 seeded 256x256 images at pipeline_chunk 1 and 4 (MP/s at each,
   the device busy share of a profiled pass at 4, the same bytes and
   pixels at both). The
   trainer, `-mt compression
   --dtype bfloat16 --use_remat --device_data --profile_dir <tmp> --steps
   16` in-process on seeded 320x320 tiles (batch 8 of 256x256 crops):
   each step finite, a nonzero gradient for every codec parameter, the
   transposed convs' parameters and Adam moments bf16 and the rest fp32,
   47 forward (29, and the residual blocks' 18 again in the recompute) and
   29 backward norm launches, all bf16; the trace exists, shows the same
   launches per step and no host-to-device copy of a batch's size; one
   step's peak device memory lower with remat than without (gated), the
   warm step time and the trace's device busy share;
12. multi-GPU on the one card (run inside phase 8's directory, after
   phase 10). Started together in the background: one G step and a timed
   second one through the library's step under DDP from phase 8's
   checkpoint (batch 8 of other seeded 256x256 crops), at world 1 under
   NCCL and at world 2 ranks sharing cuda:0 under gloo, in spawned
   ranks; `python -m torch.distributed.run --standalone --nproc_per_node
   1 -m hific_tpu_torch.cli.train --data_parallel -mt compression` for
   two flagship steps on seeded tiles; `python -m
   hific_tpu_torch.parallel.dryrun 2` (a tiny GAN G + D step over two
   ranks sharing the card, then the partitioned encoder and the spatial
   codec against the whole image's). Meanwhile, in this process: the
   single G step from the same checkpoint on the same global batch and
   noise, and a seeded 2048x3072 image through compress_spatial /
   decompress_spatial over 4 bands on cuda:0 beside compress / decompress
   (each leg timed with its peak memory). Gated: each world's loss within
   1e-4 and every gradient leaf within 1e-3 of its largest of the single
   step's, 29 forward and 29 backward norm launches in every rank's step,
   equal parameters on every rank; the CLI's checkpoint restores in the
   single-process trainer at step 2 with the unwrapped keys; the dry run
   passes; the partitioned `.hfc` bytes equal compress's, 0 y and 0 z
   symbols differ, pixels within one level, a 16-pixel halo's bytes
   differ, and each leg launches each rANS kernel once (one more for an
   encode past the default caps). The times of this phase share the card
   and the host with the ranks;
13. prints the kernels' JSON line and, last, the device line.

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


def bench_point_norm_shapes(config):
    """(M, C, act, dtype) of every ChannelNorm of one 1024x1024 image at
    bench.py's operating point in bf16, in call order: the generator's
    norm_in (the sixth) normalizes the fp32 decoded latents, the rest run
    in bf16."""
    return [(m, c, act, torch.float32 if i == 5 else torch.bfloat16)
            for i, (m, c, act) in enumerate(
                main_path_norm_shapes(config, 1024, 1024))]


def layer_norm_args(x, gamma, beta, eps: float = 1e-3,
                    weight_dtype=torch.float32):
    """Arguments of the one library call that computes the forward kernel's
    function without its ReLU: `F.layer_norm` over the channels of the
    channels-last view (a view, no copy), with gamma scaled by sqrt((C-1)/C)
    and eps by (C-1)/C, since var_u + eps = C/(C-1) * (var_b + eps (C-1)/C)
    for the unbiased var_u this norm takes and the biased var_b that
    layer_norm takes. A yardstick of speed only: the port never calls it."""
    c = x.shape[1]
    k = (c - 1) / c
    return (x.permute(0, 2, 3, 1), (c,),
            (gamma * math.sqrt(k)).to(weight_dtype),
            beta.to(weight_dtype), eps * k)


def layer_norm_backward_args(x, gamma, beta, g, eps: float = 1e-3,
                             weight_dtype=torch.float32):
    """Arguments of `torch.ops.aten.native_layer_norm_backward` for the same
    function (no ReLU), its mean and rstd computed here, outside any timing.
    It returns dx (channels-last view), dw and db: dgamma = dw * sqrt((C-1)
    / C), dbeta = db."""
    xv, shape, w, b, eps_ln = layer_norm_args(x, gamma, beta, eps,
                                              weight_dtype)
    _, mean, rstd = torch.native_layer_norm(xv, shape, w, b, eps_ln)
    return (g.permute(0, 2, 3, 1), xv, shape, mean, rstd, w, b,
            [True, True, True])


def library_weight_dtype(dtype):
    """float32 where the card's layer_norm and its backward take float32
    weights with input of `dtype`, else `dtype` (the weights cast)."""
    x = torch.ones((1, 4, 1, 2), device="cuda", dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    gamma = torch.ones(4, device="cuda")
    try:
        torch.nn.functional.layer_norm(*layer_norm_args(x, gamma, gamma))
        torch.ops.aten.native_layer_norm_backward(
            *layer_norm_backward_args(x, gamma, gamma, x))
        torch.cuda.synchronize()
        return torch.float32
    except RuntimeError as exc:
        log(f"layer_norm refuses {dtype} input with float32 weights "
            f"({str(exc).splitlines()[0]}); the yardstick casts them")
        return dtype


def check_forward_shape(m, c, act, dtype, gen, weights):
    """The forward kernel at one shape against its plain version (fp32
    within 1e-5; bf16 within one ulp plus 1e-5), two calls with the same
    bits, and its time beside the plain version's, the library call's and
    the bytes bound."""
    from hific_tpu_torch.ops import fused_norm

    x = torch.randn((1, m, 1, c), generator=gen, device="cuda")
    x = x.permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)
    gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
    got = fused_norm.channel_norm_fused(x, gamma, beta, act=act)
    again = fused_norm.channel_norm_fused(x, gamma, beta, act=act)
    want = fused_norm.channel_norm_fused_reference(x, gamma, beta, act=act)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"channel_norm M={m} C={c} {dtype}: two calls "
                             f"differ")
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        err, beyond, n_beyond = float(diff.max()), 0.0, 0
        if not err <= FP32_TOL:
            raise AssertionError(f"channel_norm M={m} C={c} act={act}: max "
                                 f"abs err {err} > {FP32_TOL}")
    else:
        # One bf16 ulp of the output, plus the fp32 limit: where gamma *
        # x_hat and beta nearly cancel, the two fp32 computations differ by
        # a few fp32 ulps of the terms, which is more than a bf16 ulp of
        # the small result.
        ulp = bf16_ulp(want)
        if not bool((diff <= ulp + FP32_TOL).all()):
            raise AssertionError(f"bf16 channel_norm M={m} C={c}: off by "
                                 f"{float((diff - ulp).max())} beyond one "
                                 f"ulp")
        err = float(diff.max())
        beyond = float((diff - ulp).clamp_min(0).max())
        n_beyond = int((diff > ulp).sum())
    args = layer_norm_args(x, gamma, beta, weight_dtype=weights[dtype])
    row = {
        "m": m, "c": c, "act": act, "dtype": str(dtype).split(".")[-1],
        "plan": list(fused_norm.forward_plan(
            m, c, x.element_size(), fused_norm._sm_count(x.device.index))),
        "max_abs_err": err, "max_beyond_one_ulp": beyond,
        "ms": cuda_time_ms(lambda: fused_norm.channel_norm_fused(
            x, gamma, beta, act=act)),
        "plain_ms": cuda_time_ms(
            lambda: fused_norm.channel_norm_fused_reference(
                x, gamma, beta, act=act)),
        "library_ms": cuda_time_ms(
            lambda: torch.nn.functional.layer_norm(*args)),
        "bound_ms": (2 * m * c * x.element_size() + 2 * c * 4)
        / HBM_BYTES_PER_S * 1e3,
    }
    log(f"channel_norm {row['dtype']:8s} M={m:7d} C={c:3d} {act:4s} plan "
        f"{row['plan']}: err {err:.2e} ({n_beyond} values beyond one ulp); "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, "
        f"layer_norm {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} "
        f"({row['bound_ms'] / row['ms']:.0%} of the HBM roofline)")
    return row


FWD_SUMS = ("ms", "plain_ms", "library_ms", "bound_ms")


def check_channel_norm(sets, weights):
    """The forward kernel at every shape of each set (name, dtype label,
    [(M, C, act, dtype)]), each distinct shape checked and timed once.
    Returns the sums per set and label (each shape as often as the set
    launches it) and the distinct shapes' rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, sums = {}, {}
    for name, label, shapes in sets:
        total = dict.fromkeys(FWD_SUMS, 0.0)
        total.update(max_abs_err=0.0, max_beyond_one_ulp=0.0)
        for shape in shapes:
            if shape not in rows:
                rows[shape] = check_forward_shape(*shape, gen, weights)
                rows[shape]["launches_per_set"] = {}
            row = rows[shape]
            key = f"{name} {label}"
            row["launches_per_set"][key] = (
                row["launches_per_set"].get(key, 0) + 1)
            for k in FWD_SUMS:
                total[k] += row[k]
            for k in ("max_abs_err", "max_beyond_one_ulp"):
                total[k] = max(total[k], row[k])
        sums.setdefault(name, {})[label] = total
        log(f"channel_norm {name} {label}: {len(shapes)} launches; kernel "
            f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f}, "
            f"layer_norm {total['library_ms']:.3f}, bound "
            f"{total['bound_ms']:.3f} ({total['bound_ms'] / total['ms']:.0%} "
            f"of the HBM roofline)")
    return sums, list(rows.values())


def empty_kernel_ms():
    """What a launch alone costs: an empty kernel of one warp and one of the
    one-wave grid (264 blocks of 256 threads), timed as the kernels are."""
    from hific_tpu_torch.ops import fused_norm

    lib = fused_norm.LIBRARY.load()

    def launch(blocks, threads):
        err = lib.hific_empty_kernel(
            blocks, threads, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty kernel: CUDA error {err}")

    return {f"{b}x{t}": cuda_time_ms(lambda: launch(b, t))
            for b, t in ((1, 32), (264, 256))}


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


def check_channel_norm_backward(shapes, gen, weights):
    """Backward kernel vs plain version at every shape (fp32 and bf16),
    with the kernel's, the plain version's and the library call's
    (`native_layer_norm_backward`, no ReLU mask) times at each distinct
    shape. Returns the summary."""
    from hific_tpu_torch.ops import fused_norm

    timed_shapes, bf16_shapes, max_err, worst = {}, {}, 0.0, (0.0, 0.0)
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
            k_ms = cuda_time_ms(lambda: fused_norm.channel_norm_backward(
                x, gamma, beta, g, act=act))
            p_ms = cuda_time_ms(
                lambda: fused_norm.channel_norm_backward_reference(
                    x, gamma, beta, g, act=act))
            args = layer_norm_backward_args(x, gamma, beta, g,
                                            weight_dtype=weights[dtype])
            l_ms = cuda_time_ms(
                lambda: torch.ops.aten.native_layer_norm_backward(*args))
            bound_ms = ((3 * m * c * x.element_size() + 4 * c * 4)
                        / HBM_BYTES_PER_S * 1e3)
            if dtype == torch.float32:
                max_err = max(max_err, abs_err)
                worst = (max(worst[0], dx_rel), max(worst[1], sums_rel))
                # The two kernels of the backward, each alone.
                dx_buf = torch.empty_like(x)
                row_ms, col_ms = (cuda_time_ms(
                    lambda: fused_norm.BACKWARD_KERNEL.launch(
                        x, g, gamma, beta, dx_buf, 1e-3, act == "relu",
                        stages=stages)) for stages in (1, 2))
                timed_shapes[(m, c, act)] = (k_ms, p_ms, bound_ms, l_ms,
                                             row_ms, col_ms)
                log(f"backward M={m:6d} C={c:3d} {act:4s}: dx err "
                    f"{dx_rel:.1e} of row scale, sums {sums_rel:.1e}, "
                    f"{kink_rows} rows at the kink")
                print(f"    backward M={m} C={c} {act}: kernel {k_ms:.4f} ms "
                      f"(row kernel {row_ms:.4f}, column sum {col_ms:.4f}), "
                      f"plain {p_ms:.4f} ms, native_layer_norm_backward "
                      f"{l_ms:.4f} ms, bound {bound_ms:.4f} ms, "
                      f"kernel/bound {k_ms / bound_ms:.2f}", flush=True)
            else:
                bf16_shapes[(m, c, act)] = (k_ms, p_ms, bound_ms, l_ms)
                log(f"backward bf16 M={m:6d} C={c:3d} {act:4s}: dx beyond "
                    f"one ulp by {dx_rel:.1e} of row scale at most ({beyond} "
                    f"values beyond one ulp), sums {sums_rel:.1e}, "
                    f"{kink_rows} rows at the kink; kernel {k_ms:.4f} ms, "
                    f"plain {p_ms:.4f} ms, native_layer_norm_backward "
                    f"{l_ms:.4f} ms, bound {bound_ms:.4f} ms")
    rows = [timed_shapes[s] for s in shapes]
    bf16_rows = [bf16_shapes[s] for s in shapes]
    return {
        "bf16": {"ms": sum(r[0] for r in bf16_rows),
                 "plain_ms": sum(r[1] for r in bf16_rows),
                 "bound_ms": sum(r[2] for r in bf16_rows),
                 "library_ms": sum(r[3] for r in bf16_rows)},
        "ms": sum(r[0] for r in rows),
        "plain_ms": sum(r[1] for r in rows),
        "bound_ms": sum(r[2] for r in rows),
        "library_ms": sum(r[3] for r in rows),
        "max_abs_err": max_err,
        "worst": worst,
        "per_shape": [
            {"m": m, "c": c, "act": act,
             "launches_per_step": sum(1 for s in shapes if s == (m, c, act)),
             "ms": r[0], "row_kernel_ms": r[4], "column_sum_ms": r[5],
             "plain_ms": r[1], "library_ms": r[3], "bound_ms": r[2],
             "bf16": dict(zip(("ms", "plain_ms", "bound_ms", "library_ms"),
                              bf16_shapes[(m, c, act)]))}
            for (m, c, act), r in timed_shapes.items()],
    }


def check_norm_kernels(config, card: str) -> dict:
    """Phase 3: the forward kernel against its plain version, and beside
    the library call, at the shapes of three paths: the 768x512 round trip
    and the batch-8 training step in each dtype, and one 1024x1024 image at
    bench.py's operating point in bf16. Phase 4: the backward kernel at the
    training step's shapes."""
    shapes = main_path_norm_shapes(config, IMAGE_H, IMAGE_W)
    train_shapes = train_step_norm_shapes(config, TRAIN_BATCH, TRAIN_CROP)
    t0 = time.perf_counter()
    weights = {dt: library_weight_dtype(dt)
               for dt in (torch.float32, torch.bfloat16)}
    fwd_sets = [(name, str(dt).split(".")[-1],
                 [(m, c, act, dt) for m, c, act in set_shapes])
                for name, set_shapes in (("round_trip_768x512", shapes),
                                         ("train_step_b8_256", train_shapes))
                for dt in (torch.float32, torch.bfloat16)]
    fwd_sets.append(("bench_1024x1024", "bfloat16",
                     bench_point_norm_shapes(config)))
    fwd_sums, fwd_rows = check_channel_norm(fwd_sets, weights)
    empty_ms = empty_kernel_ms()
    log(f"channel_norm: {len(fwd_rows)} distinct shapes in "
        f"{time.perf_counter() - t0:.1f} s; empty kernel {empty_ms} ms; "
        f"layer_norm weights {weights[torch.bfloat16]} for bf16 input "
        f"({card})")

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    bwd = check_channel_norm_backward(train_shapes, gen, weights)
    log(f"channel_norm backward: {len(train_shapes)} shapes per step, worst "
        f"dx err {bwd['worst'][0]:.2e} of row scale, dgamma/dbeta "
        f"{bwd['worst'][1]:.2e} of column scale; per step kernel "
        f"{bwd['ms']:.3f} ms, plain {bwd['plain_ms']:.3f} ms, "
        f"native_layer_norm_backward {bwd['library_ms']:.3f} ms, bound "
        f"{bwd['bound_ms']:.3f} ms; {time.perf_counter() - t0:.1f} s "
        f"({card})")
    return {"forward": fwd_sums, "forward_rows": fwd_rows,
            "empty_kernel_ms": empty_ms, "weights": weights,
            "backward": bwd}


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


# A ReLU input or latent within this share of its layer's largest
# |pre-activation| of the kink (of its magnitude of the half-integer) may
# fall on either side on the card and the CPU in float32: the CPU tests'
# KINK_REL (tests/test_torch_train.py).
KINK_REL = 1e-4


def bf16_share(card, cpu, ref) -> float:
    """|card - ref| over its bfloat16 limit, 2 |cpu - ref| + one bf16 ulp
    of ref's largest |value| (2**-7 of it rounded down to a power of 2):
    how the tiny bfloat16 step judges each tensor of the card's run
    against the CPU's bfloat16 run, with the CPU's float32 run as the
    yardstick."""
    card, cpu, ref = (t.float() for t in (card, cpu, ref))
    top = float(ref.abs().max())
    floor = 2.0 ** math.floor(math.log2(top)) * 2.0 ** -7 if top else 0.0
    limit = 2 * float((cpu - ref).abs().max()) + floor
    return float((card - ref).abs().max()) / max(limit, 1e-30)


def tiny_variant_step_card_vs_cpu(overrides, loss_tol: float,
                                  grad_tol: float) -> str:
    """One tiny-config training step of a variant (`overrides`: its config
    fields) on the card (the kernels) and on the CPU (the plain versions),
    same weights and same noise (quantization noise and, with
    `sample_noise`, the generator's): loss within `loss_tol` relative.

    The CPU step takes the card's side of every ReLU and latent rounding
    the two decided apart (`KinkSides`). float32: each such element within
    KINK_REL of the tie on both sides, and every gradient within
    `grad_tol` of its leaf's largest. bfloat16, whose differences have no
    natural scale, against the CPU's float32 step (which takes its own
    sides): each ReLU layer's pre-activations, each rounding's input and
    each gradient leaf of the card's step no further from float32 than
    twice the CPU bfloat16 step's distance plus one bf16 ulp (`bf16_share`
    at most `grad_tol`). An element decided apart then lies within that
    bound of the tie, so the card's side is one the CPU could have taken."""
    import hific_tpu_torch.models.generator as generator_module
    import hific_tpu_torch.models.hyperprior as hyperprior_module
    from hific_tpu_torch.config import mse_lpips_config
    from hific_tpu_torch.kinks import KinkSides
    from hific_tpu_torch.models.hific import HiFiC, init_random_
    from hific_tpu_torch.training.train_step import (
        TrainState, make_optimizers, make_train_step_g)

    cfg = mse_lpips_config(latent_channels=8, n_residual_blocks=1,
                           hyperlatent_filters=16, crop_size=64, **overrides)
    rng = np.random.RandomState(SEED)
    x = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    noise = {}

    def shared(key, draw):
        if key not in noise:
            noise[key] = torch.from_numpy(draw(key).astype(np.float32))
        return noise[key]

    def shared_noise(t, generator):
        return t + shared(("u",) + tuple(t.shape), lambda k: rng.uniform(
            -0.5, 0.5, k[1:])).to(t.device, t.dtype)

    def shared_normal(shape, generator, dtype, device):
        return shared(("n",) + tuple(shape), lambda k: rng.randn(*k[1:])
                      ).to(device, dtype)

    init = init_random_(HiFiC(cfg), torch.Generator().manual_seed(SEED))
    bf16 = cfg.dtype == "bfloat16"
    # bf16: the CPU's fp32 step too, the yardstick of both bf16 steps.
    runs = [("cuda", cfg), ("cpu", cfg)] + (
        [("cpu32", cfg.replace(dtype="float32"))] if bf16 else [])
    grads, losses, sides = {}, {}, {}
    saved = hyperprior_module.quantize_noise, generator_module.generator_noise
    hyperprior_module.quantize_noise = shared_noise
    generator_module.generator_noise = shared_normal
    try:
        for device, run_cfg in runs:
            model = HiFiC(run_cfg)
            model.load_state_dict(init.state_dict())
            model = model.to("cuda" if device == "cuda" else "cpu",
                             memory_format=torch.channels_last)
            state = TrainState(0, model, make_optimizers(run_cfg, model),
                               None)
            with KinkSides().hooked(model, sides["cuda"] if device == "cpu"
                                    else None) as sides[device]:
                diag = make_train_step_g(run_cfg)(state, x)
            losses[device] = float(diag["weighted_compression_loss"])
            grads[device] = {n: p.grad.float().cpu() for n, p in
                             model.named_parameters()}
    finally:
        hyperprior_module.quantize_noise, generator_module.generator_noise = \
            saved
    card, cpu = sides["cuda"], sides["cpu"]
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    name = ", ".join(f"{k}={v}" for k, v in overrides.items())
    if bf16:
        ref = sides["cpu32"]
        acts = {n: bf16_share(card.pre[n], cpu.pre[n], ref.pre[n])
                for n in card.pre}
        acts.update({f"rounding {i}": bf16_share(a, b, c) for i, (a, b, c)
                     in enumerate(zip(card.rounding, cpu.rounding,
                                      ref.rounding))})
        rel = {n: bf16_share(grads["cuda"][n], grads["cpu"][n],
                             grads["cpu32"][n]) for n in grads["cpu"]}
        worst_act = max(acts, key=acts.get)
        if acts[worst_act] > grad_tol:
            raise AssertionError(
                f"tiny training step ({name}), card vs CPU: activations "
                f"{worst_act} at {acts[worst_act]:.3f} of their bf16 limit "
                f"(limit {grad_tol:g}); {cpu.summary()}")
        ties = (f"activations at most {acts[worst_act]:.3f} of their bf16 "
                f"limit ({worst_act})")
    else:
        # Under instance norm a bias that feeds a norm (and norm_in's beta)
        # has a zero gradient in exact arithmetic: both sides' are rounding
        # noise, held against the largest gradient of the layer's weight.
        scale_of = {}
        if not cfg.use_channel_norm:
            convs = (["encoder.conv_stem"]
                     + [f"encoder.conv_down{i}" for i in range(4)]
                     + ["generator.conv_head", "generator.resblock_0.conv1",
                        "generator.resblock_0.conv2"]
                     + [f"generator.upconv{i}" for i in range(4)])
            scale_of = {f"{c}.bias": f"{c}.weight" for c in convs}
            scale_of["generator.norm_in.beta"] = "generator.norm_in.gamma"
        cpu.check(KINK_REL)
        rel = {n: float((grads["cuda"][n] - g).abs().max()
                        / grads["cpu"][scale_of.get(n, n)].abs().max()
                        .clamp_min(1e-30))
               for n, g in grads["cpu"].items()}
        ties = f"ties within {KINK_REL:g}"
    worst = max(rel, key=rel.get)
    grad_rel = rel[worst]
    if not (loss_rel <= loss_tol and grad_rel <= grad_tol):
        top = sorted(rel, key=rel.get)[-4:]
        raise AssertionError(f"tiny training step ({name}), card vs CPU: loss "
                             f"off by {loss_rel:.2e}, gradients by "
                             f"{grad_rel:.2e} ({worst}; next "
                             f"{[(n, round(rel[n], 6)) for n in top]})")
    what = ("of its bf16 limit (2 |CPU bf16 - fp32| + 1 ulp)" if bf16
            else "of its largest")
    return (f"tiny training step ({name}), card vs CPU plain path: loss rel "
            f"diff {loss_rel:.2e} (limit {loss_tol:g}), worst gradient leaf "
            f"{worst} {grad_rel:.2e} {what} (limit {grad_tol:g}); {ties}; "
            f"{cpu.summary()}")


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


GAN_PAIRS = 3  # G/D step pairs of the flagship GAN phase


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


def event_ms(fn, reps: int, warm: bool = False) -> float:
    """Median device time of `reps` calls of fn, each between two CUDA
    events (a serial kernel's time varies with its data, so each call is
    timed alone), after one call unless the caller has `warm` shapes."""
    if not warm:
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


RANS_SHAPES = [("y 1024x1024", "y", 4096, (0.0,)),
               ("y 768x512", "y", 1536, (0.0, 0.08, 0.3, "multi-nibble")),
               ("z 1024x1024", "z", 256, (0.0, 0.08, 0.3))]
# The multi-stream batch, of the cases' planes: four images' y and z at
# escape rates 0, 0.08, 0.3 and 0 (1024x1024, but the y of the 0.08 and
# 0.3 images are 768x512's; the fourth repeats the first), and one 768x512
# y.
RANS_BATCH = (["y 1024x1024 escapes 0.0", "y 768x512 escapes 0.08",
               "y 768x512 escapes 0.3", "y 1024x1024 escapes 0.0"]
              + [f"z 1024x1024 escapes {r}" for r in (0.0, 0.08, 0.3, 0.0)]
              + ["y 768x512 escapes 0.0"])


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
    (one run), the native host coder's for the same stream (median of
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
    plain = {}  # case label -> (kind, sym, idx, plain encode, plain decode)

    def plain_timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

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
        # The plain versions (~0.3-2 s a stream) once, timed as they run
        # for the check: a yardstick ~1000x the kernels' time, whose spread
        # matters little. Their outputs serve the batch's check too.
        want, p_ms = plain_timed(lambda: encode_scan_reference(*job))
        host = host_encode(kind, sym, idx)
        check_encode(label, got, want, host, lanes)
        counts = got[2].cpu().numpy()
        words = words_tensor(host, "cuda")
        decoded, bad = decode_scan(words, idx_d, packed[kind])
        plain_dec, pd_ms = plain_timed(lambda: decode_scan_reference(
            words, idx_d, packed[kind]))
        check_decode(label, decoded, bad, plain_dec, sym)
        plain[label] = (kind, sym, idx, want, plain_dec)
        log(f"rans {label}: P={p} L={lanes}, {len(host)} words "
            f"({32 * len(host) / sym.size:.3f} bits/symbol), "
            f"{int(counts[1])} push events: kernels equal their plain "
            f"versions and the host coder")
        if not label.endswith("escapes 0.0"):
            continue
        shape = label.split(" escapes")[0]
        n = p * lanes
        k_ms = event_ms(lambda: encode_scan(*job), 20)
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
            p_ms = pd_ms
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

    # The multi-stream batch: one launch of each kernel for all streams,
    # the cases' symbol planes, each held against its case's plain outputs
    # (the plain versions are functions of the planes and the caps alone).
    cases = [plain[label] for label in RANS_BATCH]
    streams = [(kind, sym, idx) for kind, sym, idx, _, _ in cases]
    jobs = [EncodeJob(torch.from_numpy(sym).cuda(),
                      torch.from_numpy(idx).cuda(), packed[kind],
                      **caps_of(sym)) for kind, sym, idx in streams]
    hosts = [host_encode(kind, sym, idx) for kind, sym, idx in streams]
    djobs = [DecodeJob(words_tensor(h, "cuda"), job.idx_l, job.tables)
             for h, job in zip(hosts, jobs)]
    got = encode_scan_many(jobs)
    decoded = decode_scan_many(djobs)
    for k, ((kind, sym, idx, want, plain_dec), host) in enumerate(
            zip(cases, hosts)):
        label = f"batch stream {k} ({kind}, P={sym.shape[0]})"
        check_encode(label, got[k], want, host, sym.shape[1])
        check_decode(label, *decoded[k], plain_dec, sym)
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


CHUNK = 4                    # pipeline_chunk of the chunked batch paths
SMALL_IMAGES, SMALL_SIDE = 16, 256  # the small-image traffic, bf16 only


def hfc_bytes(out) -> bytes:
    from hific_tpu_torch.entropy.container import dumps_compressed

    return dumps_compressed(out)[0]


def chunk_symbols(codec, imgs):
    """Each image's (y, z, coding indices) as `compress_many` stages it."""
    return [(s.y_sym, s.z_sym, s.idx) for s in codec._fetch_symbols(
        [codec._stage(codec._model_input(x), x.shape[1:3]) for x in imgs])]


def chunked_calls(codec, imgs, outs, recons, what: str):
    """compress_many and decompress_many of `imgs` at pipeline_chunk CHUNK
    against their pipeline_chunk 1 results `outs` and `recons`: the same
    `.hfc` bytes, pixels and coding indices (gated); one encode launch
    (one more past the caps) and one decode launch a call, and the norm
    kernel once a layer an image (gated: the transforms run image by
    image). Returns the launch counts."""
    relaunches = codec.device_relaunches
    codec.pipeline_chunk = CHUNK
    zero_kernel_counts()
    outs4 = codec.compress_many(imgs)
    enc = kernel_counts()
    zero_kernel_counts()
    recons4 = codec.decompress_many(outs4, as_uint8=True)
    dec = kernel_counts()
    sym4 = chunk_symbols(codec, imgs)
    codec.pipeline_chunk = 1
    sym1 = chunk_symbols(codec, imgs)
    relaunched = codec.device_relaunches - relaunches
    n_norm = len(main_path_norm_shapes(codec.config, *imgs[0].shape[1:3]))
    if (enc[1:], dec[1:]) != ((1 + (relaunched > 0), 0), (0, 1)):
        raise AssertionError(f"{what} at pipeline_chunk {CHUNK}: launches "
                             f"{enc} to encode, {dec} to decode; expected "
                             f"one rANS launch a call")
    if (enc[0], dec[0]) != (5 * len(imgs), (n_norm - 5) * len(imgs)):
        raise AssertionError(f"{what} at pipeline_chunk {CHUNK}: {enc[0]} "
                             f"and {dec[0]} norm launches; expected one a "
                             f"layer an image")
    differ = {name: sum(int((a[k] != b[k]).sum()) for a, b in zip(sym1, sym4))
              for k, name in enumerate(("y", "z", "indices"))}
    if any(differ.values()):
        raise AssertionError(f"{what}: chunked symbols differ {differ}")
    if [hfc_bytes(o) for o in outs4] != [hfc_bytes(o) for o in outs]:
        raise AssertionError(f"{what}: the .hfc bytes at pipeline_chunk "
                             f"{CHUNK} differ from the per-image ones")
    if not all(np.array_equal(a, b) for a, b in zip(recons4, recons)):
        raise AssertionError(f"{what}: the pixels at pipeline_chunk {CHUNK} "
                             f"differ from the per-image ones")
    return {"encode_launches": {"channel_norm": enc[0], "rans_encode": enc[1]},
            "decode_launches": {"channel_norm": dec[0], "rans_decode": dec[2]},
            "relaunched": relaunched, "symbols_differ": differ}


def chunk_path(codec, imgs, outs, recons, small_images: bool, card: str):
    """The batch path's calibrated images at pipeline_chunk CHUNK
    (`chunked_calls`); with `small_images`, SMALL_IMAGES seeded
    SMALL_SIDE-square images too, at pipeline_chunk 1 and CHUNK: per chunk
    size a pass's MP/s (compress_many, decompress_many to numpy; median of
    3), the device busy share of one profiled pass at CHUNK, and the bytes
    and pixels of CHUNK's pass equal chunk 1's (gated)."""
    summary = {"bench": chunked_calls(codec, imgs, outs, recons,
                                      "4 x 1024x1024")}
    log(f"pipeline_chunk {CHUNK}, 4 x 1024x1024: .hfc bytes, pixels and "
        f"coding indices equal chunk 1's; launches {summary['bench']}")
    if not small_images:
        return summary
    small = [bench_image(s, SMALL_SIDE, SMALL_SIDE)
             for s in range(1, SMALL_IMAGES + 1)]
    mp = SMALL_IMAGES * SMALL_SIDE ** 2 / 1e6
    passes = {}

    def one_pass():
        outs = codec.compress_many(small)
        passes[codec.pipeline_chunk] = (
            [hfc_bytes(o) for o in outs], codec.decompress_many(outs))
        return outs

    # The first pass at this shape, untimed.
    row = {"images": SMALL_IMAGES, "side": SMALL_SIDE,
           "bpp": float(np.mean([o.total_bpp for o in one_pass()]))}
    for chunk in (1, CHUNK):
        codec.pipeline_chunk = chunk
        ms = float(np.median([timed(one_pass)[1] for _ in range(3)]))
        row[f"chunk{chunk}"] = {"ms": ms, "mp_s": mp / ms * 1e3}
    wall_ms, _, busy_ms = profiled(one_pass)
    codec.pipeline_chunk = 1
    (bytes1, recons1), (bytes4, recons4) = passes[1], passes[CHUNK]
    if bytes4 != bytes1 or not all(np.array_equal(a, b)
                                   for a, b in zip(recons4, recons1)):
        raise AssertionError(f"small images: bytes or pixels at "
                             f"pipeline_chunk {CHUNK} differ from chunk 1's")
    row[f"chunk{CHUNK}"].update(profiled_wall_ms=wall_ms,
                                device_busy_ms=busy_ms,
                                busy_share=busy_ms / wall_ms)
    summary["small"] = row
    log(f"{SMALL_IMAGES} x {SMALL_SIDE}x{SMALL_SIDE} at {row['bpp']:.4f} "
        f"bpp: chunk 1 {row['chunk1']['mp_s']:.3f} MP/s, chunk {CHUNK} "
        f"{row[f'chunk{CHUNK}']['mp_s']:.3f} MP/s (a profiled pass: wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
        f"{row[f'chunk{CHUNK}']['busy_share']:.0%}); bytes and pixels "
        f"equal (host clock after synchronize, median of 3; {card})")
    return summary


def host_coders_path(codec, card: str):
    """The host coders on the calibrated codec, 768x512 images: with
    coder_threads 4 (container v2) the file decodes to the v1 file's
    symbols and pixels, is at most 6 + 2 * 4 * (1 + 4) bytes larger and
    launches no rANS kernel; with vectorize=False the scalar stream decodes
    to the same symbols and pixels; compress_many / decompress_many on the
    host coder of four images at wire_chunk 4 give wire_chunk 1's bytes
    and pixels; no thread outlives a call. Returns the summary."""
    import threading

    x = smooth_image(SEED)
    v1 = codec.compress(x)
    z1, y1, _ = codec.decode_symbols(v1)
    r1 = codec.decompress(v1, as_uint8=True)
    threads = threading.active_count()
    sizes = {"v1": len(hfc_bytes(v1))}
    for name, option, value in (("v2", "coder_threads", 4),
                                ("scalar", "vectorize", False)):
        default = getattr(codec, option)
        setattr(codec, option, value)
        zero_kernel_counts()
        out, enc_ms = timed(lambda: codec.compress(x))
        r, dec_ms = timed(lambda: codec.decompress(out, as_uint8=True))
        counts = kernel_counts()
        z, y, _ = codec.decode_symbols(out)
        setattr(codec, option, default)
        sizes[name] = len(hfc_bytes(out))
        sizes[f"{name}_ms"] = {"compress": enc_ms, "decompress": dec_ms}
        if counts[1:] != (0, 0):
            raise AssertionError(f"{name}: rANS kernels launched {counts[1:]}")
        if not (np.array_equal(z, z1) and np.array_equal(y, y1)
                and np.array_equal(r, r1)):
            raise AssertionError(f"{name}: symbols or pixels differ from v1's")
    if sizes["v2"] > sizes["v1"] + 6 + 2 * 4 * (1 + 4):
        raise AssertionError(f"v2 file {sizes['v2']} bytes against v1's "
                             f"{sizes['v1']}")
    imgs = [smooth_image(SEED + k) for k in range(4)]
    wire = {}
    for chunk in (1, CHUNK):
        codec.wire_chunk = chunk
        outs, enc_ms = timed(lambda: codec.compress_many(
            imgs, device_encode=False))
        recons, dec_ms = timed(lambda: codec.decompress_many(
            outs, as_uint8=True, device_decode=False))
        wire[chunk] = ([hfc_bytes(o) for o in outs], recons, enc_ms, dec_ms)
    codec.wire_chunk = 1
    if wire[1][0] != wire[CHUNK][0] or not all(
            np.array_equal(a, b) for a, b in zip(wire[1][1], wire[CHUNK][1])):
        raise AssertionError(f"wire_chunk {CHUNK}: bytes or pixels differ "
                             f"from wire_chunk 1's")
    if threading.active_count() != threads:
        raise AssertionError("a coder thread outlived its call")
    summary = {**sizes, "wire_chunk_ms": {
        str(c): {"compress_many": w[2], "decompress_many": w[3]}
        for c, w in wire.items()}}
    log(f"host coders, {IMAGE_W}x{IMAGE_H}: v1 {sizes['v1']} B, v2 (4 "
        f"shards) {sizes['v2']} B, scalar {sizes['scalar']} B; same symbols "
        f"and pixels, no rANS launch; wire_chunk {CHUNK} = wire_chunk 1 on 4 "
        f"images (host coder, ms {summary['wire_chunk_ms']}; {card})")
    return summary


def s2d_crop_card_vs_cpu(codec, cpu, crop) -> str:
    """The encoder with the space-to-depth front on, card against the CPU's
    plain path on the 64x64 crop: latents within 1e-3 of their largest
    magnitude (the d2s tail is on by default, so the crop check before it
    covers the generator's)."""
    from hific_tpu_torch.runtime import fp32_numerics

    encs = (codec.model.encoder, cpu.model.encoder)
    saved = [e.s2d_front for e in encs]
    for e in encs:
        e.s2d_front = True
    with torch.inference_mode(), fp32_numerics(deterministic=True):
        y_gpu, _ = codec.model.encode(codec._model_input(crop))
        y_cpu, _ = cpu.model.encode(cpu._model_input(crop))
    for e, flag in zip(encs, saved):
        e.s2d_front = flag
    err = float((y_gpu.cpu() - y_cpu).abs().max()
                / y_cpu.abs().max().clamp_min(1.0))
    if not (np.isfinite(err) and err <= 1e-3):
        raise AssertionError(f"card vs CPU on a 64x64 crop with the s2d "
                             f"front: latents differ by {err} (relative)")
    return (f"card vs CPU plain path, 64x64 crop, s2d front on: latents max "
            f"diff {err:.2e} of their largest magnitude (limit 1e-3)")


def vgg_lpips_card_vs_cpu() -> str:
    """LPIPS with the VGG16 backbone (seeded) on one pair of seeded
    256x256 images, card against CPU: within 1e-4 relative."""
    from hific_tpu_torch.models.lpips import default_lpips
    from hific_tpu_torch.runtime import fp32_numerics

    rng = np.random.RandomState(SEED)
    a, b = (torch.from_numpy(rng.rand(1, 3, 256, 256).astype(np.float32))
            for _ in range(2))
    model = default_lpips(SEED, "vgg").eval()
    with torch.inference_mode():
        want = float(model(a, b, normalize=True))
        model = model.cuda()
        with fp32_numerics(deterministic=True):
            got = float(model(a.cuda(), b.cuda(), normalize=True))
    rel = abs(got - want) / abs(want)
    if not (np.isfinite(got) and rel <= 1e-4):
        raise AssertionError(f"VGG LPIPS card {got} vs CPU {want}: {rel:.2e} "
                             f"relative (limit 1e-4)")
    return (f"VGG16 LPIPS, one 256x256 pair: card {got:.6f}, CPU {want:.6f}, "
            f"{rel:.2e} relative (limit 1e-4)")


def layout_rewrites(codec, imgs, card: str) -> dict:
    """The generator with the depth-to-space tail (`d2s_generator_tail`)
    on against off, and the encoder with the space-to-depth front
    (`s2d_encoder_front`) on against off, on the images `imgs` at the
    calibrated operating point. The generator runs on the encoder's
    latents of the images: with seeded random weights the decoded latents
    there are all zero (z rounds to 0, so mu is 0, and so are the y
    symbols), and so is the generator's output on them. Gated in float32:
    the generator's output nonzero and within 1e-4 of its largest
    magnitude, and the reconstruction within 1e-4 and as uint8 within one
    level; in either dtype: one norm launch a norm layer an image in both
    settings. Reported: the largest differences, the y symbols that
    differ, and each setting's device time on one image (CUDA events,
    median of 5, the shapes warm). The flags are put back as the config
    has them."""
    from hific_tpu_torch.models.layers import Norm
    from hific_tpu_torch.ops import fused_norm
    from hific_tpu_torch.runtime import fp32_numerics

    model = codec.model
    gen, enc = model.generator, model.encoder
    saved = gen.d2s_tail, enc.s2d_front
    layers = {name: sum(isinstance(m, Norm) for m in part.modules())
              for name, part in (("d2s", gen), ("s2d", enc))}
    with torch.inference_mode(), fp32_numerics(deterministic=True):
        xs = [codec._model_input(x) for x in imgs]
        latents = [model.encode(x)[0] for x in xs]

        def variant(call, inputs):
            before = fused_norm.KERNEL.launches
            results = [call(v) for v in inputs]
            torch.cuda.synchronize()
            per_image = (fused_norm.KERNEL.launches - before) / len(inputs)
            return (results, per_image,
                    event_ms(lambda: call(inputs[0]), 5, warm=True))

        def largest(a, b) -> float:
            return max(float((u.float() - v.float()).abs().max())
                       for u, v in zip(a, b))

        summary = {}
        for name, module, attr, inputs in (("d2s", gen, "d2s_tail", latents),
                                           ("s2d", enc, "s2d_front", xs)):
            runs = {}
            for flag in (True, False):
                setattr(module, attr, flag)
                runs[flag] = variant(module, inputs)
            on, off = runs[True][0], runs[False][0]
            scale = max(float(b.abs().max()) for b in off)
            if not scale > 0:
                raise AssertionError(f"{name} on vs off: the output is all "
                                     f"zero, so the comparison says nothing")
            summary[name] = {
                "on_ms": runs[True][2], "off_ms": runs[False][2],
                "norm_launches_per_image": {"on": runs[True][1],
                                            "off": runs[False][1]},
                "norm_layers": layers[name],
                "max_diff_of_largest": largest(on, off) / scale}
            if name == "d2s":
                images = [[model.reconstruction(r, x.shape[1:3]) for r, x
                           in zip(rs, imgs)] for rs in (on, off)]
                u8 = [[codec._image(r, True).int() for r in rs]
                      for rs in images]
                summary[name].update(max_abs_diff=largest(*images),
                                     max_uint8_diff=int(largest(*u8)))
            del runs, on, off
        syms = {}
        for flag in (True, False):
            enc.s2d_front = flag
            syms[flag] = [codec.encode_symbols(x)[1] for x in imgs]
        summary["s2d"]["y_symbols_differ"] = sum(
            int((a != b).sum()) for a, b in zip(syms[True], syms[False]))
        summary["s2d"]["y_symbols"] = sum(a.size for a in syms[True])
    gen.d2s_tail, enc.s2d_front = saved
    dtype = codec.config.dtype
    for name in ("d2s", "s2d"):
        launches = summary[name]["norm_launches_per_image"]
        if launches != {"on": layers[name], "off": layers[name]}:
            raise AssertionError(f"{dtype} {name} on / off: norm launches "
                                 f"per image {launches}; expected one per "
                                 f"norm layer ({layers[name]})")
    d2s = summary["d2s"]
    if dtype == "float32" and not (d2s["max_diff_of_largest"] <= 1e-4
                                   and d2s["max_abs_diff"] <= 1e-4
                                   and d2s["max_uint8_diff"] <= 1):
        raise AssertionError(f"float32 generator, d2s tail on vs off: "
                             f"{d2s}; limits 1e-4 of the largest output, "
                             f"1e-4 and one uint8 level")
    s2d = summary["s2d"]
    log(f"{dtype} layout rewrites on {len(imgs)} {imgs[0].shape[2]}x"
        f"{imgs[0].shape[1]} images: d2s tail on vs off on their encoder "
        f"latents, generator output "
        f"differs by {d2s['max_diff_of_largest']:.2e} of its largest, "
        f"reconstructions by {d2s['max_abs_diff']:.2e} (uint8 "
        f"{d2s['max_uint8_diff']}), generator {d2s['on_ms']:.2f} vs "
        f"{d2s['off_ms']:.2f} ms an image; s2d front on vs off, "
        f"{s2d['y_symbols_differ']} of {s2d['y_symbols']} y symbols differ "
        f"(latents by {s2d['max_diff_of_largest']:.2e} of their largest), "
        f"encoder {s2d['on_ms']:.2f} vs {s2d['off_ms']:.2f} ms an image; "
        f"{layers['d2s']} and {layers['s2d']} norm launches an image in "
        f"both settings (CUDA events, median of 5; {card})")
    return summary


def batch_path(codec, card: str, small_images: bool = False):
    """compress_many / decompress_many on four seeded 1024x1024 images at
    bench.py's operating point, through the device coders, at
    pipeline_chunk 1 and CHUNK (`chunk_path`, with the small images where
    asked). Returns the launch counts of each path and the summary."""
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
    chunked = chunk_path(codec, imgs, outs, recons, small_images, card)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serial.hfc")
        codec.compress_file(x0, path)
        codec.decompress_file(path, as_uint8=True)
        t_enc, t_dec = [], []
        for _ in range(3):
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
        pipelined = float(np.median([timed(one_pass)[1] for _ in range(3)]))
        codec.pipeline_chunk = CHUNK  # the same shapes: warm already
        pipelined_chunk = float(np.median([timed(one_pass)[1]
                                           for _ in range(3)]))
        codec.pipeline_chunk = 1
    imgs_dev = [torch.from_numpy(x).cuda() for x in imgs]

    def device_pass():
        outs = codec.compress_many(imgs_dev)
        recons = codec.decompress_many(outs, as_uint8=True, as_numpy=False)
        return [int(r[0, 0, 0, 0]) for r in recons]

    device_pass()
    resident = float(np.median([timed(device_pass)[1] for _ in range(3)]))
    wall_ms, rows, busy_ms = profiled(device_pass)
    kernel_ms = {k: sum(e.self_device_time_total for e in rows if k in e.key)
                 / 1e3 for k in ("rans_encode", "rans_decode", "channel_norm")}
    for e in rows:
        if "rans_" in e.key or "channel_norm" in e.key:
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
                  f"{e.key[:90]}")
    log(f"profiled device-resident pass (4 images): wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.0%}); "
        f"rans_encode {kernel_ms['rans_encode']:.2f} ms, rans_decode "
        f"{kernel_ms['rans_decode']:.2f} ms, ChannelNorm forward "
        f"{kernel_ms['channel_norm']:.2f} ms; top kernels by device time:")
    print_top(rows, 8)
    summary = {
        "bpp": float(np.mean(bpps)),
        "device_busy_share": busy_ms / wall_ms,
        "serial_ms_per_image": enc + dec,
        "serial_mp_s": mp / ((enc + dec) / 1e3),
        "pipelined_ms_per_image": pipelined / 4,
        "pipelined_mp_s": 4 * mp / (pipelined / 1e3),
        "device_resident_mp_s": 4 * mp / (resident / 1e3),
        f"pipelined_mp_s_chunk{CHUNK}": 4 * mp / (pipelined_chunk / 1e3),
        "chunked": chunked,
        "profiled_rans_encode_ms": kernel_ms["rans_encode"],
        "profiled_rans_decode_ms": kernel_ms["rans_decode"],
        "profiled_channel_norm_ms": kernel_ms["channel_norm"],
        "layout_rewrites": layout_rewrites(codec, imgs, card),
    }
    log(f"batch path, 1024x1024 at {summary['bpp']:.4f} bpp: serial "
        f"compress_file {enc:.1f} + decompress_file {dec:.1f} ms per image "
        f"({summary['serial_mp_s']:.3f} MP/s); pipelined x4 "
        f"{summary['pipelined_ms_per_image']:.1f} ms per image "
        f"({summary['pipelined_mp_s']:.3f} MP/s); device-resident x4 "
        f"{summary['device_resident_mp_s']:.3f} MP/s; at pipeline_chunk "
        f"{CHUNK}: pipelined {summary[f'pipelined_mp_s_chunk{CHUNK}']:.3f} "
        f"MP/s (host clock after synchronize, medians of 3; {card})")
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
        # Its config computes in bf16; the phases before 11 run fp32, and
        # phase 11 runs the same weights in bf16.
        return config.replace(dtype="float32"), state, f"artifact {path}"
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
        "dtypes": "int32 symbols and indices on every path (fp32 and bf16 "
                  "codecs alike)",
        "per_shape": rows,
        "batch": {"streams": batch["streams"],
                  "positions": batch["positions"],
                  "ms": batch[f"{name[5:]}_ms"],
                  "ms_one_by_one": batch[f"{name[5:]}_ms_one_by_one"]},
    }


SERVE_CLIENTS, SERVE_PER_CLIENT = 4, 4
TILE_H, TILE_W = 2000, 3000  # a 6 MP camera photo; W not a multiple of 16
# Halos: 64 pixels, 16 latents. The 32-latent decode leg (3.1 s) was
# dropped to keep the script inside its time with phase 11; its generator
# window is still measured below.
TILE_IMAGE, TILE_LATENTS = 1024, (64,)
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
    fused_norm.KERNEL.by_dtype.clear()
    device_rans.ENCODE_KERNEL.launches = 0
    device_rans.DECODE_KERNEL.launches = 0


def params_npz(state, config, tmp: str) -> str:
    """The `-ckpt` of the serving and CLI phases: the weights (the
    artifact's or the seeded ones) and `config` (which sets the compute
    dtype the tools run in) written to an uncompressed `.npz` in the
    artifact's layout (compressing 0.7 GB would take most of a minute)."""
    from hific_tpu_torch.models.hific import HiFiC
    from hific_tpu_torch.weights import (NPZ_CONFIG_KEY, NPZ_LEAF_PREFIX,
                                         jax_params_from_model)

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
        "pipeline_chunk": codec.pipeline_chunk,
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
        f"{stats['max_batch_seen']} (pipeline_chunk {codec.pipeline_chunk})"
        f"; launches norm {counts[0]}, rans_encode "
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
    decompress(as_uint8) against decompress(tile_latents=64), both
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
    enc_tiled = codec._symbols(x_in, codec.tiled_encoder(TILE_IMAGE, 64))
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
    window = 32 + 2 * 16  # a 32-latent tile's window
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
        f"weights; the tables come from the process' first build); the two "
        f"modes' .hfc equal the host "
        f"coder's; PSNR "
        + ", ".join(f"{r['psnr']:.2f}" for r in rows) + " dB; decoded PNGs "
        f"equal the codec's pixels; launches norm {counts[0]}, rans_encode "
        f"{counts[1]}, rans_decode {counts[2]} ({card})")
    return counts, summary


BF16_STEPS = 16    # the bf16 trainer's steps; the profiler takes 11-15
BF16_TILES, BF16_TILE = 16, 320  # its corpus: uniformly sized seeded tiles
# Tiny bf16 step, card vs CPU: each gradient leaf's distance from the fp32
# step within 2x the CPU bf16 step's plus one bf16 ulp (a share of 1).
BF16_GRAD_TOL = 1.0


def transposed_leaves(model) -> set:
    """Names of the transposed convs' parameters: bf16 leaves under a
    bfloat16 config, as in the JAX package."""
    from hific_tpu_torch.models.layers import ConvTranspose

    return {f"{n}.{leaf}" for n, m in model.named_modules()
            if isinstance(m, ConvTranspose) for leaf in ("weight", "bias")}


def by_dtype(counter) -> dict:
    return {str(k).replace("torch.", ""): v for k, v in counter.items()}


def bf16_codec_path(config, state, card: str):
    """The flagship codec under dtype="bfloat16": compress_file -> .hfc ->
    decompress_file of the seeded 768x512 image (symbols lossless; the
    norm kernel 29 times, norm_in's on the fp32 decoded latents, the rest
    bf16; each rANS kernel once, the encoder once more where the
    uncalibrated image overruns its caps), then the batch path at
    bench.py's operating point (its factorized tables are the fp32
    codec's, from the process' cache: the hyperlatent density is float32
    in either dtype). Returns (round trip launches by kernel,
    batch launches, batch summary, round-trip summary)."""
    from hific_tpu_torch.codec import Codec
    from hific_tpu_torch.entropy import device_rans
    from hific_tpu_torch.entropy.container import load_compressed
    from hific_tpu_torch.ops import fused_norm

    t0 = time.perf_counter()
    codec = Codec(config.replace(dtype="bfloat16"), state, device="cuda")
    codec.build_tables()
    bf16 = {n for n, p in codec.model.named_parameters()
            if p.dtype == torch.bfloat16}
    if bf16 != transposed_leaves(codec.model):
        raise AssertionError(f"bf16 codec: bf16 parameters {sorted(bf16)}")
    log(f"bf16 codec built with its tables in {time.perf_counter() - t0:.1f}"
        f" s; {len(bf16)} bf16 parameter tensors (the transposed convs')")
    x = smooth_image(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bf16.hfc")
        zero_kernel_counts()
        relaunched = codec.device_relaunches
        torch.cuda.synchronize()
        (actual_bpp, _), enc_ms = timed(lambda: codec.compress_file(x, path))
        recon, dec_ms = timed(lambda: codec.decompress_file(path,
                                                            as_uint8=True))
        counts = kernel_counts()
        norm_dtypes = by_dtype(fused_norm.KERNEL.by_dtype)
        relaunched = codec.device_relaunches - relaunched
        out = load_compressed(path)
        z_enc, y_enc, *_ = codec.encode_symbols(x)
        z_dec, y_dec, _ = codec.decode_symbols(out)
        warm = [(timed(lambda: codec.compress_file(x, path))[1],
                 timed(lambda: codec.decompress_file(path, as_uint8=True))[1])
                for _ in range(3)]
    n = len(main_path_norm_shapes(config, IMAGE_H, IMAGE_W))
    if counts[0] != n or norm_dtypes != {"float32": 1, "bfloat16": n - 1}:
        raise AssertionError(f"bf16 round trip: {counts[0]} norm launches "
                             f"by dtype {norm_dtypes}; expected {n}, norm_in "
                             f"float32 and the rest bfloat16")
    if counts[1:] != (1 + relaunched, 1):
        raise AssertionError(f"bf16 round trip: {counts[1:]} rans_encode/"
                             f"rans_decode launches; expected "
                             f"({1 + relaunched}, 1)")
    if not (np.array_equal(z_enc, z_dec) and np.array_equal(y_enc, y_dec)):
        raise AssertionError("bf16: decoded symbols differ from the encoded")
    if recon.shape != x.shape or recon.dtype != np.uint8:
        raise AssertionError(f"bf16 reconstruction {recon.shape} "
                             f"{recon.dtype}")
    enc_warm = float(np.median([w[0] for w in warm]))
    dec_warm = float(np.median([w[1] for w in warm]))
    log(f"bf16 round trip {IMAGE_W}x{IMAGE_H}: norm launches {norm_dtypes}, "
        f"rans_encode {counts[1]} ({relaunched} past the caps), rans_decode "
        f"{counts[2]}; symbols equal; {actual_bpp:.4f} bpp; first "
        f"compress_file {enc_ms:.1f} ms, decompress_file {dec_ms:.1f} ms; "
        f"warm (median of 3) {enc_warm:.1f} and {dec_warm:.1f} ms ({card})")
    tf32 = tf32_named_kernels(codec, x)
    entry_counts, entry_dtypes, entry = bf16_entry_points(codec, config,
                                                          state, card)
    (enc_launches, dec_launches), _, batch = batch_path(codec, card,
                                                        small_images=True)
    del codec
    torch.cuda.empty_cache()
    return (counts, (enc_launches, dec_launches), batch,
            {"compress_file_ms": enc_warm, "decompress_file_ms": dec_warm,
             "norm_launches_by_dtype": norm_dtypes,
             "entry_counts": entry_counts,
             "entry_norm_launches_by_dtype": entry_dtypes,
             "entry_points": entry, "tf32_named_kernels": tf32})


def bf16_entry_points(codec, config, state, card: str):
    """The compress and decompress CLIs and the serving daemon on a params
    `.npz` whose config says bfloat16, as a user runs them on the
    artifact: one 768x512 PNG through `cli.compress.main` and
    `cli.decompress.main`, then SERVE_CLIENTS clients POSTing one image
    each to /compress and the bodies to /decompress. Gates: every `.hfc`
    carries the bfloat16 prefix and equals the bytes of `codec` (the bf16
    codec of the same weights) with the host coder, every decoded image
    `codec`'s pixels, the norm kernel launched on bfloat16 inputs and each
    rANS kernel launched. Returns ((norm, rans_encode, rans_decode)
    launches, norm launches by dtype, summary)."""
    import threading
    import urllib.request

    from hific_tpu_torch.cli import compress as compress_cli
    from hific_tpu_torch.cli import decompress as decompress_cli
    from hific_tpu_torch.entropy.container import (BF16_MAGIC,
                                                   dumps_compressed,
                                                   load_compressed,
                                                   loads_compressed)
    from hific_tpu_torch.ops import fused_norm
    from hific_tpu_torch.utils.image_io import (decode_image, encode_png,
                                                read_image, write_png)

    def check_body(body: bytes, x, what: str) -> None:
        if not body.startswith(BF16_MAGIC) or body != dumps_compressed(
                codec.compress(x, device_encode=False))[0]:
            raise AssertionError(f"bf16 {what}: the .hfc is not the bf16 "
                                 f"codec's host-coder bytes with the bf16 "
                                 f"prefix")

    with tempfile.TemporaryDirectory() as tmp:
        npz = params_npz(state, config.replace(dtype="bfloat16"), tmp)
        src, enc, dec = (os.path.join(tmp, d)
                         for d in ("images", "hfc", "decoded"))
        os.makedirs(src)
        x = smooth_image(300)
        write_png(os.path.join(src, "img.png"), x[0])
        zero_kernel_counts()
        t0 = time.perf_counter()
        rows = compress_cli.main(["-ckpt", npz, "-i", src, "-o", enc])
        (png,) = decompress_cli.main(["-ckpt", npz, "-i", enc, "-o", dec])
        t_cli = time.perf_counter() - t0
        with open(os.path.join(enc, "img.hfc"), "rb") as f:
            check_body(f.read(), x, "CLI")
        want = codec.decompress(load_compressed(os.path.join(enc, "img.hfc")),
                                as_uint8=True)[0]
        if not np.array_equal(read_image(png), want):
            raise AssertionError("bf16 CLI: the decoded PNG is not the bf16 "
                                 "codec's pixels")
        server = build_server(npz)
    try:
        if server.service.codec.config.dtype != "bfloat16":
            raise AssertionError("the server on a bf16 .npz is not bf16")
        base = "http://%s:%d" % server.server_address[:2]
        images = [smooth_image(310 + i) for i in range(SERVE_CLIENTS)]
        bodies, pngs, errors = ([None] * SERVE_CLIENTS,
                                [None] * SERVE_CLIENTS, [])

        def post(path, body):
            req = urllib.request.Request(base + path, data=body,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.read()

        def client(i, leg):
            try:
                if leg == "compress":
                    bodies[i] = post("/compress", encode_png(images[i][0]))
                else:
                    pngs[i] = post("/decompress", bodies[i])
            except Exception as e:  # noqa: BLE001 -- raised below
                errors.append(e)

        t0 = time.perf_counter()
        for leg in ("compress", "decompress"):
            threads = [threading.Thread(target=client, args=(i, leg))
                       for i in range(SERVE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            if errors or any(t.is_alive() for t in threads):
                raise AssertionError(f"bf16 serve clients failed: {errors}")
        t_serve = time.perf_counter() - t0
        counts = kernel_counts()
        norm_dtypes = by_dtype(fused_norm.KERNEL.by_dtype)
        for i, x in enumerate(images):
            check_body(bodies[i], x, f"serve request {i}")
            if not np.array_equal(
                    decode_image(pngs[i]),
                    codec.decompress(loads_compressed(bodies[i]),
                                     as_uint8=True)[0]):
                raise AssertionError(f"bf16 serve request {i}: the PNG is "
                                     f"not the bf16 codec's pixels")
    finally:
        server.shutdown()
        server.server_close()
    if min(counts) == 0 or not norm_dtypes.get("bfloat16"):
        raise AssertionError(f"bf16 CLI and serve: launches (norm, "
                             f"rans_encode, rans_decode) {counts}, norm by "
                             f"dtype {norm_dtypes}")
    log(f"bf16 CLIs (compress, decompress one {IMAGE_W}x{IMAGE_H} PNG) in "
        f"{t_cli:.1f} s, PSNR {rows[0]['psnr']:.2f} dB; bf16 server: "
        f"{SERVE_CLIENTS} clients, one /compress and one /decompress each, "
        f"in {t_serve:.2f} s; every .hfc the bf16 codec's bytes with the "
        f"bf16 prefix, every image its pixels; launches norm {counts[0]} "
        f"{norm_dtypes}, rans_encode {counts[1]}, rans_decode {counts[2]} "
        f"({card})")
    return counts, norm_dtypes, {"cli_s": t_cli, "serve_s": t_serve,
                                 "psnr": rows[0]["psnr"]}


# A layer computing in float32 on the codec's path holds a float64
# computation of it within this share of its largest |output|: fp32
# products and sums leave ~1e-6 there, TF32's 10-bit inputs ~1e-3. A
# layer computing in bfloat16 (whose operands TF32's 10-bit mantissa holds
# exactly) holds the float64 result rounded to bfloat16 within one ulp,
# plus 2**-20 of its largest |output| for the fp32 sums near 0.
TF32_FREE_REL = 2.0 ** -14


def tf32_named_kernels(codec, x) -> dict:
    """The layers of `codec` that launch a kernel with "tf32" in its name
    in one compress + decompress of x: each leaf module runs inside a
    `record_function` range that names it, its input dtype and cuDNN's
    TF32 flag at the call, and each such kernel's launching op is walked up
    to its range. For each such layer, how far its output on its captured
    input, under the codec's numerics, lies from a float64 computation of
    the same layer in its compute dtype, of its largest |output|; a layer
    computing in float32 must stay within TF32_FREE_REL, one computing in
    bfloat16 within one bf16 ulp (+ 2**-20 of its largest |output|) of the
    float64 result rounded to bfloat16."""
    import copy

    from torch.autograd.profiler import record_function

    from hific_tpu_torch.models.layers import Conv, ConvTranspose
    from hific_tpu_torch.runtime import fp32_numerics

    leaves = {n: m for n, m in codec.model.named_modules()
              if n and not list(m.children())}
    ranges, inputs, handles = [], {}, []

    def pre(name):
        def fn(module, args):
            t = args[0] if args and torch.is_tensor(args[0]) else None
            dtype = str(t.dtype).replace("torch.", "") if t is not None else ""
            ranges.append(record_function(
                f"layer:{name}:{dtype}:tf32="
                f"{torch.backends.cudnn.allow_tf32}"))
            ranges[-1].__enter__()
            inputs.setdefault(name, args)
        return fn

    def post(module, args, out):
        ranges.pop().__exit__(None, None, None)

    for n, m in leaves.items():
        handles += [m.register_forward_pre_hook(pre(n)),
                    m.register_forward_hook(post)]
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            codec.decompress(codec.compress(x), as_uint8=True)
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    found = {}
    for evt in prof.events():
        for k in getattr(evt, "kernels", []):
            if "tf32" not in k.name:
                continue
            p = evt
            while p is not None and not p.name.startswith("layer:"):
                p = p.cpu_parent
            tag = p.name if p is not None else f"layer:?({evt.name})::"
            found.setdefault(tag, {"kernels": set(), "ops": set()})
            found[tag]["kernels"].add(k.name)
            found[tag]["ops"].add(evt.name)
    report = {}
    for tag, seen in found.items():
        name = tag.split(":")[1]
        entry = {"kernels": sorted(seen["kernels"]),
                 "ops": sorted(seen["ops"]), "range": tag}
        module, args = leaves.get(name), inputs.get(name)
        if isinstance(module, (Conv, ConvTranspose)) and args is not None:
            xin = args[0]
            compute = (xin.dtype if isinstance(module, ConvTranspose)
                       else module.dtype or torch.promote_types(
                           xin.dtype, module.weight.dtype))
            ref = copy.deepcopy(module)
            with torch.no_grad():
                for p in ref.parameters():
                    p.data = p.data.to(compute).double()
            ref.dtype = None
            with fp32_numerics(deterministic=True), torch.inference_mode():
                got = module(*args).double()
                want = ref(xin.to(compute).double())
            rel = float((got - want).abs().max() / want.abs().max())
            entry.update(compute_dtype=str(compute).replace("torch.", ""),
                         rel_err_vs_float64=rel)
            if compute == torch.float32 and rel > TF32_FREE_REL:
                raise AssertionError(
                    f"{name} computes in float32 on the codec's path but "
                    f"lies {rel:.2e} of its largest output from float64 "
                    f"(limit {TF32_FREE_REL:.1e}): TF32 truncation ({entry})")
            if compute == torch.bfloat16:
                rounded = want.to(torch.bfloat16).double()
                limit = (bf16_ulp(rounded.float()).double()
                         + 2.0 ** -20 * want.abs().max())
                share = float(((got - rounded).abs() / limit).max())
                entry["share_of_bf16_limit"] = share
                if share > 1.0:
                    raise AssertionError(
                        f"{name} computes in bfloat16 but lies {share:.2f} "
                        f"of one bf16 ulp (+ 2**-20 of its largest output) "
                        f"from float64 rounded to bfloat16 ({entry})")
        report[name] = entry
    log(f"kernels named tf32 in a bf16 round trip, by layer: "
        f"{json.dumps(report) if report else 'none'}")
    return report


def write_tiles(directory: str, seed: int) -> str:
    """BF16_TILES seeded smooth BF16_TILE-square PNGs (the device corpus)."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, BF16_TILE),
                         np.linspace(0, 1, BF16_TILE), indexing="ij")
    for i in range(BF16_TILES):
        img = np.stack([0.5 + 0.3 * np.sin(2 * np.pi * (
            rng.uniform(0.5, 6) * yy + rng.uniform(0.5, 6) * xx)
            + rng.uniform(0, 2 * np.pi)) for _ in range(3)], -1)
        img += rng.normal(0, 0.03, img.shape)
        Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
                        ).save(os.path.join(directory, f"tile_{i:02d}.png"))
    return directory


def read_trace(directory: str) -> dict:
    """The trainer's --profile_dir trace: per step (5 in the window) the
    norm kernels by input dtype, the host-to-device copies and their bytes,
    and the device busy share of the window."""
    (name,) = [n for n in os.listdir(directory) if n.endswith(".json")]
    with open(os.path.join(directory, name)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    norms = {}
    for e in kernels:
        for kind, keys in (("forward", ("channel_norm_kernel",
                                        "channel_norm_rows_kernel")),
                           ("backward", ("channel_norm_bwd_kernel",))):
            if any(key in e["name"] for key in keys):
                dtype = "bfloat16" if "bfloat16" in e["name"] else "float32"
                norms[(kind, dtype)] = norms.get((kind, dtype), 0) + 1
    htod = [e for e in events if e.get("cat") == "gpu_memcpy"
            and "HtoD" in e["name"]]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e.get("dur", 0) for e in events)
    steps = 5
    return {
        "trace": name,
        "norm_launches_per_step": {f"{k}/{d}": v / steps
                                   for (k, d), v in sorted(norms.items())},
        "htod_copies_per_step": len(htod) / steps,
        "htod_bytes": [e.get("args", {}).get("bytes") for e in htod],
        "busy_share": sum(e["dur"] for e in kernels) / max(end - start, 1),
        "window_ms": (end - start) / 1e3,
    }


def train_bf16_flagship(card: str, n_norms: int, n_res: int, exp_dir: str):
    """`python -m hific_tpu_torch.cli.train -mt compression --dtype bfloat16
    --use_remat --device_data --profile_dir <tmp> --steps 16`, in-process,
    at the flagship's widths, batch 8 of 256x256 crops drawn on the card
    from seeded tiles. Each step: finite loss; a nonzero gradient for every
    codec parameter; the transposed convs' parameters and Adam moments
    bf16, the rest fp32; the norm kernels launched with bf16 inputs, 29 +
    2 x n_res forward (the residual blocks' norms again in the recompute)
    and 29 backward. The trace exists and shows the same per step; no
    host-to-device copy of a batch's size during the window. Then the
    forward and backward, and a whole step, with and without remat on the
    same state and batch: the forward and backward's peak must be lower
    with remat. Returns (launches, summary)."""
    from hific_tpu_torch.cli import train as train_cli
    from hific_tpu_torch.ops import fused_norm
    from hific_tpu_torch.runtime import fp32_numerics
    from hific_tpu_torch.training.data import DeviceDataset
    from hific_tpu_torch.training.losses import compression_loss
    from hific_tpu_torch.training.train_step import (ingest_batch,
                                                     make_train_step_g)

    tiles = write_tiles(os.path.join(exp_dir, "tiles"), SEED + 7)
    prof = os.path.join(exp_dir, "profile")
    steps, transposed = [], None
    fwd_want = {torch.bfloat16: n_norms + 2 * n_res}
    bwd_want = {torch.bfloat16: n_norms}

    def on_step(state, diag):
        # One host wait a step, so that the profiled window's busy share is
        # the steps'.
        nonlocal transposed
        torch.cuda.synchronize()
        now = time.perf_counter()
        if transposed is None:
            transposed = transposed_leaves(state.model)
        params = list(state.model.named_parameters())
        for n, p in params:
            want = torch.bfloat16 if n in transposed else torch.float32
            moments = state.optimizer.state[p]
            if not (p.dtype == moments["exp_avg"].dtype
                    == moments["exp_avg_sq"].dtype == want):
                raise AssertionError(f"bf16 step {state.step}: {n} is "
                                     f"{p.dtype}, its moments "
                                     f"{moments['exp_avg'].dtype}; want "
                                     f"{want}")
            if p.grad is None:
                raise AssertionError(f"bf16 step {state.step}: no gradient "
                                     f"for {n}")
        live = torch.stack([p.grad.ne(0).any() for _, p in params]).cpu()
        loss = float(diag["weighted_compression_loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"bf16 step {state.step}: loss {loss}")
        if not bool(live.all()):
            dead = [n for (n, _), ok in zip(params, live) if not ok]
            raise AssertionError(f"bf16 step {state.step}: a zero gradient "
                                 f"for {dead}")
        counts = (dict(fused_norm.KERNEL.by_dtype),
                  dict(fused_norm.BACKWARD_KERNEL.by_dtype))
        fused_norm.KERNEL.by_dtype.clear()
        fused_norm.BACKWARD_KERNEL.by_dtype.clear()
        if counts != (fwd_want, bwd_want):
            raise AssertionError(f"bf16 step {state.step}: norm launches by "
                                 f"dtype {counts}; expected "
                                 f"{(fwd_want, bwd_want)}")
        steps.append((now, time.perf_counter(), loss, float(diag["q_rate"])))

    args = train_cli.parse_args([
        "-mt", "compression", "--dtype", "bfloat16", "--use_remat",
        "--device_data", "--profile_dir", prof, "--steps", str(BF16_STEPS),
        "-d", tiles, "-bs", str(TRAIN_BATCH), "-crop", str(TRAIN_CROP),
        "--uncalibrated_lpips_ok", "--device", "cuda", "--seed", str(SEED),
        "--log_interval", "1000", "--save_interval", "1000",
        "--experiments_dir", exp_dir])
    zero_kernel_counts()
    fused_norm.BACKWARD_KERNEL.launches = 0
    for k in (fused_norm.KERNEL, fused_norm.BACKWARD_KERNEL):
        k.by_dtype.clear()
    t0 = time.perf_counter()
    state = train_cli.run(args, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (fused_norm.KERNEL.launches,
                fused_norm.BACKWARD_KERNEL.launches)
    if len(steps) != BF16_STEPS or launches != (
            BF16_STEPS * fwd_want[torch.bfloat16],
            BF16_STEPS * bwd_want[torch.bfloat16]):
        raise AssertionError(f"bf16 trainer: {len(steps)} steps, launches "
                             f"{launches}")
    trace = read_trace(prof)
    want = {"backward/bfloat16": float(n_norms),
            "forward/bfloat16": float(n_norms + 2 * n_res)}
    if trace["norm_launches_per_step"] != want:
        raise AssertionError(f"profiled bf16 steps: norm kernels per step "
                             f"{trace['norm_launches_per_step']}; expected "
                             f"{want}")
    batch_bytes = TRAIN_BATCH * TRAIN_CROP * TRAIN_CROP * 3
    big = [b for b in trace["htod_bytes"] if b is None or b >= batch_bytes]
    if big:
        raise AssertionError(f"profiled bf16 steps with --device_data: "
                             f"host-to-device copies of {big} bytes (a batch "
                             f"is {batch_bytes})")
    times = [b[0] - a[1] for a, b in zip(steps, steps[1:])]
    # times[k] is step k + 2's: warm, before the profiler, steps 3-10.
    warm_ms = 1e3 * float(np.median(times[1:9]))
    profiled_ms = 1e3 * float(np.median(times[9:14]))

    # Peak device memory with and without remat, same state and batch (the
    # model, its Adam state and the corpus resident in both): of the
    # forward and backward, where remat acts, and of the whole step, whose
    # peak Adam's foreach temporaries may set.
    batch = next(DeviceDataset(tiles, TRAIN_CROP, TRAIN_BATCH, SEED,
                               "cuda").batches())[0]
    device = torch.device("cuda")
    lpips_fn = train_cli.make_lpips_fn(args, device)
    cfg = state.model.config

    def forward_backward():
        with fp32_numerics(deterministic=False):
            state.model.zero_grad(set_to_none=True)
            inter, _ = state.model(ingest_batch(batch, cfg, device),
                                   state.generator, training=True)
            compression_loss(cfg, inter, lpips_fn, state.step)[0].backward()

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, ms = timed(fn)
        return torch.cuda.max_memory_allocated() / 2 ** 30, ms

    peaks = {}
    for remat in (False, True, False, True):
        state.model.generator.use_remat = remat
        step_fn = make_train_step_g(cfg.replace(use_remat=remat), lpips_fn)
        peaks[remat] = (peak_of(forward_backward),
                        peak_of(lambda: step_fn(state, batch)))
    state.model.generator.use_remat = True
    (fb_remat, _), (step_remat, ms_remat) = peaks[True]
    (fb_plain, _), (step_plain, ms_plain) = peaks[False]
    if not fb_remat < fb_plain:
        raise AssertionError(f"bf16 forward + backward peak with remat "
                             f"{fb_remat:.3f} GiB not below without "
                             f"{fb_plain:.3f} GiB")
    summary = {
        "warm_step_ms": warm_ms,
        "profiled_step_ms": profiled_ms,
        "step_ms": [1e3 * t for t in times],
        "trainer_wall_s": wall,
        "device_busy_share": trace["busy_share"],
        "profiled_window_ms": trace["window_ms"],
        "norm_launches_per_profiled_step": trace["norm_launches_per_step"],
        "htod_copies_per_step": trace["htod_copies_per_step"],
        "fwd_bwd_peak_gib_remat": fb_remat,
        "fwd_bwd_peak_gib_no_remat": fb_plain,
        "step_peak_gib_remat": step_remat,
        "step_peak_gib_no_remat": step_plain,
        "step_ms_remat": ms_remat,
        "step_ms_no_remat": ms_plain,
    }
    for i, (_, _, loss, q) in enumerate(steps):
        if i in (0, BF16_STEPS - 1):
            log(f"bf16 train step {i + 1}: loss {loss:.4f}, q_bpp {q:.4f}")
    log(f"bf16 trainer ({BF16_STEPS} flagship steps, bs {TRAIN_BATCH}, "
        f"{TRAIN_CROP}x{TRAIN_CROP}, remat, device data, profiler on steps "
        f"11-15) in {wall:.1f} s; warm step {warm_ms:.1f} ms (median of "
        f"steps 3-10, host clock after synchronize; steps 11-15 under the "
        f"profiler {profiled_ms:.1f} ms); trace "
        f"{trace['trace']}: busy {trace['busy_share']:.0%} of "
        f"{trace['window_ms']:.1f} ms, norm kernels per step "
        f"{trace['norm_launches_per_step']}, host-to-device copies per step "
        f"{trace['htod_copies_per_step']:g} (bytes {trace['htod_bytes'][:8]})"
        f"; peak of the forward and backward {fb_remat:.3f} GiB with remat, "
        f"{fb_plain:.3f} GiB without; of the whole step {step_remat:.3f} "
        f"and {step_plain:.3f} GiB ({ms_remat:.1f} vs {ms_plain:.1f} ms) "
        f"({card})")
    return launches, summary


# Phase 12: multi-GPU on the one card.
SPATIAL_BANDS, SPATIAL_H, SPATIAL_W = 4, 2048, 3072  # H a multiple of 4 * 16
DP_CLI_STEPS = 2  # the data-parallel trainer CLI's steps
DDP_WORLDS = ((1, "cuda", "nccl"), (2, "cuda:0", "gloo"))


def ddp_ranks(world: int, device: str, backend: str, ckpt: str,
              config_json: str, batches, workdir: str):
    """`world` spawned ranks of the library's G step under DDP, each from
    the checkpoint `ckpt`, on its rows of each global batch (the second
    step timed warm); rank 0 returns the first step's gradients."""
    from hific_tpu_torch.parallel.dryrun import spawn, train_rank

    job = {"config": config_json, "device": device, "backend": backend,
           "checkpoint": ckpt, "lpips": {"seed": SEED},
           "steps": [("G", x) for x in batches], "grads": [0],
           "deterministic": [0]}
    ranks = [r[0] for r in spawn(
        train_rank, world, job, workdir=os.path.join(workdir, f"ddp{world}"))]
    log(f"DDP world {world} ({backend}) ranks done")
    return ranks


def start_dp_cli(exp_dir: str, tiles: str):
    """`python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    hific_tpu_torch.cli.train --data_parallel -mt compression` at the
    flagship's widths for DP_CLI_STEPS steps (batch 8 of 256x256 crops of
    the seeded tiles), started in the background: (process, log file)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "hific_tpu_torch.cli.train",
           "--data_parallel", "-mt", "compression", "-d", tiles,
           "--steps", str(DP_CLI_STEPS), "-bs", str(TRAIN_BATCH),
           "-crop", str(TRAIN_CROP), "--uncalibrated_lpips_ok",
           "--seed", str(SEED), "--log_interval", "1000",
           "--save_interval", "1000", "--experiments_dir", exp_dir]
    return start_logged(cmd, os.path.join(exp_dir, "dp_cli.log"))


def start_logged(cmd, log_path: str):
    """`cmd` started in the background from this checkout's root, its
    output to `log_path`: (process, log file)."""
    log_file = open(log_path, "w")
    proc = subprocess.Popen(
        cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=log_file, stderr=subprocess.STDOUT)
    return proc, log_file


def finish_logged(proc, log_file, what: str, timeout: float = 600) -> None:
    """Wait for a `start_logged` process (killed past `timeout`); raise
    with its log's end where it exited non-zero."""
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_file.close()
    with open(log_file.name) as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}:\n{text[-4000:]}")


def single_steps(ckpt: str, batches):
    """The in-process single G steps from `ckpt` on the same global
    batches, the first under deterministic algorithms as the ranks' first:
    (first step's loss, its gradients on the host, the second step's ms)."""
    from hific_tpu_torch.parallel.dryrun import deterministic_algorithms
    from hific_tpu_torch.cli import train as train_cli
    from hific_tpu_torch.training import checkpoints
    from hific_tpu_torch.training.train_step import make_train_step_g

    config = checkpoints.load_config(os.path.dirname(ckpt))
    state = checkpoints.restore_train_state(ckpt, config, "cuda")
    args = train_cli.parse_args(["--uncalibrated_lpips_ok", "--seed",
                                 str(SEED)])
    step = make_train_step_g(config, train_cli.make_lpips_fn(
        args, torch.device("cuda")))
    with deterministic_algorithms():
        diag = step(state, batches[0])
    loss = float(diag["weighted_compression_loss"])
    grads = {n: p.grad.detach().cpu() for n, p in
             state.model.named_parameters()}
    _, ms = timed(lambda: step(state, batches[1]))
    return loss, grads, ms


def spatial_path(config, weights, card: str):
    """A seeded 2048x3072 image through compress_spatial /
    decompress_spatial over SPATIAL_BANDS bands on cuda:0 beside compress
    / decompress: the `.hfc` bytes equal, 0 y and 0 z symbols differing
    (a nonzero count is a fault), the pixels within one level, a 16-pixel
    halo's bytes different; each rANS kernel once a call (once more for an
    encode past the default caps); each leg's time and peak device memory.
    Returns ((norm, rans_encode, rans_decode) launches, summary)."""
    from hific_tpu_torch.codec import Codec
    from hific_tpu_torch.parallel.mesh import make_mesh

    codec = Codec(config, weights, device="cuda")
    codec.build_tables()
    mesh = make_mesh(["cuda:0"] * SPATIAL_BANDS)
    x = bench_image(8, SPATIAL_H, SPATIAL_W)
    # Each leg once first: cuDNN picks its algorithms for new shapes.
    warm = codec.compress(x)
    codec.compress_spatial(x, mesh)
    codec.decompress(warm, as_uint8=True)
    codec.decompress_spatial(warm, mesh, as_uint8=True)
    legs, peaks, launches, totals = {}, {}, {}, [0, 0, 0]
    relaunched = [codec.device_relaunches]

    def leg(name, fn, rans):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_counts()
        out, legs[name] = timed(fn)
        peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        launches[name] = counts = kernel_counts()
        extra = codec.device_relaunches - relaunched[0]
        relaunched[0] = codec.device_relaunches
        want = (rans[0] + (extra if rans[0] else 0), rans[1])
        if counts[0] == 0 or counts[1:] != want:
            raise AssertionError(f"spatial leg {name}: launches (norm, "
                                 f"rans_encode, rans_decode) {counts}, "
                                 f"expected (>0, {want[0]}, {want[1]})")
        for i, c in enumerate(counts):
            totals[i] += c
        return out

    whole = leg("compress", lambda: codec.compress(x), (1, 0))
    split = leg("compress_spatial", lambda: codec.compress_spatial(x, mesh),
                (1, 0))
    r_whole = leg("decompress", lambda: codec.decompress(
        whole, as_uint8=True), (0, 1))
    r_split = leg("decompress_spatial", lambda: codec.decompress_spatial(
        split, mesh, as_uint8=True), (0, 1))
    fn, replicas = codec._spatial(mesh, "encode", 64)
    x_in = codec._model_input(x)
    enc_whole = codec._symbols(x_in)
    enc_split = codec._symbols(x_in, lambda t: fn(replicas, t))
    y_diff = int((enc_whole[1] != enc_split[1]).sum())
    z_diff = int((enc_whole[0] != enc_split[0]).sum())
    same_bytes = bool(
        np.array_equal(whole.latents_encoded, split.latents_encoded)
        and np.array_equal(whole.hyperlatents_encoded,
                           split.hyperlatents_encoded))
    pixel = int(np.abs(r_whole.astype(int) - r_split.astype(int)).max())
    short = codec.compress_spatial(x, mesh, halo_image=16)
    short_differs = not np.array_equal(short.latents_encoded,
                                       whole.latents_encoded)
    if not (same_bytes and y_diff == 0 and z_diff == 0 and pixel <= 1
            and short_differs and r_split.shape == x.shape):
        raise AssertionError(
            f"spatial codec {SPATIAL_W}x{SPATIAL_H} over {SPATIAL_BANDS} "
            f"bands: bytes equal {same_bytes}, {y_diff} y and {z_diff} z "
            f"symbols differ, largest pixel difference {pixel}, a 16-pixel "
            f"halo's bytes differ {short_differs}, shape {r_split.shape}")
    summary = {"shape": [SPATIAL_H, SPATIAL_W], "bands": SPATIAL_BANDS,
               "bpp": whole.total_bpp, "hfc_bytes_equal": same_bytes,
               "y_symbols_differ": y_diff, "y_symbols": int(enc_whole[1].size),
               "z_symbols_differ": z_diff, "z_symbols": int(enc_whole[0].size),
               "max_pixel_diff": pixel, "halo16_bytes_differ": short_differs,
               "ms": legs, "peak_gib": peaks, "launches": launches}
    log(f"spatial codec {SPATIAL_W}x{SPATIAL_H} ({whole.total_bpp:.4f} bpp) "
        f"over {SPATIAL_BANDS} bands on cuda:0: .hfc bytes equal to "
        f"compress's, {y_diff} of {enc_whole[1].size} y and {z_diff} of "
        f"{enc_whole[0].size} z symbols differ, largest pixel difference "
        f"{pixel}, a 16-pixel halo's bytes differ; legs: " + "; ".join(
            f"{k} {legs[k]:.1f} ms, peak {peaks[k]:.2f} GiB, launches "
            f"{launches[k]}" for k in legs)
        + f" (host clock after synchronize; max_memory_allocated; {card})")
    del codec
    torch.cuda.empty_cache()
    return tuple(totals), summary


def multi_gpu_path(card: str, config, weights, ckpt: str, exp_dir: str,
                   n_norms: int):
    """Phase 12. (a) one G step from phase 8's checkpoint under DDP, at
    world 1 under NCCL and at world 2 ranks sharing cuda:0 under gloo,
    against the in-process single step on the same global batch and noise
    (loss within 1e-4, every gradient leaf within 1e-3 of its largest), 29
    forward and 29 backward norm launches a rank's step, and a second step
    timed; (b) the trainer CLI under torch.distributed.run with
    --data_parallel, whose checkpoint restores in the single-process
    trainer; (c) dryrun_multichip(2) on the card; (d) the partitioned codec
    (`spatial_path`). The ranks and the CLI start first and run beside the
    parent's single steps, (d) and (c): their times share the card and
    the host. Returns (norm forward launches by path, backward, rANS
    (encode, decode), summary)."""
    from hific_tpu_torch.training import checkpoints

    t0 = time.perf_counter()
    tiles = write_tiles(os.path.join(exp_dir, "dp_tiles"), SEED + 9)
    crops = train_crops(SEED + 2)
    batches = [next(crops)[0] for _ in range(2)]
    config_json = checkpoints.load_config(os.path.dirname(ckpt)).to_json()
    cli_dir = os.path.join(exp_dir, "dp_cli")
    os.makedirs(cli_dir)
    dry_json = os.path.join(exp_dir, "dryrun.json")
    procs = [start_dp_cli(cli_dir, tiles),
             start_logged([sys.executable, "-m",
                           "hific_tpu_torch.parallel.dryrun", "2",
                           "--json", dry_json],
                          os.path.join(exp_dir, "dryrun.log"))]
    pool = concurrent.futures.ThreadPoolExecutor(len(DDP_WORLDS))
    try:
        jobs = {world: pool.submit(ddp_ranks, world, device, backend, ckpt,
                                   config_json, batches, exp_dir)
                for world, device, backend in DDP_WORLDS}
        loss, grads, single_ms = single_steps(ckpt, batches)
        log("single steps done")
        spatial_counts, spatial = spatial_path(config, weights, card)
        ranks = {world: job.result() for world, job in jobs.items()}
    finally:
        pool.shutdown()
        for (proc, log_file), what in zip(
                procs, ("torch.distributed.run trainer",
                        "dryrun_multichip(2)")):
            finish_logged(proc, log_file, what)
    log("DP trainer CLI and dryrun_multichip(2) done")
    with open(dry_json) as f:
        dry = json.load(f)
    ckpt_dir = os.path.join(cli_dir, "hific_tpu_torch_v0.1_compression_low",
                            "checkpoints")
    cli_ckpt = checkpoints.latest_checkpoint(ckpt_dir)
    cli_config = checkpoints.load_config(ckpt_dir)
    restored = checkpoints.restore_train_state(cli_ckpt, cli_config, "cuda")
    keys = list(restored.model.state_dict())
    if restored.step != DP_CLI_STEPS or any(k.startswith("module.")
                                            for k in keys):
        raise AssertionError(f"DP trainer checkpoint {cli_ckpt}: step "
                             f"{restored.step}, keys {keys[:3]}")
    del restored
    torch.cuda.empty_cache()

    summary = {"single_step_ms": single_ms, "worlds": {}}
    fwd = bwd = 0
    for world, rs in ranks.items():
        got = rs[0]
        loss_rel = abs(got["diagnostics"][0]["weighted_compression_loss"]
                       - loss) / abs(loss)
        leaf_rel = sorted(((float((got["grads"][0][n] - g).abs().max()
                               / g.abs().max().clamp_min(1e-30)), n)
                           for n, g in grads.items()), reverse=True)
        grad_rel = leaf_rel[0][0]
        bad = [r["launches"] for r in rs
               if any(c != (n_norms, n_norms) for c in r["launches"])]
        agree = all(r["checksum"] == got["checksum"] for r in rs)
        if not (loss_rel <= 1e-4 and grad_rel <= 1e-3 and not bad and agree):
            raise AssertionError(
                f"DDP world {world} vs the single step: loss off by "
                f"{loss_rel:.2e}, worst gradient leaf {grad_rel:.2e} of its "
                f"largest ({leaf_rel[:4]}), launches {bad}, ranks agree "
                f"{agree}")
        fwd += sum(c[0] for r in rs for c in r["launches"])
        bwd += sum(c[1] for r in rs for c in r["launches"])
        summary["worlds"][world] = {
            "backend": DDP_WORLDS[world - 1][2], "loss_rel_diff": loss_rel,
            "worst_grad_leaf_rel": grad_rel,
            "step_ms": [r["ms"] for r in rs], "dp": got["dp"]}
        log(f"DDP world {world} ({DDP_WORLDS[world - 1][2]}, "
            f"{DDP_WORLDS[world - 1][1]}) vs the single step from phase 8's "
            f"checkpoint (batch {TRAIN_BATCH} of {TRAIN_CROP}x{TRAIN_CROP}, "
            f"fp32, TF32 off): loss rel diff {loss_rel:.2e} (limit 1e-4), "
            f"worst gradient leaf {grad_rel:.2e} of its largest (limit "
            f"1e-3); {n_norms} + {n_norms} norm launches a rank's step; step "
            f"ms per rank (first, warm) "
            + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in
                        (r["ms"] for r in rs))
            + f"; single warm step {single_ms:.1f} ms ({card})")
    summary.update(spatial=spatial, dryrun=dry,
                   cli={"steps": DP_CLI_STEPS, "checkpoint":
                        os.path.basename(cli_ckpt)},
                   wall_s=time.perf_counter() - t0)
    log(f"DP trainer CLI under torch.distributed.run: {DP_CLI_STEPS} steps, "
        f"{os.path.basename(cli_ckpt)} restored in the single-process "
        f"trainer; dryrun_multichip(2) on the card: {dry}")
    log(f"multi-GPU phase {summary['wall_s']:.1f} s ({card})")
    dry_fwd = sum(dry["rank_norm_launches"])
    return ({"ddp_train_steps": fwd, "dryrun_ranks": dry_fwd,
             "spatial_codec": spatial_counts[0]}, bwd,
            spatial_counts[1:], summary)


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

    # Phases 3-4: the norm kernels against their plain versions.
    config, state, source = load_weights(args.weights, SEED)
    shapes = main_path_norm_shapes(config, IMAGE_H, IMAGE_W)
    train_shapes = train_step_norm_shapes(config, TRAIN_BATCH, TRAIN_CROP)
    norm = check_norm_kernels(config, card)
    rt = norm["forward"]["round_trip_768x512"]
    step = norm["forward"]["train_step_b8_256"]
    bwd_summary = norm["backward"]

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
    log(s2d_crop_card_vs_cpu(codec, cpu, crop))
    log(vgg_lpips_card_vs_cpu())

    # Phase 6b: compress_many / decompress_many at bench.py's operating point.
    (enc_launches, dec_launches), batch_out, batch = batch_path(codec, card)
    # Phase 6c: the coding indices of one image, card against the CPU.
    flipped, n_idx = indices_card_vs_cpu(codec, cpu, batch_out)
    log(f"coding indices of a 1024x1024 image, card vs CPU synth_stats on "
        f"the same hyperlatents: {flipped} of {n_idx} differ (measured, not "
        f"gated)")
    print("batch path:", json.dumps(batch), flush=True)
    # Phase 6c': the host coders (container v2, the scalar coder,
    # wire_chunk) on the calibrated codec.
    host_coders = host_coders_path(codec, card)
    print("host coders:", json.dumps(host_coders), flush=True)

    # Phase 6d: a 6 MP image whole and on tiles.
    tile_counts, tiling = tiling_path(codec, card)
    print("tiling:", json.dumps(tiling), flush=True)

    # Phase 6e: the compress and decompress CLIs, compared with the served
    # codec before its calibration; phase 6f: the serving daemon under
    # concurrent clients.
    with tempfile.TemporaryDirectory() as tmp:
        npz = params_npz(state, config, tmp)
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

        # Phase 12: multi-GPU on the one card: DDP steps from phase 8's
        # checkpoint, the DP trainer CLI, dryrun_multichip(2) and the
        # partitioned codec.
        mg_fwd, mg_bwd, mg_rans, multi_gpu = multi_gpu_path(
            card, config, state, ckpt, train_dir, len(train_shapes))
    print("gan:", json.dumps(gan), flush=True)
    print("multi-GPU:", json.dumps(multi_gpu), flush=True)

    # Phase 11: this slice. The variants' tiny steps card vs CPU, then the
    # flagship in bf16: the codec round trip and batch codec, and the
    # trainer with remat, the corpus on the card and the profiler.
    for overrides, loss_tol, grad_tol in (
            ({"dtype": "bfloat16"}, 1e-3, BF16_GRAD_TOL),
            ({"use_channel_norm": False}, 1e-4, 1e-3),
            ({"sample_noise": True, "noise_dim": 4}, 1e-4, 1e-3),
            ({"use_latent_mixture_model": True, "latent_channels_dlmm": 8},
             1e-4, 1e-3)):
        log(tiny_variant_step_card_vs_cpu(overrides, loss_tol, grad_tol))
    bf16_rt, bf16_many, bf16_batch, bf16_codec = bf16_codec_path(
        config, state, card)
    print("bf16 batch path:", json.dumps(bf16_batch), flush=True)
    with tempfile.TemporaryDirectory() as train_dir:
        bf16_launches, bf16_train = train_bf16_flagship(
            card, len(train_shapes), config.n_residual_blocks, train_dir)
    print("bf16 train:", json.dumps(bf16_train), flush=True)

    # The chunked batch paths' launches (pipeline_chunk CHUNK), by path.
    chunk_norms = {}
    chunk_rans = {"rans_encode": {}, "rans_decode": {}}
    for prefix, summary in (("", batch), ("bf16_", bf16_batch)):
        calls = summary["chunked"]["bench"]
        path = f"{prefix}compress_decompress_many_chunk{CHUNK}"
        chunk_norms[path] = (calls["encode_launches"]["channel_norm"]
                             + calls["decode_launches"]["channel_norm"])
        for kernel, leg in (("rans_encode", "encode_launches"),
                            ("rans_decode", "decode_launches")):
            chunk_rans[kernel][path] = calls[leg][kernel]
    log(f"total wall time {time.perf_counter() - T_START:.1f} s ({card})")
    print(json.dumps({"kernels": [{
        "name": "channel_norm",
        "route": "cuda",
        "source": "hific_tpu_torch/csrc/channel_norm.cu",
        "replaces": "hific_tpu/ops/pallas_norm.py:49",
        "launches": (launches + fwd_launches + serve_counts[0]
                     + tile_counts[0] + cli_counts[0] + gan_fwd
                     + bf16_rt[0] + bf16_codec["entry_counts"][0]
                     + bf16_launches[0] + sum(mg_fwd.values())
                     + sum(chunk_norms.values())),
        "launches_by_path": {**chunk_norms,
                             "codec_round_trip": launches,
                             "serve": serve_counts[0],
                             "tiling": tile_counts[0],
                             "cli": cli_counts[0],
                             "train_steps": fwd_launches,
                             "gan_train_steps": gan_fwd,
                             "bf16_codec_round_trip": bf16_rt[0],
                             "bf16_cli_and_serve":
                                 bf16_codec["entry_counts"][0],
                             "bf16_train_steps": bf16_launches[0],
                             **mg_fwd},
        "dtypes": {"bf16_codec_round_trip":
                   bf16_codec["norm_launches_by_dtype"],
                   "bf16_cli_and_serve":
                   bf16_codec["entry_norm_launches_by_dtype"],
                   "bf16_train_steps": {"bfloat16": bf16_launches[0]},
                   "other_paths": "float32"},
        "bf16": {**rt["bfloat16"],
                 "train_step_ms": step["bfloat16"]["ms"],
                 "train_step_library_ms": step["bfloat16"]["library_ms"],
                 "train_step_bound_ms": step["bfloat16"]["bound_ms"]},
        "max_abs_err": rt["float32"]["max_abs_err"],
        "ms": rt["float32"]["ms"],
        "plain_ms": rt["float32"]["plain_ms"],
        "bound_ms": rt["float32"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": rt["float32"]["library_ms"],
        "library_call": "F.layer_norm(x.permute(0, 2, 3, 1), (C,), gamma * "
                        "sqrt((C-1)/C), beta, eps * (C-1)/C), without the "
                        "ReLU",
        "library_weight_dtype": {
            str(k).split(".")[-1]: str(v).split(".")[-1]
            for k, v in norm["weights"].items()},
        "train_step_ms": step["float32"]["ms"],
        "train_step_plain_ms": step["float32"]["plain_ms"],
        "train_step_library_ms": step["float32"]["library_ms"],
        "train_step_bound_ms": step["float32"]["bound_ms"],
        "sets": norm["forward"],
        "layout_rewrites_launches_per_image": {
            dtype: {name: summary["layout_rewrites"][name][
                "norm_launches_per_image"] for name in ("d2s", "s2d")}
            for dtype, summary in (("float32", batch),
                                   ("bfloat16", bf16_batch))},
        "empty_kernel_ms": norm["empty_kernel_ms"],
        "per_shape": norm["forward_rows"],
    }, {
        "name": "channel_norm_backward",
        "route": "cuda",
        "source": "hific_tpu_torch/csrc/channel_norm.cu",
        "replaces": "hific_tpu/ops/pallas_norm.py:74",
        "launches": bwd_launches + gan_bwd + bf16_launches[1] + mg_bwd,
        "launches_by_path": {"train_steps": bwd_launches,
                             "gan_train_steps": gan_bwd,
                             "bf16_train_steps": bf16_launches[1],
                             "ddp_train_steps": mg_bwd},
        "dtypes": {"bf16_train_steps": {"bfloat16": bf16_launches[1]},
                   "other_paths": "float32"},
        "bf16": bwd_summary["bf16"],
        "max_abs_err": bwd_summary["max_abs_err"],
        "ms": bwd_summary["ms"],
        "plain_ms": bwd_summary["plain_ms"],
        "bound_ms": bwd_summary["bound_ms"],
        "bound_by": "bytes",
        "library_ms": bwd_summary["library_ms"],
        "library_call": "torch.ops.aten.native_layer_norm_backward with the "
                        "forward's rescaled weight and eps, without the ReLU "
                        "mask",
        "per_shape": bwd_summary["per_shape"],
        "g_copies_per_step": train["copies_per_step"],
        "warm_train_step_ms": train["warm_ms"],
    }] + [rans_entry(name, rans_timed, rans_err[name], launches_by_path,
                     rans_batch)
          for name, launches_by_path in (
              ("rans_encode", {**chunk_rans["rans_encode"],
                               "codec_round_trip": rt_rans[0],
                               "compress_many": enc_launches,
                               "serve": serve_counts[1],
                               "tiling": tile_counts[1],
                               "cli": cli_counts[1],
                               "bf16_codec_round_trip": bf16_rt[1],
                               "bf16_cli_and_serve":
                                   bf16_codec["entry_counts"][1],
                               "bf16_compress_many": bf16_many[0],
                               "spatial_codec": mg_rans[0]}),
              ("rans_decode", {**chunk_rans["rans_decode"],
                               "codec_round_trip": rt_rans[1],
                               "decompress_many": dec_launches,
                               "serve": serve_counts[2],
                               "tiling": tile_counts[2],
                               "cli": cli_counts[2],
                               "bf16_codec_round_trip": bf16_rt[2],
                               "bf16_cli_and_serve":
                                   bf16_codec["entry_counts"][2],
                               "bf16_decompress_many": bf16_many[1],
                               "spatial_codec": mg_rans[1]}))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
