"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--weights artifacts/flagship_rd30k_f16.npz]

Drives the port's main path, the flagship codec round trip (image -> .hfc ->
image), through `hific_tpu_torch.codec.Codec`, and holds every kernel of
that path against its plain PyTorch version:

1. the card's name, power limit and count;
2. builds the kernels from the sources in this checkout (plain nvcc);
3. runs the ChannelNorm kernel at each of the path's 29 (M, C, act) shapes
   against its plain version (fp32 within 1e-5; bf16 within one ulp plus
   1e-5 at two shapes), with its time, the plain version's time and the
   memory bound;
4. loads the flagship weights (seeded random weights of the same
   configuration where the artifact is absent) and builds the codec and
   its tables;
5. compress_file -> .hfc -> decompress_file of a seeded smooth 768x512
   image: decoded symbols equal the encoded ones, the kernel ran exactly
   once per ChannelNorm (29 launches), and the card's encoder/generator
   agree with the plain CPU path on a 64x64 crop (within 1e-3);
6. prints the kernels' JSON line and, last, the device line.

Any failure exits non-zero; no phase catches an error. Needs one CUDA card.
"""

import argparse
import json
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


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def warm_round_trip(codec, x, card: str) -> None:
    """Steady-state legs of the round trip, their split between the device
    transforms and the host coder, and the device's kernels from
    torch.profiler over one more round trip."""
    from hific_tpu_torch.entropy.container import load_compressed

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "warm.hfc")
        _, enc_ms = timed(lambda: codec.compress_file(x, path))
        _, dec_ms = timed(lambda: codec.decompress_file(path, as_uint8=True))
        _, sym_ms = timed(lambda: codec.encode_symbols(x))
        out = load_compressed(path)
        _, dsym_ms = timed(lambda: codec.decode_symbols(out))
        log(f"warm round trip: compress_file {enc_ms:.1f} ms (device "
            f"transforms + symbol fetch {sym_ms:.1f} ms, host rANS + file "
            f"{enc_ms - sym_ms:.1f} ms); decompress_file {dec_ms:.1f} ms "
            f"(rANS + synth_stats {dsym_ms:.1f} ms, generator + image fetch "
            f"{dec_ms - dsym_ms:.1f} ms) ({card})")
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        def round_trip():
            codec.compress_file(x, path)
            return codec.decompress_file(path, as_uint8=True)

        with torch.profiler.profile(activities=activities) as prof:
            _, wall_ms = timed(round_trip)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"profiled round trip: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.0%}); top kernels by device "
        f"time:")
    for e in rows[:10]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
              f"{e.key[:90]}")


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

    from hific_tpu_torch.entropy import native
    from hific_tpu_torch import native_build
    from hific_tpu_torch.codec import Codec
    from hific_tpu_torch.entropy.container import load_compressed
    from hific_tpu_torch.models.layers import Norm
    from hific_tpu_torch.ops import fused_norm

    # Phase 2: build.
    t0 = time.perf_counter()
    fused_norm.KERNEL.library()
    built = fused_norm.KERNEL.built
    log(f"built channel_norm.cu in {built.seconds:.1f} s (plain nvcc) -> "
        f"{os.path.relpath(built.path)}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    rans = native_build.build_library("rans", [native.SOURCE],
                                      ["g++"] + native_build.GXX_FLAGS)
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

    # Phase 4: weights, codec, tables.
    log(f"weights: {source}")
    t0 = time.perf_counter()
    codec = Codec(config, state, device="cuda")
    torch.cuda.synchronize()
    log(f"codec on cuda built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    codec.build_tables()
    log(f"tables built in {time.perf_counter() - t0:.1f} s")

    # Phase 5: the round trip.
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
        for h in hooks:
            h.remove()
        out = load_compressed(path)
        z_enc, y_enc, *_ = codec.encode_symbols(x)
        z_dec, y_dec, _ = codec.decode_symbols(out)
    if launches != len(shapes) or seen != shapes:
        raise AssertionError(f"channel_norm kernel launched {launches} times "
                             f"on shapes {seen}; expected {shapes}")
    if not (np.array_equal(z_enc, z_dec) and np.array_equal(y_enc, y_dec)):
        raise AssertionError("decoded symbols differ from the encoded ones")
    if recon.shape != x.shape or recon.dtype != np.uint8:
        raise AssertionError(f"reconstruction {recon.shape} {recon.dtype}")
    mse = np.mean((recon.astype(np.float64) - x.astype(np.float64)) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))
    log(f"round trip {IMAGE_W}x{IMAGE_H}: {launches} channel_norm launches, "
        f"symbols equal (z {z_enc.shape}, y {y_enc.shape}); {actual_bpp:.4f} "
        f"bpp (estimate {estimated_bpp:.4f}); PSNR {psnr:.2f} dB")
    log(f"first round trip: compress_file {t_enc * 1e3:.1f} ms, "
        f"decompress_file {t_dec * 1e3:.1f} ms (host clock after synchronize;"
        f" {card})")
    warm_round_trip(codec, x, card)

    # The card's transforms against the plain CPU path on a small crop.
    crop = x[:, :64, :64]
    cpu = Codec(config, state, device="cpu")
    y_gpu, _ = codec.model.encode(codec._model_input(crop))
    y_cpu, _ = cpu.model.encode(cpu._model_input(crop))
    # Latents are unnormalized (trained ones reach tens): compare relative
    # to their largest magnitude; pixels live in [0, 1].
    enc_err = float((y_gpu.cpu() - y_cpu).abs().max()
                    / y_cpu.abs().max().clamp_min(1.0))
    y_hat = torch.from_numpy(y_dec[:, :, :4, :4]).float()
    with torch.inference_mode():
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

    log(f"total wall time {time.perf_counter() - T_START:.1f} s ({card})")
    print(json.dumps({"kernels": [{
        "name": "channel_norm",
        "route": "cuda",
        "source": "hific_tpu_torch/csrc/channel_norm.cu",
        "replaces": "hific_tpu/ops/pallas_norm.py:49",
        "launches": launches,
        "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"],
        "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
