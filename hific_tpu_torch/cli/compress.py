"""Compression CLI of the port; counterpart of the JAX package's
`cli/compress.py`.

Loads a checkpoint for evaluation, builds the probability tables,
compresses an image or a directory of images to `.hfc` files (or, with
`-rc`, reconstructs without entropy coding), decodes them again, and
writes per-image PSNR, MS-SSIM and LPIPS with the bpp to `metrics.json`
and `metrics.csv`:

    python -m hific_tpu_torch.cli.compress -ckpt params.npz -i images/ \\
        -o out/ [--save] [--pipeline 8] [--tile_image 1024] [--spatial 4] \\
        [--scalar_rans] [--coder_threads 4] [--pipeline_chunk 4] \\
        [--wire_chunk 4] [--device cpu]

Runs on the card unless `--device` names another device. `--spatial N`
codes each image with its encoder and generator partitioned in row bands
over the first N devices (`Codec.compress_spatial` / `decompress_spatial`).
`--scalar_rans`, `--coder_threads`, `--pipeline_chunk` and `--wire_chunk`
go to the `Codec` as in the JAX package's CLI: scalar streams, lane-sharded
streams (container v2), and the batch codec's chunks under `--pipeline`.
"""

import argparse
import csv
import json
import os
import time

import numpy as np
import torch

from hific_tpu_torch.codec import Codec
from hific_tpu_torch.entropy.container import load_compressed, save_compressed
from hific_tpu_torch.parallel.mesh import make_mesh, visible_devices
from hific_tpu_torch.runtime import fp32_numerics, resolve_device
from hific_tpu_torch.training.checkpoints import resolve_eval_checkpoint
from hific_tpu_torch.training.data import EvalDataset
from hific_tpu_torch.utils.image_io import write_png
from hific_tpu_torch.utils.logging import setup_logger
from hific_tpu_torch.utils.metrics import ms_ssim, psnr

def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Compress images with HiFiC (PyTorch port)")
    p.add_argument("-ckpt", "--checkpoint_dir", required=True,
                   help="params .npz (either package's export_params), or "
                        "this package's trainer directory (config.json + "
                        "step_<N>.pt)")
    p.add_argument("-i", "--input", required=True,
                   help="image file or directory")
    p.add_argument("-o", "--output", default="compressed_out")
    p.add_argument("--save", action="store_true",
                   help="also save reconstructions as PNG")
    p.add_argument("--no_metrics", action="store_true")
    p.add_argument("--scalar_rans", action="store_true",
                   help="single-lane rANS (smaller files, slower)")
    p.add_argument("--coder_threads", type=int, default=1,
                   help="lane-shard each rANS payload into this many "
                        "independent streams coded in parallel host threads "
                        "(writes container v2; ~zero size overhead, not "
                        "readable by the reference implementation)")
    p.add_argument("--tile_latents", type=int, default=None,
                   help="run the generator on latent tiles of this size. "
                        "On an H100 this does not lower the decode's peak "
                        "memory: under the codec's deterministic cuDNN the "
                        "generator's first transposed convolution takes a "
                        "workspace of several GiB whatever the tile "
                        "(ROADMAP.md section 1)")
    p.add_argument("--tile_image", type=int, default=None,
                   help="encode on image tiles of this size (a multiple of "
                        "16): bounds the encoder's memory, the same bytes as "
                        "the whole-image encode")
    p.add_argument("-rc", "--reconstruct", action="store_true",
                   help="reconstruct without entropy coding (no .hfc)")
    p.add_argument("--shape_bucket", type=int, default=None,
                   help="reflect-pad inputs to multiples of this size")
    p.add_argument("--pipeline", type=int, default=0, metavar="N",
                   help="compress in groups of N images through "
                        "compress_many / decompress_many")
    p.add_argument("--pipeline_chunk", type=int, default=1,
                   help="within a pipelined group, the reconstructions of "
                        "this many same-shape images come to the host in "
                        "one copy (device programs stay per-image: batched "
                        "convolutions would change the bits); 1 disables")
    p.add_argument("--wire_chunk", type=int, default=1,
                   help="batch only the host sync points (stacked buffer/"
                        "index fetches, stacked symbol uploads) of this "
                        "many same-shape images; device programs stay "
                        "per-image. 1 disables")
    p.add_argument("--no_lpips", action="store_true",
                   help="skip the per-image LPIPS column")
    p.add_argument("--lpips_weights", default=None,
                   help="full LPIPS parameter .npz; defaults to lpips.npz "
                        "next to the checkpoint when present")
    p.add_argument("--lpips_backbone_path", default=None,
                   help="torchvision AlexNet .features state_dict (.pth)")
    p.add_argument("--spatial", type=int, default=0, metavar="N",
                   help="partition each image's encoder and generator in row "
                        "bands over the first N devices (bounded device "
                        "memory a band for very large images; the bytes of "
                        "the run without it when H is a multiple of N * 16). "
                        "Mutually exclusive with --pipeline/--tile_*")
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) unless named")
    return p.parse_args(argv)


def make_lpips_metric(a, device, logger):
    """Per-image LPIPS of [0, 1] NHWC images in fp32 with TF32 off:
    (fn, calibrated), fn None under --no_lpips / --no_metrics."""
    if a.no_lpips or a.no_metrics:
        return None, False
    from hific_tpu_torch.models.lpips import load_lpips

    params_npz = a.lpips_weights
    if params_npz is None:
        ckpt_dir = (os.path.dirname(a.checkpoint_dir)
                    if os.path.isfile(a.checkpoint_dir) else a.checkpoint_dir)
        candidate = os.path.join(ckpt_dir, "lpips.npz")
        if os.path.isfile(candidate):
            params_npz = candidate
    model, calibrated = load_lpips(params_npz, a.lpips_backbone_path)
    model = model.to(device).eval()
    if not calibrated:
        logger.warning(
            "LPIPS backbone uncalibrated (seeded random init): 'lpips' "
            "column is architecture-exact but not comparable to published "
            "numbers. Pass --lpips_weights / --lpips_backbone_path.")

    @fp32_numerics(deterministic=True)
    @torch.inference_mode()
    def metric(x0, x1):
        return model(x0.permute(0, 3, 1, 2), x1.permute(0, 3, 1, 2),
                     normalize=True)

    return metric, calibrated


def main(argv=None):
    a = parse_args(argv)
    logger = setup_logger(None, name="hific_tpu_torch.compress")
    os.makedirs(a.output, exist_ok=True)
    device = resolve_device(a.device)

    logger.info("Restoring %s", a.checkpoint_dir)
    config, state = resolve_eval_checkpoint(a.checkpoint_dir)
    codec = Codec(config, state, device=device, vectorize=not a.scalar_rans,
                  coder_threads=a.coder_threads,
                  pipeline_chunk=a.pipeline_chunk, wire_chunk=a.wire_chunk)
    if not a.reconstruct:  # -rc codes nothing, so it needs no tables
        logger.info("Building prior probability tables...")
        codec.build_tables()

    files = [a.input] if os.path.isfile(a.input) else a.input
    dataset = EvalDataset(files)
    lpips_fn, lpips_calibrated = make_lpips_metric(a, device, logger)
    rows = []

    def finish(x, source_bpp, path, recon, t_enc, t_dec, actual_bpp,
               theoretical_bpp, group_avg=False):
        name = os.path.splitext(os.path.basename(path))[0]
        row = _make_row(a, x, source_bpp, path, recon, t_enc, t_dec,
                        actual_bpp, theoretical_bpp, device, lpips_fn,
                        lpips_calibrated, group_avg)
        if a.save:
            write_png(os.path.join(a.output, name + "_recon.png"), recon[0])
        rows.append(row)
        logger.info("%s: %.4f bpp (ratio %.1f) enc %.2fs dec %.2fs %s",
                    name, row["actual_bpp"], row["compression_ratio"],
                    t_enc, t_dec,
                    f"PSNR {row.get('psnr', float('nan')):.2f}")

    def hfc_path(path):
        return os.path.join(
            a.output, os.path.splitext(os.path.basename(path))[0] + ".hfc")

    if a.spatial > 1 and not a.reconstruct:
        _spatial_run(a, codec, dataset, device, finish, hfc_path, logger)
        _write_metrics(a, rows, logger)
        return rows

    if a.pipeline > 1 and not a.reconstruct:
        # Groups through the batch codec: each group's device work is
        # enqueued before the host waits for any of it.
        items = list(dataset)
        for i in range(0, len(items), a.pipeline):
            group = items[i:i + a.pipeline]
            t0 = time.time()
            outs = codec.compress_many([x for x, _, _ in group],
                                       shape_bucket=a.shape_bucket)
            t_enc = (time.time() - t0) / len(group)
            bpps = [save_compressed(out, hfc_path(path))
                    for (_, _, path), out in zip(group, outs)]
            t0 = time.time()
            recons = codec.decompress_many(outs, as_uint8=True,
                                           tile_latents=a.tile_latents)
            t_dec = (time.time() - t0) / len(group)
            for (x, source_bpp, path), (actual_bpp, theoretical_bpp), recon \
                    in zip(group, bpps, recons):
                finish(x, source_bpp, path, recon, t_enc, t_dec, actual_bpp,
                       theoretical_bpp, group_avg=True)
        _write_metrics(a, rows, logger)
        return rows

    for x, source_bpp, path in dataset:
        if a.reconstruct:  # no entropy coding
            t0 = time.time()
            recon = codec.reconstruct(x)
            t_enc, t_dec = 0.0, time.time() - t0
            actual_bpp = theoretical_bpp = float("nan")
        else:
            t0 = time.time()
            out = codec.compress(x, shape_bucket=a.shape_bucket,
                                 tile_image=a.tile_image)
            actual_bpp, theoretical_bpp = save_compressed(out, hfc_path(path))
            t_enc = time.time() - t0
            t0 = time.time()
            recon = codec.decompress(load_compressed(hfc_path(path)),
                                     tile_latents=a.tile_latents,
                                     as_uint8=True)
            t_dec = time.time() - t0
        finish(x, source_bpp, path, recon, t_enc, t_dec, actual_bpp,
               theoretical_bpp)
    _write_metrics(a, rows, logger)
    return rows


def _spatial_run(a, codec, dataset, device, finish, hfc_path, logger):
    """--spatial N: one image at a time, its encoder and generator in row
    bands over the first N devices of the codec's type."""
    if a.pipeline > 1 or a.tile_image or a.tile_latents:
        raise SystemExit("--spatial is mutually exclusive with "
                         "--pipeline/--tile_image/--tile_latents")
    devices = visible_devices(device.type)
    if len(devices) < a.spatial:
        raise SystemExit(f"--spatial {a.spatial} needs {a.spatial} "
                         f"devices; only {len(devices)} visible")
    mesh = make_mesh(devices[:a.spatial])
    logger.info("spatial codec over %s", mesh)
    for x, source_bpp, path in dataset:
        t0 = time.time()
        out = codec.compress_spatial(x, mesh)
        actual_bpp, theoretical_bpp = save_compressed(out, hfc_path(path))
        t_enc = time.time() - t0
        t0 = time.time()
        recon = codec.decompress_spatial(load_compressed(hfc_path(path)),
                                         mesh, as_uint8=True)
        t_dec = time.time() - t0
        finish(x, source_bpp, path, recon, t_enc, t_dec, actual_bpp,
               theoretical_bpp)


def _make_row(a, x, source_bpp, path, recon, t_enc, t_dec, actual_bpp,
              theoretical_bpp, device, lpips_fn=None, lpips_calibrated=False,
              group_avg=False):
    row = {
        "file": path,
        "source_bpp": round(float(source_bpp), 4),
        "actual_bpp": round(float(actual_bpp), 4),
        "theoretical_bpp": round(float(theoretical_bpp), 4),
        "compression_ratio": round(float(source_bpp / actual_bpp), 2),
    }
    if group_avg:
        # A group is timed as a whole; per-image wall times do not exist.
        row["encode_s_group_avg"] = round(t_enc, 3)
        row["decode_s_group_avg"] = round(t_dec, 3)
    else:
        row["encode_s"] = round(t_enc, 3)
        row["decode_s"] = round(t_dec, 3)
    if not a.no_metrics:
        recon = np.asarray(recon)
        if recon.dtype == np.uint8:
            recon = recon.astype(np.float32) / 255.0
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(device)
        rt = torch.from_numpy(recon).to(device)
        row["psnr"] = round(float(psnr(xt, rt)[0]), 3)
        h, w = x.shape[1:3]
        if min(h, w) >= 176:  # MS-SSIM needs 11 * 2^4
            row["ms_ssim"] = round(float(ms_ssim(xt, rt)[0]), 5)
        if lpips_fn is not None:
            row["lpips"] = round(float(lpips_fn(xt, rt).reshape(-1)[0]), 5)
            row["lpips_calibrated"] = bool(lpips_calibrated)
    return row


def _write_metrics(a, rows, logger):
    metrics_path = os.path.join(a.output, "metrics.json")
    with open(metrics_path, "w") as f:
        json.dump(rows, f, indent=2)
    columns = list(dict.fromkeys(k for row in rows for k in row))
    with open(os.path.join(a.output, "metrics.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns)
        writer.writeheader()
        writer.writerows(rows)
    coded = [r for r in rows if np.isfinite(r["actual_bpp"])]  # not -rc
    if coded:
        logger.info("Mean: %.4f bpp | ratio %.1f",
                    np.mean([r["actual_bpp"] for r in coded]),
                    np.mean([r["compression_ratio"] for r in coded]))
    logger.info("Wrote %s (%d images)", metrics_path, len(rows))


if __name__ == "__main__":
    main()
