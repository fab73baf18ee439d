"""Decode-only CLI of the port: reconstruct images from `.hfc` files alone;
counterpart of the JAX package's `cli/decompress.py`.

    python -m hific_tpu_torch.cli.decompress -ckpt params.npz \\
        -i compressed/ -o recon/ [--pipeline 8] [--tile_latents 64] \\
        [--device cpu]

Takes one `.hfc` file or a directory of them (container v1 and the
lane-sharded v2 both load transparently: the file says which) and writes
one PNG per file. Decoding takes the device decoder wherever
`Codec.decompress` would; `--pipeline N` decodes groups of N through
`decompress_many`. Runs on the card unless `--device` names another
device.
"""

import argparse
import glob
import os
import time

from hific_tpu_torch.codec import Codec
from hific_tpu_torch.entropy.container import load_compressed
from hific_tpu_torch.runtime import resolve_device
from hific_tpu_torch.training.checkpoints import resolve_eval_checkpoint
from hific_tpu_torch.utils.image_io import write_png
from hific_tpu_torch.utils.logging import setup_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Reconstruct images from .hfc files (HiFiC, PyTorch "
                    "port)")
    p.add_argument("-ckpt", "--checkpoint_dir", required=True,
                   help="params .npz (either package's export_params), or "
                        "this package's trainer directory (config.json + "
                        "step_<N>.pt)")
    p.add_argument("-i", "--input", required=True,
                   help=".hfc file or directory of .hfc files")
    p.add_argument("-o", "--output", default="decompressed_out")
    p.add_argument("--pipeline", type=int, default=0, metavar="N",
                   help="decode in groups of N payloads through "
                        "decompress_many")
    p.add_argument("--tile_latents", type=int, default=None,
                   help="run the generator on latent tiles of this size. "
                        "On an H100 this does not lower the decode's peak "
                        "memory: under the codec's deterministic cuDNN the "
                        "generator's first transposed convolution takes a "
                        "workspace of several GiB whatever the tile "
                        "(ROADMAP.md section 1)")
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) unless named")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    logger = setup_logger(None, name="hific_tpu_torch.decompress")
    os.makedirs(a.output, exist_ok=True)

    logger.info("Restoring %s", a.checkpoint_dir)
    config, state = resolve_eval_checkpoint(a.checkpoint_dir)
    codec = Codec(config, state, device=resolve_device(a.device))
    logger.info("Building prior probability tables...")
    codec.build_tables()

    if os.path.isfile(a.input):
        files = [a.input]
    else:
        files = sorted(glob.glob(os.path.join(a.input, "*.hfc")))
    if not files:
        raise SystemExit(f"no .hfc files under {a.input}")

    written = []

    def emit(path, recon, dt):
        name = os.path.splitext(os.path.basename(path))[0]
        out_png = os.path.join(a.output, name + ".png")
        write_png(out_png, recon[0])
        h, w = recon.shape[1:3]
        logger.info("%s: %dx%d in %.2fs -> %s", name, w, h, dt, out_png)
        written.append(out_png)

    if a.pipeline > 1:
        for i in range(0, len(files), a.pipeline):
            group = files[i:i + a.pipeline]
            t0 = time.time()
            recons = codec.decompress_many(
                [load_compressed(f) for f in group], as_uint8=True,
                tile_latents=a.tile_latents)
            dt = (time.time() - t0) / len(group)
            for path, recon in zip(group, recons):
                emit(path, recon, dt)
    else:
        for path in files:
            t0 = time.time()
            recon = codec.decompress(load_compressed(path),
                                     tile_latents=a.tile_latents,
                                     as_uint8=True)
            emit(path, recon, time.time() - t0)
    return written


if __name__ == "__main__":
    main()
