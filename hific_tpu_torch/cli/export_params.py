"""Export a trained checkpoint of the port to a single-file params artifact;
counterpart of the JAX package's `cli/export_params.py`.

    python -m hific_tpu_torch.cli.export_params -ckpt <trainer dir> \\
        -o model.npz [--f16] [--step N] [--device cpu]

One compressed `.npz` in the JAX package's `export_params_npz` layout: the
codec parameters (no optimizer or discriminator state) under `p:<path>`
and the config JSON. The evaluation CLIs of both packages (`compress`,
`decompress`, `serve`) take it as `-ckpt model.npz`. `--f16` stores the
floating leaves as float16, half the size; a restore widens them to
float32, so tables and `.hfc` files regenerated from the restored model
are self-consistent (validate with a re-evaluation, not against what the
unrounded model wrote). Restores on the card unless `--device` names
another device.
"""

import argparse
import os

import numpy as np

from hific_tpu_torch.training import checkpoints
from hific_tpu_torch.utils.logging import setup_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-ckpt", "--checkpoint_dir", required=True,
                   help="this package's trainer directory (config.json + "
                        "step_<N>.pt)")
    p.add_argument("-o", "--output", required=True, help="output .npz path")
    p.add_argument("--f16", action="store_true",
                   help="store floating leaves as float16 (half size; "
                        "restored as float32)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to export (default: latest)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the train state the checkpoint restores "
                        "into")
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) unless named")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    logger = setup_logger(None, name="hific_tpu_torch.export_params")
    config = checkpoints.load_config(a.checkpoint_dir)
    if config is None:
        raise SystemExit(f"no {checkpoints.CONFIG_FILENAME} in "
                         f"{a.checkpoint_dir}")
    if a.step is None:
        path = checkpoints.latest_checkpoint(a.checkpoint_dir)
        if path is None:
            raise SystemExit(f"no step_<N>.pt checkpoints in "
                             f"{a.checkpoint_dir}")
    else:
        path = os.path.join(a.checkpoint_dir, f"step_{a.step}.pt")
    logger.info("Restoring %s", path)
    model = checkpoints.restore_train_state(path, config, a.device,
                                            seed=a.seed).model
    out = checkpoints.export_params_npz(
        a.output, model, config, cast_floats=np.float16 if a.f16 else None)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("Wrote %s (%.1f MB, %.1fM params%s)", out,
                os.path.getsize(out) / 1e6, n_params / 1e6,
                ", f16" if a.f16 else "")
    return out


if __name__ == "__main__":
    main()
