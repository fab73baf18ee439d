"""Checkpoint conversion CLI of the port: a reference PyTorch `.pt` -> this
package's trainer layout; counterpart of the JAX package's
`cli/convert.py`.

    python -m hific_tpu_torch.cli.convert -pt hific_med.pt -o converted \\
        [--model_type compression_gan] [--regime med] [--device cpu]

Writes `config.json` and `step_0.pt` (the converted codec and, in the GAN
stage, discriminator with fresh optimizers, as `save_checkpoint` writes
them), and `lpips.npz` (the JAX package's LPIPS file) when the checkpoint
embeds the calibrated LPIPS. The output directory is the `-ckpt` of the
compress CLI, which finds `lpips.npz` beside the checkpoint. Builds the
train state on the card unless `--device` names another device.
"""

import argparse
import os

from hific_tpu_torch.config import ModelTypes, hific_config, mse_lpips_config
from hific_tpu_torch.models.lpips import LPIPS, save_lpips_npz
from hific_tpu_torch.training import checkpoints
from hific_tpu_torch.training.train_step import create_train_state
from hific_tpu_torch.utils.convert_torch import load_reference_checkpoint
from hific_tpu_torch.utils.logging import setup_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Convert reference .pt checkpoint")
    p.add_argument("-pt", "--torch_checkpoint", required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("--model_type", default=ModelTypes.COMPRESSION_GAN,
                   choices=[ModelTypes.COMPRESSION, ModelTypes.COMPRESSION_GAN])
    p.add_argument("--regime", default="med", choices=["low", "med", "high"])
    p.add_argument("--latent_channels", type=int, default=220)
    p.add_argument("--n_residual_blocks", type=int, default=9)
    p.add_argument("--hyperlatent_filters", type=int, default=320)
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) unless named")
    return p.parse_args(argv)


def main(argv=None):
    a = parse_args(argv)
    logger = setup_logger(None, name="hific_tpu_torch.convert")

    make = (hific_config if a.model_type == ModelTypes.COMPRESSION_GAN
            else mse_lpips_config)
    config = make(regime=a.regime, latent_channels=a.latent_channels,
                  n_residual_blocks=a.n_residual_blocks,
                  hyperlatent_filters=a.hyperlatent_filters)

    logger.info("Converting %s", a.torch_checkpoint)
    model_sd, disc_sd, lpips_sd = load_reference_checkpoint(
        a.torch_checkpoint, n_residual_blocks=a.n_residual_blocks)

    logger.info("Building the train state (fresh optimizers)...")
    state = create_train_state(config, 0, a.device)
    state.model.load_state_dict(model_sd)
    if state.disc is not None and disc_sd:
        state.disc.load_state_dict(disc_sd)

    path = checkpoints.save_checkpoint(a.output_dir, state, config)
    if lpips_sd is not None:
        lpips = LPIPS()
        lpips.load_state_dict(lpips_sd)
        lpips_path = os.path.join(a.output_dir, "lpips.npz")
        save_lpips_npz(lpips_path, lpips)
        logger.info("Extracted calibrated LPIPS weights -> %s (found by "
                    "the compress CLI)", lpips_path)
    logger.info("Wrote %s; use with: python -m hific_tpu_torch.cli.compress "
                "-ckpt %s ...", path, a.output_dir)
    return path


if __name__ == "__main__":
    main()
