"""Training CLI of the port: the compression stage (rate + MSE + LPIPS).

    python -m hific_tpu_torch.cli.train -d data/openimages --regime low \
        --steps 1000000 --uncalibrated_lpips_ok

Counterpart of the JAX package's `cli/train.py` on its `-mt compression`
path: config from the flags, seeded random weights or a restored
checkpoint, the compression step of `training/train_step.py` over uint8
crops, logs every `--log_interval` steps and checkpoints every
`--save_interval` and at the end. Steps are absolute: a resumed run trains
up to `--steps` in all. Runs on the card unless `--device cpu`.

`run` takes any iterator of (uint8 NHWC batch, bpp) pairs in place of the
dataset, so a caller can drive the trainer with its own crops. The LPIPS
backbone is the seeded random one (`models/lpips.py`); without
`--uncalibrated_lpips_ok` the CLI refuses it, as the JAX CLI does, and
`--no_lpips` drops the perceptual term.
"""

import argparse
import json
import logging
import os
import sys
import time
from typing import Callable, Iterator, Optional

import torch

from hific_tpu_torch.config import mse_lpips_config
from hific_tpu_torch.models.lpips import default_lpips
from hific_tpu_torch.runtime import resolve_device
from hific_tpu_torch.training import checkpoints
from hific_tpu_torch.training.data import TrainDataset, prefetch
from hific_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_train_step_g,
)

LOG = logging.getLogger("hific_tpu_torch.train")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train HiFiC's compression "
                                "stage (PyTorch port)")
    p.add_argument("-regime", "--regime", default="low",
                   choices=["low", "med", "high"])
    p.add_argument("-d", "--dataset_path", default="data/openimages")
    p.add_argument("-name", "--name", default="hific_tpu_torch_v0.1")
    p.add_argument("-bs", "--batch_size", type=int, default=8)
    p.add_argument("-steps", "--steps", type=int, default=int(1e6))
    p.add_argument("-lr", "--learning_rate", type=float, default=1e-4)
    p.add_argument("-crop", "--crop_size", type=int, default=256)
    p.add_argument("-norm", "--normalize_input_image", action="store_true")
    p.add_argument("--likelihood_type", default="gaussian",
                   choices=["gaussian", "logistic"])
    p.add_argument("--n_residual_blocks", type=int, default=9)
    p.add_argument("--latent_channels", type=int, default=220)
    p.add_argument("--hyperlatent_filters", type=int, default=320)
    p.add_argument("--no_lpips", action="store_true",
                   help="train without the perceptual term (k_P * LPIPS)")
    p.add_argument("--uncalibrated_lpips_ok", action="store_true",
                   help="accept the seeded random LPIPS backbone (lin heads "
                        "calibrated, backbone not); without it the CLI "
                        "refuses to train on LPIPS")
    p.add_argument("--log_interval", type=int, default=1000)
    p.add_argument("--save_interval", type=int, default=50000)
    p.add_argument("--warmstart_ckpt", default=None)
    p.add_argument("--resume_ckpt", default=None)
    p.add_argument("--experiments_dir", default="experiments")
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) unless named")
    p.add_argument("--seed", type=int, default=42)
    return p.parse_args(argv)


def build_config(a):
    return mse_lpips_config(
        name=a.name, regime=a.regime, batch_size=a.batch_size,
        n_steps=a.steps, learning_rate=a.learning_rate,
        crop_size=a.crop_size, normalize_input_image=a.normalize_input_image,
        likelihood_type=a.likelihood_type,
        n_residual_blocks=a.n_residual_blocks,
        latent_channels=a.latent_channels,
        hyperlatent_filters=a.hyperlatent_filters,
        log_interval=a.log_interval, save_interval=a.save_interval)


def make_lpips_fn(a, device) -> Optional[Callable]:
    """LPIPS on [0, 1] images, or None with --no_lpips."""
    if a.no_lpips:
        LOG.warning("--no_lpips: training rate + MSE only")
        return None
    if not a.uncalibrated_lpips_ok:
        raise SystemExit(
            "The LPIPS backbone here is a seeded RANDOM init (lin heads "
            "calibrated, backbone not). Pass --uncalibrated_lpips_ok to "
            "train on it knowingly, or --no_lpips to drop the term.")
    lpips = default_lpips(a.seed).to(device, memory_format=torch.channels_last)
    return lambda x_gen, x_real: lpips(x_gen, x_real, normalize=True)


def run(a, batches: Optional[Iterator] = None,
        on_step: Optional[Callable] = None) -> TrainState:
    """Train per the parsed flags `a` over `batches` (the dataset at
    --dataset_path when None); on_step(state, diagnostics) after each step.
    Returns the final state, checkpointed."""
    config = build_config(a)
    device = resolve_device(a.device)
    exp_dir = os.path.join(a.experiments_dir,
                           f"{config.name}_{config.model_type}_{config.regime}")
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    os.makedirs(exp_dir, exist_ok=True)
    if a.resume_ckpt or a.warmstart_ckpt:
        state = checkpoints.restore_train_state(
            a.resume_ckpt or a.warmstart_ckpt, config, device,
            warmstart=a.resume_ckpt is None)
        LOG.info("restored step %d", state.step)
    else:
        state = create_train_state(config, a.seed, device)
    if state.step >= config.n_steps:
        raise SystemExit(f"-steps {config.n_steps} <= restored step "
                         f"{state.step}: nothing to train (steps are "
                         f"absolute)")
    n_params = sum(p.numel() for p in state.model.parameters())
    LOG.info("codec parameters: %.1fM on %s", n_params / 1e6, device)
    step_fn = make_train_step_g(config, make_lpips_fn(a, device))
    if batches is None:
        dataset = TrainDataset(a.dataset_path, config.crop_size, a.seed)
        batches = prefetch(dataset.batches(config.batch_size), size=4)

    metrics_path = os.path.join(exp_dir, "metrics.jsonl")
    t0, last_step = time.perf_counter(), state.step
    with open(metrics_path, "a") as metrics:
        for x, _ in batches:
            diagnostics = step_fn(state, x)
            if on_step is not None:
                on_step(state, diagnostics)
            if state.step % config.log_interval == 1:
                scalars = {k: float(v) for k, v in diagnostics.items()}
                scalars["images_per_sec"] = (
                    (state.step - last_step) * config.batch_size
                    / max(time.perf_counter() - t0, 1e-9))
                metrics.write(json.dumps({"step": state.step, **scalars})
                              + "\n")
                LOG.info("step %d | loss %.3f | q_bpp %.3f | %.1f img/s",
                         state.step, scalars["weighted_compression_loss"],
                         scalars["q_rate"], scalars["images_per_sec"])
                t0, last_step = time.perf_counter(), state.step
            if state.step % config.save_interval == 0:
                checkpoints.save_checkpoint(ckpt_dir, state, config)
            if state.step >= config.n_steps:
                break
    path = checkpoints.save_checkpoint(ckpt_dir, state, config)
    LOG.info("final checkpoint %s", path)
    return state


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(message)s")
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
