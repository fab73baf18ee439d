"""Checkpoints of the port's trainer, and export in the JAX artifact layout;
counterpart of the JAX package's `training/checkpoints.py`.

- `save_checkpoint` / `restore_train_state`: this package's own format,
  `<directory>/step_<N>.pt` (`torch.save` of the model's and the
  optimizer's state dicts, the step counter and the noise generator's
  state; in the GAN stage also the discriminator's state dict with each
  SNConv's `u`, its optimizer's and the count of D steps) beside
  `config.json`. A resume restores all of it, so the next steps are those
  the run would have taken. A warmstart (a GAN run from a compression
  run, say) needs the source run's `config.json` beside the checkpoint,
  as the JAX package's does, refuses a source whose codec differs
  (`CODEC_FIELDS`), and restores the codec parameters, their
  optimizer state and the step; the noise generator, the discriminator
  and its optimizer stay fresh, with a D count of 0.
- `export_params_npz`: the codec parameters in the JAX package's
  `export_params_npz` layout (`p:<path>` leaves + `__config_json__`), so
  `hific_tpu.training.checkpoints.load_params_npz` loads what this package
  trained.
- `resolve_eval_checkpoint`: the `-ckpt` argument of the evaluation CLIs ->
  (config, state_dict). An Orbax checkpoint of the JAX trainer is refused
  with the command that exports it to a `.npz`: this package never reads
  Orbax.
"""

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hific_tpu_torch.config import Config
from hific_tpu_torch.training.train_step import TrainState, create_train_state
from hific_tpu_torch.weights import (
    NPZ_CONFIG_KEY,
    NPZ_LEAF_PREFIX,
    jax_params_from_model,
    load_npz,
)

CONFIG_FILENAME = "config.json"
# The config fields that shape the codec or the meaning of its weights: a
# warmstart source must agree with the target on each. The widths and the
# variants' extra layers would also fail `load_state_dict`; the
# likelihood, the input range and the norm type would load and train on
# the wrong model.
CODEC_FIELDS = ("latent_channels", "n_residual_blocks", "hyperlatent_filters",
                "likelihood_type", "normalize_input_image",
                "use_channel_norm", "use_latent_mixture_model",
                "latent_channels_dlmm", "sample_noise", "noise_dim")


def save_checkpoint(directory: str, state: TrainState, config: Config
                    ) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{state.step}.pt")
    payload = {
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "noise_generator": state.generator.get_state(),
    }
    if state.disc is not None:
        payload.update(disc=state.disc.state_dict(),
                       disc_optimizer=state.disc_optimizer.state_dict(),
                       disc_steps=state.disc_steps)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    with open(os.path.join(directory, CONFIG_FILENAME), "w") as f:
        f.write(config.to_json())
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = [int(n[5:-3]) for n in os.listdir(directory)
             if n.startswith("step_") and n.endswith(".pt")
             and n[5:-3].isdigit()]
    if not steps:
        return None
    return os.path.join(directory, f"step_{max(steps)}.pt")


def load_config(directory: str) -> Optional[Config]:
    path = os.path.join(directory, CONFIG_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return Config.from_json(f.read())


def restore_train_state(path: str, config: Config, device=None,
                        warmstart: bool = False, seed: int = 0
                        ) -> TrainState:
    """The train state saved at `path`, on `device`. What the checkpoint
    does not restore (after a warmstart: the noise generator and the
    discriminator) is `create_train_state(config, seed)`'s."""
    if warmstart:
        src_dir = os.path.dirname(os.path.abspath(path))
        src_config = load_config(src_dir)
        if src_config is None:
            raise FileNotFoundError(
                f"warmstart source config not found: expected "
                f"{os.path.join(src_dir, CONFIG_FILENAME)} beside the "
                f"checkpoint (written by save_checkpoint)")
        differ = [f"{k}: {getattr(src_config, k)!r} in the source, "
                  f"{getattr(config, k)!r} here" for k in CODEC_FIELDS
                  if getattr(src_config, k) != getattr(config, k)]
        if differ:
            raise ValueError(f"warmstart from {path}: the codec differs "
                             f"({'; '.join(differ)})")
    state = create_train_state(config, seed, device)
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if warmstart:
        return state
    state.generator.set_state(payload["noise_generator"].cpu())
    if state.disc is not None:
        if "disc" not in payload:
            raise ValueError(f"{path} holds no discriminator: start the GAN "
                             f"stage from it with a warmstart")
        state.disc.load_state_dict(payload["disc"])
        state.disc_optimizer.load_state_dict(payload["disc_optimizer"])
        state.disc_steps = int(payload["disc_steps"])
    return state


def export_params_npz(out_path: str, model: torch.nn.Module, config: Config
                      ) -> str:
    """Codec parameters (float32, exact) + config -> one compressed .npz."""
    entries = {NPZ_LEAF_PREFIX + k: v
               for k, v in jax_params_from_model(model).items()}
    entries[NPZ_CONFIG_KEY] = np.frombuffer(
        config.to_json().encode("utf-8"), dtype=np.uint8)
    out_path = os.path.abspath(out_path)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez_compressed(out_path, **entries)
    return out_path


def resolve_eval_checkpoint(checkpoint_arg: str
                            ) -> Tuple[Config, Dict[str, torch.Tensor]]:
    """An evaluation CLI's `-ckpt` argument -> (config, CPU state_dict).

    A `.npz` file is an `export_params_npz` artifact (either package's).
    A directory with `config.json` and `step_<N>.pt` files is this
    package's trainer layout: the latest step's model weights. A
    directory of `step_<N>/` subdirectories is an Orbax checkpoint of the
    JAX trainer, which exits with the command that exports it."""
    if os.path.isfile(checkpoint_arg) and checkpoint_arg.endswith(".npz"):
        return load_npz(checkpoint_arg)
    if not os.path.isdir(checkpoint_arg):
        raise FileNotFoundError(f"no checkpoint at {checkpoint_arg} (expected "
                                f"a params .npz file or a checkpoints "
                                f"directory)")
    if any(n.startswith("step_") and n[5:].isdigit()
           and os.path.isdir(os.path.join(checkpoint_arg, n))
           for n in os.listdir(checkpoint_arg)):
        raise SystemExit(
            f"{checkpoint_arg} is an Orbax checkpoint of the JAX trainer, "
            f"which hific_tpu_torch does not read; export its parameters "
            f"with `python -m hific_tpu.cli.export_params -ckpt "
            f"{checkpoint_arg} -o params.npz` and pass the .npz")
    config = load_config(checkpoint_arg)
    if config is None:
        raise FileNotFoundError(f"no {CONFIG_FILENAME} in {checkpoint_arg}")
    path = latest_checkpoint(checkpoint_arg)
    if path is None:
        raise FileNotFoundError(f"no step_<N>.pt checkpoints in "
                                f"{checkpoint_arg}")
    state = restore_train_state(path, config, device="cpu")
    return config, state.model.state_dict()
