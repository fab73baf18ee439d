"""Checkpoints of the port's trainer, and export in the JAX artifact layout;
counterpart of the JAX package's `training/checkpoints.py`.

- `save_checkpoint` / `restore_train_state`: this package's own format,
  `<directory>/step_<N>.pt` (`torch.save` of the model's and the
  optimizer's state dicts, the step counter and the noise generator's
  state) beside `config.json`. A warmstart restores the codec parameters,
  their optimizer state and the step, and keeps a fresh noise generator,
  as the JAX package's does.
- `export_params_npz`: the codec parameters in the JAX package's
  `export_params_npz` layout (`p:<path>` leaves + `__config_json__`), so
  `hific_tpu.training.checkpoints.load_params_npz` loads what this package
  trained.
"""

import os
from typing import Optional

import numpy as np
import torch

from hific_tpu_torch.config import Config
from hific_tpu_torch.training.train_step import TrainState, create_train_state
from hific_tpu_torch.weights import (
    NPZ_CONFIG_KEY,
    NPZ_LEAF_PREFIX,
    jax_params_from_model,
)

CONFIG_FILENAME = "config.json"


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
                        warmstart: bool = False) -> TrainState:
    state = create_train_state(config, device=device)
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if not warmstart:
        state.generator.set_state(payload["noise_generator"].cpu())
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
