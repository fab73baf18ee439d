"""Carry weights across between the JAX package's layout and this
package's, both ways.

The JAX package stores parameters as a nested tree of NHWC-convention
arrays and exports them with `export_params_npz`: one `.npz` holding a
`p:<path>` leaf per parameter plus the config JSON under
`__config_json__`. This module turns such an artifact, or an in-memory
tree of numpy arrays, into a `state_dict` for `models.hific.HiFiC`.

Every conversion is an exact permutation or an exact widening:

- Conv kernels (`<name>/Conv_0/kernel`, HWIO) -> `<name>.weight`, OIHW.
- ConvTranspose kernels (`<name>/kernel`, no `Conv_0` level) are stored
  spatially flipped, as the HWIO kernel of the input-dilated correlation
  the JAX package runs. Un-flipped and reordered they are the
  `(I, O, kH, kW)` weight of `F.conv_transpose2d`.
- Norm gamma/beta and the density's H/a/b keep their shapes.
- float16 leaves widen to float32. bfloat16 leaves (written by numpy as raw
  2-byte `|V2` records, since numpy has no bfloat16) are the high half of a
  float32, so they widen exactly by a 16-bit shift.

`jax_params_from_model` inverts these permutations, so what this package
trains exports in the JAX artifact layout (`training/checkpoints.py`,
`export_params_npz`). `lpips_state_dict_from_jax` carries the JAX
package's LPIPS parameters (`models/lpips.py`) to this package's.
"""

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from hific_tpu_torch.config import Config
from hific_tpu_torch.models.density import HyperlatentDensity
from hific_tpu_torch.models.layers import Conv, ConvTranspose, Norm

NPZ_CONFIG_KEY = "__config_json__"
NPZ_LEAF_PREFIX = "p:"


def bf16_bits_to_float32(a: np.ndarray) -> np.ndarray:
    """bfloat16 values held as any 2-byte dtype -> the equal float32 values."""
    bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def leaf_to_float32(a) -> np.ndarray:
    a = np.asarray(a)
    # Raw `|V2` records and ml_dtypes' bfloat16 are both 2-byte void kinds.
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return bf16_bits_to_float32(a)
    if np.issubdtype(a.dtype, np.floating):
        return a.astype(np.float32)
    raise ValueError(f"not a float parameter leaf: dtype {a.dtype}")


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested JAX param tree -> {'a/b/c': leaf}. A flat dict of '/'-joined
    paths passes through."""
    flat = {}
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = v
    return flat


def convert_leaf(path: str, value) -> Tuple[str, np.ndarray]:
    """One JAX leaf -> (state_dict key, array in this package's layout)."""
    parts = path.split("/")
    a = leaf_to_float32(value)
    leaf = parts[-1]
    is_conv = len(parts) >= 2 and parts[-2] == "Conv_0"
    if leaf in ("kernel", "bias"):
        module = parts[:-2] if is_conv else parts[:-1]
        name = "weight" if leaf == "kernel" else "bias"
        if leaf == "kernel":
            if is_conv:   # HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            else:         # flipped HWIO -> (I, O, kH, kW)
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
        parts = module + [name]
    return ".".join(parts), np.ascontiguousarray(a)


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested or '/'-flat, numpy leaves) -> float32 CPU
    state_dict for `HiFiC`."""
    out = {}
    for path, value in flatten_tree(params).items():
        key, a = convert_leaf(path, value)
        out[key] = torch.from_numpy(a)
    return out


def load_npz(path: str) -> Tuple[Config, Dict[str, torch.Tensor]]:
    """Read an `export_params_npz` artifact -> (config, state_dict).

    The config's compute dtype is set to float32, the only one this package
    computes in: the weights are exact either way, and the reference runs
    that this port is held against are float32 too.
    """
    state = {}
    with np.load(path) as z:
        config = Config.from_json(bytes(z[NPZ_CONFIG_KEY]).decode("utf-8"))
        for name in z.files:  # one leaf at a time keeps the peak low
            if name.startswith(NPZ_LEAF_PREFIX):
                key, a = convert_leaf(name[len(NPZ_LEAF_PREFIX):], z[name])
                state[key] = torch.from_numpy(a)
    return config.replace(dtype="float32"), state


def jax_params_from_model(model: nn.Module) -> Dict[str, np.ndarray]:
    """HiFiC parameters -> {'a/b/c': float32 numpy leaf} in the JAX
    package's tree and layouts (the inverse of `convert_leaf`)."""
    flat = {}
    for name, module in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(module, Conv):
            w = module.weight.detach().cpu().numpy()
            flat[f"{path}/Conv_0/kernel"] = w.transpose(2, 3, 1, 0)
            flat[f"{path}/Conv_0/bias"] = module.bias.detach().cpu().numpy()
        elif isinstance(module, ConvTranspose):
            w = module.weight.detach().cpu().numpy()
            flat[f"{path}/kernel"] = w.transpose(2, 3, 0, 1)[::-1, ::-1]
            flat[f"{path}/bias"] = module.bias.detach().cpu().numpy()
        elif isinstance(module, (Norm, HyperlatentDensity)):
            for leaf, p in module.named_parameters(recurse=False):
                flat[f"{path}/{leaf}"] = p.detach().cpu().numpy()
    return {k: np.ascontiguousarray(v, np.float32) for k, v in flat.items()}


def lpips_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS parameter tree (`backbone/convK/{kernel,
    bias}`, HWIO kernels, and the heads `linK`) -> state_dict for
    `models.lpips.LPIPS`."""
    out = {}
    for path, value in flatten_tree(params).items():
        a = leaf_to_float32(value)
        parts = path.split("/")
        if parts[-1] == "kernel":
            parts[-1], a = "weight", a.transpose(3, 2, 0, 1)
        out[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(a))
    return out
