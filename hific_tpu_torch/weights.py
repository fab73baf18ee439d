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
  float32, so they widen exactly by a 16-bit shift; under a bfloat16
  config (`keep_bf16`) they stay bfloat16 tensors instead, the dtype of the
  transposed convs' parameters there.

`jax_params_from_model` inverts these permutations (bfloat16 parameters
widen exactly to float32), so what this package trains exports in the JAX
artifact layout (`training/checkpoints.py`,
`export_params_npz`). `lpips_state_dict_from_jax` carries the JAX
package's LPIPS parameters (`models/lpips.py`) to this package's.

The discriminator (`disc_state_dict_from_jax`, `jax_disc_from_model`)
lives apart from the codec tree in the JAX package (`disc_params`, and
its `spectral` collection holding each SNConv's `u` under
`discriminator/convK/u`). Its `context_conv` and `conv_out` are ordinary
`Conv_0` leaves; an SNConv declares `convK/kernel` at its own level with no
`Conv_0`, like a transposed conv, but its kernel is a plain HWIO
correlation kernel: OIHW by a transpose, with no flip.
"""

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from hific_tpu_torch.config import Config
from hific_tpu_torch.models.density import HyperlatentDensity
from hific_tpu_torch.models.layers import Conv, ConvTranspose, Norm, SNConv

NPZ_CONFIG_KEY = "__config_json__"
NPZ_LEAF_PREFIX = "p:"


def bf16_bits_to_float32(a: np.ndarray) -> np.ndarray:
    """bfloat16 values held as any 2-byte dtype -> the equal float32 values."""
    bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def leaf_to_float32(a) -> np.ndarray:
    a = np.asarray(a)
    if _is_bf16_bits(a):
        return bf16_bits_to_float32(a)
    if np.issubdtype(a.dtype, np.floating):
        return a.astype(np.float32)
    raise ValueError(f"not a float parameter leaf: dtype {a.dtype}")


def _is_bf16_bits(a: np.ndarray) -> bool:
    # Raw `|V2` records and ml_dtypes' bfloat16 are both 2-byte void kinds.
    return a.dtype.kind == "V" and a.dtype.itemsize == 2


def leaf_to_tensor(a, keep_bf16: bool = False) -> torch.Tensor:
    """A float leaf -> a float32 CPU tensor, or a bfloat16 one for a
    bfloat16 leaf when `keep_bf16`."""
    a = np.ascontiguousarray(a)
    if keep_bf16 and _is_bf16_bits(a):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(leaf_to_float32(a))


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


def convert_leaf(path: str, value, keep_bf16: bool = False
                 ) -> Tuple[str, torch.Tensor]:
    """One JAX leaf -> (state_dict key, CPU tensor in this package's
    layout; see `leaf_to_tensor` for its dtype)."""
    parts = path.split("/")
    a = leaf_to_tensor(value, keep_bf16)
    leaf = parts[-1]
    is_conv = len(parts) >= 2 and parts[-2] == "Conv_0"
    if leaf in ("kernel", "bias"):
        module = parts[:-2] if is_conv else parts[:-1]
        name = "weight" if leaf == "kernel" else "bias"
        if leaf == "kernel":
            if is_conv:   # HWIO -> OIHW
                a = a.permute(3, 2, 0, 1)
            else:         # flipped HWIO -> (I, O, kH, kW)
                a = a.flip(0, 1).permute(2, 3, 0, 1)
        parts = module + [name]
    return ".".join(parts), a.contiguous()


def state_dict_from_jax(params: Mapping, keep_bf16: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested or '/'-flat, numpy leaves) -> CPU state_dict
    for `HiFiC`: float32, and bfloat16 for bfloat16 leaves when
    `keep_bf16` (a bfloat16 config's train state)."""
    return dict(convert_leaf(path, value, keep_bf16)
                for path, value in flatten_tree(params).items())


def load_npz(path: str) -> Tuple[Config, Dict[str, torch.Tensor]]:
    """Read an `export_params_npz` artifact -> (config, state_dict).

    The config is the artifact's, its compute dtype included; under a
    bfloat16 config the bfloat16 leaves stay bfloat16. A caller that wants
    the float32 codec of the same weights replaces `dtype` (the weights are
    exact either way).
    """
    state = {}
    with np.load(path) as z:
        config = Config.from_json(bytes(z[NPZ_CONFIG_KEY]).decode("utf-8"))
        keep_bf16 = config.dtype == "bfloat16"
        for name in z.files:  # one leaf at a time keeps the peak low
            if name.startswith(NPZ_LEAF_PREFIX):
                key, a = convert_leaf(name[len(NPZ_LEAF_PREFIX):], z[name],
                                      keep_bf16)
                state[key] = a
    return config, state


def jax_params_from_model(model: nn.Module) -> Dict[str, np.ndarray]:
    """HiFiC parameters -> {'a/b/c': float32 numpy leaf} in the JAX
    package's tree and layouts (the inverse of `convert_leaf`)."""
    flat = {}
    for name, module in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(module, Conv):
            w = _numpy(module.weight)
            flat[f"{path}/Conv_0/kernel"] = w.transpose(2, 3, 1, 0)
            flat[f"{path}/Conv_0/bias"] = _numpy(module.bias)
        elif isinstance(module, ConvTranspose):
            w = _numpy(module.weight)
            flat[f"{path}/kernel"] = w.transpose(2, 3, 0, 1)[::-1, ::-1]
            flat[f"{path}/bias"] = _numpy(module.bias)
        elif isinstance(module, (Norm, HyperlatentDensity)):
            for leaf, p in module.named_parameters(recurse=False):
                flat[f"{path}/{leaf}"] = _numpy(p)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in flat.items()}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A parameter -> float32 numpy (a bfloat16 one widened exactly)."""
    return t.detach().float().cpu().numpy()


def disc_state_dict_from_jax(disc_params: Mapping, spectral: Mapping
                             ) -> Dict[str, torch.Tensor]:
    """The JAX package's discriminator parameters and `spectral` collection
    (nested or '/'-flat, numpy leaves; `u` under `discriminator/convK/u`)
    -> float32 CPU state_dict for `models.discriminator.Discriminator`."""
    out = {}
    for path, value in flatten_tree(disc_params).items():
        parts = path.split("/")
        if parts[-1] == "kernel" and parts[-2] != "Conv_0":  # SNConv
            key = ".".join(parts[:-1] + ["weight"])
            a = torch.from_numpy(np.ascontiguousarray(
                leaf_to_float32(value).transpose(3, 2, 0, 1)))
        else:
            key, a = convert_leaf(path, value)
        out[key] = a
    for path, value in flatten_tree(spectral).items():
        parts = path.split("/")
        if parts[0] == "discriminator":
            parts = parts[1:]
        out[".".join(parts)] = torch.from_numpy(
            np.ascontiguousarray(leaf_to_float32(value)))
    return out


def jax_disc_from_model(disc: nn.Module) -> Tuple[Dict[str, np.ndarray],
                                                 Dict[str, np.ndarray]]:
    """Discriminator -> ({'a/b': float32 leaf} of its parameters,
    {'discriminator/convK/u': float32 leaf} of its spectral collection), in
    the JAX package's trees and layouts (the inverse of
    `disc_state_dict_from_jax`)."""
    params, spectral = {}, {}
    for name, module in disc.named_modules():
        path = name.replace(".", "/")
        if isinstance(module, (Conv, SNConv)):
            leaf = path if isinstance(module, SNConv) else f"{path}/Conv_0"
            w = module.weight.detach().cpu().numpy()
            params[f"{leaf}/kernel"] = w.transpose(2, 3, 1, 0)
            params[f"{leaf}/bias"] = module.bias.detach().cpu().numpy()
        if isinstance(module, SNConv):
            spectral[f"discriminator/{path}/u"] = module.u.cpu().numpy()
    return tuple({k: np.ascontiguousarray(v, np.float32)
                  for k, v in d.items()} for d in (params, spectral))


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
