"""Map reference PyTorch HiFiC checkpoints onto this package's modules;
counterpart of the JAX package's `utils/convert_torch.py`.

The reference saves `{'model_state_dict': ..., args...}` with its own
module names. Both sides are torch layouts, so the tensors keep their
values and most their shapes:

- Conv2d weight (O, I, kh, kw)          -> `Conv` weight, unchanged
- ConvTranspose2d weight (I, O, kh, kw) -> `ConvTranspose` weight, unchanged
- a stride-1 ConvTranspose2d (the hyper synthesis's conv3) -> the `Conv`
  it equals: I and O swapped and the kernel flipped spatially
- ChannelNorm gamma / beta (1, C, 1, 1) -> (C,)
- HyperpriorDensity H_k / a_k / b_k     -> unchanged (C, f_out, f_in)
- spectral_norm weight_orig / weight_u  -> `SNConv` weight and its `u`
- the embedded LPIPS backbone and lin heads -> `models.lpips.LPIPS`

The name map is keyed on the reference's module attribute names, as the
JAX package's is; every tensor equals, bit for bit, what the JAX package's
conversion followed by `weights.state_dict_from_jax` gives.
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

# The reference Model registers its PerceptualLoss as a submodule, so full
# checkpoints embed the LPIPS backbone and lin heads under this prefix.
LPIPS_PREFIX = "perceptual_loss.model.net."
# (torchvision `.features` slice, index) of each backbone conv in the
# reference's LPIPS wrappers.
_LPIPS_SLICES = {
    "alex": ((1, 0), (2, 3), (3, 6), (4, 8), (5, 10)),
    "vgg": ((1, 0), (1, 2), (2, 5), (2, 7), (3, 10), (3, 12), (3, 14),
            (4, 17), (4, 19), (4, 21), (5, 24), (5, 26), (5, 28)),
}


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _conv_t_as_conv(w: np.ndarray) -> np.ndarray:
    """Stride-1 ConvTranspose2d (I, O, kh, kw) -> the OIHW conv it is."""
    return w.transpose(1, 0, 2, 3)[:, :, ::-1, ::-1]


def _norm(v: np.ndarray) -> np.ndarray:
    return v.reshape(-1)


def convert_state_dict(sd: Dict, n_residual_blocks: int = 9,
                       density_filters: int = 4,
                       has_discriminator: Optional[bool] = None
                       ) -> Tuple[StateDict, StateDict]:
    """The reference `model_state_dict` (tensors or numpy arrays) ->
    (state_dict of `models.hific.HiFiC`, state_dict of
    `models.discriminator.Discriminator` with each SNConv's `u`, empty
    without a discriminator), float32 CPU tensors."""
    # np.array copies: a tensor's .numpy() shares memory with the live
    # module, whose spectral norm updates weight_u in place on a forward.
    sd = {k: np.array(v.numpy() if hasattr(v, "numpy") else v)
          for k, v in sd.items()}
    p: Dict[str, np.ndarray] = {}

    def conv(ours: str, theirs: str) -> None:
        p[f"{ours}.weight"] = sd[f"{theirs}.weight"]
        p[f"{ours}.bias"] = sd[f"{theirs}.bias"]

    def norm(ours: str, theirs: str) -> None:
        p[f"{ours}.gamma"] = _norm(sd[f"{theirs}.gamma"])
        p[f"{ours}.beta"] = _norm(sd[f"{theirs}.beta"])

    # Encoder: [pad, Conv2d, ChannelNorm, act] blocks.
    conv("encoder.conv_stem", "Encoder.conv_block1.1")
    norm("encoder.norm_stem", "Encoder.conv_block1.2")
    for i in range(4):
        conv(f"encoder.conv_down{i}", f"Encoder.conv_block{i + 2}.1")
        norm(f"encoder.norm_down{i}", f"Encoder.conv_block{i + 2}.2")
    conv("encoder.conv_out", "Encoder.conv_block_out.1")

    # Generator.
    norm("generator.norm_in", "Generator.conv_block_init.0")
    conv("generator.conv_head", "Generator.conv_block_init.2")
    norm("generator.norm_head", "Generator.conv_block_init.3")
    for m in range(n_residual_blocks):
        ours, theirs = f"generator.resblock_{m}", f"Generator.resblock_{m}"
        for c, n in (("conv1", "norm1"), ("conv2", "norm2")):
            conv(f"{ours}.{c}", f"{theirs}.{c}")
            norm(f"{ours}.{n}", f"{theirs}.{n}")
    for i in range(4):
        conv(f"generator.upconv{i}", f"Generator.upconv_block{i + 1}.0")
        norm(f"generator.norm_up{i}", f"Generator.upconv_block{i + 1}.1")
    conv("generator.conv_out", "Generator.conv_block_out.1")

    # Hyperprior transforms.
    for i in (1, 2, 3):
        conv(f"hyperprior.analysis_net.conv{i}",
             f"Hyperprior.analysis_net.conv{i}")
    if "Hyperprior.synthesis_DLMM_params.conv1.weight" in sd:
        # The DLMM variant: one synthesis head of C*K*3 mixture parameters.
        nets = (("synthesis_dlmm", "synthesis_DLMM_params"),)
        conv("hyperprior.synthesis_dlmm.conv_out",
             "Hyperprior.synthesis_DLMM_params.conv_out")
    else:
        nets = (("synthesis_mu", "synthesis_mu"),
                ("synthesis_std", "synthesis_std"))
    for ours, theirs in nets:
        for i in (1, 2):  # ConvTranspose2d, stride 2
            conv(f"hyperprior.{ours}.conv{i}", f"Hyperprior.{theirs}.conv{i}")
        p[f"hyperprior.{ours}.conv3.weight"] = _conv_t_as_conv(
            sd[f"Hyperprior.{theirs}.conv3.weight"])
        p[f"hyperprior.{ours}.conv3.bias"] = sd[
            f"Hyperprior.{theirs}.conv3.bias"]

    # Hyperlatent density.
    for k in range(density_filters):
        for leaf in ("H", "a", "b"):
            p[f"hyperprior.hyperlatent_density.{leaf}_{k}"] = sd[
                f"Hyperprior.hyperlatent_likelihood.{leaf}_{k}"]

    # Discriminator.
    disc: Dict[str, np.ndarray] = {}
    if has_discriminator is None:
        has_discriminator = "Discriminator.context_conv.weight" in sd
    if has_discriminator:
        for name in ("context_conv", "conv_out"):
            disc[f"{name}.weight"] = sd[f"Discriminator.{name}.weight"]
            disc[f"{name}.bias"] = sd[f"Discriminator.{name}.bias"]
        for i in (1, 2, 3, 4):
            theirs = f"Discriminator.conv{i}"
            disc[f"conv{i}.weight"] = sd[f"{theirs}.weight_orig"]
            disc[f"conv{i}.bias"] = sd[f"{theirs}.bias"]
            disc[f"conv{i}.u"] = sd[f"{theirs}.weight_u"]

    return ({k: _tensor(v) for k, v in p.items()},
            {k: _tensor(v) for k, v in disc.items()})


def lpips_state_dict_from_reference(sd: Dict, net: str = "alex",
                                    prefix: str = LPIPS_PREFIX
                                    ) -> Optional[StateDict]:
    """The calibrated LPIPS embedded in a reference checkpoint (backbone
    `{prefix}net.slice{K}.{i}.weight`, lin heads
    `{prefix}lin{k}.model.1.weight`) -> state_dict of
    `models.lpips.LPIPS(net)`, or None where the keys are absent."""
    if f"{prefix}lin0.model.1.weight" not in sd:
        return None

    def leaf(key: str) -> torch.Tensor:
        v = sd[prefix + key]
        return _tensor(np.array(v.numpy() if hasattr(v, "numpy") else v))

    first = 1 if net == "alex" else 0  # AlexNet's convs are conv1 .. conv5
    out = {}
    for k, (sl, fi) in enumerate(_LPIPS_SLICES[net]):
        for name in ("weight", "bias"):
            out[f"backbone.conv{k + first}.{name}"] = leaf(
                f"net.slice{sl}.{fi}.{name}")
    for k in range(5):
        out[f"lin{k}"] = leaf(f"lin{k}.model.1.weight").reshape(-1)
    return out


def load_reference_checkpoint(path: str, **kw
                              ) -> Tuple[StateDict, StateDict,
                                         Optional[StateDict]]:
    """Read a reference `.pt` checkpoint and convert it: (codec
    state_dict, discriminator state_dict, the embedded AlexNet LPIPS's
    state_dict or None). The file is read with `weights_only=False`:
    reference checkpoints pickle their `args`, so load only files from a
    source you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    lpips = lpips_state_dict_from_reference(sd)
    sd = {k: v for k, v in sd.items() if not k.startswith("perceptual_loss")}
    return convert_state_dict(sd, **kw) + (lpips,)
