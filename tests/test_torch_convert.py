"""The port's checkpoint converters against the JAX package's.

A synthetic reference state dict (the reference's names and shapes, built
by `tests/test_convert_torch.py`'s helper, with the embedded LPIPS of
either net added) goes through the port's `utils/convert_torch.py` and
through the JAX package's conversion followed by `weights`' carry into
this package's layout: the tensors are bit-identical, for the codec, the
DLMM hyper synthesis, the discriminator with its spectral `u`, and LPIPS
alex and vgg. The port's `cli/convert.py` writes a trainer directory that
its compress CLI takes as `-ckpt` (LPIPS found beside it) to the JAX
`Codec`'s `.hfc` bytes on the JAX conversion of the same `.pt`; its
`cli/export_params.py` writes, in float32 and in float16, the leaf names,
dtypes and values of the JAX package's `export_params_npz` of the same
weights, which the JAX `load_params_npz` and the port's
`resolve_eval_checkpoint` read.

CPU only; ~70 s alone (the tiny model's 960-channel layers make each
compressed `.npz` ~80 MB of floats; the JAX LPIPS and codec compile).
"""

import argparse
import os

import numpy as np
import pytest
import torch
from PIL import Image

from hific_tpu.codec import Codec as JaxCodec
from hific_tpu.config import hific_config as jax_hific_config
from hific_tpu.entropy.container import save_compressed
from hific_tpu.models.lpips import (load_lpips_npz,
                                    lpips_params_from_reference_state)
from hific_tpu.training import checkpoints as jax_checkpoints
from hific_tpu.utils import convert_torch as jax_convert
from hific_tpu_torch.cli import compress as compress_cli
from hific_tpu_torch.cli import convert as convert_cli
from hific_tpu_torch.cli import export_params as export_cli
from hific_tpu_torch.config import Config
from hific_tpu_torch.models.hific import HiFiC
from hific_tpu_torch.models.discriminator import Discriminator
from hific_tpu_torch.models.lpips import LPIPS, load_lpips
from hific_tpu_torch.training import checkpoints
from hific_tpu_torch.utils import convert_torch
from hific_tpu_torch.weights import (disc_state_dict_from_jax,
                                     flatten_tree,
                                     lpips_state_dict_from_jax,
                                     state_dict_from_jax)
from tests.test_convert_torch import _synthetic_reference_state_dict

TINY = dict(latent_channels=8, n_residual_blocks=1, hyperlatent_filters=16)
LPIPS_SLICES = {  # (slice, torchvision index, out channels) of each conv
    "alex": ((1, 0, 64), (2, 3, 192), (3, 6, 384), (4, 8, 256),
             (5, 10, 256)),
    "vgg": ((1, 0, 64), (1, 2, 64), (2, 5, 128), (2, 7, 128), (3, 10, 256),
            (3, 12, 256), (3, 14, 256), (4, 17, 512), (4, 19, 512),
            (4, 21, 512), (5, 24, 512), (5, 26, 512), (5, 28, 512)),
}


def _with_lpips(sd, net, seed=1):
    """`sd` plus the reference's embedded LPIPS of `net`: backbone
    `perceptual_loss.model.net.net.slice{K}.{i}.*`, heads
    `perceptual_loss.model.net.lin{k}.model.1.weight`."""
    rng = np.random.RandomState(seed)
    sd = dict(sd)
    prefix = convert_torch.LPIPS_PREFIX
    c_in, taps = 3, []
    for sl, idx, c in LPIPS_SLICES[net]:
        k = {0: 11, 3: 5}.get(idx, 3) if net == "alex" else 3
        sd[f"{prefix}net.slice{sl}.{idx}.weight"] = (
            rng.randn(c, c_in, k, k).astype(np.float32) * 0.05)
        sd[f"{prefix}net.slice{sl}.{idx}.bias"] = rng.randn(c).astype(
            np.float32) * 0.05
        c_in = c
        if not taps or taps[-1][0] != sl:
            taps.append([sl, c])
        taps[-1][1] = c
    for k, (_, c) in enumerate(taps):
        sd[f"{prefix}lin{k}.model.1.weight"] = rng.rand(1, c, 1, 1).astype(
            np.float32)
    return sd


def _dlmm(sd):
    """`sd` with the DLMM hyper synthesis in place of mu / std."""
    rng = np.random.RandomState(2)
    sd = {k: v for k, v in sd.items()
          if not k.startswith(("Hyperprior.synthesis_mu",
                               "Hyperprior.synthesis_std"))}
    c, n = 8, 16
    pre = "Hyperprior.synthesis_DLMM_params"
    for name, shape in (("conv1", (n, n, 5, 5)), ("conv2", (n, n, 5, 5)),
                        ("conv3", (n, c, 3, 3)),
                        ("conv_out", (c * 12, c, 1, 1))):
        sd[f"{pre}.{name}.weight"] = rng.randn(*shape).astype(np.float32)
        sd[f"{pre}.{name}.bias"] = rng.randn(shape[0] if name == "conv_out"
                                             else shape[1]).astype(np.float32)
    return sd


def _assert_bit_identical(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("case", ["codec", "dlmm", "discriminator",
                                  "lpips_alex", "lpips_vgg"])
def test_converted_tensors_equal_jax_conversion(case):
    """Bit for bit against the JAX package's `convert_state_dict` /
    `lpips_params_from_reference_state`, carried across by
    `state_dict_from_jax`, `disc_state_dict_from_jax` and
    `lpips_state_dict_from_jax`."""
    sd = _synthetic_reference_state_dict()
    if case.startswith("lpips"):
        net = case.split("_")[1]
        sd = _with_lpips(sd, net)
        got = convert_torch.lpips_state_dict_from_reference(sd, net)
        want = lpips_state_dict_from_jax(
            lpips_params_from_reference_state(sd, net))
        _assert_bit_identical(got, want)
        LPIPS(net).load_state_dict(got)
        return
    if case == "dlmm":
        sd = _dlmm(sd)
    params, disc, spectral = jax_convert.convert_state_dict(
        sd, n_residual_blocks=1)
    model_sd, disc_sd = convert_torch.convert_state_dict(
        sd, n_residual_blocks=1)
    if case == "discriminator":
        _assert_bit_identical(disc_sd, disc_state_dict_from_jax(disc,
                                                                spectral))
        Discriminator(8).load_state_dict(disc_sd)
        return
    _assert_bit_identical(model_sd, state_dict_from_jax(params))
    config = Config(use_latent_mixture_model=case == "dlmm",
                    latent_channels_dlmm=8, **TINY)
    HiFiC(config).load_state_dict(model_sd)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A reference `.pt` (the synthetic state dict with AlexNet's LPIPS and
    pickled args), the port's CLI conversion of it, and the JAX package's
    conversion."""
    root = tmp_path_factory.mktemp("convert")
    sd = _with_lpips(_synthetic_reference_state_dict(), "alex")
    pt = str(root / "reference.pt")
    torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                     for k, v in sd.items()},
                "args": argparse.Namespace(regime="med")}, pt)
    out_dir = str(root / "converted")
    path = convert_cli.main(["-pt", pt, "-o", out_dir, "--latent_channels",
                             "8", "--n_residual_blocks", "1",
                             "--hyperlatent_filters", "16", "--device",
                             "cpu"])
    assert os.path.basename(path) == "step_0.pt"
    params, _, _, lpips_params = jax_convert.load_reference_checkpoint(
        pt, n_residual_blocks=1)
    return dict(root=root, out_dir=out_dir, params=params,
                lpips_params=lpips_params,
                jax_config=jax_hific_config(regime="med", **TINY),
                state=checkpoints.resolve_eval_checkpoint(out_dir)[1])


def test_converted_directory_compresses_to_jax_bytes(converted):
    """The compress CLI on the converted directory (its LPIPS found as
    `lpips.npz` beside the checkpoint) writes the JAX `Codec`'s bytes for a
    64x64 PNG; the LPIPS file holds JAX's leaves of the same checkpoint."""
    root = converted["root"]
    images = root / "imgs"
    images.mkdir()
    rng = np.random.RandomState(3)
    Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(
        images / "img.png")
    x = np.asarray(Image.open(images / "img.png"), np.float32)[None] / 255.0
    jax_codec = JaxCodec(converted["jax_config"], converted["params"])
    save_compressed(jax_codec.compress(x), str(root / "jax.hfc"))
    rows = compress_cli.main(["-ckpt", converted["out_dir"], "-i",
                              str(images), "-o", str(root / "out"),
                              "--device", "cpu"])
    assert (root / "out" / "img.hfc").read_bytes() == (
        root / "jax.hfc").read_bytes()
    assert np.isfinite(rows[0]["lpips"])

    npz = os.path.join(converted["out_dir"], "lpips.npz")
    _, calibrated = load_lpips(npz)
    assert calibrated
    want = flatten_tree(converted["lpips_params"])
    got = flatten_tree(load_lpips_npz(npz))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("f16", [False, True])
def test_export_params_writes_the_jax_artifact(converted, f16):
    """`cli/export_params.py` on the converted directory against the JAX
    package's `export_params_npz` of its conversion: the same leaf names,
    dtypes and values (float32 exact; float16 the rounded values), a
    config the JAX package reads as its own, and a `.npz` that
    `resolve_eval_checkpoint` restores."""
    root = converted["root"]
    name = "f16" if f16 else "f32"
    out = export_cli.main(["-ckpt", converted["out_dir"], "-o",
                           str(root / f"port_{name}.npz"), "--device", "cpu"]
                          + (["--f16"] if f16 else []))
    want_path = jax_checkpoints.export_params_npz(
        str(root / f"jax_{name}.npz"), converted["params"],
        converted["jax_config"], cast_floats=np.float16 if f16 else None)
    with np.load(out) as got, np.load(want_path) as want:
        leaves = [k for k in want.files if k.startswith("p:")]
        assert sorted(got.files) == sorted(want.files)
        for k in leaves:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jax_config, params = jax_checkpoints.load_params_npz(out)
    assert jax_config == converted["jax_config"]
    assert set(flatten_tree(params)) == {k[2:] for k in leaves}
    config, state = checkpoints.resolve_eval_checkpoint(out)
    assert config == Config.from_json(converted["jax_config"].to_json())
    for k, t in converted["state"].items():
        rounded = t.half().float() if f16 else t
        assert torch.equal(state[k], rounded), k
