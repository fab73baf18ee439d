"""The port's compress / decompress CLIs against the JAX package, and
`resolve_eval_checkpoint` on the three forms of `-ckpt`.

The port's CLIs run in-process on an exported `.npz` (the tiny config with
the port's seeded weights, written by its `export_params_npz` in the JAX
artifact layout) and PNGs (76x92 and 64x64), with `--no_lpips`.
They are held against the JAX `Codec` called directly on the same `.npz`
and pixels, as the JAX CLI calls it (its CLI run here costs ~55 s, most of
it compiling its device decoder): the `.hfc` files are byte-equal, PSNR in
`metrics.json` agrees within 1e-3 dB with the JAX package's `psnr` of its
reconstruction, and the port's PNGs are the JAX package's pixels within one
level (the float reconstructions agree within ~4e-6, so a pixel can
straddle a rounding boundary). The codec flags `--scalar_rans`,
`--coder_threads`, `--pipeline_chunk` and `--wire_chunk` write the JAX
`Codec`'s bytes under the same options.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from hific_tpu.codec import Codec as JaxCodec
from hific_tpu.config import mse_lpips_config
from hific_tpu.entropy import container as jax_container
from hific_tpu.entropy.container import save_compressed
from hific_tpu.training.checkpoints import load_params_npz
from hific_tpu.utils.metrics import psnr as jax_psnr
from hific_tpu_torch.cli import compress as compress_cli
from hific_tpu_torch.cli import decompress as decompress_cli
from hific_tpu_torch.config import Config
from hific_tpu_torch.models.hific import HiFiC, init_random_
from hific_tpu_torch.training import checkpoints
from hific_tpu_torch.training.train_step import create_train_state

TINY = dict(latent_channels=8, n_residual_blocks=1, hyperlatent_filters=16)
SIZES = ((76, 92), (64, 64))
PSNR_ATOL_DB = 1e-3


def _smooth_u8(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    img = np.stack([0.5 + 0.3 * np.sin(2 * np.pi * (rng.uniform(0.5, 2) * yy
                                                     + rng.uniform(0.5, 2) * xx)
                                       + rng.uniform(0, 6))
                    for _ in range(3)], -1)
    img += rng.normal(0, 0.02, img.shape)
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The exported tiny model, the PNGs, and per image the JAX `Codec`'s
    `.hfc` bytes, uint8 reconstruction and PSNR (as its CLI computes them:
    the PNG's pixels / 255 in, the uint8 reconstruction / 255 out), and
    the PSNR of its `reconstruct`."""
    root = tmp_path_factory.mktemp("cli")
    config = Config.from_json(mse_lpips_config(**TINY).to_json())
    model = init_random_(HiFiC(config), torch.Generator().manual_seed(0))
    npz = checkpoints.export_params_npz(str(root / "tiny.npz"), model, config)
    images = root / "imgs"
    images.mkdir()
    jax_out = root / "jax_out"
    jax_out.mkdir()
    codec = JaxCodec(*load_params_npz(npz))
    jax_rows = []
    for i, (h, w) in enumerate(SIZES):
        Image.fromarray(_smooth_u8(h, w, i)).save(images / f"img_{i}.png")
        x = np.asarray(Image.open(images / f"img_{i}.png"),
                       np.float32)[None] / 255.0
        out = codec.compress(x)
        save_compressed(out, str(jax_out / f"img_{i}.hfc"))
        recon = np.asarray(codec.decompress(out, as_uint8=True,
                                            device_decode=False))
        jax_rows.append({
            "recon": recon[0],
            "psnr": float(jax_psnr(x, recon.astype(np.float32) / 255.0)[0]),
            "rc_psnr": float(jax_psnr(x, codec.reconstruct(x))[0])})
    return dict(root=root, npz=npz, images=str(images), jax_out=jax_out,
                jax_rows=jax_rows, jax_codec=codec)


def _port_compress(setup, name, *extra):
    out = setup["root"] / name
    rows = compress_cli.main(["-ckpt", setup["npz"], "-i", setup["images"],
                              "-o", str(out), "--device", "cpu",
                              "--no_lpips", *extra])
    return out, rows


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _within_a_level(got, want):
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_compress_cli_bytes_and_psnr_equal_jax(setup):
    out, rows = _port_compress(setup, "port_out", "--save")
    assert len(rows) == len(SIZES)
    with open(out / "metrics.json") as f:
        assert json.load(f) == rows
    for i, (row, want) in enumerate(zip(rows, setup["jax_rows"])):
        assert os.path.basename(row["file"]) == f"img_{i}.png"
        assert (_read(out / f"img_{i}.hfc")
                == _read(setup["jax_out"] / f"img_{i}.hfc"))
        assert np.isfinite(row["psnr"])
        assert abs(row["psnr"] - want["psnr"]) <= PSNR_ATOL_DB
        assert "ms_ssim" not in row  # below 176 px
        _within_a_level(np.asarray(Image.open(out / f"img_{i}_recon.png")),
                        want["recon"])
    with open(out / "metrics.csv") as f:
        header = f.readline().strip().split(",")
        assert len(f.readlines()) == len(SIZES)
    assert header == list(rows[0])


def test_pipeline_groups_write_the_same_files_with_lpips(setup):
    """--pipeline 2 (compress_many / decompress_many) writes the per-image
    files; without --no_lpips each row has the uncalibrated LPIPS."""
    grouped = setup["root"] / "port_pipeline"
    rows = compress_cli.main(["-ckpt", setup["npz"], "-i", setup["images"],
                              "-o", str(grouped), "--device", "cpu",
                              "--pipeline", "2"])
    for i, row in enumerate(rows):
        assert "encode_s_group_avg" in row
        assert row["lpips"] >= 0.0 and row["lpips_calibrated"] is False
        assert (_read(grouped / f"img_{i}.hfc")
                == _read(setup["jax_out"] / f"img_{i}.hfc"))


def test_decompress_cli_matches_jax_pixels(setup):
    written = decompress_cli.main([
        "-ckpt", setup["npz"], "-i", str(setup["jax_out"]), "-o",
        str(setup["root"] / "port_dec"), "--device", "cpu",
        "--pipeline", "2"])
    assert [os.path.basename(p) for p in written] == [
        f"img_{i}.png" for i in range(len(SIZES))]
    for png, want in zip(written, setup["jax_rows"]):
        _within_a_level(np.asarray(Image.open(png)), want["recon"])


def test_reconstruct_rows_match_jax(setup):
    out, rows = _port_compress(setup, "port_rc", "-rc")
    for row, want in zip(rows, setup["jax_rows"]):
        assert np.isnan(row["actual_bpp"])
        assert abs(row["psnr"] - want["rc_psnr"]) <= PSNR_ATOL_DB
    assert not any(n.endswith(".hfc") for n in os.listdir(out))


@pytest.mark.parametrize("flag", [
    ["--spatial", "2"], ["--scalar_rans"], ["--coder_threads", "2"],
    ["--pipeline_chunk", "2"], ["--wire_chunk", "2"]])
def test_unported_flags_exit_nonzero(setup, flag):
    """`--spatial 2` exits for want of devices on the one CPU, with the JAX
    CLI's message. The codec's flags run: with `--pipeline 2`, so that the
    batch codec's chunks apply, each `.hfc` equals the JAX `Codec`'s
    built with the same options as the JAX CLI builds it (scalar streams,
    container v2; the chunks change no byte), and PSNR is finite."""
    if flag[0] == "--spatial":
        with pytest.raises(SystemExit) as e:
            compress_cli.main(["-ckpt", setup["npz"], "-i", setup["images"],
                               "-o", str(setup["root"] / "refused"),
                               "--device", "cpu", *flag])
        assert e.value.code not in (0, None)
        assert "--spatial 2 needs 2 devices; only 1 visible" in str(
            e.value.code)
        return
    out, rows = _port_compress(setup, "flag_" + flag[0][2:], "--pipeline",
                               "2", *flag)
    codec = setup["jax_codec"]
    codec.vectorize = flag[0] != "--scalar_rans"
    codec.coder_threads = 2 if flag[0] == "--coder_threads" else 1
    try:
        for i, row in enumerate(rows):
            assert np.isfinite(row["psnr"])
            x = np.asarray(Image.open(os.path.join(setup["images"],
                                                   f"img_{i}.png")),
                           np.float32)[None] / 255.0
            want = io.BytesIO()
            jax_container._save_to(want, codec.compress(x))
            assert _read(out / f"img_{i}.hfc") == want.getvalue()
    finally:
        codec.vectorize, codec.coder_threads = True, 1


def test_resolve_npz(setup):
    config, state = checkpoints.resolve_eval_checkpoint(setup["npz"])
    assert config.latent_channels == 8 and config.dtype == "float32"
    assert "encoder.conv_out.weight" in state


def test_resolve_trainer_directory(tmp_path):
    config = Config.from_json(mse_lpips_config(**TINY).to_json())
    state = create_train_state(config, seed=3, device="cpu")
    state.step = 7
    checkpoints.save_checkpoint(str(tmp_path), state, config)
    got_config, got = checkpoints.resolve_eval_checkpoint(str(tmp_path))
    assert got_config == config
    want = state.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_resolve_orbax_directory_names_the_export(tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        f.write(mse_lpips_config(**TINY).to_json())
    (tmp_path / "step_100").mkdir()
    with pytest.raises(SystemExit) as e:
        checkpoints.resolve_eval_checkpoint(str(tmp_path))
    assert "python -m hific_tpu.cli.export_params" in str(e.value.code)


def test_resolve_missing_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        checkpoints.resolve_eval_checkpoint(str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError):
        checkpoints.resolve_eval_checkpoint(str(tmp_path))
