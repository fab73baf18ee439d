"""Spatial partitioning in the port (`hific_tpu_torch/parallel/spatial.py`,
`Codec.compress_spatial` / `decompress_spatial`, the compress CLI's
`--spatial`) against the whole image and the JAX package's partitioned
programs, and `parallel.dryrun.dryrun_multichip`.

The tiny config (latent 8, 1 residual block, hyperlatent 16) with
JAX-initialised weights carried across by `weights.state_dict_from_jax`,
in fp32 on the CPU. The port's n-band mesh names the CPU n times (the
bands run in turn); the JAX package's is n of the 8 virtual CPU devices.
Within the port the bands equal the whole image bit for bit at 2 and 4
bands; against the JAX package's spatial codec on a 2-device mesh the
`.hfc` bytes are identical and the decodes agree within 1e-4 (float) and
one level (uint8), as the codec's tests hold them.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hific_tpu.codec import Codec as JaxCodec
from hific_tpu.config import mse_lpips_config
from hific_tpu.entropy import container as jax_container
from hific_tpu.models.hific import HiFiC as JaxHiFiC
from hific_tpu.parallel import spatial as jax_spatial
from hific_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hific_tpu_torch.cli import compress as compress_cli
from hific_tpu_torch.codec import Codec
from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy import container
from hific_tpu_torch.parallel.dryrun import dryrun_multichip
from hific_tpu_torch.parallel.mesh import make_mesh
from hific_tpu_torch.parallel.spatial import (
    make_spatial_map,
    pad_rows_for_mesh,
    replicate,
    spatial_encode_fn,
    spatial_generate_fn,
)
from hific_tpu_torch.training import checkpoints
from hific_tpu_torch.weights import state_dict_from_jax

FLOAT_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    cfg = mse_lpips_config(latent_channels=8, n_residual_blocks=1,
                           hyperlatent_filters=16)
    model = JaxHiFiC(cfg)
    init = jax.jit(lambda r: model.init({"params": r, "quantize": r},
                                        jnp.zeros((1, 64, 64, 3)),
                                        training=True)["params"])
    params = init(jax.random.PRNGKey(0))
    port = Codec(Config.from_json(cfg.to_json()),
                 state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            params)),
                 device="cpu")
    port.build_tables()
    return dict(cfg=cfg, model=model, params=params,
                jax_codec=JaxCodec(cfg, params),
                port=port)


def _cpu_mesh(n):
    return make_mesh(["cpu"] * n)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _hfc(out, writer=container) -> bytes:
    f = io.BytesIO()
    writer._save_to(f, out)
    return f.getvalue()


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_encoder_matches_whole(tiny, n):
    """256x128 image (the JAX test's), halo 64: n bands equal the whole
    image's latents exactly; a halo of 16 (under the 49 px receptive
    extent) does not."""
    port = tiny["port"]
    x = _nchw(np.random.RandomState(0).rand(1, 256, 128, 3).astype(
        np.float32))
    mesh = _cpu_mesh(n)
    enc = lambda m, t: m.encoder(t)  # noqa: E731
    with torch.inference_mode():
        want = port.model.encoder(x)
        got = spatial_encode_fn(enc, mesh, halo=64)(
            replicate(port.model, mesh), x)
        bad = spatial_encode_fn(enc, mesh, halo=16)(
            replicate(port.model, mesh), x)
    assert torch.equal(got, want)
    assert float((bad - want).abs().max()) > 1e-6


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_generator_matches_whole(tiny, n):
    """32x8 latents (the JAX test's), 8 latents of halo: n bands equal the
    whole generator's image exactly."""
    port = tiny["port"]
    lat = _nchw((np.random.RandomState(1).randn(1, 32, 8, 8) * 2).astype(
        np.float32))
    mesh = _cpu_mesh(n)
    gen = lambda m, t: m.generate(  # noqa: E731
        t, (t.shape[2] * 16, t.shape[3] * 16))
    with torch.inference_mode():
        want = gen(port.model, lat)
        got = spatial_generate_fn(gen, mesh, halo_latents=8)(
            replicate(port.model, mesh), lat)
    assert got.shape == want.shape == (1, 3, 512, 128)
    assert torch.equal(got, want)


def test_one_band_is_the_map_itself(tiny):
    x = _nchw(np.random.RandomState(2).rand(1, 48, 32, 3).astype(
        np.float32))
    mesh = _cpu_mesh(1)
    with torch.inference_mode():
        got = spatial_encode_fn(lambda m, t: m.encoder(t), mesh)(
            replicate(tiny["port"].model, mesh), x)
        assert torch.equal(got, tiny["port"].model.encoder(x))


def test_spatial_constraints():
    """The JAX package's asserts, with its messages."""
    mesh = _cpu_mesh(8)
    ident = {torch.device("cpu"): None}
    f = lambda m, t: t  # noqa: E731
    sp = make_spatial_map(f, mesh, scale=1, halo=4, downsample=True)
    with pytest.raises(AssertionError, match="not divisible"):
        sp(ident, torch.zeros((1, 1, 10, 4)))
    sp_big_halo = make_spatial_map(f, mesh, scale=1, halo=64,
                                   downsample=True)
    with pytest.raises(AssertionError, match="too small"):
        sp_big_halo(ident, torch.zeros((1, 1, 16, 4)))


@pytest.mark.parametrize("h", [40, 100])
def test_pad_rows_for_mesh_matches_jax(h):
    x = np.random.RandomState(3).rand(1, h, 5, 2).astype(np.float32)
    got, h0 = pad_rows_for_mesh(_nchw(x), _cpu_mesh(4), 16)
    want, jh0 = jax_spatial.pad_rows_for_mesh(
        jnp.asarray(x), jax_make_mesh(jax.devices()[:4]), 16)
    assert h0 == jh0 == h
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


SPATIAL_IMAGE = (256, 96)  # H a multiple of 4 * 16; windows fit at n = 4


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_codec_matches_whole(tiny, n):
    """`compress_spatial` writes `compress`'s `.hfc` bytes and
    `decompress_spatial` (8 latents of halo) returns `decompress`'s image
    bit for bit, float and uint8."""
    port = tiny["port"]
    x = np.random.RandomState(4).rand(1, *SPATIAL_IMAGE, 3).astype(
        np.float32)
    mesh = _cpu_mesh(n)
    out = port.compress_spatial(x, mesh)
    assert _hfc(out) == _hfc(port.compress(x))
    assert np.array_equal(port.decompress_spatial(out, mesh, halo_latents=8),
                          port.decompress(out))
    assert np.array_equal(
        port.decompress_spatial(out, mesh, halo_latents=8, as_uint8=True),
        port.decompress(out, as_uint8=True))


def test_spatial_codec_matches_jax(tiny):
    """Over 2 bands and JAX's 2-device mesh (JAX's `spatial_encode_fn` and
    `spatial_generate_fn` inside its codec's methods): the same `.hfc`
    bytes; decodes within 1e-4 (float) and one level (uint8). One mesh
    size only: JAX's partitioned programs take ~50 s to compile on the
    CPU, and the port's bands equal its whole image at 2 and 4."""
    port, jax_codec = tiny["port"], tiny["jax_codec"]
    x = np.random.RandomState(4).rand(1, *SPATIAL_IMAGE, 3).astype(
        np.float32)
    mesh, jmesh = _cpu_mesh(2), jax_make_mesh(jax.devices()[:2])
    out = port.compress_spatial(x, mesh)
    jout = jax_codec.compress_spatial(x, jmesh)
    assert _hfc(out) == _hfc(jout, jax_container)
    got = port.decompress_spatial(out, mesh, halo_latents=8)
    want = np.asarray(jax_codec.decompress_spatial(jout, jmesh,
                                                   halo_latents=8))
    np.testing.assert_allclose(got, want, atol=FLOAT_ATOL, rtol=0)
    got8 = port.decompress_spatial(out, mesh, halo_latents=8, as_uint8=True)
    want8 = np.asarray(jax_codec.decompress_spatial(
        jout, jmesh, halo_latents=8, as_uint8=True))
    assert got8.dtype == want8.dtype == np.uint8
    assert np.abs(got8.astype(int) - want8.astype(int)).max() <= 1


def test_decompress_spatial_falls_back_to_decompress(tiny):
    """A `compress` file of 3 latent rows (48 px) does not band over 2
    devices: `decompress_spatial` is `decompress`, bit for bit; so is a
    file whose bands are too few rows for the halo."""
    port = tiny["port"]
    rng = np.random.RandomState(5)
    small = port.compress(rng.rand(1, 48, 32, 3).astype(np.float32))
    assert np.array_equal(port.decompress_spatial(small, _cpu_mesh(2)),
                          port.decompress(small))
    short = port.compress(rng.rand(1, 64, 32, 3).astype(np.float32))
    assert np.array_equal(
        port.decompress_spatial(short, _cpu_mesh(2), halo_latents=16,
                                as_uint8=True),
        port.decompress(short, as_uint8=True))


def test_cli_spatial_writes_the_bytes_of_the_plain_run(tiny, tmp_path,
                                                       monkeypatch):
    """`--spatial 2` with the device enumeration giving two CPU devices
    writes the `.hfc` bytes and the PNG of the run without it (H a
    multiple of 32); it refuses --pipeline."""
    from PIL import Image

    port = tiny["port"]
    npz = checkpoints.export_params_npz(str(tmp_path / "tiny.npz"),
                                        port.model, port.config)
    images = tmp_path / "imgs"
    images.mkdir()
    rng = np.random.RandomState(6)
    Image.fromarray(rng.randint(0, 256, (256, 80, 3)).astype(
        np.uint8)).save(images / "a.png")
    monkeypatch.setattr(compress_cli, "visible_devices",
                        lambda kind: [torch.device(kind)] * 2)
    base = ["-ckpt", npz, "-i", str(images), "--device", "cpu",
            "--no_metrics", "--save"]
    compress_cli.main(base + ["-o", str(tmp_path / "plain")])
    compress_cli.main(base + ["-o", str(tmp_path / "sp"), "--spatial", "2"])
    for name in ("a.hfc", "a_recon.png"):
        assert ((tmp_path / "sp" / name).read_bytes()
                == (tmp_path / "plain" / name).read_bytes()), name
    with pytest.raises(SystemExit, match="mutually exclusive"):
        compress_cli.main(base + ["-o", str(tmp_path / "x"), "--spatial",
                                  "2", "--pipeline", "2"])


def test_dryrun_multichip_4(tmp_path):
    """Four ranks in the (2, 2) layout: a tiny GAN G step and D step, then
    the partitioned encoder and the spatial codec over two bands."""
    summary = dryrun_multichip(4, device="cpu", workdir=str(tmp_path))
    assert (summary["ranks"], summary["n_slices"], summary["bands"]) == (
        4, 2, 2)
    assert os.listdir(tmp_path) == []
