"""The port's image metrics, evaluation dataset and image I/O against the
JAX package's.

`psnr`, `ssim` and `ms_ssim` of `hific_tpu_torch.utils.metrics` equal the
JAX package's within 1e-5 relative on seeded arrays (both in float32; the
blurs sum in another order). `EvalDataset` yields the JAX one's arrays,
bpp and paths. Image I/O goes through Pillow on both sides (the card's
machine has it), so `image_io` is held against Pillow's own decode.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hific_tpu.training.data import EvalDataset as JaxEvalDataset
from hific_tpu.utils import metrics as jax_metrics
from hific_tpu_torch.training.data import EvalDataset
from hific_tpu_torch.utils import image_io, metrics
from hific_tpu_torch.utils.logging import setup_logger

RTOL = 1e-5


def _pair(shape, seed, noise):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["psnr", "ssim", "ms_ssim"])
@pytest.mark.parametrize("shape,noise", [((2, 180, 200, 3), 0.05),
                                         ((1, 192, 176, 3), 0.2)])
def test_metric_matches_jax(name, shape, noise):
    a, b = _pair(shape, seed=shape[1], noise=noise)
    want = np.asarray(getattr(jax_metrics, name)(jnp.asarray(a),
                                                 jnp.asarray(b)))
    got = getattr(metrics, name)(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", ["psnr", "ssim"])
def test_metric_max_val_and_numpy_uint8_inputs(name):
    """[0, 255] images given as numpy uint8 and max_val 255 (computed in
    float32 whatever the dtype)."""
    a, b = _pair((1, 40, 48, 3), seed=3, noise=0.1)
    a8, b8 = (np.round(v * 255).astype(np.uint8) for v in (a, b))
    want = np.asarray(getattr(jax_metrics, name)(a8, b8, max_val=255.0))
    got = getattr(metrics, name)(a8, b8, max_val=255.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def test_identical_images():
    a, _ = _pair((1, 176, 176, 3), seed=1, noise=0.0)
    assert torch.isinf(metrics.psnr(a, a)).all()
    np.testing.assert_allclose(metrics.ms_ssim(a, a).numpy(), 1.0, rtol=1e-6)


def _write_pngs(root):
    rng = np.random.RandomState(0)
    paths = []
    for name, mode, shape in (("a_rgb.png", "RGB", (30, 41, 3)),
                              ("b_gray.png", "L", (17, 23)),
                              ("c_rgba.png", "RGBA", (25, 19, 4))):
        path = root / name
        Image.fromarray((rng.rand(*shape) * 255).astype(np.uint8),
                        mode).save(path)
        paths.append(str(path))
    (root / "d_broken.png").write_bytes(b"not an image")
    return paths


@pytest.mark.parametrize("normalize", [False, True])
def test_eval_dataset_matches_jax(tmp_path, normalize):
    _write_pngs(tmp_path)
    got = list(EvalDataset(str(tmp_path), normalize=normalize))
    want = list(JaxEvalDataset(str(tmp_path), normalize=normalize))
    assert len(got) == len(want) == 3  # the broken file is skipped
    for (x, bpp, path), (jx, jbpp, jpath) in zip(got, want):
        assert x.dtype == np.float32 and x.shape == jx.shape
        np.testing.assert_array_equal(x, jx)
        assert bpp == jbpp and path == jpath


def test_image_io_reads_what_pillow_reads(tmp_path):
    """Gray, RGB and RGBA PNGs read as Pillow's RGB conversion, from a
    file and from bytes."""
    for path in _write_pngs(tmp_path):
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB"))
        got = image_io.read_image(path)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        with open(path, "rb") as f:
            np.testing.assert_array_equal(image_io.decode_image(f.read()),
                                          want)


def test_png_written_reads_back_and_floats_quantize_as_jax(tmp_path):
    rng = np.random.RandomState(1)
    img = (rng.rand(13, 29, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        image_io.decode_image(image_io.encode_png(img)), img)
    x = rng.rand(13, 29, 3).astype(np.float32)
    path = str(tmp_path / "f.png")
    image_io.write_png(path, x)
    # The JAX CLIs' save_png: round(x * 255), clipped.
    want = np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)


def test_setup_logger_once(tmp_path):
    name = "hific_tpu_torch.test_logger"
    logger = setup_logger(str(tmp_path), name=name)
    try:
        assert logger.level == logging.INFO and not logger.propagate
        assert len(logger.handlers) == 2
        assert setup_logger(None, name=name) is logger
        assert len(logger.handlers) == 2
        logger.info("hello")
        for h in logger.handlers:
            h.flush()
        assert "hello" in (tmp_path / "train.log").read_text()
    finally:
        for h in list(logger.handlers):
            h.close()
            logger.removeHandler(h)


@pytest.mark.parametrize("kind", ["params_npz", "backbone_path"])
def test_lpips_weight_files_match_jax(tmp_path, kind):
    """`load_lpips` reads the two files the compress CLI takes as the JAX
    package's `build_lpips_fn` reads them: its full LPIPS snapshot
    (--lpips_weights) and a torchvision AlexNet `.features` state_dict
    (--lpips_backbone_path, beside the packaged lin heads); the same
    distances within 1e-5 relative, and both called calibrated."""
    from hific_tpu.models.lpips import build_lpips_fn, default_lpips_params
    from hific_tpu.models.lpips import save_lpips_npz
    from hific_tpu_torch.models.lpips import load_lpips

    if kind == "params_npz":
        path = str(tmp_path / "lpips.npz")
        save_lpips_npz(path, default_lpips_params(backbone_seed=3))
    else:
        path = str(tmp_path / "alexnet_features.pth")
        gen = torch.Generator().manual_seed(3)
        shapes = {0: (64, 3, 11, 11), 3: (192, 64, 5, 5),
                  6: (384, 192, 3, 3), 8: (256, 384, 3, 3),
                  10: (256, 256, 3, 3)}
        torch.save({f"{i}.{leaf}": torch.randn(*(s if leaf == "weight"
                                                  else s[:1]),
                                                generator=gen) * 0.05
                    for i, s in shapes.items()
                    for leaf in ("weight", "bias")}, path)
    jax_fn, jax_calibrated = build_lpips_fn(**{kind: path})
    model, calibrated = load_lpips(**{kind: path})
    assert calibrated and jax_calibrated
    a, b = _pair((2, 64, 72, 3), seed=4, noise=0.1)
    want = np.asarray(jax_fn(jnp.asarray(a), jnp.asarray(b),
                             normalize=True)).reshape(-1)
    with torch.no_grad():
        got = model(torch.from_numpy(a).permute(0, 3, 1, 2),
                    torch.from_numpy(b).permute(0, 3, 1, 2),
                    normalize=True).reshape(-1).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
