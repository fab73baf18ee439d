"""The port's LPIPS VGG16 path, its 2AFC head and `CityScapesDataset`
against the JAX package's.

- `LPIPS("vgg")` on the JAX package's seeded VGG16 backbone and the
  packaged VGG lin heads, carried across with `lpips_state_dict_from_jax`:
  distances of two seeded 64x64 pairs within 1e-5 relative.
- `Dist2LogitLayer` from a seeded reference state dict (1x1 convs
  `model.0/2/4`) and `bce_ranking_loss` within 1e-6.
- `load_lpips(net="vgg")` reads a JAX-saved LPIPS `.npz` and a
  torchvision VGG16 `.features` state_dict (its 13 convs by torchvision
  index); `save_lpips_npz` writes what the JAX package's `load_lpips_npz`
  reads back.
- `CityScapesDataset` on a synthetic `leftImg8bit/<split>/<city>/*.png`
  tree, and on a root without that layout: the JAX package's files, and
  the port's `TrainDataset` batches over them.

CPU only; ~25 s alone (most of it the JAX VGG16's initialisation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hific_tpu.models.lpips import LPIPS as JaxLPIPS
from hific_tpu.models.lpips import Dist2LogitLayer as JaxDist2Logit
from hific_tpu.models.lpips import bce_ranking_loss as jax_bce_ranking_loss
from hific_tpu.models.lpips import (default_lpips_params,
                                    load_lpips_npz,
                                    load_torch_dist2logit_weights as
                                    jax_load_dist2logit,
                                    save_lpips_npz as jax_save_lpips_npz)
from hific_tpu.training.data import CityScapesDataset as JaxCityScapes
from hific_tpu_torch.models.lpips import (LPIPS, TORCHVISION_FEATURES,
                                          VGG_CHNS, Dist2LogitLayer,
                                          bce_ranking_loss, default_lpips,
                                          load_lpips,
                                          load_torch_dist2logit_weights,
                                          save_lpips_npz)
from hific_tpu_torch.training.data import CityScapesDataset, TrainDataset
from hific_tpu_torch.weights import flatten_tree, lpips_state_dict_from_jax

LPIPS_RTOL = 1e-5
HEAD_TOL = 1e-6


@pytest.fixture(scope="module")
def vgg_params():
    return jax.tree_util.tree_map(
        np.asarray, default_lpips_params("vgg", backbone_seed=0))


def _images(seed, shape=(2, 64, 64, 3)):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_vgg_lpips_matches_jax(vgg_params):
    """The distances of two pairs within 1e-5 relative."""
    a, b = _images(0)
    want = np.asarray(jax.jit(lambda p, x, y: JaxLPIPS(net="vgg").apply(
        {"params": p}, x, y, normalize=True))(
            vgg_params, jnp.asarray(a), jnp.asarray(b))).reshape(-1)
    model = LPIPS("vgg")
    model.load_state_dict(lpips_state_dict_from_jax(vgg_params))
    with torch.no_grad():
        got = model(_nchw(a), _nchw(b), normalize=True)
    assert got.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(got.reshape(-1).numpy(), want,
                               rtol=LPIPS_RTOL, atol=0)


def test_dist2logit_and_bce_ranking_loss_match_jax():
    """The reference's Dist2LogitLayer weights (seeded) in both stacks: the
    preference scores and the BCE ranking loss within 1e-6."""
    gen = torch.Generator().manual_seed(0)
    torch_state = {}
    for idx, (o, i) in zip((0, 2, 4), ((32, 5), (32, 32), (1, 32))):
        torch_state[f"model.{idx}.weight"] = torch.randn(o, i, 1, 1,
                                                         generator=gen) * 0.3
        torch_state[f"model.{idx}.bias"] = torch.randn(o, generator=gen) * 0.1
    rng = np.random.RandomState(1)
    d0, d1 = (rng.rand(6, 1, 1, 1).astype(np.float32) for _ in range(2))
    judge = rng.uniform(-1, 1, (6, 1, 1, 1)).astype(np.float32)

    head = JaxDist2Logit()
    params = head.init(jax.random.PRNGKey(0), jnp.asarray(d0),
                       jnp.asarray(d1))["params"]
    params = jax_load_dist2logit(
        params, {k: v.numpy() for k, v in torch_state.items()})
    logit_j = head.apply({"params": params}, jnp.asarray(d0), jnp.asarray(d1))
    loss_j = jax_bce_ranking_loss(logit_j, jnp.asarray(judge))

    layer = load_torch_dist2logit_weights(Dist2LogitLayer(), torch_state)
    with torch.no_grad():
        logit_t = layer(torch.from_numpy(d0), torch.from_numpy(d1))
        loss_t = bce_ranking_loss(logit_t, torch.from_numpy(judge))
    np.testing.assert_allclose(logit_t.numpy(), np.asarray(logit_j),
                               rtol=0, atol=HEAD_TOL)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=HEAD_TOL)


def test_load_lpips_vgg_files(vgg_params, tmp_path):
    """A JAX-saved LPIPS `.npz` loads as those parameters; a torchvision
    VGG16 `.features` state_dict fills the 13 convs by torchvision index
    beside the packaged heads; `save_lpips_npz` round-trips through the
    JAX package's `load_lpips_npz`."""
    npz = str(tmp_path / "lpips_vgg.npz")
    jax_save_lpips_npz(npz, vgg_params)
    model, calibrated = load_lpips(npz, net="vgg")
    assert calibrated
    want = lpips_state_dict_from_jax(vgg_params)
    assert all(torch.equal(t, want[k]) for k, t in model.state_dict().items())

    gen = torch.Generator().manual_seed(2)
    features = {}
    convs = list(default_lpips(0, "vgg").backbone.children())
    for conv, idx in zip(convs, TORCHVISION_FEATURES["vgg"]):
        features[f"{idx}.weight"] = torch.randn(conv.weight.shape,
                                                generator=gen)
        features[f"{idx}.bias"] = torch.randn(conv.bias.shape, generator=gen)
    pth = str(tmp_path / "vgg16_features.pth")
    torch.save(features, pth)
    model, calibrated = load_lpips(backbone_path=pth, net="vgg")
    assert calibrated
    for k, conv in enumerate(model.backbone.children()):
        idx = TORCHVISION_FEATURES["vgg"][k]
        assert torch.equal(conv.weight, features[f"{idx}.weight"])
        assert torch.equal(conv.bias, features[f"{idx}.bias"])
    with np.load("hific_tpu_torch/assets/lpips_lin_vgg.npz") as lin:
        for k, c in enumerate(VGG_CHNS):
            assert torch.equal(getattr(model, f"lin{k}"),
                               torch.from_numpy(lin[f"lin{k}"]))

    out = str(tmp_path / "port_vgg.npz")
    save_lpips_npz(out, model)
    back = flatten_tree(load_lpips_npz(out))
    assert set(back) == set(flatten_tree(vgg_params))
    model_back = LPIPS("vgg")
    model_back.load_state_dict(lpips_state_dict_from_jax(back))
    assert all(torch.equal(t, model.state_dict()[k])
               for k, t in model_back.state_dict().items())


def _png_tree(root, paths):
    for i, rel in enumerate(paths):
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        img = np.random.RandomState(i).randint(0, 256, (72, 80, 3))
        Image.fromarray(img.astype(np.uint8)).save(path)


@pytest.mark.parametrize("layout", ["leftImg8bit", "fallback"])
def test_cityscapes_dataset(tmp_path, layout):
    """`<root>/leftImg8bit/train/<city>/*.png` (the val split's files left
    out), or `root` itself without that layout: the JAX package's files,
    and the batches of the port's `TrainDataset` over them."""
    if layout == "leftImg8bit":
        _png_tree(tmp_path, ["leftImg8bit/train/aachen/a_000000.png",
                             "leftImg8bit/train/aachen/a_000001.png",
                             "leftImg8bit/train/bremen/b_000000.png",
                             "leftImg8bit/val/lindau/l_000000.png"])
        split_dir = tmp_path / "leftImg8bit" / "train"
    else:
        _png_tree(tmp_path, ["x/one.png", "two.png"])
        split_dir = tmp_path
    data = CityScapesDataset(str(tmp_path), split="train", crop_size=48,
                             seed=3)
    assert data.files == JaxCityScapes(str(tmp_path), crop_size=48).files
    assert len(data.files) == 3 if layout == "leftImg8bit" else 2
    assert all("val" not in f for f in data.files)
    got = next(data.batches(2, num_workers=1))
    want = next(TrainDataset(str(split_dir), crop_size=48, seed=3).batches(
        2, num_workers=1))
    assert got[0].dtype == np.uint8 and got[0].shape == (2, 48, 48, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
