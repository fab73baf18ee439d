"""The port's trainer CLI (`hific_tpu_torch.cli.train`) on the CPU, tiny
config: the GAN stage warmstarted from a compression run, an exact resume,
the held-out evaluation against the JAX package's `make_eval_step`, the
threaded crop loader, and the LPIPS weight files.

Everything runs on synthetic PNGs written by the tests, in fp32 on the CPU;
tolerances are stated at each test.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hific_tpu.models.hyperprior as jax_hyperprior_module
import hific_tpu_torch.models.hyperprior as hyperprior_module
from hific_tpu.config import mse_lpips_config as jax_mse_lpips_config
from hific_tpu.models.lpips import LPIPS as JaxLPIPS
from hific_tpu.models.lpips import default_lpips_params, save_lpips_npz
from hific_tpu.training import train_step as jax_train_step
from hific_tpu.training.data import TrainDataset as JaxTrainDataset
from hific_tpu_torch.cli import train as train_cli
from hific_tpu_torch.models.lpips import ALEX_CHNS, default_lpips, load_lpips
from hific_tpu_torch.training.data import TrainDataset
from hific_tpu_torch.training.train_step import create_train_state
from hific_tpu_torch.weights import jax_params_from_model

SEED = 42  # the CLI's default --seed
TINY_FLAGS = ["-bs", "2", "-crop", "64", "--latent_channels", "8",
              "--n_residual_blocks", "1", "--hyperlatent_filters", "16",
              "--device", "cpu", "--seed", str(SEED)]
COMP_DIR = "hific_tpu_torch_v0.1_compression_low"
GAN_DIR = "hific_tpu_torch_v0.1_compression_gan_low"


def _write_pngs(directory, n=3, seed=6):
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(directory, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (72 + 8 * i, 90, 3),
                                    dtype=np.uint8)).save(
            os.path.join(directory, f"im{i}.png"))
    return str(directory)


def _nested(flat):
    tree = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(leaf)
    return tree


# Quantization noise by NHWC shape, the same on both sides (the eval's
# noisy rate estimate draws it too), as tests/test_torch_train.py shares it.
_NOISE_RNG = np.random.RandomState(9)
NOISE = {shape: _NOISE_RNG.uniform(-0.5, 0.5, shape).astype(np.float32)
         for shape in ((2, 1, 1, 16), (2, 4, 4, 8))}


def _port_noise(x, generator):
    nhwc = (x.shape[0], x.shape[2], x.shape[3], x.shape[1])
    return x + torch.from_numpy(NOISE[nhwc]).permute(0, 3, 1, 2).to(x.device)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every run here on one CPU thread: the exact-resume test needs it
    (the CPU backward's threaded reductions round differently from run to
    run), and on one thread the tiny runs do not crowd out the test
    processes beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def compression_run(one_thread, tmp_path_factory):
    """One compression step through the CLI, on the shared noise, with a
    held-out batch and the JAX package's seeded LPIPS parameters as an
    `--lpips_weights` file: (root, data dir, eval dir, lpips params, lpips
    npz, final state)."""
    root = tmp_path_factory.mktemp("train_cli")
    data = _write_pngs(root / "data")
    held_out = _write_pngs(root / "eval", n=2, seed=7)
    lpips_params = default_lpips_params("alex", backbone_seed=0)
    npz = str(root / "lpips.npz")
    save_lpips_npz(npz, lpips_params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hyperprior_module, "quantize_noise", _port_noise)
        state = train_cli.run(train_cli.parse_args(TINY_FLAGS + [
            "-d", data, "--eval_dataset_path", held_out,
            "--lpips_weights", npz, "--steps", "1", "--log_interval", "2",
            "--experiments_dir", str(root / "exp")]))
    return root, data, held_out, lpips_params, npz, state


def test_eval_writes_scalars_and_reconstructions_like_jax(compression_run,
                                                          monkeypatch):
    """At step 1: `train/` and `test/` scalars in tensorboard/metrics.jsonl
    and reconstructions/step_1.png (the input | reconstruction grid); the
    test scalars within rtol 1e-4 of the JAX package's make_eval_step on
    the port's weights after step 1 and the same held-out batch, noise and
    LPIPS parameters (loaded from the --lpips_weights file)."""
    root, _, held_out, lpips_params, _, state = compression_run
    exp = root / "exp" / COMP_DIR
    with open(exp / "tensorboard" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    train = [r for r in rows if "train/weighted_compression_loss" in r]
    test = [r for r in rows if "test/weighted_compression_loss" in r]
    assert [r["step"] for r in train] == [1] and [r["step"] for r in test] \
        == [1]
    from PIL import Image

    with Image.open(exp / "reconstructions" / "step_1.png") as im:
        assert im.size == (128, 128)

    batch = next(TrainDataset(held_out, 64, SEED + 1).batches(
        2, num_workers=1))[0]
    cfg = jax_mse_lpips_config(latent_channels=8, n_residual_blocks=1,
                               hyperlatent_filters=16, crop_size=64,
                               batch_size=2)
    monkeypatch.setattr(jax_hyperprior_module, "quantize_noise",
                        lambda x, rng: x + jnp.asarray(NOISE[tuple(x.shape)]))
    net = JaxLPIPS(net="alex")
    eval_fn = jax_train_step.make_eval_step(
        cfg, lambda g, r: net.apply({"params": lpips_params}, g, r,
                                    normalize=True))
    diag_j, _ = jax.jit(lambda p, x: eval_fn(
        types.SimpleNamespace(params=p, step=1), x,
        jax.random.PRNGKey(SEED + 2)))(
        _nested(jax_params_from_model(state.model)), jnp.asarray(batch))
    got = {k[len("test/"):]: v for k, v in test[0].items()
           if k.startswith("test/")}
    assert set(got) == set(diag_j)
    for k, v in diag_j.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def _snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def test_gan_stage_warmstarts_from_a_compression_run(compression_run,
                                                     monkeypatch):
    """-mt compression_gan from the compression run's step_1.pt, over the
    PNGs (threaded loader): the first G step starts from the source's codec
    parameters and step with a fresh discriminator (the seeded one, D count
    0, no Adam state); the run alternates G and D steps, and its final
    checkpoint holds the discriminator with its u, its optimizer and the D
    count."""
    root, data, _, _, npz, _ = compression_run
    source = str(root / "exp" / COMP_DIR / "checkpoints" / "step_1.pt")
    seen, calls = {}, []
    make_g = train_cli.make_train_step_g

    def spying_g(config, lpips_fn):
        step = make_g(config, lpips_fn)

        def first(state, x):
            if not seen:
                seen.update(step=state.step, disc_steps=state.disc_steps,
                            codec=_snapshot(state.model),
                            disc=_snapshot(state.disc),
                            disc_adam=dict(state.disc_optimizer.state))
            return step(state, x)
        return first

    monkeypatch.setattr(train_cli, "make_train_step_g", spying_g)
    state = train_cli.run(
        train_cli.parse_args(TINY_FLAGS + [
            "-d", data, "-mt", "compression_gan", "--warmstart_ckpt", source,
            "--lpips_weights", npz, "--steps", "3", "--log_interval", "2",
            "--experiments_dir", str(root / "exp")]),
        on_step=lambda s, d: calls.append(("D" if "disc_loss" in d else "G",
                                           s.step, s.disc_steps)))
    payload = torch.load(source, weights_only=True)
    assert seen["step"] == payload["step"] == 1
    for k, v in payload["model"].items():
        assert torch.equal(seen["codec"][k], v), k
    fresh = create_train_state(state.model.config, SEED, "cpu")
    for k, v in fresh.disc.state_dict().items():
        assert torch.equal(seen["disc"][k], v), k
    assert seen["disc_steps"] == 0 and not seen["disc_adam"]

    assert calls == [("G", 2, 0), ("D", 2, 1), ("G", 3, 1), ("D", 3, 2)]
    final = torch.load(root / "exp" / GAN_DIR / "checkpoints" / "step_3.pt",
                       weights_only=True)
    assert final["disc_steps"] == 2 and final["step"] == 3
    assert {f"conv{i}.u" for i in range(1, 5)} <= set(final["disc"])
    assert len(final["disc_optimizer"]["state"]) == len(list(
        state.disc.parameters()))
    with open(root / "exp" / GAN_DIR / "tensorboard" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [3]
    assert np.isfinite(rows[0]["train/gen_loss"])


def _assert_same(a, b, path=""):
    """Nested checkpoint payloads equal, tensors bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def _gan_flags(root, exp, steps, start):
    return TINY_FLAGS + [
        "-mt", "compression_gan", "--lpips_weights", str(root / "lpips.npz"),
        "--steps", str(steps), "--log_interval", "1000",
        "--experiments_dir", str(root / exp)] + start


def test_resume_continues_like_the_uninterrupted_run(compression_run):
    """A GAN run of G steps 2-3 (each with its D step), checkpointing at
    step 2, and a run resumed from that checkpoint over the last two
    batches: the same final checkpoint, every tensor bit for bit (codec,
    both optimizers, discriminator and u, D count, noise generator). On
    one thread (`one_thread`)."""
    root, data, _, _, _, _ = compression_run
    source = str(root / "exp" / COMP_DIR / "checkpoints" / "step_1.pt")
    stream = TrainDataset(data, 64, 0).batches(2, num_workers=1)
    batches = [next(stream) for _ in range(4)]
    ckpts = root / "whole" / GAN_DIR / "checkpoints"

    train_cli.run(train_cli.parse_args(_gan_flags(
        root, "whole", 3, ["--warmstart_ckpt", source,
                           "--save_interval", "2"])), batches=iter(batches))
    train_cli.run(train_cli.parse_args(_gan_flags(
        root, "resumed", 3, ["--resume_ckpt", str(ckpts / "step_2.pt")])),
        batches=iter(batches[2:]))
    _assert_same(torch.load(ckpts / "step_3.pt", weights_only=True),
                 torch.load(root / "resumed" / GAN_DIR / "checkpoints"
                            / "step_3.pt", weights_only=True))


def test_batches_ending_between_g_and_d_warn(compression_run, caplog):
    """Batches that run out after a G step and before its D step: the run
    ends there, its final checkpoint holds that G step without the D step,
    and a warning says a resume from it starts with a G step."""
    root, data, _, _, _, _ = compression_run
    source = str(root / "exp" / COMP_DIR / "checkpoints" / "step_1.pt")
    stream = TrainDataset(data, 64, 0).batches(2, num_workers=1)
    with caplog.at_level("WARNING", logger=train_cli.LOG.name):
        state = train_cli.run(train_cli.parse_args(_gan_flags(
            root, "short", 10, ["--warmstart_ckpt", source])),
            batches=iter([next(stream) for _ in range(3)]))
    assert (state.step, state.disc_steps) == (3, 1)
    final = torch.load(root / "short" / GAN_DIR / "checkpoints" / "step_3.pt",
                       weights_only=True)
    assert (final["step"], final["disc_steps"]) == (3, 1)
    assert "1 D step(s) short of step 3's cycle" in caplog.text


def test_crop_loader_threads(tmp_path):
    """num_workers=1 gives the single-threaded stream, crop for crop (the
    JAX package's with uint8 output, which draws alike); num_workers=4
    gives uint8 crops of the asked shape, each the crop of the file and
    seed the consumer drew, the same on every run."""
    data = _write_pngs(tmp_path)
    one = TrainDataset(data, crop_size=48, seed=3).batches(3, num_workers=1)
    ref = JaxTrainDataset(data, crop_size=48, seed=3,
                          out_dtype="uint8").batches(3, num_workers=1)
    for _ in range(3):
        (x, bpp), (x_j, bpp_j) = next(one), next(ref)
        np.testing.assert_array_equal(x, x_j)
        np.testing.assert_array_equal(bpp, bpp_j)

    runs = []
    for _ in range(2):
        ds = TrainDataset(data, crop_size=48, seed=3)
        stream = ds.batches(3, num_workers=4)
        runs.append([next(stream) for _ in range(3)])
        stream.close()
    draws = np.random.RandomState(3)
    for i, (x, bpp) in enumerate(runs[0]):
        assert x.shape == (3, 48, 48, 3) and x.dtype == np.uint8
        for j in range(3):
            path = ds.files[draws.randint(len(ds.files))]
            seed = int(draws.randint(2 ** 31))
            want, want_bpp = ds._sample_path(path,
                                             np.random.RandomState(seed))
            np.testing.assert_array_equal(x[j], want)
            assert bpp[j] == np.float32(want_bpp)
        np.testing.assert_array_equal(x, runs[1][i][0])


def test_lpips_weight_files(tmp_path):
    """--lpips_backbone_path (a torchvision AlexNet .features state_dict)
    and --lpips_lin_path (LPIPS v0.1 lin heads) load the files the test
    wrote: the trainer's LPIPS equals one built from them by hand, bit for
    bit. Lin heads alone leave the backbone uncalibrated, which the CLI
    refuses without --uncalibrated_lpips_ok."""
    src = default_lpips(5)
    backbone = {}
    for idx, conv in zip((0, 3, 6, 8, 10), src.backbone.children()):
        backbone[f"{idx}.weight"] = conv.weight.detach().clone()
        backbone[f"{idx}.bias"] = torch.randn(conv.bias.shape)
    rng = np.random.RandomState(8)
    lin = {f"lin{k}.model.1.weight": torch.from_numpy(
        rng.rand(1, c, 1, 1).astype(np.float32))
        for k, c in enumerate(ALEX_CHNS)}
    torch.save(backbone, tmp_path / "alexnet_features.pth")
    torch.save(lin, tmp_path / "alex.pth")
    flags = TINY_FLAGS + ["--lpips_lin_path", str(tmp_path / "alex.pth")]

    fn = train_cli.make_lpips_fn(train_cli.parse_args(flags + [
        "--lpips_backbone_path", str(tmp_path / "alexnet_features.pth")]),
        "cpu")
    want = default_lpips(SEED)
    with torch.no_grad():
        for k, conv in enumerate(want.backbone.children()):
            idx = (0, 3, 6, 8, 10)[k]
            conv.weight.copy_(backbone[f"{idx}.weight"])
            conv.bias.copy_(backbone[f"{idx}.bias"])
        for k in range(len(ALEX_CHNS)):
            getattr(want, f"lin{k}").copy_(lin[f"lin{k}.model.1.weight"]
                                           .reshape(-1))
    want = want.to(memory_format=torch.channels_last)  # as the trainer's
    a, b = torch.rand(2, 3, 64, 64), torch.rand(2, 3, 64, 64)
    assert torch.equal(fn(a, b), want(a, b, normalize=True))

    model, calibrated = load_lpips(lin_path=str(tmp_path / "alex.pth"))
    assert not calibrated
    assert torch.equal(model.lin0, lin["lin0.model.1.weight"].reshape(-1))
    with pytest.raises(SystemExit, match="uncalibrated"):
        train_cli.make_lpips_fn(train_cli.parse_args(flags), "cpu")
