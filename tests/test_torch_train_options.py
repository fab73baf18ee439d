"""The trainer options of the JAX CLI that the port carries, on the CPU.

- `--use_remat`: the generator's residual blocks under activation
  checkpointing give the same loss and gradients as without it, bit for
  bit on one CPU thread, in float32 and in bfloat16.
- `DeviceDataset` (`--device_data`), the counterparts of the JAX package's
  `tests/test_device_data.py`: uint8 crops of the asked shape that are
  windows of the corpus (or their mirror images), the same batches for
  the same seed, mixed sizes refused, and a train step on a device batch
  equal to the step on the same batch from the host.
- `--profile_dir`: a trace of steps 11-15 after 16 tiny steps (the
  bf16, remat and device-data flags together run on the card, in
  `chip_smoke.py` phase 11).
- `--max_rss_gb`: over the limit the trainer checkpoints and exits with
  the JAX CLI's message, and `--resume_ckpt` continues from there.
- The flags that the JAX CLI has and the port refuses or ignores.
"""

import json
import os

import numpy as np
import pytest
import torch

from hific_tpu_torch.cli import train as train_cli
from hific_tpu_torch.config import mse_lpips_config
from hific_tpu_torch.models import generator as generator_module
from hific_tpu_torch.models.hific import HiFiC, init_random_
from hific_tpu_torch.training import checkpoints
from hific_tpu_torch.training.data import DeviceDataset
from hific_tpu_torch.training.train_step import (
    TrainState,
    make_optimizers,
    make_train_step_g,
)

TINY = dict(latent_channels=8, n_residual_blocks=2, hyperlatent_filters=16,
            crop_size=64, batch_size=2)
TINY_FLAGS = ["-bs", "2", "-crop", "64", "--latent_channels", "8",
              "--n_residual_blocks", "1", "--hyperlatent_filters", "16",
              "--no_lpips", "--device", "cpu"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiles(directory, n, shape, seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(directory, exist_ok=True)
    for i in range(n):
        Image.fromarray((rng.rand(*shape) * 255).astype(np.uint8)).save(
            os.path.join(directory, f"tile_{i}.png"))
    return str(directory)


@pytest.fixture
def tile_dir(tmp_path):
    return _tiles(tmp_path / "tiles", 5, (40, 40, 3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gives_the_same_step_bit_for_bit(one_thread, monkeypatch,
                                               dtype):
    """One G step with and without `use_remat`, same weights and noise:
    every diagnostic and every gradient equal, bit for bit."""
    x = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3)).astype(
        np.uint8)
    init = init_random_(HiFiC(mse_lpips_config(**TINY, dtype=dtype)),
                        torch.Generator().manual_seed(0)).state_dict()
    calls, block_forward = [], generator_module.ResidualBlock.forward
    monkeypatch.setattr(generator_module.ResidualBlock, "forward",
                        lambda block, t: calls.append(1)
                        or block_forward(block, t))
    results = []
    for remat in (False, True):
        cfg = mse_lpips_config(**TINY, dtype=dtype, use_remat=remat)
        model = HiFiC(cfg)
        model.load_state_dict(init)
        model = model.to(memory_format=torch.channels_last)
        state = TrainState(0, model, make_optimizers(cfg, model),
                           torch.Generator().manual_seed(1))
        calls.clear()
        diag = make_train_step_g(cfg)(state, x)
        # With remat each block runs again in the backward.
        assert len(calls) == TINY["n_residual_blocks"] * (1 + remat)
        results.append((diag, {n: p.grad for n, p in
                               model.named_parameters()}))
    (diag_a, grads_a), (diag_b, grads_b) = results
    assert diag_a.keys() == diag_b.keys()
    for k in diag_a:
        assert torch.equal(diag_a[k], diag_b[k]), k
    for name, g in grads_a.items():
        assert g.dtype == grads_b[name].dtype
        assert torch.equal(g, grads_b[name]), name


def test_device_dataset_batches(tile_dir):
    ds = DeviceDataset(tile_dir, crop_size=32, batch_size=4, seed=0,
                       device="cpu")
    assert ds.data.shape == (5, 40, 40, 3) and ds.data.dtype == torch.uint8
    it = ds.batches()
    x0, bpp0 = next(it)
    x1, _ = next(it)
    assert x0.shape == (4, 32, 32, 3) and x0.dtype == torch.uint8
    assert x0.device == ds.data.device
    assert bpp0.shape == (4,) and np.all(bpp0 > 0)
    assert not torch.equal(x0, x1)
    src = ds.data.numpy()
    for crop in x0.numpy():
        assert any(np.array_equal(maybe[y:y + 32, x:x + 32], crop)
                   for tile in src for maybe in (tile, tile[:, ::-1])
                   for y in range(9) for x in range(9))


def test_device_dataset_defaults_to_the_card(tile_dir):
    """No device named: the corpus goes to the card, as every entry point
    of the port runs; without CUDA that is an error, not a silent CPU
    corpus."""
    if torch.cuda.is_available():
        assert DeviceDataset(tile_dir, crop_size=32, batch_size=2).data.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DeviceDataset(tile_dir, crop_size=32, batch_size=2)


def test_device_dataset_determinism(tile_dir):
    a, b = (next(DeviceDataset(tile_dir, crop_size=32, batch_size=4, seed=7,
                               device="cpu").batches())[0] for _ in range(2))
    c = next(DeviceDataset(tile_dir, crop_size=32, batch_size=4, seed=8,
                           device="cpu").batches())[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_device_dataset_refuses_mixed_and_small_sizes(tmp_path, tile_dir):
    from PIL import Image

    with pytest.raises(ValueError, match="smaller than crop_size"):
        DeviceDataset(tile_dir, crop_size=48, batch_size=2, device="cpu")
    Image.fromarray(np.zeros((48, 40, 3), np.uint8)).save(
        os.path.join(tile_dir, "odd.png"))
    with pytest.raises(ValueError, match="uniformly-sized"):
        DeviceDataset(tile_dir, crop_size=32, batch_size=2, device="cpu")
    ds = DeviceDataset(_tiles(tmp_path / "other", 2, (40, 40, 3)),
                       crop_size=32, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        next(ds.batches(3))


def test_train_step_on_a_device_batch(tmp_path, one_thread):
    """A G step on a DeviceDataset batch equals the step on the same crops
    handed over from the host as numpy uint8."""
    ds = DeviceDataset(_tiles(tmp_path / "t", 3, (72, 80, 3)), crop_size=64,
                       batch_size=2, seed=1, device="cpu")
    x, _ = next(ds.batches())
    cfg = mse_lpips_config(**TINY)
    init = init_random_(HiFiC(cfg), torch.Generator().manual_seed(0))
    diags = []
    for batch in (x, x.numpy()):
        model = HiFiC(cfg)
        model.load_state_dict(init.state_dict())
        model = model.to(memory_format=torch.channels_last)
        state = TrainState(0, model, make_optimizers(cfg, model),
                           torch.Generator().manual_seed(1))
        diags.append(make_train_step_g(cfg)(state, batch))
    for k in diags[0]:
        assert torch.equal(diags[0][k], diags[1][k]), k


def _run_dir(tmp_path, name):
    return (tmp_path / "exp" / f"hific_tpu_torch_v0.1_compression_low"
            / name)


def test_profile_dir_writes_a_trace_of_steps_11_to_15(tmp_path, one_thread):
    """16 tiny steps with the corpus on the device: a Chrome trace of steps
    11-15 in --profile_dir. (One thread: the steps' CPU kernels slow down
    many times over when the test workers oversubscribe the cores.)"""
    data = _tiles(tmp_path / "tiles", 3, (72, 72, 3))
    prof = tmp_path / "prof"
    state = train_cli.run(train_cli.parse_args(TINY_FLAGS + [
        "-d", data, "--steps", "16", "--device_data", "--profile_dir",
        str(prof), "--log_interval", "1000", "--experiments_dir",
        str(tmp_path / "exp")]))
    assert state.step == 16
    (trace,) = os.listdir(prof)
    assert trace == "trace_steps_11-15.json"
    with open(prof / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


def test_max_rss_checkpoints_exits_and_resumes(tmp_path, one_thread):
    """--max_rss_gb 1e-6: at the first log step the trainer checkpoints and
    exits with the JAX CLI's message; --resume_ckpt continues from it."""
    data = _tiles(tmp_path / "tiles", 3, (72, 72, 3))
    flags = TINY_FLAGS + ["-d", data, "--log_interval", "2",
                          "--experiments_dir", str(tmp_path / "exp")]
    with pytest.raises(SystemExit, match=r"host RSS .* GB > --max_rss_gb "
                                         r"0\.0: checkpointed .*step_1\.pt; "
                                         r"resume with --resume_ckpt"):
        train_cli.main(flags + ["--steps", "5", "--max_rss_gb", "1e-6"])
    ckpt_dir = _run_dir(tmp_path, "checkpoints")
    path = checkpoints.latest_checkpoint(str(ckpt_dir))
    assert path.endswith("step_1.pt")
    state = train_cli.run(train_cli.parse_args(
        flags + ["--steps", "3", "--max_rss_gb", "0", "--resume_ckpt",
                 path]))
    assert state.step == 3
    with open(_run_dir(tmp_path, "tensorboard") / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert all(r["train/host_rss_gb"] > 0 for r in rows)


def test_jax_flags_parse_with_their_meanings():
    """The JAX CLI's flags: --dtype, --use_remat and
    --use_latent_mixture_model reach the config; --use_pallas_norm is
    accepted; --data_parallel and --n_slices parse, and --n_slices without
    --data_parallel is refused."""
    a = train_cli.parse_args(TINY_FLAGS + [
        "--dtype", "bfloat16", "--use_remat", "--use_latent_mixture_model",
        "--use_pallas_norm", "--device_data", "--max_rss_gb", "0",
        "--profile_dir", "p"])
    cfg = train_cli.build_config(a)
    assert (cfg.dtype, cfg.use_remat, cfg.use_latent_mixture_model,
            cfg.use_pallas_norm) == ("bfloat16", True, True, True)
    assert train_cli.parse_args(TINY_FLAGS).max_rss_gb == -1.0
    a = train_cli.parse_args(TINY_FLAGS + ["--data_parallel",
                                           "--n_slices", "2"])
    assert (a.data_parallel, a.n_slices) == (True, 2)
    with pytest.raises(SystemExit):
        train_cli.parse_args(TINY_FLAGS + ["--n_slices", "2"])


@pytest.mark.parametrize("field,value", [("use_channel_norm", False),
                                         ("sample_noise", True)])
def test_warmstart_refuses_another_variant(tmp_path, field, value):
    """A channel-norm codec would load into an instance-norm model (the
    same gamma and beta) and train the wrong model: a warmstart refuses a
    source of another variant, naming the field, before it reads the
    checkpoint."""
    cfg = mse_lpips_config(**TINY)
    with open(tmp_path / checkpoints.CONFIG_FILENAME, "w") as f:
        f.write(cfg.to_json())
    with pytest.raises(ValueError, match=field):
        checkpoints.restore_train_state(
            str(tmp_path / "step_0.pt"), cfg.replace(**{field: value}),
            device="cpu", warmstart=True)
