"""Data-parallel training in the port (`hific_tpu_torch/parallel/mesh.py`,
DDP steps in `training/train_step.py`) against the port's single-process
step and the JAX package's `shard_train_step`.

Ranks are spawned processes on the CPU under gloo (`parallel.dryrun.spawn`,
a `file://` rendezvous under the test's temporary directory, one thread a
rank). The tiny config (latent 8, 1 residual block, hyperlatent 16) at a
global batch of 4 of 64x64 crops starts from JAX's `create_train_state`;
both packages get the same quantization noise (each package's
`hyperprior.quantize_noise` replaced by one adding seeded arrays keyed by
the global batch's shape, of which a rank adds its rows). The JAX steps
run over a 2-device mesh and a (replica 2, data 2) mesh of the 8 virtual
CPU devices, the port's over 2 ranks and over 4 ranks in 2 slices. The
compression stage's G step (with LPIPS) is held against the port's
single-process step, the GAN stage's G then D step (without LPIPS, whose
batch mean shards as the distortion's does) also against JAX's.

The rate target is set between the global batch's quantized rate and its
noisiest shard's, so a rank that branched on its own shard's rate would
take lambda_A where the global step takes lambda_B.

Tolerances (those of `tests/test_torch_train_gan.py`): gradients within
1e-4 of each leaf's largest, losses rtol 1e-4, parameters within the Adam
move over that tolerance, u within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hific_tpu.models.hyperprior as jax_hyperprior_module
import hific_tpu_torch.models.hyperprior as hyperprior_module
from hific_tpu.config import hific_config as jax_hific_config
from hific_tpu.config import mse_lpips_config as jax_mse_lpips_config
from hific_tpu.models.lpips import default_lpips_params
from hific_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
    make_mesh_2d as jax_make_mesh_2d,
    replicate as jax_replicate,
    shard_batch as jax_shard_batch,
    shard_train_step as jax_shard_train_step,
)
from hific_tpu.training import train_step as jax_train_step
from hific_tpu_torch.cli import train as train_cli
from hific_tpu_torch.config import Config
from hific_tpu_torch.models.hific import HiFiC
from hific_tpu_torch.ops.quantize import (
    batch_shard,
    current_batch_shard,
    quantize_noise,
)
from hific_tpu_torch.models.generator import generator_noise
from hific_tpu_torch.parallel.dryrun import (
    _fixed_noise,
    cli_rank,
    spawn,
    train_rank,
)
from hific_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    REPLICA_AXIS,
    DataParallel,
    infer_n_slices,
    make_mesh,
    make_mesh_2d,
    shard_rows,
)
from hific_tpu_torch.training import checkpoints
from hific_tpu_torch.training.data import DeviceDataset, TrainDataset
from hific_tpu_torch.training.schedules import scheduled_param
from hific_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_disc_optimizer,
    make_optimizers,
    make_train_step_d,
    make_train_step_g,
)
from hific_tpu_torch.weights import (
    disc_state_dict_from_jax,
    lpips_state_dict_from_jax,
    state_dict_from_jax,
)
from test_torch_train import _jax_adam_state
from test_torch_train_gan import (
    GRAD_REL,
    LOSS_RTOL,
    U_ATOL,
    _assert_after_step,
    _assert_gradients,
    _lpips,
    _lr,
    _np_tree,
)

TINY = dict(latent_channels=8, n_residual_blocks=1, hyperlatent_filters=16,
            crop_size=64, batch_size=4)
GLOBAL = 4
WORLDS = [(2, 1), (4, 2)]  # (ranks, n_slices)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------- #
# Meshes, shards and noise


def test_meshes_and_shards():
    mesh = make_mesh_2d(2, range(4))
    assert mesh.shape == {REPLICA_AXIS: 2, DATA_AXIS: 2}
    assert mesh.devices == [0, 1, 2, 3] and mesh.size == 4
    assert make_mesh(["cpu", "cpu"]).shape == {DATA_AXIS: 2}
    with pytest.raises(ValueError, match="not divisible into 3 slices"):
        make_mesh_2d(3, range(4))
    x = np.arange(8)
    assert list(shard_rows(x, 1, 4)) == [2, 3]
    with pytest.raises(ValueError, match="not divisible by the 3-rank"):
        shard_rows(x, 0, 3)
    dp = DataParallel(mesh, 2, torch.device("cpu"), "gloo")
    assert (dp.index, dp.world) == (2, 4)
    assert list(dp.shard(x)) == [4, 5]


def test_infer_n_slices(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert infer_n_slices() == 1
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert infer_n_slices() == 2


@pytest.mark.parametrize("shape", [(4, 8, 4, 4), (4, 16, 1, 1)])
def test_sharded_noise_is_the_global_draws_rows(shape):
    """Under `batch_shard(i, n)` each draw is the global batch's (the
    channels-last layout of the single process's) and keeps shard i's
    rows; the generator advances as the global draw's does."""
    x = torch.zeros(shape).contiguous(memory_format=torch.channels_last)
    g = torch.Generator().manual_seed(5)
    whole = quantize_noise(x, g)
    after = torch.rand(1, generator=g)
    whole_gen = generator_noise((4, 3, 3, 2), torch.Generator().manual_seed(
        6), torch.float32, "cpu")
    for index in range(2):
        g = torch.Generator().manual_seed(5)
        with batch_shard(index, 2):
            assert current_batch_shard() == (index, 2)
            part = quantize_noise(x[2 * index:2 * index + 2], g)
            gen_part = generator_noise((2, 3, 3, 2), torch.Generator(
            ).manual_seed(6), torch.float32, "cpu")
        assert torch.equal(part, whole[2 * index:2 * index + 2])
        assert torch.equal(gen_part, whole_gen[2 * index:2 * index + 2])
        assert torch.equal(torch.rand(1, generator=g), after)
    assert current_batch_shard() is None


# --------------------------------------------------------------------- #
# Steps: the port's DP step against its single step and JAX's SPMD step


def _crops(rng):
    """Two low-contrast crops (128 +- 48) then two of full-range uniform
    noise: the shards' quantized rates lie apart. (At 128 +- 8 a ReLU or
    rounding tie is decided apart: the port's and JAX's single steps then
    differ by 4e-4 of a generator leaf, as `hific_tpu_torch/kinks.py`
    describes; this file imposes no sides, so its data has no such tie.)"""
    low = [np.clip(128 + rng.randint(-48, 49, (64, 64, 3)), 0, 255)
           for _ in range(2)]
    high = [rng.randint(0, 256, (64, 64, 3)) for _ in range(2)]
    return np.stack(low + high).astype(np.uint8)


def _per_image_qbpp(jcfg, model_sd, x, noise):
    """The port's quantized rate of each image of the global batch, with
    its rows of the shared noise."""
    model = HiFiC(Config.from_json(jcfg.to_json()))
    model.load_state_dict(model_sd)
    model = model.to(memory_format=torch.channels_last)
    xt = torch.from_numpy(x).float().div(255.0).permute(0, 3, 1, 2)
    saved = hyperprior_module.quantize_noise
    hyperprior_module.quantize_noise = _fixed_noise(noise)
    try:
        out = []
        with torch.no_grad():
            for i in range(GLOBAL):
                with batch_shard(i, GLOBAL):
                    inter, _ = model(xt[i:i + 1].contiguous(
                        memory_format=torch.channels_last), None)
                out.append(float(inter.q_bpp))
    finally:
        hyperprior_module.quantize_noise = saved
    return np.asarray(out)


def _split_case(make, noise, x, from_jax):
    """A config of `make` whose rate target at step 0 lies between the
    global batch's quantized rate and its noisiest shard's (of 2 and of
    4), with the initial state: JAX's `create_train_state` (from_jax) or
    the port's seeded one, as port state dicts."""
    cfg = make(**TINY)
    case = {}
    if from_jax:
        jstate = jax.jit(lambda k: jax_train_step.create_train_state(
            cfg, k))(jax.random.PRNGKey(0))
        case["jstate"] = jstate
        sds = {"model": state_dict_from_jax(_np_tree(jstate.params)),
               "disc": disc_state_dict_from_jax(_np_tree(jstate.disc_params),
                                                _np_tree(jstate.spectral))}
    else:
        state = create_train_state(Config.from_json(cfg.to_json()), 0, "cpu")
        sds = {"model": state.model.state_dict()}
    q = _per_image_qbpp(cfg, sds["model"], x, noise)
    shard_max = min(q.reshape(2, 2).mean(1).max(), q.max())
    target = 0.5 * (q.mean() + shard_max)
    factor = cfg.target_schedule.vals[0]
    cfg = make(**TINY, target_rate=float(target / factor))
    return dict(case, cfg=cfg, sds=sds, q=q, target=target)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return _setup(str(tmp_path_factory.mktemp("single_ckpt")))


def _single_checkpoint(directory, x):
    """A single-process checkpoint of the tiny compression config after one
    step (Adam's moments and the noise generator's state in it)."""
    cfg = Config.from_json(jax_mse_lpips_config(**TINY).to_json())
    state = create_train_state(cfg, 3, "cpu")
    make_train_step_g(cfg)(state, x)
    return checkpoints.save_checkpoint(directory, state, cfg), cfg


def _setup(ckpt_dir):
    rng = np.random.RandomState(0)
    xg = _crops(rng)
    xd = rng.randint(0, 256, (GLOBAL, 64, 64, 3)).astype(np.uint8)
    noise = {(GLOBAL, 1, 1, 16): rng.uniform(-0.5, 0.5, (GLOBAL, 1, 1, 16)),
             (GLOBAL, 4, 4, 8): rng.uniform(-0.5, 0.5, (GLOBAL, 4, 4, 8))}
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    lpips_params = default_lpips_params("alex", backbone_seed=0)
    # LPIPS in the compression case only: the JAX steps of the GAN case
    # compile in half the time without it, and its mean over the batch
    # shards as the distortion's does.
    cases = {"compression": dict(_split_case(jax_mse_lpips_config, noise, xg,
                                             from_jax=False), lpips=True),
             "gan": dict(_split_case(jax_hific_config, noise, xg,
                                     from_jax=True), lpips=False)}
    ckpt, ckpt_cfg = _single_checkpoint(ckpt_dir, xd)
    return dict(xg=xg, xd=xd, noise=noise, lpips=lpips_params, cases=cases,
                single={}, ckpt=ckpt, ckpt_cfg=ckpt_cfg)


@pytest.fixture
def shared_noise(setup, monkeypatch):
    noise = setup["noise"]
    monkeypatch.setattr(jax_hyperprior_module, "quantize_noise",
                        lambda x, rng: x + jnp.asarray(noise[tuple(x.shape)]))
    monkeypatch.setattr(hyperprior_module, "quantize_noise",
                        _fixed_noise(noise))


def _jax_mesh(world, n_slices):
    devices = jax.devices()[:world]
    if n_slices > 1:
        return jax_make_mesh_2d(n_slices, devices)
    return jax_make_mesh(devices)


def _jax_steps(case, setup, kinds, mesh, lpips_j):
    """JAX's sharded steps from its initial state: (state after each,
    diagnostics of each)."""
    cfg, state = case["cfg"], jax_replicate(case["jstate"], mesh)
    states, diags = [], []
    for kind in kinds:
        make = (jax_train_step.make_train_step_g(cfg, lpips_j) if kind == "G"
                else jax_train_step.make_train_step_d(cfg))
        x = setup["xg"] if kind == "G" else setup["xd"]
        state, diag = jax_shard_train_step(make, mesh, donate_state=False)(
            state, jax_shard_batch(jnp.asarray(x), mesh))
        states.append(state)
        diags.append({k: float(v) for k, v in diag.items()})
    return states, diags


def _port_single(case, setup, kinds, lpips_t):
    """The port's single-process steps from the case's initial state:
    diagnostics and the stepped module's gradients of each (computed once
    a case)."""
    key = id(case)
    if key in setup["single"]:
        return setup["single"][key]
    cfg = Config.from_json(case["cfg"].to_json())
    model = HiFiC(cfg)
    model.load_state_dict(case["sds"]["model"])
    model = model.to(memory_format=torch.channels_last)
    state = TrainState(0, model, make_optimizers(cfg, model),
                       torch.Generator())
    if cfg.use_discriminator:
        from hific_tpu_torch.models.discriminator import Discriminator

        disc = Discriminator(cfg.latent_channels)
        disc.load_state_dict(case["sds"]["disc"])
        state.disc = disc.to(memory_format=torch.channels_last)
        state.disc_optimizer = make_disc_optimizer(cfg, state.disc)
    diags, grads = [], []
    for kind in kinds:
        if kind == "G":
            diag = make_train_step_g(cfg, lpips_t if case["lpips"] else None)(
                state, setup["xg"])
            module = state.model
        else:
            diag = make_train_step_d(cfg)(state, setup["xd"])
            module = state.disc
        diags.append({k: float(v) for k, v in diag.items()})
        grads.append({n: p.grad.clone() for n, p in module.named_parameters()})
    setup["single"][key] = diags, grads
    return diags, grads


def _job(case, setup, kinds, world, n_slices):
    return {"config": case["cfg"].to_json(), "device": "cpu",
            "backend": "gloo", "n_slices": n_slices,
            "state_dicts": case["sds"],
            "lpips": ({"state_dict": lpips_state_dict_from_jax(
                _np_tree(setup["lpips"]))} if case["lpips"] else None),
            "noise": setup["noise"], "grads": True, "params": True,
            "steps": [(k, setup["xg"] if k == "G" else setup["xd"])
                      for k in kinds]}


KINDS = {"compression": "G", "gan": "GD", "bf16": "G"}


@pytest.fixture(scope="module", params=WORLDS,
                ids=[f"world{w}_slices{s}" for w, s in WORLDS])
def dp_runs(request, setup, tmp_path_factory):
    """Both cases' DP runs over one spawned process group."""
    world, n_slices = request.param
    jobs = [_job(setup["cases"][name], setup, KINDS[name], world, n_slices)
            for name in ("compression", "gan")]
    # bf16 (the transposed convs' bf16 leaves in their own DDP buckets,
    # all-reduced in bf16) from the compression case's weights.
    jobs.append(dict(jobs[0], lpips=None, params=True, config=Config.from_json(
        setup["cases"]["compression"]["cfg"].to_json()).replace(
            dtype="bfloat16").to_json()))
    # A single-process checkpoint resumed under DP (its own noise).
    jobs.append({"config": setup["ckpt_cfg"].to_json(), "device": "cpu",
                 "backend": "gloo", "n_slices": n_slices,
                 "checkpoint": setup["ckpt"], "steps": [("G", setup["xg"])]})
    ranks = spawn(train_rank, world, *jobs,
                  workdir=str(tmp_path_factory.mktemp(f"dp{world}")),
                  cpu_threads=1)
    return world, n_slices, ranks


def _assert_dp_matches_single(setup, ranks, name, world):
    """Rank 0's diagnostics and gradients against the port's
    single-process steps; the rate penalty the global batch's branch
    (lambda_B) although a shard's own rate is above the target; every
    rank with the same diagnostics and parameters after the steps."""
    case = setup["cases"][name]
    kinds = KINDS[name]
    job = list(KINDS).index(name)
    got = ranks[0][job]
    single_diags, single_grads = _port_single(case, setup, kinds,
                                              _lpips(setup["lpips"])[1])
    cfg = case["cfg"]
    shard_q = case["q"].reshape(world, -1).mean(1)
    assert shard_q.max() > case["target"] > case["q"].mean()
    lambda_b = scheduled_param(cfg.lambda_B, cfg.lambda_schedule, 0)
    assert got["diagnostics"][0]["rate_penalty"] == pytest.approx(lambda_b)
    for i, kind in enumerate(kinds):
        assert set(got["diagnostics"][i]) == set(single_diags[i])
        for k, want in single_diags[i].items():
            np.testing.assert_allclose(got["diagnostics"][i][k], want,
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"{kind} {k}")
        for n, g in single_grads[i].items():
            scale = float(g.abs().max())
            err = float((got["grads"][i][n] - g).abs().max())
            assert err <= GRAD_REL * scale, (kind, n, err, scale)
    for r in ranks[1:]:
        assert r[job]["checksum"] == got["checksum"]
        assert r[job]["diagnostics"] == got["diagnostics"]
    assert got["launches"] == [(0, 0)] * len(kinds)  # no kernel on the CPU
    return got


def test_dp_compression_step_matches_single_process(setup, dp_runs,
                                                     shared_noise):
    """The compression stage's G step data-parallel over 2 ranks and over
    4 ranks in 2 slices against the port's single-process step on the
    global batch (`_assert_dp_matches_single`)."""
    world, _, ranks = dp_runs
    _assert_dp_matches_single(setup, ranks, "compression", world)


def test_dp_gan_steps_match_single_process_and_jax(setup, dp_runs,
                                                   shared_noise):
    """The GAN stage's G step, then its D step, data-parallel over 2 ranks
    and over 4 ranks in 2 slices: against the port's single-process steps
    (`_assert_dp_matches_single`), and against JAX's SPMD steps over a
    matching mesh: the same diagnostics after each step, the G step's
    codec gradients and the D step's discriminator gradients (from JAX's
    Adam mu), the parameters after each step within the Adam move and u
    after both."""
    world, n_slices, ranks = dp_runs
    got = _assert_dp_matches_single(setup, ranks, "gan", world)
    case = setup["cases"]["gan"]
    cfg = case["cfg"]
    jstates, jdiags = _jax_steps(case, setup, "GD",
                                 _jax_mesh(world, n_slices), None)
    for i, kind in enumerate("GD"):
        assert set(got["diagnostics"][i]) == set(jdiags[i])
        for k, want in jdiags[i].items():
            np.testing.assert_allclose(got["diagnostics"][i][k], want,
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"{kind} {k} vs JAX")
    params = got["params"]
    count, mu, nu = _jax_adam_state(jstates[0].opt_state)
    _assert_gradients(got["grads"][0], mu, f"DP G step, world {world}")
    _assert_after_step({n: params["model"][n] for n in mu}, (count, mu, nu),
                       state_dict_from_jax(_np_tree(jstates[0].params)),
                       _lr(cfg, 0), "DP G step")
    s_d = jstates[1]
    adam_j = s_d.disc_opt_state[0]
    adam = (int(adam_j.count),
            disc_state_dict_from_jax(_np_tree(adam_j.mu), {}),
            disc_state_dict_from_jax(_np_tree(adam_j.nu), {}))
    _assert_gradients(got["grads"][1], adam[1], "DP D step")
    _assert_after_step({n: params["disc"][n] for n in adam[1]}, adam,
                       disc_state_dict_from_jax(_np_tree(s_d.disc_params),
                                                {}),
                       _lr(cfg, 0), "DP D step")
    for n, u in disc_state_dict_from_jax({}, _np_tree(s_d.spectral)).items():
        np.testing.assert_allclose(params["disc"][n].numpy(), u.numpy(),
                                   atol=U_ATOL, err_msg=n)


# --------------------------------------------------------------------- #
# Datasets, checkpoints and the CLI


def _write_pngs(directory, n, seed, side=80):
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (side, side, 3)).astype(
            np.uint8)).save(os.path.join(directory, f"im{i}.png"))
    return str(directory)


def _dp(index, world):
    return DataParallel(make_mesh(list(range(world))), index,
                        torch.device("cpu"), "gloo")


def test_device_dataset_shards_are_the_single_batch(tmp_path):
    """Under world 2 each rank's DeviceDataset batch is its rows of the
    single-device batch, batch after batch."""
    data = _write_pngs(tmp_path, 3, seed=1)
    single = DeviceDataset(data, 64, 4, seed=3, device="cpu")
    ranks = [DeviceDataset(data, 64, 4, seed=3, device="cpu", mesh=_dp(i, 2))
             for i in range(2)]
    streams = [r.batches() for r in ranks]
    for (x, bpp) in (next(single.batches()) for _ in range(3)):
        parts = [next(s) for s in streams]
        assert torch.equal(torch.cat([p[0] for p in parts]), x)
        assert all(p[1].shape == (2,) for p in parts)
    with pytest.raises(ValueError, match="not divisible by the 3-rank"):
        DeviceDataset(data, 64, 4, device="cpu", mesh=_dp(0, 3))


def test_train_dataset_shards_are_the_threaded_batch(tmp_path):
    """Each rank decodes only its rows of the threaded stream's batch."""
    data = _write_pngs(tmp_path, 3, seed=2)
    single = TrainDataset(data, 64, seed=4).batches(4, num_workers=2)
    ranks = [TrainDataset(data, 64, seed=4).batches(4, num_workers=2,
                                                    mesh=_dp(i, 2))
             for i in range(2)]
    for _ in range(2):
        x, bpp = next(single)
        parts = [next(r) for r in ranks]
        assert np.array_equal(np.concatenate([p[0] for p in parts]), x)
        assert np.array_equal(np.concatenate([p[1] for p in parts]), bpp)


TINY_FLAGS = ["-bs", "2", "-crop", "64", "--latent_channels", "8",
              "--n_residual_blocks", "1", "--hyperlatent_filters", "16",
              "--no_lpips", "--device", "cpu", "--seed", "3"]


def test_cli_refuses_slices_that_do_not_divide_the_world(monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")
    a = train_cli.parse_args(TINY_FLAGS + [
        "--data_parallel", "--n_slices", "3", "--experiments_dir",
        str(tmp_path)])
    with pytest.raises(SystemExit, match="--n_slices 3 does not divide the "
                                         "world of 2 ranks"):
        train_cli.run(a, batches=iter([]))


def test_dp_cli_checkpoint_restores_both_ways(tmp_path):
    """15 steps of the trainer CLI with --data_parallel over 2 ranks, with
    --use_remat, --device_data, --max_rss_gb (a collective at each log
    step) and --profile_dir: rank 0 alone writes the trace of steps 11-15
    and the scalars; its checkpoint has the single-process keys and
    restores into a single process (the reverse:
    `test_single_checkpoint_resumes_under_dp`)."""
    data = _write_pngs(tmp_path / "data", 3, seed=5)
    prof = tmp_path / "prof"
    argv = TINY_FLAGS + ["--data_parallel", "-d", data, "--steps", "15",
                         "--use_remat", "--device_data", "--max_rss_gb",
                         "1000", "--profile_dir", str(prof),
                         "--log_interval", "5", "--experiments_dir",
                         str(tmp_path / "exp")]
    steps = spawn(cli_rank, 2, argv, workdir=str(tmp_path / "ranks"),
                  cpu_threads=1)
    assert steps == [15, 15]
    assert os.listdir(prof) == ["trace_steps_11-15.json"]
    ckpt_dir = tmp_path / "exp" / "hific_tpu_torch_v0.1_compression_low" \
        / "checkpoints"
    path = checkpoints.latest_checkpoint(str(ckpt_dir))
    assert path.endswith("step_15.pt")
    config = checkpoints.load_config(str(ckpt_dir))
    state = checkpoints.restore_train_state(path, config, device="cpu")
    fresh = create_train_state(config, 3, device="cpu")
    assert state.model.state_dict().keys() == fresh.model.state_dict().keys()
    assert state.step == 15
    with open(ckpt_dir.parent / "tensorboard" / "metrics.jsonl") as f:
        assert len(f.readlines()) == 3  # steps 1, 6, 11; rank 0 alone


def test_dp_bf16_step_runs_and_ranks_agree(setup, dp_runs):
    """A bf16 G step under DDP: finite losses, bf16 gradients of the
    transposed convs (reduced in their dtype), every rank with the same
    parameters after it, the leaves' dtypes unchanged."""
    _, _, ranks = dp_runs
    got = ranks[0][2]
    assert np.isfinite(got["diagnostics"][0]["weighted_compression_loss"])
    assert got["grads"][0]["generator.upconv0.weight"].dtype == torch.bfloat16
    assert got["grads"][0]["encoder.conv_stem.weight"].dtype == torch.float32
    params = got["params"]["model"]
    assert params["generator.upconv0.weight"].dtype == torch.bfloat16
    for r in ranks[1:]:
        assert r[2]["checksum"] == got["checksum"]


def test_single_checkpoint_resumes_under_dp(setup, dp_runs):
    """A single-process checkpoint restored on every rank of a DP run: its
    next step (the checkpoint's noise state, drawn for the global batch)
    equals the single process's next step from the same file."""
    _, _, ranks = dp_runs
    state = checkpoints.restore_train_state(setup["ckpt"], setup["ckpt_cfg"],
                                            device="cpu")
    want = make_train_step_g(setup["ckpt_cfg"])(state, setup["xg"])
    got = ranks[0][3]["diagnostics"][0]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], float(v), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    for r in ranks[1:]:
        assert r[3]["checksum"] == ranks[0][3]["checksum"]
