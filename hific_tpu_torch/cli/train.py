"""Training CLI of the port, both stages of HiFiC's recipe.

    python -m hific_tpu_torch.cli.train -mt compression \
        -d data/openimages --regime low --steps 200000 \
        --uncalibrated_lpips_ok
    python -m hific_tpu_torch.cli.train -mt compression_gan \
        -d data/openimages --regime low --steps 400000 \
        --uncalibrated_lpips_ok --warmstart_ckpt \
        experiments/hific_tpu_torch_v0.1_compression_low/checkpoints/step_200000.pt

Counterpart of the JAX package's `cli/train.py`: config from the flags,
seeded random weights or a restored checkpoint, then the steps of
`training/train_step.py` over uint8 crops. `-mt compression` trains rate +
MSE + LPIPS; `-mt compression_gan` (`hific_config`) adds the conditional
discriminator, alternating one G step with `discriminator_steps` D steps
on distinct batches, and is started from a compression run with
`--warmstart_ckpt`. Every `--log_interval` G steps the scalars go to
`<exp>/tensorboard/metrics.jsonl` (and TensorBoard where it imports), and
with `--eval_dataset_path` one fixed held-out batch is evaluated (`test/`
scalars, `<exp>/reconstructions/step_<N>.png`). Checkpoints every
`--save_interval` G steps and at the end, each after the D steps of its G
step, so a resume continues exactly as the run would have; when `run`'s
batches run out between a G step and its D steps, the final checkpoint
lacks those D steps, a resume from it starts with a G step, and the
trainer says so in a warning. Steps are
absolute: a resumed or warmstarted run trains up to `--steps` in all.
Runs on the card unless `--device cpu`.

The JAX CLI's single-device options carry their meanings: `--dtype
bfloat16` (bfloat16 convs, the transposed convs' parameters and moments in
bfloat16), `--use_remat` (the generator's residual blocks recomputed in
the backward), `--use_latent_mixture_model` (the DLMM hyperprior),
`--device_data` (the corpus on the device once, crops drawn there; needs
uniformly sized images), `--max_rss_gb` (checkpoint and exit when the
host's resident memory passes it, checked at each log step; default 90% of
system RAM, 0 disables) and `--profile_dir` (a `torch.profiler` trace of G
steps 11-15, written as Chrome trace JSON). `--use_pallas_norm` is
accepted and means nothing here: the norm always runs the CUDA kernel on a
GPU tensor.

Data parallelism, one process per GPU under `torch.distributed.run`:

    python -m torch.distributed.run --standalone --nproc_per_node 8 \
        -m hific_tpu_torch.cli.train --data_parallel -mt compression ...

Each rank joins the process group from the environment (NCCL on the
cards, gloo with `--device cpu`), holds the state on `cuda:LOCAL_RANK` and
steps on its rows of the global batch (`--batch_size` stays the global
batch, which the world must divide), the codec and the discriminator in
DDP (`training/train_step.py`). `--n_slices` lays the ranks out as
(replica, data), one row a host (default: the hosts of the run) and must
divide the world. The datasets decode or gather only the rank's rows;
rank 0 alone writes checkpoints (the others wait for it), scalars,
reconstructions, the held-out eval and the profiler trace. The RSS guard
reads the largest host memory over the ranks, and every rank stops.

`run` takes any iterator of (uint8 NHWC batch, bpp) pairs in place of the
dataset, so a caller can drive the trainer with its own crops. LPIPS loads
local files only (`--lpips_weights`, `--lpips_backbone_path`,
`--lpips_lin_path`); without a calibrated backbone it is the seeded
random one (`models/lpips.py`), which the CLI refuses without
`--uncalibrated_lpips_ok`, as the JAX CLI does; `--no_lpips` drops the
perceptual term.
"""

import argparse
import logging
import os
import sys
import time
from typing import Callable, Iterator, Optional

import torch

from hific_tpu_torch.config import ModelTypes, hific_config, mse_lpips_config
from hific_tpu_torch.models.lpips import load_lpips
from hific_tpu_torch.parallel.mesh import infer_n_slices, init_process_group
from hific_tpu_torch.runtime import resolve_device
from hific_tpu_torch.training import checkpoints
from hific_tpu_torch.training.data import (
    DeviceDataset,
    TrainDataset,
    prefetch,
)
from hific_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    data_parallel_,
    make_eval_step,
    make_train_step_d,
    make_train_step_g,
)
from hific_tpu_torch.utils.logging import MetricWriter, save_side_by_side

LOG = logging.getLogger("hific_tpu_torch.train")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train HiFiC (PyTorch port)")
    p.add_argument("-mt", "--model_type", default=ModelTypes.COMPRESSION,
                   choices=[ModelTypes.COMPRESSION,
                            ModelTypes.COMPRESSION_GAN])
    p.add_argument("-regime", "--regime", default="low",
                   choices=["low", "med", "high"])
    p.add_argument("-d", "--dataset_path", default="data/openimages")
    p.add_argument("--eval_dataset_path", default=None,
                   help="held-out images: one fixed batch of crops is "
                        "evaluated every log_interval")
    p.add_argument("-name", "--name", default="hific_tpu_torch_v0.1")
    p.add_argument("-bs", "--batch_size", type=int, default=8)
    p.add_argument("-steps", "--steps", type=int, default=int(1e6))
    p.add_argument("-lr", "--learning_rate", type=float, default=1e-4)
    p.add_argument("-crop", "--crop_size", type=int, default=256)
    p.add_argument("-norm", "--normalize_input_image", action="store_true")
    p.add_argument("--likelihood_type", default="gaussian",
                   choices=["gaussian", "logistic"])
    p.add_argument("--n_residual_blocks", type=int, default=9)
    p.add_argument("--latent_channels", type=int, default=220)
    p.add_argument("--hyperlatent_filters", type=int, default=320)
    p.add_argument("--use_latent_mixture_model", action="store_true")
    p.add_argument("--no_lpips", action="store_true",
                   help="train without the perceptual term (k_P * LPIPS)")
    p.add_argument("--lpips_weights", default=None,
                   help="full LPIPS parameter .npz (the JAX package's "
                        "save_lpips_npz layout); calibrated")
    p.add_argument("--lpips_lin_path", default=None,
                   help="LPIPS v0.1 lin-head weights (alex.pth); defaults "
                        "to the packaged calibrated heads")
    p.add_argument("--lpips_backbone_path", default=None,
                   help="torchvision AlexNet .features state_dict (.pth); "
                        "without it (or --lpips_weights) the backbone is a "
                        "seeded random init, not perceptually calibrated")
    p.add_argument("--uncalibrated_lpips_ok", action="store_true",
                   help="accept the seeded random LPIPS backbone (lin heads "
                        "calibrated, backbone not); without it the CLI "
                        "refuses to train on LPIPS")
    p.add_argument("--log_interval", type=int, default=1000)
    p.add_argument("--save_interval", type=int, default=50000)
    p.add_argument("--warmstart_ckpt", default=None,
                   help="step_<N>.pt of another run (a compression run for "
                        "-mt compression_gan): its codec, optimizer and "
                        "step; the discriminator starts fresh")
    p.add_argument("--resume_ckpt", default=None)
    p.add_argument("--experiments_dir", default="experiments")
    p.add_argument("--data_parallel", action="store_true",
                   help="one rank per GPU under torch.distributed.run: the "
                        "global batch sharded over the ranks, gradients "
                        "averaged by DDP")
    p.add_argument("--n_slices", type=int, default=None,
                   help="with --data_parallel: lay the ranks out as "
                        "(replica=hosts, data=ranks of a host); default: "
                        "the hosts of the run (WORLD_SIZE / "
                        "LOCAL_WORLD_SIZE); must divide the world")
    p.add_argument("--device_data", action="store_true",
                   help="upload the whole corpus to the device once and "
                        "draw crops and flips there (no per-step batch "
                        "upload; needs uniformly sized images that fit "
                        "device memory, e.g. pre-cropped tiles)")
    p.add_argument("--max_rss_gb", type=float, default=-1.0,
                   help="checkpoint and exit cleanly if the host's resident "
                        "memory exceeds this at a log step (default: 90%% "
                        "of system RAM; 0 disables)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--use_remat", action="store_true",
                   help="recompute the generator's residual blocks in the "
                        "backward (less device memory, more compute)")
    p.add_argument("--use_pallas_norm", action="store_true",
                   help="accepted for the JAX CLI's command lines; the "
                        "norm always runs its CUDA kernel here")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of steps 11-15 here")
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) unless named")
    p.add_argument("--seed", type=int, default=42)
    a = p.parse_args(argv)
    if a.n_slices is not None and not a.data_parallel:
        p.error("--n_slices needs --data_parallel")
    return a


def build_config(a):
    kw = dict(
        name=a.name, regime=a.regime, batch_size=a.batch_size,
        n_steps=a.steps, learning_rate=a.learning_rate,
        crop_size=a.crop_size, normalize_input_image=a.normalize_input_image,
        likelihood_type=a.likelihood_type,
        n_residual_blocks=a.n_residual_blocks,
        latent_channels=a.latent_channels,
        hyperlatent_filters=a.hyperlatent_filters,
        use_latent_mixture_model=a.use_latent_mixture_model,
        log_interval=a.log_interval, save_interval=a.save_interval,
        dtype=a.dtype, use_remat=a.use_remat,
        use_pallas_norm=a.use_pallas_norm)
    if a.model_type == ModelTypes.COMPRESSION_GAN:
        return hific_config(**kw)
    return mse_lpips_config(**kw)


def make_lpips_fn(a, device) -> Optional[Callable]:
    """LPIPS on [0, 1] images, or None with --no_lpips."""
    if a.no_lpips:
        LOG.warning("--no_lpips: training rate + MSE only")
        return None
    lpips, calibrated = load_lpips(a.lpips_weights, a.lpips_backbone_path,
                                   a.lpips_lin_path, seed=a.seed)
    if not calibrated and not a.uncalibrated_lpips_ok:
        raise SystemExit(
            "The LPIPS backbone here is a seeded RANDOM init (lin heads "
            "calibrated, backbone not). Pass --lpips_backbone_path or "
            "--lpips_weights for true LPIPS, --uncalibrated_lpips_ok to "
            "train on it knowingly, or --no_lpips to drop the term.")
    lpips = lpips.to(device, memory_format=torch.channels_last)
    return lambda x_gen, x_real: lpips(x_gen, x_real, normalize=True)


def _nhwc(t: torch.Tensor, normalized: bool):
    """NCHW device tensor -> NHWC numpy in [0, 1]."""
    if normalized:
        t = (t + 1.0) / 2.0
    return t.permute(0, 2, 3, 1).cpu().numpy()


def _rss_gb() -> float:
    """This process's resident memory in GB (0 where /proc does not say)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def _max_rss_gb(flag: float) -> float:
    """--max_rss_gb: negative means 90% of system RAM (0, no limit, where
    /proc does not say)."""
    if flag >= 0:
        return flag
    try:
        with open("/proc/meminfo") as f:
            return 0.9 * int(f.readline().split()[1]) / 1e6
    except OSError:
        return 0.0


class _StepProfiler:
    """--profile_dir: a torch.profiler trace from the end of G step 10 to
    the end of G step 15, written to the directory as Chrome trace JSON."""

    START, STOP = 10, 15

    def __init__(self, directory: Optional[str], device: torch.device):
        self.directory = directory
        self.device = device
        self.prof = None

    def after_g_step(self, step: int) -> None:
        if not self.directory:
            return
        if step == self.START:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
        elif step == self.STOP and self.prof is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prof.stop()
            os.makedirs(self.directory, exist_ok=True)
            path = os.path.join(
                self.directory,
                f"trace_steps_{self.START + 1}-{self.STOP}.json")
            self.prof.export_chrome_trace(path)
            self.prof = None
            LOG.info("wrote profiler trace %s", path)

    def close(self) -> None:
        if self.prof is not None:  # the run ended inside the window
            self.prof.stop()
            self.prof = None


def join_data_parallel(a, config):
    """--data_parallel: this rank's `DataParallel`, after the checks that
    need no process group (the slices and the batch divide the world)."""
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    n_slices = a.n_slices or infer_n_slices()
    if n_slices < 1 or world % n_slices:
        raise SystemExit(f"--n_slices {n_slices} does not divide the world "
                         f"of {world} ranks")
    if config.batch_size % world:
        raise SystemExit(f"--batch_size {config.batch_size} not divisible "
                         f"by the {world}-rank mesh")
    return init_process_group(a.device, n_slices=n_slices)


def run(a, batches: Optional[Iterator] = None,
        on_step: Optional[Callable] = None) -> TrainState:
    """Train per the parsed flags `a` over `batches` (the dataset at
    --dataset_path when None; global batches under --data_parallel, of
    which each rank takes its rows); on_step(state, diagnostics) after
    each G and each D step (a D step's diagnostics hold `disc_loss`).
    Returns the final state, checkpointed."""
    config = build_config(a)
    dp = join_data_parallel(a, config) if a.data_parallel else None
    try:
        return _run(a, config, dp, batches, on_step)
    finally:
        if dp is not None:
            dp.close()


def _run(a, config, dp, batches, on_step) -> TrainState:
    device = resolve_device(a.device) if dp is None else dp.device
    main = dp is None or dp.is_main
    info = LOG.info if main else (lambda *args: None)
    exp_dir = os.path.join(a.experiments_dir,
                           f"{config.name}_{config.model_type}_{config.regime}")
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    os.makedirs(exp_dir, exist_ok=True)
    if a.resume_ckpt or a.warmstart_ckpt:
        state = checkpoints.restore_train_state(
            a.resume_ckpt or a.warmstart_ckpt, config, device,
            warmstart=a.resume_ckpt is None, seed=a.seed)
        info("%s %s at step %d",
                 "resumed" if a.resume_ckpt else "warmstarted from",
                 a.resume_ckpt or a.warmstart_ckpt, state.step)
    else:
        state = create_train_state(config, a.seed, device)
    if state.step >= config.n_steps:
        raise SystemExit(f"-steps {config.n_steps} <= restored step "
                         f"{state.step}: nothing to train (steps are "
                         f"absolute)")
    if dp is not None:
        data_parallel_(state, dp)
        info("data parallel: %s", dp)
    n_params = sum(p.numel() for p in state.model.parameters())
    info("codec parameters: %.1fM on %s", n_params / 1e6, device)
    lpips_fn = make_lpips_fn(a, device)
    step_g = make_train_step_g(config, lpips_fn)
    step_d = make_train_step_d(config) if config.use_discriminator else None
    d_per_g = config.discriminator_steps if step_d is not None else 0
    if batches is None and a.device_data:
        dataset = DeviceDataset(a.dataset_path, config.crop_size,
                                config.batch_size, a.seed, device, mesh=dp)
        info("device-resident dataset: %s (%.0f MB on %s)",
                 tuple(dataset.data.shape), dataset.data.numel() / 1e6,
                 device)
        batches = dataset.batches()  # on the device: no prefetch thread
    elif batches is None:
        dataset = TrainDataset(a.dataset_path, config.crop_size, a.seed)
        batches = prefetch(dataset.batches(config.batch_size, mesh=dp),
                           size=4)
    elif dp is not None:
        batches = ((dp.shard(x), dp.shard(bpp)) for x, bpp in batches)

    eval_fn = None
    if a.eval_dataset_path and main:
        # One fixed held-out batch and a fixed noise seed: eval curves
        # comparable across steps and runs.
        eval_ds = TrainDataset(a.eval_dataset_path, config.crop_size,
                               a.seed + 1)
        eval_batch, _ = next(eval_ds.batches(config.batch_size,
                                             num_workers=1))
        eval_fn = make_eval_step(config, lpips_fn)
        recon_dir = os.path.join(exp_dir, "reconstructions")
        os.makedirs(recon_dir, exist_ok=True)

    writer = MetricWriter(os.path.join(exp_dir, "tensorboard")) if main \
        else None
    max_rss_gb = _max_rss_gb(a.max_rss_gb)
    profiler = _StepProfiler(a.profile_dir if main else None, device)
    t0, last_step = time.perf_counter(), state.step
    d_pending = 0  # D steps still to take after the last G step
    try:
        for x, _ in batches:
            if d_pending:
                diag = step_d(state, x)
                d_pending -= 1
            else:
                diag = diagnostics = step_g(state, x)
                d_pending = d_per_g
                profiler.after_g_step(state.step)
            if on_step is not None:
                on_step(state, diag)
            if d_pending:
                continue
            # The end of a G step's cycle: log, save, stop.
            step = state.step
            if step % config.log_interval == 1:
                scalars = {k: float(v) for k, v in diagnostics.items()}
                scalars["images_per_sec"] = (
                    (step - last_step) * config.batch_size * (1 + d_per_g)
                    / max(time.perf_counter() - t0, 1e-9))
                scalars["host_rss_gb"] = (_rss_gb() if dp is None
                                          else dp.max(_rss_gb()))
                if main:
                    writer.write(step, scalars, prefix="train/")
                if max_rss_gb and scalars["host_rss_gb"] > max_rss_gb:
                    # A checkpoint and a clean stop beat the kernel's
                    # SIGKILL.
                    path = checkpoints.save_checkpoint(ckpt_dir, state,
                                                       config)
                    raise SystemExit(
                        f"host RSS {scalars['host_rss_gb']:.1f} GB > "
                        f"--max_rss_gb {max_rss_gb:.1f}: checkpointed "
                        f"{path}; resume with --resume_ckpt (or train "
                        f"with --device_data to avoid per-step upload "
                        f"retention)")
                info("step %d | loss %.3f | q_bpp %.3f | %.1f img/s",
                         step, scalars["weighted_compression_loss"],
                         scalars["q_rate"], scalars["images_per_sec"])
                if eval_fn is not None:
                    noise = torch.Generator(device=device).manual_seed(
                        a.seed + 2)
                    ediag, einter = eval_fn(state, eval_batch, noise)
                    writer.write(step, {k: float(v) for k, v in ediag.items()},
                                 prefix="test/")
                    x_in = _nhwc(einter.input_image,
                                 config.normalize_input_image)
                    recon = _nhwc(einter.reconstruction,
                                  config.normalize_input_image)
                    writer.write_images(step, {"test/input": x_in,
                                               "test/reconstruction": recon})
                    save_side_by_side(
                        os.path.join(recon_dir, f"step_{step}.png"),
                        x_in, recon)
                t0, last_step = time.perf_counter(), step
            if step % config.save_interval == 0:
                checkpoints.save_checkpoint(ckpt_dir, state, config)
            if step >= config.n_steps:
                break
    finally:
        profiler.close()
        if writer is not None:
            writer.close()
    if d_pending:
        LOG.warning("the batches ran out %d D step(s) short of step %d's "
                    "cycle: a resume from its checkpoint starts with a G "
                    "step", d_pending, state.step)
    path = checkpoints.save_checkpoint(ckpt_dir, state, config)
    info("final checkpoint %s", path)
    return state


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(message)s")
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
