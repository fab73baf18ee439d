"""Multi-rank dry run; counterpart of the JAX package's
`dryrun_multichip` (`__graft_entry__.py`), with the spawner and the rank
driver that the tests and `chip_smoke.py` start ranks with.

    python -m hific_tpu_torch.parallel.dryrun 4 --device cpu \\
        [--json summary.json]

`spawn` starts n ranks with the spawn start method (a child imports only
this package, never JAX) and a `file://` rendezvous in a directory of its
own, so no port is needed. `train_rank` is one rank of a data-parallel
run of the library's steps (`training/train_step.py` under DDP) on its
rows of given global batches; `cli_rank` one rank of the trainer CLI.
`dryrun_multichip(n)` runs a tiny GAN G step and D step over n ranks (the
(replica, data) = (2, n / 2) layout where n is even and at least 4), then
checks the partitioned encoder and the spatial codec against the
whole-image ones in this process.
"""

import contextlib
import os
import tempfile
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from hific_tpu_torch.parallel.mesh import init_process_group, make_mesh


def spawn(fn: Callable, n_ranks: int, *args, workdir: str,
          cpu_threads: Optional[int] = None) -> list:
    """Run `fn(rank, n_ranks, init_method, *args)` in `n_ranks` spawned
    processes, the rendezvous a file in `workdir` (which must not hold
    one); returns their return values by rank. A rank that raises makes
    this raise, with its traceback. cpu_threads: torch's CPU threads in
    each rank (1 where several ranks share a few cores)."""
    os.makedirs(workdir, exist_ok=True)
    torch.multiprocessing.start_processes(
        _entry, args=(fn, n_ranks, workdir, cpu_threads, args),
        nprocs=n_ranks, join=True, start_method="spawn")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n_ranks)]


def _entry(rank, fn, n_ranks, workdir, cpu_threads, args):
    if cpu_threads is not None:
        torch.set_num_threads(cpu_threads)
    init = "file://" + os.path.join(os.path.abspath(workdir), "rendezvous")
    result = fn(rank, n_ranks, init, *args)
    torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))


def _lpips_fn(spec, device):
    """None, {"seed": s} (the seeded backbone `cli/train.py` builds) or
    {"state_dict": sd} -> LPIPS on [0, 1] images, or None."""
    if spec is None:
        return None
    from hific_tpu_torch.models.lpips import LPIPS, load_lpips

    if "state_dict" in spec:
        net = LPIPS()
        net.load_state_dict(spec["state_dict"])
    else:
        net, _ = load_lpips(seed=spec["seed"])
    net = net.to(device, memory_format=torch.channels_last)
    return lambda x_gen, x_real: net(x_gen, x_real, normalize=True)


def _fixed_noise(noise: dict):
    """`hyperprior.quantize_noise` adding given noise, keyed by the GLOBAL
    batch's NHWC shape: this rank's rows of it."""
    from hific_tpu_torch.ops.quantize import current_batch_shard

    def add(x, generator):
        index, count = current_batch_shard() or (0, 1)
        n = x.shape[0]
        full = noise[(n * count, x.shape[2], x.shape[3], x.shape[1])]
        rows = torch.from_numpy(np.ascontiguousarray(
            full[index * n:(index + 1) * n])).permute(0, 3, 1, 2)
        return x + rows.to(x.device, x.dtype)

    return add


@contextlib.contextmanager
def deterministic_algorithms():
    """`torch.use_deterministic_algorithms(True, warn_only=True)` for the
    block: cuDNN then picks deterministic convolution algorithms whatever
    `cudnn.deterministic` says (the train step sets it off), so two runs of
    a step sum each gradient in one order."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norm_counts():
    from hific_tpu_torch.ops import fused_norm

    return (fused_norm.KERNEL.launches, fused_norm.BACKWARD_KERNEL.launches)


def train_rank(rank: int, world: int, init_method: str, *jobs: dict
               ) -> list:
    """One rank of data-parallel runs of the library's G and D steps, one
    run per job, in one process group (the first job's device, backend
    and n_slices).

    job: `config` (Config JSON), `device` ("cpu", "cuda" for
    cuda:LOCAL_RANK, or "cuda:i", which ranks may share under gloo),
    optional `backend`, `n_slices`, `checkpoint` (a `step_<N>.pt` to
    resume from; else `create_train_state(config, 0)` with optional
    `state_dicts` {"model", "disc"} loaded over it), `lpips` (see
    `_lpips_fn`), `noise` (fixed quantization noise by global NHWC shape,
    the tests' shared noise), `steps` [("G" | "D", global batch)],
    `deterministic` (indices of the steps run under deterministic
    algorithms: cuDNN's atomics otherwise reorder the sums of a gradient
    run to run), and `grads` / `params` (rank 0 returns the gradients of
    the stepped module after each step, or after the steps of a list of
    indices / the final state dicts).

    Returns per job the rank's diagnostics, norm launches and time (host
    clock after the device's work, ms) per step, a checksum of its
    parameters after the steps (float64 sum per leaf), what rank 0 was
    asked for, and the rank's `DataParallel` as text."""
    first = jobs[0]
    dp = init_process_group(first["device"], first.get("backend"),
                            first.get("n_slices", 1), rank, world,
                            init_method)
    try:
        return [_run_job(dp, job) for job in jobs]
    finally:
        dp.close()


def _run_job(dp, job: dict) -> dict:
    import hific_tpu_torch.models.hyperprior as hyperprior_module
    from hific_tpu_torch.config import Config
    from hific_tpu_torch.training.checkpoints import restore_train_state
    from hific_tpu_torch.training.train_step import (
        create_train_state, data_parallel_, make_train_step_d,
        make_train_step_g)

    saved_noise = hyperprior_module.quantize_noise
    if job.get("noise") is not None:
        hyperprior_module.quantize_noise = _fixed_noise(job["noise"])
    try:
        config = Config.from_json(job["config"])
        if job.get("checkpoint"):
            state = restore_train_state(job["checkpoint"], config, dp.device)
        else:
            state = create_train_state(config, 0, dp.device)
            sds = job.get("state_dicts") or {}
            if "model" in sds:
                state.model.load_state_dict(sds["model"])
            if "disc" in sds:
                state.disc.load_state_dict(sds["disc"])
        data_parallel_(state, dp)
        step_g = make_train_step_g(config, _lpips_fn(job.get("lpips"),
                                                     dp.device))
        step_d = (make_train_step_d(config) if config.use_discriminator
                  else None)
        out = {"dp": repr(dp), "diagnostics": [], "launches": [],
               "grads": [], "ms": []}
        grads = job.get("grads")
        for i, (kind, batch) in enumerate(job["steps"]):
            batch = dp.shard(batch)
            _sync(dp.device)
            c0, t0 = _norm_counts(), time.perf_counter()
            with (deterministic_algorithms()
                  if i in job.get("deterministic", ())
                  else contextlib.nullcontext()):
                diag = (step_g if kind == "G" else step_d)(state, batch)
            _sync(dp.device)
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["diagnostics"].append({k: float(v) for k, v in diag.items()})
            out["launches"].append(tuple(
                b - a for a, b in zip(c0, _norm_counts())))
            if dp.is_main and (grads is True
                               or isinstance(grads, list) and i in grads):
                module = state.model if kind == "G" else state.disc
                out["grads"].append({n: p.grad.detach().cpu()
                                     for n, p in module.named_parameters()})
        modules = [state.model] + ([state.disc] if state.disc is not None
                                   else [])
        out["checksum"] = [float(p.detach().double().sum())
                           for m in modules for p in m.parameters()]
        if job.get("params") and dp.is_main:
            out["params"] = {
                "model": {k: v.cpu() for k, v in
                          state.model.state_dict().items()},
                "disc": ({k: v.cpu() for k, v in
                          state.disc.state_dict().items()}
                         if state.disc is not None else None)}
        return out
    finally:
        hyperprior_module.quantize_noise = saved_noise


def cli_rank(rank: int, world: int, init_method: str, argv: list):
    """`cli.train.main(argv)` as one rank of a gloo process group joined at
    `init_method` (what `torch.distributed.run` arranges through the
    environment, without a port). Returns the final step."""
    import torch.distributed as dist

    from hific_tpu_torch.cli import train as train_cli

    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    try:
        return train_cli.run(train_cli.parse_args(argv)).step
    finally:
        dist.destroy_process_group()


def _tiny_config(batch_size: int, gan: bool):
    from hific_tpu_torch.config import hific_config, mse_lpips_config

    make = hific_config if gan else mse_lpips_config
    return make(latent_channels=8, n_residual_blocks=1,
                hyperlatent_filters=16, crop_size=64, batch_size=batch_size)


def _band_mesh(n: int, device: torch.device):
    """n bands: n distinct devices of the type where there are enough,
    else `device` n times."""
    from hific_tpu_torch.parallel.mesh import visible_devices

    devices = visible_devices(device.type)
    return make_mesh(devices[:n] if len(devices) >= n else [device] * n)


def dryrun_multichip(n_ranks: int, device="cpu",
                     workdir: Optional[str] = None) -> dict:
    """A tiny GAN G step and D step over `n_ranks` spawned ranks (global
    batch 2 n, each rank on `device`: "cpu" under gloo; "cuda" gives rank
    r cuda:r under NCCL where there are n cards, else every rank shares
    cuda:0 under gloo), asserting finite losses and equal parameters on
    every rank after them; then, in this process, the partitioned encoder
    equal to the whole image's and the spatial codec against `compress` /
    `decompress` (bytes equal, pixels within one level, the non-divisible
    fallback equal to `decompress`) over n / 2 bands in the 2-slice layout
    (n even and at least 4), else n."""
    from hific_tpu_torch.codec import Codec
    from hific_tpu_torch.models.hific import HiFiC, init_random_
    from hific_tpu_torch.runtime import fp32_numerics

    device = torch.device(device)
    n_slices = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    batch = 2 * n_ranks
    config = _tiny_config(batch, gan=True)
    rng = np.random.RandomState(0)
    xg = rng.rand(batch, 64, 64, 3).astype(np.float32)
    xd = rng.rand(batch, 64, 64, 3).astype(np.float32)
    rank_device, backend = "cpu", "gloo"
    if device.type == "cuda":
        shared = torch.cuda.device_count() < n_ranks
        rank_device = "cuda:0" if shared else "cuda"
        backend = "gloo" if shared else "nccl"
    job = {"config": config.to_json(), "device": rank_device,
           "backend": backend, "n_slices": n_slices,
           "steps": [("G", xg), ("D", xd)]}
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        ranks = [r[0] for r in spawn(
            train_rank, n_ranks, job, workdir=tmp,
            cpu_threads=1 if device.type == "cpu" else None)]
    g_loss = ranks[0]["diagnostics"][0]["weighted_compression_loss"]
    d_loss = ranks[0]["diagnostics"][1]["disc_loss"]
    assert np.isfinite(g_loss) and np.isfinite(d_loss), (g_loss, d_loss)
    for r in ranks[1:]:
        assert r["diagnostics"] == ranks[0]["diagnostics"], "diagnostics"
        assert r["checksum"] == ranks[0]["checksum"], "parameters differ"

    # One image's encoder in row bands over the data axis, exactly the
    # whole image's.
    n_data = n_ranks // n_slices
    mesh = _band_mesh(n_data, device)
    codec_cfg = _tiny_config(1, gan=False)
    weights = torch.Generator().manual_seed(1)
    model = init_random_(HiFiC(codec_cfg), weights).to(
        device, memory_format=torch.channels_last).eval()
    from hific_tpu_torch.parallel.spatial import replicate, spatial_encode_fn

    # 64 rows a band (the JAX dry run's), 128 at two bands, where the
    # halo'd window must still fit in the image.
    rows = (64 if n_data != 2 else 128) * n_data
    x_sp = torch.from_numpy(rng.rand(1, 3, rows, 64).astype(
        np.float32)).to(device).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode(), fp32_numerics(deterministic=True):
        want = model.encoder(x_sp)
        got = spatial_encode_fn(lambda m, t: m.encoder(t), mesh, halo=64)(
            replicate(model, mesh), x_sp)
    enc_err = float((got - want).abs().max())
    assert enc_err <= 1e-5 * float(want.abs().max()), enc_err

    # The spatial codec against the whole-image one.
    codec = Codec(codec_cfg, model.state_dict(), device=device)
    codec.build_tables()
    x_codec = rng.rand(1, 256 * n_data, 32, 3).astype(np.float32)
    out_sp = codec.compress_spatial(x_codec, mesh)
    out_1d = codec.compress(x_codec)
    assert (np.array_equal(out_sp.latents_encoded, out_1d.latents_encoded)
            and np.array_equal(out_sp.hyperlatents_encoded,
                               out_1d.hyperlatents_encoded)), "streams"
    recon_sp = codec.decompress_spatial(out_sp, mesh, halo_latents=8)
    recon_1d = codec.decompress(out_1d)
    pix_err = float(np.abs(recon_sp - recon_1d).max())
    u8 = [np.clip(r * 255.0 + 0.5, 0, 255).astype(np.int32)
          for r in (recon_sp, recon_1d)]
    assert pix_err <= 1e-4 and np.abs(u8[0] - u8[1]).max() <= 1, pix_err

    # A compress() file whose latent rows do not band over the mesh
    # decodes through the single-device generator: == decompress().
    out_small = codec.compress(rng.rand(1, 48, 32, 3).astype(np.float32))
    assert np.array_equal(codec.decompress_spatial(out_small, mesh),
                          codec.decompress(out_small)), "fallback"
    summary = {"ranks": n_ranks, "n_slices": n_slices, "bands": n_data,
               "rank_norm_launches": [sum(f for f, _ in r["launches"])
                                      for r in ranks],
               "g_loss": g_loss, "d_loss": d_loss,
               "encoder_max_abs_err": enc_err, "pixel_max_abs_err": pix_err,
               "dp": ranks[0]["dp"]}
    print(f"dryrun_multichip({n_ranks}): ok, {summary}")
    return summary


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description="Multi-rank dry run of the "
                                            "port's parallel paths")
    p.add_argument("n_ranks", type=int)
    p.add_argument("--device", default="cuda", help="cuda (the default) "
                   "or cpu")
    p.add_argument("--json", default=None,
                   help="also write the summary to this file")
    a = p.parse_args(argv)
    summary = dryrun_multichip(a.n_ranks, device=a.device)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(summary, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
