"""A/B of the ChannelNorm forward kernel of two checkouts on one NVIDIA card.

    python3 scripts/norm_ab.py --parent DIR

DIR is a checkout of the earlier commit, for example
`mkdir -p _ab/parent && git archive <commit> | tar -x -C _ab/parent
--exclude=artifacts --exclude='demo_out*'` (`_ab/` is gitignored). Four
turns, parent, change, change, parent, each in a process of its own that
imports that checkout's `hific_tpu_torch.ops.fused_norm`: it builds the
checkout's `csrc/channel_norm.cu` (nvcc, into its own `_build/`) and calls
its `channel_norm_fused` at every distinct forward shape of this checkout's
`chip_smoke.py` phase 3 (the 768x512 round trip, a batch-8 256x256 training
step and one 1024x1024 image, each in fp32 and in bf16), on the same seeded
inputs, checked against its plain version and timed as phase 3 times it
(`chip_smoke.cuda_time_ms`: 20 calls in a CUDA graph between two events).
Each side goes through its own C interface and wrapper. Prints the card,
one line per shape and one JSON line (also written to `--out FILE`);
`--log FILE` keeps each turn's output.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def root_chip_smoke():
    """This checkout's chip_smoke.py, whatever checkout is on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "norm_ab_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def shape_sets():
    """{set name: [(M, C, act, dtype name)]}, distinct shapes in call
    order."""
    sys.path.insert(0, ROOT)
    from hific_tpu_torch.config import Config

    cs = root_chip_smoke()
    config = Config()  # the flagship: C=220, 9 residual blocks
    rows = {
        "round_trip_768x512": cs.main_path_norm_shapes(
            config, cs.IMAGE_H, cs.IMAGE_W),
        "train_step_b8_256": cs.train_step_norm_shapes(
            config, cs.TRAIN_BATCH, cs.TRAIN_CROP),
        "bench_1024x1024": cs.main_path_norm_shapes(config, 1024, 1024),
    }
    sets = {}
    for name, shapes in rows.items():
        for dtype in ("float32", "bfloat16"):
            key = f"{name} {dtype}"
            sets[key] = []
            for m, c, act in shapes:
                if (m, c, act, dtype) not in sets[key]:
                    sets[key].append((m, c, act, dtype))
    return sets


def child(tree: str, shapes) -> int:
    """One turn: the checkout's kernel times as one JSON line, last."""
    sys.path.insert(0, tree)
    import torch
    from hific_tpu_torch.ops import fused_norm

    if not os.path.abspath(fused_norm.__file__).startswith(tree):
        raise RuntimeError(f"imported {fused_norm.__file__}, not {tree}'s")
    cs = root_chip_smoke()
    times = {}
    for m, c, act, dtype_name in shapes:
        dtype = getattr(torch, dtype_name)
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + m + c)
        x = torch.randn((1, m, 1, c), generator=gen, device="cuda")
        x = x.permute(0, 3, 1, 2).to(dtype).contiguous(
            memory_format=torch.channels_last)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
        got = fused_norm.channel_norm_fused(x, gamma, beta, act=act).float()
        want = fused_norm.channel_norm_fused_reference(
            x, gamma, beta, act=act).float()
        limit = (cs.FP32_TOL if dtype == torch.float32
                 else cs.bf16_ulp(want) + cs.FP32_TOL)
        if not bool(((got - want).abs() <= limit).all()):
            raise AssertionError(f"{tree}: M={m} C={c} {dtype_name} differs "
                                 f"from the plain version")
        times[f"{m} {c} {act} {dtype_name}"] = cs.cuda_time_ms(
            lambda: fused_norm.channel_norm_fused(x, gamma, beta, act=act))
    print(json.dumps(times))
    return 0


def turn(tree: str, shapes, log) -> dict:
    run = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", tree,
         "--shapes", json.dumps(shapes)], cwd=tree, capture_output=True,
        text=True)
    if log:
        with open(log, "a") as f:
            f.write(f"== {tree}\n{run.stdout}{run.stderr}")
    if run.returncode:
        raise RuntimeError(f"turn in {tree} failed ({run.returncode}):\n"
                           f"{run.stdout[-3000:]}{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent")
    parser.add_argument("--child")
    parser.add_argument("--shapes")
    parser.add_argument("--log")
    parser.add_argument("--out")
    args = parser.parse_args()
    if args.child:
        return child(os.path.abspath(args.child),
                     [tuple(s) for s in json.loads(args.shapes)])
    if not args.parent:
        parser.error("--parent DIR is required")
    import torch
    if not torch.cuda.is_available():
        print("norm_ab: no CUDA device", file=sys.stderr)
        return 1
    card = root_chip_smoke().card_line()
    print(card, flush=True)
    sets = shape_sets()
    shapes = sorted({s for rows in sets.values() for s in rows})
    parent = os.path.abspath(args.parent)
    turns = [turn(tree, shapes, args.log)
             for tree in (parent, ROOT, ROOT, parent)]
    results = {}
    for name, rows in sets.items():
        results[name] = []
        for m, c, act, dtype in rows:
            key = f"{m} {c} {act} {dtype}"
            p0, c0, c1, p1 = (t[key] for t in turns)
            row = {"m": m, "c": c, "act": act, "parent_ms": [p0, p1],
                   "change_ms": [c0, c1],
                   "change_over_parent": (c0 + c1) / (p0 + p1)}
            results[name].append(row)
            print(f"{name} M={m} C={c} {act}: parent {p0:.4f} ms, change "
                  f"{c0:.4f}, change {c1:.4f}, parent {p1:.4f} "
                  f"({row['change_over_parent']:.3f}x; {card})", flush=True)
    line = json.dumps({"card": card, "ab": results})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
