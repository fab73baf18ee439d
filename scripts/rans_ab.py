"""A/B of the device rANS kernels of two checkouts on one NVIDIA card.

    python3 scripts/rans_ab.py --parent DIR [--weights PATH]

DIR is a checkout of the earlier commit, for example
`mkdir -p _ab/parent && git archive <commit> | tar -x -C _ab/parent
--exclude=artifacts` (`_ab/` is gitignored). Four turns, parent, change,
change, parent, each in a process of its own that imports that checkout's
`chip_smoke.py` and package: it builds the checkout's kernels from its own
sources (nvcc, into its own `_build/`), makes the flagship codec from the
same weights (`--weights`, or seeded random ones where that file is
missing) and runs `chip_smoke.check_rans_kernels`, which checks the kernels
against their plain versions and the host coder and times each at every
shape of its phase 5 (CUDA events, median of 20, seeded symbols at escape
rate 0, the same in both checkouts). Each side goes through its own C
interface and wrappers, so any two checkouts compare whose
`check_rans_kernels(codec, card)` returns the per-shape timings first.
Prints the card, one line per kernel and shape, and one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "artifacts", "flagship_rd30k_f16.npz")


def child(tree: str, weights: str) -> int:
    """One turn: the checkout's kernel times as one JSON line, last."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke
    from hific_tpu_torch.codec import Codec

    card = chip_smoke.card_line()
    config, state, _ = chip_smoke.load_weights(weights, chip_smoke.SEED)
    codec = Codec(config, state, device="cuda")
    codec.build_tables()
    timed = chip_smoke.check_rans_kernels(codec, card)[0]
    torch.cuda.synchronize()
    print(json.dumps({f"{kernel} {shape}": r["ms"]
                      for (kernel, shape), r in timed.items()}))
    return 0


def turn(tree: str, weights: str, log: str) -> dict:
    run = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", tree,
         "--weights", weights], cwd=tree, capture_output=True, text=True)
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
    parser.add_argument("--weights", default=WEIGHTS)
    parser.add_argument("--log", default=os.path.join(
        ROOT, "chiprun_out", "rans_ab.log"))
    args = parser.parse_args()
    weights = os.path.abspath(args.weights)
    if args.child:
        return child(os.path.abspath(args.child), weights)
    if not args.parent:
        parser.error("--parent DIR is required")
    import torch
    if not torch.cuda.is_available():
        print("rans_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    card = chip_smoke.card_line()
    print(card, flush=True)
    os.makedirs(os.path.dirname(args.log), exist_ok=True)
    parent = os.path.abspath(args.parent)
    turns = [turn(tree, weights, args.log)
             for tree in (parent, ROOT, ROOT, parent)]
    results = []
    for key in turns[0]:
        if key not in turns[1]:
            continue
        p0, c0, c1, p1 = (t[key] for t in turns)
        row = {"kernel_shape": key, "parent_ms": [p0, p1],
               "change_ms": [c0, c1],
               "change_over_parent": (c0 + c1) / (p0 + p1)}
        results.append(row)
        print(f"{key}: parent {p0:.4f} ms, change {c0:.4f}, change "
              f"{c1:.4f}, parent {p1:.4f} ms "
              f"({row['change_over_parent']:.3f}x; {card})", flush=True)
    print(json.dumps({"card": card, "weights": weights, "ab": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
