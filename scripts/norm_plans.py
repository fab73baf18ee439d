"""Time the ChannelNorm forward kernel's launch plans on one NVIDIA card.

    python3 scripts/norm_plans.py [--out FILE]

At every distinct (M, C, act) of `chip_smoke.py` phase 3's three sets (the
768x512 round trip, a batch-8 256x256 training step and one 1024x1024
image), in fp32 and bf16, on seeded inputs: the rows path
(`fused_norm.rows_plan`, where the rows allow it), the tiles path
(`fused_norm.tiles_plan`) with ring tiles of 1, 2 and 4 KB and 2 or 4
stages, and the plan `fused_norm.forward_plan` picks, each checked against
the plain version and timed as phase 3 times the kernel
(`chip_smoke.cuda_time_ms`: 20 launches in a CUDA graph between two
events). Prints the card and one line per shape, and with `--out` writes
every time to FILE as one JSON object.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def shapes():
    from hific_tpu_torch.config import Config

    config = Config()
    seen = []
    for m, c, act in (
            chip_smoke.main_path_norm_shapes(config, chip_smoke.IMAGE_H,
                                             chip_smoke.IMAGE_W)
            + chip_smoke.train_step_norm_shapes(config, chip_smoke.TRAIN_BATCH,
                                                chip_smoke.TRAIN_CROP)
            + chip_smoke.main_path_norm_shapes(config, 1024, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            if (m, c, act, dtype) not in seen:
                seen.append((m, c, act, dtype))
    return seen


def plans(m, c, itemsize, sms):
    from hific_tpu_torch.ops import fused_norm

    out = {"picked": fused_norm.forward_plan(m, c, itemsize, sms)}
    rows = fused_norm.rows_plan(m, c, itemsize)
    if rows is not None:
        out["rows"] = rows
    for tile in (1024, 2048, 4096):
        for stages in (2, 4):
            out[f"tiles {tile} B x {stages}"] = fused_norm.tiles_plan(
                m, c, itemsize, sms, ring_tile=tile, ring_stages=stages)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("norm_plans: no CUDA device", file=sys.stderr)
        return 1
    from hific_tpu_torch.ops import fused_norm

    card = chip_smoke.card_line()
    print(card, flush=True)
    sms = fused_norm._sm_count(0)
    results = []
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    for m, c, act, dtype in shapes():
        x = torch.randn((1, m, 1, c), generator=gen, device="cuda")
        x = x.permute(0, 3, 1, 2).to(dtype).contiguous(
            memory_format=torch.channels_last)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(c, generator=gen, device="cuda")
        want = fused_norm.channel_norm_fused_reference(
            x, gamma, beta, act=act).float()
        limit = (chip_smoke.FP32_TOL if dtype == torch.float32
                 else chip_smoke.bf16_ulp(want) + chip_smoke.FP32_TOL)
        out = torch.empty_like(x)
        row = {"m": m, "c": c, "act": act, "dtype": str(dtype)[6:]}
        seen = {}
        for name, plan in plans(m, c, x.element_size(), sms).items():
            if plan not in seen:
                def launch(plan=plan):
                    fused_norm.KERNEL.launch(x, gamma, beta, out, 1e-3,
                                             act == "relu", plan=plan)
                launch()
                if not bool(((out.float() - want).abs() <= limit).all()):
                    raise AssertionError(f"M={m} C={c} {dtype} {plan}: "
                                         f"differs from the plain version")
                seen[plan] = chip_smoke.cuda_time_ms(launch)
            row[name] = {"plan": list(plan), "ms": seen[plan]}
        results.append(row)
        print(f"M={m} C={c} {act} {row['dtype']}: " + ", ".join(
            f"{k} {v['ms'] * 1e3:.1f} us" for k, v in row.items()
            if isinstance(v, dict)), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "shapes": results}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
