"""Dataset parity harness of the port: Kodak / CLIC evaluation against
expected numbers; counterpart of the JAX package's `cli/eval_kodak.py`.

    python -m hific_tpu_torch.cli.eval_kodak -ckpt params.npz -i kodak/ \\
        --expected expected_kodak_med.json [--scalar_rans] [--device cpu]

Compresses every image through the full `.hfc` codec (`cli/compress.py`
with `--pipeline`), prints the README-style per-image table (bpp, ratio,
PSNR, MS-SSIM, LPIPS) and the means, writes them to
`<output>/eval_report.json`, and with `--expected` diffs each metric
against the expected values: outside tolerance the command exits 1.

Expected-values JSON (every field optional):
    {
      "mean":      {"bpp": 0.30, "psnr": 30.4, "ms_ssim": 0.96, "lpips": 0.1},
      "per_image": {"kodim01": {"bpp": 0.32, "psnr": 29.1}, ...},
      "tolerance": {"bpp": 0.02, "psnr": 0.25, "ms_ssim": 0.005,
                    "lpips": 0.01}
    }
"""

import argparse
import json
import os
import sys

import numpy as np

from hific_tpu_torch.cli import compress as compress_cli

DEFAULT_TOL = {"bpp": 0.02, "psnr": 0.25, "ms_ssim": 0.005, "lpips": 0.01}
_METRIC_KEYS = {"bpp": "actual_bpp", "psnr": "psnr", "ms_ssim": "ms_ssim",
                "lpips": "lpips"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate a checkpoint on an image dataset (Kodak/CLIC; "
                    "PyTorch port)")
    p.add_argument("-ckpt", "--checkpoint_dir", required=True)
    p.add_argument("-i", "--input", required=True, help="image directory")
    p.add_argument("-o", "--output", default="eval_out")
    p.add_argument("--expected", default=None,
                   help="JSON of expected metrics to diff against")
    p.add_argument("--save", action="store_true",
                   help="save reconstructions next to the metrics")
    p.add_argument("--pipeline", type=int, default=4,
                   help="pipelined compression group size")
    p.add_argument("--shape_bucket", type=int, default=64)
    p.add_argument("--scalar_rans", action="store_true")
    p.add_argument("--no_lpips", action="store_true")
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--lpips_backbone_path", default=None)
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) unless named")
    return p.parse_args(argv)


def _fmt(v, nd=4):
    return "-" if v is None else f"{v:.{nd}f}"


def summarize(rows) -> dict:
    means = {}
    for name, key in [("bpp", "actual_bpp"), ("ratio", "compression_ratio"),
                      ("psnr", "psnr"), ("ms_ssim", "ms_ssim"),
                      ("lpips", "lpips")]:
        vals = [r[key] for r in rows if r.get(key) is not None]
        if vals:
            means[name] = float(np.mean(vals))
    return means


def print_table(rows, out=sys.stdout) -> dict:
    """README-style markdown table and means; returns the means."""
    cols = ["image", "bpp", "ratio", "psnr", "ms_ssim", "lpips"]
    print("| " + " | ".join(cols) + " |", file=out)
    print("|" + "---|" * len(cols), file=out)
    for r in rows:
        name = os.path.splitext(os.path.basename(r["file"]))[0]
        print("| {} | {} | {} | {} | {} | {} |".format(
            name, _fmt(r.get("actual_bpp")),
            _fmt(r.get("compression_ratio"), 1), _fmt(r.get("psnr"), 2),
            _fmt(r.get("ms_ssim"), 5), _fmt(r.get("lpips"), 5)), file=out)
    means = summarize(rows)
    print("| **mean** | {} | {} | {} | {} | {} |".format(
        _fmt(means.get("bpp")), _fmt(means.get("ratio"), 1),
        _fmt(means.get("psnr"), 2), _fmt(means.get("ms_ssim"), 5),
        _fmt(means.get("lpips"), 5)), file=out)
    return means


def diff_expected(rows, means, expected) -> list:
    """Compare with the expected-values JSON; returns the failures (empty:
    parity)."""
    tol = {**DEFAULT_TOL, **expected.get("tolerance", {})}
    failures = []

    def check(scope, want, got):
        for metric, exp_val in want.items():
            key = _METRIC_KEYS.get(metric, metric)
            got_val = got.get(metric if scope == "mean" else key)
            if got_val is None:
                failures.append(f"{scope}: metric '{metric}' not computed")
                continue
            d = abs(float(got_val) - float(exp_val))
            if d > tol.get(metric, 0.0):
                failures.append(
                    f"{scope}: {metric} = {got_val:.5f}, expected "
                    f"{exp_val:.5f} (|diff| {d:.5f} > tol "
                    f"{tol.get(metric, 0.0)})")

    if "mean" in expected:
        check("mean", expected["mean"], means)
    by_name = {os.path.splitext(os.path.basename(r["file"]))[0]: r
               for r in rows}
    for name, want in expected.get("per_image", {}).items():
        if name not in by_name:
            failures.append(f"per_image: '{name}' not found in results")
            continue
        check(name, want, by_name[name])
    return failures


def main(argv=None) -> dict:
    """Run the evaluation; returns the report (rows, means and, with
    --expected, the expected values and the failures)."""
    a = parse_args(argv)
    compress_argv = [
        "-ckpt", a.checkpoint_dir, "-i", a.input, "-o", a.output,
        "--pipeline", str(a.pipeline), "--shape_bucket", str(a.shape_bucket),
    ]
    for flag in ("save", "scalar_rans", "no_lpips"):
        if getattr(a, flag):
            compress_argv.append(f"--{flag}")
    for flag in ("lpips_weights", "lpips_backbone_path", "device"):
        if getattr(a, flag):
            compress_argv += [f"--{flag}", getattr(a, flag)]

    rows = sorted(compress_cli.main(compress_argv), key=lambda r: r["file"])
    means = print_table(rows)
    report = {"rows": rows, "mean": means}
    if a.expected:
        with open(a.expected) as f:
            expected = json.load(f)
        failures = diff_expected(rows, means, expected)
        report["expected"] = expected
        report["failures"] = failures
        if failures:
            print("\nPARITY FAIL:", file=sys.stderr)
            for failure in failures:
                print("  " + failure, file=sys.stderr)
        else:
            print("\nPARITY OK (all metrics within tolerance)")
    with open(os.path.join(a.output, "eval_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def cli(argv=None) -> int:
    """The command's exit code: 1 where a metric is outside tolerance."""
    return 1 if main(argv).get("failures") else 0


if __name__ == "__main__":
    sys.exit(cli())
