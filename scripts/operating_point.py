"""What bench.py's operating point codes on one NVIDIA card, with the
seeded weights `init_random_` draws alone and with `chip_smoke.py`'s
(`code_real_symbols_`), in fp32 and bf16.

    python3 scripts/operating_point.py [--out FILE]

The flagship configuration (`chip_smoke.load_weights` without the
artifact). For each set of weights and dtype: the codec on the card, its
encoder's output scaled by `chip_smoke.calibrate` into 0.20-0.45 bpp on
`bench_image(0)`, then `compress_many` / `decompress_many` of the four
seeded 1024x1024 images of the batch path, and
`chip_smoke.operating_point` of them: the share of nonzero z and y
symbols, the distinct coding indices, the decoded pixels' spread, and
whether that point is degenerate (`chip_smoke.degenerate`, the batch
path's gate). Prints the card and one JSON object,
also written to FILE with `--out`. Needs one CUDA card.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402


def measure(state, config, dtype: str) -> dict:
    from hific_tpu_torch.codec import Codec

    codec = Codec(config.replace(dtype=dtype), state, device="cuda")
    codec.build_tables()
    alpha, bpp = chip_smoke.calibrate(codec, chip_smoke.bench_image(0))
    imgs = [chip_smoke.bench_image(s) for s in (1, 2, 3, 4)]
    outs = codec.compress_many(imgs)
    recons = codec.decompress_many(outs, as_uint8=True)
    row = {"alpha": alpha, "probe_bpp": bpp,
           "bpp": float(np.mean([o.total_bpp for o in outs])),
           "hyperlatent_bpp": float(np.mean([o.hyperlatent_bpp
                                             for o in outs]))}
    row["point"] = chip_smoke.operating_point(codec, imgs, recons)
    row["degenerate"] = chip_smoke.degenerate(row["point"])
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("operating_point: no CUDA device", file=sys.stderr)
        return 1
    from hific_tpu_torch.config import Config
    from hific_tpu_torch.models.hific import HiFiC, init_random_

    card = chip_smoke.card_line()
    print(card, flush=True)
    config = Config()
    results = {"card": card}
    for weights in ("init_random_", "code_real_symbols_"):
        model = init_random_(HiFiC(config),
                             torch.Generator().manual_seed(chip_smoke.SEED))
        if weights == "code_real_symbols_":
            chip_smoke.code_real_symbols_(model, chip_smoke.SEED)
        for dtype in ("float32", "bfloat16"):
            results[f"{weights} {dtype}"] = measure(model.state_dict(),
                                                    config, dtype)
    text = json.dumps(results)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
