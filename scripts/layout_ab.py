"""The layout rewrites' time on one NVIDIA card: the generator with the
depth-to-space tail (`d2s_generator_tail`) on against off, and the encoder
with the space-to-depth front (`s2d_encoder_front`) on against off, in
fp32 and bf16, in turns.

    python3 scripts/layout_ab.py [--out FILE] [--turns 4]

The flagship configuration on seeded random weights (`chip_smoke.py`'s),
under the codec's numerics (`runtime.fp32_numerics`, deterministic).
Inputs: four seeded 1024x1024 images (`chip_smoke.bench_image`) for the
encoder, and the encoder's float32 latents of them for the generator (the
decode path hands it float32 latents in either dtype). Each turn times
each setting, on before off in even turns and off before on in odd ones:
the CUDA-event time of one image (median of 5, the shapes warm; where the
host cannot keep the card busy this is the host's time) and the device
busy time of one image under torch.profiler (the sum of its kernels'
device times). Prints the card and one JSON object (per setting the
medians over the turns, and every turn), also written to FILE with
`--out`. Needs one CUDA card.
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


def one_setting(module, attr: str, flag: bool, inputs) -> dict:
    """`module` with `attr` set to `flag`: after a warm call on every
    input, the CUDA-event ms of one input (median of 5) and its device
    busy ms under the profiler."""
    from hific_tpu_torch.runtime import fp32_numerics

    setattr(module, attr, flag)
    with torch.inference_mode(), fp32_numerics(deterministic=True):
        for v in inputs:
            module(v)
        torch.cuda.synchronize()
        event = chip_smoke.event_ms(lambda: module(inputs[0]), 5, warm=True)
        _, _, busy = chip_smoke.profiled(lambda: module(inputs[0]))
    return {"event_ms": event, "device_busy_ms": busy}


def ab(module, attr: str, inputs, turns: int) -> dict:
    """Both settings of `attr`, `turns` times in alternating order; the
    attribute is put back as it was."""
    saved = getattr(module, attr)
    runs = {"on": [], "off": []}
    for t in range(turns):
        for flag in ((True, False) if t % 2 == 0 else (False, True)):
            runs["on" if flag else "off"].append(
                one_setting(module, attr, flag, inputs))
    setattr(module, attr, saved)
    out = {"turns": runs}
    for key in ("event_ms", "device_busy_ms"):
        for side in ("on", "off"):
            out[f"{side}_{key}"] = float(np.median([r[key]
                                                    for r in runs[side]]))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--turns", type=int, default=4)
    parser.add_argument("--weights", default=os.path.join(
        ROOT, "artifacts", "flagship_rd30k_f16.npz"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("layout_ab: no CUDA device", file=sys.stderr)
        return 1
    from hific_tpu_torch.codec import Codec
    from hific_tpu_torch.ops import fused_norm
    from hific_tpu_torch.runtime import fp32_numerics

    card = chip_smoke.card_line()
    print(card, flush=True)
    fused_norm.LIBRARY.load()
    config, state, source = chip_smoke.load_weights(args.weights,
                                                    chip_smoke.SEED)
    imgs = [chip_smoke.bench_image(s) for s in (1, 2, 3, 4)]
    result = {"card": card, "weights": source, "images": "4 x 1024x1024",
              "torch": torch.__version__}
    for dtype in ("float32", "bfloat16"):
        model = Codec(config.replace(dtype=dtype), state,
                      device="cuda").model
        with torch.inference_mode(), fp32_numerics(deterministic=True):
            xs = [torch.from_numpy(x).cuda().permute(0, 3, 1, 2).float()
                  .div(255.0).contiguous(memory_format=torch.channels_last)
                  for x in imgs]
            latents = [model.encoder(x).float() for x in xs]
        result[dtype] = {
            "generator_d2s": ab(model.generator, "d2s_tail", latents,
                                args.turns),
            "encoder_s2d": ab(model.encoder, "s2d_front", xs, args.turns)}
        for name, r in result[dtype].items():
            chip_smoke.log(
                f"{dtype} {name}: on {r['on_event_ms']:.2f} ms (device busy "
                f"{r['on_device_busy_ms']:.2f}), off {r['off_event_ms']:.2f} "
                f"ms (device busy {r['off_device_busy_ms']:.2f}); medians of "
                f"{args.turns} turns, one 1024x1024 image ({card})")
        del model
        torch.cuda.empty_cache()
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
