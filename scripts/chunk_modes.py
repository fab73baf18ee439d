"""What batching the transforms would do to the batch codec's
`pipeline_chunk` on one NVIDIA card: a chunk's encoder front and generator
as one pass over the chunk's batch, against one pass an image (what
`hific_tpu_torch.codec` runs), held to the bar of per-image bytes and
pixels, and timed.

    python3 scripts/chunk_modes.py [--out FILE] [--layers]

The flagship configuration on seeded random weights (`chip_smoke.py`'s),
in fp32 and bf16, the encoder scaled into 0.20-0.45 bpp as `chip_smoke.py`
does (`calibrate`). Two sets: 4 x 1024x1024 and 16 x 256x256 seeded images
(`chip_smoke.bench_image`). For each dtype, set and mode ("per_image": the
codec at pipeline_chunk 4; "batched": this script's chunks of 4 through
`Codec._front` and `Codec._generate` in one pass each, each image's
synth_stats and the coders as the codec runs them) against the codec at
pipeline_chunk 1 on the same images: the images whose `.hfc` bytes differ,
the y and z symbols and coding indices that differ (the front's doing),
the decoded pixels of the same payloads that differ and by how much (the
generator's); and the time of a pass (compress, then decompress to uint8
numpy; host clock after synchronize, median of 5). Prints the card and one
JSON object, also written to FILE with `--out`. With `--layers` it
measures instead, for each of LAYER_CASES (dtype, image size, batch), each
leaf layer of the encoder front and of the generator on the batch against
the same layer on each image's rows of the same input (so that a
difference is that layer's own): the layers whose outputs differ, in call
order, with the largest difference and the count of elements.
"""

import argparse
import concurrent.futures
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

SETS = {"4x1024x1024": (4, 1024), "16x256x256": (16, 256)}
CHUNK = 4
# (dtype, height, width, batch) of the --layers measurement.
LAYER_CASES = [("bfloat16", 512, 768, 4), ("bfloat16", 512, 768, 2),
               ("bfloat16", 64, 64, 4), ("float32", 512, 768, 4),
               ("float32", 64, 64, 4), ("bfloat16", 1024, 1024, 4)]


def leaf_diffs(module, run, batch):
    """Run `run` on the batch, then on each of its images alone, every leaf
    layer of `module` given in the per-image runs its rows of the input it
    had in the batch run (so that a difference is that layer's own);
    returns the layers whose outputs differ, in call order: (name, largest
    difference, elements that differ)."""
    names = {m: n for n, m in module.named_modules()
             if n and not list(m.children())}
    inputs, seen, mode = {}, {}, {"i": None}

    def pre_hook(mod, inp):
        name = names[mod]
        if mode["i"] is None:
            inputs[name] = inp[0]
            return None
        i = mode["i"]
        return (inputs[name][i:i + 1],) + tuple(inp[1:])

    def hook(mod, inp, out):
        name = names[mod]
        if mode["i"] is None:
            seen[name] = [out.detach().float().clone(), []]
        else:
            seen[name][1].append(out.detach().float().clone())

    handles = [h for m in names for h in (m.register_forward_pre_hook(pre_hook),
                                          m.register_forward_hook(hook))]
    try:
        run(batch)
        for i in range(batch.shape[0]):
            mode["i"] = i
            run(batch[i:i + 1])
    finally:
        for h in handles:
            h.remove()
    out = []
    for name, (whole, parts) in seen.items():
        d = (whole - torch.cat(parts)).abs()
        if int((d > 0).sum()):
            out.append((name, float(d.max()), int((d > 0).sum())))
    return out


def layers(config, state):
    """The --layers measurement over LAYER_CASES."""
    from hific_tpu_torch.codec import Codec
    from hific_tpu_torch.runtime import fp32_numerics

    result = {}
    for dtype, h, w, n in LAYER_CASES:
        codec = Codec(config.replace(dtype=dtype), state, device="cuda")
        codec.build_tables()
        imgs = [chip_smoke.bench_image(s, h, w) for s in range(1, n + 1)]
        x = torch.cat([codec._model_input(i) for i in imgs])
        y_hats = codec._host_latents(codec.compress_many(imgs))
        with fp32_numerics(deterministic=True), torch.inference_mode():
            front = leaf_diffs(codec.model, codec.model.compress_front, x)
            gen = leaf_diffs(codec.model.generator, codec.model.generator,
                             torch.cat(y_hats))
        key = f"{dtype} {h}x{w} batch {n}"
        result[key] = {"front": front, "generator": gen}
        chip_smoke.log(f"{key}: front {front[:3]}, generator {gen[:3]}")
        del codec
        torch.cuda.empty_cache()
    return result


def batched_stage(codec, imgs):
    """compress_many's device work with the front of each chunk of CHUNK
    same-shape images in one pass (each image's hyperlatent bits from its
    own rows)."""
    from hific_tpu_torch.codec import _runs, _Staged
    from hific_tpu_torch.models.hific import _bits

    staged = []
    for run in _runs(imgs, lambda x: x.shape, CHUNK):
        y, z_sym, _ = codec._front(torch.cat([codec._model_input(x)
                                              for x in run]))
        for k, x in enumerate(run):
            z = z_sym[k:k + 1]
            mu, sigma, idx = codec.model.synth_stats(z, codec.scale_table)
            y_sym, latent_bits = codec.model.latent_symbols(y[k:k + 1], mu,
                                                            sigma)
            hyper_bits = _bits(codec.model.hyperprior.hyperlatent_density(
                z.float()))
            staged.append(_Staged(z, y_sym, idx, torch.stack(
                [hyper_bits.float(), latent_bits.float()]), x.shape[1:3]))
    return staged


def batched_decode(codec, outs):
    """decompress_many on the device decoder with the generator of each
    chunk of CHUNK same-shape payloads in one pass; uint8 numpy images."""
    from hific_tpu_torch.codec import _runs
    from hific_tpu_torch.runtime import Fetch

    y_hats, _ = codec._device_latents(outs)
    fetches = [Fetch(codec._generate(
        torch.cat([y for _, y in run]), run[0][0].spatial_shape, True))
        for run in _runs(list(zip(outs, y_hats)),
                         lambda item: item[1].shape, CHUNK)]
    return [img[None] for fetch in fetches for img in fetch.result()]


def run_mode(codec, imgs, mode: str):
    """`mode`'s payloads of `imgs` at CHUNK, its decoder (payloads -> uint8
    images) and the staged inputs behind the payloads."""
    from hific_tpu_torch.runtime import fp32_numerics

    if mode == "per_image":
        codec.pipeline_chunk = CHUNK
        outs = codec.compress_many(imgs)
        codec.pipeline_chunk = 1

        def decode(payloads):
            codec.pipeline_chunk = CHUNK
            images = codec.decompress_many(payloads)
            codec.pipeline_chunk = 1
            return images

        return outs, decode, lambda: [
            codec._stage(codec._model_input(x), x.shape[1:3]) for x in imgs]
    with fp32_numerics(deterministic=True), torch.inference_mode():
        staged = batched_stage(codec, imgs)
        outs = codec._device_compress(staged)

    def decode(payloads):
        with fp32_numerics(deterministic=True), torch.inference_mode():
            return batched_decode(codec, payloads)

    return outs, decode, lambda: staged


def hfc(out) -> bytes:
    from hific_tpu_torch.entropy import container

    f = io.BytesIO()
    container._save_to(f, out)
    return f.getvalue()


def compare(codec, imgs, mode: str):
    """`mode` at CHUNK against the codec at pipeline_chunk 1 on the same
    images, and the time of a pass of each."""
    codec.pipeline_chunk = 1
    outs1 = codec.compress_many(imgs)
    px1 = codec.decompress_many(outs1)
    sym1 = codec._fetch_symbols([codec._stage(codec._model_input(x),
                                              x.shape[1:3]) for x in imgs])
    outs4, decode, staged = run_mode(codec, imgs, mode)
    sym4 = codec._fetch_symbols(staged())
    px4 = decode(outs1)
    diff = {name: int(sum(int((getattr(a, name) != getattr(b, name)).sum())
                          for a, b in zip(sym1, sym4)))
            for name in ("y_sym", "z_sym", "idx")}
    pixel_diff = [np.abs(a.astype(int) - b.astype(int)) for a, b in
                  zip(px1, px4)]

    def one():
        return decode(run_mode(codec, imgs, mode)[0])

    one()
    ms = float(np.median([chip_smoke.timed(one)[1] for _ in range(5)]))
    return {"images": len(imgs),
            "hfc_differ": sum(hfc(a) != hfc(b) for a, b in zip(outs1, outs4)),
            "symbols_differ": diff,
            "pixels_differ": int(sum(int((d > 0).sum()) for d in pixel_diff)),
            "largest_pixel_difference": int(max(d.max() for d in pixel_diff)),
            "bpp": float(np.mean([o.total_bpp for o in outs1])),
            "chunk_4_ms": ms}


def pass_ms(codec, imgs):
    """A pass at pipeline_chunk 1: compress_many, decompress_many."""
    def one():
        return codec.decompress_many(codec.compress_many(imgs))

    one()
    return float(np.median([chip_smoke.timed(one)[1] for _ in range(5)]))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--layers", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chunk_modes: no CUDA device")
    from hific_tpu_torch.codec import Codec
    from hific_tpu_torch.entropy import device_rans
    from hific_tpu_torch.ops import fused_norm

    card = chip_smoke.card_line()
    print(card, flush=True)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(fused_norm.LIBRARY.load),
                    pool.submit(device_rans.LIBRARY.load)]:
            job.result()
    config, state, source = chip_smoke.load_weights(
        os.path.join(ROOT, "artifacts", "flagship_rd30k_f16.npz"),
        chip_smoke.SEED)
    result = {"card": card, "weights": source, "chunk": CHUNK}
    if args.layers:
        result["layers"] = layers(config, state)
    for dtype in () if args.layers else ("float32", "bfloat16"):
        codec = Codec(config.replace(dtype=dtype), state, device="cuda")
        codec.build_tables()
        alpha, _ = chip_smoke.calibrate(codec, chip_smoke.bench_image(0))
        for name, (n, side) in SETS.items():
            imgs = [chip_smoke.bench_image(s, side, side)
                    for s in range(1, n + 1)]
            mp = n * side * side / 1e6
            row = {"alpha": alpha, "chunk_1_ms": pass_ms(codec, imgs)}
            for mode in ("batched", "per_image"):
                row[mode] = compare(codec, imgs, mode)
                row[mode]["chunk_4_mp_s"] = mp / row[mode]["chunk_4_ms"] * 1e3
            row["chunk_1_mp_s"] = mp / row["chunk_1_ms"] * 1e3
            result[f"{dtype} {name}"] = row
            chip_smoke.log(f"{dtype} {name}: {json.dumps(row)}")
        del codec
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
