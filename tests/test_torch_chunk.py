"""The port's batch codec with `pipeline_chunk` and `wire_chunk`, against
its own per-image paths and the JAX package.

The images are the JAX package's chunking test's (`tests/test_codec.py`,
seeded uint8, 64x64 with a 64x96 one in second place that breaks the run)
with one more 64x64 image, so that the chunks at `pipeline_chunk` 2 are
[1], [1], [2], [1]: a break in shape and an odd tail. Asserted:

- `compress_many` at `pipeline_chunk` 2, on the host coder and on the
  device encoder (its plain version here), writes the per-image
  `compress`'s bytes, which are the JAX `Codec`'s, in order; the device
  coders still take one encode and one decode call for all images;
- `decompress_many` at `pipeline_chunk` 2 returns the per-image
  `decompress`'s pixels (uint8 and float, numpy and tensors), on the host
  and device decoders, within one level of the JAX `Codec`'s
  (`device_decode=False`); the encoder and the generator run image by
  image, and the uint8 images come to the host in one copy a chunk (batch
  sizes 1, 1, 2, 1);
- `wire_chunk` on the host paths (sharded streams, `coder_threads` 2, and
  `device_decode=False`) and on the device coders' paths: the bytes and
  pixels of `wire_chunk` 1, and the JAX `Codec`'s sharded bytes; every
  thread pool closed when the call returns.

The tiny config with JAX-initialised parameters (init under `jax.jit`).
"""

import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hific_tpu.codec import Codec as JaxCodec
from hific_tpu.config import mse_lpips_config
from hific_tpu.entropy import container as jax_container
from hific_tpu.models.hific import HiFiC as JaxHiFiC
from hific_tpu_torch import codec as codec_module
from hific_tpu_torch.codec import Codec
from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy import container
from hific_tpu_torch.weights import state_dict_from_jax


@pytest.fixture(scope="module")
def tiny():
    cfg = mse_lpips_config(latent_channels=8, n_residual_blocks=1,
                           hyperlatent_filters=16)
    model = JaxHiFiC(cfg)
    params = jax.jit(lambda r: model.init({"params": r, "quantize": r},
                                          jnp.zeros((1, 64, 64, 3)),
                                          training=True)["params"])(
        jax.random.PRNGKey(0))
    state = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return JaxCodec(cfg, params), Config.from_json(cfg.to_json()), state


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(17)
    imgs = [rng.randint(0, 256, size=(1, 64, 64, 3), dtype=np.uint8)
            for _ in range(3)]
    imgs.insert(1, rng.randint(0, 256, size=(1, 64, 96, 3), dtype=np.uint8))
    imgs.append(rng.randint(0, 256, size=(1, 64, 64, 3), dtype=np.uint8))
    return imgs


@pytest.fixture(scope="module")
def per_image(tiny, images):
    """The per-image paths: each image's `compress` bytes and
    `decompress` uint8 and float pixels, and the JAX `Codec`'s bytes and
    uint8 pixels."""
    jax_codec, cfg, state = tiny
    codec = Codec(cfg, state, device="cpu")
    outs = [codec.compress(x) for x in images]
    jax_outs = [jax_codec.compress(x) for x in images]
    return {"outs": outs, "hfc": [_hfc(o) for o in outs],
            "u8": [codec.decompress(o, as_uint8=True) for o in outs],
            "float": [codec.decompress(o) for o in outs],
            "jax_hfc": [_hfc(o, jax_container) for o in jax_outs],
            "jax_u8": [np.asarray(jax_codec.decompress(
                o, as_uint8=True, device_decode=False)) for o in jax_outs]}


def _hfc(out, writer=container) -> bytes:
    f = io.BytesIO()
    writer._save_to(f, out)
    return f.getvalue()


def _within_a_level(got, want):
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("device_coders", [False, True],
                         ids=["host_coder", "device_coders"])
def test_pipeline_chunk_gives_per_image_bytes_and_pixels(
        tiny, images, per_image, device_coders, monkeypatch):
    _, cfg, state = tiny
    codec = Codec(cfg, state, device="cpu", pipeline_chunk=2)
    batches, calls, copies = [], [], []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: batches.append(inp[0].shape[0]))
        for m in (codec.model.encoder, codec.model.generator)]
    fetch = codec_module.Fetch

    def counted_fetch(t):
        if t.dim() == 4 and t.dtype == torch.uint8:
            copies.append(t.shape[0])
        return fetch(t)

    monkeypatch.setattr(codec_module, "Fetch", counted_fetch)

    def counted(fn):
        def call(jobs):
            calls.append((fn.__name__, len(jobs)))
            return fn(jobs)
        return call

    monkeypatch.setattr(codec_module, "encode_scan_many",
                        counted(codec_module.encode_scan_many))
    monkeypatch.setattr(codec_module, "decode_scan_many",
                        counted(codec_module.decode_scan_many))
    on = True if device_coders else None
    outs = codec.compress_many(images, device_encode=on)
    got = [_hfc(o) for o in outs]
    assert got == per_image["hfc"] == per_image["jax_hfc"]
    u8 = codec.decompress_many(outs, device_decode=on)
    for hook in hooks:
        hook.remove()
    assert batches == [1] * 2 * len(images)
    assert copies == [1, 1, 2, 1]
    tensors = codec.decompress_many(outs, as_numpy=False, device_decode=on)
    floats = codec.decompress_many(outs, as_uint8=False, device_decode=on)
    assert calls == ([("encode_scan_many", 10)] + [("decode_scan_many", 5)] * 3
                     if device_coders else [])
    for k in range(len(images)):
        np.testing.assert_array_equal(u8[k], per_image["u8"][k])
        assert isinstance(tensors[k], torch.Tensor)
        np.testing.assert_array_equal(tensors[k].numpy(), per_image["u8"][k])
        np.testing.assert_array_equal(floats[k], per_image["float"][k])
        _within_a_level(u8[k], per_image["jax_u8"][k])


def test_wire_chunk_host_paths(tiny, images, per_image):
    """Sharded streams on the host coder with wire_chunk 4: the bytes of
    wire_chunk 1, which are the JAX `Codec`'s with coder_threads 2; the
    host decoder of sharded and (device_decode=False) unsharded payloads at
    wire_chunk 2 gives the per-image pixels; no thread outlives a call."""
    jax_codec, cfg, state = tiny
    plain = Codec(cfg, state, device="cpu", coder_threads=2)
    wired = Codec(cfg, state, device="cpu", coder_threads=2, wire_chunk=4)
    want = [_hfc(o) for o in plain.compress_many(images)]
    before = threading.active_count()
    outs = wired.compress_many(images)
    assert threading.active_count() == before
    assert [_hfc(o) for o in outs] == want
    assert all(o.sharded for o in outs)
    jax_codec.coder_threads = 2
    try:
        assert want == [_hfc(jax_codec.compress(x), jax_container)
                        for x in images]
    finally:
        jax_codec.coder_threads = 1
    for payloads in (outs, per_image["outs"]):
        got = wired.decompress_many(payloads, device_decode=False)
        assert threading.active_count() == before
        for g, w in zip(got, per_image["u8"]):
            np.testing.assert_array_equal(g, w)


def test_wire_chunk_changes_nothing_on_device_coders(tiny, images, per_image):
    """On the device coders' paths (their plain versions here) wire_chunk
    3 writes the same bytes and decodes the same pixels, pipeline_chunk 2
    beside it."""
    _, cfg, state = tiny
    codec = Codec(cfg, state, device="cpu", wire_chunk=3, pipeline_chunk=2)
    outs = codec.compress_many(images, device_encode=True)
    assert [_hfc(o) for o in outs] == per_image["hfc"]
    for g, w in zip(codec.decompress_many(outs, device_decode=True),
                    per_image["u8"]):
        np.testing.assert_array_equal(g, w)
