"""The port's lane-sharded and scalar coders and container v2, against the
JAX package.

- Sharded payloads at K = 1, 2, 4 and 7 shards, and at a K above the lane
  count (clamped): the bytes equal the JAX package's
  `encode_indexed_sharded`, each shard is `encode_indexed` of its lane
  group alone, the payload decodes (in any thread count), and a corrupt
  payload (empty, a bad K, a truncated header, lengths that do not add
  up) raises JAX's error.
- Scalar streams, native and numpy, with escapes of several nibbles: the
  bytes equal the JAX package's `encode_indexed_scalar` (its numpy coder)
  and both sides decode them.
- Files: a `.hfc` of `Codec(coder_threads=4)` (container v2) and of
  `Codec(vectorize=False)` byte for byte the JAX `Codec`'s; each package
  decodes the other's v1 and v2 files to the same symbols; the bfloat16 v2
  layout (both prefixes) round-trips and a float32 codec refuses it.
- `eval_kodak` on synthetic PNGs with an expected-values JSON that passes
  and one that fails (exit code 1).

The tiny config with JAX-initialised parameters (init under `jax.jit`),
both codecs on the CPU (one JAX `Codec`, its `vectorize` and
`coder_threads` set for each case); the JAX codec decodes on its host
coder.
"""

import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hific_tpu.codec import Codec as JaxCodec
from hific_tpu.config import mse_lpips_config
from hific_tpu.entropy import coding as jax_coding
from hific_tpu.entropy import container as jax_container
from hific_tpu.models.hific import HiFiC as JaxHiFiC
from hific_tpu_torch.cli import eval_kodak
from hific_tpu_torch.codec import Codec
from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy import coding, container
from hific_tpu_torch.entropy.entropy_models import ConditionalEntropyModel
from hific_tpu_torch.models.hific import HiFiC, init_random_
from hific_tpu_torch.training.checkpoints import export_params_npz
from hific_tpu_torch.weights import state_dict_from_jax

PRECISION = 16


@pytest.fixture(scope="module")
def tables():
    return ConditionalEntropyModel("gaussian").tables


def _args(t):
    return (t.cdf, t.cdf_length, t.cdf_offset, PRECISION)


def _planes(shape, seed, n_rows=64):
    """Seeded (N, C, H, W) symbols and scale-table indices, with escapes of
    one to five nibbles (|value| up to ~1e6)."""
    rng = np.random.RandomState(seed)
    indices = rng.randint(0, n_rows, size=shape).astype(np.int32)
    symbols = np.round(rng.randn(*shape) * 4).astype(np.int32)
    far = rng.choice(symbols.size, max(4, symbols.size // 20), replace=False)
    symbols.flat[far] = rng.randint(-3000, 3000, far.size)
    symbols.flat[far[:3]] = [999_999, -65_000, 40]
    return symbols, indices


@pytest.mark.parametrize("shards", [1, 2, 4, 7, 100])
@pytest.mark.parametrize("shape", [(1, 24, 5, 7), (2, 3, 4, 5)],
                         ids=["batch1", "batch2"])
def test_sharded_payload_equals_jax_and_its_lane_groups(tables, shards,
                                                        shape):
    """K shards (clamped to the lane count: 24 channels at batch 1, 60
    elements at batch 2): the JAX package's bytes; shard k is the
    vectorized stream of its lane group; decoded by the port and by JAX."""
    symbols, indices = _planes(shape, seed=shards)
    ours, coding_shape = coding.encode_indexed_sharded(
        symbols, indices, *_args(tables), shards)
    theirs, jax_shape = jax_coding.encode_indexed_sharded(
        symbols, indices, *_args(tables), shards)
    assert ours.tobytes() == theirs.tobytes()
    assert tuple(coding_shape) == tuple(jax_shape)
    k = int(ours[0])
    sym_l, idx_l, _ = coding._layout(symbols, indices)
    assert k == min(shards, sym_l.shape[1])
    at = 1 + k
    for (lo, hi), n in zip(coding._lane_splits(sym_l.shape[1], k),
                           ours[1:1 + k]):
        alone = coding._encode_layout(np.ascontiguousarray(sym_l[:, lo:hi]),
                                      np.ascontiguousarray(idx_l[:, lo:hi]),
                                      *_args(tables))
        assert ours[at:at + n].tobytes() == alone.tobytes()
        at += int(n)
    assert at == ours.size
    np.testing.assert_array_equal(coding.decode_indexed_sharded(
        theirs, indices, *_args(tables), tables.inverse), symbols)
    np.testing.assert_array_equal(jax_coding.decode_indexed_sharded(
        ours, indices, *_args(tables), tables.inverse), symbols)


def test_lane_splits_are_jax_splits():
    for lanes in (1, 2, 5, 24, 220, 320):
        for k in (1, 2, 3, 4, 7, 8, 400):
            assert coding._lane_splits(lanes, k) == \
                jax_coding._lane_splits(lanes, k)


@pytest.mark.parametrize("corrupt", ["empty", "k_zero", "k_above_lanes",
                                     "truncated_header", "length_mismatch"])
def test_corrupt_sharded_payloads_raise_as_jax(tables, corrupt):
    symbols, indices = _planes((1, 8, 3, 3), seed=5)
    good, _ = coding.encode_indexed_sharded(symbols, indices,
                                            *_args(tables), 4)
    payload = {
        "empty": good[:0],
        "k_zero": np.concatenate([[0], good[1:]]).astype(np.uint32),
        "k_above_lanes": np.concatenate([[9], good[1:]]).astype(np.uint32),
        "truncated_header": good[:3],
        "length_mismatch": good[:-1],
    }[corrupt]
    with pytest.raises(ValueError) as jax_error:
        jax_coding.decode_indexed_sharded(payload, indices, *_args(tables),
                                          tables.inverse)
    with pytest.raises(ValueError) as error:
        coding.decode_indexed_sharded(payload, indices, *_args(tables),
                                      tables.inverse)
    assert str(error.value) == str(jax_error.value)
    assert str(error.value).startswith("corrupt sharded payload")


def test_sharded_coder_closes_its_threads(tables):
    symbols, indices = _planes((1, 24, 6, 6), seed=9)
    before = threading.active_count()
    payload, _ = coding.encode_indexed_sharded(symbols, indices,
                                               *_args(tables), 8)
    coding.decode_indexed_sharded(payload, indices, *_args(tables),
                                  tables.inverse)
    assert threading.active_count() == before


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("shape", [(1, 6, 4, 5), (2, 3, 3, 4)],
                         ids=["batch1", "batch2"])
def test_scalar_stream_equals_jax(tables, native, shape, monkeypatch):
    """The native coder (one lane of every element) and the numpy coder
    write the JAX package's numpy scalar stream; both sides decode it."""
    monkeypatch.setenv("HIFIC_TPU_TORCH_NATIVE", native)
    symbols, indices = _planes(shape, seed=len(native) + shape[0])
    ours, coding_shape = coding.encode_indexed_scalar(symbols, indices,
                                                      *_args(tables))
    theirs, jax_shape = jax_coding.encode_indexed_scalar(
        symbols, indices, *_args(tables), use_native=False)
    assert ours.tobytes() == theirs.tobytes()
    assert tuple(coding_shape) == tuple(jax_shape) == shape[1:]
    np.testing.assert_array_equal(coding.decode_indexed_scalar(
        theirs, indices, *_args(tables), tables.inverse), symbols)
    np.testing.assert_array_equal(jax_coding.decode_indexed_scalar(
        ours, indices, *_args(tables), tables.inverse, use_native=False),
        symbols)


# ---------------------------------------------------------------------------
# Files


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


def _u8(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (1, h, w, 3),
                                               dtype=np.uint8)


def _hfc(out, writer=container) -> bytes:
    f = io.BytesIO()
    writer._save_to(f, out)
    return f.getvalue()


@pytest.mark.parametrize("options", [dict(coder_threads=4),
                                     dict(vectorize=False), {}],
                         ids=["v2", "scalar", "v1"])
def test_files_equal_jax_and_decode_both_ways(tiny, options):
    """The port's file of a 48x64 image equals the JAX `Codec`'s byte for
    byte (v2 starts with its prefix); the port decodes JAX's file and JAX
    the port's, to the symbols the port encoded; a codec with other
    options decodes a v1 or v2 file too (the file says it is sharded)."""
    jax_codec, port_cfg, state = tiny
    port = Codec(port_cfg, state, device="cpu", **options)
    jax_codec.vectorize = options.get("vectorize", True)
    jax_codec.coder_threads = options.get("coder_threads", 1)
    x = _u8(48, 64, seed=1)
    ours = _hfc(port.compress(x))
    theirs = _hfc(jax_codec.compress(x), jax_container)
    assert ours == theirs
    assert ours.startswith(container.V2_MAGIC) == ("coder_threads" in options)
    z_enc, y_enc, *_ = port.encode_symbols(x)
    z_dec, y_dec, _ = port.decode_symbols(container.loads_compressed(theirs))
    np.testing.assert_array_equal(z_dec, z_enc)
    np.testing.assert_array_equal(y_dec, y_enc)
    want = port.decompress(container.loads_compressed(ours), as_uint8=True)
    got_jax = np.asarray(jax_codec.decompress(
        jax_container.loads_compressed(ours), as_uint8=True,
        device_decode=False))
    jax_codec.vectorize, jax_codec.coder_threads = True, 1
    assert np.abs(got_jax.astype(int) - want.astype(int)).max() <= 1
    if options.get("vectorize", True):
        other = Codec(port_cfg, state, device="cpu",
                      coder_threads=1 if options else 3)
        np.testing.assert_array_equal(other.decompress(
            container.loads_compressed(theirs), as_uint8=True), want)


def test_bf16_v2_layout_round_trips_and_fp32_refuses_it(tiny, tmp_path):
    """A bfloat16 codec with coder_threads 4 writes both prefixes, the
    dtype's first; the file loads as sharded and bfloat16, writes back the
    same bytes, decodes to its symbols; a float32 codec refuses it as it
    refuses a bfloat16 v1 file; the JAX reader refuses it as corrupt."""
    _, port_cfg, state = tiny
    bf16 = Codec(port_cfg.replace(dtype="bfloat16"), state, device="cpu",
                 coder_threads=4)
    x = _u8(64, 48, seed=2)
    path = str(tmp_path / "bf16_v2.hfc")
    bf16.compress_file(x, path)
    with open(path, "rb") as f:
        data = f.read()
    assert data.startswith(container.BF16_MAGIC + container.V2_MAGIC)
    out = container.loads_compressed(data)
    assert out.sharded and out.compute_dtype == "bfloat16"
    assert container.dumps_compressed(out)[0] == data
    z_enc, y_enc, *_ = bf16.encode_symbols(x)
    z_dec, y_dec, _ = bf16.decode_symbols(out)
    np.testing.assert_array_equal(z_dec, z_enc)
    np.testing.assert_array_equal(y_dec, y_enc)
    assert bf16.decompress_file(path).shape == x.shape
    fp32 = Codec(port_cfg, state, device="cpu")
    with pytest.raises(ValueError, match="payload coded by a"):
        fp32.decompress_file(path)
    with pytest.raises(AssertionError, match="corrupt container"):
        jax_container.load_compressed(path)


def test_device_coders_refuse_sharded_and_scalar(tiny):
    """The device coders take vectorized unsharded streams only: asking
    for them otherwise raises; by default the host coder runs."""
    _, port_cfg, state = tiny
    x = _u8(32, 48, seed=3)
    for options in (dict(coder_threads=2), dict(vectorize=False)):
        codec = Codec(port_cfg, state, device="cpu", **options)
        with pytest.raises(ValueError, match="device_encode"):
            codec.compress(x, device_encode=True)
        with pytest.raises(ValueError, match="device_encode"):
            codec.compress_many([x], device_encode=True)
        out = codec.compress(x)
        with pytest.raises(ValueError, match="device_decode"):
            codec.decompress(out, device_decode=True)
        with pytest.raises(ValueError, match="device_decode"):
            codec.decompress_many([out], device_decode=True)
    with pytest.raises(ValueError, match="vectorize"):
        Codec(port_cfg, state, device="cpu", coder_threads=2, vectorize=False)


# ---------------------------------------------------------------------------
# eval_kodak


@pytest.fixture(scope="module")
def eval_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    config = Config(latent_channels=8, n_residual_blocks=1,
                    hyperlatent_filters=16)
    model = init_random_(HiFiC(config), torch.Generator().manual_seed(0))
    npz = export_params_npz(str(root / "tiny.npz"), model, config)
    images = root / "kodak"
    images.mkdir()
    for i, (h, w) in enumerate(((64, 96), (64, 96), (48, 64))):
        Image.fromarray(_u8(h, w, seed=10 + i)[0]).save(
            images / f"kodim{i + 1:02d}.png")
    return root, npz, str(images)


def _expected(root, name, body):
    path = root / name
    with open(path, "w") as f:
        json.dump(body, f)
    return str(path)


def test_eval_kodak_passes_and_fails_on_expected(eval_inputs):
    """The table's rows and means on three synthetic PNGs (pipeline 2,
    shape bucket 32, scalar coder passed on); an expected JSON of those
    means passes (exit 0), one whose PSNR is 1 dB off fails (exit 1)
    naming the metric."""
    root, npz, images = eval_inputs
    argv = ["-ckpt", npz, "-i", images, "--pipeline", "2", "--shape_bucket",
            "32", "--scalar_rans", "--no_lpips", "--device", "cpu"]
    report = eval_kodak.main(argv + ["-o", str(root / "first")])
    assert [r["file"].split("/")[-1] for r in report["rows"]] == [
        "kodim01.png", "kodim02.png", "kodim03.png"]
    means = report["mean"]
    assert np.isfinite(means["psnr"]) and means["bpp"] > 0
    good = _expected(root, "good.json", {
        "mean": {"bpp": means["bpp"], "psnr": means["psnr"]},
        "per_image": {"kodim03": {"psnr": report["rows"][2]["psnr"]}}})
    bad = _expected(root, "bad.json", {
        "mean": {"psnr": means["psnr"] + 1.0}})
    assert eval_kodak.cli(argv + ["-o", str(root / "good"),
                                  "--expected", good]) == 0
    report = eval_kodak.main(argv + ["-o", str(root / "bad"),
                                     "--expected", bad])
    assert len(report["failures"]) == 1
    assert report["failures"][0].startswith("mean: psnr")
    assert eval_kodak.cli(argv + ["-o", str(root / "bad"),
                                  "--expected", bad]) == 1
    with open(root / "bad" / "eval_report.json") as f:
        assert json.load(f)["failures"] == report["failures"]
