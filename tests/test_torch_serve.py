"""The port's HTTP serving daemon (`hific_tpu_torch/cli/serve.py`), driven
as a real server on an ephemeral port on the CPU: compress an image over
HTTP, get `.hfc` bytes back, decompress them over HTTP, and match the
codec's own paths and the JAX `Codec`'s bytes; concurrent clients are
batched by the dispatcher; a bad payload is answered with 400.

The model is the tiny config with the port's seeded weights, exported by
its `export_params_npz` (the JAX artifact layout, so the JAX `Codec` loads
the same `.npz`).
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from hific_tpu.codec import Codec as JaxCodec
from hific_tpu.config import mse_lpips_config
from hific_tpu.entropy.container import dumps_compressed as jax_dumps
from hific_tpu.training.checkpoints import load_params_npz
from hific_tpu_torch.cli import serve as serve_cli
from hific_tpu_torch.config import Config
from hific_tpu_torch.entropy.container import dumps_compressed
from hific_tpu_torch.models.hific import HiFiC, init_random_
from hific_tpu_torch.training.checkpoints import export_params_npz

TINY = dict(latent_channels=8, n_residual_blocks=1, hyperlatent_filters=16)
# Long enough that requests sent together land in one batch on a loaded
# CPU; every request waits at most this long for company.
WINDOW_MS = "300"


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    config = Config.from_json(mse_lpips_config(**TINY).to_json())
    model = init_random_(HiFiC(config), torch.Generator().manual_seed(0))
    return export_params_npz(
        str(tmp_path_factory.mktemp("ckpt") / "tiny.npz"), model, config)


@pytest.fixture(scope="module")
def served(npz):
    a = serve_cli.parse_args(["-ckpt", npz, "--port", "0", "--device", "cpu",
                              "--batch_window_ms", WINDOW_MS])
    server = serve_cli.make_server(a)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    host, port = server.server_address[:2]
    yield f"http://{host}:{port}", server.service
    server.shutdown()
    server.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read(), dict(r.headers)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _image(seed, h=48, w=64):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def test_serve_roundtrip_matches_codec_and_jax(served, npz):
    base, service = served
    health = _get(base + "/healthz")
    assert health["status"] == "ok" and health["tables_built"]
    assert health["device"] == "cpu"

    arr = _image(0)
    status, hfc, headers = _post(base + "/compress", _png(arr))
    assert status == 200
    assert float(headers["X-Bpp"]) > 0
    assert headers["X-Shape"] == "48x64"
    direct = service.codec.compress(arr[None])
    assert hfc == dumps_compressed(direct)[0]
    assert hfc == jax_dumps(JaxCodec(*load_params_npz(npz)).compress(
        arr[None]))[0]

    status, png, headers = _post(base + "/decompress", hfc)
    assert status == 200 and headers["Content-Type"] == "image/png"
    got = np.asarray(Image.open(io.BytesIO(png)))
    want = service.codec.decompress(direct, as_uint8=True)[0]
    np.testing.assert_array_equal(got, want)

    stats = _get(base + "/stats")
    assert stats["compress_requests"] >= 1
    assert stats["decompress_requests"] >= 1
    assert stats["errors"] == 0


def test_concurrent_clients_are_batched(served):
    """Four clients at once: every response is the codec's, and the
    dispatcher put more than one request into a batch."""
    base, service = served
    images = [_image(10 + i) for i in range(4)]
    results, errors = [None] * len(images), []
    start = threading.Barrier(len(images))

    def client(i):
        try:
            start.wait(timeout=30)
            s, hfc, _ = _post(base + "/compress", _png(images[i]))
            assert s == 200
            start.wait(timeout=60)
            s, png, _ = _post(base + "/decompress", hfc)
            assert s == 200
            results[i] = (hfc, png)
        except Exception as e:  # noqa: BLE001 -- collected for the assert
            errors.append((i, e))

    before = service.stats_snapshot()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    stats = service.stats_snapshot()
    assert stats["max_batch_seen"] > 1
    assert (stats["batched_requests"] - before["batched_requests"]
            == 2 * len(images))
    assert stats["batches"] - before["batches"] < 2 * len(images)
    for arr, (hfc, png) in zip(images, results):
        direct = service.codec.compress(arr[None])
        assert hfc == dumps_compressed(direct)[0]
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(png))),
            service.codec.decompress(direct, as_uint8=True)[0])


def test_dispatcher_batches_match_serial(served):
    """A three-job batch handed to the dispatcher's runner directly:
    compress batches ride compress_many, decompress batches
    decompress_many, with the results of serial codec calls."""
    _, service = served
    arrs = [_image(20 + i)[None] for i in range(3)]
    jobs = [serve_cli._Job("compress", a) for a in arrs]
    service._run_batch(jobs)
    for job, a in zip(jobs, arrs):
        assert job.error is None
        assert (dumps_compressed(job.result)[0]
                == dumps_compressed(service.codec.compress(a))[0])
    djobs = [serve_cli._Job("decompress", job.result) for job in jobs]
    service._run_batch(djobs)
    for djob, job in zip(djobs, jobs):
        assert djob.error is None
        np.testing.assert_array_equal(
            djob.result, service.codec.decompress(job.result, as_uint8=True))


def test_failed_batch_retries_each_job_alone(served):
    """One bad payload in a batch fails alone; its neighbours succeed."""
    _, service = served
    good = serve_cli._Job("compress", _image(30)[None])
    bad = serve_cli._Job("compress", np.zeros((1, 8, 8), np.uint8))
    service._run_batch([good, bad])
    assert good.error is None and good.result is not None
    assert isinstance(bad.error, ValueError)


@pytest.mark.parametrize("path,body", [("/decompress", b"not a container"),
                                       ("/compress", b"not an image")])
def test_bad_payload_is_a_400_not_a_crash(served, path, body):
    base, _ = served
    req = urllib.request.Request(base + path, data=body, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    assert _get(base + "/healthz")["status"] == "ok"


def test_unknown_path_is_a_404(served):
    base, _ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nothing", timeout=30)
    assert e.value.code == 404


@pytest.mark.parametrize("flag", [["--coder_threads", "2"],
                                  ["--pipeline_chunk", "4"],
                                  ["--wire_chunk", "2"]])
def test_unported_flags_exit_nonzero(flag):
    with pytest.raises(SystemExit) as e:
        serve_cli.parse_args(["-ckpt", "unused.npz", *flag])
    assert "ROADMAP" in str(e.value.code)
