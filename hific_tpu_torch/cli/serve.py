"""HTTP serving daemon of the port: compress and decompress over the wire
with the model warm; counterpart of the JAX package's `cli/serve.py`.

    python -m hific_tpu_torch.cli.serve -ckpt params.npz \\
        [--host 127.0.0.1] [--port 8080] [--max_batch 8] \\
        [--pipeline_chunk 4] [--wire_chunk 1] [--coder_threads 1] \\
        [--device cpu]

    POST /compress     image bytes (PNG, JPEG, ...) -> `.hfc` bytes
                       (X-Bpp and X-Shape response headers)
    POST /decompress   `.hfc` bytes -> PNG bytes
    GET  /healthz      liveness and model info (JSON)
    GET  /stats        request, byte, batch and busy-time counters (JSON)

A thread per connection (ThreadingHTTPServer) parses and serialises:
image decoding, PNG encoding and the container's bytes overlap across
clients. Codec work goes through one dispatcher thread, the only thread
that touches the codec after it is built: it waits up to
`--batch_window_ms` after the first queued job for more, then takes every
queued job of the head's kind, up to `--max_batch`, into one
`compress_many` or `decompress_many` call, so the device coders code a
batch of requests in one kernel launch. The codec takes the JAX package's
daemon defaults: `--pipeline_chunk 4` (the images of up to four
same-shape decompress requests of a batch copied to the host together),
`--wire_chunk 1`, `--coder_threads 1`. A batch that fails is
retried one job at a time, so one bad request fails alone. The dispatcher
makes the codec's device its current CUDA device when it starts (PyTorch
keeps the current device per thread). A bad request is answered with 400.
Runs on the card unless `--device` names another device.
"""

import argparse
import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from hific_tpu_torch.codec import Codec
from hific_tpu_torch.entropy.container import dumps_compressed, loads_compressed
from hific_tpu_torch.runtime import resolve_device
from hific_tpu_torch.training.checkpoints import resolve_eval_checkpoint
from hific_tpu_torch.utils.image_io import decode_image, encode_png
from hific_tpu_torch.utils.logging import setup_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="HiFiC codec server (PyTorch port)")
    p.add_argument("-ckpt", "--checkpoint_dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 picks a free port (logged at startup)")
    p.add_argument("--shape_bucket", type=int, default=None,
                   help="reflect-pad request images to multiples of this")
    p.add_argument("--tile_latents", type=int, default=None,
                   help="run the generator on latent tiles of this size. "
                        "On an H100 this does not lower the decode's peak "
                        "memory: under the codec's deterministic cuDNN the "
                        "generator's first transposed convolution takes a "
                        "workspace of several GiB whatever the tile "
                        "(ROADMAP.md section 1)")
    p.add_argument("--max_batch", type=int, default=8,
                   help="most queued requests dispatched as one "
                        "compress_many / decompress_many call")
    p.add_argument("--batch_window_ms", type=float, default=2.0,
                   help="after the first job arrives, hold dispatch up to "
                        "this many ms so that concurrent requests join one "
                        "batch (0 dispatches at once; the window closes "
                        "early once max_batch jobs are queued)")
    p.add_argument("--coder_threads", type=int, default=1,
                   help="lane-shard each rANS payload into this many "
                        "streams coded in host threads (container v2)")
    p.add_argument("--pipeline_chunk", type=int, default=4,
                   help="within a batch, the reconstructions of this "
                        "many same-shape images come to the host in one "
                        "copy; 1 disables")
    p.add_argument("--wire_chunk", type=int, default=1,
                   help="on the host coder's paths, one copy to the host "
                        "for this many same-shape images and their rANS "
                        "calls in this many threads; 1 disables")
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) unless named")
    return p.parse_args(argv)


class _Job:
    __slots__ = ("kind", "payload", "done", "result", "error")

    def __init__(self, kind, payload):
        self.kind = kind          # "compress" | "decompress"
        self.payload = payload    # uint8 (1, H, W, 3) | CompressionOutput
        self.done = threading.Event()
        self.result = None
        self.error = None


class CodecService:
    """A warm codec behind one dispatcher thread, and the counters."""

    def __init__(self, config, state, device=None, shape_bucket=None,
                 tile_latents=None, max_batch=8, batch_window_ms=0.0,
                 coder_threads=1, pipeline_chunk=1, wire_chunk=1):
        self.codec = Codec(config, state, device=resolve_device(device),
                           coder_threads=coder_threads,
                           pipeline_chunk=pipeline_chunk,
                           wire_chunk=wire_chunk)
        self.codec.build_tables()
        self.shape_bucket = shape_bucket
        self.tile_latents = tile_latents
        self.max_batch = max(1, int(max_batch))
        self.batch_window_s = max(0.0, float(batch_window_ms)) / 1e3
        self._queue = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._stats_lock = threading.Lock()
        self.stats = {"compress_requests": 0, "decompress_requests": 0,
                      "errors": 0, "pixels_in": 0, "bytes_hfc": 0,
                      "busy_seconds": 0.0, "batches": 0,
                      "compress_batches": 0, "decompress_batches": 0,
                      "batched_requests": 0, "max_batch_seen": 0}
        self.n_params = sum(int(v.numel()) for v in state.values())
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True,
                                            name="codec-dispatcher")
        self._dispatcher.start()

    # ------------------------------------------------------------------ #
    # The dispatcher

    def _submit(self, kind, payload):
        job = _Job(kind, payload)
        with self._cv:
            if self._closed:
                raise RuntimeError("service is shut down")
            self._queue.append(job)
            self._cv.notify()
        job.done.wait()
        if job.error is not None:
            raise job.error
        return job.result

    def _next_batch(self):
        """Wait for jobs; then the batch window; then every queued job of
        the head's kind, up to max_batch (requests are independent, so
        jobs of the other kind may be passed). None once closed and
        drained."""
        with self._cv:
            while not self._queue and not self._closed:
                self._cv.wait()
            if self._closed and not self._queue:
                return None
            if self.batch_window_s > 0.0 and not self._closed:
                kind0 = self._queue[0].kind
                deadline = time.monotonic() + self.batch_window_s
                while (sum(1 for j in self._queue if j.kind == kind0)
                       < self.max_batch and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0.0:
                        break
                    self._cv.wait(remaining)
            kind = self._queue[0].kind
            batch, rest = [], collections.deque()
            while self._queue and len(batch) < self.max_batch:
                job = self._queue.popleft()
                (batch if job.kind == kind else rest).append(job)
            rest.extend(self._queue)
            self._queue = rest
            return batch

    def _dispatch_loop(self):
        # The model's own device names its index, where `codec.device`
        # may be plain "cuda".
        device = next(self.codec.model.parameters()).device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            self._run_batch(batch)

    def _run_batch(self, batch):
        t0 = time.time()
        kind = batch[0].kind
        try:
            results = self._execute(kind, [j.payload for j in batch])
            for job, res in zip(batch, results):
                job.result = res
        except Exception as e:  # noqa: BLE001 -- a failed batch must not
            # wedge its waiters; each job is retried alone, so one bad
            # request fails alone
            if len(batch) == 1:
                batch[0].error = e
            else:
                for job in batch:
                    try:
                        job.result = self._execute(kind, [job.payload])[0]
                    except Exception as e1:  # noqa: BLE001 -- to its waiter
                        job.error = e1
        dt = time.time() - t0
        with self._stats_lock:
            self.stats["busy_seconds"] += dt
            self.stats["batches"] += 1
            self.stats[f"{kind}_batches"] += 1
            self.stats["batched_requests"] += len(batch)
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                               len(batch))
        for job in batch:
            job.done.set()

    def _execute(self, kind, payloads):
        if kind == "compress":
            return self.codec.compress_many(payloads,
                                            shape_bucket=self.shape_bucket)
        return self.codec.decompress_many(payloads, as_uint8=True,
                                          tile_latents=self.tile_latents)

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._dispatcher.join(timeout=30)

    # ------------------------------------------------------------------ #
    # Request entry points, on the HTTP threads: parsing and serialisation
    # stay here so they overlap across clients.

    def compress(self, image_bytes: bytes):
        arr = decode_image(image_bytes)[None]  # (1, H, W, 3) uint8
        out = self._submit("compress", arr)
        data, actual_bpp, _ = dumps_compressed(out)
        with self._stats_lock:
            self.stats["compress_requests"] += 1
            self.stats["pixels_in"] += arr.shape[1] * arr.shape[2]
            self.stats["bytes_hfc"] += len(data)
        return data, {"X-Bpp": f"{actual_bpp:.4f}",
                      "X-Shape": f"{arr.shape[1]}x{arr.shape[2]}"}

    def decompress(self, hfc_bytes: bytes) -> bytes:
        recon = self._submit("decompress", loads_compressed(hfc_bytes))
        png = encode_png(recon[0])
        with self._stats_lock:
            self.stats["decompress_requests"] += 1
            self.stats["bytes_hfc"] += len(hfc_bytes)
        return png

    def health(self) -> dict:
        return {"status": "ok", "params_m": round(self.n_params / 1e6, 1),
                "tables_built": bool(self.codec._tables_built),
                "device": str(self.codec.device)}

    def stats_snapshot(self) -> dict:
        with self._stats_lock:
            return dict(self.stats)


def make_handler(service, logger):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            logger.info("%s %s", self.address_string(), fmt % args)

        def _reply(self, code, body: bytes, ctype, headers=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, service.health())
            elif self.path == "/stats":
                self._json(200, service.stats_snapshot())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            try:
                if self.path == "/compress":
                    data, headers = service.compress(body)
                    self._reply(200, data, "application/octet-stream",
                                headers)
                elif self.path == "/decompress":
                    self._reply(200, service.decompress(body), "image/png")
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})
            except Exception as e:  # noqa: BLE001 -- a bad request must not
                # take the server down; the error goes back to the client
                with service._stats_lock:
                    service.stats["errors"] += 1
                logger.exception("request failed")
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(a, logger=None):
    """The warm service and its HTTP server, not yet serving (tests and
    callers drive `serve_forever` themselves). `server_close` also stops
    the dispatcher."""
    logger = logger or setup_logger(None, name="hific_tpu_torch.serve")
    logger.info("Restoring %s", a.checkpoint_dir)
    try:
        config, state = resolve_eval_checkpoint(a.checkpoint_dir)
    except FileNotFoundError as e:
        raise SystemExit(str(e))
    logger.info("Building prior probability tables...")
    service = CodecService(config, state, device=a.device,
                           shape_bucket=a.shape_bucket,
                           tile_latents=a.tile_latents,
                           max_batch=a.max_batch,
                           batch_window_ms=a.batch_window_ms,
                           coder_threads=a.coder_threads,
                           pipeline_chunk=a.pipeline_chunk,
                           wire_chunk=a.wire_chunk)

    class _Server(ThreadingHTTPServer):
        def server_close(self):
            super().server_close()
            service.close()

    server = _Server((a.host, a.port), make_handler(service, logger))
    server.service = service
    return server


def main(argv=None):
    a = parse_args(argv)
    logger = setup_logger(None, name="hific_tpu_torch.serve")
    server = make_server(a, logger)
    host, port = server.server_address[:2]
    logger.info("Serving on http://%s:%d (POST /compress, /decompress; "
                "GET /healthz, /stats)", host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("Shutting down")
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
