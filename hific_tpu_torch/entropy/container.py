"""`.hfc` binary container; this package's own copy of the JAX package's
`entropy/container.py`, byte for byte the same format:

  uint16 hyperlatent spatial shape (H, W)
  uint16 image spatial shape (H, W)
  uint16 hyper coding shape (C, H, W)
  uint16 latent coding shape (C, H, W)
  uint16 batch size
  4-byte magic 0x46 0xE2 0x84 0x92
  uint32 byte length + raw uint32 rANS words, hyperlatents; magic
  uint32 byte length + raw uint32 rANS words, latents; magic

Version 2, written when the streams are lane-sharded (`coder_threads` > 1,
`CompressionOutput.sharded`): the same body prefixed with the 6 bytes
0xFF 0xFF "HFC2", each rANS payload a self-describing sharded payload
(`entropy/coding.py`). A float32 v2 file is byte for byte the JAX
package's. A v1 file cannot start with 0xFFFF (a hyperlatent grid 65535
rows tall), so the first two bytes tell the versions apart.

A file of a bfloat16 codec is prefixed with 0xFF 0xFF "HFCb": its coding
indices come from a bfloat16 hyper synthesis, so a codec of another compute
dtype must not decode it, and the prefix lets the reader know
(`CompressionOutput.compute_dtype`). A bfloat16 v2 file carries both
prefixes, the dtype's first:

  0xFF 0xFF "HFCb" | 0xFF 0xFF "HFC2" | body with sharded payloads

The JAX package has no bfloat16 file; its reader refuses one as corrupt.
"""

import io
import os
from typing import NamedTuple, Tuple

import numpy as np

MAGIC = b"\x46\xE2\x84\x92"
V2_MAGIC = b"\xff\xffHFC2"
BF16_MAGIC = b"\xff\xffHFCb"


class CompressionOutput(NamedTuple):
    hyperlatents_encoded: np.ndarray   # uint32 stream
    latents_encoded: np.ndarray        # uint32 stream
    hyperlatent_spatial_shape: Tuple[int, int]
    spatial_shape: Tuple[int, int]
    hyper_coding_shape: Tuple[int, ...]
    latent_coding_shape: Tuple[int, ...]
    batch_shape: int
    # v2: the payloads are lane-sharded (serialized as the v2 prefix)
    sharded: bool = False
    # reporting (not serialized)
    hyperlatent_bits: float = 0.0
    latent_bits: float = 0.0
    total_bits: float = 0.0
    hyperlatent_bpp: float = 0.0
    latent_bpp: float = 0.0
    total_bpp: float = 0.0
    # the codec's compute dtype (`Config.dtype`), serialized as the prefix
    compute_dtype: str = "float32"


def _write_u16(f, values):
    for v in values:
        if not 0 <= int(v) < 2 ** 16:
            raise ValueError(f"{v} does not fit the container's uint16 field")
        f.write(np.uint16(v).tobytes())


def _read_exact(f, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise ValueError("corrupt container (truncated)")
    return data


def _read_u16(f, n):
    return tuple(int(v) for v in np.frombuffer(_read_exact(f, 2 * n), np.uint16))


def _save_to(f, out: CompressionOutput) -> None:
    if out.compute_dtype == "bfloat16":
        f.write(BF16_MAGIC)
    elif out.compute_dtype != "float32":
        raise ValueError(f"no container for compute dtype "
                         f"{out.compute_dtype!r}")
    if out.sharded:
        f.write(V2_MAGIC)
    _write_u16(f, out.hyperlatent_spatial_shape)
    _write_u16(f, out.spatial_shape)
    _write_u16(f, out.hyper_coding_shape)
    _write_u16(f, out.latent_coding_shape)
    _write_u16(f, [out.batch_shape])
    f.write(MAGIC)
    for stream in (out.hyperlatents_encoded, out.latents_encoded):
        stream = np.ascontiguousarray(stream, dtype=np.uint32)
        f.write(np.uint32(stream.nbytes).tobytes())
        f.write(stream.tobytes())
        f.write(MAGIC)


def _load_from(f) -> CompressionOutput:
    compute_dtype = "float32"
    start = f.tell()
    prefix = f.read(len(BF16_MAGIC))
    if prefix == BF16_MAGIC:
        compute_dtype = "bfloat16"
        start = f.tell()
        prefix = f.read(len(V2_MAGIC))
    sharded = prefix == V2_MAGIC
    if not sharded:
        f.seek(start)
    hyper_spatial = _read_u16(f, 2)
    spatial = _read_u16(f, 2)
    hyper_coding = _read_u16(f, 3)
    latent_coding = _read_u16(f, 3)
    (batch,) = _read_u16(f, 1)
    if _read_exact(f, 4) != MAGIC:
        raise ValueError("corrupt container (header)")
    streams = []
    for _ in range(2):
        nbytes = int(np.frombuffer(_read_exact(f, 4), np.uint32)[0])
        streams.append(np.frombuffer(_read_exact(f, nbytes), np.uint32).copy())
        if _read_exact(f, 4) != MAGIC:
            raise ValueError("corrupt container (payload)")
    return CompressionOutput(
        hyperlatents_encoded=streams[0],
        latents_encoded=streams[1],
        hyperlatent_spatial_shape=hyper_spatial,
        spatial_shape=spatial,
        hyper_coding_shape=hyper_coding,
        latent_coding_shape=latent_coding,
        batch_shape=batch,
        sharded=sharded,
        compute_dtype=compute_dtype,
    )


def save_compressed(out: CompressionOutput, path: str) -> Tuple[float, float]:
    """Write the container; returns (actual_bpp, theoretical_bpp)."""
    with open(path, "wb") as f:
        _save_to(f, out)
    actual_bpp = 8.0 * os.path.getsize(path) / float(np.prod(out.spatial_shape))
    return actual_bpp, float(out.total_bpp)


def load_compressed(path: str) -> CompressionOutput:
    with open(path, "rb") as f:
        return _load_from(f)


def dumps_compressed(out: CompressionOutput) -> Tuple[bytes, float, float]:
    """Serialize to bytes (the same bytes `save_compressed` writes); returns
    (payload, actual_bpp, theoretical_bpp)."""
    buf = io.BytesIO()
    _save_to(buf, out)
    data = buf.getvalue()
    actual_bpp = 8.0 * len(data) / float(np.prod(out.spatial_shape))
    return data, actual_bpp, float(out.total_bpp)


def loads_compressed(data: bytes) -> CompressionOutput:
    return _load_from(io.BytesIO(data))
