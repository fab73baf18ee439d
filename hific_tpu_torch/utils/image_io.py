"""Image files and bytes <-> uint8 HWC arrays, through Pillow, as the JAX
package reads and writes them (`cli/serve.py`, `cli/compress.py`,
`training/data.py`).

Pillow is imported where an image is read or written, never when this
module is imported; without it a read or write raises ImportError.
"""

import io
from typing import BinaryIO, Union

import numpy as np


def _to_rgb(f: Union[str, BinaryIO]) -> np.ndarray:
    from PIL import Image

    with Image.open(f) as im:
        return np.array(im.convert("RGB"), dtype=np.uint8)


def read_image(path: str) -> np.ndarray:
    """An image file of any format Pillow reads -> uint8 (H, W, 3) RGB."""
    return _to_rgb(path)


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes -> uint8 (H, W, 3) RGB."""
    return _to_rgb(io.BytesIO(data))


def to_uint8(img) -> np.ndarray:
    """uint8 as it is; float in [0, 1] -> round(x * 255), clipped."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return arr


def encode_png(img) -> bytes:
    """(H, W, 3) uint8, or float in [0, 1] -> PNG bytes."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(to_uint8(img)).save(buf, format="PNG")
    return buf.getvalue()


def write_png(path: str, img) -> None:
    """(H, W, 3) uint8, or float in [0, 1] -> a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
