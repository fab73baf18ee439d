"""Training input pipeline; counterpart of the JAX package's
`training/data.py` (`TrainDataset` with uint8 output, `prefetch`).

Random scale in [max(crop / short side, 0.75), 0.95], random crop to
crop_size, horizontal flip; batches of uint8 NHWC crops (the train step
maps them to floats on the device) with each source file's bpp. Decoding
needs Pillow: without it the dataset raises; a file Pillow cannot read is
skipped.
"""

import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".webp")


def list_images(root: str) -> List[str]:
    files = []
    for dirpath, _, filenames in os.walk(root):
        for f in sorted(filenames):
            if f.lower().endswith(IMG_EXTENSIONS):
                files.append(os.path.join(dirpath, f))
    return sorted(files)


def _load_image(path: str) -> Optional[np.ndarray]:
    from PIL import Image  # no Pillow: ImportError, never "skip every file"

    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except OSError:  # unreadable or corrupt file (UnidentifiedImageError)
        return None


def _source_bpp(path: str, shape) -> float:
    """Bits per pixel of the file on disk."""
    return 8.0 * os.path.getsize(path) / float(shape[0] * shape[1])


class TrainDataset:
    """Random-scale, random-crop, horizontal-flip uint8 crops."""

    def __init__(self, root_or_files, crop_size: int = 256, seed: int = 0):
        if isinstance(root_or_files, str):
            self.files = list_images(root_or_files)
        else:
            self.files = list(root_or_files)
        if not self.files:
            raise ValueError("no training images found")
        self.crop_size = crop_size
        self.rng = np.random.RandomState(seed)

    def _sample(self) -> Optional[Tuple[np.ndarray, float]]:
        from PIL import Image

        path = self.files[self.rng.randint(len(self.files))]
        img = _load_image(path)
        if img is None:
            return None
        h, w = img.shape[:2]
        bpp = _source_bpp(path, (h, w))
        crop = self.crop_size
        scale_low = max(crop / min(h, w), 0.75)
        scale = self.rng.uniform(scale_low, max(scale_low, 0.95))
        nh = max(crop, int(round(h * scale)))
        nw = max(crop, int(round(w * scale)))
        if (nh, nw) != (h, w):
            img = np.asarray(
                Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
        top = self.rng.randint(img.shape[0] - crop + 1)
        left = self.rng.randint(img.shape[1] - crop + 1)
        img = img[top: top + crop, left: left + crop]
        if self.rng.rand() < 0.5:
            img = img[:, ::-1]
        return np.ascontiguousarray(img), bpp

    def batches(self, batch_size: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite stream of (uint8 (B, crop, crop, 3), bpp (B,))."""
        while True:
            imgs, bpps = [], []
            while len(imgs) < batch_size:
                s = self._sample()
                if s is not None:
                    imgs.append(s[0])
                    bpps.append(s[1])
            yield np.stack(imgs), np.asarray(bpps, np.float32)


def prefetch(iterator, size: int = 4):
    """Run `iterator` in a daemon thread, keeping `size` items ready. An
    exception in the iterator is raised here, in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()

    def worker():
        try:
            for item in iterator:
                q.put((item, None))
        except Exception as e:  # handed to the consumer, re-raised there
            q.put((None, e))
        finally:
            q.put((done, None))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item, err = q.get()
        if err is not None:
            raise err
        if item is done:
            return
        yield item
