"""Input pipelines; counterpart of the JAX package's `training/data.py`
(`TrainDataset` with uint8 output, `EvalDataset`, `prefetch`).

Random scale in [max(crop / short side, 0.75), 0.95], random crop to
crop_size, horizontal flip; batches of uint8 NHWC crops (the train step
maps them to floats on the device) with each source file's bpp, drawn by
a pool of threads. Decoding needs Pillow: without it the dataset raises; a
file Pillow cannot read is skipped.
"""

import collections
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from hific_tpu_torch.utils.image_io import read_image

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".webp")


def list_images(root: str) -> List[str]:
    files = []
    for dirpath, _, filenames in os.walk(root):
        for f in sorted(filenames):
            if f.lower().endswith(IMG_EXTENSIONS):
                files.append(os.path.join(dirpath, f))
    return sorted(files)


def _load_image(path: str) -> Optional[np.ndarray]:
    try:  # no Pillow: ImportError, never "skip every file"
        return read_image(path)
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
        path = self.files[self.rng.randint(len(self.files))]
        return self._sample_path(path, self.rng)

    def _sample_path(self, path: str, rng: np.random.RandomState
                     ) -> Optional[Tuple[np.ndarray, float]]:
        from PIL import Image

        img = _load_image(path)
        if img is None:
            return None
        h, w = img.shape[:2]
        bpp = _source_bpp(path, (h, w))
        crop = self.crop_size
        scale_low = max(crop / min(h, w), 0.75)
        scale = rng.uniform(scale_low, max(scale_low, 0.95))
        nh = max(crop, int(round(h * scale)))
        nw = max(crop, int(round(w * scale)))
        if (nh, nw) != (h, w):
            img = np.asarray(
                Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
        top = rng.randint(img.shape[0] - crop + 1)
        left = rng.randint(img.shape[1] - crop + 1)
        img = img[top: top + crop, left: left + crop]
        if rng.rand() < 0.5:
            img = img[:, ::-1]
        return np.ascontiguousarray(img), bpp

    def batches(self, batch_size: int, num_workers: int = 4
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite stream of (uint8 (B, crop, crop, 3), bpp (B,)).

        num_workers > 1: decoding and augmenting fan out over a thread pool
        (Pillow releases the GIL while it decodes and resizes). The consumer
        draws each sample's file and seed from the shared generator as it
        submits it, so only one thread touches that generator and the
        stream is the same on every run. num_workers <= 1: one thread,
        every draw from the shared generator."""
        if num_workers <= 1:
            while True:
                imgs, bpps = [], []
                while len(imgs) < batch_size:
                    s = self._sample()
                    if s is not None:
                        imgs.append(s[0])
                        bpps.append(s[1])
                yield np.stack(imgs), np.asarray(bpps, np.float32)

        def submit(pool):
            path = self.files[self.rng.randint(len(self.files))]
            seed = int(self.rng.randint(2 ** 31))
            return pool.submit(self._sample_path, path,
                               np.random.RandomState(seed))

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            pending = collections.deque(
                submit(pool) for _ in range(batch_size + num_workers))
            imgs, bpps = [], []
            while True:
                s = pending.popleft().result()
                pending.append(submit(pool))
                if s is None:
                    continue
                imgs.append(s[0])
                bpps.append(s[1])
                if len(imgs) == batch_size:
                    yield np.stack(imgs), np.asarray(bpps, np.float32)
                    imgs, bpps = [], []


class EvalDataset:
    """Full-resolution evaluation images with their files' bpp and paths."""

    def __init__(self, root_or_files, normalize: bool = False):
        if isinstance(root_or_files, str):
            self.files = list_images(root_or_files)
        else:
            self.files = list(root_or_files)
        self.normalize = normalize

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, float, str]]:
        """(float32 (1, H, W, 3) in [0, 1] (or [-1, 1] when normalized),
        source bpp, path) per readable file."""
        for path in self.files:
            img = _load_image(path)
            if img is None:
                continue
            x = img.astype(np.float32) / 255.0
            if self.normalize:
                x = x * 2.0 - 1.0
            yield x[None], _source_bpp(path, img.shape), path


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
