"""Input pipelines; counterpart of the JAX package's `training/data.py`
(`TrainDataset` with uint8 output, `CityScapesDataset`, `DeviceDataset`,
`EvalDataset`, `prefetch`).

`TrainDataset`: random scale in [max(crop / short side, 0.75), 0.95],
random crop to crop_size, horizontal flip; batches of uint8 NHWC crops (the
train step maps them to floats on the device) with each source file's
bpp, drawn by a pool of threads. `DeviceDataset`: the whole uint8 corpus on
the device once, each batch's crops drawn there. Decoding needs Pillow:
without it the datasets raise; a file Pillow cannot read is skipped.

Under data parallelism (`mesh`, a `parallel.mesh.DataParallel`) the batch
size is the global batch's: both datasets draw the global batch's random
choices from the shared seed on every rank and keep this rank's rows, so
the ranks' rows together are the single process's batch.
"""

import collections
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from hific_tpu_torch.parallel.mesh import shard_rows
from hific_tpu_torch.runtime import resolve_device
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

    def _draw(self) -> Tuple[str, int]:
        """A sample's file and seed, from the shared generator."""
        path = self.files[self.rng.randint(len(self.files))]
        return path, int(self.rng.randint(2 ** 31))

    def _sample_or_redraw(self, path: str, seed: int
                          ) -> Tuple[np.ndarray, float]:
        """The sample of (path, seed); where Pillow cannot read the file,
        that of another file drawn from a generator of `seed`, so that the
        shared generator is not touched."""
        redraw = np.random.RandomState(seed)
        while True:
            s = self._sample_path(path, np.random.RandomState(seed))
            if s is not None:
                return s
            path = self.files[redraw.randint(len(self.files))]
            seed = int(redraw.randint(2 ** 31))

    def batches(self, batch_size: int, num_workers: int = 4, mesh=None
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite stream of (uint8 (B, crop, crop, 3), bpp (B,)).

        num_workers > 1: decoding and augmenting fan out over a thread pool
        (Pillow releases the GIL while it decodes and resizes). The consumer
        draws each sample's file and seed from the shared generator as it
        submits it, so only one thread touches that generator and the
        stream is the same on every run. num_workers <= 1: one thread,
        every draw from the shared generator.

        mesh (data parallelism): `batch_size` is the global batch. Every
        rank draws the global batch's files and seeds as the threaded
        stream does and decodes only its rows, so the ranks' rows are the
        threaded stream's batch. A file Pillow cannot read is replaced by
        the rank that owns its row (from a generator of its seed), so a
        corpus with one gives other batches than a single process."""
        if mesh is not None:
            yield from self._shard_batches(batch_size, num_workers, mesh)
            return
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
            path, seed = self._draw()
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

    def _shard_batches(self, batch_size: int, num_workers: int, mesh):
        rows = shard_rows(np.arange(batch_size), mesh.index, mesh.world)
        with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
            while True:
                draws = [self._draw() for _ in range(batch_size)]
                samples = [f.result() for f in [
                    pool.submit(self._sample_or_redraw, *draws[i])
                    for i in rows]]
                yield (np.stack([img for img, _ in samples]),
                       np.asarray([bpp for _, bpp in samples], np.float32))


class CityScapesDataset(TrainDataset):
    """`TrainDataset` over CityScapes' `<root>/leftImg8bit/<split>/<city>/
    *.png` layout, or over `root` itself where that directory is absent,
    as the JAX package's `CityScapesDataset`."""

    def __init__(self, root: str, split: str = "train", crop_size: int = 256,
                 seed: int = 0):
        img_dir = os.path.join(root, "leftImg8bit", split)
        super().__init__(img_dir if os.path.isdir(img_dir) else root,
                         crop_size=crop_size, seed=seed)


class DeviceDataset:
    """The training corpus resident on the device: every image is uploaded
    once as uint8, and each batch's image pick, crop offsets and flips are
    drawn on the device from a device `torch.Generator` and gathered there,
    so no batch crosses from the host during training.

    As the JAX package's `DeviceDataset`: the images must share one shape,
    at least crop_size on each side, and fit the device beside the model;
    there is no random-scale jitter (for pre-cropped tiles the host
    pipeline's scale stage is nearly a no-op); and the crops follow the
    host pipeline's distribution, not its random stream. Batches are
    uint8 NHWC device tensors, which the train step maps to floats as it
    maps the host pipeline's. On the card unless `device` names another.

    mesh (data parallelism): every rank holds the corpus on its device and
    draws the global batch's picks, offsets and flips from the shared
    seed, then gathers only its rows: their values are the single
    device's batch's rows."""

    def __init__(self, root_or_files, crop_size: int = 256,
                 batch_size: int = 8, seed: int = 0, device=None,
                 mesh=None):
        files = (list_images(root_or_files)
                 if isinstance(root_or_files, str) else list(root_or_files))
        if not files:
            raise ValueError("no training images found")
        imgs, bpps, shape = [], [], None
        for path in files:
            img = _load_image(path)
            if img is None:
                continue
            if shape is None:
                shape = img.shape
            if img.shape != shape:
                raise ValueError(
                    f"DeviceDataset needs uniformly-sized images: {path} is "
                    f"{img.shape}, first was {shape}. Pre-crop the corpus "
                    "(or use the host TrainDataset pipeline).")
            if min(shape[0], shape[1]) < crop_size:
                raise ValueError(f"images ({shape[0]}x{shape[1]}) smaller "
                                 f"than crop_size {crop_size}")
            imgs.append(img)
            bpps.append(_source_bpp(path, img.shape))
        if not imgs:
            raise ValueError("no readable training images found")
        self.mesh = mesh
        if mesh is not None:
            shard_rows(np.arange(batch_size), mesh.index, mesh.world)
        self.data = torch.from_numpy(np.stack(imgs)).to(
            resolve_device(device))  # (N, H, W, 3)
        self.crop_size = crop_size
        self.batch_size = batch_size
        self.mean_bpp = float(np.mean(bpps))
        self.generator = torch.Generator(device=self.data.device)
        self.generator.manual_seed(seed)

    def sample(self) -> torch.Tensor:
        """One uint8 batch (B, crop, crop, 3) on the device (this rank's
        rows under a mesh): a uniform image per row, uniform crop offsets,
        each crop flipped left-right with probability 1/2, in one
        gather."""
        n, h, w, _ = self.data.shape
        b, crop, dev = self.batch_size, self.crop_size, self.data.device
        g = self.generator
        idx = torch.randint(0, n, (b,), generator=g, device=dev)
        oy = torch.randint(0, h - crop + 1, (b,), generator=g, device=dev)
        ox = torch.randint(0, w - crop + 1, (b,), generator=g, device=dev)
        flip = torch.rand((b,), generator=g, device=dev) < 0.5
        if self.mesh is not None:
            idx, oy, ox, flip = (self.mesh.shard(t)
                                 for t in (idx, oy, ox, flip))
        span = torch.arange(crop, device=dev)
        rows = oy[:, None] + span
        cols = ox[:, None] + torch.where(flip[:, None], span.flip(0), span)
        return self.data[idx[:, None, None], rows[:, :, None],
                         cols[:, None, :]]

    def batches(self, batch_size: Optional[int] = None
                ) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
        """Infinite stream of (uint8 device batch, the corpus' mean bpp per
        row). The batch size is fixed at construction."""
        if batch_size is not None and batch_size != self.batch_size:
            raise ValueError(f"batch_size {batch_size} != {self.batch_size}, "
                             f"the one DeviceDataset was built for")
        rows = self.batch_size // (1 if self.mesh is None
                                   else self.mesh.world)
        bpps = np.full((rows,), self.mean_bpp, np.float32)
        while True:
            yield self.sample(), bpps


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
