"""Logging of the port's command-line tools; counterpart of the JAX
package's `utils/logging.py` (`setup_logger`, `MetricWriter`,
`save_side_by_side`).

Scalars go to `metrics.jsonl` always, and to TensorBoard event files
through `torch.utils.tensorboard` where it imports (as the JAX package's
go through TensorFlow where that imports).
"""

import json
import logging
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from hific_tpu_torch.utils.image_io import write_png

MAX_IMAGES = 4  # images of a batch shown in TensorBoard and side by side


def setup_logger(log_dir: Optional[str] = None,
                 name: str = "hific_tpu_torch") -> logging.Logger:
    """INFO to stdout (and to `<log_dir>/train.log` when given); a logger
    that already has handlers is returned as it is."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "train.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class MetricWriter:
    """Scalar sink: `<log_dir>/metrics.jsonl` always, TensorBoard when
    `torch.utils.tensorboard` imports; `storage` keeps every value written,
    by key, in memory."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)
        self.storage = defaultdict(list)

    def write(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        record = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}"
            record[key] = float(v)
            self.storage[key].append(float(v))
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}{k}", float(v), int(step))
            self._tb.flush()

    def write_images(self, step: int, images: Dict[str, np.ndarray]):
        """The first MAX_IMAGES of NHWC [0, 1] image batches to
        TensorBoard; nothing without it."""
        if self._tb is None:
            return
        for name, batch in images.items():
            arr = np.clip(np.asarray(batch)[:MAX_IMAGES], 0.0, 1.0)
            self._tb.add_images(name, arr, int(step), dataformats="NHWC")
        self._tb.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def save_side_by_side(path: str, inputs, recons) -> str:
    """An input | reconstruction PNG, one row for each of the first
    MAX_IMAGES images, of NHWC float batches in [0, 1]."""
    x = np.clip(np.asarray(inputs)[:MAX_IMAGES], 0.0, 1.0)
    r = np.clip(np.asarray(recons)[:MAX_IMAGES], 0.0, 1.0)
    rows = [np.concatenate([xi, ri], axis=1) for xi, ri in zip(x, r)]
    write_png(path, np.concatenate(rows, axis=0))
    return path
