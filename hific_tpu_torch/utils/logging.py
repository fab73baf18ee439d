"""Console logging of the port's command-line tools; counterpart of
`setup_logger` in the JAX package's `utils/logging.py`."""

import logging
import os
import sys
from typing import Optional


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
