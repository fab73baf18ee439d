"""Build a shared library from this package's C++/CUDA sources at first use.

Outputs go to `hific_tpu_torch/_build/` (listed in `.gitignore`), named by a
hash of the sources and the command, so an edited source builds anew and an
unchanged one is built once per checkout. A build writes to a temporary
name and renames it into place: there is no lock file, so a build cut off
half way leaves nothing that a later build waits on.
"""

import hashlib
import os
import shutil
import subprocess
import time
from typing import List, NamedTuple

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


class Built(NamedTuple):
    path: str
    seconds: float  # 0.0 when the library was already built
    log: str        # the compiler's output (nvcc's -Xptxas -v report)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "hific_tpu_torch are built on a machine with the "
                           "CUDA toolkit")
    return path


def build_library(name: str, sources: List[str], compiler: List[str]
                  ) -> Built:
    """Compile `sources` with `compiler` (argv prefix) into a .so."""
    digest = hashlib.sha256(" ".join(compiler[1:]).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    path = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return Built(path, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run(compiler + sources + ["-o", tmp],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building {name} failed ({' '.join(compiler)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return Built(path, seconds, proc.stdout + proc.stderr)
