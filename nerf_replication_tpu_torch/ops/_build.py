"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled at
first use into ``<repo>/build/lib<name>-<hash>.so``, keyed by a hash of
the source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source rebuilds and an unchanged one is loaded as it is. ``nvcc -Xptxas
-v`` output (registers, shared memory, spills) is kept beside the library
as ``.log``.
"""

from __future__ import annotations

import ctypes
import concurrent.futures
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# never --use_fast_math: the encoders need precise sinf/cosf
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from source and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Path of the built library for ``csrc/<name>.cu``; builds it if the
    source or the flags changed since the last build."""
    src = CSRC_DIR / f"{name}.cu"
    key = src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # the shared headers
        key += header.read_bytes()
    lib = BUILD_DIR / f"lib{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib


def build_all(names) -> None:
    """Build every source in ``names`` that needs it, one nvcc each, all
    started together."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(library_path, names))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; callers keep the
    handle (and the ``argtypes`` they set on it)."""
    return ctypes.CDLL(str(library_path(name)))


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launch of ``lib``,
    a library that exports ``nerf_cuda_error_string``."""
    if err != 0:
        text = lib.nerf_cuda_error_string
        text.argtypes, text.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name} launch failed: {text(err).decode()}")
