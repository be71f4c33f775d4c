"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

``nvcc`` compiles every ``*.cu`` there for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library is built at first use,
from the checkout's sources only, into ``build/repro_torch_kernels/<key>/``
at the root of the checkout, where ``<key>`` hashes the sources and the
flags: an edited source builds anew, an unchanged one loads at once.
Nothing is compiled or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <checkout>/build/repro_torch_kernels (src/repro_torch/kernels/build.py)
BUILD_ROOT = (Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
LIB_NAME = "librepro_torch_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of each C entry point (pointers and the stream as c_void_p, so
# ctypes does not cut a 64-bit address to an int)
SIGNATURES = {
    "repro_vtrace": [_P] * 8 + [_I, _I, _P],
    "repro_loss_vtrace": [_P] * 11 + [_I, _I, _I, _F, _I, _F, _I, _F, _P],
}


def sources() -> Tuple[Path, ...]:
    return tuple(sorted(CSRC.glob("*.cu")))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def build() -> Tuple[Path, str]:
    """Compile the library unless this key's copy exists.

    Returns (path, compiler log); the log of an earlier build is read back
    from ``build.log`` beside the library."""
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib)          # atomic: a reader never sees a part
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib, log


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
