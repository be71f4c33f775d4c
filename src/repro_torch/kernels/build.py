"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

``nvcc`` compiles every ``*.cu`` there for ``sm_90a``, one process per
source and all at once, and links the objects into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds). The library is built at first use,
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

GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = GENCODE + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-fmad=false", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
# argtypes of each C entry point (pointers and the stream as c_void_p, so
# ctypes does not cut a 64-bit address to an int)
SIGNATURES = {
    # rho, c, disc, rew, v, vtp1, out; T, B, cluster, seg, chunk,
    # threads, smem; stream
    "repro_vtrace": [_P] * 7 + [_I] * 7 + [_P],
    # logits, onehot, blp, disc, rew, v, vtp1, out; T, B, A, cluster, seg,
    # chunk, threads, stage_logits, smem; rho_bar, clip_rho, c_bar, clip_c,
    # lambda; stream
    "repro_loss_vtrace": [_P] * 8 + [_I] * 9 + [_F, _I, _F, _I, _F, _P],
    # q, k, v, o; B, T, S, H, K, D, causal, window; scale, is_bf16, stream
    "repro_flash_attention": [_P] * 4 + [_I] * 8 + [_F, _I, _P],
    # q, k, v, bias, o, part_m, part_l, part_acc; B, S, H, K, D, nsplit,
    # split_len; scale, is_bf16, stream
    "repro_decode_attention": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
    # a, b, h0 (None for zeros), h; T, N; stream
    "repro_linear_scan": [_P] * 4 + [_L, _L, _P],
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        try:
            for src in sources():
                obj = os.path.join(tmp, src.stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                objs.append(obj)
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs = [_finish(cmd, proc) for cmd, proc in procs]
        finally:
            for _, proc in procs:       # a failed compile stops the others
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        so = os.path.join(tmp, LIB_NAME)
        cmd = [nvcc, *GENCODE, "-shared", "-o", so, *objs]
        logs.append(_finish(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        log = "".join(logs)
        log_path.write_text(log)
        os.replace(so, lib)           # atomic: a reader never sees a part
    return lib, log


def _finish(cmd, proc: subprocess.Popen) -> str:
    """Wait for one nvcc; raise with its output if it failed."""
    try:
        out, _ = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out: {' '.join(cmd)}") from None
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}")
    return out


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


# ---------------------------------------------------------------------------
# What every kernel wrapper does around a launch


def on_cuda(device, what: str) -> bool:
    """True for a CUDA device (launch the kernel), False for the CPU (take
    the plain version); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no {what} kernel or plain version for {device}")


def check_f32(name: str, x, shape, device) -> None:
    """Raise unless ``x`` is a contiguous float32 tensor of ``shape`` on
    ``device``: what the float32 kernels take."""
    import torch
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_f32s(names, xs, shape, device) -> None:
    """``check_f32`` over several tensors in one pass of plain attribute
    tests; where one fails, ``check_f32`` goes over them again to raise
    with the name and the reason."""
    import torch
    for x in xs:
        if x.dtype != torch.float32 or x.shape != shape or \
                x.device != device or not x.is_contiguous():
            break
    else:
        return
    for name, x in zip(names, xs):
        check_f32(name, x, shape, device)


def call_on(device, fn, *args):
    """``fn(*args)`` with ``device`` current: no context switch (a few
    microseconds of host time) where it already is."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


def stream(device) -> int:
    """The current stream of ``device``, as the int ctypes passes on (the
    raw handle, without building a ``torch.cuda.Stream``: a launch's host
    time matters on the serving path)."""
    import torch
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def raise_on(code: int, name: str) -> None:
    """A C entry point returns its launch's ``cudaError_t``; 0 is success."""
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {code}")
