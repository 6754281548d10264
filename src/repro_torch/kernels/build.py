"""Build and load the hand-written CUDA kernels (``csrc/``).

The sources have a plain C interface: ``nvcc`` compiles them for
``sm_90a`` into a shared library under ``build/repro_torch_kernels/`` at
the root of the checkout, named by a digest of the sources so an edit
rebuilds, and ``ctypes`` loads it. Nothing here runs at import: the first
wrapper that launches a kernel builds the library, and the CPU tests,
which never launch one, need no compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("attention.cu",)
HEADERS = ("attention.cuh",)
#: build/ at the root of the checkout (src/repro_torch/kernels -> root)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argtypes of every C entry point; every one returns a cudaError_t as int
SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P] + [_I] * 8 + [_P],
    "paged_decode_fwd": [_P] * 6 + [_I] * 7 + [_P],
    "bullet_attention_paged_fwd": [_P] * 4 + [_I] * 5 + [_P] * 6
                                  + [_I] * 9 + [_P],
    "bullet_ctas_per_sm": [_I] * 4 + [ctypes.POINTER(_I)],
}


class Build(NamedTuple):
    path: Path
    seconds: float          # 0.0 when the library was already built
    log: str                # nvcc's output (ptxas register/smem report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libattention_{_digest()}.so"


def build() -> Build:
    """Compile the sources unless this digest is already built. The output
    is written to a temporary name and renamed into place, so concurrent
    builders never load a half-written library."""
    out = library_path()
    if out.is_file():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Build(out, time.perf_counter() - t0, res.stdout + res.stderr)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.attention_error_string.argtypes = [ctypes.c_int]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().attention_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device, as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


#: dtype codes of the C interface
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}
#: head dims the library is instantiated for (HEAD_DIM in attention.cu)
HEAD_DIMS = (128,)


def check_inputs(kernel: str, floats, ints=()) -> int:
    """Validate what a launch receives before any pointer crosses into C:
    every tensor on one CUDA device and contiguous, the float tensors of
    one supported dtype, the index tensors int32. Returns the dtype code."""
    first = floats[0]
    for t in (*floats, *ints):
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{kernel}: every tensor must be on "
                             f"{first.device} (a CUDA device), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: tensors must be contiguous")
    code = DTYPE_CODES.get(str(first.dtype))
    if code is None or any(t.dtype != first.dtype for t in floats):
        raise TypeError(f"{kernel}: float32 or bfloat16 inputs of one dtype, "
                        f"got {[t.dtype for t in floats]}")
    for t in ints:
        if str(t.dtype) != "torch.int32":
            raise TypeError(f"{kernel}: index tensors must be int32, "
                            f"got {t.dtype}")
    d = first.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head dim {d} not in {HEAD_DIMS}")
    return code
