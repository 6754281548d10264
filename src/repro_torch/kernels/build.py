"""Build and load the hand-written CUDA kernels (``csrc/``).

The sources have a plain C interface: ``nvcc`` compiles each of them for
``sm_90a`` into an object file, all at once in parallel, and links them
into one shared library under ``build/repro_torch_kernels/`` at the root
of the checkout, named by a digest of the sources so an edit rebuilds;
``ctypes`` loads it. ``attention.cu`` holds the attention kernels (flash
prefill and dense decode at head dims 64, 128 and 256, paged decode and the
fused launches at 64 and 128; in bf16 the flash body runs on the tensor cores
through wgmma and TMA, so ``sm_90a``'s ``a`` is needed),
``flash_attention_bwd.cu`` the gradient of the flash prefill in fp32 and
``flash_attention_bwd_tc.cu`` in bf16 on the tensor cores (D = 64, 128 and
256), ``ssd_scan.cu``
the Mamba-2 SSD chunk scan (in bf16 C Bᵀ once per row and chunk, the
chunk states, a pass over the chunks and the outputs, on the tensor cores
through ``mma.sync``), ``ssd_scan_bwd.cu`` its gradient in fp32 and
``ssd_scan_bwd_tc.cu`` in bf16 on the tensor cores, and
``rglru_scan.cu`` the RG-LRU linear recurrence and its gradient (fp32 and
bf16). The geometry of the split
decode bodies and of the bf16 SSD scan (``geometry.all_defines()``)
reaches every source as ``-D`` defines and is part of the digest.
Nothing here runs at import: the first wrapper that launches a kernel
builds the library, and the CPU tests, which never launch one, need no
compiler.
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

from repro_torch.kernels.geometry import all_defines

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("attention.cu", "flash_attention_bwd.cu",
           "flash_attention_bwd_tc.cu", "ssd_scan.cu", "ssd_scan_bwd.cu",
           "ssd_scan_bwd_tc.cu", "rglru_scan.cu")
HEADERS = ("attention.cuh",)
#: build/ at the root of the checkout (src/repro_torch/kernels -> root)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argtypes of every C entry point; every one returns a cudaError_t as int
SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, _P] + [_I] * 9 + [_P],
    "flash_attention_fwd_lse": [_P] * 5 + [_I] * 7 + [_P],
    "flash_attention_bwd": [_P] * 10 + [_I] * 9 + [_P],
    "flash_attention_bwd_tc": [_P] * 11 + [_I] * 8 + [_P],
    "paged_decode_fwd": [_P] * 6 + [_I] * 7 + [_P],
    "paged_decode_split_fwd": [_P] * 9 + [_I] * 8 + [_P],
    "bullet_attention_paged_fwd": [_P] * 4 + [_I] * 5 + [_P] * 9
                                  + [_I] * 9 + [_P, _P] + [_I] * 2 + [_P],
    "decode_attention_fwd": [_P] * 6 + [_I] * 6 + [_P],
    "decode_attention_split_fwd": [_P] * 9 + [_I] * 8 + [_P],
    "bullet_attention_fwd": [_P] * 4 + [_I] * 5 + [_P] * 9 + [_I] * 8
                            + [_P, _P] + [_I] * 2 + [_P],
    "bullet_ctas_per_sm": [_I] * 5 + [ctypes.POINTER(_I)],
    "split_decode_ctas_per_sm": [_I, _I, ctypes.POINTER(_I)],
    "ssd_scan_fwd": [_P] * 10 + [_I] * 8 + [_P],
    "ssd_scan_bwd": [_P] * 17 + [_I] * 6 + [_P],
    "ssd_scan_bwd_tc": [_P] * 18 + [_I] * 7 + [_P],
    "rglru_scan_fwd": [_P] * 5 + [_I] * 4 + [_P],
    "rglru_scan_bwd": [_P] * 8 + [_I] * 4 + [_P],
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
    h.update(repr(sorted(all_defines().items())).encode())
    return h.hexdigest()[:16]


def compile_command(nvcc: str, src: str, obj: str) -> list:
    """The ``nvcc -c`` of one source: sm_90a, the geometry's defines,
    ptxas's register and spill report."""
    return [nvcc, "-gencode", ARCH, "-std=c++17", "-O3",
            *(f"-D{k}={v}" for k, v in sorted(all_defines().items())),
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", "-o", obj,
            str(CSRC / src)]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_kernels_{_digest()}.so"


def build() -> Build:
    """Compile the sources unless this digest is already built: one
    ``nvcc -c`` per source, all started together, then one link. The
    library is written to a temporary name and renamed into place, so
    concurrent builders never load a half-written library; nvcc's report
    is kept beside it (``.log``) for a later caller."""
    out = library_path()
    if out.is_file():
        log = out.with_suffix(".log")
        return Build(out, 0.0, log.read_text() if log.is_file() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                compile_command(nvcc, src, obj), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            text = proc.communicate()[0]
            logs.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(logs))
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, "-gencode", ARCH, "-shared", "-o", lib,
                              *objs], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, out)
    return Build(out, time.perf_counter() - t0, "".join(logs))


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
#: head dims the flash prefill and dense decode kernels are instantiated
#: for (DISPATCH in attention.cu): the D = 64 of Granite-3.0-2B and
#: SeamlessM4T-Large-v2, the D = 128 of Qwen3 and Llama, the D = 256 of
#: RecurrentGemma
HEAD_DIMS = (64, 128, 256)
#: head dims of the paged decode and the two fused kernels
#: (DISPATCH_PAGED in attention.cu): only the paged path runs them, and it
#: serves D = 64 (Granite) and D = 128 models
PAGED_HEAD_DIMS = (64, 128)
#: head dims of the flash backward (``flash_attention_bwd.cu``): those of
#: the models that train on the card (D = 256: RecurrentGemma's local
#: attention, in 32-row tiles)
BWD_HEAD_DIMS = (64, 128, 256)


def check_inputs(kernel: str, floats, ints=(), fp32=(), *,
                 head_dim: bool = True, head_dims=HEAD_DIMS) -> int:
    """Validate what a launch receives before any pointer crosses into C:
    every tensor on one CUDA device and contiguous, the float tensors of
    one supported dtype, the ``fp32`` tensors float32, the index tensors
    int32, and (attention kernels, ``head_dim``) the last dim of the first
    tensor one of ``head_dims``. Returns the dtype code. Meta tensors (a
    dry-run's stand-ins for the card's) pass the same checks, all on the
    meta device."""
    first = floats[0]
    for t in (*floats, *ints, *fp32):
        if not (t.is_cuda or t.is_meta) or t.device != first.device:
            raise ValueError(f"{kernel}: every tensor must be on "
                             f"{first.device} (a CUDA device, or meta for a "
                             f"dry-run), got {t.device}")
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
    for t in fp32:
        if str(t.dtype) != "torch.float32":
            raise TypeError(f"{kernel}: {tuple(t.shape)} must be float32, "
                            f"got {t.dtype}")
    d = first.shape[-1]
    if head_dim and d not in head_dims:
        raise ValueError(f"{kernel}: head dim {d} not in {head_dims}")
    return code


def refuse_grad(kernel: str, tensors, item: str) -> None:
    """Raise ``NotImplementedError`` when grad mode is on and one of
    ``tensors`` (None entries skipped) requires grad: the kernel writes
    its output through a raw pointer, so autograd would see a result cut
    off from the graph and every gradient before the call would be lost
    without an error. ``item`` names the ROADMAP item that brings the
    kernel's backward (kernels 2-5: the decode and fused serving kernels,
    which no training path runs)."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kernel}: no backward on the card yet ({item}); train this "
            "model on the CPU, where the plain version is differentiable")


def check_aligned(kernel: str, tensors) -> None:
    """The bf16 attention bodies read through TMA maps and 16-byte
    ``cp.async`` copies: each tensor must start 16-byte aligned."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: bfloat16 tensors must start "
                             f"16-byte aligned")
