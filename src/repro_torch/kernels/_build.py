"""Builds ``csrc/*.cu`` into one shared library and loads it with ctypes.

The kernels have a plain C interface (no PyTorch headers), so ``nvcc``
compiles each source in seconds; the sources are compiled in parallel, one
``nvcc`` per file, and linked into ``libfrontier_kernels-<hash>.so`` under
the build directory.  The hash covers the sources and the flags, so a
library is rebuilt only when either changes.  Nothing happens at import:
the first kernel launch triggers the build.

The build directory is ``build/kernels`` at the root of the source checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
#: seconds the last real build took (0.0 when the library was found built)
last_build_s: float = 0.0


class KernelBuildError(RuntimeError):
    """nvcc missing, or a source failed to compile or link."""


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels cannot be built without it")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global last_build_s
    out_dir = build_dir()
    lib = out_dir / f"libfrontier_kernels-{_digest()}.so"
    if lib.is_file():
        last_build_s = 0.0
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in sources():
        obj = out_dir / f"{src.stem}-{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failed = [], []
    for src, obj, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            print(log)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
        objs.append(obj)
    try:
        if failed:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
        tmp = out_dir / f"{lib.name}.{os.getpid()}.tmp"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelBuildError("link failed:\n" + link.stdout)
        os.replace(tmp, lib)     # atomic: concurrent processes that build agree
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    last_build_s = time.perf_counter() - t0
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_int64)
    lib.frontier_flash_attention.argtypes = [
        p, p, p, p, i, i, i, i, i, i, i, strides, f, i, i, p]
    lib.frontier_flash_attention.restype = i
    lib.frontier_decode_attention.argtypes = [
        p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, strides, f, p]
    lib.frontier_decode_attention.restype = i
    lib.frontier_grouped_gemm.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.frontier_grouped_gemm.restype = i
    lib.frontier_grouped_gemm_plan.argtypes = [i, i, i, i, i, i, i,
                                               ctypes.POINTER(ctypes.c_int)]
    lib.frontier_grouped_gemm_plan.restype = None
    lib.frontier_wkv_chunked.argtypes = [
        p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, strides, p]
    lib.frontier_wkv_chunked.restype = i


def load(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build(verbose=verbose)))
        _declare(lib)
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise when a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def dtype_code(dtype) -> int:
    import torch
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")


def aligned(t):
    """``t`` with a contiguous last dim, or an error: the attention kernels
    load 16 bytes at a time, so every row must start on a 16-byte boundary."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    per16 = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:-1]):
        raise ValueError("attention kernels need 16-byte aligned rows; got "
                         f"strides {tuple(t.stride())} at {t.data_ptr():#x}")
    return t


def stride_array(*values: int):
    return (ctypes.c_int64 * len(values))(*values)
