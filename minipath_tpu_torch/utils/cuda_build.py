"""Build a CUDA source of the package into a shared library and load it.

The kernels have a plain C interface (pointers, ints and the stream), so
each source (``csrc/traverse.cu``, ``csrc/traverse_q.cu``) is compiled by
``nvcc`` alone, without PyTorch's headers, into a library of its own in
``minipath_tpu_torch/_build/``, and loaded with ``ctypes``. A build is keyed
on a hash of the source and the flags: an unchanged source is built once per
checkout, at its first use. The target is Hopper (``sm_90a``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# No --use_fast_math: the kernels rely on IEEE division and square root.
# -fmad=false keeps multiply and add as separately rounded steps, so a kernel
# gives the same bits as its plain PyTorch version, op for op. With fused
# multiply-adds the traversal's Möller–Trumbore t drifts up to 4e-5 relative
# (normals 5e-4) from the plain version on camera rays of the atrium, past
# the 1e-5 (1e-4) the kernel is held to; the fused build is about 6% faster
# (NVIDIA H100 80GB HBM3, 700 W).
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


@dataclass
class CudaLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc's and ptxas' report (registers, spills)


_libraries: dict[Path, CudaLibrary] = {}
_locks: dict[Path, threading.Lock] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: install the CUDA toolkit or set CUDA_HOME")


def load_cuda_library(source: Path) -> CudaLibrary:
    """Compile ``source`` (if its build is missing) and load it. Each source
    has its own lock, so that threads build different sources at once.

    The wrappers call this at every launch, so a source already loaded is
    found by the path as given, before ``Path.resolve``: where file-system
    calls are slow, its system calls cost more than the launch itself
    (``chip_smoke.py`` phase 13 times both).
    """
    built = _libraries.get(source)
    if built is not None:
        return built
    given, source = source, Path(source).resolve()
    with _lock:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        if source in _libraries:
            _libraries[given] = _libraries[source]
            return _libraries[source]
        digest = hashlib.sha256(
            source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"lib{source.stem}-{digest}.so"
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                capture_output=True,
                text=True,
            )
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
                    f"{proc.stderr}{proc.stdout}"
                )
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        log = log_path.read_text() if log_path.exists() else ""
        built = CudaLibrary(ctypes.CDLL(str(out)), out, seconds, log)
        _libraries[source] = _libraries[given] = built
        return built
