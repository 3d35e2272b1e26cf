"""Build a CUDA source of the package into a shared library and load it.

The kernels have a plain C interface (pointers, ints and the stream), so
each source (``csrc/traverse.cu``, ``csrc/traverse_q.cu``) is compiled by
``nvcc`` alone, without PyTorch's headers, into a library of its own in
:func:`build_dir`, and loaded with ``ctypes``. A build is keyed on a hash of
the source, the headers it includes from its own directory, and the flags:
an unchanged source is built once per build directory, at its first use.
The target is Hopper (``sm_90a``). :class:`KernelEntry` binds a kernel
whose arguments travel as one C struct.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

# The package's own build directory, used where it can be written.
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# The directory that holds the package: in a checkout, the repository's root;
# in an installation, the site directory.
ROOT = BUILD_DIR.parent.parent

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


def _writable(path: Path) -> bool:
    """Whether ``path`` may be written: the process has the access and the
    mode grants someone write. Root passes every access check, so the mode
    is what tells it that a package was installed read-only."""
    return os.access(path, os.W_OK) and bool(path.stat().st_mode & 0o222)


def build_dir() -> Path:
    """Where the package's native and CUDA libraries are built: the
    package's ``_build/`` where it (or, before the first build, the package
    directory) can be written, else ``$XDG_CACHE_HOME/minipath_tpu_torch``
    (``~/.cache/minipath_tpu_torch`` where that variable is unset), as in an
    installation that is read-only. The directory is created if missing."""
    if _writable(BUILD_DIR if BUILD_DIR.exists() else BUILD_DIR.parent):
        out = BUILD_DIR
    else:
        out = _user_cache()
    out.mkdir(parents=True, exist_ok=True)
    return out


def _user_cache() -> Path:
    return Path(os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache") / "minipath_tpu_torch"


def bench_cache_dir() -> Path:
    """Where the bench and the tools cache the scenes they build. In a
    checkout, the repository's ``.bench_cache/torch/`` (``.gitignore`` lists
    it); in an installation, ``$XDG_CACHE_HOME/minipath_tpu_torch/bench_cache``
    (``~/.cache/...`` where that variable is unset). A checkout is told by
    its mark, the repository's ``pyproject.toml`` beside the package, which
    an installation does not carry; whether the site directory can be
    written tells nothing, since a virtual environment's can. The directory
    is created if missing."""
    if (ROOT / "pyproject.toml").is_file():
        out = ROOT / ".bench_cache" / "torch"
    else:
        out = _user_cache() / "bench_cache"
    out.mkdir(parents=True, exist_ok=True)
    return out


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def source_bytes(source: Path, _seen=None) -> bytes:
    """``source``'s bytes followed by those of every header it includes by a
    quoted name, headers of headers too, each once: what a build's key must
    cover, or an edited header would go on running an old library."""
    seen = set() if _seen is None else _seen
    seen.add(source)
    data = source.read_bytes()
    for name in _INCLUDE.findall(data):
        header = (source.parent / name.decode()).resolve()
        if header not in seen:
            data += source_bytes(header, seen)
    return data


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
            source_bytes(source) + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = build_dir() / f"lib{source.stem}-{digest}.so"
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
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


class KernelEntry:
    """The launch of one C entry point of a kernel library whose arguments
    travel as one C struct: ``int <prefix>_<name>(const void* args, void*
    stream)`` in ``source``, which also exports ``<prefix>_error_string``
    and ``<prefix>_args_size``. ``args`` is the ctypes mirror of the struct,
    field for field; its size is checked against the source's at the first
    load.

    Calling it launches on ``device``'s current stream. Each of ``fields``
    names a field of ``args``: a tensor (on ``device``; its address is
    passed), None (a null pointer) or a number. The caller keeps the tensors
    alive and gives them the dtypes and shapes the kernel reads. The struct
    is read on the host, at the launch. ``launches`` counts launches."""

    def __init__(self, source: Path, args: type[ctypes.Structure], prefix: str, name: str):
        self.source, self.args, self.prefix = source, args, prefix
        self.symbol = f"{prefix}_{name}"
        self._names = frozenset(field for field, _ in args._fields_)
        self.launches = 0

    def load(self) -> CudaLibrary:
        """Build (at first use) and load the library; returns the
        :class:`CudaLibrary`."""
        built = load_cuda_library(self.source)
        lib = built.lib
        fn = getattr(lib, self.symbol)
        if fn.argtypes is None:
            error_string = getattr(lib, f"{self.prefix}_error_string")
            error_string.argtypes, error_string.restype = [ctypes.c_int32], ctypes.c_char_p
            args_size = getattr(lib, f"{self.prefix}_args_size")
            args_size.restype = ctypes.c_int32
            if args_size() != ctypes.sizeof(self.args):
                raise RuntimeError(f"{self.args.__module__}.{self.args.__name__} disagrees with the argument "
                                   f"struct of {self.source.name}")
            fn.argtypes, fn.restype = [ctypes.POINTER(self.args), ctypes.c_void_p], ctypes.c_int32
        return built

    def __call__(self, device, **fields) -> None:
        import torch

        args = self.args()
        for name, value in fields.items():
            if name not in self._names:
                raise TypeError(f"no field {name!r} in the arguments of {self.symbol}")
            if isinstance(value, torch.Tensor):
                if value.device != device:
                    raise ValueError(f"{name} is on {value.device}, the launch on {device}")
                value = value.data_ptr()
            setattr(args, name, value)
        lib = self.load().lib
        with torch.cuda.device(device):
            err = getattr(lib, self.symbol)(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            error_string = getattr(lib, f"{self.prefix}_error_string")
            raise RuntimeError(f"{self.symbol} launch failed: cudaError {err} ({error_string(err).decode()})")
        self.launches += 1
