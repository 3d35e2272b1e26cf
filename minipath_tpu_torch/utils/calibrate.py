"""Device-health probe for benchmark artifacts, and the chain kernel behind it.

Port of ``minipath_tpu/utils/calibrate.py``. Every benchmark artifact embeds
:func:`device_health`, so that numbers can be compared across artifacts: two
runs with matching health figures are comparable, and a throughput change
that tracks a health change is the card or its host, not the code. Four
probes, with the JAX package's keys:

* ``matmul_8k_bf16_tflops``: chained ``tanh(m @ m)`` on 8192x8192 bf16 (the
  tensor cores). The product is a plain ``torch.matmul``, as the JAX package
  leaves it to XLA.
* ``vpu_chain_gops``: the dependent multiply/min/max chain (the op mix of the
  BVH slab test) through the hand-written kernel, counted with the JAX
  package's 5 operations per element and iteration so that the figures
  compare; the kernel itself executes 4 (two multiplies, a min and a max).
* ``fetch_mb_s``: device-to-host rate on an 8 MB buffer.
* ``roundtrip_ms``: one trivial dispatch with its 4-byte input and fetch.

The chain kernel is ``csrc/chain.cu`` (CUDA C++ for ``sm_90a``, its own
library, built by ``nvcc`` at first use): K4, the port of
``_vpu_chain_kernel``, and K5, the port of
``tools/microbench_vpu_bf16.py::_chain_kernel`` (f32 and bf16), are
instances of one template. :func:`vpu_chain` launches it on a CUDA tensor and
runs :func:`vpu_chain_reference` on a CPU tensor.

Unlike the JAX probe, nothing here swallows an error: a kernel that fails to
build or launch raises, and the artifact is never written with a ``None``
in its place. Reps are chained on the previous output and timed between
``torch.cuda.synchronize()`` calls.
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path

import numpy as np
import torch

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "chain.cu"

# The probe sizes (the JAX package's); the CPU tests make them small.
MATMUL_N = 8192
CHAIN_SHAPE = (512, 128)
CHAIN_ITERS = 65536
FETCH_BYTES = 8 << 20
# Operations per element and iteration in the JAX package's figure: it
# counts three multiplies, but the third (``a * 0.5``) is loop-invariant.
CHAIN_OPS_PER_STEP = 5

# b = a * CHAIN_SCALE. In bf16 the constant rounds to 1.0, so there b == a.
CHAIN_SCALE = 1.0009765625


def chain_input(shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The probes' input: ``np.random.default_rng(0).uniform(0.5, 1.0,
    shape)``, as the JAX package makes it, cast to ``dtype``."""
    x = np.random.default_rng(0).uniform(0.5, 1.0, shape)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def vpu_chain_reference(x: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain PyTorch version of the chain, with the kernel's ops in its
    order: ``b = a * 1.0009765625``, then ``iters`` times ``acc =
    max(min(acc * b, a * acc), a * 0.5)`` from ``acc = a``."""
    a = x
    b = a * CHAIN_SCALE
    half = a * 0.5
    acc = a
    for _ in range(iters):
        acc = torch.maximum(torch.minimum(acc * b, a * acc), half)
    return acc


def vpu_chain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """The chain over every element of ``x`` (float32 or bfloat16).

    On a CUDA tensor this launches the kernel (K4/K5) and raises if it
    cannot; on a CPU tensor it runs :func:`vpu_chain_reference`.
    ``vpu_chain.launches`` counts kernel launches by dtype name.
    """
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"vpu_chain takes float32 or bfloat16, got {x.dtype}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if x.device.type == "cpu":
        return vpu_chain_reference(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"no chain kernel for device {x.device}")
    return _launch(x, iters)


vpu_chain.launches = {"float32": 0, "bfloat16": 0}


def load_library():
    """Build (at first use) and load the chain library; returns the
    :class:`~minipath_tpu_torch.utils.cuda_build.CudaLibrary`."""
    from minipath_tpu_torch.utils.cuda_build import load_cuda_library

    built = load_cuda_library(_SOURCE)
    lib = built.lib
    if lib.mp_chain_f32.argtypes is None:
        vp = ctypes.c_void_p
        for fn in (lib.mp_chain_f32, lib.mp_chain_bf16x2):
            fn.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_int, vp]
            fn.restype = ctypes.c_int
        lib.mp_chain_error_string.argtypes = [ctypes.c_int]
        lib.mp_chain_error_string.restype = ctypes.c_char_p
    return built


def _launch(x: torch.Tensor, iters: int) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("vpu_chain needs a contiguous tensor")
    if iters > 2**31 - 1:
        raise ValueError(f"iters {iters} exceeds the kernel's int")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (x.numel() % 2 or x.data_ptr() % 4):
        raise ValueError("the bf16 chain takes pairs: an even element count, 4-byte aligned")
    lib = load_library().lib
    out = torch.empty_like(x)
    launch = lib.mp_chain_bf16x2 if bf16 else lib.mp_chain_f32
    n = x.numel() // 2 if bf16 else x.numel()
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), out.data_ptr(), n, int(iters), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chain kernel launch failed: cudaError {err} ({lib.mp_chain_error_string(err).decode()})")
    vpu_chain.launches["bfloat16" if bf16 else "float32"] += 1
    return out


def synchronize(device: torch.device) -> None:
    """Wait for the device's work where ``device`` is a card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_health(device="cuda", reps: int = 5) -> dict:
    """Measure the matmul, chain, fetch and round-trip rates on ``device``.

    Returns a small dict for a benchmark artifact, with the JAX package's
    keys. Raises where a probe fails, and at once where ``device`` is CUDA
    and no card is present.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_health: no CUDA device is available")
        name = f"{device}: {torch.cuda.get_device_name(device)}"
    else:
        name = str(device)
    out: dict = {"device": name}

    n = MATMUL_N
    a = torch.full((n, n), 0.001, dtype=torch.bfloat16, device=device)

    def f(m):
        return torch.tanh(m @ m)

    float(f(a).float().mean())  # warm
    synchronize(device)
    t0 = time.perf_counter()
    m = a
    for _ in range(reps):
        m = f(m)
    synchronize(device)
    dt = (time.perf_counter() - t0) / reps
    out["matmul_8k_bf16_tflops"] = round(2 * n**3 / dt / 1e12, 1)

    x = chain_input(CHAIN_SHAPE, torch.float32, device)
    vpu_chain(x, CHAIN_ITERS)  # build and warm
    synchronize(device)
    t0 = time.perf_counter()
    y = x
    for _ in range(reps):
        y = vpu_chain(y, CHAIN_ITERS)
    synchronize(device)
    dt = (time.perf_counter() - t0) / reps
    ops = CHAIN_SHAPE[0] * CHAIN_SHAPE[1] * CHAIN_ITERS * CHAIN_OPS_PER_STEP
    out["vpu_chain_gops"] = round(ops / dt / 1e9, 1)

    buf = torch.full((FETCH_BYTES,), 7, dtype=torch.uint8, device=device)
    buf[:8].to("cpu", copy=True)  # warm the fetch path
    synchronize(device)
    t0 = time.perf_counter()
    host = buf.to("cpu", copy=True)
    dt = time.perf_counter() - t0
    if int(host[0]) != 7:
        raise RuntimeError("device_health: the fetched buffer holds the wrong bytes")
    out["fetch_mb_s"] = round(FETCH_BYTES / dt / 1e6, 1)

    def g(v):
        return v + 1

    int(g(torch.tensor(0, dtype=torch.int32, device=device)))  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        int(g(torch.tensor(1, dtype=torch.int32, device=device)))
    dt = (time.perf_counter() - t0) / reps
    out["roundtrip_ms"] = round(dt * 1e3, 2)
    return out
