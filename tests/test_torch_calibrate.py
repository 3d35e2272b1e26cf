"""The port's device-health probe and chain kernels (K4, K5) against the JAX
package, on the CPU.

The chain has no addition, and IEEE multiply, min and max round once, so the
plain PyTorch chain and the Pallas kernels in interpret mode agree bit for
bit: no tolerance, in float32 and in bfloat16. The chain converges to
``a * 0.5`` within a few hundred iterations, so the counts checked are small
(1, 7 and 64), where a wrong kernel cannot hide behind the fixed point.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from minipath_tpu.utils import calibrate as jax_calibrate
from minipath_tpu_torch.tools import microbench_vpu_bf16 as tool
from minipath_tpu_torch.utils import calibrate

REPO = Path(__file__).resolve().parent.parent
ITERS = (1, 7, 64)
HEALTH_KEYS = ("device", "matmul_8k_bf16_tflops", "vpu_chain_gops", "fetch_mb_s", "roundtrip_ms")
DTYPES = {"float32": (jnp.float32, torch.float32, np.uint32), "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16)}


@functools.lru_cache(maxsize=None)
def _jax_tool():
    """``tools/microbench_vpu_bf16.py``, loaded by path (``tools/`` is no
    package)."""
    spec = importlib.util.spec_from_file_location("jax_microbench_vpu_bf16", REPO / "tools" / "microbench_vpu_bf16.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bits(a) -> np.ndarray:
    """The raw bits of a float32 or bfloat16 array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int32 if a.dtype == torch.float32 else torch.int16).numpy().view(
            np.uint32 if a.dtype == torch.float32 else np.uint16)
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint16)


def _pair(shape, dtype):
    """The same input in JAX and in torch, bit for bit."""
    jdt, tdt, ubits = DTYPES[dtype]
    xj = jnp.asarray(np.random.default_rng(0).uniform(0.5, 1.0, shape), jdt)
    raw = _bits(xj).copy()
    xt = torch.from_numpy(raw.view(np.int32 if ubits is np.uint32 else np.int16)).view(tdt)
    return xj, xt


def _pallas(kernel, x, iters):
    return pl.pallas_call(
        functools.partial(kernel, iters=iters),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True,
    )(x)


@pytest.mark.parametrize("iters", ITERS)
def test_plain_chain_equals_the_device_health_kernel(iters):
    """K4's plain version against ``calibrate._vpu_chain_kernel`` at the
    probe's (512, 128), bit for bit."""
    xj, xt = _pair(calibrate.CHAIN_SHAPE, "float32")
    want = _pallas(jax_calibrate._vpu_chain_kernel, xj, iters)
    got = calibrate.vpu_chain(xt, iters)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_chain_equals_the_bf16_tool_kernel(dtype, iters):
    """K5's plain version against the tool's unrolled ``_chain_kernel`` at
    its (256, 128), in both types, bit for bit."""
    xj, xt = _pair((256, 128), dtype)
    want = _pallas(_jax_tool()._chain_kernel, xj, iters)
    got = calibrate.vpu_chain(xt, iters)
    assert got.dtype == xt.dtype
    assert np.array_equal(_bits(got), _bits(want))


def test_bf16_scale_rounds_to_one():
    """``1.0009765625`` is not a bf16 number: in bf16 ``b == a`` bit for bit,
    in JAX and in torch alike (the JAX tool's comment says otherwise)."""
    xj, xt = _pair((256, 128), "bfloat16")
    assert np.array_equal(_bits(xj * 1.0009765625), _bits(xj))
    assert np.array_equal(_bits(xt * calibrate.CHAIN_SCALE), _bits(xt))
    assert float(torch.tensor(calibrate.CHAIN_SCALE, dtype=torch.bfloat16)) == 1.0
    xj32, xt32 = _pair((256, 128), "float32")
    assert not np.array_equal(_bits(xt32 * calibrate.CHAIN_SCALE), _bits(xt32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chain_input_is_the_jax_input(dtype):
    xj, _ = _pair((64, 128), dtype)
    got = calibrate.chain_input((64, 128), DTYPES[dtype][1])
    assert np.array_equal(_bits(got), _bits(xj))


def test_chain_wrapper_checks_its_input():
    x = calibrate.chain_input((4, 128))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        calibrate.vpu_chain(x.to(torch.float16), 3)
    with pytest.raises(ValueError, match="iters"):
        calibrate.vpu_chain(x, -1)
    before = dict(calibrate.vpu_chain.launches)
    assert torch.equal(calibrate.vpu_chain(x, 0), x)
    assert calibrate.vpu_chain.launches == before  # the CPU path launches nothing


@pytest.fixture
def small_probe(monkeypatch):
    monkeypatch.setattr(calibrate, "MATMUL_N", 64)
    monkeypatch.setattr(calibrate, "CHAIN_SHAPE", (8, 128))
    monkeypatch.setattr(calibrate, "CHAIN_ITERS", 16)
    monkeypatch.setattr(calibrate, "FETCH_BYTES", 1 << 16)


def test_device_health_has_the_jax_keys(small_probe):
    """On the CPU, with the probe sizes made small: the JAX package's keys,
    each with a positive finite number, and no key for an error."""
    source = (REPO / "minipath_tpu" / "utils" / "calibrate.py").read_text()
    for key in HEALTH_KEYS:
        assert f'out["{key}"]' in source or f'"{key}": str(dev)' in source, key
    out = calibrate.device_health(device="cpu", reps=2)
    assert tuple(out) == HEALTH_KEYS
    assert out["device"] == "cpu"
    for key in HEALTH_KEYS[1:]:
        assert isinstance(out[key], float) and np.isfinite(out[key]) and out[key] >= 0, (key, out[key])


def test_device_health_needs_the_card_it_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.device_health(device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tool_run_prints_its_rate(dtype, capsys):
    dt = tool.run(dtype, shape=(4, 128), iters=3, reps=2, device="cpu")
    line = capsys.readouterr().out.strip()
    assert dt > 0
    assert line.startswith(str(dtype).removeprefix("torch."))
    assert line.endswith("Gop/s") and "us/call" in line


def test_tool_main(monkeypatch, capsys):
    monkeypatch.setattr(tool, "run", functools.partial(tool.run, shape=(2, 128), iters=2, reps=2))
    assert tool.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "devices: [cpu]"
    assert lines[1].startswith("float32") and lines[2].startswith("bfloat16")
    assert lines[3].startswith("bf16 speedup over f32:")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 2
