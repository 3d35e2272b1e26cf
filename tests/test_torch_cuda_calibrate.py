"""The chain kernels (K4, K5) against their plain PyTorch version, on the
card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package: ``python -m pytest --noconftest -q
tests/test_torch_cuda_calibrate.py``.

The chain has no addition, and multiply, min and max round once in CUDA as
in PyTorch, so the kernel and its plain version agree bit for bit in float32
and in bfloat16: no tolerance. The counts checked include small ones (1, 7,
64), because the chain reaches its fixed point ``a * 0.5`` within a few
hundred iterations.
"""

import pytest
import torch

from minipath_tpu_torch.tools import microbench_vpu_bf16 as tool
from minipath_tpu_torch.utils import calibrate

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize(
    "dtype,shape,iters",
    [(torch.float32, calibrate.CHAIN_SHAPE, n) for n in (0, 1, 7, 64, 1000)]
    + [(dt, (256, 128), n) for dt in (torch.float32, torch.bfloat16) for n in (1, 7, 64, 256)]
    + [(torch.bfloat16, (3, 130), 5)],
)
def test_chain_kernel_equals_its_plain_version(cuda, dtype, shape, iters):
    x = calibrate.chain_input(shape, dtype, cuda)
    before = calibrate.vpu_chain.launches[str(dtype).removeprefix("torch.")]
    got = calibrate.vpu_chain(x, iters)
    torch.cuda.synchronize()
    assert calibrate.vpu_chain.launches[str(dtype).removeprefix("torch.")] == before + 1
    want = calibrate.vpu_chain_reference(x, iters)
    assert got.dtype == dtype and got.shape == x.shape and got.device == x.device
    assert torch.equal(_bits(got), _bits(want))
    # ... and the plain version on the CPU gives the same bits.
    assert torch.equal(_bits(got.cpu()), _bits(calibrate.vpu_chain(x.cpu(), iters)))


def test_chained_reps_stay_bit_exact(cuda):
    """The probe feeds each call the previous output."""
    x = calibrate.chain_input((64, 128), torch.float32, cuda)
    y, z = x, x
    for _ in range(3):
        y, z = calibrate.vpu_chain(y, 33), calibrate.vpu_chain_reference(z, 33)
    assert torch.equal(_bits(y), _bits(z))


def test_chain_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = calibrate.chain_input((4, 128), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        calibrate.vpu_chain(x.t(), 3)
    with pytest.raises(ValueError, match="pairs"):
        calibrate.vpu_chain(calibrate.chain_input((3, 3), torch.bfloat16, cuda), 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        calibrate.vpu_chain(x.half(), 3)


def test_device_health_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(calibrate, "MATMUL_N", 2048)
    monkeypatch.setattr(calibrate, "CHAIN_ITERS", 4096)
    before = calibrate.vpu_chain.launches["float32"]
    out = calibrate.device_health("cuda", reps=3)
    assert calibrate.vpu_chain.launches["float32"] == before + 4  # one warm call and the reps
    assert out["device"].startswith("cuda") and torch.cuda.get_device_name(0) in out["device"]
    for key in ("matmul_8k_bf16_tflops", "vpu_chain_gops", "fetch_mb_s", "roundtrip_ms"):
        assert isinstance(out[key], float) and out[key] > 0, key


def test_tool_run_launches_reps_plus_one(cuda, capsys):
    before = dict(calibrate.vpu_chain.launches)
    tool.run(torch.bfloat16, shape=(64, 128), iters=16, reps=5)
    assert calibrate.vpu_chain.launches["bfloat16"] == before["bfloat16"] + 6
    assert capsys.readouterr().out.startswith("bfloat16")
