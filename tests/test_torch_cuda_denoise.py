"""The à-trous filter and the guide buffers on the card against the CPU.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package: ``python -m pytest --noconftest -q
tests/test_torch_cuda_denoise.py``.

``atrous_denoise`` is plain torch ops, the same on both devices; the card's
``exp`` and ``pow`` differ from the CPU's in the last bits, which the power
of 128 on the normal term scales up and four iterations compound: ``rtol=1e-4,
atol=1e-5`` on a ``[0, 1]`` image, the tolerance the CPU tests hold against
the JAX package. ``render_aux`` on the card goes through the kernels (K2 and
the f16 table, or K1, one launch each). Its film jitter comes from a
generator on its own device, and the card's stream is another than the
CPU's, so the two buffers are compared by share of pixels: hit masks equal
on >= 97% (silhouettes move by a pixel), coverage within 1%, unit normals
on the hits and the largest hit depth on the misses.
"""

import numpy as np
import pytest
import torch

from minipath_tpu_torch import Camera, TriangleBvh
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.render.denoise import atrous_denoise, render_aux
from minipath_tpu_torch.scene import procedural

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    xx = np.arange(w, dtype=np.float32)[None, :].repeat(h, 0)
    left = xx < w // 2
    base = np.where(left[..., None], np.float32([0.8, 0.3, 0.2]), np.float32([0.2, 0.5, 0.7]))
    rgb = np.clip(base + rng.normal(0.0, 0.08, (h, w, 3)), 0.0, 1.0).astype(np.float32)
    normal = np.where(left[..., None], np.float32([0.0, 0.0, 1.0]), np.float32([0.6, 0.0, 0.8]))
    normal = (normal + rng.normal(0.0, 0.01, (h, w, 3))).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = (3.0 + 0.05 * xx + np.where(left, 0.0, 1.5)).astype(np.float32)
    miss = rng.uniform(size=(h, w)) < 0.1
    normal[miss] = 0.0
    depth[miss] = np.inf
    variance = rng.uniform(0.0, 0.01, (h, w)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (rgb, normal, depth, variance))


@pytest.mark.parametrize("with_variance", [False, True], ids=["fixed_sigma", "variance"])
@pytest.mark.parametrize("size", [(48, 40), (270, 480)], ids=["48x40", "270x480"])
def test_atrous_denoise_on_the_card_matches_the_cpu(cuda, size, with_variance):
    rgb, normal, depth, variance = _inputs(*size, seed=3)
    var = variance if with_variance else None
    want = atrous_denoise(rgb, normal, depth, var)
    got = atrous_denoise(rgb.to(cuda), normal.to(cuda), depth.to(cuda), None if var is None else var.to(cuda))
    assert got.device.type == "cuda" and got.shape == want.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("which", ["pt_tracer", "full_tracer"])
def test_render_aux_on_the_card_matches_the_cpu(cuda, which):
    mesh = procedural.merge_meshes([procedural.make_uv_sphere(1.0, center=(0, 1.0, 0), rings=12, segments=20),
                                    procedural.make_cube(1.0, center=(1.8, 0.5, 0))])
    bvh = TriangleBvh.build(mesh)
    camera = Camera().look_at((0, 2.2, 6), (0, 1.0, 0)).f_number(32.0)

    def aux(device):
        if which == "pt_tracer":
            tracer, state = tw.make_pt_tracer(bvh.pt_scene(device), stack_size=bvh.recommended_stack_size)
        else:
            tracer, state = tw.make_full_tracer(bvh.kernel_scene(device), stack_size=bvh.recommended_stack_size)
        gen = torch.Generator(device=device).manual_seed(0)
        return render_aux(tracer, state, camera.build_sampler((96, 64), device), gen, width=96, height=64)

    k1, k2 = kernels.trace_packets.launches, kernels.trace_packets_pt.launches["closest"]
    n_card, z_card = aux(cuda)
    assert (kernels.trace_packets.launches - k1, kernels.trace_packets_pt.launches["closest"] - k2) == (
        (0, 1) if which == "pt_tracer" else (1, 0))
    n_cpu, z_cpu = aux("cpu")
    hit_card, hit_cpu = torch.any(n_card != 0, dim=-1).cpu(), torch.any(n_cpu != 0, dim=-1)
    assert (hit_card == hit_cpu).float().mean().item() >= 0.97
    assert abs(hit_card.float().mean().item() - hit_cpu.float().mean().item()) <= 0.01
    lens = n_card.cpu()[hit_card].norm(dim=-1)
    assert torch.allclose(lens, torch.ones_like(lens), atol=2e-3)
    assert bool((z_card.cpu()[~hit_card] == z_card.max().cpu()).all())
