"""The camera-ray kernel's CPU side: on CPU tensors the ray generation takes
the plain chain (``sample_rays`` and ``rays_to_rays9``), and the kernel's
Python side (the packet-origin table, the row stride, the first sample, the
seed, the uniforms, the argument struct) holds to the plain chain and to
``csrc/camera.cu`` without a card. With the launch stubbed, the index rule
the kernel applies to those arguments (``camera_rays.lane_pixels``) gives
every lane the pixel, sample index and pixel id that the plain chain hands
``sample_rays``, in the tile layout and in the frame-block layout. The
kernel itself is held to the plain chain on the card by
``tests/test_torch_cuda_camera.py``."""

import ctypes
import re

import pytest
import torch

from minipath_tpu_torch import Camera
from minipath_tpu_torch.render import camera_rays, frame, integrator, shade
from minipath_tpu_torch.render.stratify import grid_factor
from minipath_tpu_torch.utils import profiling

# A frame whose 64-px tiles and 8-px blocks overhang its right and bottom
# edges.
W, H = 200, 136
TILE_ORIGINS = [[0.0, 0.0], [192.0, 64.0], [128.0, 128.0], [192.0, 128.0]]
M32 = 0xFFFFFFFF


def _sampler():
    return Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3).build_sampler(
        (W, H), "cpu")


def _plain(module, call):
    """``call()`` on the plain chain, and the pixels and strata it hands
    ``sample_rays`` (the one call it makes)."""
    seen = []
    real = module.sample_rays

    def spy(sampler, pixel_xy, generator, strat=None):
        seen.append((pixel_xy, strat))
        return real(sampler, pixel_xy, generator, strat=strat)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(module, "sample_rays", spy)
        out = call()
    assert len(seen) == 1
    return out, seen[0]


def _kernel(call):
    """``call()`` as it runs on a card, the launch stubbed: the output and
    the launch's fields."""
    fields = {}
    with pytest.MonkeyPatch.context() as m:
        for module in (frame, integrator):
            m.setattr(module, "uses_camera_kernel", lambda device: True)
        m.setattr(frame, "launch_camera", lambda device, **f: fields.update(f))
        out = call()
    return out, fields


def _assert_same_lanes(fields, pixel_xy, strat, shape):
    B, P = pixel_xy.shape[:2]
    assert shape == (B, 9, P)
    assert fields["n"] == B * P and fields["lanes"] == P and fields["rays9"].shape == (B, 9, P)
    bp, bw = fields["block_pixels"], fields["block_width"]
    x, y, s, pid = camera_rays.lane_pixels(
        fields["origin"], px_block=(bp // bw, bw), samples=P // bp, s0=fields["s0"], row_stride=fields["row_stride"],
        x_mask=fields["x_mask"], strat_seed=fields["strat_seed"] if strat is not None else 0,
    )
    assert torch.equal(x.to(torch.float32), pixel_xy[..., 0]) and torch.equal(y.to(torch.float32), pixel_xy[..., 1])
    if strat is None:
        assert "strat_mode" not in fields
        return
    s_idx, plain_pid, spp, salt = strat
    assert torch.equal(s, s_idx.expand(B, P))
    assert torch.equal(pid, plain_pid & M32)
    assert fields["salt"] == salt == frame.CAMERA_SALT
    assert fields["strat_mode"] == (shade.STRAT_SOBOL if spp < 0 else shade.STRAT_JITTER)
    gx, gy = grid_factor(abs(spp))
    assert (fields["spp"], fields["gx"]) == (abs(spp), gx)
    assert ctypes.c_float(fields["inv_gy"]).value == ctypes.c_float(1.0 / gy).value


@pytest.mark.parametrize("seed", [-1_234_567_891, 7_654_321])
@pytest.mark.parametrize("spp", [1, 7, 32, 64])
def test_tile_index_rule_matches_film_strat(spp, seed):
    """Tiles on the frame's right and bottom edges, their padded rows and
    columns included: every lane's pixel, sample index and
    ``film_strat`` pixel id, and the generator's draws."""
    sampler, origins = _sampler(), torch.tensor(TILE_ORIGINS)
    shape = dict(tile_shape=(64, 64), packet_shape=(16, 16), spp=spp)
    g_plain, g_kernel = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    want, (pixel_xy, strat) = _plain(integrator, lambda: integrator.tile_batch_rays9(
        sampler, origins, g_plain, seed, **shape))
    got, fields = _kernel(lambda: integrator.tile_batch_rays9(sampler, origins, g_kernel, seed, **shape))
    assert fields["row_stride"] == 1 << 14 and fields["x_mask"] == 0x3FFF and fields["s0"] == 0
    _assert_same_lanes(fields, pixel_xy, strat, tuple(got.shape))
    assert tuple(want.shape) == tuple(got.shape)
    assert torch.equal(g_plain.get_state(), g_kernel.get_state())


BLOCK_CASES = {
    # name: (strat_spp, strat_offset, block_ids)
    "iid": (None, 0, None),
    "strat": (16, 4, None),
    "strat-offset": (64, 32, None),
    "sobol": (-16, 8, None),
    "strat-block-ids": (16, 8, [5, 0, 77, 3, 51, 26]),
    "sobol-block-ids": (-16, 0, [77, 2, 40]),
}


@pytest.mark.parametrize("seed", [-77, 2_000_000_011])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_index_rule_matches_gen_rays9_blocks(case, seed):
    """The frame-block layout of the path tracer and ``render_frame``: the
    packets' first pixels from their block indices (or ``block_ids``), the
    row stride ``wc * bw``, the first sample ``strat_offset``."""
    strat_spp, offset, ids = BLOCK_CASES[case]
    sampler, wc = _sampler(), -(-W // 8)
    block_ids = None if ids is None else torch.tensor(ids)
    kw = dict(block_count=6 if ids is None else len(ids), wc=wc, px_block=(8, 8), samples=4, strat_spp=strat_spp,
              strat_offset=offset, strat_seed=seed, block_ids=block_ids)
    g_plain, g_kernel = torch.Generator().manual_seed(6), torch.Generator().manual_seed(6)
    want, (pixel_xy, strat) = _plain(frame, lambda: frame.gen_rays9_blocks(sampler, g_plain, 71, **kw))
    got, fields = _kernel(lambda: frame.gen_rays9_blocks(sampler, g_kernel, 71, **kw))
    assert fields["row_stride"] == wc * 8 and fields["x_mask"] == M32 and fields["s0"] == offset
    assert (fields["u_film"] is None) == (strat_spp is not None and strat_spp < 0)
    _assert_same_lanes(fields, pixel_xy, strat, tuple(got.shape))
    assert tuple(want.shape) == tuple(got.shape)
    assert torch.equal(g_plain.get_state(), g_kernel.get_state())


def test_kernel_uniforms_are_sample_rays_draws():
    """The film and the lens uniforms, in ``sample_rays``' order and shapes."""
    sampler, origins = _sampler(), torch.tensor(TILE_ORIGINS[:2])
    _, fields = _kernel(lambda: integrator.tile_batch_rays9(
        sampler, origins, torch.Generator().manual_seed(8), 3, tile_shape=(64, 64), packet_shape=(16, 16), spp=4))
    fresh = torch.Generator().manual_seed(8)
    B, _, P = fields["rays9"].shape
    assert torch.equal(fields["u_film"], torch.rand((B, P, 2), generator=fresh))
    assert torch.equal(fields["u_lens"], torch.rand((B, P, 2), generator=fresh))
    for name in ("center", "up", "right", "film_origin_offset", "pixel_scale", "lens_radius", "lens_weight"):
        assert fields[name] is getattr(sampler, name), name


def test_cpu_takes_the_plain_chain():
    """On CPU tensors no kernel launches and ``camera.kernel_lanes`` is not
    recorded; each path calls ``sample_rays`` once and returns its rays."""
    sampler, before = _sampler(), camera_rays.launch.launches
    profiling.take()
    profiling.enable()
    try:
        tile, _ = _plain(integrator, lambda: integrator.tile_batch_rays9(
            sampler, torch.tensor(TILE_ORIGINS), torch.Generator().manual_seed(1), 9, tile_shape=(64, 64),
            packet_shape=(16, 16), spp=2))
        blocks, _ = _plain(frame, lambda: frame.gen_rays9_blocks(
            sampler, torch.Generator().manual_seed(1), 0, block_count=4, wc=25, samples=2, strat_spp=2))
        rec = profiling.take()
    finally:
        profiling.disable()
    assert camera_rays.launch.launches == before
    assert "camera.kernel_lanes" not in rec.counters
    assert tile.shape == (4 * 16, 9, 2 * 256) and blocks.shape == (4, 9, 2 * 64)
    assert torch.isfinite(tile[:, :6]).all() and torch.isfinite(blocks[:, :6]).all()


_CTYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int32, "unsigned": ctypes.c_uint32, "float": ctypes.c_float}


def test_args_struct_mirrors_the_kernel_source():
    """``render/camera_rays.py::_Args`` names the fields of ``CameraArgs`` in
    ``csrc/camera.cu`` in its order and with its C types."""
    src = camera_rays._SOURCE.read_text()
    body = re.search(r"struct CameraArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(const )?(\w+)(\*)? (\w+);", line)
        assert m, line
        fields.append((m.group(4), ctypes.c_void_p if m.group(3) else _CTYPES[m.group(2)]))
    assert [(n, t) for n, t in camera_rays._Args._fields_] == fields


def test_launch_rejects_unknown_fields_and_other_devices():
    with pytest.raises(TypeError, match="no field"):
        camera_rays.launch(torch.device("cpu"), n=1, rays=None)
    with pytest.raises(ValueError, match="is on"):
        camera_rays.launch(torch.device("cuda", 0), rays9=torch.zeros(1))
