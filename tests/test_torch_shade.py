"""The bounce shading's CPU side: on CPU tensors the bounce loop takes the
plain PyTorch shading, and the kernel's Python side (its uniforms, its
argument struct, its checks) holds to the plain version and to
``csrc/shade.cu`` without a card. The kernel itself is held to the plain
version on the card by ``tests/test_torch_cuda_shade.py``."""

import ctypes
import re

import pytest
import torch

from minipath_tpu_torch import Camera, TriangleBvh
from minipath_tpu_torch.render import shade
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.render.frame import gen_frame_rays9
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.utils import profiling

PLAIN_PHASES = ("pt.environment_emission", "pt.bsdf_scatter", "pt.hit_emission", "pt.nee_light_sample",
                "pt.roulette_update")


@pytest.fixture(scope="module")
def atrium():
    mesh = procedural.make_atrium(0)
    ids, dicts = procedural.atrium_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24)
    scene = bvh.pt_scene("cpu")
    table = tm.material_table(dicts, "cpu")
    tracer, _ = tw.make_pt_tracer(scene, stack_size=bvh.recommended_stack_size)
    shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=bvh.recommended_stack_size)
    lights = tm.build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    return dict(scene=scene, table=table, tracer=tracer, shadow=shadow, lights=lights)


def _camera():
    return Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


def test_cpu_frame_takes_plain_shading_inside_shade_spans(atrium):
    s = atrium
    before = shade.launch.launches
    profiling.take()
    profiling.enable()
    try:
        img = tw.render_frame_pt(s["tracer"], s["scene"], s["table"], _camera().build_sampler((16, 16), "cpu"),
                                 torch.Generator().manual_seed(0), width=16, height=16, spp=2, bounces=3,
                                 samples_per_packet=2, lights=s["lights"], shadow_tracer=s["shadow"],
                                 nee_max_depth=2)
        rec = profiling.take()
    finally:
        profiling.disable()
    assert torch.isfinite(img).all()
    assert shade.launch.launches == before
    assert "pt.shade_kernel_lanes" not in rec.counters and rec.counters["pt.lanes"] == 16 * 16 * 2 * 3
    shades = {sp.id for sp in rec.spans if sp.name == "pt.shade"}
    # A bounce's shading, and the NEE light added after each of the two
    # shadow traces.
    assert len(shades) == 3 + 2
    for name in PLAIN_PHASES:
        inner = [sp for sp in rec.spans if sp.name == name]
        assert len(inner) == (2 if name == "pt.nee_light_sample" else 3), name
        assert all(sp.parent in shades for sp in inner), name
    assert all(sp.parent not in shades for sp in rec.spans if sp.name in ("pt.trace", "pt.shadow_trace"))


@pytest.mark.parametrize("bounce, shadow_rr", [(0, True), (0, False), (3, True)], ids=["nee", "nee-no-rr", "roulette"])
@pytest.mark.parametrize("mode", ["iid", "strat", "sobol"])
def test_kernel_uniforms_leave_the_generator_as_the_plain_bounce(atrium, monkeypatch, mode, bounce, shadow_rr):
    """The kernel's uniforms are the plain bounce's draws: with the launch
    stubbed, ``_shade_kernel`` leaves a generator where ``_shade_plain``
    leaves it, and hands the kernel the numbers a fresh generator gives in
    the plain order."""
    s = atrium
    W, H, S = 32, 16, 2
    rays9, _ = gen_frame_rays9(_camera().build_sampler((W, H), "cpu"), torch.Generator().manual_seed(1), width=W,
                               height=H, px_block=(16, 16), samples=S)
    B0, _, P0 = rays9.shape
    N = B0 * P0
    flat = rays9.transpose(1, 2).reshape(N, 9)
    state = tw._PathState(flat[:, 0:3], flat[:, 3:6], flat[:, 6:9], torch.ones(N, 3), torch.zeros(N, 3),
                          torch.arange(N, dtype=torch.int32), torch.ones(N, dtype=torch.bool), torch.zeros(N))
    kh = s["tracer"](s["scene"], state.origin, state.direction, state.inv_direction)
    strata = None if mode == "iid" else tw._Strata(16 if mode == "strat" else -16, 0, 5, 0, P0, P0 // S)
    kw = dict(bounce=bounce, nee_here=True, shadow_rr=shadow_rr, rr_start=3, rr_floor=0.05, strata=strata)
    seen = {}
    monkeypatch.setattr(tw, "launch_shade", lambda device, **fields: seen.update(fields))
    g_kernel, g_plain = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    tw._shade_kernel(state, kh, s["table"], tm.Environment.sky("cpu"), s["lights"], g_kernel, **kw)
    tw._shade_plain(state, kh, s["table"], tm.Environment.sky("cpu"), s["lights"], g_plain, **kw)
    assert torch.equal(g_kernel.get_state(), g_plain.get_state())

    fresh = torch.Generator().manual_seed(9)
    order = [("u_z", (N,)), ("u_phi", (N,)), ("u_lobe", (N, 2)), ("u_choice", (N,)), ("u_light", (N,)),
             ("u_tri", (N, 2)), ("u_rr", (N,)), ("u_path", (N,))]
    drawn = {"u_rr": shadow_rr, "u_path": bounce >= 3}
    for name, shape in order:
        if drawn.get(name, mode != "sobol"):
            assert torch.equal(seen[name], torch.rand(shape, generator=fresh)), name
        else:
            assert seen[name] is None, name
    if strata is None:
        assert "strat_mode" not in seen
    else:
        assert seen["strat_mode"] == (shade.STRAT_SOBOL if mode == "sobol" else shade.STRAT_JITTER)
        assert seen["salt_bsdf"] == 8 * bounce and seen["salt_nee"] == 8 * bounce + 4


_CTYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int32, "unsigned": ctypes.c_uint32, "float": ctypes.c_float}


def test_args_struct_mirrors_the_kernel_source():
    """``render/shade.py::_Args`` names the fields of ``ShadeArgs`` in
    ``csrc/shade.cu`` in its order and with its C types, so the kernel reads
    each argument where the wrapper wrote it."""
    src = shade._SOURCE.read_text()
    body = re.search(r"struct ShadeArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(const )?(\w+)(\*)? (\w+);", line)
        assert m, line
        fields.append((m.group(4), ctypes.c_void_p if m.group(3) else _CTYPES[m.group(2)]))
    assert [(n, t) for n, t in shade._Args._fields_] == fields


def test_launch_rejects_unknown_fields_and_other_devices():
    with pytest.raises(TypeError, match="no field"):
        shade.launch(torch.device("cpu"), n=1, normals=None)
    with pytest.raises(ValueError, match="is on"):
        shade.launch(torch.device("cuda", 0), t=torch.zeros(1))
