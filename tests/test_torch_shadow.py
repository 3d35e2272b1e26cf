"""The NEE shadow batch's CPU side: on CPU tensors the bounce loop takes the
plain shadow batch, the shadow tracer's packed entry traces what its plain
entry traces, and the kernels' Python side (the argument struct, its checks,
the one copy of the sort key's device code) holds to ``csrc/shadow.cu``
without a card. The kernels themselves are held to the plain shadow batch on
the card by ``tests/test_torch_cuda_shadow.py``."""

import ctypes
import re

import pytest
import torch

from minipath_tpu_torch import Camera, TriangleBvh
from minipath_tpu_torch.render import compact, shadow
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.utils import profiling

PASSES = (shadow.box_pass, shadow.key_pass, shadow.pack_pass, shadow.resolve_pass)


@pytest.fixture(scope="module")
def atrium():
    mesh = procedural.make_atrium(0)
    ids, dicts = procedural.atrium_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24)
    scene = bvh.pt_scene("cpu")
    table = tm.material_table(dicts, "cpu")
    return dict(
        scene=scene, table=table, stack=bvh.recommended_stack_size,
        tracer=tw.make_pt_tracer(scene, stack_size=bvh.recommended_stack_size)[0],
        lights=tm.build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table),
    )


@pytest.mark.parametrize("shadow_sort", tw.SHADOW_SORTS)
def test_cpu_frame_takes_the_plain_shadow_batch(atrium, shadow_sort, monkeypatch):
    """On the CPU every shadow batch is ``_shadow_light_plain``: no launch,
    no ``pt.shadow_kernel_lanes``, ``pt.shadow_rays`` counted."""
    shadow_tracer, _ = tw.make_pt_shadow_tracer(atrium["scene"], stack_size=atrium["stack"])
    calls, real = [], tw._shadow_light_plain

    def plain(*args):
        calls.append(args[-1])
        return real(*args)

    def kernel(*args):
        raise AssertionError("the kernel route on the CPU")

    monkeypatch.setattr(tw, "_shadow_light_plain", plain)
    monkeypatch.setattr(tw, "_shadow_light_kernel", kernel)
    before = [p.launches for p in PASSES]
    profiling.take()
    profiling.enable()
    try:
        img = tw.render_frame_pt(atrium["tracer"], atrium["scene"], atrium["table"],
                                 Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).build_sampler((16, 16), "cpu"),
                                 torch.Generator().manual_seed(0), width=16, height=16, spp=2, bounces=3,
                                 samples_per_packet=2, lights=atrium["lights"], shadow_tracer=shadow_tracer,
                                 shadow_sort=shadow_sort)
        rec = profiling.take()
    finally:
        profiling.disable()
    assert torch.isfinite(img).all()
    assert calls == [shadow_sort] * 3
    assert [p.launches for p in PASSES] == before
    assert "pt.shadow_kernel_lanes" not in rec.counters and rec.counters["pt.shadow_rays"] > 0


@pytest.mark.parametrize("packet_size", [256, 2048])
def test_the_packed_entry_traces_what_the_plain_entry_traces(atrium, packet_size):
    """``shadow.packed`` over ``_pack_rays9``'s rows of a shadow batch gives
    the answers ``shadow`` gives for the same segments, padded to whole
    packets; the portable tracer has no packed entry."""
    shadow_tracer, _ = tw.make_pt_shadow_tracer(atrium["scene"], stack_size=atrium["stack"],
                                                packet_size=packet_size)
    assert shadow_tracer.packet_size == packet_size
    g = torch.Generator().manual_seed(packet_size)
    n = 3 * packet_size + 17
    origin = torch.rand((n, 3), generator=g) * torch.tensor([30.0, 10.0, 12.0]) - torch.tensor([15.0, 0.0, 6.0])
    segment = torch.rand((n, 3), generator=g) * 8.0 - 4.0
    segment[::5, 0] = 0.0
    cand = torch.rand(n, generator=g) < 0.5
    wi = segment / segment.norm(dim=-1, keepdim=True)
    o_s, s_s, n_cand, _ = tw._shadow_batch(cand, origin, segment, wi)
    want = shadow_tracer(atrium["scene"], o_s, s_s, n_cand)
    inv = torch.where(s_s == 0.0, torch.full_like(s_s, torch.inf), 1.0 / s_s)
    r9, live_packets, Np = tw._pack_rays9(packet_size, n_cand, o_s, s_s, inv)
    tri = shadow_tracer.packed(atrium["scene"], r9, live_packets)
    assert tri.dtype == torch.int32 and tri.shape == (Np,)
    assert torch.equal(tri[:n] >= 0, want) and 0 < int(want.sum()) < int(n_cand)
    assert not (tri[int(n_cand):] >= 0).any()  # parked and dead lanes find nothing
    portable, _ = tw.make_portable_shadow_tracer(None, stack_size=atrium["stack"])
    assert getattr(portable, "packed", None) is None


_CTYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int32}


def test_args_struct_mirrors_the_kernel_source():
    """``render/shadow.py::_Args`` names the fields of ``ShadowArgs`` in
    ``csrc/shadow.cu`` in its order and with its C types, so the kernels
    read each argument where the wrapper wrote it."""
    src = shadow._SOURCE.read_text()
    body = re.search(r"struct ShadowArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(const )?(\w+)(\*)? (\w+);", line)
        assert m, line
        fields.append((m.group(4), ctypes.c_void_p if m.group(3) else _CTYPES[m.group(2)]))
    assert [(n, t) for n, t in shadow._Args._fields_] == fields
    for entry in PASSES:
        assert re.search(rf"int {entry.symbol}\(const void\* args, void\* stream\)", src), entry.symbol
    for symbol in ("const char* mp_shadow_error_string(int err)", "int mp_shadow_args_size()"):
        assert symbol in src, symbol


def test_the_sort_key_device_code_has_one_copy():
    """The cell, Morton and direction-bin device code lives in
    ``csrc/sort_key.cuh``, which both key passes include; neither source
    defines it again."""
    header = (shadow._SOURCE.parent / "sort_key.cuh").read_text()
    for name in ("morton_cell", "direction_bin", "clamp_min"):
        assert re.search(rf"__device__ __forceinline__ \w+ {name}\(", header), name
    for source in (shadow._SOURCE, compact._SOURCE):
        src = source.read_text()
        assert '#include "sort_key.cuh"' in src, source.name
        assert not re.search(r"\b(morton_cell|direction_bin|clamp_min)\([^;]*\)\s*\{", src), source.name


def test_launch_rejects_unknown_fields_and_other_devices():
    with pytest.raises(TypeError, match="no field"):
        shadow.key_pass(torch.device("cpu"), keys=None)
    with pytest.raises(ValueError, match="is on"):
        shadow.pack_pass(torch.device("cuda", 0), order=torch.zeros(1, dtype=torch.int64))
