"""The compaction's CPU side: on CPU tensors the bounce loop takes the plain
PyTorch compaction, and the kernels' Python side (the argument struct, its
checks) holds to ``csrc/compact.cu`` without a card. The kernels themselves
are held to the plain version on the card by
``tests/test_torch_cuda_compact.py``."""

import ctypes
import re

import pytest
import torch

from minipath_tpu_torch import Camera, TriangleBvh
from minipath_tpu_torch.render import compact
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.utils import profiling


def test_cpu_frame_takes_the_plain_compaction(monkeypatch):
    """On the CPU ``_compact`` is ``_compact_plain``: no launch, no
    ``pt.compaction_kernel_lanes``, the same state."""
    mesh = procedural.make_atrium(0)
    ids, dicts = procedural.atrium_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24)
    scene = bvh.pt_scene("cpu")
    tracer, _ = tw.make_pt_tracer(scene, stack_size=bvh.recommended_stack_size)
    states = []
    real = tw._compact

    def checked(state, fine_direction=True):
        out = real(state, fine_direction=fine_direction)
        states.append(fine_direction)
        want = tw._compact_plain(state, fine_direction)
        for name in tw._PathState._fields:
            got, ref = getattr(out, name), getattr(want, name)
            assert (got is None and ref is None) or torch.equal(got, ref), name
        return out

    monkeypatch.setattr(tw, "_compact", checked)
    before = compact.key_pass.launches, compact.permute_pass.launches
    profiling.take()
    profiling.enable()
    try:
        img = tw.render_frame_pt(tracer, scene, tm.material_table(dicts, "cpu"),
                                 Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).build_sampler((16, 16), "cpu"),
                                 torch.Generator().manual_seed(0), width=16, height=16, spp=2, bounces=3,
                                 samples_per_packet=2)
        rec = profiling.take()
    finally:
        profiling.disable()
    assert torch.isfinite(img).all()
    assert states == [True, False]
    assert (compact.key_pass.launches, compact.permute_pass.launches) == before
    assert "pt.compaction_kernel_lanes" not in rec.counters and rec.counters["pt.lanes"] == 16 * 16 * 2 * 3


_CTYPES = {"int64_t": ctypes.c_int64, "int": ctypes.c_int32}


def test_args_struct_mirrors_the_kernel_source():
    """``render/compact.py::_Args`` names the fields of ``CompactArgs`` in
    ``csrc/compact.cu`` in its order and with its C types, so the kernels
    read each argument where the wrapper wrote it."""
    src = compact._SOURCE.read_text()
    body = re.search(r"struct CompactArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(const )?(\w+)(\*)? (\w+);", line)
        assert m, line
        fields.append((m.group(4), ctypes.c_void_p if m.group(3) else _CTYPES[m.group(2)]))
    assert [(n, t) for n, t in compact._Args._fields_] == fields
    # Each pass's C entry point, and the two the binding reads beside them,
    # are in the source.
    for entry in (compact.key_pass, compact.permute_pass):
        assert re.search(rf"int {entry.symbol}\(const void\* args, void\* stream\)", src), entry.symbol
    for symbol in ("const char* mp_compact_error_string(int err)", "int mp_compact_args_size()"):
        assert symbol in src, symbol


def test_launch_rejects_unknown_fields_and_other_devices():
    with pytest.raises(TypeError, match="no field"):
        compact.key_pass(torch.device("cpu"), keys=None)
    with pytest.raises(ValueError, match="is on"):
        compact.permute_pass(torch.device("cuda", 0), perm=torch.zeros(1, dtype=torch.int64))
