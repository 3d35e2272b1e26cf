"""The path tracer over the 16-bit quantized layout on the port's normal
path, on the CPU.

A tree built with ``layout="q16"`` gives ``pt_scene`` a ``QPTScene``: K3's
plain version traces the bounces and the NEE segments. At a small size the
port's ``render_frame_pt`` (5 bounces, NEE at the first vertex, the sky)
over that scene agrees with the benchmark's BSDF-only reference
(``benchmark/reference/pathtrace.py``, over the mesh itself) under the
``pt-q16-600k-1080p64-nee1`` cell's own comparison and limits, and each
fault the cell must catch fails them. The quantized scene holds no f32
copy of the tree on its device, its shading table is bit for bit the one
built from the f32 arrays, and the table's build is a span of its own.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.drivers import common, pt_frame  # noqa: E402
from benchmark.reference import atrium, bvh, pathtrace, trace  # noqa: E402
from minipath_tpu_torch import cli  # noqa: E402
from minipath_tpu_torch.render import kernels, kernels_q  # noqa: E402
from minipath_tpu_torch.render import wavefront as W  # noqa: E402
from minipath_tpu_torch.scene import procedural, triangle_bvh  # noqa: E402
from minipath_tpu_torch.scene.materials import Environment, build_light_table, material_table  # noqa: E402
from minipath_tpu_torch.scene.obj_loader import MeshData  # noqa: E402
from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh  # noqa: E402
from minipath_tpu_torch.utils import profiling  # noqa: E402
from test_torch_tworooms import _a_tenth_brighter, _half_the_wavefront  # noqa: E402

CELL = json.loads((REPO / "benchmark" / "workloads" / "pt-q16-600k-1080p64-nee1.json").read_text())
TRIANGLES, BOUNCES, NEE_DEPTH = 3_000, CELL["bounces"], CELL["nee_depth"]
SIZE, BLOCK = (32, 16), 8
FRAMES, SPP, REFERENCE_PATHS = 6, 16, 256
CAMERA = {"eye": [-16.0, 4.0, 0.0], "target": [10.0, 3.0, 0.5], "f_number": 8.0, "sensor_width": 0.036}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs a worker a core or more, and the
    plain traversal's many small operations gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mesh():
    return atrium.make_atrium(TRIANGLES)


def _tree(mesh, layout="q16") -> TriangleBvh:
    data = MeshData(triangles=mesh.triangles, positions=mesh.positions, normals=mesh.normals,
                    texcoords=mesh.texcoords)
    return TriangleBvh.build(data, materials=atrium.atrium_materials(mesh), layout=layout)


@pytest.fixture(scope="module")
def small(mesh):
    """The small atrium's program state over its ``QPTScene`` and the
    reference's sums at every pixel of the checked blocks."""
    ids = atrium.atrium_materials(mesh)
    tree = _tree(mesh)
    pts = tree.pt_scene("cpu")
    assert isinstance(pts, kernels_q.QPTScene)
    table = material_table(pt_frame.port_materials(), "cpu")
    tracer, _ = W.make_pt_tracer(pts, stack_size=tree.recommended_stack_size)
    shadow, _ = W.make_pt_shadow_tracer(pts, stack_size=tree.recommended_stack_size)
    lights = build_light_table(tree.host_arrays.tri_packets, tree.host_arrays.tri_material, table)
    config = {"camera": CAMERA}
    sampler = common.port_camera(config).build_sampler(SIZE, "cpu")
    pixels = pt_frame.check_blocks(25, *SIZE, (SIZE[0] // BLOCK) * (SIZE[1] // BLOCK), BLOCK)
    ref = trace.prepare(bvh.build_tree(mesh.positions, mesh.triangles), mesh.positions, mesh.triangles, "cpu")
    vnorm = pathtrace.unit_shading_normals(trace.shading_normals(mesh.positions, mesh.normals, mesh.triangles, "cpu"))
    total, squares = pathtrace.estimate_pixels(
        ref, vnorm, torch.from_numpy(ids).long(), pathtrace.material_table("cpu"), common.lens(config), SIZE, pixels,
        REFERENCE_PATHS, BOUNCES, 31)
    return dict(tracer=tracer, shadow=shadow, scene=pts, table=table, lights=lights, sampler=sampler, pixels=pixels,
                total=total.numpy(), squares=squares.numpy())


def _frames(s) -> np.ndarray:
    """``(FRAMES, n, 3)`` values of the checked pixels, one seed a frame,
    rendered as the cell renders them."""
    out = []
    for k in range(FRAMES):
        img = W.render_frame_pt(
            s["tracer"], s["scene"], s["table"], s["sampler"], torch.Generator().manual_seed(2500 + k),
            width=SIZE[0], height=SIZE[1], spp=SPP, bounces=BOUNCES, env=Environment.sky("cpu"),
            samples_per_packet=8, lights=s["lights"], shadow_tracer=s["shadow"], nee_max_depth=NEE_DEPTH,
        )
        out.append(img.numpy()[s["pixels"][:, 1], s["pixels"][:, 0], :3])
    return np.stack(out).astype(np.float64)


def _unchanged(monkeypatch):
    """Each bounce leaves the paths as they were: no radiance is gathered."""
    monkeypatch.setattr(W, "_pt_trace", lambda *a, samples, **kw: torch.zeros(
        (a[3].shape[0], a[3].shape[2] // samples, 3), dtype=torch.float32, device=a[3].device))


@pytest.mark.parametrize("fault", [None, _unchanged, _a_tenth_brighter, _half_the_wavefront],
                         ids=["sound", "unchanged", "brighter", "half_wavefront"])
def test_the_port_agrees_with_the_reference(small, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    got = pt_frame.compare(_frames(small), small["total"], small["squares"], REFERENCE_PATHS, BLOCK * BLOCK, CELL)
    failed = [name for name, (value, limit) in got.items() if value > limit]
    assert (not failed) == (fault is None), got


def test_the_frame_traces_k3_in_both_lean_modes(small, monkeypatch):
    """The frame's traces go to K3's lean closest-hit and any-hit (its plain
    version on the CPU), never to K2's."""
    modes = []
    real_q = kernels_q.trace_packets_q

    def q(*a, lean=False, anyhit=False, **kw):
        modes.append((lean, anyhit))
        return real_q(*a, lean=lean, anyhit=anyhit, **kw)

    monkeypatch.setattr(W, "trace_packets_q", q)
    monkeypatch.setattr(W, "trace_packets_pt", lambda *a, **kw: pytest.fail("K2 traced a QPTScene"))
    W.render_frame_pt(small["tracer"], small["scene"], small["table"], small["sampler"],
                      torch.Generator().manual_seed(3), width=SIZE[0], height=SIZE[1], spp=8, bounces=BOUNCES,
                      env=Environment.sky("cpu"), samples_per_packet=8, lights=small["lights"], shadow_tracer=small["shadow"],
                      nee_max_depth=NEE_DEPTH)
    assert modes.count((True, False)) == BOUNCES and modes.count((True, True)) == NEE_DEPTH
    assert set(modes) == {(True, False), (True, True)}


# ---- the layout: no f32 copy on the device, the same shading table ----------


@pytest.mark.parametrize("entry", ["pt_scene", "quantized_pt_scene"])
def test_a_q16_pt_scene_uploads_no_f32_arrays(mesh, entry):
    tree = _tree(mesh)
    scene = getattr(tree, entry)("cpu")
    assert isinstance(scene, kernels_q.QPTScene)
    assert tree._device_arrays == {}


def test_auto_over_the_budget_takes_q16_without_the_f32_arrays(mesh, monkeypatch):
    """Under ``auto`` with the f32 layout over the budget, ``pt_scene``
    decides before anything reaches the device: a ``QPTScene``, and no f32
    arrays uploaded."""
    tree = _tree(mesh, layout="auto")
    monkeypatch.setattr(triangle_bvh, "SCENE_BUDGET_BYTES", tree.f32_scene_bytes(pt=True) - 1)
    assert isinstance(tree.pt_scene("cpu"), kernels_q.QPTScene)
    assert tree._device_arrays == {}


def test_the_material_check_runs_on_the_host(mesh):
    """Material ids past the f16 table's range raise before the layout is
    chosen, and with nothing on the device."""
    ids = atrium.atrium_materials(mesh).copy()
    ids[7] = kernels.MAX_MATERIAL_ID
    data = MeshData(triangles=mesh.triangles, positions=mesh.positions, normals=mesh.normals,
                    texcoords=mesh.texcoords)
    for layout in triangle_bvh.LAYOUTS:
        tree = TriangleBvh.build(data, materials=ids, layout=layout)
        with pytest.raises(ValueError, match="material ids"):
            tree.pt_scene("cpu")
        assert tree._device_arrays == {} and tree._quantized_scenes == {}


@pytest.mark.parametrize("layout", triangle_bvh.LAYOUTS)
def test_the_shading_table_is_the_f32_arrays_table(mesh, layout):
    """Bit for bit the table that ``build_shade_flat`` makes from the whole
    f32 ``BvhArrays`` on the device (the route that kept them there)."""
    tree = _tree(mesh, layout)
    want = kernels.build_shade_flat(tree.build_result.as_device("cpu"))
    got = tree.quantized_pt_scene("cpu").shade_flat
    assert got.dtype == want.dtype == torch.float16 and got.shape == want.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(tree.pt_scene("cpu").shade_flat.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("layout", triangle_bvh.LAYOUTS)
def test_the_shade_table_span_and_counter(mesh, layout, on):
    """While the recorder is on, the shading table's build is the span
    ``scene.shade_table`` and its bytes the counter ``scene.shade_bytes``,
    in either layout; off, neither is recorded."""
    tree = _tree(mesh, layout)
    profiling.take()
    try:
        if on:
            profiling.enable()
        scene = tree.pt_scene("cpu")
    finally:
        profiling.disable()
        rec = profiling.take()
    names = [s.name for s in rec.spans]
    if not on:
        assert not names and not rec.counters
        return
    assert names.count("scene.shade_table") == 1
    assert rec.counters["scene.shade_bytes"] == scene.shade_flat.nbytes == tree.host_arrays.tri_material.size * 40
    assert ("scene.q16_bytes" in rec.counters) == (layout == "q16")


def test_the_cli_trace_holds_the_shade_table(tmp_path, monkeypatch):
    """``--layout q16 --integrator pt --nee --trace-out`` writes
    ``scene.shade_table`` and ``scene.shade_bytes`` beside the quantized
    layout's span and bytes."""
    if shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable (no g++)")
    monkeypatch.setattr(procedural, "make_atrium", lambda real=procedural.make_atrium: real(TRIANGLES))
    out = tmp_path / "trace.json"
    assert cli.main(["--scene", "atrium", "--layout", "q16", "--integrator", "pt", "--nee", "--nee-depth", "1",
                     "--bounces", "5", "--width", "16", "--height", "16", "--spp", "2", "--device", "cpu",
                     "--no-stats", "-q", "-o", str(tmp_path / "f.png"), "--trace-out", str(out)]) == 0
    events = json.loads(out.read_text())["traceEvents"]
    spans = {e["name"] for e in events if e["ph"] == "X"}
    counters = {e["name"]: e["args"][e["name"]] for e in events if e["ph"] == "C"}
    assert {"scene.shade_table", "scene.quantize"} <= spans
    assert counters["scene.shade_bytes"] > 0 and counters["scene.q16_bytes"] > 0
