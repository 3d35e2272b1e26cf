"""The two-rooms scene on the port's normal path, on the CPU.

The benchmark's frozen copy of the scene (``benchmark/reference/
tworooms.py``) is the port's ``make_tworooms`` and ``tworooms_materials``
bit for bit; at a small size the port's ``render_frame_pt`` (7 bounces, NEE
at every vertex, no environment) agrees with the benchmark's light-sampling
reference (``benchmark/reference/pathtrace_nee.py``) under the
``pt-tworooms-1080p64`` cell's own comparison and limits, and each fault
the cell must catch fails them; the shadow batch's span and counter are
recorded; ``cli.main --scene tworooms`` writes a lit image.

The small frame looks through the doorway from 4 m (the cell's camera, 10 m
back, sees mostly the dark room, whose pixels need far more samples than a
test can take); its checked blocks are the whole frame's.
"""

from __future__ import annotations

import argparse
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

from benchmark.drivers import common, pt_frame, pt_frame_tworooms  # noqa: E402
from benchmark.reference import bvh, pathtrace, pathtrace_nee, trace, tworooms  # noqa: E402
from minipath_tpu_torch import cli  # noqa: E402
from minipath_tpu_torch.render import wavefront as W  # noqa: E402
from minipath_tpu_torch.scene import procedural  # noqa: E402
from minipath_tpu_torch.scene.bvh import native  # noqa: E402
from minipath_tpu_torch.scene.materials import Environment, build_light_table, material_table  # noqa: E402
from minipath_tpu_torch.utils import profiling  # noqa: E402

CELL = json.loads((REPO / "benchmark" / "workloads" / "pt-tworooms-1080p64.json").read_text())
TRIANGLES, BOUNCES = 2_000, 7
SIZE, BLOCK = (32, 16), 8
FRAMES, SPP, REFERENCE_PATHS = 8, 24, 320
CAMERA = {"eye": [-4.0, 2.0, 0.0], "target": [0.0, 1.5, 0.0], "f_number": 8.0, "sensor_width": 0.036}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs a worker a core or more, and the
    plain traversal's many small operations gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("target", [0, 2_000, 150_000])
def test_the_frozen_scene_is_the_ports(target):
    mesh, want = tworooms.make_tworooms(target), procedural.make_tworooms(target)
    for field in ("triangles", "positions", "normals", "texcoords"):
        got, exp = getattr(mesh, field), getattr(want, field)
        assert got.dtype == exp.dtype and np.array_equal(got, exp), field
    ids = tworooms.tworooms_materials(mesh)
    want_ids, dicts = procedural.tworooms_materials(want)
    assert ids.dtype == want_ids.dtype and np.array_equal(ids, want_ids)
    assert (ids == 3).sum() == 2  # the panel's two triangles
    table = material_table(dicts, "cpu")
    frozen = material_table(pt_frame_tworooms.port_materials(), "cpu")
    for field in table._fields:
        assert torch.equal(getattr(table, field), getattr(frozen, field)), field


@pytest.fixture(scope="module")
def small():
    """The small scene's program state and the reference's sums at every
    pixel of the checked blocks."""
    torch.manual_seed(0)
    mesh = tworooms.make_tworooms(TRIANGLES)
    ids = tworooms.tworooms_materials(mesh)
    from benchmark.harness import scene

    tree = scene.port_bvh(mesh, ids)
    table = material_table(pt_frame_tworooms.port_materials(), "cpu")
    pts = tree.pt_scene("cpu")
    tracer, _ = W.make_pt_tracer(pts, stack_size=tree.recommended_stack_size)
    shadow, _ = W.make_pt_shadow_tracer(pts, stack_size=tree.recommended_stack_size)
    lights = build_light_table(tree.host_arrays.tri_packets, tree.host_arrays.tri_material, table)
    config = {"camera": CAMERA}
    sampler = common.port_camera(config).build_sampler(SIZE, "cpu")
    pixels = pt_frame_tworooms.check_blocks(23, *SIZE, (SIZE[0] // BLOCK) * (SIZE[1] // BLOCK), BLOCK)
    ref = trace.prepare(bvh.build_tree(mesh.positions, mesh.triangles), mesh.positions, mesh.triangles, "cpu")
    vnorm = pathtrace.unit_shading_normals(trace.shading_normals(mesh.positions, mesh.normals, mesh.triangles, "cpu"))
    total, squares = pathtrace_nee.estimate_pixels(
        ref, vnorm, torch.from_numpy(ids).long(), pathtrace_nee.material_table(tworooms.MATERIALS, "cpu"),
        pathtrace_nee.light_table(mesh.positions, mesh.triangles, ids, tworooms.MATERIALS, "cpu"),
        common.lens(config), SIZE, pixels, REFERENCE_PATHS, BOUNCES, 29)
    return dict(tracer=tracer, shadow=shadow, scene=pts, table=table, lights=lights, sampler=sampler, pixels=pixels,
                total=total.numpy(), squares=squares.numpy())


def _frames(s) -> np.ndarray:
    """``(FRAMES, n, 3)`` values of the checked pixels, one seed a frame,
    rendered as the cell renders them."""
    out = []
    for k in range(FRAMES):
        img = W.render_frame_pt(
            s["tracer"], s["scene"], s["table"], s["sampler"], torch.Generator().manual_seed(1000 + k),
            width=SIZE[0], height=SIZE[1], spp=SPP, bounces=BOUNCES, env=Environment.none("cpu"),
            samples_per_packet=8, lights=s["lights"], shadow_tracer=s["shadow"], nee_max_depth=None,
        )
        out.append(img.numpy()[s["pixels"][:, 1], s["pixels"][:, 0], :3])
    return np.stack(out).astype(np.float64)


def _nee_dropped_past_the_first_vertex(monkeypatch):
    """No light sample past the first vertex, with nothing reweighted: the
    emitter hits keep the MIS weight that assumed one."""
    real = W._shade_plain

    def dropped(*args, bounce, **kw):
        state, query = real(*args, bounce=bounce, **kw)
        if query is not None and bounce >= 1:
            query = query._replace(cand=torch.zeros_like(query.cand))
        return state, query

    monkeypatch.setattr(W, "_shade_plain", dropped)


def _a_tenth_brighter(monkeypatch):
    real = W._pt_trace
    monkeypatch.setattr(W, "_pt_trace", lambda *a, **kw: real(*a, **kw) * 1.1)


def _half_the_wavefront(monkeypatch):
    """Every other packet of each chunk's wavefront never traced, left black."""
    real = W._pt_trace

    def half(*a, **kw):
        out = real(*a, **kw)
        out[1::2] = 0.0
        return out

    monkeypatch.setattr(W, "_pt_trace", half)


@pytest.mark.parametrize("fault", [None, _nee_dropped_past_the_first_vertex, _a_tenth_brighter, _half_the_wavefront],
                         ids=["sound", "nee_dropped", "brighter", "half_wavefront"])
def test_the_port_agrees_with_the_light_sampling_reference(small, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    got = pt_frame.compare(_frames(small), small["total"], small["squares"], REFERENCE_PATHS, BLOCK * BLOCK, CELL)
    failed = [name for name, (value, limit) in got.items() if value > limit]
    assert (not failed) == (fault is None), got


@pytest.mark.parametrize("shadow_sort", W.SHADOW_SORTS)
@pytest.mark.parametrize("shards", [1, 2])
def test_the_shadow_batch_is_recorded(small, shadow_sort, shards):
    """``pt.shadow_batch`` twice a NEE bounce of each shard (the
    batch before the any-hit trace and the scatter after it), inside
    ``pt.shadow_trace``; ``pt.shadow_occluded`` no more than
    ``pt.shadow_rays``; nothing recorded with tracing off."""
    kw = dict(width=SIZE[0], height=SIZE[1], spp=8, bounces=BOUNCES, env=Environment.none("cpu"),
              samples_per_packet=8, lights=small["lights"], shadow_tracer=small["shadow"], nee_max_depth=None,
              shadow_sort=shadow_sort, mesh=None if shards == 1 else ("cpu",) * shards)
    args = (small["tracer"], small["scene"], small["table"], small["sampler"])
    profiling.take()
    W.render_frame_pt(*args, torch.Generator().manual_seed(5), **kw)
    assert not profiling.take().spans
    profiling.enable()
    try:
        W.render_frame_pt(*args, torch.Generator().manual_seed(5), **kw)
    finally:
        profiling.disable()
    rec = profiling.take()
    batches = [s for s in rec.spans if s.name == "pt.shadow_batch"]
    outer = {s.id: s for s in rec.spans if s.name == "pt.shadow_trace"}
    assert len(batches) == 2 * BOUNCES * shards and len(outer) == BOUNCES * shards
    assert all(s.parent in outer for s in batches)
    rays, blocked = rec.counters["pt.shadow_rays"], rec.counters["pt.shadow_occluded"]
    assert 0 < blocked < rays


def test_cli_renders_the_two_rooms(tmp_path, monkeypatch):
    """``--scene tworooms --integrator pt --nee`` with the cell's camera
    builds the scene natively with its materials and writes a lit image."""
    if shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable (no g++)")
    make = procedural.make_tworooms
    monkeypatch.setattr(procedural, "make_tworooms", lambda: make(TRIANGLES))
    out = tmp_path / "tworooms.png"
    rc = cli.main(["--scene", "tworooms", "--integrator", "pt", "--nee", "--bounces", "7", "--camera-from", "-10", "3",
                   "0", "--camera-to", "0", "1.5", "0", "--f-number", "8", "--width", "32", "--height", "18",
                   "--spp", "8", "--device", "cpu", "--no-stats", "-q", "-o", str(out)])
    assert rc == 0
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (18, 32, 4) and (img[..., 3] == 255).all() and img[..., :3].max() > 0
    tree, dicts = cli.load_scene(argparse.Namespace(scene="tworooms", obj=None, integrator="pt", layout="auto"))
    mesh = make(TRIANGLES)
    ids, want_dicts = procedural.tworooms_materials(mesh)
    assert dicts == want_dicts
    want = native.build_bvh_native(mesh, materials=ids)
    for f in want.arrays._fields:
        assert np.array_equal(np.asarray(getattr(tree.host_arrays, f)), np.asarray(getattr(want.arrays, f))), f
