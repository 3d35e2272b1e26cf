"""The port's spans and counters (``utils/profiling.py``) on the CPU.

Tracing is on while a torch profiler records, on every thread, or after
``enable()``; off, nothing is recorded and no ``record_function`` is
entered. ``render()`` records its caller's spans (``render.start``,
``render.wait``, ``render.image``) and its render thread's (``render.frame``
and, below it, each dispatch's phases and the tile integrator's), one
request id for all; ``render_frame_pt`` counts the lanes, live lanes and
shadow rays of its bounce loop. The caller's spans also appear as ranges in
the profiler's trace, and one offset puts the program's clock on the
trace's.
"""

import inspect
import json
import statistics
import threading

import numpy as np
import pytest
import torch

from minipath_tpu_torch import Camera, RenderSettings, Scene, TriangleBvh, render
from minipath_tpu_torch import cli
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.primitives import Sphere
from minipath_tpu_torch.utils import profiling

CAMERA = Camera().look_at((0, 2, 10), (0, 1.5, 0)).f_number(4.8).focus_distance(10)
CALLER_SPANS = ("render.start", "render.wait", "render.image")


@pytest.fixture
def record():
    """A clean recorder before the test, and whatever it left taken after."""
    profiling.take()
    yield
    profiling.disable()
    profiling.take()


@pytest.fixture
def counted_ranges(monkeypatch):
    """Counts every ``torch.profiler.record_function`` entered."""
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        calls.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return calls


def _scene(kind):
    if kind == "sphere":
        return Scene(Sphere())
    return Scene(TriangleBvh.build(procedural.make_uv_sphere(1.0, rings=8, segments=16)))


def _tile_render(kind, resolution=(48, 32)):
    settings = RenderSettings(tile_size=16, sample_count=4, resolution=resolution)
    p = render(_scene(kind), CAMERA, settings, finished_tile_callback=lambda tile, snap: None, device="cpu", seed=1)
    p.wait()
    return p, p.image()


def test_a_span_on_another_thread_keeps_its_parent_and_request(record, counted_ranges):
    """Under a profiler, a span opened on a second thread is recorded (the
    profiler's flag is process-wide) with the parent and request it names,
    and its children inherit them; each also entered ``record_function``."""
    with torch.profiler.profile():
        request = profiling.new_request()
        with profiling.span("outer", request=request):
            parent = profiling.current()

            def work():
                with profiling.span("thread.root", request=request, parent=parent):
                    with profiling.span("thread.child"):
                        profiling.count("thread.items", 3)
                        profiling.count("thread.items", torch.tensor(4, dtype=torch.int32))

            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    rec = profiling.take()
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"outer", "thread.root", "thread.child"}
    assert by["thread.root"].parent == by["outer"].id and by["thread.child"].parent == by["thread.root"].id
    assert by["outer"].request == by["thread.root"].request == by["thread.child"].request == request
    assert by["thread.root"].thread == by["thread.child"].thread != by["outer"].thread
    assert by["outer"].start_ns <= by["thread.root"].start_ns <= by["thread.child"].start_ns
    assert by["thread.child"].end_ns <= by["thread.root"].end_ns <= by["outer"].end_ns
    assert rec.counters == {"thread.items": 7}
    assert sorted(counted_ranges) == ["outer", "thread.child", "thread.root"]
    assert profiling.take() == profiling.Record([], {})


def test_nothing_is_recorded_with_tracing_off(record, counted_ranges):
    """With no profiler and no ``enable()``, a render records no span and
    no counter and enters no ``record_function``; ``enable()`` records
    without entering one."""
    _tile_render("sphere")
    profiling.count("x", 1)
    assert profiling.take() == profiling.Record([], {}) and counted_ranges == []
    profiling.enable()
    _tile_render("sphere")
    rec = profiling.take()
    assert {s.name for s in rec.spans} >= {"render.frame", "render.dispatch"} and counted_ranges == []
    assert rec.counters["render.callback_ns"] > 0


@pytest.mark.parametrize("kind", ["sphere", "triangles"])
def test_a_tile_render_nests_its_spans_under_one_request(record, tmp_path, kind):
    """A tile-mode render under the profiler: ``render.frame`` holds every
    dispatch, each dispatch its passes' ray generation, trace and shading,
    all under one request; the caller's spans, moved by one offset, fall
    within 1 ms of their ranges in the exported trace."""
    with torch.profiler.profile() as prof:
        p, image = _tile_render(kind)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert (image[..., 3] > 0).any()
    rec = profiling.take()
    by_id = {s.id: s for s in rec.spans}
    names = [s.name for s in rec.spans]
    assert len({s.request for s in rec.spans}) == 1
    frame = next(s for s in rec.spans if s.name == "render.frame")
    assert by_id[frame.parent].name == "render.start" and frame.thread != by_id[frame.parent].thread
    dispatches = [s for s in rec.spans if s.name == "render.dispatch"]
    assert len(dispatches) == 1 and dispatches[0].parent == frame.id  # 6 tiles: one dispatch
    phases = [s for s in rec.spans if s.parent == dispatches[0].id]
    assert {s.name for s in phases} == {"render.ray_gen", "render.trace", "render.shade", "render.finalize"}
    for s in phases:
        assert dispatches[0].start_ns <= s.start_ns <= s.end_ns <= dispatches[0].end_ns
    assert names.count("render.fetch") == names.count("render.write_back") == 1
    assert p.timings().summary()["dispatch"]["count"] == 1

    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = {e["name"]: e for e in events if e.get("ph") == "X" and e["name"] in CALLER_SPANS}
    assert set(ranges) == set(CALLER_SPANS)
    mine = {s.name: s for s in rec.spans if s.name in CALLER_SPANS}
    offset = statistics.median(ranges[n]["ts"] - mine[n].start_ns / 1e3 for n in CALLER_SPANS)
    for n in CALLER_SPANS:
        assert abs(mine[n].start_ns / 1e3 + offset - ranges[n]["ts"]) < 1e3, n
        assert abs(mine[n].end_ns / 1e3 + offset - ranges[n]["ts"] - ranges[n]["dur"]) < 1e3, n


def test_the_path_tracer_counts_its_lanes_live_lanes_and_shadow_rays(record, monkeypatch):
    """A NEE frame with compaction: ``pt.lanes`` is the wavefront's lanes
    at every bounce's trace, ``pt.live_lanes`` a recount of the live paths
    before each trace (all at the first, the compacted live prefix after),
    ``pt.shadow_rays`` the shadow candidates traced."""
    mesh = procedural.make_atrium(0)
    ids, dicts = procedural.atrium_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24)
    scene = bvh.pt_scene("cpu")
    table = tm.material_table(dicts, "cpu")
    tracer, _ = tw.make_pt_tracer(scene, stack_size=bvh.recommended_stack_size)
    shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=bvh.recommended_stack_size)
    lights = tm.build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    camera = Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)
    live, cands = [], []
    compact, shadow_batch = tw._compact, tw._shadow_batch

    def recount_compact(state, **kw):
        out = compact(state, **kw)
        live.append(int(out.active.sum()))
        return out

    def recount_shadow(cand, *args, **kw):
        cands.append(int(cand.sum()))
        return shadow_batch(cand, *args, **kw)

    monkeypatch.setattr(tw, "_compact", recount_compact)
    monkeypatch.setattr(tw, "_shadow_batch", recount_shadow)
    bounces, chunks, lanes = 3, 2, 16 * 16 * 2
    profiling.enable()
    img = tw.render_frame_pt(tracer, scene, table, camera.build_sampler((16, 16), "cpu"),
                             torch.Generator().manual_seed(0), width=16, height=16, spp=2 * chunks,
                             bounces=bounces, samples_per_packet=2, lights=lights, shadow_tracer=shadow)
    profiling.disable()
    assert np.isfinite(img.numpy()).all()
    rec = profiling.take()
    assert len(live) == chunks * (bounces - 1) and len(cands) == chunks * bounces
    assert rec.counters["pt.lanes"] == lanes * bounces * chunks
    assert rec.counters["pt.live_lanes"] == lanes * chunks + sum(live) < rec.counters["pt.lanes"]
    assert rec.counters["pt.shadow_rays"] == sum(cands) > 0
    frame = [s for s in rec.spans if s.name == "pt.frame"]
    assert len(frame) == 1 and [s.parent for s in rec.spans if s.name == "pt.chunk"] == [frame[0].id] * chunks
    assert {s.request for s in rec.spans} == {frame[0].request}


def test_phase_timers_never_synchronize(record, monkeypatch):
    """``PhaseTimers.phase`` reads the host's clock and nothing else: no
    device argument, no ``torch.cuda.synchronize``; ``render()``'s timings
    still name ``dispatch`` and ``fetch``."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: synced.append(a))
    assert list(inspect.signature(profiling.PhaseTimers.phase).parameters) == ["self", "name"]
    timers = profiling.PhaseTimers("t.")
    with timers.phase("x"):
        pass
    p, _ = _tile_render("triangles", resolution=(160, 144))  # 90 tiles: two dispatches
    summary = p.timings().summary()
    assert summary["dispatch"]["count"] == summary["fetch"]["count"] == 2
    assert timers.summary()["x"]["count"] == 1 and synced == []


def test_the_cli_writes_its_spans_with_trace_out(record, tmp_path):
    """``--trace-out`` records the run and writes a Chrome trace holding the
    render thread's ``render.frame``."""
    out = tmp_path / "spans" / "trace.json"
    assert cli.main(["--scene", "sphere-mesh", "--width", "48", "--height", "32", "--spp", "2", "--tile-size", "16",
                     "--device", "cpu", "--no-stats", "-q", "-o", str(tmp_path / "frame.png"),
                     "--trace-out", str(out)]) == 0
    data = json.loads(out.read_text())
    frames = [e for e in data["traceEvents"] if e["name"] == "render.frame"]
    assert len(frames) == 1 and frames[0]["ph"] == "X" and frames[0]["dur"] > 0
    assert frames[0]["args"]["parent"] is not None
    assert any(e["ph"] == "C" and e["name"] == "render.callback_ns" for e in data["traceEvents"])
    assert not profiling.recording()
