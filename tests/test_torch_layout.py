"""The scene layout a caller chooses (``TriangleBvh.layout``, the CLI's and
the GUI's ``--layout``) on the CPU, and the 16-bit layout's frames against
the benchmark's plain reference.

Under ``q16`` the tracer is K3's plain version (the kernel's float32 steps
over the decompressed words) and the reference is
``benchmark/reference/q16.py``: the words decoded by the published rule and
traced by the reference's own traversal over its own tree, refitted to the
decoded triangles. Both decode with the same separately rounded float32
steps and take the same closest hits, so the bytes agree exactly: the
tolerance is none.
"""

import argparse
import json
import shutil

import numpy as np
import pytest
from PIL import Image

from benchmark.reference import bvh as ref_bvh
from benchmark.reference import parity, q16
from minipath_tpu_torch import Camera, RenderSettings, Scene, cli, gui, render
from minipath_tpu_torch.render import kernels, kernels_q
from minipath_tpu_torch.scene import procedural, triangle_bvh
from minipath_tpu_torch.scene.bvh.build import build_bvh
from minipath_tpu_torch.scene.obj_loader import MeshData
from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh
from minipath_tpu_torch.utils import profiling

ATRIUM = 20_000
EYE, TARGET, F_NUMBER, FOCUS = (-16.0, 4.0, 0.0), (10.0, 3.0, 0.5), 8.0, 12.0
# 48 x 32 over the CLI's default 24 mm sensor height: a 36 mm sensor width.
WIDTH, HEIGHT, SPP, TILE, SEED = 48, 32, 8, 16, 5


@pytest.fixture(scope="module")
def atrium():
    if shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable (no g++)")
    return procedural.make_atrium(ATRIUM)


def _reference_bytes(mesh, bvh: TriangleBvh, pixels: np.ndarray) -> np.ndarray:
    """The reference's bytes of the frame at ``pixels``, from the tree's own
    quantized words."""
    qs = bvh.quantized_scene("cpu")
    words = q16.Words(qs.node_q.numpy(), qs.tri_q.numpy(), qs.root, qs.root_box.numpy())
    decoded = q16.decode(words)
    lane_tri = q16.lane_triangles(bvh.host_arrays.tri_vidx, mesh.triangles)
    checks = q16.check(decoded, lane_tri, mesh.positions, mesh.triangles)
    assert max(checks.values()) <= 8.0, checks
    ref, vnorm = q16.reference_scene(decoded, lane_tri, ref_bvh.build_tree(mesh.positions, mesh.triangles), "cpu")
    lens = parity.look_at(EYE, TARGET, F_NUMBER, 0.036)._replace(focus_distance=FOCUS)
    return parity.render_pixels(ref, vnorm, lens, (WIDTH, HEIGHT), TILE, SPP, SEED, pixels)


def _render_bytes(bvh: TriangleBvh, tmp_path, monkeypatch) -> np.ndarray:
    cam = Camera().look_at(EYE, TARGET).f_number(F_NUMBER).focus_distance(FOCUS)
    progress = render(Scene(bvh), cam, RenderSettings(TILE, SPP, (WIDTH, HEIGHT)),
                      finished_tile_callback=lambda t, s: None, device="cpu", seed=SEED)
    progress.wait()
    return progress.image()


def _cli_bytes(bvh: TriangleBvh, tmp_path, monkeypatch) -> np.ndarray:
    """The CLI's PNG; its atrium is cut to the one ``bvh`` was built on."""
    monkeypatch.setattr(procedural, "make_atrium", lambda real=procedural.make_atrium: real(ATRIUM))
    out = tmp_path / "q16.png"
    assert cli.main([
        "--scene", "atrium", "--layout", "q16", "--width", str(WIDTH), "--height", str(HEIGHT), "--spp", str(SPP),
        "--tile-size", str(TILE), "--seed", str(SEED), "--device", "cpu", "--no-stats", "-q", "-o", str(out),
        "--camera-from", *map(str, EYE), "--camera-to", *map(str, TARGET), "--f-number", str(F_NUMBER),
        "--focus", str(FOCUS),
    ]) == 0
    return np.asarray(Image.open(out))


@pytest.mark.parametrize("entry", [_render_bytes, _cli_bytes], ids=["render", "cli"])
def test_q16_frame_equals_the_reference(atrium, entry, tmp_path, monkeypatch):
    bvh = TriangleBvh.build(atrium, use_native=True, layout="q16")
    image = entry(bvh, tmp_path, monkeypatch)
    pixels = np.stack(np.meshgrid(np.arange(WIDTH), np.arange(HEIGHT)), axis=-1).reshape(-1, 2)
    want = _reference_bytes(atrium, bvh, pixels)
    got = image[pixels[:, 1], pixels[:, 0]]
    assert (got[:, 3] > 0).mean() > 0.5  # the frame sees the atrium
    np.testing.assert_array_equal(got, want)


# ---- the choice ------------------------------------------------------------------


@pytest.mark.parametrize("budget", [None, "under"])
@pytest.mark.parametrize("layout", ["auto", "q16"])
def test_the_layout_is_the_one_asked_for(monkeypatch, layout, budget):
    """``auto`` picks by the budget as before (none on the CPU; a patched
    budget below the f32 bytes takes the quantized layout); ``q16`` is
    honoured whatever the budget."""
    mesh = procedural.make_random_triangles(2000, seed=1)
    bvh = TriangleBvh.build(mesh, layout=layout)
    assert bvh.layout == layout
    if budget == "under":
        monkeypatch.setattr(triangle_bvh, "SCENE_BUDGET_BYTES", bvh.f32_scene_bytes() - 1)
    quantized = layout == "q16" or (layout == "auto" and budget == "under")
    want = (kernels_q.QuantizedScene, kernels_q.QPTScene) if quantized else (kernels.KernelScene, kernels.PTScene)
    assert isinstance(bvh.kernel_scene("cpu"), want[0])
    assert isinstance(bvh.pt_scene("cpu"), want[1])


def test_an_unknown_layout_raises():
    mesh = procedural.make_random_triangles(200, seed=1)
    with pytest.raises(ValueError, match="layout 'q8'"):
        TriangleBvh.build(mesh, layout="q8")
    with pytest.raises(ValueError, match="layout 'f32'"):
        TriangleBvh(build_bvh(mesh), layout="f32")
    for parser in (cli.build_parser(), gui.build_parser()):
        assert parser.parse_args([]).layout == "auto" and parser.parse_args(["--layout", "q16"]).layout == "q16"
        with pytest.raises(SystemExit):
            parser.parse_args(["--layout", "f32"])


def test_q16_on_a_spatial_split_tree_raises(capsys):
    """Spatial splits clip leaf boxes tighter than their triangles: the
    quantized layout cannot hold them, and ``q16`` raises where ``auto``
    would take the f32 layout; the CLI's check says so and fails."""
    floor = MeshData(
        triangles=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        positions=np.float32([[-12, -1, -12], [12, -1, -12], [12, -1, 12], [-12, -1, 12]]),
        normals=np.zeros((4, 3), np.float32),
    )
    mesh = procedural.merge_meshes([procedural.make_random_triangles(600, seed=5), floor])
    split = build_bvh(mesh, leaf_max=24, spatial_splits=True)
    assert isinstance(TriangleBvh(split).kernel_scene("cpu"), kernels.KernelScene)
    with pytest.raises(ValueError, match="spatial splits"):
        TriangleBvh(split, layout="q16").kernel_scene("cpu")
    assert not cli.quantize_for_layout(argparse.Namespace(device="cpu"), TriangleBvh(split, layout="q16"))
    assert "--layout q16: leaf vertices extend outside" in capsys.readouterr().err
    assert cli.quantize_for_layout(argparse.Namespace(device="cpu"), TriangleBvh(split))


# ---- tracing --------------------------------------------------------------------


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_k3_rays_and_the_quantize_span(on):
    """While the recorder is on, the layout's build is the span
    ``scene.quantize`` with its bytes in ``scene.q16_bytes``, and every K3
    call adds its batch's rays to ``k3.rays``; off, none of them is
    recorded."""
    mesh = procedural.make_random_triangles(2000, seed=1)
    bvh = TriangleBvh.build(mesh, layout="q16")
    cam = Camera().look_at((0, 0, 25), (0, 0, 0))
    profiling.take()
    try:
        if on:
            profiling.enable()
        progress = render(Scene(bvh), cam, RenderSettings(16, 3, (40, 24)), device="cpu")
        progress.wait()
    finally:
        profiling.disable()
        rec = profiling.take()
    names = {s.name for s in rec.spans}
    if not on:
        assert not names and not rec.counters
        return
    qs = bvh.quantized_scene("cpu")
    assert "scene.quantize" in names
    assert rec.counters["scene.q16_bytes"] == sum(t.nbytes for t in (qs.node_q, qs.tri_q, qs.node_frame, qs.root_box))
    assert rec.counters["scene.q16_bytes"] == bvh.quantized_scene_bytes() + 24
    # 40 x 24 in 16-px tiles: 3 x 2 tiles, each traced at 16 x 16, 3 spp.
    assert rec.counters["k3.rays"] == 6 * 16 * 16 * 3


def test_the_cli_trace_holds_the_layout_spans(atrium, tmp_path, monkeypatch):
    """``--trace-out`` writes ``scene.quantize``, ``scene.q16_bytes`` and
    ``k3.rays`` into the exported trace."""
    monkeypatch.setattr(procedural, "make_atrium", lambda real=procedural.make_atrium: real(3000))
    trace = tmp_path / "trace.json"
    assert cli.main(["--scene", "atrium", "--layout", "q16", "--width", "32", "--height", "16", "--spp", "2",
                     "--tile-size", "16", "--device", "cpu", "--no-stats", "-q", "-o", str(tmp_path / "f.png"),
                     "--camera-from", *map(str, EYE), "--camera-to", *map(str, TARGET),
                     "--trace-out", str(trace)]) == 0
    events = json.loads(trace.read_text())["traceEvents"]
    spans = {e["name"] for e in events if e["ph"] == "X"}
    counters = {e["name"]: e["args"][e["name"]] for e in events if e["ph"] == "C"}
    assert "scene.quantize" in spans
    assert counters["k3.rays"] == 2 * 16 * 16 * 2 and counters["scene.q16_bytes"] > 0
