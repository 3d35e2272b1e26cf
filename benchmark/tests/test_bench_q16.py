"""The 16-bit layout's cell on the CPU: the tiny ``q16`` cell run whole,
sound and broken underneath; the reference's word checks; K3's op and byte
model pinned to the kernel's source; and the bfloat16 control, here and (on
the card) at the cell's own size."""

from __future__ import annotations

import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import DATA, copy_benchmark
from test_bench_run import _dropped_tiles, _unchanged

from benchmark import run
from benchmark.drivers import common, render_cli
from benchmark.harness import roofline, roofline_q, scene
from benchmark.reference import atrium, bvh, parity, q16

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 4321
SEEDS = (11, 2**31 + 7, 4_000_000_019)


@pytest.fixture
def q16_bench(tmp_path, monkeypatch):
    """The tiny benchmark with its ``q16`` configuration and cell, in a
    temporary copy, its caches kept there too."""
    monkeypatch.setattr(scene, "CACHE", tmp_path / "cache")
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-q16", "source": "https://github.com/bluecube/minipath",
                             "file": "benchmark/configs/tiny-q16.json", "reduced": ["triangles"], "why": "tests"})
    bench["workloads"].append({"name": "tiny-q16", "config": "tiny-q16", "traffic": "render_cli_q16-tiny",
                               "chips": 1, "why": "tests"})
    for m in bench["end_to_end"]:
        if m["name"] == "mrays_s":
            m["workloads"].append("tiny-q16")
    return copy_benchmark(tmp_path, bench)


def _run(bench_path, trace=False):
    out, err = io.StringIO(), io.StringIO()
    rc = run.run("tiny-q16", SEED, 0.3, trace, device=torch.device("cpu"), bench_path=bench_path, out=out, err=err)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_a_sound_q16_run_is_correct(q16_bench, trace):
    rc, line, err = _run(q16_bench, trace)
    assert rc == 0 and line["correct"] is True, err
    assert set(line["checks"]) == {"off_share", "pixel_z2", "mean_gap", "vertex_ulps", "box_ulps", "box_fit_ulps"}
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert ("setup_s" in line["metrics"]) != trace
    assert "layout " in err  # the set-up's step that builds the quantized layout


def test_a_program_without_the_layout_choice_fails_at_once(q16_bench, monkeypatch):
    """The parent of the layout choice: ``TriangleBvh.build`` takes no
    ``layout``. The run stops in set-up with the reason, before the mesh."""
    from minipath_tpu_torch.scene import triangle_bvh

    real = triangle_bvh.TriangleBvh.build.__func__

    def build(cls, mesh, materials=None, use_native=None, leaf_max=None):
        return real(cls, mesh, materials, use_native, leaf_max)

    monkeypatch.setattr(triangle_bvh.TriangleBvh, "build", classmethod(build))
    monkeypatch.setattr(scene, "mesh", lambda config: pytest.fail("the mesh was made"))
    with pytest.raises(RuntimeError, match="no layout choice"):
        _run(q16_bench)


# -- the timed path broken underneath ----------------------------------------


def _leaf_boxes_rolled(monkeypatch):
    """Vertices decoded against the wrong box: each packet decodes against
    the next packet's leaf box (the words stay sound)."""
    from minipath_tpu_torch.render import kernels_q

    real = kernels_q.decompressed_boxes

    def rolled(*args, **kw):
        child_box, node_frame, leaf_box = real(*args, **kw)
        return child_box, node_frame, torch.roll(leaf_box, 1, dims=0)

    monkeypatch.setattr(kernels_q, "decompressed_boxes", rolled)


def _vertices_quantized_against_the_root(monkeypatch):
    """Vertices encoded against the wrong box: the root's frame in place of
    their leaf's."""
    from minipath_tpu_torch.scene.bvh import quantize

    real = quantize.build_quantized_scene

    def wrong(arrays):
        qs = real(arrays)
        frame = quantize.root_frame(qs.root_box)
        verts = np.asarray(arrays.tri_packets, np.float64).reshape(-1, 72)
        lo, size = np.tile(frame[:3], 24), np.tile(frame[3:] - frame[:3], 24)
        q = np.clip(np.rint((verts - lo) / size * 65535.0), 0, 65535).astype(np.int64)
        words = qs.tri_q.astype(np.int64)
        words[:, 0:36] = q[:, 0::2] | (q[:, 1::2] << 16)
        return qs._replace(tri_q=quantize._to_i32(words))

    monkeypatch.setattr(quantize, "build_quantized_scene", wrong)


def _child_boxes_rounded_inward(monkeypatch):
    """Child boxes rounded inward: every bound of every child one step
    inside the round-out one, in the words as the quantizer wrote them."""
    from minipath_tpu_torch.scene.bvh import quantize

    real = quantize.build_quantized_scene

    def inward(arrays):
        qs = real(arrays)
        w = qs.node_q[:, :24].astype(np.int64) & 0xFFFFFFFF
        q = np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(-1, 8, 6)  # min xyz, max xyz
        valid = (qs.node_q[:, 24:32] != -8)[..., None]
        lo = np.where(valid, np.minimum(q[..., :3] + 1, q[..., 3:]), q[..., :3])
        hi = np.where(valid, np.maximum(q[..., 3:] - 1, lo), q[..., 3:])
        q = np.concatenate([lo, hi], axis=-1).reshape(-1, 24, 2)
        words = qs.node_q.astype(np.int64)
        words[:, :24] = q[..., 0] | (q[..., 1] << 16)
        return qs._replace(node_q=quantize._to_i32(words))

    monkeypatch.setattr(quantize, "build_quantized_scene", inward)


def _child_boxes_rounded_out_two_steps(monkeypatch):
    """Child boxes rounded out two steps further than the rule, in the
    quantizer: the children and the vertices are encoded against the wider
    boxes, so the words decode consistently and contain every triangle."""
    from minipath_tpu_torch.scene.bvh import quantize

    real = quantize._quantize_boxes_conservative

    def wider(pb, cmin, cmax, valid):
        q_min, q_max, _, _ = real(pb, cmin, cmax, valid)
        v = valid[..., None]
        q_min = np.where(v, np.maximum(q_min - 2, 0), q_min)
        q_max = np.where(v, np.minimum(q_max + 2, 65535), q_max)
        pmin, pmax = pb[:, None, 0:3], pb[:, None, 3:6]
        return q_min, q_max, quantize._dec(pmin, pmax, q_min), quantize._dec(pmin, pmax, q_max)

    monkeypatch.setattr(quantize, "_quantize_boxes_conservative", wider)


FAULTS = [_leaf_boxes_rolled, _vertices_quantized_against_the_root, _child_boxes_rounded_inward, _unchanged,
          _dropped_tiles, _child_boxes_rounded_out_two_steps]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
def test_a_broken_q16_path_is_not_correct(q16_bench, monkeypatch, fault):
    fault(monkeypatch)
    rc, line, err = _run(q16_bench)
    assert rc == 0 and line["correct"] is False, err
    failed = {name for name, c in line["checks"].items() if c["value"] > c["limit"]}
    if fault in (_vertices_quantized_against_the_root, _child_boxes_rounded_inward):
        assert failed & {"vertex_ulps", "box_ulps"}, line["checks"]
    if fault is _child_boxes_rounded_out_two_steps:
        assert failed == {"box_fit_ulps"}, line["checks"]


# -- the reference's word checks ---------------------------------------------


def _words(m: atrium.Mesh):
    from minipath_tpu_torch.scene.obj_loader import MeshData
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    data = MeshData(triangles=m.triangles, positions=m.positions, normals=m.normals, texcoords=m.texcoords)
    b = TriangleBvh.build(data, use_native=True, layout="q16")
    qs = b.kernel_scene("cpu")
    return q16.Words(qs.node_q.numpy(), qs.tri_q.numpy(), qs.root, qs.root_box.numpy()), b.host_arrays.tri_vidx


def test_the_decode_follows_the_programs_words():
    """The program's own decoded boxes (the leaf frames it keeps in words
    58..63) equal the rule's, and a lane left out of the mesh's triangles, or
    one held twice, leaves nothing to compare."""
    m = atrium.make_atrium(3000)
    words, vidx = _words(m)
    decoded = q16.decode(words)
    frames = words.tri_q[:, 58:64].copy().view(np.float32)
    np.testing.assert_array_equal(frames, decoded.leaf_box)
    lane_tri = q16.lane_triangles(vidx, m.triangles)
    assert sorted(lane_tri[lane_tri >= 0].tolist()) == list(range(len(m.triangles)))
    missing = np.array(vidx, copy=True)
    missing[np.nonzero(lane_tri >= 0)[0][0]] = 0
    twice = np.array(vidx, copy=True)
    real = np.nonzero(lane_tri >= 0)[0]
    twice[real[0]] = twice[real[1]]
    assert q16.lane_triangles(missing, m.triangles) is None and q16.lane_triangles(twice, m.triangles) is None
    assert q16.check(decoded, None, m.positions, m.triangles) == dict.fromkeys(
        ("vertex_ulps", "box_ulps", "box_fit_ulps"), q16.UNMATCHED)


# -- the cell's device readers -----------------------------------------------


def test_the_k3_cells_device_ms_split_the_frame():
    """``k3_ms`` reads K3's full closest-hit instance, ``tile_glue_q_ms``
    everything but K3 (K1, were it there, counts as glue); together they
    read every device microsecond of the frames."""
    from types import SimpleNamespace

    from benchmark.harness import profile

    tr = profile.Trace(0.0, 1e6, [("void traverse_q_kernel<false, false>(QArgs)", 0.0, 4e3),
                                  ("void traverse_q_kernel<true, false>(QArgs)", 4e3, 1e3),
                                  ("void traverse_kernel<false, false>(TraceArgs)", 5e3, 2e3),
                                  ("elementwise", 7e3, 6e3)], [])
    ctx = SimpleNamespace(trace=tr, traced=[{}, {}])

    def read(name, c=ctx):
        return run.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read(c)

    assert read("k3_ms") == pytest.approx(2.0)
    assert read("tile_glue_q_ms") == pytest.approx(4.0)
    only_k3 = SimpleNamespace(trace=profile.Trace(0.0, 1e6, [("void traverse_q_kernel<false, false>(Q)", 0.0, 1.0)],
                                                  []), traced=[{}])
    assert read("tile_glue_q_ms", only_k3) is None


# -- K3's op and byte model --------------------------------------------------


def _between(text: str, start: str, end: str) -> str:
    i = text.index(start)
    return text[i:text.index(end, i)]


def test_the_model_counts_the_kernels_arithmetic():
    """The counts of ``roofline_q.py`` are the arithmetic that
    ``csrc/traverse_q.cu`` does beyond K1's, read from its source: per inner
    visit the frame's three scales; per child box six u16 values unpacked
    (a byte permute and a subtraction each) and decoded (a multiply and an
    add each); per triangle lane nine coordinates unpacked and decoded and
    two edges of three subtractions."""
    src = (ROOT / "minipath_tpu_torch" / "csrc" / "traverse_q.cu").read_text()
    assert src.count("__byte_perm") == 2 and src.count("- 8388608.f") == 2  # lo16 and hi16
    inner = _between(src, "while (have && (cur & MP_COUNT_MASK) == 0)", "mp_children_done")
    assert inner.count("* MP_INV_U16") == 3 and len(re.findall(r"\(f[ab]\.\w - bmin\w\)", inner)) == 3
    child = _between(inner, "for (int c = 0; c < 8; ++c)", "const float tx0")
    assert len(re.findall(r"(?:lo|hi)16\(w\[[^]]*\]\) \* ms[xyz]", child)) == 6
    assert len(re.findall(r"bmin[xyz] \+ ", child)) == 6
    lane = _between(src, "const int u0 = 9 * lane;", "mp_test_triangle(")
    assert len(re.findall(r"MP_COORD\(\d\) \* ls[xyz]", lane)) == 9
    assert len(re.findall(r"bmin[xyz] \+ MP_COORD", lane)) == 9
    assert lane.count("- v0") == 6

    assert roofline_q.FRAME == {"add_mul": 6}
    assert roofline_q.SLAB_Q == {"add_mul": 6 + 6 + 6 + 12, "cmp_minmax": 13, "int": 6}
    assert roofline_q.MT_Q == {"add_mul": 9 + 9 + 9 + 6 + 45, "cmp_minmax": 5, "rcp": 1, "int": 9}
    assert roofline_q.RATES == {"add_mul": 128, "cmp_minmax": 64, "rcp": 16, "int": 64}
    assert (roofline_q.NODE_BYTES, roofline_q.FRAME_BYTES, roofline_q.PACKET_BYTES) == (128, 32, 256)


def test_k3s_least_time_is_k1s_plus_the_decoding():
    ops_s, bytes_s = roofline_q.k3_least_seconds(10**8, 20.0, 10.0, 1000, 1000)
    visit = 6 / 128 + 8 * (30 / 128 + 13 / 64 + 6 / 64)
    lane = 78 / 128 + 5 / 64 + 1 / 16 + 9 / 64
    assert ops_s == pytest.approx(10**8 * (20 * visit + 10 * 8 * lane) / (132 * 1.98e9))
    assert bytes_s == (1000 * 160 + 1000 * 256 + 10**8 * 60) / 3.35e12
    k1_ops, k1_bytes = roofline.k1_least_seconds(10**8, 20.0, 10.0, 1000, 1000)
    assert ops_s > k1_ops and bytes_s < k1_bytes


# -- the control: the reference in bfloat16 ----------------------------------


def _control(m: atrium.Mesh, tree, words, vidx, device, lens, size, tile, spp, seed, pixels, frames) -> dict:
    """The cell's numbers with the reference in bfloat16 put in the
    program's place: the words decoded and the frames traced in bfloat16,
    against the float32 decode and replay."""
    decoded = q16.decode(words)
    lane_tri = q16.lane_triangles(vidx, m.triangles)

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    low = decoded._replace(child_box=bf16(decoded.child_box), root_frame=bf16(decoded.root_frame),
                           leaf_box=bf16(decoded.leaf_box), verts=bf16(decoded.verts))
    numbers = q16.check(low, lane_tri, m.positions, m.triangles)
    f32 = q16.reference_scene(decoded, lane_tri, tree, device)
    b16 = q16.reference_scene(decoded, lane_tri, tree, device, torch.bfloat16)
    seeds = [int(x) for x in common.rng(seed, 0).integers(0, 2**31, frames)]
    got = [parity.render_pixels(*b16, lens, size, tile, spp, s, pixels, dtype=torch.bfloat16) for s in seeds]
    want = parity.render_pixels(*f32, lens, size, tile, spp, seeds[0], pixels)
    total, squares = parity.estimate_pixels(*f32, lens, size, pixels, 128, seed % 2**62)
    numbers.update(render_cli.compare(np.stack([g[:, [0, 3]] for g in got]).astype(np.float64) / 255.0,
                                      total.cpu().numpy(), squares.cpu().numpy(), 128))
    numbers["off_share"] = common.off_share(got[0], want)
    return numbers


def _cell() -> tuple:
    params = json.loads((ROOT / "benchmark" / "workloads" / "q16-600k-1080p64.json").read_text())
    config = json.loads((ROOT / "benchmark" / "configs" / "atrium600k-q16.json").read_text())
    return params, config


@pytest.mark.parametrize("seed", SEEDS)
def test_the_q16_control_fails_on_the_cpu(seed):
    params, _ = _cell()
    m = atrium.make_atrium(3000)
    words, vidx = _words(m)
    lens = parity.look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5), 8.0, 0.036)
    pixels = common.check_pixels(seed, 48, 32, 512)
    got = _control(m, bvh.build_tree(m.positions, m.triangles), words, vidx, "cpu", lens, (48, 32), 16, 40, seed,
                   pixels, 8)
    assert any(got[name] > limit for name, limit in params["checks"].items()), got


@pytest.mark.cuda
def test_the_q16_control_fails_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params, config = _cell()
    m = scene.mesh(config)
    tree = scene.reference_tree(config, m)
    words, vidx = _words(m)
    size = (params["width"], params["height"])
    readings = []
    for seed in SEEDS:
        pixels = common.check_pixels(seed, *size, params["check_pixels"])
        readings.append(_control(m, tree, words, vidx, "cuda", common.lens(config), size, params["tile_size"],
                                 params["spp"], seed, pixels, 16))
    print(f"control q16-600k-1080p64: {readings}")
    assert all(any(got[name] > limit for name, limit in params["checks"].items()) for got in readings)
