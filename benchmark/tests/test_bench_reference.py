"""The frozen scene and the plain references, on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import atrium, bvh, parity, trace


@pytest.mark.parametrize("target", [3000, 250_000])
def test_frozen_atrium_equals_the_ports(target):
    from minipath_tpu_torch.scene import procedural

    mine, theirs = atrium.make_atrium(target), procedural.make_atrium(target)
    for field in atrium.Mesh._fields:
        np.testing.assert_array_equal(getattr(mine, field), getattr(theirs, field))
    ids, dicts = procedural.atrium_materials(theirs)
    np.testing.assert_array_equal(atrium.atrium_materials(mine), ids)
    assert len(dicts) == len(atrium.MATERIALS)
    for d, (kind, color, fuzz, ior, strength) in zip(dicts, atrium.MATERIALS):
        emission = np.float32(color) * np.float32(strength) if kind == "emissive" else (0, 0, 0)
        albedo = (0, 0, 0) if kind == "emissive" else color
        np.testing.assert_allclose(d["emission"], emission)
        np.testing.assert_allclose(d["albedo"], albedo)
        assert d["param"] == {"metal": fuzz, "dielectric": ior}.get(kind, 0.0)


def _one_triangle_scene(v, dtype=torch.float32):
    positions = np.asarray(v, np.float32)
    triangles = np.array([[0, 1, 2]], np.int32)
    tree = bvh.build_tree(positions, triangles)
    return trace.prepare(tree, positions, triangles, "cpu", dtype)


def test_plain_intersection_on_hand_made_rays():
    s = _one_triangle_scene([[0, 0, 0], [1, 0, 0], [0, 1, 0]])
    o = torch.tensor([[0.25, 0.25, 1.0], [0.25, 0.25, -2.0], [2.0, 2.0, 1.0], [0.25, 0.25, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    h = trace.trace(s, o, d)
    assert h.tri.tolist() == [0, 0, -1, -1]  # two-sided; a miss beside it; behind the origin
    assert h.t[:2].tolist() == [1.0, 2.0]
    np.testing.assert_allclose(h.u[:2], [0.25, 0.25])
    np.testing.assert_allclose(h.v[:2], [0.25, 0.25])


def test_closest_of_many_is_found_whatever_the_tree():
    rng = np.random.default_rng(3)
    centers = rng.uniform(-5, 5, (400, 1, 3))
    positions = (centers + rng.normal(0, 0.4, (400, 3, 3))).astype(np.float32).reshape(-1, 3)
    triangles = np.arange(1200, dtype=np.int32).reshape(-1, 3)
    s = trace.prepare(bvh.build_tree(positions, triangles), positions, triangles, "cpu")
    o = torch.from_numpy(rng.uniform(-6, 6, (300, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32)), dim=-1)
    h = trace.trace(s, o, d)
    # Brute force over every triangle, the same arithmetic.
    v0 = torch.from_numpy(positions[triangles[:, 0]])
    e1 = torch.from_numpy(positions[triangles[:, 1]]) - v0
    e2 = torch.from_numpy(positions[triangles[:, 2]]) - v0
    p = torch.cross(d[:, None], e2[None], dim=-1)
    det = (e1[None] * p).sum(-1)
    sv = o[:, None] - v0[None]
    u = (sv * p).sum(-1) / det
    q = torch.cross(sv, e1[None].expand_as(sv), dim=-1)
    v = (d[:, None] * q).sum(-1) / det
    t = (e2[None] * q).sum(-1) / det
    ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0)
    best = torch.where(ok, t, torch.inf).min(dim=1)
    hit = torch.isfinite(best.values)
    assert torch.equal(h.tri >= 0, hit)
    assert torch.equal(h.tri[hit], best.indices[hit])
    assert int(h.inner_visits.min()) >= 1


def test_parity_reference_equals_render_on_the_cpu():
    """render() in tile mode over the port's native tree, byte for byte at
    every pixel, passes of 32 and 8 samples."""
    from minipath_tpu_torch import Camera, RenderSettings, Scene, render

    from benchmark.harness import scene

    m = atrium.make_atrium(3000)
    cam = Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(0.036)
    w, h, spp, tile = 48, 32, 40, 16
    p = render(Scene(scene.port_bvh(m)), cam, RenderSettings(tile, spp, (w, h)),
               finished_tile_callback=lambda *_: None, device="cpu", seed=2**33 + 5)
    p.wait()
    img = p.image()
    ref = trace.prepare(bvh.build_tree(m.positions, m.triangles), m.positions, m.triangles, "cpu")
    vn = trace.shading_normals(m.positions, m.normals, m.triangles, "cpu")
    px = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1).reshape(-1, 2)
    lens = parity.look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5), 8.0, 0.036)
    want = parity.render_pixels(ref, vn, lens, (w, h), tile, spp, 2**33 + 5, px)
    np.testing.assert_array_equal(img[px[:, 1], px[:, 0]], want)
    assert 0.2 < (want[:, 3] == 255).mean() <= 1.0
