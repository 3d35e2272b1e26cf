"""The port's lean trace (K2) and its scene layout against the JAX package's.

The plain PyTorch version of K2 runs here, on the CPU; the JAX kernel
``trace_packets_pallas_pt`` runs in interpret mode, as tests/test_pallas.py
runs it. Tolerances: ``build_shade_flat`` and ``prepare_scene_pt`` equal bit
for bit. Closest-hit: ``tri`` equal on at least 99.9% of rays, every
mismatch a tie (both candidates' ``t`` within 1e-5 relative); the JAX kernel
traverses per packet in its own child order, the port per ray, so the winner
of an exact tie may differ. ``t`` within 1e-5 relative or 1e-6 absolute,
and where ``tri`` matches ``u`` and ``v`` within 1e-5 on at least 98% of
rays and within 1e-4 on all. Both sides take the same float32 steps, but
XLA:CPU always contracts a multiply-add into one fused step, which the port
(and its CUDA kernel, built with ``-fmad=false``) rounds in two: on a small
triangle seen from afar, Möller–Trumbore's ``u`` and ``v`` carry an
absolute float32 error of about 1e-5 (distance / triangle size x 1e-7), so
the two roundings differ there by up to 1e-4, and a near hit's ``t`` by a
few 1e-7 absolute. Any-hit: the occlusion masks are equal on every ray. The CUDA
kernel is compared with the plain version on the card in
tests/test_torch_cuda_pt.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu.render.pallas_kernels import build_shade_flat as jax_build_shade_flat
from minipath_tpu.render.pallas_kernels import prepare_scene_pt as jax_prepare_scene_pt
from minipath_tpu.render.pallas_kernels import trace_packets_pallas_pt
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu.scene.obj_loader import MeshData
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu_torch.geometry.ray import make_rays
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.render.wavefront import _SHADOW_T_MAX
from minipath_tpu_torch.scene.bvh.build import from_numpy
from minipath_tpu_torch.scene.bvh import links as L
from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

RTOL = 1e-5
T_ATOL = 1e-6
UV_ATOL, UV_SHARE, UV_ATOL_ALL = 1e-5, 0.98, 1e-4
P = 256  # rays per packet


@pytest.fixture(scope="module")
def atrium():
    """The path tracer's atrium at its smallest (hall, columns, one prop),
    with the benchmark materials and leaves of up to 24 triangles."""
    mesh = jax_procedural.make_atrium(0)
    ids, _ = jax_procedural.atrium_materials(mesh)
    res = jax_build_bvh(mesh, materials=ids, leaf_max=24)
    return res, jax_prepare_scene_pt(res.as_device()), kernels.prepare_scene_pt(from_numpy(res.arrays._asdict(), "cpu"))


def _uv_mesh():
    """A sphere and a cube whose vertices carry non-trivial texture
    coordinates, so the uv columns of the shading table are exercised."""
    mesh = jax_procedural.merge_meshes(
        [jax_procedural.make_uv_sphere(1.0, rings=6, segments=9), jax_procedural.make_cube(1.5, center=(2, 0, 0))]
    )
    rng = np.random.default_rng(4)
    mesh.texcoords = rng.uniform(-3.0, 3.0, mesh.positions.shape).astype(np.float32)
    return mesh, rng.integers(0, 2047, mesh.triangle_count).astype(np.int32)


@pytest.mark.parametrize("scene", ["atrium", "uv"])
def test_shade_flat_and_pt_scene_bit_for_bit(atrium, scene):
    if scene == "atrium":
        res = atrium[0]
    else:
        mesh, ids = _uv_mesh()
        res = jax_build_bvh(mesh, materials=ids)
    want = jax_prepare_scene_pt(res.as_device())
    got = kernels.prepare_scene_pt(from_numpy(res.arrays._asdict(), "cpu"))
    assert got.root == int(np.asarray(want.root).reshape(()))
    for name in ("node_box", "node_links", "tri_data", "shade_flat"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g.view(np.uint16) if g.dtype == np.float16 else g,
                                      w.view(np.uint16) if w.dtype == np.float16 else w, err_msg=name)
    np.testing.assert_array_equal(
        kernels.build_shade_flat(from_numpy(res.arrays._asdict(), "cpu")).numpy().view(np.uint16),
        np.asarray(jax_build_shade_flat(res.as_device())).view(np.uint16),
    )


def test_f3_repairs_raise():
    """Material ids past the f16 table raise before any layout is built,
    and so do texture coordinates f16 would store as inf."""
    mesh, ids = _uv_mesh()
    ids[5] = 2048
    bvh = TriangleBvh.build(_as_port_mesh(mesh), materials=ids)
    with pytest.raises(ValueError, match="material ids"):
        bvh.pt_scene("cpu")
    with pytest.raises(ValueError, match="material ids"):
        kernels.check_material_ids(torch.tensor([-1]))
    mesh, ids = _uv_mesh()
    mesh.texcoords[3, 1] = 7e4  # beyond f16's largest finite value, 65504
    bvh = TriangleBvh.build(_as_port_mesh(mesh), materials=ids)
    with pytest.raises(ValueError, match="f16"):
        bvh.pt_scene("cpu")
    kernels.check_material_ids(torch.zeros(0, dtype=torch.int32))  # an empty scene passes


def _as_port_mesh(mesh):
    from minipath_tpu_torch.scene.obj_loader import MeshData as PortMeshData

    return PortMeshData(triangles=mesh.triangles, positions=mesh.positions, normals=mesh.normals,
                        texcoords=mesh.texcoords)


def _rays9(o, d, inv=None):
    """(B, P, 3) float32 arrays -> the port's (B, 9, P) and the JAX kernel's
    (B, 9, P/128, 128), the same values. Without ``inv`` the direction is
    normalized (``make_rays``); with it, ``d`` and ``inv`` are taken as
    they are."""
    if inv is None:
        rays = make_rays(torch.from_numpy(o), torch.from_numpy(d))
        d, inv = rays.direction.numpy(), rays.inv_direction.numpy()
    r9 = np.ascontiguousarray(np.swapaxes(np.concatenate([o, d, inv], -1), 1, 2).astype(np.float32))
    B = r9.shape[0]
    return torch.from_numpy(r9), jnp.asarray(r9.reshape(B, 9, P // 128, 128))


def _ray_sets(res, scene):
    """Random rays in the hall, coherent pinhole rays down the colonnade,
    and bounce-like rays: cosine-distributed directions leaving the first
    hits of the coherent rays."""
    rng = np.random.default_rng(7)
    lo, hi = np.asarray(res.arrays.bbox_min), np.asarray(res.arrays.bbox_max)
    random_o = rng.uniform(lo + 0.5, hi - 0.5, (4, P, 3)).astype(np.float32)
    random_d = rng.normal(size=(4, P, 3)).astype(np.float32)

    ys, xs = np.mgrid[0:32, 0:32].astype(np.float32)
    d = np.stack([np.full_like(xs, 1.0), 0.4 - ys / 40.0, xs / 40.0 - 0.4], -1).reshape(4, P, 3)
    coherent_o = np.broadcast_to(np.float32([-16.0, 4.0, 0.0]), d.shape).copy()
    coherent_d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)

    r9, _ = _rays9(coherent_o, coherent_d)
    first = kernels.trace_packets_pt(scene, r9, stack_size=res.recommended_stack_size)
    hit = first.tri.numpy() >= 0
    t = np.where(hit, first.t.numpy(), 1.0)[..., None]
    sf = scene.shade_flat.float().numpy()[np.maximum(first.tri.numpy(), 0)]
    n = sf[..., 0:3] + first.u.numpy()[..., None] * (sf[..., 3:6] - sf[..., 0:3]) \
        + first.v.numpy()[..., None] * (sf[..., 6:9] - sf[..., 0:3])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    n = np.where((np.sum(n * coherent_d, -1, keepdims=True) < 0), n, -n)
    u = rng.normal(size=n.shape)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    bounce_d = (n + u).astype(np.float32)
    bounce_o = (coherent_o + coherent_d * t + n * 1e-3).astype(np.float32)
    return {"random": (random_o, random_d), "coherent": (coherent_o, coherent_d), "bounce": (bounce_o, bounce_d)}


def _compare(got: kernels.PTHits, want, min_match=0.999):
    tri, wtri = got.tri.numpy(), np.asarray(want.tri)
    t, wt = got.t.numpy(), np.asarray(want.t)
    assert tri.shape == wtri.shape and tri.dtype == np.int32
    same = tri == wtri
    assert same.mean() >= min_match, same.mean()
    np.testing.assert_allclose(t[~same], wt[~same], rtol=RTOL)  # a mismatch is a tie
    np.testing.assert_allclose(t, wt, rtol=RTOL, atol=T_ATOL)
    for a, b in ((got.u.numpy(), want.u), (got.v.numpy(), want.v)):
        err = np.abs(a - np.asarray(b))[same]
        assert (err <= UV_ATOL).mean() >= UV_SHARE, (err <= UV_ATOL).mean()
        assert err.max() <= UV_ATOL_ALL, err.max()


@pytest.mark.parametrize("rays", ["random", "coherent", "bounce"])
def test_closest_hit_matches_jax(atrium, rays):
    res, jscene, tscene = atrium
    o, d = _ray_sets(res, tscene)[rays]
    r9, jr9 = _rays9(o, d)
    ss = res.recommended_stack_size
    got = kernels.trace_packets_pt(tscene, r9, stack_size=ss)
    _compare(got, trace_packets_pallas_pt(jscene, jr9, stack_size=ss, interpret=True))
    assert (got.tri.numpy() >= 0).mean() > 0.5
    assert np.all(got.overflow.numpy() == 0)
    assert np.all(got.inner_visits.numpy() > 0) and np.all(got.leaf_tests.numpy() > 0)


def test_anyhit_occlusion_matches_jax(atrium):
    """Shadow segments from points in the hall to points on its ceiling
    and walls, as NEE launches them: direction = segment, t_max just
    under 1."""
    res, jscene, tscene = atrium
    rng = np.random.default_rng(9)
    lo, hi = np.asarray(res.arrays.bbox_min), np.asarray(res.arrays.bbox_max)
    o = rng.uniform(lo + 0.5, hi - 0.5, (4, P, 3)).astype(np.float32)
    target = rng.uniform(lo + 0.1, hi - 0.1, (4, P, 3)).astype(np.float32)
    target[..., 1] = np.where(rng.uniform(size=(4, P)) < 0.5, hi[1] - 1e-3, target[..., 1])
    seg = (target - o).astype(np.float32)
    seg[0, :4] = 0.0  # zero segments are never occluded
    inv = np.where(seg == 0.0, np.inf, 1.0 / np.where(seg == 0.0, 1.0, seg)).astype(np.float32)
    r9, jr9 = _rays9(o, seg, inv)
    ss = res.recommended_stack_size
    got = kernels.trace_packets_pt(tscene, r9, stack_size=ss, t_max=_SHADOW_T_MAX, anyhit=True)
    want = trace_packets_pallas_pt(jscene, jr9, stack_size=ss, t_max=_SHADOW_T_MAX, anyhit=True, interpret=True)
    occ = got.tri.numpy() >= 0
    np.testing.assert_array_equal(occ, np.asarray(want.tri) >= 0)
    assert 0.1 < occ.mean() < 0.95 and not occ[0, :4].any()
    # Any-hit finds a hit exactly where closest-hit finds one under t_max.
    closest = kernels.trace_packets_pt(tscene, r9, stack_size=ss, t_max=_SHADOW_T_MAX)
    np.testing.assert_array_equal(occ, closest.tri.numpy() >= 0)
    assert np.all(got.inner_visits.numpy() <= closest.inner_visits.numpy())


def test_roots_and_live_packets_match_jax(atrium):
    """Per-packet roots (the root's child subtrees, and one NULL root) and a
    live-packet prefix given as a tensor."""
    res, jscene, tscene = atrium
    o, d = _ray_sets(res, tscene)["random"]
    r9, jr9 = _rays9(o, d)
    ss = res.recommended_stack_size
    root = int(res.arrays.root)
    children = [c for c in np.asarray(res.arrays.node_child_links)[root >> L.COUNT_BITS] if c != L.NULL_LINK]
    roots = np.array([children[0], children[1 % len(children)], L.NULL_LINK, children[-1]], np.int32)
    live = torch.tensor(3, dtype=torch.int32)
    got = kernels.trace_packets_pt(tscene, r9, stack_size=ss, roots=torch.from_numpy(roots), live_packets=live)
    want = trace_packets_pallas_pt(jscene, jr9, stack_size=ss, interpret=True, roots=jnp.asarray(roots), live_packets=3)
    _compare(got, want, min_match=1.0)
    tri = got.tri.numpy()
    assert np.all(tri[2:] == -1) and np.all(np.isinf(got.t.numpy()[2:]))
    assert np.all(got.inner_visits.numpy()[2:] == 0)
    # A subtree root sees a subset of the whole tree's hits.
    full = kernels.trace_packets_pt(tscene, r9, stack_size=ss).tri.numpy()
    assert (tri[:2] >= 0).any() and (tri[:2] >= 0).sum() <= (full[:2] >= 0).sum()
    # Ints and tensors give the same prefix.
    as_int = kernels.trace_packets_pt(tscene, r9, stack_size=ss, live_packets=1)
    as_tensor = kernels.trace_packets_pt(tscene, r9, stack_size=ss, live_packets=torch.tensor([1]))
    assert torch.equal(as_int.tri, as_tensor.tri) and np.all(as_int.tri.numpy()[1:] == -1)


def _leaf_roots(res, tri):
    """For each packet of ``tri`` (the first hits of a ray set), the leaf
    link whose triangle packets hold that packet's most frequent hit."""
    links = np.asarray(res.arrays.node_child_links).reshape(-1)
    leaves = links[(links != L.NULL_LINK) & ((links & L.COUNT_MASK) != 0)]
    first, count = leaves >> L.COUNT_BITS, leaves & L.COUNT_MASK
    out = []
    for row in tri:
        pk = np.bincount(row[row >= 0] >> 3).argmax()
        out.append(int(leaves[(first <= pk) & (pk < first + count)][0]))
    return out


@pytest.mark.parametrize("anyhit", [False, True], ids=["closest", "anyhit"])
def test_leaf_roots_match_jax(atrium, anyhit):
    """Leaf links as per-packet roots, beside an inner link and a NULL root,
    with a live-packet prefix: the two-level tracer's usual roots. K2 enters
    a leaf root straight into its triangle tests, without a box test."""
    res, jscene, tscene = atrium
    o, d = _ray_sets(res, tscene)["coherent"]
    r9, jr9 = _rays9(o, d)
    ss = res.recommended_stack_size
    first = kernels.trace_packets_pt(tscene, r9, stack_size=ss).tri.numpy()
    leaf = _leaf_roots(res, first)
    root = int(res.arrays.root)
    inner = [int(c) for c in np.asarray(res.arrays.node_child_links)[root >> L.COUNT_BITS]
             if c != L.NULL_LINK and (c & L.COUNT_MASK) == 0]
    # The inner child of the root under which packet 1 finds the most hits.
    hits = [(kernels.trace_packets_pt(tscene, r9[1:2], stack_size=ss, roots=torch.tensor([c])).tri >= 0).sum()
            for c in inner]
    roots = np.array([leaf[0], inner[int(np.argmax(hits))], L.NULL_LINK, leaf[3]], np.int32)
    t_max = 1e3 if anyhit else np.inf
    for live in (None, 3):
        kw = {} if live is None else {"live_packets": live}
        got = kernels.trace_packets_pt(tscene, r9, stack_size=ss, roots=torch.from_numpy(roots), t_max=t_max,
                                       anyhit=anyhit, **{k: torch.tensor(v) for k, v in kw.items()})
        want = trace_packets_pallas_pt(jscene, jr9, stack_size=ss, interpret=True, roots=jnp.asarray(roots),
                                       t_max=t_max, anyhit=anyhit, **kw)
        if anyhit:
            np.testing.assert_array_equal(got.tri.numpy() >= 0, np.asarray(want.tri) >= 0)
        else:
            _compare(got, want)  # a ray on an edge two triangles share is a tie either may win
        tri = got.tri.numpy()
        assert np.all(tri[2] == -1) and (tri[0] >= 0).any() and (tri[1] >= 0).any()
        assert (tri[3] >= 0).any() == (live is None)
        # A leaf root tests only its own triangles, and no inner node.
        pk = tri[0][tri[0] >= 0] >> 3
        assert np.all((pk >= leaf[0] >> L.COUNT_BITS) & (pk < (leaf[0] >> L.COUNT_BITS) + (leaf[0] & L.COUNT_MASK)))
        assert got.inner_visits.numpy()[0] == 0 and got.leaf_tests.numpy()[0] == P * (leaf[0] & L.COUNT_MASK)


def test_empty_scene_misses(atrium):
    res = jax_build_bvh(MeshData())
    scene = kernels.prepare_scene_pt(from_numpy(res.arrays._asdict(), "cpu"))
    assert scene.root == L.NULL_LINK
    assert scene.shade_flat.shape == np.asarray(jax_prepare_scene_pt(res.as_device()).shade_flat).shape
    o, d = _ray_sets(atrium[0], atrium[2])["random"]
    r9, _ = _rays9(o, d)
    for anyhit in (False, True):
        got = kernels.trace_packets_pt(scene, r9, stack_size=8, anyhit=anyhit)
        assert np.all(got.tri.numpy() == -1) and np.all(got.inner_visits.numpy() == 0)


def test_wrong_roots_shape_raises(atrium):
    _, _, tscene = atrium
    r9 = torch.zeros((2, 9, 128))
    with pytest.raises(ValueError, match="roots"):
        kernels.trace_packets_pt(tscene, r9, stack_size=8, roots=torch.zeros(3, dtype=torch.int32))
