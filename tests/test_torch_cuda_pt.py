"""The CUDA lean trace (K2) and the path tracer on the card, against their
plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package: ``python -m pytest --noconftest -q
tests/test_torch_cuda_pt.py``.

K2 and its plain version take the same IEEE steps in the same order (the
library is built with ``-fmad=false``), so ``t``, ``tri``, ``u``, ``v`` and
the counters agree exactly in closest-hit mode, and any-hit mode returns the
same triangle. A Sobol frame on the card and on the CPU agrees within 1e-3
on at least 99% of pixels (torch's float32 math on the two devices rounds
``sin``, ``cos``, ``exp`` and ``log`` differently).
"""

import pytest
import torch

from minipath_tpu_torch import Camera, TriangleBvh
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh import links as L

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def atrium():
    mesh = procedural.make_atrium(20_000)
    ids, dicts = procedural.atrium_materials(mesh)
    return TriangleBvh.build(mesh, materials=ids, leaf_max=24), dicts


def _camera():
    return Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


def _bounce_rays(atrium, device, B=16, P=2048, seed=0):
    """Camera rays, traced once and scattered off their hits as the bounce
    loop does (a miss keeps its ray): bounce-1 rays in the kernel's
    layout."""
    from minipath_tpu_torch.render.frame import gen_frame_rays9

    bvh, dicts = atrium
    scene = bvh.pt_scene(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    w, h = 256, B * P // 256
    rays9, _ = gen_frame_rays9(_camera().build_sampler((w, h), device), gen, width=w, height=h,
                               px_block=(16, 16), samples=1)
    flat = rays9.transpose(1, 2).reshape(-1, 9)
    o, d = flat[:, 0:3], flat[:, 3:6]
    tracer, _ = tw.make_pt_tracer(scene, stack_size=bvh.recommended_stack_size)
    kh = tracer(scene, o, d, flat[:, 6:9])
    new_dir, *_ = tw.scatter_full(tm.material_table(dicts, device), gen, d, kh.normal, kh.material)
    nf = torch.where((d * kh.normal).sum(-1, keepdim=True) < 0, kh.normal, -kh.normal)
    hit = (kh.tri >= 0)[:, None]
    o = torch.where(hit, o + d * kh.t[:, None] + nf * 1e-3, o)
    d = torch.where(hit, new_dir, d)
    r9, _, _ = tw._pack_rays9(P, None, o, d, 1.0 / d)
    return r9


def _assert_same(got, want):
    for name in ("t", "tri", "u", "v", "overflow", "inner_visits", "leaf_tests"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_closest_hit_matches_plain_version(cuda, atrium):
    bvh, _ = atrium
    scene = bvh.pt_scene(cuda)
    r9 = _bounce_rays(atrium, cuda)
    ss = bvh.recommended_stack_size
    before = dict(kernels.trace_packets_pt.launches)
    got = kernels.trace_packets_pt(scene, r9, stack_size=ss)
    torch.cuda.synchronize()
    assert kernels.trace_packets_pt.launches["closest"] == before["closest"] + 1
    want = kernels.trace_packets_pt_reference(scene, r9, stack_size=ss)
    _assert_same(got, want)
    assert (got.tri >= 0).float().mean().item() > 0.5 and int(got.overflow.sum()) == 0


def test_anyhit_and_live_count_match_plain_version(cuda, atrium):
    bvh, _ = atrium
    scene = bvh.pt_scene(cuda)
    r9 = _bounce_rays(atrium, cuda, B=8, seed=1)
    # Shadow segments of length 4 along the bounce directions.
    seg = r9[:, 3:6] * 4.0
    s9 = torch.cat([r9[:, 0:3], seg, 1.0 / seg], dim=1).contiguous()
    ss = bvh.recommended_stack_size
    live = torch.tensor([5], dtype=torch.int32, device=cuda)
    before = kernels.trace_packets_pt.launches["anyhit"]
    got = kernels.trace_packets_pt(scene, s9, stack_size=ss, t_max=tw._SHADOW_T_MAX, anyhit=True, live_packets=live)
    assert kernels.trace_packets_pt.launches["anyhit"] == before + 1
    want = kernels.trace_packets_pt_reference(scene, s9, stack_size=ss, t_max=tw._SHADOW_T_MAX, anyhit=True,
                                              live_packets=live)
    _assert_same(got, want)
    occ = got.tri >= 0
    assert 0.05 < occ[:5].float().mean().item() < 0.95 and not occ[5:].any()


def test_roots_match_plain_version(cuda, atrium):
    bvh, _ = atrium
    scene = bvh.pt_scene(cuda)
    r9 = _bounce_rays(atrium, cuda, B=8, seed=2)
    links = bvh.host_arrays.node_child_links[int(bvh.host_arrays.root) >> L.COUNT_BITS]
    children = [int(c) for c in links if c != L.NULL_LINK]
    roots = torch.tensor([children[i % len(children)] for i in range(7)] + [L.NULL_LINK], dtype=torch.int32,
                         device=cuda)
    ss = bvh.recommended_stack_size
    got = kernels.trace_packets_pt(scene, r9, stack_size=ss, roots=roots)
    _assert_same(got, kernels.trace_packets_pt_reference(scene, r9, stack_size=ss, roots=roots))
    assert torch.all(got.tri[7] == -1) and (got.tri[:7] >= 0).any()


def _leaf_roots(bvh, tri):
    """For each packet of ``tri`` (the first hits of a ray set), the leaf
    link whose triangle packets hold that packet's most frequent hit."""
    links = bvh.host_arrays.node_child_links.reshape(-1)
    leaves = links[(links != L.NULL_LINK) & ((links & L.COUNT_MASK) != 0)]
    first, count = leaves >> L.COUNT_BITS, leaves & L.COUNT_MASK
    out = []
    for row in tri:
        pk = torch.bincount(row[row >= 0] >> 3).argmax().item()
        out.append(int(leaves[(first <= pk) & (pk < first + count)][0]))
    return out


@pytest.mark.parametrize("mode", ["closest", "anyhit", "live_packets"])
def test_leaf_roots_match_plain_version(cuda, atrium, mode):
    """Leaf links as per-packet roots, as the two-level tracer makes them,
    beside inner links and a NULL root: K2 enters a leaf root straight into
    its triangle tests."""
    bvh, _ = atrium
    scene = bvh.pt_scene(cuda)
    r9 = _bounce_rays(atrium, cuda, B=8, seed=5)
    ss = bvh.recommended_stack_size
    leaf = _leaf_roots(bvh, kernels.trace_packets_pt(scene, r9, stack_size=ss).tri.cpu())
    links = bvh.host_arrays.node_child_links[int(bvh.host_arrays.root) >> L.COUNT_BITS]
    inner = [int(c) for c in links if c != L.NULL_LINK and (c & L.COUNT_MASK) == 0]
    roots = torch.tensor([leaf[0], leaf[1], inner[0], leaf[3], L.NULL_LINK, leaf[5], leaf[6], inner[-1]],
                         dtype=torch.int32, device=cuda)
    kw = {"anyhit": mode == "anyhit"}
    if mode == "live_packets":
        kw["live_packets"] = torch.tensor([6], dtype=torch.int32, device=cuda)
    got = kernels.trace_packets_pt(scene, r9, stack_size=ss, roots=roots, **kw)
    _assert_same(got, kernels.trace_packets_pt_reference(scene, r9, stack_size=ss, roots=roots, **kw))
    is_leaf = torch.tensor([1, 1, 0, 1, 0, 1, 1, 0], dtype=torch.bool, device=cuda)
    live = torch.arange(8, device=cuda) < (6 if mode == "live_packets" else 8)
    assert torch.all(got.inner_visits[is_leaf] == 0)
    assert torch.all((got.leaf_tests[is_leaf & live] > 0)) and (got.tri[[0, 1, 3, 5]] >= 0).any(dim=1).all()
    assert torch.all(got.tri[4] == -1) and torch.all(got.tri[~live] == -1)


def test_twolevel_tracer_on_card(cuda, atrium):
    """The two-level tracer on the card: the CPU's result (K2 bit for bit
    with its plain version), the flat tracer's hits, ``rounds + 1`` K2
    launches, and no host sync in a warm trace."""
    from minipath_tpu_torch.render.twolevel import build_treelets, make_pt_tracer_twolevel

    bvh, _ = atrium
    r9 = _bounce_rays(atrium, cuda, B=8, seed=6)
    flat = r9.transpose(1, 2).reshape(-1, 9)
    n_live = flat.shape[0] * 3 // 4

    def trace(device, sync_check=False):
        scene = bvh.pt_scene(device)
        tracer, _ = make_pt_tracer_twolevel(scene, build_treelets(bvh.host_arrays, 2, device=device),
                                            stack_size=bvh.recommended_stack_size, rounds=2)
        f = flat.to(device)
        live = torch.tensor([n_live], dtype=torch.int32, device=device)
        tracer(scene, f[:, 0:3], f[:, 3:6], f[:, 6:9], live)
        if not sync_check:
            return tracer(scene, f[:, 0:3], f[:, 3:6], f[:, 6:9], live)
        torch.cuda.synchronize()
        before = kernels.trace_packets_pt.launches["closest"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = tracer(scene, f[:, 0:3], f[:, 3:6], f[:, 6:9], live)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert kernels.trace_packets_pt.launches["closest"] == before + 3
        return out

    got = trace(cuda, sync_check=True)
    want = trace("cpu")
    for name in ("t", "tri", "material", "overflow", "inner_visits", "leaf_tests"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    torch.testing.assert_close(got.normal.cpu(), want.normal, rtol=0, atol=1e-6)
    scene = bvh.pt_scene(cuda)
    tracer, _ = tw.make_pt_tracer(scene, stack_size=bvh.recommended_stack_size)
    ref = tracer(scene, flat[:, 0:3], flat[:, 3:6], flat[:, 6:9], n_live)
    same = (got.tri == ref.tri)[:n_live].float().mean().item()
    assert same >= 0.999 and bool((got.tri[n_live:] == -1).all()) and int(got.overflow) == 0


def _tie_scene_and_rays(device, B=8):
    from minipath_tpu_torch.geometry.ray import make_rays

    bvh = TriangleBvh.build(procedural.make_tie_lattice(), leaf_max=8)
    o, d = procedural.tie_lattice_rays(count=B * 256, seed=4)
    rays = make_rays(torch.from_numpy(o).view(B, 256, 3).to(device), torch.from_numpy(d).view(B, 256, 3).to(device))
    return bvh, kernels.rays_to_rays9(rays)


@pytest.mark.parametrize("stack_size", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("anyhit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("scene_name", ["ties", "atrium"])
def test_small_stacks_and_exact_ties_match_bit_for_bit(cuda, atrium, scene_name, anyhit, stack_size):
    """Duplicated boxes, coplanar duplicate triangles and stacks that
    overflow, with per-packet roots and with a live prefix: what the
    ordered push, the nearest child kept in registers and the inner-first
    loop could break unseen elsewhere."""
    if scene_name == "ties":
        bvh, r9 = _tie_scene_and_rays(cuda)
    else:
        bvh, r9 = atrium[0], _bounce_rays(atrium, cuda, B=8, P=256, seed=3)
    scene = bvh.pt_scene(cuda)
    links = bvh.host_arrays.node_child_links[int(bvh.host_arrays.root) >> L.COUNT_BITS]
    children = [int(c) for c in links if c != L.NULL_LINK]
    B = r9.shape[0]
    roots = torch.tensor([children[i % len(children)] for i in range(B - 1)] + [L.NULL_LINK], dtype=torch.int32,
                         device=cuda)
    live = torch.tensor([5], dtype=torch.int32, device=cuda)
    for kw in ({}, {"roots": roots}, {"live_packets": live}, {"t_max": 2.5}, {"roots": roots, "live_packets": 3}):
        got = kernels.trace_packets_pt(scene, r9, stack_size=stack_size, anyhit=anyhit, **kw)
        want = kernels.trace_packets_pt_reference(scene, r9, stack_size=stack_size, anyhit=anyhit, **kw)
        _assert_same(got, want)
    if stack_size <= 2:
        assert int(kernels.trace_packets_pt(scene, r9, stack_size=stack_size).overflow.sum()) > 0


def test_sobol_frame_on_card_matches_cpu(cuda, atrium):
    bvh, dicts = atrium
    kw = dict(width=32, height=32, spp=4, bounces=3, samples_per_packet=4, sobol=True, shadow_rr=False,
              strat_seed=77)

    def frame(device):
        scene = bvh.pt_scene(device)
        table = tm.material_table(dicts, device)
        tracer, _ = tw.make_pt_tracer(scene, stack_size=bvh.recommended_stack_size)
        shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=bvh.recommended_stack_size)
        lights = tm.build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
        return tw.render_frame_pt(tracer, scene, table, _camera().build_sampler((32, 32), device), None,
                                  lights=lights, shadow_tracer=shadow, **kw).cpu()

    before = dict(kernels.trace_packets_pt.launches)
    got = frame(cuda)
    assert all(kernels.trace_packets_pt.launches[m] > before[m] for m in before)
    want = frame("cpu")
    assert torch.isfinite(got).all()
    close = ((got - want).abs().amax(dim=-1) <= 1e-3).float().mean().item()
    assert close >= 0.99, close
    torch.testing.assert_close(got[..., :3].mean(), want[..., :3].mean(), rtol=5e-3, atol=0)


@pytest.mark.parametrize("layout", ["f32", "quantized"])
def test_portable_tracers_match_kernels(cuda, atrium, layout):
    """The portable engine (``make_portable_tracer``, pure torch, no code in
    common with the kernels) against K2 over the f32 layout and K3 in lean
    mode over the quantized one, on bounce-1 rays and on shadow segments:
    the same triangles (K3's quantized vertices may move a hit on at most
    0.5% of rays), ``t`` within 1e-5 relative plus 1e-6 where the triangle
    is the same (the engine's torch ops on the card contract multiply-adds
    that K2, built with ``-fmad=false``, rounds one by one: a last-bit
    difference of a term of order 1, which a hit 2e-3 from a bounce ray's
    origin turns into 2e-5 relative) (for K3 ``tools/parity_big.py``'s rule, the 99th percentile of the
    difference below 5e-3 of ``max(t, 1)``: bounce rays start 1e-3 off a
    surface, where the quantized vertices' absolute error dominates), the
    same occlusion (99.5% for K3)."""
    bvh, _ = atrium
    scene = bvh.pt_scene(cuda) if layout == "f32" else bvh.quantized_pt_scene(cuda)
    ss = bvh.recommended_stack_size
    flat = _bounce_rays(atrium, cuda, B=4, seed=7).transpose(1, 2).reshape(-1, 9)
    o, d, inv = flat[:, 0:3], flat[:, 3:6], flat[:, 6:9]
    arrays = bvh.arrays(cuda)
    want = tw.make_portable_tracer(arrays, stack_size=ss)[0](arrays, o, d, inv)
    got = tw.make_pt_tracer(scene, stack_size=ss)[0](scene, o, d, inv)
    same = got.tri == want.tri
    share = 1.0 if layout == "f32" else 0.995
    assert same.float().mean().item() >= share
    hit = same & (want.tri >= 0)
    assert hit.float().mean().item() > 0.5
    if layout == "f32":
        torch.testing.assert_close(got.t[hit], want.t[hit], rtol=1e-5, atol=1e-6)
    else:
        rel = (got.t[hit] - want.t[hit]).abs() / want.t[hit].clamp_min(1.0)
        assert torch.quantile(rel, 0.99).item() < 5e-3
    seg = d * 4.0
    occ_want = tw.make_portable_shadow_tracer(arrays, stack_size=ss)[0](arrays, o, seg)
    occ_got = tw.make_pt_shadow_tracer(scene, stack_size=ss)[0](scene, o, seg)
    assert (occ_got == occ_want).float().mean().item() >= share
    assert 0.05 < occ_want.float().mean().item() < 0.95
