"""The NEE shadow batch's kernels (``csrc/shadow.cu``) on the card, against
the plain PyTorch shadow batch they replace.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package: ``python -m pytest --noconftest -q
tests/test_torch_cuda_shadow.py``.

Both routes run on the card over the same query and radiance
(``wavefront._shadow_light_kernel`` and ``wavefront._shadow_light_plain``).
The key pass computes ``shadow_sort_key(..., "pos")`` with its float32 steps
in its order, and both sort that key with the same ``torch.sort`` call, so
the permutation is the same, ties included; the pack pass then writes the
live packets' rows as ``_pack_rays9(_shadow_batch(...))`` writes them, K2
traces the same packets, and the resolve pass adds the same light. So the
key, the counts, the live packets' rows and the radiance agree bit for bit
(NaN equal to NaN). The cases: the queries of bounces 0-6 of a two-rooms
chunk (NEE at every vertex) and of bounce 0 of an atrium chunk; random
queries of 3,000 lanes (``torch.sort``'s one-block sort) and 65,537 (its
radix sort), neither a multiple of the packet, with no candidate, every lane
a candidate, zero segment components and a non-finite candidate origin.
"""

import pytest
import torch

from minipath_tpu_torch import Camera, TriangleBvh
from minipath_tpu_torch.render import shadow as shadow_passes
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

W, H, S = 256, 128, 4  # 131,072 lanes a chunk
TWOROOMS_BOUNCES, ATRIUM_BOUNCES = 7, 5
PASSES = ("box_pass", "key_pass", "pack_pass", "resolve_pass")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _parts(cuda, mesh, ids, dicts):
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24)
    scene = bvh.pt_scene(cuda)
    table = tm.material_table(dicts, cuda)
    tracer, _ = tw.make_pt_tracer(scene, stack_size=bvh.recommended_stack_size)
    shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=bvh.recommended_stack_size)
    lights = tm.build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    return dict(scene=scene, table=table, tracer=tracer, shadow=shadow, lights=lights)


@pytest.fixture(scope="module")
def tworooms(cuda):
    mesh = procedural.make_tworooms(20_000)
    ids, dicts = procedural.tworooms_materials(mesh)
    parts = _parts(cuda, mesh, ids, dicts)
    camera = Camera().look_at((-4.0, 2.0, 0.0), (0.0, 1.5, 0.0)).f_number(8.0).sensor_width(36e-3)
    return dict(parts, camera=camera, env=tm.Environment.none(cuda), bounces=TWOROOMS_BOUNCES, nee_max_depth=None)


@pytest.fixture(scope="module")
def atrium(cuda):
    mesh = procedural.make_atrium(20_000)
    ids, dicts = procedural.atrium_materials(mesh)
    parts = _parts(cuda, mesh, ids, dicts)
    camera = Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)
    return dict(parts, camera=camera, env=None, bounces=ATRIUM_BOUNCES, nee_max_depth=1)


def _frame(s, cuda, seed=11, **kw):
    return tw.render_frame_pt(s["tracer"], s["scene"], s["table"], s["camera"].build_sampler((W, H), cuda),
                              torch.Generator(device=cuda).manual_seed(seed), width=W, height=H, spp=S,
                              bounces=s["bounces"], env=s["env"], samples_per_packet=S, lights=s["lights"],
                              shadow_tracer=s["shadow"], nee_max_depth=s["nee_max_depth"], strat_seed=5, **kw)


def _queries(s, cuda):
    """The NEE queries of one chunk and the radiance each meets, in bounce
    order."""
    seen, real = [], tw._shadow_light

    def capturing(tracer_state, query, radiance, shadow_tracer, shadow_sort):
        seen.append((query, radiance.clone()))
        return real(tracer_state, query, radiance, shadow_tracer, shadow_sort)

    tw._shadow_light = capturing
    try:
        _frame(s, cuda)
    finally:
        tw._shadow_light = real
    return seen


def _same(got, want):
    """Whether two tensors agree element for element, NaN equal to NaN."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    same = got == want
    if got.is_floating_point():
        same = same | (torch.isnan(got) & torch.isnan(want))
    return bool(same.all())


def _launches():
    return tuple(getattr(shadow_passes, name).launches for name in PASSES)


def _check(name, s, query, radiance):
    """Both routes over ``query`` and ``radiance``: the kernel route's key,
    counts, live packets' rows, radiance and blocked count against the plain
    route's."""
    shadow, scene = s["shadow"], s["scene"]
    P = shadow.packet_size
    fields, real = {}, {n: getattr(shadow_passes, n) for n in PASSES}

    def recording(pass_name):
        def launch(dev, **f):
            fields[pass_name] = f
            return real[pass_name](dev, **f)
        return launch

    before = _launches()
    try:
        for n in PASSES:
            setattr(shadow_passes, n, recording(n))
        got = tw._shadow_light_kernel(scene, query, radiance.clone(), shadow)
    finally:
        for n in PASSES:
            setattr(shadow_passes, n, real[n])
    torch.cuda.synchronize()
    assert _launches() == tuple(b + 1 for b in before)

    cand = query.cand
    N = cand.shape[0]
    key = tw.shadow_sort_key(cand, query.origin, query.wi, query.light, "pos")
    o_s, s_s, n_cand, order = tw._shadow_batch(cand, query.origin, query.segment, query.wi, query.light, "pos")
    inv = torch.where(s_s == 0.0, torch.full_like(s_s, torch.inf), 1.0 / s_s)
    rays, live, _ = tw._pack_rays9(P, n_cand, o_s, s_s, inv)
    counts = fields["box_pass"]["counts"]
    live_packets = int(live)
    occluded = torch.empty_like(cand)
    occluded[order] = shadow(scene, o_s, s_s, n_cand)
    want = tw._shadow_light_plain(scene, query, radiance.clone(), shadow, "pos")
    print(f"\nSHADOW {name}: lanes {N}, candidates {int(n_cand)}, live packets {live_packets}, "
          f"blocked {int((cand & occluded).sum())}")
    assert _same(fields["key_pass"]["key"], key)
    assert int(counts[0]) == int(n_cand) and int(counts[1]) == live_packets
    assert int(counts[2]) == int((cand & occluded).sum())
    assert fields["pack_pass"]["rays"].shape == rays.shape
    assert _same(fields["pack_pass"]["rays"][:live_packets], rays[:live_packets])
    assert _same(got, want)


@pytest.fixture(scope="module")
def tworooms_queries(cuda, tworooms):
    queries = _queries(tworooms, cuda)
    assert len(queries) == TWOROOMS_BOUNCES
    return queries


@pytest.mark.parametrize("bounce", range(TWOROOMS_BOUNCES))
def test_tworooms_chunk_queries_match_plain(tworooms, tworooms_queries, bounce):
    query, radiance = tworooms_queries[bounce]
    assert int(query.cand.sum()) > 0
    _check(f"two rooms, bounce {bounce}", tworooms, query, radiance)


def test_atrium_chunk_query_matches_plain(cuda, atrium):
    queries = _queries(atrium, cuda)
    assert len(queries) == 1
    _check("atrium, bounce 0", atrium, *queries[0])


def _random_query(cuda, n, case):
    g = torch.Generator(device=cuda).manual_seed(n)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=cuda)

    # Points across both rooms, segments to the panel's neighbourhood.
    origin = rand(n, 3) * torch.tensor([16.0, 5.5, 7.0], device=cuda) - torch.tensor([8.0, 0.0, 3.5], device=cuda)
    target = rand(n, 3) * 2.0 + torch.tensor([5.0, 4.5, -1.0], device=cuda)
    segment = target - origin
    segment[::7, 1] = 0.0
    segment[::11, 2] = -0.0
    wi = segment / segment.norm(dim=-1, keepdim=True)
    cand = rand(n) < 0.4
    if case == "none":
        cand[:] = False
    elif case == "all":
        cand[:] = True
    elif case == "nan_origin":
        cand[n // 3] = True
        origin[n // 3, 1] = torch.nan
    elif case == "inf_origin":
        cand[n // 3] = cand[n // 2] = True
        origin[n // 3, 0] = torch.inf
        origin[n // 2, 2] = -torch.inf
    zero = torch.zeros_like(origin)
    query = tw._ShadowQuery(
        cand=cand, origin=torch.where(cand[:, None], origin, zero), segment=torch.where(cand[:, None], segment, zero),
        wi=torch.where(cand[:, None], wi, zero), light=torch.zeros(n, dtype=torch.int32, device=cuda),
        contrib=torch.where(cand[:, None], rand(n, 3), zero),
    )
    return query, rand(n, 3)


@pytest.mark.parametrize("case", ["random", "none", "all", "nan_origin", "inf_origin"])
@pytest.mark.parametrize("n", [3_000, 65_537])
def test_random_query_matches_plain(cuda, tworooms, n, case):
    """3,000 keys take ``torch.sort``'s one-block sort, 65,537 its radix
    sort; neither is a multiple of the 2,048-lane packet."""
    assert n % tworooms["shadow"].packet_size
    _check(f"random {case}", tworooms, *_random_query(cuda, n, case))


@pytest.mark.parametrize("scene", ["tworooms", "atrium"])
def test_frame_equals_the_plain_shadow_batch(cuda, scene, request, monkeypatch):
    """A whole NEE frame through the kernels equals, bit for bit, the frame
    with the plain shadow batch; four passes a NEE bounce."""
    s = request.getfixturevalue(scene)
    nee_bounces = s["bounces"] if s["nee_max_depth"] is None else s["nee_max_depth"]
    before = _launches()
    img, var = _frame(s, cuda, return_variance=True)
    assert _launches() == tuple(b + nee_bounces for b in before)
    monkeypatch.setattr(tw, "_shadow_light", tw._shadow_light_plain)
    ref, ref_var = _frame(s, cuda, return_variance=True)
    assert torch.isfinite(img).all() and img[..., :3].mean() > 0
    assert torch.equal(img, ref) and torch.equal(var, ref_var)


def test_shadow_batch_makes_no_host_sync(cuda, tworooms, monkeypatch):
    """Every shadow batch of a chunk runs under ``set_sync_debug_mode("error")``:
    a host sync inside it would raise."""
    real, calls = tw._shadow_light, []

    def strict(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(1)
        return out

    query, radiance = _random_query(cuda, 4096, "random")
    tw._shadow_light_kernel(tworooms["scene"], query, radiance, tworooms["shadow"])  # the libraries loaded
    monkeypatch.setattr(tw, "_shadow_light", strict)
    _frame(tworooms, cuda)
    assert len(calls) == TWOROOMS_BOUNCES


def test_counters(cuda, tworooms, monkeypatch):
    """``pt.shadow_kernel_lanes`` is N a NEE bounce (``pt.lanes``, NEE at
    every vertex); ``pt.shadow_rays`` and ``pt.shadow_occluded`` equal the
    plain route's."""
    counters = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(tw, "_shadow_light", tw._shadow_light_plain)
        profiling.take()
        profiling.enable()
        try:
            _frame(tworooms, cuda)
            counters[route] = profiling.take().counters
        finally:
            profiling.disable()
    got, want = counters["kernel"], counters["plain"]
    assert got["pt.shadow_kernel_lanes"] == got["pt.lanes"] == W * H * S * TWOROOMS_BOUNCES
    assert "pt.shadow_kernel_lanes" not in want
    assert got["pt.shadow_rays"] == want["pt.shadow_rays"] > 0
    assert got["pt.shadow_occluded"] == want["pt.shadow_occluded"] > 0
