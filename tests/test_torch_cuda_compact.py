"""The path tracer's compaction kernels (``csrc/compact.cu``) on the card,
against the plain PyTorch compaction they replace.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package: ``python -m pytest --noconftest -q
tests/test_torch_cuda_compact.py``.

Both versions run on the card over the same state
(``wavefront._compact_kernel`` and ``wavefront._compact_plain``). The key
pass computes the plain version's int32 key with its float32 steps in its
order, and both sort that key with the same ``torch.sort`` call, so the
permutation is the same, ties included; the permute pass then gathers the
same rows. So every field of the returned state agrees bit for bit (NaN
equal to NaN), the permutation read from ``pixel`` among them. The cases
cover both of ``torch.sort``'s algorithms (up to 4,096 keys it sorts in one
block, above that by radix), the first bounce's strided views, the states of
a real chunk at bounces 1-4, and the edges: every lane dead, every lane live,
a non-finite origin.
"""

import pytest
import torch

from minipath_tpu_torch import Camera, TriangleBvh
from minipath_tpu_torch.render import compact
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.render.frame import gen_frame_rays9
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

W, H, S, BOUNCES = 256, 128, 4, 5  # 131,072 lanes a chunk


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def setup(cuda):
    mesh = procedural.make_atrium(20_000)
    ids, dicts = procedural.atrium_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24)
    scene = bvh.pt_scene(cuda)
    table = tm.material_table(dicts, cuda)
    tracer, _ = tw.make_pt_tracer(scene, stack_size=bvh.recommended_stack_size)
    shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=bvh.recommended_stack_size)
    lights = tm.build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    return dict(scene=scene, table=table, tracer=tracer, shadow=shadow, lights=lights)


def _camera():
    return Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


def _frame(s, cuda, nee, seed=11, **kw):
    return tw.render_frame_pt(s["tracer"], s["scene"], s["table"], _camera().build_sampler((W, H), cuda),
                              torch.Generator(device=cuda).manual_seed(seed), width=W, height=H, spp=S,
                              bounces=BOUNCES, samples_per_packet=S, lights=s["lights"] if nee else None,
                              shadow_tracer=s["shadow"] if nee else None, nee_max_depth=1 if nee else None,
                              strat_seed=5, **kw)


def _differ(got: tw._PathState, want: tw._PathState) -> dict:
    """The lanes where each field of ``got`` differs from ``want``'s (NaN
    equals NaN); every lane of a field whose dtype or shape differs."""
    out = {}
    for name in tw._PathState._fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None or g is None:
            out[name] = int((g is None) != (w is None))
            continue
        if g.dtype != w.dtype or g.shape != w.shape:
            out[name] = w.shape[0]
            continue
        same = g == w
        if g.is_floating_point():
            same = same | (torch.isnan(g) & torch.isnan(w))
        if same.dim() > 1:
            same = same.all(dim=-1)
        out[name] = int((~same).sum())
    return out


def _launches():
    """The key and permute launches so far."""
    return compact.key_pass.launches, compact.permute_pass.launches


def _check(name, state, fine):
    key0, permute0 = _launches()
    got = tw._compact_kernel(state, fine)
    torch.cuda.synchronize()
    assert _launches() == (key0 + 1, permute0 + 1)
    want = tw._compact_plain(state, fine)
    differ = _differ(got, want)
    n = state.origin.shape[0]
    perm = got.pixel.long()
    print(f"\nCOMPACT {name} fine={fine} lanes={n} live={int(state.active.sum())} lanes that differ {differ}")
    assert not any(differ.values()), differ
    if state.pixel.equal(torch.arange(n, dtype=torch.int32, device=state.pixel.device)):
        assert torch.equal(torch.sort(perm).values, torch.arange(n, device=perm.device))


@pytest.fixture(scope="module")
def chunk_states(cuda, setup):
    """The states that enter the compaction at bounces 1-4 of one chunk,
    with NEE at the first vertex and without; keyed by ``(nee, bounce)``."""
    states = {}
    real = tw._compact
    for nee in (True, False):
        seen = []

        def capturing(state, fine_direction=True):
            seen.append(state)
            return real(state, fine_direction=fine_direction)

        tw._compact = capturing
        try:
            _frame(setup, cuda, nee)
        finally:
            tw._compact = real
        assert len(seen) == BOUNCES - 1
        states.update({(nee, b + 1): st for b, st in enumerate(seen)})
    return states


@pytest.mark.parametrize("fine", [True, False], ids=["bins", "octants"])
@pytest.mark.parametrize("bounce", [1, 2, 3, 4])
@pytest.mark.parametrize("nee", [True, False], ids=["nee", "bsdf"])
def test_chunk_state_matches_plain(chunk_states, nee, bounce, fine):
    state = chunk_states[nee, bounce]
    assert (state.prev_pdf is not None) == nee
    assert int(state.active.sum()) > 0
    _check(f"chunk bounce {bounce} nee={nee}", state, fine)


@pytest.mark.parametrize("fine", [True, False], ids=["bins", "octants"])
@pytest.mark.parametrize("nee", [True, False], ids=["nee", "bsdf"])
def test_strided_bounce0_views_match_plain(cuda, nee, fine):
    """The first bounce's state: origin, direction and inverse are views of
    one ``(N, 9)`` tensor (row stride 9)."""
    rays9, _ = gen_frame_rays9(_camera().build_sampler((W, H), cuda), torch.Generator(device=cuda).manual_seed(1),
                               width=W, height=H, px_block=(16, 16), samples=S)
    B0, _, P0 = rays9.shape
    N = B0 * P0
    flat = rays9.transpose(1, 2).reshape(N, 9)
    state = tw._PathState(
        origin=flat[:, 0:3], direction=flat[:, 3:6], inv_direction=flat[:, 6:9],
        throughput=torch.rand((N, 3), device=cuda), radiance=torch.rand((N, 3), device=cuda),
        pixel=torch.arange(N, dtype=torch.int32, device=cuda), active=torch.rand(N, device=cuda) < 0.7,
        prev_pdf=torch.rand(N, device=cuda) if nee else None,
    )
    assert state.origin.stride() == (9, 1)
    _check("bounce-0 views", state, fine)


def _random_state(cuda, n, case, nee=True):
    g = torch.Generator(device=cuda).manual_seed(n)
    origin = torch.rand((n, 3), generator=g, device=cuda) * 10.0 - 5.0
    direction = torch.randn((n, 3), generator=g, device=cuda)
    direction = direction / direction.norm(dim=-1, keepdim=True)
    # Axis-aligned directions: zero and negative-zero components, ties
    # between the axes.
    direction[::7, 1] = 0.0
    direction[::11, 2] = -0.0
    direction[::13] = torch.tensor([0.0, -1.0, 0.0], device=cuda)
    direction[::17] = torch.tensor([0.6, 0.0, 0.6], device=cuda)
    active = torch.rand(n, generator=g, device=cuda) < 0.6
    if case == "all_dead":
        active[:] = False
    elif case == "all_live":
        active[:] = True
    elif case == "nan_origin":
        origin[n // 3, 1] = torch.nan
    elif case == "inf_origin":
        origin[n // 3, 0] = torch.inf
        origin[n // 2, 2] = -torch.inf
    return tw._PathState(
        origin=origin, direction=direction, inv_direction=1.0 / direction,
        throughput=torch.rand((n, 3), generator=g, device=cuda), radiance=torch.rand((n, 3), generator=g, device=cuda),
        pixel=torch.arange(n, dtype=torch.int32, device=cuda), active=active,
        prev_pdf=torch.rand(n, generator=g, device=cuda) if nee else None,
    )


@pytest.mark.parametrize("fine", [True, False], ids=["bins", "octants"])
@pytest.mark.parametrize("case", ["random", "all_dead", "all_live", "nan_origin", "inf_origin"])
@pytest.mark.parametrize("n", [3_000, 65_537])
def test_random_state_matches_plain(cuda, n, case, fine):
    """3,000 keys take ``torch.sort``'s one-block sort, 65,537 its radix
    sort; either way the same key gives the same permutation."""
    _check(f"random {case}", _random_state(cuda, n, case), fine)


def test_random_state_without_nee_matches_plain(cuda):
    _check("random without NEE", _random_state(cuda, 65_537, "random", nee=False), True)


def test_frame_equals_the_plain_compaction(cuda, setup, monkeypatch):
    """A whole NEE frame with the kernels' compaction equals, bit for bit,
    the frame with the plain compaction; two kernel launches a compaction."""
    key0, permute0 = _launches()
    img, var = _frame(setup, cuda, True, return_variance=True)
    assert _launches() == (key0 + BOUNCES - 1, permute0 + BOUNCES - 1)
    monkeypatch.setattr(tw, "_compact", tw._compact_plain)
    ref, ref_var = _frame(setup, cuda, True, return_variance=True)
    assert torch.isfinite(img).all() and img[..., :3].mean() > 0
    assert torch.equal(img, ref) and torch.equal(var, ref_var)


def test_compaction_makes_no_host_sync(cuda, setup, monkeypatch):
    """Every compaction of a chunk runs under ``set_sync_debug_mode("error")``:
    a host sync inside it would raise."""
    real, calls = tw._compact, []

    def strict(state, fine_direction=True):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(state, fine_direction=fine_direction)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(fine_direction)
        return out

    tw._compact_kernel(_random_state(cuda, 4096, "random"), True)  # the library loaded
    monkeypatch.setattr(tw, "_compact", strict)
    _frame(setup, cuda, True)
    assert calls == [True] + [False] * (BOUNCES - 2)


def test_kernel_lanes_counter_equals_lanes_compacted(cuda, setup):
    profiling.take()
    profiling.enable()
    try:
        _frame(setup, cuda, True)
        rec = profiling.take()
    finally:
        profiling.disable()
    lanes = W * H * S
    assert rec.counters["pt.lanes"] == lanes * BOUNCES
    assert rec.counters["pt.compaction_kernel_lanes"] == lanes * (BOUNCES - 1)
