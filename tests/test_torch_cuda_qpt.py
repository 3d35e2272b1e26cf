"""The path tracer's kernel routes over the 16-bit quantized layout
(``QPTScene``: K3's lean closest-hit and any-hit) on the card, against their
plain PyTorch routes.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package: ``python -m pytest --noconftest -q
tests/test_torch_cuda_qpt.py``.

The shading (``csrc/shade.cu``), compaction (``csrc/compact.cu``) and NEE
shadow-batch (``csrc/shadow.cu``, its packed rows traced by K3's any-hit)
routes were held to their plain routes over the f32 ``PTScene`` (K2); here
the same holds over a ``QPTScene``. Every call of each kernel route in a
frame is run beside its plain route on the same inputs, and the two agree
bit for bit (NaN equal to NaN); a whole frame through the kernel routes
equals the frame with the plain routes put in their place. The quantized
scene's shading table, built on the card from the host arrays, is the table
built from the whole f32 arrays on the card, and no f32 arrays stay there.
"""

import pytest
import torch

from minipath_tpu_torch import Camera, TriangleBvh
from minipath_tpu_torch.render import compact, kernels, kernels_q, shade
from minipath_tpu_torch.render import shadow as shadow_passes
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural

pytestmark = pytest.mark.cuda

W, H, S, BOUNCES = 256, 128, 4, 5  # 131,072 lanes a chunk, one chunk a frame


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def setup(cuda):
    mesh = procedural.make_atrium(20_000)
    ids, dicts = procedural.atrium_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24, layout="q16")
    scene = bvh.pt_scene(cuda)
    assert isinstance(scene, kernels_q.QPTScene)
    table = tm.material_table(dicts, cuda)
    tracer, _ = tw.make_pt_tracer(scene, stack_size=bvh.recommended_stack_size)
    shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=bvh.recommended_stack_size)
    lights = tm.build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    camera = Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)
    return dict(bvh=bvh, scene=scene, table=table, tracer=tracer, shadow=shadow, lights=lights, camera=camera)


def _frame(s, cuda, seed=11):
    return tw.render_frame_pt(s["tracer"], s["scene"], s["table"], s["camera"].build_sampler((W, H), cuda),
                              torch.Generator(device=cuda).manual_seed(seed), width=W, height=H, spp=S,
                              bounces=BOUNCES, env=tm.Environment.sky(cuda), samples_per_packet=S,
                              lights=s["lights"], shadow_tracer=s["shadow"], nee_max_depth=1, strat_seed=5,
                              return_variance=True)


def _same(got, want):
    """Whether two tensors (or two Nones) agree element for element, NaN
    equal to NaN."""
    if got is None or want is None:
        return got is None and want is None
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    same = got == want
    if got.is_floating_point():
        same = same | (torch.isnan(got) & torch.isnan(want))
    return bool(same.all())


def _differ(got, want, fields, mask=None):
    """The fields of ``got`` that differ from ``want``'s. With ``mask``, on
    its lanes and by value: the NEE query's light index is int32 from the
    kernel and int64 from ``torch.searchsorted``."""
    def pick(x, like):
        return x if x is None or mask is None else x[mask].to(like.dtype)

    return [name for name in fields
            if not _same(pick(getattr(got, name), getattr(want, name)), pick(getattr(want, name), getattr(want, name)))]


def test_each_shading_call_matches_plain(cuda, setup, monkeypatch):
    """Every bounce of a frame over the ``QPTScene``: the kernel's next
    state on every lane and its NEE query (the candidates on every lane, the
    segment and what it adds on each candidate) against the plain version's,
    from the same generator state, on the same K3 hits."""
    seen, real = [], tw._shade_kernel

    def both(state, kh, materials, env, lights, generator, **kw):
        twin = torch.Generator(device=cuda)
        twin.set_state(generator.get_state())
        want, want_q = tw._shade_plain(state, kh, materials, env, lights, twin, **kw)
        got, got_q = real(state, kh, materials, env, lights, generator, **kw)
        differ = _differ(got, want, tw._PathState._fields)
        if (got_q is None) != (want_q is None):
            differ.append("nee")
        elif want_q is not None:
            differ += [f"nee.{n}" for n in _differ(got_q, want_q, ("cand",))]
            fields = [n for n in tw._ShadowQuery._fields if n != "cand"]
            differ += [f"nee.{n}" for n in _differ(got_q, want_q, fields, want_q.cand)]
        if not torch.equal(generator.get_state(), twin.get_state()):
            differ.append("generator")
        seen.append((kw["bounce"], int(state.active.sum()), differ))
        return got, got_q

    monkeypatch.setattr(tw, "_shade_kernel", both)
    before = shade.launch.launches
    _frame(setup, cuda)
    print(f"\nSHADE over QPTScene: {seen}")
    assert shade.launch.launches == before + BOUNCES
    assert [b for b, _, _ in seen] == list(range(BOUNCES)) and all(n > 0 for _, n, _ in seen)
    assert not any(d for _, _, d in seen), seen


def test_each_compaction_matches_plain(cuda, setup, monkeypatch):
    """Every compaction of a frame over the ``QPTScene`` (bounces 1-4),
    every field of the next state, the permutation in ``pixel`` among
    them."""
    seen, real = [], tw._compact_kernel

    def both(state, fine_direction=True):
        want = tw._compact_plain(state, fine_direction)
        got = real(state, fine_direction)
        seen.append((int(want.active.sum()), _differ(got, want, tw._PathState._fields)))
        return got

    monkeypatch.setattr(tw, "_compact_kernel", both)
    before = compact.key_pass.launches
    _frame(setup, cuda)
    print(f"\nCOMPACT over QPTScene: {seen}")
    assert compact.key_pass.launches == before + BOUNCES - 1 and len(seen) == BOUNCES - 1
    assert not any(d for _, d in seen), seen


def test_the_shadow_batch_matches_plain(cuda, setup, monkeypatch):
    """The NEE bounce's shadow batch over the ``QPTScene``: the kernel
    route's packed rows traced by K3's any-hit, and the radiance it returns,
    against the plain route's segments traced by K3's any-hit."""
    seen, real = [], tw._shadow_light_kernel

    def both(tracer_state, query, radiance, shadow_tracer):
        want = tw._shadow_light_plain(tracer_state, query, radiance.clone(), shadow_tracer, "pos")
        got = real(tracer_state, query, radiance, shadow_tracer)
        seen.append((int(query.cand.sum()), _same(got, want)))
        return got

    monkeypatch.setattr(tw, "_shadow_light_kernel", both)
    before = shadow_passes.pack_pass.launches, kernels_q.trace_packets_q.launches["anyhit"]
    _frame(setup, cuda)
    print(f"\nSHADOW over QPTScene: {seen}")
    assert len(seen) == 1 and seen[0][0] > 1000 and seen[0][1], seen
    # One pack pass, and K3's any-hit twice: the kernel route's and the plain route's.
    assert (shadow_passes.pack_pass.launches, kernels_q.trace_packets_q.launches["anyhit"]) == (
        before[0] + 1, before[1] + 2)


def test_frame_equals_the_plain_routes(cuda, setup, monkeypatch):
    """A whole NEE frame over the ``QPTScene`` through the shading,
    compaction and shadow-batch kernels equals the frame with the three
    plain routes, bit for bit; K3 only, in its lean modes."""
    modes = dict(kernels_q.trace_packets_q.launches)
    k2 = dict(kernels.trace_packets_pt.launches)
    img, var = _frame(setup, cuda)
    got = {m: kernels_q.trace_packets_q.launches[m] - modes[m] for m in modes}
    assert got == {"full": 0, "closest": BOUNCES, "anyhit": 1} and kernels.trace_packets_pt.launches == k2
    monkeypatch.setattr(tw, "_shade_kernel", tw._shade_plain)
    monkeypatch.setattr(tw, "_compact_kernel", tw._compact_plain)
    monkeypatch.setattr(tw, "_shadow_light", tw._shadow_light_plain)
    ref, ref_var = _frame(setup, cuda)
    assert torch.isfinite(img).all() and img[..., :3].mean() > 0
    exact = (img == ref).all(dim=-1).float().mean().item()
    print(f"\nFRAME over QPTScene: pixels equal {exact:.6f}")
    assert torch.equal(img, ref) and torch.equal(var, ref_var)


def test_the_shading_table_on_the_card(cuda, setup):
    """The table built on the card from the host arrays' six fields is, bit
    for bit, the table built from the whole f32 ``BvhArrays`` on the card;
    the tree keeps no f32 arrays there."""
    bvh = setup["bvh"]
    assert bvh._device_arrays == {}
    want = kernels.build_shade_flat(bvh.build_result.as_device(cuda))
    got = setup["scene"].shade_flat
    assert got.device == want.device and got.dtype == want.dtype == torch.float16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert bvh._device_arrays == {}
