"""The path tracer's bounce-shading kernel (``csrc/shade.cu``) on the card,
against the plain PyTorch shading it replaces.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package: ``python -m pytest --noconftest -q
tests/test_torch_cuda_shade.py``.

Both versions run on the card over the same hits, state and generator seed
(``wavefront._shade_kernel`` and ``wavefront._shade_plain``). The kernel
draws the plain version's uniforms, in its order, before it launches, so the
two see the same numbers. Its arithmetic is the plain version's, op for op,
rounded as PyTorch's CUDA kernels round it (the library is built with
``-fmad=false``, and the kernel mirrors the order of torch.sum's three-term
reduction and torch.linalg.cross's fused product). So every output agrees bit
for bit: the next state on every lane, the NEE segment and contribution on
every candidate. The cases take every branch of the shading: misses (lanes
sent out of the closed hall), Lambertian, glossy and mirror metal, glass that
refracts and glass that cannot, emitters with and without an MIS weight.
"""

import pytest
import torch

from minipath_tpu_torch import Camera, TriangleBvh
from minipath_tpu_torch.render import shade
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.render.frame import gen_frame_rays9
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

W, H, S = 512, 256, 2  # 262,144 lanes
MISS_EVERY = 61  # one lane in 61 starts outside the hall, pointing away


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
    # The atrium's metal is glossy; this table makes it a mirror.
    mirror = tm.material_table([{**d, "param": 0.0} if d["kind"] == tm.METAL else d for d in dicts], cuda)
    return dict(bvh=bvh, scene=scene, table=table, mirror_table=mirror, tracer=tracer, shadow=shadow,
                lights=lights, env=tm.Environment.sky(cuda))


def _camera():
    return Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


def _strata(mode, P0):
    if mode == "iid":
        return None
    return tw._Strata(64 if mode == "strat" else -64, 8, 123457, 0, P0, P0 // S)


def _first_state(cuda, nee, live=None):
    rays9, _ = gen_frame_rays9(_camera().build_sampler((W, H), cuda), torch.Generator(device=cuda).manual_seed(1),
                               width=W, height=H, px_block=(16, 16), samples=S)
    B0, _, P0 = rays9.shape
    N = B0 * P0
    flat = rays9.transpose(1, 2).reshape(N, 9).clone()
    # The hall is closed: these lanes start above it and point away.
    out = torch.arange(N, device=cuda) % MISS_EVERY == 5
    flat[out, 0:9] = torch.tensor([0.0, 1e4, 0.0, 0.0, 1.0, 0.0, torch.inf, 1.0, torch.inf], device=cuda)
    state = tw._PathState(
        origin=flat[:, 0:3], direction=flat[:, 3:6], inv_direction=flat[:, 6:9],
        throughput=torch.ones((N, 3), device=cuda), radiance=torch.zeros((N, 3), device=cuda),
        pixel=torch.arange(N, dtype=torch.int32, device=cuda),
        active=torch.arange(N, device=cuda) < (N if live is None else live),
        prev_pdf=torch.zeros(N, device=cuda) if nee else None,
    )
    return state, P0


CASES = {
    # name: (bounce, NEE on, NEE here, shadow roulette, live prefix, compacted first, mirror metal)
    "bsdf": (0, False, False, True, False, False, False),
    "nee": (0, True, True, True, False, False, False),
    "nee_no_shadow_rr": (0, True, True, False, False, False, False),
    "past_nee_depth": (1, True, False, True, False, False, False),
    "roulette": (3, True, True, True, False, False, False),
    "live_prefix": (0, True, True, True, True, False, False),
    "compacted": (1, True, True, True, False, True, False),
    "mirror": (0, True, True, True, False, False, True),
}


def _inputs(s, cuda, mode, case):
    bounce, nee, nee_here, shadow_rr, prefix, compacted, mirror = CASES[case]
    N = W * H * S
    state, P0 = _first_state(cuda, nee, live=N // 3 if prefix else None)
    strata = _strata(mode, P0)
    lights = s["lights"] if nee else None
    live = N // 3 if prefix else None
    kh = s["tracer"](s["scene"], state.origin, state.direction, state.inv_direction, live)
    if compacted:
        # One plain bounce with its NEE light added, then compaction: the
        # state a second bounce finds (strided columns, MIS pdfs, a dead
        # suffix).
        nxt, q = tw._shade_plain(state, kh, s["table"], s["env"], lights, torch.Generator(device=cuda).manual_seed(2),
                                 bounce=0, nee_here=True, shadow_rr=True, rr_start=3, rr_floor=0.05, strata=strata)
        nxt = nxt._replace(radiance=nxt.radiance + torch.where(q.cand[:, None], q.contrib, 0.0))
        state = tw._compact(nxt)
        live = state.active.sum(dtype=torch.int32)
        kh = s["tracer"](s["scene"], state.origin, state.direction, state.inv_direction, live)
    kw = dict(bounce=bounce, nee_here=nee_here, shadow_rr=shadow_rr, rr_start=3, rr_floor=0.05, strata=strata,
              live=live)
    return state, kh, lights, s["mirror_table" if mirror else "table"], kw


def _branches(state, kh, table, live):
    """The live lanes by the branch their shading takes."""
    n = state.origin.shape[0]
    n_live = n if live is None else int(live)
    active = state.active & (torch.arange(n, device=state.origin.device) < n_live)
    hit = active & (kh.tri >= 0)
    mat = kh.material.long().clamp(min=0)
    kind, param = table.kind.long()[mat], table.param[mat]
    metal, glass, emitter = hit & (kind == tm.METAL), hit & (kind == tm.DIELECTRIC), hit & (kind == tm.EMISSIVE)
    d_dot_n = (state.direction * kh.normal).sum(-1)
    ior = param.clamp(min=1.0001)
    eta = torch.where(d_dot_n < 0, 1.0 / ior, ior)
    sin_t = (1.0 - d_dot_n.abs().clamp(max=1.0) ** 2).clamp(min=0.0).sqrt()
    return dict(
        miss=int((active & (kh.tri < 0)).sum()), lambertian=int((hit & (kind == tm.LAMBERTIAN)).sum()),
        glossy=int((metal & (param >= tw.GLOSSY_MIN_FUZZ)).sum()),
        mirror=int((metal & (param < tw.GLOSSY_MIN_FUZZ)).sum()),
        dielectric=int(glass.sum()), cannot_refract=int((glass & (eta * sin_t > 1.0)).sum()),
        emitter=int(emitter.sum()),
        emitter_mis=int((emitter & (state.prev_pdf > 0)).sum()) if state.prev_pdf is not None else 0,
    )


# The branches each case's live lanes take (the camera sees no emitter; the
# live third of the frame holds no prop; past bounce 0 no lane leaves the
# hall); together every branch of the shading.
FIRST_HITS = ("miss", "lambertian", "glossy", "dielectric", "cannot_refract")
BRANCHES = {
    **{case: FIRST_HITS for case in CASES},
    "live_prefix": ("miss", "lambertian"),
    "compacted": ("lambertian", "glossy", "dielectric", "cannot_refract", "emitter", "emitter_mis"),
    "mirror": ("miss", "lambertian", "mirror", "dielectric", "cannot_refract"),
}


def _differ(got, want, mask):
    """The ``mask`` lanes where ``got`` and ``want`` differ in any element
    (NaN equals NaN)."""
    same = got == want
    if got.is_floating_point():
        same = same | (torch.isnan(got) & torch.isnan(want))
    if same.dim() > 1:
        same = same.all(dim=-1)
    return int((mask & ~same).sum())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", ["iid", "strat", "sobol"])
def test_one_bounce_matches_plain(cuda, setup, mode, case):
    s = setup
    state, kh, lights, table, kw = _inputs(s, cuda, mode, case)
    g_kernel = torch.Generator(device=cuda).manual_seed(5)
    g_plain = torch.Generator(device=cuda).manual_seed(5)
    before = shade.launch.launches
    got, got_q = tw._shade_kernel(state, kh, table, s["env"], lights, g_kernel, **kw)
    torch.cuda.synchronize()
    assert shade.launch.launches == before + 1
    want, want_q = tw._shade_plain(state, kh, table, s["env"], lights, g_plain, **kw)
    assert torch.equal(g_kernel.get_state(), g_plain.get_state())

    branches = _branches(state, kh, table, kw["live"])
    assert all(branches[b] > 0 for b in BRANCHES[case]), branches
    live = state.active
    assert live.sum().item() > 1000
    # Every lane's next state, live or dead, bit for bit.
    every = torch.ones_like(live)
    differ = {name: _differ(getattr(got, name), getattr(want, name), every)
              for name in ("active", "origin", "direction", "inv_direction", "throughput", "radiance", "prev_pdf")
              if getattr(want, name) is not None}
    assert (got.prev_pdf is None) == (want.prev_pdf is None)
    assert not got.active[~live].any()
    if want_q is None:
        assert got_q is None
    else:
        differ["cand"] = _differ(got_q.cand, want_q.cand, every)
        assert want_q.cand.sum().item() > 100
        # The segment and what it adds, on every candidate.
        for name in ("origin", "segment", "wi", "light", "contrib"):
            differ[f"nee.{name}"] = _differ(getattr(got_q, name), getattr(want_q, name), want_q.cand)
    print(f"\nSHADE {mode} {case} lanes={int(live.sum())} branches {branches} lanes that differ {differ}")
    assert not any(differ.values()), differ


FRAMES = {
    "iid": dict(stratify=False),
    "strat": dict(),
    "sobol": dict(sobol=True),
}


@pytest.mark.parametrize("mode", list(FRAMES))
def test_frame_mean_matches_plain(cuda, setup, mode, monkeypatch):
    """Whole NEE frames through ``render_frame_pt`` (compaction, NEE at the
    first vertex, roulette from the third bounce): the kernel's mean within
    one standard error of the plain version's."""
    s = setup
    kw = dict(width=96, height=64, spp=16, bounces=5, samples_per_packet=8, lights=s["lights"],
              shadow_tracer=s["shadow"], nee_max_depth=1, rr_start=3, return_variance=True, strat_seed=99,
              **FRAMES[mode])
    sampler = _camera().build_sampler((96, 64), cuda)

    def frame():
        return tw.render_frame_pt(s["tracer"], s["scene"], s["table"], sampler,
                                  torch.Generator(device=cuda).manual_seed(11), **kw)

    before = shade.launch.launches
    img, _ = frame()
    assert shade.launch.launches == before + 2 * 5
    monkeypatch.setattr(tw, "_shade_kernel", tw._shade_plain)
    ref, var = frame()
    assert shade.launch.launches == before + 2 * 5
    luma = torch.tensor([0.2126, 0.7152, 0.0722], device=cuda)
    got, want = (img[..., :3] @ luma).mean().item(), (ref[..., :3] @ luma).mean().item()
    se = var.sum().sqrt().item() / var.numel()
    assert torch.isfinite(img).all()
    assert abs(got - want) <= se, (got, want, se)
    close = ((img - ref).abs().amax(dim=-1) <= 1e-4).float().mean().item()
    exact = (img == ref).all(dim=-1).float().mean().item()
    print(f"\nFRAME {mode}: mean {got:.6f} plain {want:.6f} se {se:.6f}, pixels within 1e-4: {close:.4f}, "
          f"equal: {exact:.4f}")
    assert close == 1.0, close


def test_kernel_lanes_counter_equals_lanes(cuda, setup):
    s = setup
    sampler = _camera().build_sampler((64, 32), cuda)
    before = shade.launch.launches
    profiling.take()
    profiling.enable()
    try:
        tw.render_frame_pt(s["tracer"], s["scene"], s["table"], sampler, torch.Generator(device=cuda).manual_seed(3),
                           width=64, height=32, spp=8, bounces=4, samples_per_packet=4, lights=s["lights"],
                           shadow_tracer=s["shadow"], strat_seed=1)
        rec = profiling.take()
    finally:
        profiling.disable()
    lanes = rec.counters["pt.lanes"]
    assert lanes == 64 * 32 * 8 * 4
    assert rec.counters["pt.shade_kernel_lanes"] == lanes
    assert shade.launch.launches == before + 2 * 4  # chunks x bounces
    # A bounce's shading; on a card the NEE light is added inside the shadow
    # batch's second span, by its resolve pass.
    names = [sp.name for sp in rec.spans]
    assert names.count("pt.shade") == 2 * 4 and names.count("pt.shadow_batch") == 2 * 2 * 4
    assert not {"pt.bsdf_scatter", "pt.environment_emission"} & {sp.name for sp in rec.spans}


def test_sharded_sobol_frame_matches_unsharded(cuda, setup):
    """Each shard launches the kernel on its own rays; in Sobol mode without
    roulette draws, the sharded frame traces the unsharded frame's paths."""
    s = setup
    kw = dict(width=64, height=48, bounces=3, samples_per_packet=4, lights=s["lights"], shadow_rr=False, sobol=True)
    sampler = _camera().build_sampler((64, 48), cuda)
    one = tw.render_frame_pt(s["tracer"], s["scene"], s["table"], sampler, None, spp=8, strat_seed=7, **kw,
                             shadow_tracer=s["shadow"])
    before = shade.launch.launches
    two = tw.render_frame_pt(s["tracer"], s["scene"], s["table"], sampler, None, spp=8, strat_seed=7, **kw,
                             shadow_tracer=s["shadow"], mesh=(cuda,) * 2)
    assert shade.launch.launches == before + 2 * 2 * 3  # shards x chunks x bounces
    close = ((one - two).abs().amax(dim=-1) <= 1e-5).float().mean().item()
    assert close >= 0.999, close
