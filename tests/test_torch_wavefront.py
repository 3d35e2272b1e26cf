"""The port's wavefront path tracer against the JAX package's.

Tolerances, each with its reason:

- ``_direction_bin`` and ``_morton16`` are equal bit for bit (the same
  float32 steps and integer operations).
- ``scatter_full`` in Sobol strata mode (no iid uniform on either side):
  directions within 1e-5, pdfs within 1e-5 relative (a Phong lobe's pdf
  raises a cosine to a power near 87, which scales a last-bit difference of
  the libm ``log``/``exp`` or of XLA's fused multiply-adds), ``terminate``
  and ``diffuse`` equal.
- ``shade_from_flat`` from one f16 table: within 1e-6 of the JAX version
  (f32 arithmetic in another order). Against K1's f32 normals the lean
  path's normals are only as good as f16, about 2e-3, which is why the JAX
  package's ``test_pt_tracer_matches_full_tracer`` fails at 2e-5: hold a
  lean-path normal to the f16 level, or compare lean with lean.
- The seed-matched frame: every dimension in Sobol mode is a pure function
  of (pixel, sample, seed), shadow roulette is off and path roulette never
  fires in 3 bounces, so both sides trace the same paths; at least 98% of
  pixels within 1e-4 per channel and the image means within 1e-3 relative
  (float32 rounding, and the rare exact tie K2 resolves differently, which
  sends one path elsewhere).
- Analytic frames: exact up to float32 (1e-5; 1e-4 for the Lambertian
  zero-variance case; 2e-2 for the mirror, whose camera rays spread).
- NEE and BSDF-only iid frames: image means within 4 standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu import camera as jax_camera
from minipath_tpu.render import wavefront as jw
from minipath_tpu.render.pallas_kernels import prepare_scene as jax_prepare_scene
from minipath_tpu.render.pallas_kernels import prepare_scene_pt as jax_prepare_scene_pt
from minipath_tpu.render.pallas_kernels import trace_packets_pallas
from minipath_tpu.scene import materials as jm
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu_torch import Camera
from minipath_tpu_torch.camera import CameraSampler
from minipath_tpu_torch.render import kernels
from minipath_tpu_torch.render import wavefront as tw
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh.build import from_numpy
from minipath_tpu_torch.scene.obj_loader import MeshData
from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_direction_bin_and_morton_bit_for_bit():
    rng = np.random.default_rng(2)
    d = np.concatenate([_unit(rng, 4000), np.eye(3, dtype=np.float32), -np.eye(3, dtype=np.float32),
                        np.float32([[0.5, 0.5, 0.0], [0.0, -0.3, 0.3], [1e-12, 0.0, 0.0]])])
    got = tw._direction_bin(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jw._direction_bin(jnp.asarray(d))))
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() <= 95 and len(np.unique(got)) == 96
    cell = rng.integers(0, 16, (4000, 3)).astype(np.int32)
    got = tw._morton16(torch.from_numpy(cell)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jw._morton16(jnp.asarray(cell))))
    assert len(np.unique(got)) == len(np.unique(cell, axis=0))


def test_scatter_full_sobol_matches_jax():
    dicts = [
        tm.lambertian((0.6, 0.5, 0.4)), tm.metal((0.9, 0.8, 0.7), 0.15), tm.metal((0.9, 0.9, 0.9), 0.0),
        tm.dielectric(1.5), tm.emissive((1.0, 0.9, 0.8), 4.0),
    ]
    jdicts = [
        jm.lambertian((0.6, 0.5, 0.4)), jm.metal((0.9, 0.8, 0.7), 0.15), jm.metal((0.9, 0.9, 0.9), 0.0),
        jm.dielectric(1.5), jm.emissive((1.0, 0.9, 0.8), 4.0),
    ]
    rng = np.random.default_rng(8)
    n = 2000
    d, nrm = _unit(rng, n), _unit(rng, n)
    mat = rng.integers(0, 5, n).astype(np.int32)
    s = rng.integers(0, 8, n).astype(np.int32)
    pid = rng.integers(0, 1 << 20, n).astype(np.int32)
    got = tw.scatter_full(tm.material_table(dicts, "cpu"), None, torch.from_numpy(d), torch.from_numpy(nrm),
                          torch.from_numpy(mat), strat=(torch.from_numpy(s), torch.from_numpy(pid), -8, 16))
    want = jw.scatter_full(jm.material_table(jdicts), jax.random.key(0), jnp.asarray(d), jnp.asarray(nrm),
                           jnp.asarray(mat), strat=(jnp.asarray(s), jnp.asarray(pid), -8, 16))
    new_dir, atten, emitted, terminate, pdf, diffuse = (x.numpy() for x in got)
    w = [np.asarray(x) for x in want]
    np.testing.assert_allclose(new_dir, w[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(atten, w[1])
    np.testing.assert_array_equal(emitted, w[2])
    np.testing.assert_array_equal(terminate, w[3])
    np.testing.assert_allclose(pdf, w[4], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(diffuse, w[5])
    assert terminate.any() and (pdf > 0).mean() > 0.3 and diffuse.any()


def test_compact_is_a_sorted_permutation_with_a_live_prefix():
    rng = np.random.default_rng(3)
    N = 3000
    o = torch.from_numpy(rng.uniform(-5, 5, (N, 3)).astype(np.float32))
    d = torch.from_numpy(_unit(rng, N))
    active = torch.from_numpy(rng.uniform(size=N) < 0.6)
    state = tw._PathState(
        origin=o, direction=d, inv_direction=1.0 / d,
        throughput=torch.from_numpy(rng.uniform(size=(N, 3)).astype(np.float32)),
        radiance=torch.from_numpy(rng.uniform(size=(N, 3)).astype(np.float32)),
        pixel=torch.arange(N, dtype=torch.int32), active=active,
        prev_pdf=torch.from_numpy(rng.uniform(size=N).astype(np.float32)),
    )
    for fine in (True, False):
        c = tw._compact(state, fine_direction=fine)
        perm = c.pixel.long()
        assert c.pixel.dtype == torch.int32 and torch.equal(torch.sort(perm).values, torch.arange(N))
        for name in ("origin", "direction", "throughput", "radiance", "prev_pdf"):
            assert torch.equal(getattr(c, name), getattr(state, name)[perm]), name
        assert torch.equal(c.inv_direction, 1.0 / c.direction)
        n_live = int(active.sum())
        assert torch.equal(c.active, torch.arange(N) < n_live)
        assert bool(state.active[perm][:n_live].all()) and not bool(state.active[perm][n_live:].any())
        # The key is non-decreasing: dead last, then direction, then cell.
        cell = tw._morton16(tw._position_cells(o))[perm]
        dbin = tw._direction_bin(c.direction) if fine else (
            (c.direction[:, 0] > 0).int() * 4 + (c.direction[:, 1] > 0).int() * 2 + (c.direction[:, 2] > 0).int())
        key = ((~state.active[perm]).int() << 19) | (dbin << 12) | cell
        assert bool((key[1:] >= key[:-1]).all())


def test_shade_from_flat_matches_jax_and_k1_to_f16():
    mesh = jax_procedural.merge_meshes([jax_procedural.make_uv_sphere(1.0, rings=10, segments=14),
                                        jax_procedural.make_cube(1.5, center=(2.5, 0, 0))])
    mesh.texcoords = np.random.default_rng(1).uniform(0, 1, mesh.positions.shape).astype(np.float32)
    res = jax_build_bvh(mesh, materials=np.arange(mesh.triangle_count, dtype=np.int32) % 3)
    scene = kernels.prepare_scene_pt(from_numpy(res.arrays._asdict(), "cpu"))
    ys, xs = np.mgrid[0:16, 0:32].astype(np.float32)
    d = np.stack([xs / 40.0 - 0.3, ys / 40.0 - 0.2, np.full_like(xs, 1.0)], -1).reshape(2, 256, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.float32([0.6, 0.0, -6.0]), d.shape).copy()
    with np.errstate(divide="ignore"):
        inv = np.where(d == 0.0, np.inf, 1.0 / d).astype(np.float32)
    r9 = torch.from_numpy(np.ascontiguousarray(np.swapaxes(np.concatenate([o, d, inv], -1), 1, 2)))
    ph = kernels.trace_packets_pt(scene, r9, stack_size=res.recommended_stack_size)
    tri, u, v = ph.tri.reshape(-1), ph.u.reshape(-1), ph.v.reshape(-1)
    hit = (tri >= 0).numpy()
    assert 0.3 < hit.mean() < 1.0
    got = tw.shade_from_flat(scene.shade_flat, tri, u, v)
    want = jw.shade_from_flat(jnp.asarray(scene.shade_flat.numpy()), jnp.asarray(tri.numpy()),
                              jnp.asarray(u.numpy()), jnp.asarray(v.numpy()))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-6)
    # Against K1 (f32 normals in-kernel): the f16 table's precision.
    full = trace_packets_pallas(jax_prepare_scene(res.as_device()), jnp.asarray(r9.numpy().reshape(2, 9, 2, 128)),
                                stack_size=res.recommended_stack_size, interpret=True)
    same = np.asarray(full.tri).reshape(-1) == tri.numpy()
    assert same.mean() > 0.98  # the fan crosses shared edges: a mismatch is a tie
    np.testing.assert_allclose(ph.t.numpy().reshape(-1), np.asarray(full.t).reshape(-1), rtol=1e-5)
    np.testing.assert_allclose(got[0].numpy()[same & hit], np.asarray(full.normal).reshape(-1, 3)[same & hit],
                               rtol=0, atol=2e-3)
    np.testing.assert_array_equal(got[1].numpy()[same & hit], np.asarray(full.material).reshape(-1)[same & hit])


# ---- frames -----------------------------------------------------------------


def _bench_camera(cls):
    return cls().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)


@pytest.fixture(scope="module")
def small_atrium():
    """``make_atrium(0)`` (the hall, its columns, one prop; emissive
    ceiling) with the benchmark materials, built once by the JAX builder and
    handed to both packages."""
    mesh = jax_procedural.make_atrium(0)
    ids, dicts = jax_procedural.atrium_materials(mesh)
    res = jax_build_bvh(mesh, materials=ids, leaf_max=24)
    return res, dicts


@pytest.mark.parametrize("nee", [False, True], ids=["bsdf", "nee"])
def test_seed_matched_sobol_frame(small_atrium, nee):
    res, dicts = small_atrium
    W = H = 16
    kw = dict(width=W, height=H, spp=2, bounces=3, samples_per_packet=2, sobol=True, shadow_rr=False)
    seed = 1234567
    # JAX: the lean kernel in interpret mode, as the JAX package's tests run it.
    jscene = jax_prepare_scene_pt(res.as_device())
    jtable = jm.material_table(dicts)
    jtracer, _ = jw.make_pt_tracer(jscene, stack_size=res.recommended_stack_size, interpret=True)
    jshadow = jlights = None
    if nee:
        jshadow, _ = jw.make_pt_shadow_tracer(jscene, stack_size=res.recommended_stack_size, interpret=True)
        jlights = jm.build_light_table(res.arrays.tri_packets, res.arrays.tri_material, jtable)
    jsampler = _bench_camera(jax_camera.Camera).build_sampler((W, H))
    want = np.asarray(jw.render_frame_pt(jtracer, jscene, jtable, jsampler, jax.random.key(0), strat_seed=seed,
                                         lights=jlights, shadow_tracer=jshadow, **kw))
    # The port: K2's plain version on the CPU, the same arrays.
    scene = kernels.prepare_scene_pt(from_numpy(res.arrays._asdict(), "cpu"))
    table = tm.material_table(dicts, "cpu")
    tracer, _ = tw.make_pt_tracer(scene, stack_size=res.recommended_stack_size)
    shadow = lights = None
    if nee:
        shadow, _ = tw.make_pt_shadow_tracer(scene, stack_size=res.recommended_stack_size)
        lights = tm.build_light_table(res.arrays.tri_packets, res.arrays.tri_material, table)
    sampler = CameraSampler.from_numpy({k: np.asarray(v) for k, v in jsampler._asdict().items()}, "cpu")
    got = tw.render_frame_pt(tracer, scene, table, sampler, None, strat_seed=seed, lights=lights,
                             shadow_tracer=shadow, **kw).numpy()
    assert got.shape == want.shape == (H, W, 4) and np.isfinite(got).all()
    close = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    assert close.mean() >= 0.98, close.mean()
    np.testing.assert_allclose(got[..., :3].mean(), want[..., :3].mean(), rtol=1e-3)
    assert got[..., :3].mean() > 0.05


def test_seed_matched_sobol_frame_uncompacted(small_atrium):
    """The megakernel mode (``compaction=False``, the CLI's
    ``--no-compaction``): every bounce traces the whole wavefront with its
    dead lanes masked. Against the JAX frame in the same mode within the
    seed-matched tolerances, and bit for bit against the port's compacted
    frame: with Sobol strata keyed on each path's pixel and no roulette,
    compaction only reorders the same paths."""
    res, dicts = small_atrium
    W = H = 16
    kw = dict(width=W, height=H, spp=2, bounces=3, samples_per_packet=2, sobol=True, shadow_rr=False)
    seed = 7654321
    jscene = jax_prepare_scene_pt(res.as_device())
    jtracer, _ = jw.make_pt_tracer(jscene, stack_size=res.recommended_stack_size, interpret=True)
    jsampler = _bench_camera(jax_camera.Camera).build_sampler((W, H))
    want = np.asarray(jw.render_frame_pt(jtracer, jscene, jm.material_table(dicts), jsampler, jax.random.key(0),
                                         strat_seed=seed, compaction=False, **kw))
    scene = kernels.prepare_scene_pt(from_numpy(res.arrays._asdict(), "cpu"))
    tracer, _ = tw.make_pt_tracer(scene, stack_size=res.recommended_stack_size)
    sampler = CameraSampler.from_numpy({k: np.asarray(v) for k, v in jsampler._asdict().items()}, "cpu")

    def frame(compaction):
        return tw.render_frame_pt(tracer, scene, tm.material_table(dicts, "cpu"), sampler, None, strat_seed=seed,
                                  compaction=compaction, **kw).numpy()

    got = frame(False)
    assert got.shape == want.shape == (H, W, 4) and np.isfinite(got).all()
    close = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    assert close.mean() >= 0.98, close.mean()
    np.testing.assert_allclose(got[..., :3].mean(), want[..., :3].mean(), rtol=1e-3)
    np.testing.assert_array_equal(got, frame(True))


def _floor_bvh(mat_count=1, panel=False):
    floor = procedural.make_quad(100.0)
    pos = floor.positions.copy()
    floor.positions = np.stack([pos[:, 0], pos[:, 2], pos[:, 1]], axis=-1)
    meshes = [floor]
    if panel:  # an emissive panel above the camera, facing the floor
        p = procedural.make_quad(20.0)
        pp = p.positions.copy()
        p.positions = np.stack([pp[:, 0], np.full_like(pp[:, 2], 8.0), pp[:, 1]], axis=-1)
        meshes.append(p)
    mesh = procedural.merge_meshes(meshes)
    ids = np.zeros(mesh.triangle_count, np.int32)
    ids[floor.triangle_count:] = mat_count - 1
    return TriangleBvh.build(mesh, materials=ids)


def _down_camera():
    return Camera().look_direction((0, 5, 0), (0, -1, 0), (0, 0, 1))


def _render(bvh, table, camera, env, spp=2, bounces=3, seed=0, **kw):
    tracer, state = tw.make_pt_tracer(bvh.pt_scene("cpu"), stack_size=bvh.recommended_stack_size)
    return tw.render_frame_pt(
        tracer, state, table, camera.build_sampler((16, 16), "cpu"), torch.Generator().manual_seed(seed),
        width=16, height=16, spp=spp, bounces=bounces, env=env, samples_per_packet=spp, **kw,
    )


@pytest.mark.parametrize("case", ["all_miss", "emissive", "lambertian", "mirror"])
def test_analytic_frames(case):
    if case == "all_miss":
        img = _render(TriangleBvh.build(MeshData()), tm.material_table([tm.lambertian((0.5, 0.5, 0.5))], "cpu"),
                      Camera().look_direction((0, 0, 0), (0, 1, 0), (0, 0, 1)),
                      tm.Environment.uniform((0.3, 0.6, 0.9), "cpu"), bounces=2)
        want, atol = [0.3, 0.6, 0.9], 1e-5
    elif case == "emissive":
        img = _render(_floor_bvh(), tm.material_table([tm.emissive((2.0, 1.0, 0.5))], "cpu"), _down_camera(),
                      tm.Environment.none("cpu"))
        want, atol = [2.0, 1.0, 0.5], 1e-5
    elif case == "lambertian":
        # Cosine-sampled Lambertian under a uniform environment: every path
        # carries exactly albedo * env.
        img = _render(_floor_bvh(), tm.material_table([tm.lambertian((0.8, 0.6, 0.4))], "cpu"), _down_camera(),
                      tm.Environment.uniform((1.0, 1.0, 1.0), "cpu"))
        want, atol = [0.8, 0.6, 0.4], 1e-4
    else:
        img = _render(_floor_bvh(), tm.material_table([tm.metal((1.0, 1.0, 1.0), 0.0)], "cpu"), _down_camera(),
                      tm.Environment.gradient((1.0, 0.0, 0.0), (0.0, 0.0, 1.0), "cpu"))
        img = img[8:9, 8:9]  # the straight-down ray reflects to the zenith
        want, atol = [0.0, 0.0, 1.0], 2e-2
    rgb = img[..., :3].numpy()
    np.testing.assert_allclose(rgb, np.broadcast_to(want, rgb.shape), rtol=0, atol=atol)
    assert np.all(img[..., 3].numpy() == 1.0)


def test_compaction_matches_megakernel_mean():
    """The port of tests/test_wavefront.py's
    ``test_compaction_matches_megakernel_mean``: iid frames of a grey floor
    under the sky, compacted and uncompacted, from two seeds; the image
    means agree within 5%."""
    table = tm.material_table([tm.lambertian((0.5, 0.5, 0.5))], "cpu")
    env = tm.Environment.sky("cpu")
    a, b = (_render(_floor_bvh(), table, _down_camera(), env, spp=8, bounces=4, seed=seed, compaction=compaction)
            for seed, compaction in ((1, True), (2, False)))
    np.testing.assert_allclose(a[..., :3].mean().item(), b[..., :3].mean().item(), rtol=0.05)
    assert a[..., :3].mean().item() > 0.05


def test_iid_nee_mean_matches_bsdf_only():
    """NEE with MIS is unbiased: the same image mean as pure BSDF sampling,
    within 4 standard errors of the difference (each from the per-pixel
    variance of the mean that ``return_variance`` reports)."""
    bvh = _floor_bvh(mat_count=2, panel=True)
    table = tm.material_table([tm.lambertian((0.6, 0.6, 0.6)), tm.emissive((1.0, 1.0, 1.0), 2.0)], "cpu")
    lights = tm.build_light_table(bvh.host_arrays.tri_packets, bvh.host_arrays.tri_material, table)
    shadow, _ = tw.make_pt_shadow_tracer(bvh.pt_scene("cpu"), stack_size=bvh.recommended_stack_size)
    kw = dict(spp=64, bounces=3, stratify=False, return_variance=True)
    env = tm.Environment.none("cpu")
    a, var_a = _render(bvh, table, _down_camera(), env, seed=1, **kw)
    b, var_b = _render(bvh, table, _down_camera(), env, seed=2, lights=lights, shadow_tracer=shadow, **kw)
    luma = torch.tensor([0.2126, 0.7152, 0.0722])
    la, lb = (a[..., :3] @ luma).mean().item(), (b[..., :3] @ luma).mean().item()
    se = np.sqrt(var_a.sum().item() + var_b.sum().item()) / var_a.numel()
    assert lb > 0.05 and se > 0
    assert abs(la - lb) <= 4 * se, (la, lb, se)
    assert var_b.mean() < var_a.mean()  # and NEE lowers the variance


def test_cli_pt_cpu_writes_png(tmp_path):
    """``--integrator pt --nee`` on the CPU (K2's plain version) renders a
    tiny sphere frame under the sky; the grey sphere has no emitter, so the
    CLI warns and renders without light sampling."""
    import subprocess
    import sys
    from pathlib import Path

    out = tmp_path / "pt.png"
    proc = subprocess.run(
        [sys.executable, "-m", "minipath_tpu_torch.cli", "--scene", "sphere-mesh", "--integrator", "pt", "--nee",
         "--width", "32", "--height", "24", "--spp", "2", "--bounces", "3", "--device", "cpu", "--no-stats",
         "-o", str(out)],
        cwd=Path(__file__).resolve().parent.parent, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "no emissive triangles" in proc.stderr and "path traced 32x24 @ 2 spp" in proc.stderr
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (24, 32, 4) and (img[..., :3] > 0).all() and (img[..., 3] == 255).all()
