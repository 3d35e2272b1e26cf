"""Estimator quality: stratification, Sobol points, adaptive sampling and the
variance-guided filter, by RMSE against a high-spp reference.

Port of ``tools/bench_quality.py``, every section at the JAX tool's sizes.
Equal-sample RMSE compares estimators, not devices; the tool runs on the
card, and on the CPU at small sizes. On the atrium with its materials
(60,000 triangles requested, leaves of up to 24; 160x90, 5 bounces, the
sky, the benchmark camera) against a 256-spp stratified reference:

* ``stratification``: iid against per-pixel strata at 8 and 32 spp;
* ``adaptive``: uniform against ``render_frame_pt_adaptive`` (a 2-spp
  pilot, chunks of 8) at average budgets of 10, 18 and 34 spp;
* ``denoise_variance_guided``: the raw frame against ``atrous_denoise``
  guided by its variance and ``render_aux``'s buffers, at 4 and 32 spp;
* ``sobol``: iid, strata and Owen-scrambled Sobol points at 8 and 32 spp.

Then two scenes whose noise is concentrated, where an allocator can move
samples: ``adaptive_concentrated_noise`` (a glossy ball on a diffuse floor
under the sky, 128x96, 3 bounces, a 192-spp reference; budgets 10 and 18)
and ``adaptive_tworooms_concentrated`` (``make_tworooms(40_000)`` from the
dark room, 128x96, 6 bounces, no environment, the mean of two 256-spp
frames; budgets 12 and 24, three pilot and block variants). Every RMSE is
the mean over three seeds.

``--engine kernel`` (the default) traces with K2 (its plain version on the
CPU), ``--engine portable`` with the portable engine
(``make_portable_tracer``); the output names it. One gate holds the engine
to the other: an 8-spp Sobol frame of the atrium through both from one
seed, whose means must agree within 1% (``engine_check``); past it the
run exits 1 after its JSON. A smaller
``reference_spp`` cuts every reference in proportion, and
``reference_cut`` says so. Prints the JSON (the keys of the JAX-era
``QUALITY.json``); ``--out`` also writes it.

Usage: ``python -m minipath_tpu_torch.tools.bench_quality [--device cuda]
[--engine {kernel,portable}] [--out PATH] [W H reference_spp]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from minipath_tpu_torch.tools import common

SIZE = (160, 90, 256)
BOUNCES = 5
ATRIUM_TRIANGLES = 60_000
LEAF_MAX = 24
SEEDS = 3
STRAT_SPP = (8, 32)
ADAPTIVE_BUDGETS = (10, 18, 34)
DENOISE_SPP = (4, 32)
SOBOL_SPP = (8, 32)
SPHERE_SIZE, SPHERE_BOUNCES, SPHERE_REF_SPP, SPHERE_BUDGETS = (128, 96), 3, 192, (10, 18)
TWOROOMS_TRIANGLES, TWOROOMS_SIZE, TWOROOMS_BOUNCES = 40_000, (128, 96), 6
TWOROOMS_REF_SPP, TWOROOMS_BUDGETS = 256, (12, 24)
# (name, pilot spp, samples a chunk, pixel block edge)
TWOROOMS_VARIANTS = (("p2_px16", 2, 8, 16), ("p4_px16", 4, 8, 16), ("p4_px8", 4, 4, 8))
ENGINES = {"kernel": "f32", "portable": "portable"}
ENGINE_CHECK_SPP, ENGINE_CHECK_RTOL = 8, 0.01


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


class Renderer:
    """One scene's uniform and adaptive frames, as host RGB arrays."""

    def __init__(self, bvh, table, camera, engine, device, size, bounces, env):
        self.tracer, _, self.state = common.pt_tracers(bvh, device, engine)
        self.table, self.device = table, device
        self.kw = dict(width=size[0], height=size[1], bounces=bounces, env=env, px_block=(16, 16))
        self.sampler = camera.build_sampler(size, device)

    def gen(self, seed):
        return torch.Generator(device=self.device).manual_seed(seed)

    def uniform(self, seed, spp, variance=False, **kw):
        from minipath_tpu_torch.render.wavefront import render_frame_pt

        out = render_frame_pt(self.tracer, self.state, self.table, self.sampler, self.gen(seed), spp=spp,
                              samples_per_packet=min(8, spp), return_variance=variance, **{**self.kw, **kw})
        return out if variance else out[..., :3].cpu().numpy()

    def adaptive(self, seed, spp, pilot=2, chunk=8, block=16):
        from minipath_tpu_torch.render.adaptive import render_frame_pt_adaptive

        kw = {**self.kw, "px_block": (block, block)}
        return render_frame_pt_adaptive(self.tracer, self.state, self.table, self.sampler, self.gen(seed), spp=spp,
                                        pilot_spp=pilot, samples_per_packet=chunk, **kw)[..., :3].cpu().numpy()


def mse_ratio(a: float, b: float) -> float | None:
    """``(a / b) ** 2``, or None where ``b`` is 0 (a frame equal to its
    reference)."""
    return (a / b) ** 2 if b > 0 else None


def _mean_rmse(fn, seeds, ref) -> float:
    return float(np.mean([rmse(fn(s), ref) for s in seeds]))


def sphere_section(engine, device, ref_spp) -> dict:
    """A glossy ball on a diffuse floor under the sky: most blocks see almost
    no variance."""
    from minipath_tpu_torch import Camera
    from minipath_tpu_torch.scene.materials import Environment, lambertian, material_table, metal
    from minipath_tpu_torch.scene.procedural import make_quad, make_uv_sphere, merge_meshes
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    sph = make_uv_sphere(1.0, rings=12, segments=20)
    sph.positions[:, 1] += 1.0
    floor = make_quad(30.0)
    p = floor.positions.copy()
    floor.positions = np.stack([p[:, 0], p[:, 2], p[:, 1]], axis=-1)
    mesh = merge_meshes([sph, floor])
    ids = np.concatenate([np.zeros(len(sph.triangles), np.int32), np.ones(len(floor.triangles), np.int32)])
    table = material_table([metal((0.9, 0.7, 0.4), fuzz=0.4), lambertian((0.5, 0.55, 0.6))], device)
    camera = Camera().look_at((0, 2.2, 6), (0, 1.0, 0)).f_number(32.0)
    r = Renderer(TriangleBvh.build(mesh, materials=ids), table, camera, engine, device, SPHERE_SIZE, SPHERE_BOUNCES,
                 Environment.sky(device))
    ref = r.uniform(999, ref_spp)
    rows = []
    for budget in SPHERE_BUDGETS:
        seeds = range(30, 30 + SEEDS)
        r_uni = _mean_rmse(lambda s: r.uniform(s, budget), seeds, ref)
        r_ada = _mean_rmse(lambda s: r.adaptive(s, budget), seeds, ref)
        rows.append({"avg_spp": budget, "rmse_uniform": r_uni, "rmse_adaptive": r_ada,
                     "mse_ratio_uniform_over_adaptive": mse_ratio(r_uni, r_ada)})
        common.log(f"sphere budget {budget}: uniform {r_uni:.5f}, adaptive {r_ada:.5f}")
    return {"workload": f"glossy ball + diffuse floor {SPHERE_SIZE[0]}x{SPHERE_SIZE[1]}, {SPHERE_BOUNCES} bounces, "
                        f"reference {ref_spp} spp", "rows": rows}


def tworooms_section(engine, device, ref_spp) -> dict:
    """The two-rooms scene from the dark room: the noise lives in the doorway
    and its light spill, BSDF sampling only."""
    from minipath_tpu_torch import Camera
    from minipath_tpu_torch.scene.materials import Environment, material_table
    from minipath_tpu_torch.scene.procedural import make_tworooms, tworooms_materials
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    mesh = make_tworooms(TWOROOMS_TRIANGLES)
    ids, dicts = tworooms_materials(mesh)
    camera = Camera().look_at((-10.0, 3.0, 0.0), (0.0, 1.5, 0.0)).f_number(8.0).sensor_width(36e-3)
    r = Renderer(TriangleBvh.build(mesh, materials=ids), material_table(dicts, device), camera, engine, device,
                 TWOROOMS_SIZE, TWOROOMS_BOUNCES, Environment.none(device))
    ref = np.mean([r.uniform(990 + i, ref_spp) for i in range(2)], axis=0)
    rows = []
    for budget in TWOROOMS_BUDGETS:
        seeds = range(30, 30 + SEEDS)
        r_uni = _mean_rmse(lambda s: r.uniform(s, budget), seeds, ref)
        row = {"avg_spp": budget, "rmse_uniform": r_uni}
        for name, pilot, chunk, block in TWOROOMS_VARIANTS:
            r_ada = _mean_rmse(lambda s: r.adaptive(s, budget, pilot, chunk, block), seeds, ref)
            row[f"rmse_adaptive_{name}"] = r_ada
            row[f"mse_ratio_uniform_over_adaptive_{name}"] = mse_ratio(r_uni, r_ada)
        rows.append(row)
        common.log(f"tworooms budget {budget}: {row}")
    return {"workload": f"tworooms (dark room, lit doorway) {TWOROOMS_SIZE[0]}x{TWOROOMS_SIZE[1]}, "
                        f"{TWOROOMS_BOUNCES} bounces, BSDF-only, reference 2x{ref_spp} spp", "rows": rows}


def main(argv=None) -> int:
    p = common.parser("Estimator quality of the path tracer: stratification, Sobol, adaptive, denoise.",
                      "W H reference_spp (default 160 90 256)")
    p.add_argument("--engine", choices=sorted(ENGINES), default="kernel",
                   help="kernel: K2 (its plain version on the CPU); portable: the portable engine")
    args = p.parse_args(argv)
    W, H, REF = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.render.denoise import atrous_denoise, render_aux
    from minipath_tpu_torch.scene.materials import Environment, table_from_numpy

    engine = ENGINES[args.engine]
    scene = common.atrium(ATRIUM_TRIANGLES, materials=True, leaf_max=LEAF_MAX)
    r = Renderer(scene.bvh, table_from_numpy(scene.material_fields, device), bench_camera(), engine, device, (W, H),
                 BOUNCES, Environment.sky(device))
    seeds = range(20, 20 + SEEDS)
    common.log(f"reference ({REF} spp stratified)...")
    ref = r.uniform(999, REF)

    strat = []
    for spp in STRAT_SPP:
        r_iid = _mean_rmse(lambda s: r.uniform(s, spp, stratify=False), seeds, ref)
        r_st = _mean_rmse(lambda s: r.uniform(s, spp), seeds, ref)
        strat.append({"spp": spp, "rmse_iid": r_iid, "rmse_stratified": r_st,
                      "mse_reduction": mse_ratio(r_iid, r_st)})
        common.log(f"strat spp {spp}: iid {r_iid:.5f}, stratified {r_st:.5f}")

    adap = []
    for budget in ADAPTIVE_BUDGETS:
        r_uni = _mean_rmse(lambda s: r.uniform(s, budget), range(30, 30 + SEEDS), ref)
        r_ada = _mean_rmse(lambda s: r.adaptive(s, budget), range(30, 30 + SEEDS), ref)
        adap.append({"avg_spp": budget, "rmse_uniform": r_uni, "rmse_adaptive": r_ada,
                     "mse_ratio_uniform_over_adaptive": mse_ratio(r_uni, r_ada)})
        common.log(f"adaptive budget {budget}: uniform {r_uni:.5f}, adaptive {r_ada:.5f}")

    normal, depth = render_aux(r.tracer, r.state, r.sampler, r.gen(1), width=W, height=H, px_block=(16, 16))
    den = []
    for spp in DENOISE_SPP:
        img, var = r.uniform(40, spp, variance=True)
        noisy = img[..., :3]
        filtered = atrous_denoise(noisy, normal, depth, var)
        den.append({"spp": spp, "rmse_noisy": rmse(noisy.cpu().numpy(), ref),
                    "rmse_denoised": rmse(filtered.cpu().numpy(), ref)})
        common.log(f"denoise spp {spp}: {den[-1]}")

    sobol = []
    for spp in SOBOL_SPP:
        r_iid = _mean_rmse(lambda s: r.uniform(s, spp, stratify=False), seeds, ref)
        r_st = _mean_rmse(lambda s: r.uniform(s, spp), seeds, ref)
        r_so = _mean_rmse(lambda s: r.uniform(s, spp, sobol=True), seeds, ref)
        sobol.append({"spp": spp, "rmse_iid": r_iid, "rmse_stratified": r_st, "rmse_sobol": r_so,
                      "mse_ratio_strat_over_sobol": mse_ratio(r_st, r_so),
                      "mse_ratio_iid_over_sobol": mse_ratio(r_iid, r_so)})
        common.log(f"sobol spp {spp}: iid {r_iid:.5f}, strata {r_st:.5f}, sobol {r_so:.5f}")

    other = "portable" if engine == "f32" else "f32"
    r_other = Renderer(scene.bvh, r.table, bench_camera(), other, device, (W, H), BOUNCES, Environment.sky(device))
    mean, other_mean = (float(x.uniform(20, ENGINE_CHECK_SPP, sobol=True).mean()) for x in (r, r_other))
    check = {"other_engine": other, "spp": ENGINE_CHECK_SPP, "mean": mean, "other_mean": other_mean,
             "mean_shift_frac": abs(mean - other_mean) / max(other_mean, 1e-9)}
    common.log(f"engine check: {check}")

    scale = REF / SIZE[2]
    sphere = sphere_section(engine, device, max(2, round(SPHERE_REF_SPP * scale)))
    tworooms = tworooms_section(engine, device, max(2, round(TWOROOMS_REF_SPP * scale)))
    wins = [row["avg_spp"] for row in adap if (row["mse_ratio_uniform_over_adaptive"] or 0.0) > 1.0]
    out = {
        "workload": f"atrium interior GI {W}x{H}, {BOUNCES} bounces, {scene.bvh.build_result.triangle_count} "
                    f"triangles, {args.engine} engine",
        "device": common.device_name(device),
        "engine": {"kernel": "K2 over the f32 layout (make_pt_tracer)",
                   "portable": "the portable engine (make_portable_tracer)"}[args.engine],
        "reference_spp": REF,
        "reference_cut": None if REF == SIZE[2] else f"every reference at {REF}/{SIZE[2]} of its spp",
        "stratification": strat,
        "adaptive": adap,
        "adaptive_note": f"uniform-noise interior GI; adaptive beats uniform (MSE ratio > 1) at budgets {wins} "
                         f"of {list(ADAPTIVE_BUDGETS)} in this run",
        "denoise_variance_guided": den,
        "sobol": {"workload": f"atrium interior GI {W}x{H}, {BOUNCES} bounces, Owen-scrambled Sobol vs jittered "
                              f"strata vs iid, reference {REF} spp, {SEEDS} seeds", "rows": sobol},
        "adaptive_concentrated_noise": sphere,
        "adaptive_tworooms_concentrated": tworooms,
        "kernel_launches": common.kernel_launches(),
        "engine_check": check,
        "gates_failed": [] if check["mean_shift_frac"] < ENGINE_CHECK_RTOL else [
            f"{args.engine} and {other} frame means within {ENGINE_CHECK_RTOL}"],
    }
    common.emit(out, args.out)
    return 1 if out["gates_failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
