"""Fewer rays: roulette's start and floor, and the wavefront's tail cutoff.

Port of ``tools/sweep_rr2.py``. Three knobs of ``render_frame_pt`` trace
fewer rays:

* ``rr_start``: the first bounce where path roulette may end a path
  (unbiased);
* ``rr_floor``: the least survival probability; higher is gentler roulette,
  and 1.0 turns it off (unbiased: survivors are reweighted);
* ``min_live_frac``: end the whole wavefront once its live share falls below
  it (biased: the rest of the paths' light is dropped).

Each row of :data:`CONFIGS` (the first is the package's default) renders the
atrium with its materials (250k triangles, leaves of up to 24, the
benchmark camera, the sky) at 960x540 @ 8 spp, 5 bounces, NEE at the first
vertex, over K2: one warm-up frame and five timed ones, six seeds in all
(``common.seed_sweep``). A row reports its seconds a frame, the frame mean,
the per-pixel variance across the seeds, its Monte-Carlo efficiency
1 / (variance x seconds) over the first row's, and its mean's shift from the
first row's in percent. The gate (``common.row_gate``): every unbiased row's
mean within 1% of the first row's, or within 4 standard errors of their
difference where the seeds' frame means spread more (the JAX tool asserted
2%); the biased rows are reported, not gated.

Modes, as the JAX tool's: ``--bsdf-only`` renders without NEE (the
``wavefront`` section of the JAX-era ``SWEEP_RR.json``, where the default is
``nee_capped``); ``--floors F,F,...`` sweeps survival floors at the default
``rr_start`` in place of :data:`CONFIGS` (the JAX tool appends those rows to
its file; here they stand alone, relative to their own first row);
``--floors-precise F,F,...`` (the ``floor_precise`` section) compares floors
by the within-frame variance estimator (``render_frame_pt(return_variance=
True)``, the per-sample variance of the luminance over every pixel) over six
seeds each, with the seed-to-seed spread of the efficiency as its error bar.

The JSON line holds the section under its ``SWEEP_RR.json`` name, the row keys
of that file; ``--out`` writes it; no other file is written.

Usage: ``python -m minipath_tpu_torch.tools.sweep_rr2 [--device cuda] [--out
PATH] [--bsdf-only] [--floors F,...] [--floors-precise F,...] [W H spp]``
"""

from __future__ import annotations

import sys
import time

import numpy as np

from minipath_tpu_torch.tools import common

SIZE = (960, 540, 8)
BOUNCES = 5
SEEDS = 6
NEE_CAP = 1
# (rr_start, rr_floor, min_live_frac); the first row is the package's default.
CONFIGS = (
    (3, 0.05, None),
    (2, 0.05, None),
    (1, 0.05, None),
    (3, 0.25, None),
    (3, 0.50, None),
    (2, 0.25, None),
    (3, 0.05, 0.02),
    (3, 0.05, 0.05),
)


def floats(text: str) -> list[float]:
    return [float(x) for x in text.split(",")]


def grid(w, sampler, env, configs, size, nee: bool, failed: list) -> list[dict]:
    """One :func:`common.seed_sweep` row a config, relative to the first."""
    W, H, SPP = size
    rows = []
    for rs, fl, mlf in configs:
        def frame(seed):
            return common.host_rgb(common.pt_frame(
                w, sampler, seed, width=W, height=H, spp=SPP, nee=nee, bounces=BOUNCES, env=env,
                nee_max_depth=NEE_CAP if nee else None, rr_start=rs, rr_floor=fl, min_live_frac=mlf,
            ))

        label = f"rs={rs} fl={fl} mlf={mlf}"
        row = {"rr_start": rs, "rr_floor": fl, "min_live_frac": mlf, **common.seed_sweep(frame, SEEDS, 40, label)}
        common.log(f"{label}: {row['s_per_frame']:.3f}s/frame mean={row['mean']:.5f} var={row['var']:.4e}")
        rows.append(row)
    base = rows[0]
    for r in rows:
        r["efficiency_vs_baseline"] = common.efficiency(r) / common.efficiency(base)
        r["mean_shift_pct"] = 100.0 * (r["mean"] - base["mean"]) / max(base["mean"], 1e-9)
        if r["min_live_frac"] is None:
            common.row_gate(f"rr_start={r['rr_start']} rr_floor={r['rr_floor']}", r, base, failed)
    return rows


def floors_precise(w, sampler, env, floors, size, failed: list) -> list[dict]:
    """Each survival floor at the default ``rr_start``: one warm-up frame,
    then ``SEEDS`` frames, each with its within-frame variance; the
    efficiency ratio to the first floor with its standard error."""
    W, H, SPP = size
    rows = []
    for fl in floors:
        def frame(seed):
            img, var = common.pt_frame(w, sampler, seed, width=W, height=H, spp=SPP, nee=True, bounces=BOUNCES,
                                       env=env, nee_max_depth=NEE_CAP, rr_start=3, rr_floor=fl,
                                       return_variance=True)
            return float(img[..., :3].mean()), float(var.mean())

        t0 = time.perf_counter()
        frame(7)
        common.log(f"floor {fl}: warmup {time.perf_counter() - t0:.2f}s")
        per_seed = []
        for i in range(SEEDS):
            t0 = time.perf_counter()
            mean, var = frame(80 + i)
            per_seed.append({"t_s": time.perf_counter() - t0, "var": var, "mean": mean})
        ts = np.array([s["t_s"] for s in per_seed])
        vs = np.array([s["var"] for s in per_seed])
        effs = 1.0 / (vs * ts)
        rows.append({
            "rr_floor": fl, "t_mean_s": float(ts.mean()), "t_std_s": float(ts.std()), "var_mean": float(vs.mean()),
            "var_rel_std": float(vs.std() / vs.mean()), "eff_mean": float(effs.mean()),
            "eff_stderr": float(effs.std() / np.sqrt(len(effs))), "per_seed": per_seed,
        })
        common.log(f"floor {fl}: t {ts.mean():.3f}s var {vs.mean():.4e} eff {effs.mean():.2f}")
    for r in rows:
        means = np.array([s["mean"] for s in r["per_seed"]])
        r["mean"], r["mean_stderr"] = float(means.mean()), float(means.std(ddof=1) / np.sqrt(len(means)))
    base = rows[0]
    for r in rows:
        ratio = r["eff_mean"] / base["eff_mean"]
        # Independent seeds: the relative errors add in quadrature.
        rel = np.hypot(r["eff_stderr"] / r["eff_mean"], base["eff_stderr"] / base["eff_mean"])
        r["efficiency_vs_first"] = float(ratio)
        r["efficiency_vs_first_stderr"] = float(ratio * rel)
        common.row_gate(f"rr_floor={r['rr_floor']}", r, base, failed)
    return rows


def main(argv=None) -> int:
    p = common.parser("Roulette start and floor, and the tail cutoff, by Monte-Carlo efficiency on the atrium.",
                      "W H spp (default 960 540 8)")
    p.add_argument("--bsdf-only", action="store_true", help="no NEE: the wavefront section")
    p.add_argument("--floors", type=floats, default=None, metavar="F,...",
                   help="sweep these survival floors at rr_start 3 in place of the configs")
    p.add_argument("--floors-precise", type=floats, default=None, metavar="F,...",
                   help="compare these floors by the within-frame variance estimator (NEE)")
    args = p.parse_args(argv)
    size = common.sizes(args, p, SIZE)
    if args.floors_precise is not None and (args.bsdf_only or args.floors is not None):
        p.error("--floors-precise takes neither --bsdf-only nor --floors")
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.bench import bench_camera
    from minipath_tpu_torch.scene.materials import Environment

    W, H, SPP = size
    w = common.pt_workload(*common.build_scene(device), device)
    sampler = bench_camera().build_sampler((W, H), device)
    env = Environment.sky(device)
    failed = []
    if args.floors_precise is not None:
        section = "floor_precise"
        rows = floors_precise(w, sampler, env, args.floors_precise, size, failed)
        workload = (f"atrium NEE(cap={NEE_CAP}) {W}x{H} @ {SPP}spp, {BOUNCES} bounces, {SEEDS} seeds, within-frame "
                    "variance estimator")
    else:
        nee = not args.bsdf_only
        section = "nee_capped" if nee else "wavefront"
        configs = CONFIGS if args.floors is None else [(3, f, None) for f in args.floors]
        rows = grid(w, sampler, env, configs, size, nee, failed)
        mode = f"NEE(cap={NEE_CAP})" if nee else "wavefront (BSDF-only)"
        workload = f"atrium {mode} {W}x{H} @ {SPP}spp, {BOUNCES} bounces, {SEEDS} seeds"
    out = {
        "device": common.device_name(device),
        section: {"workload": f"{workload}, K2 over the f32 layout", "rows": rows},
        "kernel_launches": common.kernel_launches(),
        "gates_failed": failed,
    }
    return common.finish(out, args.out)


if __name__ == "__main__":
    sys.exit(main())
