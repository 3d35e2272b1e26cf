"""The spatial-split tree (SBVH) against the binned-SAH tree on the path
tracer's real bounce wavefronts.

Port of ``tools/sweep_sbvh.py``. The atrium with its materials (250k
triangles, leaves of up to 24) is built twice, each cached in
``bench_cache_dir()`` (``utils/cuda_build.py``): by the native builder, as the path tracer's tools
build it, and by the NumPy builder with spatial splits, which clips
triangles into several leaves where that shrinks the boxes
(``build_bvh(spatial_splits=True)``; the JAX package leaves it off by
default, ``scene/bvh/build.py``). The NumPy SBVH build is slow: minutes at
250k triangles.

The wavefronts: the benchmark camera's 960x540 @ 8 spp camera rays (16x16
pixel packets), then four bounces, each scattered off the binned-SAH tree's
hits by the atrium's materials, the same rays for both trees. From bounce 1
on, the live rays are sorted by direction octant and a 16^3 Morton cell of
their origin, the dead ones last, as the JAX tool sorts them. Each set is
traced by K2 (closest hit, packets of 2048, the live prefix) over each tree:
one warm-up launch, then one timed by CUDA events, with the launch's
inner-visit and leaf-test counters, the direct measure of whether the
clipped references shrink what a ray visits. The gate: on every live ray
the two trees agree on hit or miss, and on ``t`` within 1e-5 relative on
99.99% of the hits (the triangle ids differ between trees).

The JAX tool printed its rows; ``--out`` writes the JSON, and nothing else
is written.

Usage: ``python -m minipath_tpu_torch.tools.sweep_sbvh [--device cuda] [--out
PATH] [n_triangles W H spp]``
"""

from __future__ import annotations

import sys

import torch

from minipath_tpu_torch.tools import common

SIZE = (250_000, 960, 540, 8)
BOUNCES = 4
LEAF_MAX = 24
TREES = (("obj", "native"), ("sbvh", "sbvh"))


def sort_key(o, d, active) -> torch.Tensor:
    """The JAX tool's key: direction octant, then the Morton code of the
    origin's cell in a 16^3 grid over the origins' box (the bounce loop's
    own helpers), the dead rays last."""
    from minipath_tpu_torch.render.wavefront import _morton16, _position_cells

    octant = (d[:, 0] > 0).int() * 4 + (d[:, 1] > 0).int() * 2 + (d[:, 2] > 0).int()
    return torch.where(active, (octant << 12) | _morton16(_position_cells(o)), 1 << 30)


def main(argv=None) -> int:
    p = common.parser("SBVH against the binned-SAH tree on the atrium's bounce wavefronts, K2 with its counters.",
                      "n_triangles W H spp (default 250000 960 540 8)")
    args = p.parse_args(argv)
    n_tris, W, H, SPP = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.bench import bench_camera, scene_mb
    from minipath_tpu_torch.render.frame import gen_frame_rays9
    from minipath_tpu_torch.render.wavefront import scatter
    from minipath_tpu_torch.scene.bvh.build import compute_tree_stats
    from minipath_tpu_torch.scene.materials import table_from_numpy

    engines, trees, fields = {}, {}, None
    for name, builder in TREES:
        built = common.atrium(n_tris, materials=True, leaf_max=LEAF_MAX, builder=builder)
        tracer, _, state = common.pt_tracers(built.bvh, device, "f32")
        engines[name] = (tracer, state)
        fields = built.material_fields
        arrays = built.bvh.host_arrays
        trees[name] = {"builder": builder, "build_s": built.build_s, "cached": built.cached,
                       "depth": built.bvh.build_result.max_depth, "inner_nodes": int(arrays.node_child_links.shape[0]),
                       "packets": int(arrays.tri_packets.shape[0]), "references": int(compute_tree_stats(arrays)[3].total),
                       "layout_mb": scene_mb(state)}
        common.log(f"{name}: {trees[name]}")
    table = table_from_numpy(fields, device)

    sampler = bench_camera().build_sampler((W, H), device)
    rays9, _ = gen_frame_rays9(sampler, torch.Generator(device=device).manual_seed(0), width=W, height=H,
                               px_block=(16, 16), samples=SPP)
    flat = rays9.transpose(1, 2).reshape(-1, 9)
    del rays9
    o, d, inv = flat[:, 0:3], flat[:, 3:6], flat[:, 6:9]
    N = o.shape[0]
    active = torch.ones(N, dtype=torch.bool, device=device)

    # The bounce sets advance on the binned-SAH tree; both trees trace them.
    tracer_o, state_o = engines["obj"]
    gen = torch.Generator(device=device).manual_seed(1)
    sets = [(o, d, inv, active)]
    for _ in range(BOUNCES):
        kh = tracer_o(state_o, o, d, inv)
        nd, _, _, term = scatter(table, gen, d, kh.normal, kh.material)
        hit = (kh.tri >= 0) & active
        h = hit[:, None]
        o = torch.where(h, o + d * kh.t[:, None] + 1e-3 * torch.sign(nd), o)
        d = torch.where(h, nd, d)
        inv = torch.where(d == 0, torch.inf, 1.0 / d)
        active = hit & ~term
        sets.append((o, d, inv, active))

    timer = common.DeviceTimer(device)
    failed, rows = [], []
    for bounce, (o, d, inv, active) in enumerate(sets):
        live = int(active.sum())
        if bounce > 0:
            perm = torch.argsort(sort_key(o, d, active))
            o, d, inv = o[perm], d[perm], inv[perm]
        row = {"bounce": bounce, "live": live, "live_frac": live / N}
        ref = None
        for name, _ in TREES:
            tracer, state = engines[name]
            tracer(state, o, d, inv, live)  # warm-up
            timer.start()
            kh = tracer(state, o, d, inv, live)
            ms = timer.stop()
            if int(kh.overflow.sum()):
                failed.append(f"bounce {bounce}, {name}: stack overflow")
            hit, t = kh.tri[:live] >= 0, kh.t[:live]
            row[name] = {"ms": ms, "live_mrays_per_s": live / ms / 1e3, "inner_visits": int(kh.inner_visits.sum()),
                         "leaf_tests": int(kh.leaf_tests.sum())}
            if ref is None:
                ref = (hit, t)
            else:
                row.update(common.tree_agreement(f"bounce {bounce}", hit, t, *ref, failed))
        row["visits_sbvh_over_obj"] = row["sbvh"]["inner_visits"] / max(row["obj"]["inner_visits"], 1)
        row["leaf_tests_sbvh_over_obj"] = row["sbvh"]["leaf_tests"] / max(row["obj"]["leaf_tests"], 1)
        row["ms_sbvh_over_obj"] = row["sbvh"]["ms"] / row["obj"]["ms"]
        common.log(f"bounce {bounce}: live {live / N:.1%} | " + " | ".join(
            f"{n}: {row[n]['ms']:.3f} ms, visits {row[n]['inner_visits']}, leaf tests {row[n]['leaf_tests']}"
            for n, _ in TREES) + f" | hit mismatch {row['hit_mismatch']}")
        rows.append(row)
    out = {
        "device": common.device_name(device),
        "workload": f"atrium ({n_tris} asked) PT wavefronts {W}x{H} @ {SPP}spp, camera rays and {BOUNCES} bounces, "
                    "sorted from bounce 1, K2 closest-hit over the live prefix, packets of 2048",
        "trees": trees,
        "rows": rows,
        "kernel_launches": common.kernel_launches(),
        "gates_failed": failed,
    }
    return common.finish(out, args.out)


if __name__ == "__main__":
    sys.exit(main())
