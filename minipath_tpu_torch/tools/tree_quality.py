"""Tree quality by the SAH cost model: the expected tests a ray makes.

Port of ``tools/tree_quality.py``. :func:`tree_cost` weighs each child of
each inner node by its box's surface area over the root box's (the chance
that a random ray through the root box enters it) and counts what entering
it costs: 8 box tests for an inner child, and for a leaf one pop and 8
triangle tests a packet. It compares the 250k-triangle atrium's native
build with the Python (binned-SAH) build, both with leaves of up to 24
triangles, each cached in ``utils/cuda_build.py::bench_cache_dir()``. The
gate: each tree holds every triangle (its leaves' lanes count the mesh's
triangles), so that a tree cannot score lower by losing some.

It runs on the host, in NumPy; ``--device`` keeps the tools' convention
(``cuda`` without a card exits 2). The JAX tool printed its rows; ``--out``
writes the JSON, and nothing else is written.

Usage: ``python -m minipath_tpu_torch.tools.tree_quality [--device cuda]
[--out PATH] [n_triangles]``
"""

from __future__ import annotations

import sys

import numpy as np

from minipath_tpu_torch.scene.bvh import links as L
from minipath_tpu_torch.tools import common

SIZE = (250_000,)
LEAF_MAX = 24
TREES = (("native-24", "native"), ("python-24", "python"))


def surface_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Surface areas of boxes ``(..., 3)``, in float64; an empty box has 0."""
    s = np.maximum(np.asarray(hi, np.float64) - np.asarray(lo, np.float64), 0.0)
    return 2.0 * (s[..., 0] * (s[..., 1] + s[..., 2]) + s[..., 1] * s[..., 2])


def tree_cost(arrays) -> tuple[float, float]:
    """``(expected inner-node and leaf visits, expected triangle tests)`` a
    ray through the root box makes in the tree of host ``arrays``
    (``BvhArrays``): the JAX tool's loop over every child, in NumPy."""
    links = np.asarray(arrays.node_child_links)
    area = surface_area(arrays.node_child_box_min, arrays.node_child_box_max) / surface_area(
        arrays.bbox_min, arrays.bbox_max)
    valid = links != L.NULL_LINK
    leaf = valid & L.is_leaf(links)
    count = np.where(leaf, L.decode_count(links), 0)
    c_inner = float(np.sum(area * count) + np.sum(area[valid & ~leaf]) * 8)
    c_tri = float(np.sum(area * count) * 8)  # 8 lanes a packet, padding included
    return c_inner, c_tri


def main(argv=None) -> int:
    p = common.parser("Expected box and triangle tests a ray makes, native against Python tree.",
                      "n_triangles (default 250000)")
    args = p.parse_args(argv)
    (n_tris,) = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.scene.bvh.build import compute_tree_stats

    failed, rows, tris = [], [], None
    for name, builder in TREES:
        built = common.atrium(n_tris, materials=False, leaf_max=LEAF_MAX, builder=builder)
        arrays, tris = built.bvh.host_arrays, built.bvh.build_result.triangle_count
        box, tri = tree_cost(arrays)
        refs = int(compute_tree_stats(arrays)[3].total)
        if refs != tris:
            failed.append(f"{name}: its leaves hold {refs} triangles of {tris}")
        rows.append({"tree": name, "box_tests": box, "tri_tests": tri, "total": box + tri,
                     "inner_nodes": int(arrays.node_child_links.shape[0]), "packets": int(arrays.tri_packets.shape[0]),
                     "depth": built.bvh.build_result.max_depth, "build_s": built.build_s})
        common.log(f"{name}: E[box tests]={box:.1f} E[tri tests]={tri:.1f} total~{box + tri:.1f}")
    out = {
        "device": common.device_name(device),
        "workload": f"atrium ({tris} triangles), leaves <= {LEAF_MAX}, SAH cost per ray through the root box",
        "rows": rows,
        "gates_failed": failed,
    }
    return common.finish(out, args.out)


if __name__ == "__main__":
    sys.exit(main())
