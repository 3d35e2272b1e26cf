"""The op and byte model of the traversal kernels (K1, K2, K3), and the
card's published peaks it is held to.

One module holds the counts, so that the smoke test's bounds
(``chip_smoke.py``) and the path tracer's profile
(``tools/profile_pt_headline.py``) read the same numbers. A traversal's
operations follow from its own counters: every inner visit slab-tests the
node's 8 child boxes, every leaf test runs Möller–Trumbore on a packet's 8
triangle lanes.
"""

from __future__ import annotations

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): float32
# outside the tensor cores, and HBM bandwidth.
PEAK_FP32_OPS, PEAK_HBM_BYTES = 67e12, 3.35e12
# Float32 operations of one traversal step, counted in the kernels' sources.
# Slab test of one child box: 6 subtractions, 6 multiplies, 12 min/max, 1
# compare. Two-sided Moller-Trumbore of one triangle lane: 2 cross products
# (9 each), 3 dot products (5 each), a reciprocal, 3 subtractions, 3
# multiplies by 1/det and 6 compares (with u + v). K3 first decompresses:
# 6 multiplies and 6 adds per child box; 9 of each per lane's vertices and
# 6 subtractions for its edges.
SLAB_OPS, MT_OPS = 25, 48
# Children of an inner node, and triangle lanes of a leaf packet.
NODE_CHILDREN = PACKET_LANES = 8
# K3 reads a box beside its u16 words: an inner node's own box from its
# node_frame row (6 of the row's 8 words), a leaf's from words 58..63 of its
# first packet's row.
FRAME_BYTES = 6 * 4
COST = {
    # kernel: (ops per child box, ops per triangle lane, bytes per node row
    #          visited, per triangle packet's vertices, per leaf's first
    #          packet, per distinct triangle hit (its normals and material,
    #          for the epilogue), and written per ray)
    "traverse": (SLAB_OPS, MT_OPS, 48 * 4 + 8 * 4, 72 * 4, 0, 9 * 4 + 4, 4 + 4 + 12 + 4),
    "traverse_pt": (SLAB_OPS, MT_OPS, 48 * 4 + 8 * 4, 72 * 4, 0, 0, 4 * 4),
    "traverse_q": (SLAB_OPS + 12, MT_OPS + 24, 32 * 4 + FRAME_BYTES, 36 * 4, FRAME_BYTES, 9 + 2, 4 + 4 + 12 + 4),
    "traverse_q_lean": (SLAB_OPS + 12, MT_OPS + 24, 32 * 4 + FRAME_BYTES, 36 * 4, FRAME_BYTES, 0, 4 * 4),
}
# Bytes a thread's loads request at one inner visit and at one test of a
# triangle packet, whatever cache serves them: K1 and K2 a 192 B box row and
# a 32 B link row, then the packet's 72 vertex words; K3 a 128 B node row and
# a 32 B frame row, then the 9 int4 that hold a packet's u16 vertices (the
# two int4 of a leaf's frame, once a leaf visit, are left out: no counter
# counts leaf visits).
REQUESTED = {"traverse": (224, 288), "traverse_pt": (224, 288), "traverse_q": (160, 144), "traverse_q_lean": (160, 144)}


def ops_per_visit(kernel: str) -> tuple[int, int]:
    """Float32 operations of one ray's inner visit and of one ray's leaf
    test (a packet of 8 lanes) in ``kernel``."""
    slab, mt = COST[kernel][:2]
    return NODE_CHILDREN * slab, PACKET_LANES * mt


def traversal_ops(kernel: str, inner_visits: int, leaf_tests: int) -> int:
    """Float32 operations of a launch of ``kernel`` from its counters' sums."""
    inner, leaf = ops_per_visit(kernel)
    return int(inner_visits) * inner + int(leaf_tests) * leaf
