"""The traversal's op and byte model and the card's published rates: the
least time K1 needs for a given work, frozen here so that the yardstick does
not move with the program.

An inner visit slab-tests a node's 8 child boxes; a leaf test runs two-sided
Möller–Trumbore on a packet's 8 triangle lanes. The operations are counted in
``csrc/traverse.cu`` as it stood when the benchmark was defined, which is
built with ``-fmad=false``: no multiply fuses with an add, so each is one
instruction. Each class of operation is weighed by its issue rate on
compute capability 9.0 (CUDA C++ Programming Guide, "Throughput of Native
Arithmetic Instructions"): float32 add, subtract and multiply at 128 a clock
and SM; compare, minimum and maximum at 64; a reciprocal at 16. The card is
an H100 SXM: 132 SMs at its 1.98 GHz boost clock, HBM at 3.35 TB/s.
"""

from __future__ import annotations

SMS, CLOCK_HZ, PEAK_HBM_BYTES = 132, 1.98e9, 3.35e12
# Results a clock and SM of each class: add/subtract/multiply, compare/min/max, reciprocal.
RATES = {"add_mul": 128, "cmp_minmax": 64, "rcp": 16}
# One child box's slab test: 6 subtractions, 6 multiplies; 12 min/max and
# the compare t1 <= t2.
SLAB = {"add_mul": 12, "cmp_minmax": 13, "rcp": 0}
# One triangle lane: 2 cross products (9 each), 4 dot products (det, u, v,
# t: 5 each), 3 subtractions (o - v0), 3 multiplies by 1/det and u + v; the
# reciprocal 1/det; the compares u >= 0, v >= 0, u + v <= 1, t >= 0, t < best.
MT = {"add_mul": 18 + 20 + 3 + 3 + 1, "cmp_minmax": 5, "rcp": 1}
NODE_CHILDREN = PACKET_LANES = 8
# K1's layout: a node row is 48 box floats and 8 links; a triangle packet
# is 72 vertex floats and 8 material floats, and 72 shading-normal floats.
NODE_BYTES = 48 * 4 + 8 * 4
PACKET_BYTES = 80 * 4 + 72 * 4
# A ray read (origin, direction, inverse direction) and its hit written
# (t, triangle, normal, material).
RAY_BYTES, HIT_BYTES = 9 * 4, 4 + 4 + 12 + 4


def sm_clocks(ops: dict) -> float:
    """SM clocks that ``ops`` (counts by class) take at the classes' rates."""
    return sum(n / RATES[kind] for kind, n in ops.items())


def k1_least_seconds(rays: int, inner_per_ray: float, leaf_per_ray: float, nodes: int, packets: int):
    """``(seconds by operations, seconds by bytes)`` for K1 to trace
    ``rays`` rays that each make the given inner visits and packet tests,
    over a scene of ``nodes`` node rows and ``packets`` triangle packets,
    each byte counted once."""
    clocks = rays * (inner_per_ray * NODE_CHILDREN * sm_clocks(SLAB) + leaf_per_ray * PACKET_LANES * sm_clocks(MT))
    nbytes = nodes * NODE_BYTES + packets * PACKET_BYTES + rays * (RAY_BYTES + HIT_BYTES)
    return clocks / (SMS * CLOCK_HZ), nbytes / PEAK_HBM_BYTES
