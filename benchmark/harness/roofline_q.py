"""K3's op and byte model: the least time the quantized traversal needs for a
given work, frozen here as ``roofline.py`` freezes K1's, so that the
yardstick does not move with the program.

K3 (``csrc/traverse_q.cu``, built with ``-fmad=false``: no multiply fuses
with an add) visits the same nodes and packets as K1 and does K1's
arithmetic on them, after it has decoded them from the 16-bit layout:

- an inner visit reads the node's frame and takes the frame's three
  scales, ``(max - min) * (1/65535)``: 3 subtractions, 3 multiplies;
- a child box unpacks its 6 u16 values (each a byte permute, an integer
  operation, and one exact float subtraction of 2^23: the kernel converts no
  integer to float with a conversion instruction) and decodes each as
  ``min + q * scale`` (a multiply and an add), then takes K1's slab test;
- a triangle lane unpacks its 9 u16 coordinates the same way, decodes them
  (9 multiplies, 9 adds) and forms its two edges (6 subtractions), then
  takes K1's Möller–Trumbore.

The classes are weighed at their issue rates on compute capability 9.0
(CUDA C++ Programming Guide, "Throughput of Native Arithmetic
Instructions"): float32 add, subtract and multiply 128 a clock and SM;
compare, minimum and maximum 64; 32-bit integer and logical operations
(the byte permute counted among them) 64; reciprocal 16. Left out, so that
the least time errs low: a leaf's three scales (per leaf, which the
reference's count does not give apart from its packets), and the winning
hit's shading normal (per ray: 9 i8-to-float conversions, which the
Guide's table puts at 16, the interpolation and one reciprocal square root).

Bytes: every node row (128 B of u16 boxes and links) with its frame row
(32 B) and every triangle row (256 B) once, and each ray read and its hit
written once, as K1's model counts them.
"""

from __future__ import annotations

import re

from benchmark.harness import roofline

# The kernel the model is of: K3's full closest-hit instance; and every
# instance of K3.
K3 = re.compile(r"traverse_q_kernel<\s*false\s*,\s*false\s*>")
K3_ANY = re.compile(r"traverse_q_kernel<")

RATES = {**roofline.RATES, "int": 64}
# A node's frame: 3 subtractions, 3 multiplies.
FRAME = {"add_mul": 6}
# One child box: 6 unpacking subtractions, 6 multiplies, 6 adds, then the
# slab test; 6 byte permutes.
SLAB_Q = {"add_mul": 18 + roofline.SLAB["add_mul"], "cmp_minmax": roofline.SLAB["cmp_minmax"], "int": 6}
# One triangle lane: 9 unpacking subtractions, 9 multiplies, 9 adds, 6 edge
# subtractions, then Möller–Trumbore; 9 byte permutes.
MT_Q = {"add_mul": 33 + roofline.MT["add_mul"], "cmp_minmax": roofline.MT["cmp_minmax"], "rcp": roofline.MT["rcp"],
        "int": 9}
NODE_BYTES, FRAME_BYTES, PACKET_BYTES = 32 * 4, 8 * 4, 64 * 4


def sm_clocks(ops: dict) -> float:
    """SM clocks that ``ops`` (counts by class) take at the classes' rates."""
    return sum(n / RATES[kind] for kind, n in ops.items())


def k3_least_seconds(rays: int, inner_per_ray: float, leaf_per_ray: float, nodes: int, packets: int):
    """``(seconds by operations, seconds by bytes)`` for K3 to trace
    ``rays`` rays that each make the given inner visits and packet tests,
    over a scene of ``nodes`` node rows and ``packets`` triangle rows, each
    byte counted once."""
    per_visit = sm_clocks(FRAME) + roofline.NODE_CHILDREN * sm_clocks(SLAB_Q)
    clocks = rays * (inner_per_ray * per_visit + leaf_per_ray * roofline.PACKET_LANES * sm_clocks(MT_Q))
    nbytes = (nodes * (NODE_BYTES + FRAME_BYTES) + packets * PACKET_BYTES
              + rays * (roofline.RAY_BYTES + roofline.HIT_BYTES))
    return clocks / (roofline.SMS * roofline.CLOCK_HZ), nbytes / roofline.PEAK_HBM_BYTES
