"""The reference's own tree: a frozen NumPy copy of the port's 8-wide SAH
builder (``minipath_tpu_torch/scene/bvh/build.py``, object splits only, as it
stood when the benchmark was defined).

Each inner node partitions its triangles into up to 8 children by recursive
binned-SAH binary splits; a leaf holds at most 56 triangles in packets of 8.
The tree serves two ends: the plain traversal that decides ``correct``
(closest hits do not depend on the tree), and the fixed count of work that
``k1_roofline`` divides by the kernel's time, so that a later change to
the program's tree or traversal moves the share and not the yardstick.

This module imports NumPy only.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np

SAH_BINS = 16
CHILDREN = PACKET = 8
LEAF_MAX = 56
NULL = -1


class Tree(NamedTuple):
    box_min: np.ndarray  # (N, 8, 3) float32
    box_max: np.ndarray  # (N, 8, 3) float32
    # (N, 8) int64 child links: >= 0 an inner node's index, < -1 a leaf,
    # encoded -(2 + first_packet * 8 + packet_count); NULL for no child.
    links: np.ndarray
    packet_tri: np.ndarray  # (M, 8) int64 triangle ids, -1 padding
    root: int  # a link as above


def leaf_link(first: int, count: int) -> int:
    return -(2 + first * 8 + count)


def decode_leaf(link):
    """``(first_packet, packet_count)`` of leaf links (NumPy or torch)."""
    code = -link - 2
    return code // 8, code % 8


def _surface_area(bmin, bmax):
    s = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (s[..., 0] * (s[..., 1] + s[..., 2]) + s[..., 1] * s[..., 2])


class _Group(NamedTuple):
    ids: np.ndarray
    bmin: np.ndarray
    bmax: np.ndarray

    def take(self, mask):
        return _Group(self.ids[mask], self.bmin[mask], self.bmax[mask])


class _Builder:
    def __init__(self, tri_verts: np.ndarray):
        self.tri_min = tri_verts.min(axis=1)
        self.tri_max = tri_verts.max(axis=1)
        self.box_min, self.box_max, self.links, self.packets = [], [], [], []

    def leaf(self, g: _Group) -> int:
        n = len(g.ids)
        count = -(-n // PACKET)
        first = len(self.packets)
        ids = np.full(count * PACKET, -1, np.int64)
        ids[:n] = g.ids
        self.packets.extend(ids.reshape(count, PACKET))
        return leaf_link(first, count)

    def split2(self, g: _Group):
        c = 0.5 * (g.bmin + g.bmax)
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        extent = cmax - cmin
        if not np.any(extent > 0):
            return None
        best = None
        for axis in range(3):
            if extent[axis] <= 0:
                continue
            scale = SAH_BINS / extent[axis]
            b = np.minimum(((c[:, axis] - cmin[axis]) * scale).astype(np.int64), SAH_BINS - 1)
            counts = np.bincount(b, minlength=SAH_BINS)
            bmin = np.full((SAH_BINS, 3), np.inf, np.float32)
            bmax = np.full((SAH_BINS, 3), -np.inf, np.float32)
            np.minimum.at(bmin, b, g.bmin)
            np.maximum.at(bmax, b, g.bmax)
            pmin, pmax = np.minimum.accumulate(bmin, axis=0), np.maximum.accumulate(bmax, axis=0)
            smin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
            smax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
            pcnt, scnt = np.cumsum(counts), np.cumsum(counts[::-1])[::-1]
            cost = np.where(
                (pcnt[:-1] > 0) & (scnt[1:] > 0),
                _surface_area(pmin[:-1], pmax[:-1]) * pcnt[:-1] + _surface_area(smin[1:], smax[1:]) * scnt[1:],
                np.inf,
            )
            i = int(np.argmin(cost))
            if np.isfinite(cost[i]) and (best is None or cost[i] < best[0]):
                best = (float(cost[i]), b, i)
        if best is None:
            return None
        _, b, i = best
        return g.take(b <= i), g.take(b > i)

    def split8(self, g: _Group) -> list:
        groups, stuck = [g], set()
        while len(groups) < CHILDREN:
            cand, pri_best = None, -np.inf
            for gi, h in enumerate(groups):
                if gi in stuck or len(h.ids) <= PACKET:
                    continue
                pri = _surface_area(h.bmin.min(axis=0), h.bmax.max(axis=0)) * len(h.ids)
                if len(h.ids) > LEAF_MAX:
                    pri += np.inf
                if pri > pri_best:
                    cand, pri_best = gi, pri
            if cand is None:
                break
            split = self.split2(groups[cand])
            if split is None:
                stuck.add(cand)
                continue
            groups[cand] = split[0]
            groups.append(split[1])
        if len(groups) == 1:
            groups = [g.take(np.arange(len(g.ids)) % CHILDREN == k) for k in range(CHILDREN)]
            groups = [h for h in groups if len(h.ids)]
        return groups

    def node(self, g: _Group) -> int:
        if len(g.ids) <= LEAF_MAX:
            return self.leaf(g)
        groups = self.split8(g)
        idx = len(self.links)
        self.box_min.append(np.zeros((CHILDREN, 3), np.float32))
        self.box_max.append(np.zeros((CHILDREN, 3), np.float32))
        self.links.append(np.full(CHILDREN, NULL, np.int64))
        for i, h in enumerate(groups):
            self.box_min[idx][i] = h.bmin.min(axis=0)
            self.box_max[idx][i] = h.bmax.max(axis=0)
            self.links[idx][i] = self.node(h)
        return idx


def build_tree(positions: np.ndarray, triangles: np.ndarray) -> Tree:
    """The SAH tree of a mesh given as float32 positions and int triangles."""
    tv = positions[triangles].astype(np.float32)
    b = _Builder(tv)
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))
    root = b.node(_Group(np.arange(len(tv), dtype=np.int64), b.tri_min.copy(), b.tri_max.copy()))
    if not b.links:  # a single leaf: one node that holds it
        b.box_min.append(np.zeros((CHILDREN, 3), np.float32))
        b.box_max.append(np.zeros((CHILDREN, 3), np.float32))
        b.links.append(np.full(CHILDREN, NULL, np.int64))
    return Tree(np.stack(b.box_min), np.stack(b.box_max), np.stack(b.links), np.stack(b.packets), int(root))
