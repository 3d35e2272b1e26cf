"""Plain PyTorch closest-hit traversal over the reference's own tree.

A lockstep loop: each step pops one stack entry for every ray that has one;
the rays that popped an inner node slab-test its 8 child boxes and push the
hit children far-first (so the nearest pops next), the rays that popped a
leaf run two-sided Möller–Trumbore on its packets of 8 triangles, keeping
the first lane of least ``t`` under a strict ``t < best``. An entry whose
entry distance exceeds the ray's best hit is dropped at its pop. It counts
inner visits and packet tests per ray: the work of a traversal of this tree
in this order, whatever program traces the same rays.

Every float is computed in ``dtype``: float32 is the reference, a lower type
its control. This module imports torch and NumPy only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import bvh

BIG = 1e30


class Scene(NamedTuple):
    box: torch.Tensor  # (N, 8, 6) min xyz, max xyz
    links: torch.Tensor  # (N, 8) int64
    packet_tri: torch.Tensor  # (M, 8) int64
    tri: torch.Tensor  # (M, 8, 9) v0, e1, e2 of each lane, zeros on padding
    root: int
    nodes: int
    packets: int


class Hits(NamedTuple):
    t: torch.Tensor
    tri: torch.Tensor  # triangle id, -1 on a miss
    u: torch.Tensor
    v: torch.Tensor
    inner_visits: torch.Tensor  # per ray, int64
    leaf_tests: torch.Tensor


def prepare(tree: bvh.Tree, positions: np.ndarray, triangles: np.ndarray, device, dtype=torch.float32) -> Scene:
    """The tree and its triangles on ``device``: edges are differences of
    the float32 positions, taken in ``dtype``."""
    ids = torch.from_numpy(tree.packet_tri).to(device)
    verts = torch.from_numpy(positions[triangles].astype(np.float32)).to(device, dtype)  # (T, 3, 3)
    lane = verts[ids.clamp(min=0)]  # (M, 8, 3, 3)
    v0 = lane[:, :, 0]
    tri = torch.cat([v0, lane[:, :, 1] - v0, lane[:, :, 2] - v0], dim=-1)
    tri = torch.where((ids >= 0)[..., None], tri, torch.zeros_like(tri))
    box = torch.cat([torch.from_numpy(tree.box_min), torch.from_numpy(tree.box_max)], dim=-1).to(device, dtype)
    return Scene(box, torch.from_numpy(tree.links).to(device), ids, tri.contiguous(), tree.root,
                 tree.links.shape[0], tree.packet_tri.shape[0])


def trace(scene: Scene, origin: torch.Tensor, direction: torch.Tensor, stack_size: int = 128) -> Hits:
    """Closest hits of rays ``(R, 3)`` (``direction`` unit length)."""
    dev, dt = origin.device, scene.box.dtype
    R = origin.shape[0]
    o, d = origin.to(dt), direction.to(dt)
    inv = torch.where(d == 0.0, torch.full_like(d, math.inf), 1.0 / d).clamp(-BIG, BIG)
    best_t = torch.full((R,), math.inf, dtype=dt, device=dev)
    best_tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(R, dtype=dt, device=dev)
    best_v = torch.zeros(R, dtype=dt, device=dev)
    ivis = torch.zeros(R, dtype=torch.int64, device=dev)
    ltst = torch.zeros(R, dtype=torch.int64, device=dev)
    st_link = torch.zeros((R, stack_size), dtype=torch.int64, device=dev)
    st_t = torch.zeros((R, stack_size), dtype=dt, device=dev)
    st_link[:, 0] = scene.root
    sp = torch.ones(R, dtype=torch.int64, device=dev)
    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        top = sp[act] - 1
        sp[act] = top
        link = st_link[act, top]
        keep = st_t[act, top] <= best_t[act]
        act, link = act[keep], link[keep]
        inner = link >= 0

        a, n = act[inner], link[inner]
        if a.numel():
            ivis[a] += 1
            box = scene.box[n]
            oa, ia = o[a][:, None, :], inv[a][:, None, :]
            t0 = (box[..., 0:3] - oa) * ia
            t1 = (box[..., 3:6] - oa) * ia
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            near = torch.maximum(torch.clamp(lo[..., 0], min=0.0), torch.maximum(lo[..., 1], lo[..., 2]))
            far = torch.minimum(torch.minimum(hi[..., 0], best_t[a][:, None]), torch.minimum(hi[..., 1], hi[..., 2]))
            clinks = scene.links[n]
            hit = (near <= far) & (clinks != bvh.NULL)
            key = torch.where(hit, near, torch.full_like(near, math.inf))
            key, order = torch.sort(key, dim=1, descending=True, stable=True)
            hit = torch.gather(hit, 1, order)
            clinks = torch.gather(clinks, 1, order)
            pos = sp[a][:, None] + torch.cumsum(hit, dim=1) - hit.long()
            if bool((hit & (pos >= stack_size)).any()):
                raise RuntimeError("reference traversal: stack overflow")
            rows = a[:, None].expand(-1, 8)[hit]
            st_link[rows, pos[hit]] = clinks[hit]
            st_t[rows, pos[hit]] = key[hit]
            sp[a] += hit.sum(dim=1)

        a = act[~inner]
        if a.numel():
            first, cnt = bvh.decode_leaf(link[~inner])
            ltst[a] += cnt
            for j in range(int(cnt.max())):
                m = cnt > j
                _leaf_packet(scene.tri, first[m] + j, a[m], o, d, best_t, best_tri, best_u, best_v)
    tri = torch.where(best_tri >= 0, scene.packet_tri.view(-1)[best_tri.clamp(min=0)], best_tri)
    return Hits(best_t, tri, best_u, best_v, ivis, ltst)


def _leaf_packet(tri, pk, a, o, d, best_t, best_tri, best_u, best_v) -> None:
    tr = tri[pk]  # (k, 8, 9)
    v0x, v0y, v0z = tr[..., 0], tr[..., 1], tr[..., 2]
    e1x, e1y, e1z = tr[..., 3], tr[..., 4], tr[..., 5]
    e2x, e2y, e2z = tr[..., 6], tr[..., 7], tr[..., 8]
    ox, oy, oz = (o[a, k][:, None] for k in range(3))
    dx, dy, dz = (d[a, k][:, None] for k in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / det
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = inv_det * (sx * px + sy * py + sz * pz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = inv_det * (dx * qx + dy * qy + dz * qz)
    t = inv_det * (e2x * qx + e2y * qy + e2z * qz)
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0) & (t < best_t[a][:, None])
    t_new, lane = torch.where(ok, t, torch.full_like(t, math.inf)).min(dim=1)
    upd = t_new < best_t[a]
    au, lu = a[upd], lane[upd][:, None]
    best_t[au] = t_new[upd]
    best_tri[au] = pk[upd] * 8 + lane[upd]
    best_u[au] = torch.gather(u[upd], 1, lu)[:, 0]
    best_v[au] = torch.gather(v[upd], 1, lu)[:, 0]


def shading_normals(positions: np.ndarray, normals: np.ndarray, triangles: np.ndarray, device, dtype=torch.float32):
    """``(T, 3, 3)`` vertex normals a triangle is shaded with: its vertex
    normals, or, where one of them is zero (a flat triangle), its geometric
    normal ``e1 x e2`` in all three slots, each term a product exact in
    float64 less a float32 product, rounded once."""
    tv = positions[triangles].astype(np.float32)
    e1, e2 = tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]

    def term(i, j):
        return (e1[:, i].astype(np.float64) * e2[:, j] - (e1[:, j] * e2[:, i]).astype(np.float64)).astype(np.float32)

    cross = np.stack([term(1, 2), term(2, 0), term(0, 1)], axis=-1)
    vn = normals[triangles].astype(np.float32)
    flat = (np.sum(vn * vn, axis=-1) == 0.0).any(axis=-1)
    vn = np.where(flat[:, None, None], cross[:, None, :], vn)
    return torch.from_numpy(vn).to(device, dtype)


def shade_normal(vnorm: torch.Tensor, hits: Hits) -> torch.Tensor:
    """Unit interpolated shading normal at each hit, zeros on a miss."""
    sh = vnorm[hits.tri.clamp(min=0)]
    n0, n1, n2 = sh[:, 0], sh[:, 1], sh[:, 2]
    u, v = hits.u[:, None].to(sh.dtype), hits.v[:, None].to(sh.dtype)
    nrm = n0 + u * (n1 - n0) + v * (n2 - n0)
    sq = nrm[:, 0] * nrm[:, 0] + nrm[:, 1] * nrm[:, 1] + nrm[:, 2] * nrm[:, 2]
    nrm = nrm * torch.rsqrt(torch.clamp(sq, min=1e-30))[:, None]
    return torch.where((hits.tri >= 0)[:, None], nrm, torch.zeros_like(nrm))
