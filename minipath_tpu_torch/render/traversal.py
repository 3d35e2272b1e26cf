"""The portable traversal engine: packet traversal of the BVH in plain torch.

Port of ``minipath_tpu/render/traversal.py`` (``trace_packets``,
``finalize_hits``, ``intersect_bvh``, ``trace_brute_force``). It runs on any
device and serves as an oracle with rules of its own, independent of the
kernels: ``bench.py``'s smoke test holds the kernels against it, and
:func:`trace_brute_force` needs no BVH at all.

Packets of rays (``(B, P, 3)`` fields) walk the tree together: every packet
keeps ONE stack, each step pops one entry per packet and tests all P rays
against the popped node's 8 child boxes (the NaN-rule slab test of
``geometry/aabb.py``) or against one 8-triangle packet (two-sided
Möller–Trumbore). Children are pushed far-first by the packet's least entry
distance, entries are pruned at pop when their entry distance exceeds every
ray's best hit, and a multi-packet leaf pushes a continuation link for its
remainder, so every step costs the same. Pushes past ``stack_size`` are
dropped and counted in ``overflow``.

Each step ends in one host sync (``any(sp > 0)``); the engine is an oracle,
not a render path.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from minipath_tpu_torch.geometry.aabb import slab_test
from minipath_tpu_torch.geometry.ray import Rays
from minipath_tpu_torch.geometry.triangle import barycentric_interpolate, moller_trumbore, triangle_geometric_normal
from minipath_tpu_torch.render.hit import HitRecords
from minipath_tpu_torch.scene.bvh import links as L
from minipath_tpu_torch.scene.bvh.build import BvhArrays

_NULL = L.NULL_LINK


class TraceResult(NamedTuple):
    """Raw closest-hit result: ``tri`` is the padded global triangle index
    (packet*8 + lane) or -1 for a miss; ``t`` is the hit distance (inf on a
    miss)."""

    t: torch.Tensor  # (B, P) f32
    tri: torch.Tensor  # (B, P) i32
    steps: torch.Tensor  # () i32, traversal iterations
    # () i32, stack pushes dropped because the stack was full. Non-zero means
    # intersections may have been missed; size the stack with
    # BuildResult.recommended_stack_size to guarantee zero.
    overflow: torch.Tensor | None = None


def trace_packets(bvh: BvhArrays, rays: Rays, t_max=math.inf, stack_size: int = 64) -> TraceResult:
    """Closest-hit trace of ray packets against the BVH (torch arrays on the
    rays' device).

    ``rays`` fields are ``(B, P, 3)``: B packets of P rays each. Rays within
    a packet should be coherent (same pixel tile) for efficiency; results are
    exact regardless of coherence. ``t_max`` is a scalar or a tensor that
    broadcasts to ``(B, P)``.
    """
    B, P = rays.origin.shape[:2]
    S = stack_size
    dev = rays.origin.device
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    barange = torch.arange(B, device=dev)
    node_box_min = bvh.node_child_box_min
    node_box_max = bvh.node_child_box_max
    node_links = bvh.node_child_links.to(i32)
    tri_packets = bvh.tri_packets

    root = int(bvh.root)
    # Column S takes the pushes that do not fit; it is never read.
    stack_links = torch.full((B, S + 1), _NULL, dtype=i32, device=dev)
    stack_links[:, 0] = root
    stack_tmin = torch.full((B, S + 1), -math.inf, dtype=f32, device=dev)
    sp = torch.full((B,), 0 if root == _NULL else 1, dtype=i32, device=dev)
    best_t = torch.as_tensor(t_max, dtype=f32, device=dev).expand(B, P).clone()
    best_tri = torch.full((B, P), -1, dtype=i32, device=dev)
    steps = torch.zeros((), dtype=i32, device=dev)
    overflow = torch.zeros((), dtype=i32, device=dev)

    while bool((sp > 0).any()):
        active = sp > 0
        top = torch.clamp(sp - 1, min=0).long()
        link = torch.where(active, stack_links[barange, top], _NULL)
        t_entry = stack_tmin[barange, top]
        sp = sp - active.to(i32)

        # Prune entries that cannot beat any ray's best hit.
        valid = active & (link != _NULL) & (t_entry <= best_t.amax(dim=1))
        leaf = valid & ((link & L.COUNT_MASK) != 0)
        inner = valid & ((link & L.COUNT_MASK) == 0)
        idx = torch.clamp(link >> L.COUNT_BITS, min=0)
        inner_idx = torch.where(inner, idx, 0).long()
        leaf_idx = torch.where(leaf, idx, 0)

        # ---- inner nodes: all P rays vs 8 child boxes -----------------------
        clinks = node_links[inner_idx]  # (B, 8)
        t1, t2 = slab_test(
            node_box_min[inner_idx][:, None],  # (B, 1, 8, 3)
            node_box_max[inner_idx][:, None],
            rays.origin[:, :, None],  # (B, P, 1, 3)
            rays.inv_direction[:, :, None],
            best_t[:, :, None],
        )  # (B, P, 8)
        ray_hit = t1 <= t2
        child_any = ray_hit.any(dim=1) & (clinks != _NULL) & inner[:, None]
        child_tmin = torch.where(ray_hit, t1, math.inf).amin(dim=1)  # (B, 8)

        # Push far-first so the nearest child is popped first.
        order = torch.argsort(-torch.where(child_any, child_tmin, -math.inf), dim=1, stable=True)
        sorted_links = torch.gather(clinks, 1, order)
        sorted_any = torch.gather(child_any, 1, order)
        sorted_tmin = torch.gather(child_tmin, 1, order)
        any_i = sorted_any.to(i32)
        write_pos = torch.where(sorted_any, sp[:, None] + torch.cumsum(any_i, dim=1, dtype=i32) - any_i, S)
        overflow = overflow + (sorted_any & (write_pos >= S)).sum(dtype=i32)
        write_pos = torch.clamp(write_pos, max=S).long()
        stack_links.scatter_(1, write_pos, sorted_links)
        stack_tmin.scatter_(1, write_pos, sorted_tmin)
        sp = torch.clamp(sp + any_i.sum(dim=1, dtype=i32), max=S)

        # ---- leaves: all P rays vs one 8-triangle packet ---------------------
        tris = tri_packets[leaf_idx.long()]  # (B, 8, 3, 3)
        mask, t, _u, _v = moller_trumbore(
            tris[:, None, :, 0],  # (B, 1, 8, 3)
            tris[:, None, :, 1],
            tris[:, None, :, 2],
            rays.origin[:, :, None],
            rays.direction[:, :, None],
        )  # (B, P, 8)
        tvalid = mask & (t >= 0.0) & (t < best_t[:, :, None]) & leaf[:, None, None]
        tcand = torch.where(tvalid, t, math.inf)
        t_new, lane = tcand.min(dim=-1)  # the first lane of least t
        upd = t_new < best_t
        best_t = torch.where(upd, t_new, best_t)
        best_tri = torch.where(upd, leaf_idx[:, None] * L.LEAF_NODE_PACKET_SIZE + lane.to(i32), best_tri)

        # Continuation for multi-packet leaves.
        count = link & L.COUNT_MASK
        cont = leaf & (count > 1)
        cont_link = ((leaf_idx + 1) << L.COUNT_BITS) | torch.clamp(count - 1, min=1)
        cpos = torch.where(cont, sp, S)
        fits = cont & (cpos < S)
        overflow = overflow + (cont & ~fits).sum(dtype=i32)
        cpos = torch.clamp(cpos, max=S).long()
        stack_links[barange, cpos] = cont_link
        stack_tmin[barange, cpos] = t_entry
        sp = sp + fits.to(i32)
        steps = steps + 1

    miss = best_tri < 0
    return TraceResult(
        t=torch.where(miss, math.inf, best_t),
        tri=best_tri,
        steps=steps,
        overflow=overflow,
    )


def finalize_hits(bvh: BvhArrays, rays: Rays, result: TraceResult) -> HitRecords:
    """Shading data for closest hits (``ray_bvh_intersection.rs:66-95``):
    smooth normals by barycentric interpolation of the vertex normals unless
    the triangle is flat-shaded, and interpolated texture coordinates. The
    barycentrics are recomputed from the winning triangle (one gather)."""
    hit = result.tri >= 0
    safe_tri = torch.clamp(result.tri, min=0).long()
    verts = bvh.tri_packets[safe_tri >> 3, safe_tri & 7]  # (..., 3, 3)
    v0, v1, v2 = verts[..., 0, :], verts[..., 1, :], verts[..., 2, :]
    _, _, u, v = moller_trumbore(v0, v1, v2, rays.origin, rays.direction)
    u = torch.where(hit, u, 0.0)
    v = torch.where(hit, v, 0.0)

    vidx = bvh.tri_vidx[safe_tri].long()  # (..., 3)
    n = bvh.vert_normal[vidx]  # (..., 3, 3)
    smooth = barycentric_interpolate(u, v, n[..., 0, :], n[..., 1, :], n[..., 2, :])
    geom = triangle_geometric_normal(v0, v1, v2)
    flat = bvh.tri_flat[safe_tri]
    normal = torch.where(flat[..., None], geom, smooth)
    norm = torch.sqrt(torch.sum(normal * normal, dim=-1, keepdim=True))
    normal = normal / torch.where(norm > 0, norm, 1.0)

    uvs = bvh.vert_uv[vidx]
    texture_coords = barycentric_interpolate(u, v, uvs[..., 0, :], uvs[..., 1, :], uvs[..., 2, :])
    t = torch.where(hit, result.t, math.inf)
    point = rays.origin + rays.direction * torch.where(hit, result.t, 0.0)[..., None]
    return HitRecords(
        hit=hit,
        t=t,
        point=point,
        normal=normal,
        material=bvh.tri_material[safe_tri].to(torch.int32),
        texture_coords=texture_coords,
    )


def intersect_bvh(bvh: BvhArrays, rays: Rays, t_max=math.inf, stack_size: int = 64) -> HitRecords:
    """Trace and finalize in one call (the ``Object::intersect`` equivalent)."""
    return finalize_hits(bvh, rays, trace_packets(bvh, rays, t_max=t_max, stack_size=stack_size))


def trace_brute_force(tri_packets: torch.Tensor, rays: Rays, t_max=math.inf) -> TraceResult:
    """Oracle: the closest hit by testing every triangle against every ray.

    ``tri_packets`` is the BVH packet array ``(M, 8, 3, 3)`` (padding
    triangles are degenerate and never hit); memory grows as rays x
    triangles, so it suits small scenes and tests.
    """
    flat = tri_packets.reshape(-1, 3, 3)  # (M*8, 3, 3)
    o = rays.origin[..., None, :]  # (..., 1, 3)
    d = rays.direction[..., None, :]
    mask, t, _u, _v = moller_trumbore(flat[..., 0, :], flat[..., 1, :], flat[..., 2, :], o, d)
    valid = mask & (t >= 0.0) & (t < t_max)
    best, tri = torch.where(valid, t, math.inf).min(dim=-1)
    miss = ~torch.isfinite(best)
    return TraceResult(
        t=best,
        tri=torch.where(miss, -1, tri.to(torch.int32)),
        steps=torch.zeros((), dtype=torch.int32, device=best.device),
    )
