"""Plain reference of the path tracer's estimate with light sampling: the
estimator for scenes whose emitters BSDF sampling alone cannot find.

An independent estimator of the same pixel integral as the port's wavefront
path tracer (``render_frame_pt``) with next-event estimation at every vertex
over ``bounces`` closest-hit traces. At every Lambertian and glossy vertex it
takes one area sample of the emitters (an emitter by its power, area x mean
radiance; a point uniform on it) with its own shadow test, and continues the
path by one BSDF sample; the two strategies are combined by the balance
heuristic, w = p / (p_light + p_bsdf), each density computed here from its
definition (the light's over solid angle, the cosine lobe's cos / pi, the
Phong lobe's (n + 1) / (2 pi) cos^n). The program combines them by the power
heuristic: the weights differ vertex by vertex and agree only in their sum,
so a fault of the program's weights, or of its densities, changes its
estimate and not the reference's. The camera's emission, and a delta lobe's,
takes full weight.

Pure light sampling at a Lambertian vertex (with the emission its BSDF ray
hits left uncounted) is unbiased too, but its 1 / d^2 tail at the vertices
beside the panel, on its skirt and the ceiling above it, is too heavy for a
check: three such estimates at 64, 128 and 256 paths a pixel read 1.04, 0.92
and 0.84 of the same frames' mean on the card.

The program also samples a light at the last vertex, whose BSDF ray is
never traced, with the power heuristic's weight: that weighted part of the
paths one segment longer belongs to the integral it computes. At the last
vertex the reference therefore weighs its light sample by
p_light^2 / (p_light^2 + p_bsdf^2), from its own densities.

The camera rays, material models, self-intersection offset, f16 shading
normals and closest-hit traversal are ``pathtrace.py``'s and ``trace.py``'s;
the occlusion test is a traversal of its own over the reference's tree,
bounded by the segment's length (the light end pulled back by the offset, as
the surface end is pushed off). No roulette, no compaction, no environment:
a path ends on a miss, at an emitter, or when its metal lobe goes below the
surface.

Every float is computed in ``dtype``. This module imports torch and NumPy
only.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import bvh, parity, pathtrace, trace
from .pathtrace import EMISSIVE, EPS, GLOSSY_MIN_FUZZ, LAMBERTIAN, METAL

KINDS = {"lambertian": LAMBERTIAN, "metal": METAL, "dielectric": pathtrace.DIELECTRIC, "emissive": EMISSIVE}


class Lights(NamedTuple):
    """The emissive triangles, in ``dtype``."""

    v0: torch.Tensor  # (L, 3)
    e1: torch.Tensor  # (L, 3)
    e2: torch.Tensor  # (L, 3)
    normal: torch.Tensor  # (L, 3) unit
    radiance: torch.Tensor  # (L, 3)
    pick: torch.Tensor  # (L,) probability of choosing the emitter
    cdf: torch.Tensor  # (L,) inclusive
    density: torch.Tensor  # (L,) pick / area: the sample's density over area
    tri_light: torch.Tensor  # (T,) int64: the light a triangle is, -1 for none


def material_table(materials, device, dtype=torch.float32) -> dict:
    """Materials given as ``atrium.MATERIALS`` gives them, as tensors."""
    kind = torch.tensor([KINDS[m[0]] for m in materials], device=device)
    albedo = torch.tensor([(0.0,) * 3 if m[0] == "emissive" else m[1] for m in materials])
    param = torch.tensor([{"metal": m[2], "dielectric": m[3]}.get(m[0], 0.0) for m in materials])
    emission = torch.tensor(np.array([np.float32(m[1]) * np.float32(m[4]) if m[0] == "emissive" else (0.0,) * 3
                                      for m in materials], np.float32))
    return {"kind": kind, "albedo": albedo.to(device, dtype), "param": param.to(device, dtype),
            "emission": emission.to(device, dtype)}


def light_table(positions: np.ndarray, triangles: np.ndarray, tri_material: np.ndarray, materials, device,
                dtype=torch.float32) -> Lights:
    """The triangles whose material emits, each chosen by its power."""
    emits = np.array([m[0] == "emissive" for m in materials])[tri_material]
    tv = positions[triangles[emits]].astype(np.float64)
    e1, e2 = tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]
    cross = np.cross(e1, e2)
    twice = np.linalg.norm(cross, axis=-1)
    radiance = np.array([np.float32(m[1]) * np.float32(m[4]) if m[0] == "emissive" else (0.0,) * 3
                         for m in materials], np.float64)[tri_material[emits]]
    power = 0.5 * twice * radiance.mean(axis=-1)
    pick = power / power.sum()
    cdf = np.cumsum(pick)
    cdf[-1] = 1.0

    tri_light = np.full(tri_material.shape[0], -1, np.int64)
    tri_light[emits] = np.arange(int(emits.sum()))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    return Lights(t(tv[:, 0]), t(e1), t(e2), t(cross / twice[:, None]), t(radiance), t(pick), t(cdf),
                  t(pick / (0.5 * twice)), torch.from_numpy(tri_light).to(device))


def occluded(scene: trace.Scene, origin: torch.Tensor, direction: torch.Tensor, t_max: torch.Tensor,
             stack_size: int = 128) -> torch.Tensor:
    """``(R,)`` bool: whether a triangle lies at a distance in ``[0, t_max)``
    along each ray (``direction`` unit length). ``trace.trace``'s lockstep
    loop with the rays' best distance starting at ``t_max``, so boxes beyond
    it are never entered, and a ray's search ending at its first blocker."""
    dev, dt = origin.device, scene.box.dtype
    R = origin.shape[0]
    o, d = origin.to(dt), direction.to(dt)
    inv = torch.where(d == 0.0, torch.full_like(d, math.inf), 1.0 / d).clamp(-trace.BIG, trace.BIG)
    best_t = t_max.to(dt).clone()
    best_tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(R, dtype=dt, device=dev)
    best_v = torch.zeros(R, dtype=dt, device=dev)
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
            box = scene.box[n]
            oa, ia = o[a][:, None, :], inv[a][:, None, :]
            t0 = (box[..., 0:3] - oa) * ia
            t1 = (box[..., 3:6] - oa) * ia
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            near = torch.maximum(torch.clamp(lo[..., 0], min=0.0), torch.maximum(lo[..., 1], lo[..., 2]))
            far = torch.minimum(torch.minimum(hi[..., 0], best_t[a][:, None]), torch.minimum(hi[..., 1], hi[..., 2]))
            clinks = scene.links[n]
            hit = (near <= far) & (clinks != bvh.NULL)
            pos = sp[a][:, None] + torch.cumsum(hit, dim=1) - hit.long()
            if bool((hit & (pos >= stack_size)).any()):
                raise RuntimeError("reference occlusion test: stack overflow")
            rows = a[:, None].expand(-1, 8)[hit]
            st_link[rows, pos[hit]] = clinks[hit]
            st_t[rows, pos[hit]] = near[hit]
            sp[a] += hit.sum(dim=1)

        a = act[~inner]
        if a.numel():
            first, cnt = bvh.decode_leaf(link[~inner])
            for j in range(int(cnt.max())):
                m = cnt > j
                trace._leaf_packet(scene.tri, first[m] + j, a[m], o, d, best_t, best_tri, best_u, best_v)
            sp[a[best_tri[a] >= 0]] = 0
    return best_tri >= 0


def phong_density(param: torch.Tensor, cos_a: torch.Tensor) -> torch.Tensor:
    """Solid-angle density of the metal's lobe (``pathtrace._scatter``:
    cos a = u^(1 / (n + 1)), n = 2 / fuzz^2 - 2) at angle a from its axis."""
    n = 2.0 / torch.clamp(param, min=GLOSSY_MIN_FUZZ) ** 2 - 2.0
    c = torch.clamp(cos_a, min=0.0)
    return torch.where(c > 0.0, (n + 1.0) / (2.0 * math.pi) * c ** n, torch.zeros_like(c))


def bsdf_density(mats: dict, mat, d, nf, w) -> torch.Tensor:
    """Solid-angle density with which ``pathtrace._scatter`` samples the
    direction ``w`` at a Lambertian or glossy vertex (incoming ``d``, facing
    normal ``nf``): cos / pi about ``nf``, or the Phong lobe about the
    mirror direction."""
    mirror = pathtrace._normalize(d - 2.0 * pathtrace._dot(d, nf) * nf)
    lobe = phong_density(mats["param"][mat], pathtrace._dot(w, mirror)[:, 0])
    return torch.where(mats["kind"][mat] == METAL, lobe, torch.clamp(pathtrace._dot(w, nf)[:, 0], min=0.0) / math.pi)


def light_density(lights: Lights, light, direction, dist2) -> torch.Tensor:
    """Solid-angle density with which the light sample reaches the point of
    the emitter ``light`` at squared distance ``dist2`` along ``direction``."""
    cos_y = torch.abs(pathtrace._dot(direction, lights.normal[light]))[:, 0]
    return lights.density[light] * dist2 / cos_y


def direct(scene: trace.Scene, lights: Lights, mats: dict, gen, point, nf, d, mat, last: bool):
    """``(k, 3)`` light one area sample of the emitters brings to each
    vertex (``point``, facing normal ``nf``, incoming direction ``d``,
    material ``mat``) toward the eye, per unit throughput, where its segment
    is unblocked: weighed against the vertex's BSDF sampling by the balance
    heuristic, or at the ``last`` vertex by the power heuristic."""
    dev, dt, k = point.device, point.dtype, point.shape[0]
    u = torch.rand((k, 3), generator=gen, device=dev).to(dt)
    i = torch.searchsorted(lights.cdf, u[:, 0:1].contiguous()).squeeze(1).clamp(max=lights.cdf.shape[0] - 1)
    s = torch.sqrt(u[:, 1:2])
    y = lights.v0[i] + (1.0 - s) * lights.e1[i] + (u[:, 2:3] * s) * lights.e2[i]
    x = point + nf * EPS
    to = y - x
    dist2 = pathtrace._dot(to, to)[:, 0]
    dist = torch.sqrt(dist2)
    wi = to / torch.clamp(dist, min=1e-12)[:, None]
    cos_x = pathtrace._dot(wi, nf)[:, 0]
    light_pdf = light_density(lights, i, wi, dist2)
    bsdf_pdf = bsdf_density(mats, mat, d, nf, wi)
    # The BSDF times the cosine: albedo / pi x cos for the Lambertian lobe,
    # albedo x the lobe's density for the metal's (each lobe's weight is
    # its albedo), zero below the surface.
    f_cos = mats["albedo"][mat] * torch.where(cos_x > 0.0, bsdf_pdf, torch.zeros_like(bsdf_pdf))[:, None]
    # Each weight as 1 / (1 + ratio), which a density past the float range
    # (a light seen edge-on) takes to 0 or 1 and not to inf / inf.
    ratio = bsdf_pdf / light_pdf
    weight = 1.0 / (1.0 + (ratio * ratio if last else ratio))
    value = f_cos * lights.radiance[i] * (weight / light_pdf)[:, None]

    live = torch.nonzero((cos_x > 0.0) & (light_pdf > 0.0) & torch.isfinite(light_pdf)).squeeze(1)
    lit = torch.zeros(k, dtype=torch.bool, device=dev)
    if live.numel():
        lit[live] = ~occluded(scene, x[live], wi[live], dist[live] - EPS)
    return torch.where(lit[:, None], value, torch.zeros_like(value))


def radiance(scene: trace.Scene, unit_vnorm, tri_material, mats, lights: Lights, origin, direction, bounces: int,
             gen):
    """Per-path radiance ``(n, 3)`` of camera rays."""
    dev, dt = origin.device, scene.box.dtype
    n = origin.shape[0]
    o, d = origin.to(dt).clone(), direction.to(dt).clone()
    thr = torch.ones((n, 3), dtype=dt, device=dev)
    rad = torch.zeros((n, 3), dtype=dt, device=dev)
    # The density of the BSDF sample that made each path's ray; 0 from the
    # camera and from a delta lobe, whose emitter hits take full weight.
    prev_pdf = torch.zeros(n, dtype=dt, device=dev)
    live = torch.arange(n, device=dev)
    for bounce in range(bounces):
        if live.numel() == 0:
            break
        h = trace.trace(scene, o[live], d[live])
        hit = h.tri >= 0
        live, h = live[hit], h._replace(t=h.t[hit], tri=h.tri[hit], u=h.u[hit], v=h.v[hit])
        dl = d[live]
        mat = tri_material[h.tri]
        new, atten, emitted, stop, nf = pathtrace._scatter(mats, gen, dl, trace.shade_normal(unit_vnorm, h), mat)
        light = lights.tri_light[h.tri]
        pb = prev_pdf[live]
        pl = light_density(lights, light.clamp(min=0), dl, h.t * h.t)
        w_bsdf = torch.where((pb > 0.0) & (light >= 0), 1.0 / (1.0 + pl / pb), torch.ones_like(pb))
        rad[live] += thr[live] * emitted * w_bsdf[:, None]
        point = o[live] + dl * h.t[:, None]
        kind = mats["kind"][mat]
        # Lambertian and glossy vertices: a light sample and a BSDF sample.
        sampled = (kind == LAMBERTIAN) | ((kind == METAL) & (mats["param"][mat] >= GLOSSY_MIN_FUZZ))
        at = torch.nonzero(sampled).squeeze(1)
        if at.numel():
            rad[live[at]] += thr[live[at]] * direct(scene, lights, mats, gen, point[at], nf[at], dl[at], mat[at],
                                                    bounce == bounces - 1)
        thr[live] = thr[live] * atten
        side = torch.where(pathtrace._dot(new, nf) >= 0, nf, -nf)
        o[live] = point + side * EPS
        d[live] = new
        prev_pdf[live] = torch.where(sampled, bsdf_density(mats, mat, dl, nf, new), torch.zeros_like(pb))
        live = live[~stop]
    return rad


def estimate_pixels(scene, unit_vnorm, tri_material, mats, lights: Lights, lens: parity.Lens, resolution,
                    pixels: np.ndarray, paths: int, bounces: int, seed: int, block: int = 1 << 18):
    """``(sum (n, 3), sum of squares (n,))`` over ``paths`` path radiances at
    each of ``pixels`` ``(n, 2)``, in float64: the radiances' RGB and the
    squares of their channel sums, from iid film and lens samples drawn from
    ``seed``."""
    dev, dt = scene.box.device, scene.box.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cam = parity.sampler(lens, resolution, dev, dt)
    px = torch.from_numpy(np.repeat(pixels, paths, axis=0)).to(dev)
    owner = torch.arange(len(pixels), device=dev).repeat_interleave(paths)
    total = torch.zeros((len(pixels), 3), dtype=torch.float64, device=dev)
    squares = torch.zeros(len(pixels), dtype=torch.float64, device=dev)
    zero = torch.zeros(min(block, len(px)), dtype=torch.int64, device=dev)
    for i in range(0, len(px), block):
        p, who = px[i:i + block], owner[i:i + block]
        u = torch.rand((len(p), 4), generator=gen, device=dev).to(dt)
        o, d = parity.camera_rays(cam, p[:, 0], p[:, 1], zero[:len(p)], 1, 0, u[:, :2], u[:, 2:])
        r = radiance(scene, unit_vnorm, tri_material, mats, lights, o, d, bounces, gen).double()
        total.index_add_(0, who, r)
        squares.index_add_(0, who, r.sum(dim=1) ** 2)
    return total, squares
