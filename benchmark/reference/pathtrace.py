"""Plain reference of the path tracer's estimate: BSDF sampling only.

An independent estimator of the same pixel integral as the port's wavefront
path tracer (``render_frame_pt``): thin-lens camera rays with iid film and
lens samples, the closest hit by the plain traversal of ``trace.py`` over the
reference's own tree, and at each hit the emission (two-sided emitters, which
end the path), then one BSDF sample: cosine-weighted Lambertian, a normalized
Phong lobe about the mirror direction for metal (a ray below the surface is
absorbed), Schlick's reflect-or-refract choice for glass. A miss takes the
sky. The path is traced ``bounces`` times. Next-event estimation with MIS,
Russian roulette, strata and compaction change the port's variance and not
its expectation, so they are left out here.

The material models, the sky, the self-intersection offset of 1e-3 along the
facing normal (along the new direction's side for a transmission) and the
shading normals (interpolated from unit vertex normals held in float16) are
copied from the port as they stood when the benchmark was defined
(``render/wavefront.py``, ``scene/materials.py``, ``render/kernels.py``).

Every float is computed in ``dtype``. This module imports torch and NumPy
only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import atrium, parity, trace

EPS = 1e-3
LAMBERTIAN, METAL, DIELECTRIC, EMISSIVE = 0, 1, 2, 3
GLOSSY_MIN_FUZZ = 1e-3
SKY = ((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))  # horizon, zenith


def material_table(device, dtype=torch.float32) -> dict:
    """The benchmark's materials (``atrium.MATERIALS``) as tensors."""
    kinds = {"lambertian": LAMBERTIAN, "metal": METAL, "dielectric": DIELECTRIC, "emissive": EMISSIVE}
    kind = torch.tensor([kinds[m[0]] for m in atrium.MATERIALS], device=device)
    albedo = torch.tensor([(0.0,) * 3 if m[0] == "emissive" else m[1] for m in atrium.MATERIALS])
    param = torch.tensor([{"metal": m[2], "dielectric": m[3]}.get(m[0], 0.0) for m in atrium.MATERIALS])
    emission = torch.tensor(np.array([np.float32(m[1]) * np.float32(m[4]) if m[0] == "emissive" else (0.0,) * 3
                                      for m in atrium.MATERIALS], np.float32))
    return {"kind": kind, "albedo": albedo.to(device, dtype), "param": param.to(device, dtype),
            "emission": emission.to(device, dtype)}


def unit_shading_normals(vnorm: torch.Tensor) -> torch.Tensor:
    """Vertex normals (``trace.shading_normals``) made unit and held in
    float16, as the port's lean layout holds them."""
    length = torch.sqrt(torch.sum(vnorm.float() * vnorm.float(), dim=-1, keepdim=True))
    return (vnorm.float() / torch.clamp(length, min=1e-20)).half().to(vnorm.dtype)


def _normalize(v):
    return v * torch.rsqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-30))


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _scatter(mats, gen, d, n, mat):
    """One BSDF sample: ``(new direction, attenuation, emitted, terminate)``."""
    dev, dt, k = d.device, d.dtype, d.shape[0]

    def rand(*shape):
        return torch.rand((k, *shape), generator=gen, device=dev).to(dt)

    kind, param, albedo, emission = mats["kind"][mat], mats["param"][mat], mats["albedo"][mat], mats["emission"][mat]
    front = _dot(d, n) < 0.0
    nf = torch.where(front, n, -n)
    u = rand(2)
    z = -1.0 + 2.0 * u[:, 0]
    phi = 2.0 * math.pi * u[:, 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    lam = _normalize(nf + torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1))
    lam = torch.where(_dot(lam, nf) <= 1e-6, nf, lam)

    refl = _normalize(d - 2.0 * _dot(d, nf) * nf)
    n_exp = 2.0 / torch.clamp(param, min=GLOSSY_MIN_FUZZ) ** 2 - 2.0
    u = rand(2)
    cos_a = torch.exp(torch.log(torch.clamp(u[:, 0], min=1e-12)) / (n_exp + 1.0))
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    phi = 2.0 * math.pi * u[:, 1]
    flip = (torch.abs(refl[:, 0:1]) > 0.9).to(dt)
    a = torch.cat([1.0 - flip, flip, torch.zeros_like(flip)], dim=-1)
    t1 = _normalize(torch.linalg.cross(a, refl, dim=-1))
    t2 = torch.linalg.cross(refl, t1, dim=-1)
    lobe = refl * cos_a[:, None] + t1 * (sin_a * torch.cos(phi))[:, None] + t2 * (sin_a * torch.sin(phi))[:, None]
    met = torch.where((param >= GLOSSY_MIN_FUZZ)[:, None], lobe, refl)
    absorbed = torch.sum(met * nf, dim=-1) <= 0.0

    ior = torch.clamp(param, min=1.0001)
    eta = torch.where(front[:, 0], 1.0 / ior, ior)[:, None]
    cos_t = torch.clamp(-_dot(d, nf), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    schlick = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    reflect = (eta * sin_t > 1.0) | (schlick > rand()[:, None])
    perp = eta * (d + cos_t * nf)
    para = -torch.sqrt(torch.abs(1.0 - _dot(perp, perp))) * nf
    die = torch.where(reflect, refl, _normalize(perp + para))

    is_lam, is_met = (kind == LAMBERTIAN)[:, None], (kind == METAL)[:, None]
    is_die, is_emi = (kind == DIELECTRIC)[:, None], kind == EMISSIVE
    new = torch.where(is_lam, lam, torch.where(is_met, met, torch.where(is_die, die, nf)))
    atten = torch.where(is_die, torch.ones_like(albedo), torch.where(is_emi[:, None], torch.zeros_like(albedo), albedo))
    emitted = torch.where(is_emi[:, None], emission, torch.zeros_like(emission))
    return new, atten, emitted, is_emi | (is_met[:, 0] & absorbed), nf


def radiance(scene: trace.Scene, unit_vnorm, tri_material, mats, origin, direction, bounces: int, gen):
    """Per-path radiance ``(n, 3)`` of camera rays."""
    dev, dt = origin.device, scene.box.dtype
    n = origin.shape[0]
    o, d = origin.to(dt), direction.to(dt)
    thr = torch.ones((n, 3), dtype=dt, device=dev)
    rad = torch.zeros((n, 3), dtype=dt, device=dev)
    live = torch.arange(n, device=dev)
    horizon, zenith = (torch.tensor(c, device=dev, dtype=dt) for c in SKY)
    for _ in range(bounces):
        if live.numel() == 0:
            break
        h = trace.trace(scene, o[live], d[live])
        hit = h.tri >= 0
        dl = d[live]
        t_sky = (dl[:, 1] + 1.0) * 0.5
        sky = horizon * (1.0 - t_sky[:, None]) + zenith * t_sky[:, None]
        rad[live[~hit]] += thr[live[~hit]] * sky[~hit]
        live, h, dl = live[hit], h._replace(t=h.t[hit], tri=h.tri[hit], u=h.u[hit], v=h.v[hit]), dl[hit]
        nrm = trace.shade_normal(unit_vnorm, h)
        new, atten, emitted, stop, nf = _scatter(mats, gen, dl, nrm, tri_material[h.tri])
        rad[live] += thr[live] * emitted
        thr[live] = thr[live] * atten
        point = o[live] + dl * h.t[:, None]
        side = torch.where(_dot(new, nf) >= 0, nf, -nf)
        o[live] = point + side * EPS
        d[live] = new
        live = live[~stop]
    return rad


def estimate_pixels(scene, unit_vnorm, tri_material, mats, lens: parity.Lens, resolution, pixels: np.ndarray,
                    paths: int, bounces: int, seed: int, block: int = 1 << 18):
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
        r = radiance(scene, unit_vnorm, tri_material, dict(mats), o, d, bounces, gen).double()
        total.index_add_(0, who, r)
        squares.index_add_(0, who, r.sum(dim=1) ** 2)
    return total, squares
