"""Materials, emissive-triangle lights and environments for the path tracer.

Port of ``minipath_tpu/scene/materials.py``: a table of Lambertian / metal /
dielectric / emissive materials indexed by the BVH's per-triangle ids, the
light table next-event estimation samples, and simple environment lights.

The JAX package packs each table into one row per entry and gathers rows,
because XLA:TPU lowers every small gather to a serial loop. On the card a
plain index of a small table is one kernel, so each field is indexed on its
own here; the values are the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
EMISSIVE = 3


class MaterialTable(NamedTuple):
    """Material parameters as tensors on one device, indexed by the BVH's
    per-triangle ids."""

    kind: torch.Tensor  # (n,) i32
    albedo: torch.Tensor  # (n, 3) f32
    emission: torch.Tensor  # (n, 3) f32
    param: torch.Tensor  # (n,) f32: fuzz for metal, ior for dielectric

    @property
    def device(self) -> torch.device:
        return self.kind.device


def lambertian(albedo) -> dict:
    return dict(kind=LAMBERTIAN, albedo=albedo, emission=(0, 0, 0), param=0.0)


def metal(albedo, fuzz: float = 0.0) -> dict:
    return dict(kind=METAL, albedo=albedo, emission=(0, 0, 0), param=fuzz)


def dielectric(ior: float = 1.5) -> dict:
    return dict(kind=DIELECTRIC, albedo=(1, 1, 1), emission=(0, 0, 0), param=ior)


def emissive(color, strength: float = 1.0) -> dict:
    c = np.asarray(color, np.float32) * strength
    return dict(kind=EMISSIVE, albedo=(0, 0, 0), emission=tuple(c), param=0.0)


def material_table(materials, device) -> MaterialTable:
    """A table on ``device`` from a list of material dicts (see the
    helpers); an empty list gives one grey Lambertian."""
    if not materials:
        materials = [lambertian((0.8, 0.8, 0.8))]
    return table_from_numpy(
        {
            "kind": np.asarray([m["kind"] for m in materials], np.int32),
            "albedo": np.asarray([m["albedo"] for m in materials], np.float32),
            "emission": np.asarray([m["emission"] for m in materials], np.float32),
            "param": np.asarray([m["param"] for m in materials], np.float32),
        },
        device,
    )


def _tensors(cls, fields, dtypes, device):
    return cls(
        **{
            name: torch.from_numpy(np.array(fields[name], dtypes.get(name, np.float32), copy=True)).to(device)
            for name in cls._fields
        }
    )


def table_from_numpy(fields, device) -> MaterialTable:
    """A :class:`MaterialTable` on ``device`` from a mapping of field name
    to array-like (the JAX package's ``MaterialTable._asdict()`` works as
    it is)."""
    return _tensors(MaterialTable, fields, {"kind": np.int32}, device)


class LightTable(NamedTuple):
    """Emissive-triangle table for next-event estimation.

    Every triangle lane whose material is EMISSIVE and whose area is not
    zero is a light (padding lanes are degenerate and fall out). Selection
    is power-weighted (area x mean emission) by an inverse-CDF lookup.
    Lights are two-sided, like the emission of ``scatter_full``.
    """

    v0: torch.Tensor  # (L, 3) f32
    e1: torch.Tensor  # (L, 3) f32 edge v1 - v0
    e2: torch.Tensor  # (L, 3) f32 edge v2 - v0
    normal: torch.Tensor  # (L, 3) f32 unit geometric normal
    area: torch.Tensor  # (L,) f32
    emission: torch.Tensor  # (L, 3) f32
    pmf: torch.Tensor  # (L,) f32 selection probability
    cdf: torch.Tensor  # (L,) f32 inclusive cumulative pmf
    tri_light: torch.Tensor  # (M*8,) i32 padded triangle id -> light id or -1


def light_table_from_numpy(fields, device) -> LightTable:
    """A :class:`LightTable` on ``device`` from a mapping of field name to
    array-like (the JAX package's ``LightTable._asdict()`` works as it is)."""
    return _tensors(LightTable, fields, {"tri_light": np.int32}, device)


def build_light_table(tri_packets, tri_material, materials: MaterialTable, device=None):
    """Build the light table on the host, in NumPy, and move it to
    ``device`` (default: the material table's). Returns ``None`` when the
    scene has no emissive triangle of non-zero power. ``tri_packets`` is
    the BVH's ``(M, 8, 3, 3)`` packed vertex array and ``tri_material`` its
    ``(M*8,)`` material ids (NumPy arrays or tensors)."""
    device = materials.device if device is None else torch.device(device)

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    tp = host(tri_packets).astype(np.float64).reshape(-1, 3, 3)
    mat = host(tri_material).astype(np.int64)
    kind = host(materials.kind)
    e1 = tp[:, 1] - tp[:, 0]
    e2 = tp[:, 2] - tp[:, 0]
    n = np.cross(e1, e2)
    area2 = np.linalg.norm(n, axis=-1)
    is_light = (kind[mat] == EMISSIVE) & (area2 > 0)
    idx = np.nonzero(is_light)[0]
    if idx.size == 0:
        return None
    # A spatially split BVH references one triangle from several leaves, so
    # one emitter can fill several lanes. Each physical emitter must be ONE
    # light (else its sampling density doubles while hit_light_pdf reports
    # one copy's pdf, which biases MIS): dedupe by exact vertex identity in
    # first-appearance order and map every duplicate lane to the shared id.
    key9 = tp[idx].reshape(idx.size, 9)
    _, first, inv = np.unique(key9, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    keep = idx[first[order]]  # one representative lane per emitter
    light_of_lane = rank[inv.reshape(-1)].astype(np.int32)

    emission = host(materials.emission).astype(np.float64)[mat[keep]]
    area = area2[keep] * 0.5
    power = area * emission.mean(axis=-1)
    if power.sum() <= 0.0:
        return None  # emissive materials of zero radiance: nothing to sample
    pmf = power / power.sum()
    cdf = np.cumsum(pmf)
    cdf[-1] = 1.0
    tri_light = np.full(mat.shape[0], -1, np.int32)
    tri_light[idx] = light_of_lane
    return light_table_from_numpy(
        dict(
            v0=tp[keep, 0],
            e1=e1[keep],
            e2=e2[keep],
            normal=n[keep] / area2[keep, None],
            area=area,
            emission=emission,
            pmf=pmf,
            cdf=cdf,
            tri_light=tri_light,
        ),
        device,
    )


def material_rows(materials: MaterialTable, mat_id: torch.Tensor):
    """Per-lane material parameters: ``(kind i32, param, albedo (..., 3),
    emission (..., 3))``."""
    i = mat_id.long()
    return materials.kind[i], materials.param[i], materials.albedo[i], materials.emission[i]


def sample_lights(lights: LightTable, generator, x: torch.Tensor, strat=None):
    """Sample one light point per shading point ``x`` ``(N, 3)``.

    Returns ``(y, wi, pdf_solid, emission, cos_y, li)``: the light point, the
    unit direction to it, the solid-angle pdf of that direction (selection
    pmf x area-to-solid-angle), the light's radiance, the two-sided cosine
    at the light, and the light's index.

    ``strat`` is ``None`` (iid uniforms from ``generator``) or ``(s, pid,
    spp, salt)``: the light choice and the point on the triangle then come
    from per-pixel strata (:mod:`minipath_tpu_torch.render.stratify`). With
    a negative ``spp`` (Owen-scrambled Sobol) nothing is drawn from
    ``generator``, which may be None.
    """
    from minipath_tpu_torch.render.stratify import strat1d, strat2d

    n = x.shape[0]
    sobol = strat is not None and strat[2] < 0

    def uniform(*shape):
        return None if sobol else torch.rand(shape, generator=generator, device=x.device)

    u = uniform(n)
    if strat is not None:
        s_idx, pid, spp, salt = strat
        u = strat1d(u, s_idx, pid, spp, salt + 0)
    li = torch.searchsorted(lights.cdf, u).clamp(0, lights.cdf.shape[0] - 1)
    v0, e1, e2 = lights.v0[li], lights.e1[li], lights.e2[li]
    ln, em = lights.normal[li], lights.emission[li]
    pmf, area = lights.pmf[li], lights.area[li]
    r = uniform(n, 2)
    r0, r1 = (None, None) if r is None else (r[:, 0], r[:, 1])
    if strat is not None:
        r0, r1 = strat2d(r0, r1, s_idx, pid, spp, salt + 1)
    s = torch.sqrt(r0)
    bu = (1.0 - s)[:, None]
    bv = (r1 * s)[:, None]
    y = v0 + bu * e1 + bv * e2
    seg = y - x
    dist2 = torch.sum(seg * seg, dim=-1)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-12))
    wi = seg / dist[:, None]
    cos_y = torch.abs(torch.sum(wi * ln, dim=-1))
    pdf_solid = pmf / area * dist2 / torch.clamp(cos_y, min=1e-8)
    return y, wi, pdf_solid, em, cos_y, li


def hit_light_pdf(lights: LightTable, tri: torch.Tensor, direction: torch.Tensor, t: torch.Tensor):
    """Solid-angle pdf with which NEE would have sampled the emitter that a
    BSDF ray hit (``tri`` padded triangle ids, unit ``direction``, distance
    ``t``): the other half of the MIS power heuristic. 0 off the lights."""
    li = lights.tri_light[tri.clamp(min=0).long()]
    valid = (tri >= 0) & (li >= 0)
    lis = li.clamp(min=0).long()
    cos_y = torch.abs(torch.sum(direction * lights.normal[lis], dim=-1))
    pdf = lights.pmf[lis] / lights.area[lis] * (t * t) / torch.clamp(cos_y, min=1e-8)
    return torch.where(valid, pdf, torch.zeros_like(pdf))


class Environment(NamedTuple):
    """Environment light ``color(d) = mix(horizon, zenith, (d.y + 1) / 2)``.

    Both colours equal give a uniform environment; zeros give darkness.
    """

    horizon: torch.Tensor  # (3,) f32
    zenith: torch.Tensor  # (3,) f32

    @classmethod
    def gradient(cls, horizon, zenith, device) -> "Environment":
        def t(c):
            return torch.tensor(np.asarray(c, np.float32), device=device)

        return cls(horizon=t(horizon), zenith=t(zenith))

    @classmethod
    def uniform(cls, color, device) -> "Environment":
        return cls.gradient(color, color, device)

    @classmethod
    def sky(cls, device) -> "Environment":
        return cls.gradient([1.0, 1.0, 1.0], [0.5, 0.7, 1.0], device)

    @classmethod
    def none(cls, device) -> "Environment":
        return cls.gradient([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], device)

    def radiance(self, direction: torch.Tensor) -> torch.Tensor:
        """Environment radiance for ``(..., 3)`` directions."""
        t = (direction[..., 1] + 1.0) * 0.5
        return self.horizon * (1.0 - t[..., None]) + self.zenith * t[..., None]
