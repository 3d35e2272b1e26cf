"""Wavefront path tracer.

Port of ``minipath_tpu/render/wavefront.py``: per-bounce structure-of-arrays
ray queues over the lean traversal kernel (K2, ``render/kernels.py``, or K3
in lean mode over a quantized ``QPTScene``, ``render/kernels_q.py``), masked
BSDF sampling (Lambertian, metal with a Phong lobe, dielectric, emissive),
next-event estimation with the MIS power heuristic, Russian roulette, and a
sort-based compaction that moves dead paths to a suffix and regroups live
ones by direction and position between bounces. The bounce loop is PyTorch
around the kernels; it keeps the live-ray and shadow-candidate counts on the
device and hands them to the kernels as tensors, so a frame makes no host
sync per bounce. A bounce's shading (everything between a closest-hit trace
and the next compaction or trace, but the shadow trace) is one launch of the
bounce-shading kernel on a card (:func:`_shade_kernel`, ``render/shade.py``)
and plain PyTorch elsewhere (:func:`_shade_plain`, the kernel's reference);
the two agree bit for bit on the card. The compaction likewise is two
kernels around one ``torch.sort`` on a card (:func:`_compact_kernel`,
``render/compact.py``) and plain PyTorch elsewhere (:func:`_compact_plain`),
and so is a NEE bounce's shadow batch, from the shading kernel's query to the
light it adds (:func:`_shadow_light_kernel`, ``render/shadow.py``, and
:func:`_shadow_light_plain`).

Random numbers come from an explicit ``torch.Generator`` in place of
``jax.random`` keys. In Sobol mode (``sobol=True``) every camera, BSDF and
light dimension is a pure function of (pixel, sample, seed) and nothing is
drawn from the generator for them; only shadow-ray and path roulette stay
iid.

:func:`render_frame_pt` with a ``mesh`` runs the whole bounce loop per
device of the mesh, each shard on its own range of pixel blocks; without
one, the frame is the one shard.

The tracers come in three families with one contract: the lean kernels'
(:func:`make_pt_tracer`, :func:`make_pt_shadow_tracer`), the full kernels'
(:func:`make_full_tracer`), and the portable engine's
(:func:`make_portable_tracer`, :func:`make_portable_shadow_tracer`), which
share no code with the kernels and serve as an independent engine. On the
CPU a kernel tracer runs the kernel's plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from minipath_tpu_torch.camera import CameraSampler
from minipath_tpu_torch.geometry.ray import Rays
from minipath_tpu_torch.parallel import frame_shards, gather
from minipath_tpu_torch.render import shadow as shadow_passes
from minipath_tpu_torch.render.compact import key_pass, permute_pass
from minipath_tpu_torch.render.frame import gen_rays9_blocks, rays9_to_rays, unpack_frame
from minipath_tpu_torch.render.kernels import KernelHits, KernelScene, PTHits, PTScene, _live_count, trace_packets_pt
from minipath_tpu_torch.render.kernels_q import QPTScene, QuantizedScene, trace_packets_q, trace_scene
from minipath_tpu_torch.render.shade import STRAT_JITTER, STRAT_SOBOL
from minipath_tpu_torch.render.shade import launch as launch_shade
from minipath_tpu_torch.render.stratify import grid_factor, render_seed, strat1d, strat2d
from minipath_tpu_torch.render.traversal import finalize_hits, trace_packets
from minipath_tpu_torch.scene.bvh.build import BvhArrays
from minipath_tpu_torch.scene.materials import (
    DIELECTRIC,
    EMISSIVE,
    LAMBERTIAN,
    METAL,
    Environment,
    LightTable,
    MaterialTable,
    hit_light_pdf,
    material_rows,
    sample_lights,
)
from minipath_tpu_torch.utils.profiling import count, new_request, recording, span

_EPS = 1e-3  # self-intersection offset along the facing normal
_PI = np.pi


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _normalize(v):
    return v * torch.rsqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-30))


def _unit_vector_from_uniforms(u_z, u_phi):
    """Uniform sphere directions ``(..., 3)`` from two [0, 1) uniforms."""
    z = -1.0 + 2.0 * u_z
    phi = 2.0 * _PI * u_phi
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def _reflect(d, n):
    return d - 2.0 * _dot(d, n) * n


# Fuzz below this is a perfect mirror (delta lobe, no pdf); at or above it
# the metal is a Phong lobe that NEE can cover.
GLOSSY_MIN_FUZZ = 1e-3


def phong_exponent(fuzz):
    """Cosine-power exponent matched to the metal ``fuzz`` parameter by the
    roughness mapping ``n = 2 / fuzz^2 - 2``."""
    return 2.0 / torch.clamp(fuzz, min=GLOSSY_MIN_FUZZ) ** 2 - 2.0


def phong_pdf(n_exp, cos_alpha):
    """Solid-angle pdf of the normalized cosine-power lobe at angle
    ``alpha`` from its axis."""
    c = torch.clamp(cos_alpha, 0.0, 1.0)
    powed = torch.exp(n_exp * torch.log(torch.clamp(c, min=1e-12)))
    return torch.where(c > 0.0, (n_exp + 1.0) / (2.0 * _PI) * powed, torch.zeros_like(c))


def _orthobasis(w):
    """Two unit tangents orthogonal to unit vectors ``w`` ``(..., 3)``."""
    # a = +y where |w.x| > 0.9, else +x (built on the device: a tensor made
    # from host values would cost a host sync per call).
    flip = (torch.abs(w[..., 0:1]) > 0.9).to(w.dtype)
    a = torch.cat([1.0 - flip, flip, torch.zeros_like(flip)], dim=-1)
    t1 = _normalize(torch.linalg.cross(a, w, dim=-1))
    t2 = torch.linalg.cross(w, t1, dim=-1)
    return t1, t2


def _uniforms(generator, shape, device, sobol: bool):
    """iid [0, 1) uniforms from ``generator``, or None where Sobol points
    replace them."""
    return None if sobol else torch.rand(shape, generator=generator, device=device)


def scatter_full(materials: MaterialTable, generator, direction, normal, mat_id, strat=None):
    """Masked BSDF sampling for a batch of hits, with the MIS inputs NEE
    needs.

    Takes ``(..., 3)`` ray directions and shading normals and ``(...)``
    material ids. Returns ``(new_direction, attenuation, emitted, terminate,
    pdf, diffuse)``: ``pdf`` is the solid-angle pdf of the sampled direction
    for the sampleable lobes (cosine-weighted Lambertian, glossy metal) and 0
    for delta and emissive lanes; ``diffuse`` marks Lambertian lanes. Every
    branch is computed and selected per lane.

    Fuzzy metal is a normalized Phong lobe about the mirror direction
    (:func:`phong_exponent`); its implied BRDF is ``albedo * phong_pdf /
    cos_in``, so lobe sampling carries exactly ``albedo`` per bounce.

    ``strat`` is ``None`` (iid uniforms from ``generator``) or ``(s, pid,
    spp, salt)``: the Lambertian sphere sample, the glossy lobe sample and
    the dielectric reflect/refract choice then come from per-pixel strata
    (:mod:`minipath_tpu_torch.render.stratify`), and with a negative ``spp``
    (Sobol) nothing is drawn from ``generator``.
    """
    kind, param, albedo, emission = material_rows(materials, mat_id)
    dev = direction.device
    batch = tuple(mat_id.shape)
    sobol = strat is not None and strat[2] < 0

    d_dot_n = _dot(direction, normal)
    front = d_dot_n < 0.0  # the ray hits the front face
    nf = torch.where(front, normal, -normal)  # facing normal

    # Lambertian: cosine-weighted through (nf + unit vector), the sphere
    # sample drawn from explicit (z, phi) uniforms so strata can tile them.
    u_z = _uniforms(generator, batch, dev, sobol)
    u_phi = _uniforms(generator, batch, dev, sobol)
    if strat is not None:
        s_idx, pid, spp, salt = strat
        u_z, u_phi = strat2d(u_z, u_phi, s_idx, pid, spp, salt + 0)
    lam_dir = _normalize(nf + _unit_vector_from_uniforms(u_z, u_phi))
    # Guard the degenerate case (unit vector ~ -nf).
    lam_bad = torch.sum(lam_dir * nf, dim=-1, keepdim=True) <= 1e-6
    lam_dir = torch.where(lam_bad, nf, lam_dir)

    # Metal: a perfect mirror when fuzz ~ 0, else a cosine-power lobe about
    # the mirror direction.
    refl = _normalize(_reflect(direction, nf))
    glossy = param >= GLOSSY_MIN_FUZZ
    n_exp = phong_exponent(param)
    u = _uniforms(generator, batch + (2,), dev, sobol)
    u0, u1 = (None, None) if u is None else (u[..., 0], u[..., 1])
    if strat is not None:
        u0, u1 = strat2d(u0, u1, s_idx, pid, spp, salt + 1)
    cos_a = torch.exp(torch.log(torch.clamp(u0, min=1e-12)) / (n_exp + 1.0))
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    phi = 2.0 * _PI * u1
    t1, t2 = _orthobasis(refl)
    lobe_dir = (
        refl * cos_a[..., None]
        + t1 * (sin_a * torch.cos(phi))[..., None]
        + t2 * (sin_a * torch.sin(phi))[..., None]
    )
    met_dir = torch.where(glossy[..., None], lobe_dir, refl)
    met_absorbed = torch.sum(met_dir * nf, dim=-1) <= 0.0
    zero = torch.zeros_like(param)
    met_pdf = torch.where(glossy, phong_pdf(n_exp, cos_a), zero)

    # Dielectric: refract or reflect (Schlick).
    ior = torch.clamp(param, min=1.0001)
    eta = torch.where(front[..., 0], 1.0 / ior, ior)[..., None]
    cos_theta = torch.clamp(-_dot(direction, nf), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot_refract = eta * sin_theta > 1.0
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    schlick = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    choice = _uniforms(generator, batch, dev, sobol)
    if strat is not None:
        choice = strat1d(choice, s_idx, pid, spp, salt + 2)
    do_reflect = cannot_refract | (schlick > choice[..., None])
    perp = eta * (direction + cos_theta * nf)
    para = -torch.sqrt(torch.abs(1.0 - torch.sum(perp * perp, dim=-1, keepdim=True))) * nf
    die_dir = torch.where(do_reflect, refl, _normalize(perp + para))

    is_lam = (kind == LAMBERTIAN)[..., None]
    is_met = (kind == METAL)[..., None]
    is_die = (kind == DIELECTRIC)[..., None]
    is_emi = kind == EMISSIVE

    new_dir = torch.where(is_lam, lam_dir, torch.where(is_met, met_dir, torch.where(is_die, die_dir, nf)))
    attenuation = torch.where(
        is_die, torch.ones_like(albedo), torch.where(is_emi[..., None], torch.zeros_like(albedo), albedo)
    )
    emitted = torch.where(is_emi[..., None], emission, torch.zeros_like(emission))
    terminate = is_emi | (is_met[..., 0] & met_absorbed)
    # Delta lanes (mirror, dielectric) report pdf 0, so emitter hits through
    # them keep full MIS weight.
    lam_pdf = torch.clamp(torch.sum(new_dir * nf, dim=-1), min=0.0) / _PI
    diffuse = is_lam[..., 0]
    pdf = torch.where(diffuse, lam_pdf, torch.where(is_met[..., 0], met_pdf, zero))
    return new_dir, attenuation, emitted, terminate, pdf, diffuse


def scatter(materials: MaterialTable, generator, direction, normal, mat_id):
    """:func:`scatter_full` without the MIS outputs: ``(new_direction,
    attenuation, emitted, terminate)``."""
    return scatter_full(materials, generator, direction, normal, mat_id)[:4]


def _pack_rays9(packet_size: int, live_rays, origin, direction, inv_direction):
    """Pad the ray stream to whole packets (repeating the LAST ray, which is
    coherent with its packet), turn a live-ray count into a live-packet
    count (dead rays form a suffix after compaction) and pack into the
    kernel's ``(B, 9, packet_size)`` layout. Returns ``(rays9,
    live_packets, padded_count)``; callers slice results ``[:N]``."""
    N = origin.shape[0]
    Np = -(-N // packet_size) * packet_size
    r = torch.cat([origin, direction, inv_direction], dim=-1)
    if Np != N:
        r = torch.cat([r, r[N - 1 :].expand(Np - N, 9)], dim=0)
    live_packets = None if live_rays is None else (live_rays + packet_size - 1) // packet_size
    r9 = r.reshape(Np // packet_size, packet_size, 9).transpose(1, 2).contiguous()
    return r9, live_packets, Np


def shade_from_flat(shade_flat, tri, u, v):
    """One row gather out of a :class:`PTScene`'s f16 ``shade_flat`` and the
    barycentric interpolation: ``(normal, material, texture_coords)`` for
    the kernel's winning ``(tri, u, v)``. The interpolation runs in f32.
    Misses read row 0; callers mask them."""
    u = u[:, None]
    v = v[:, None]
    row = shade_flat[tri.clamp(min=0).long()].to(torch.float32)
    n0 = row[:, 0:3]
    normal = _normalize(n0 + u * (row[:, 3:6] - n0) + v * (row[:, 6:9] - n0))
    uv0 = row[:, 10:13]
    tex = uv0 + u * (row[:, 13:16] - uv0) + v * (row[:, 16:19] - uv0)
    return normal, row[:, 9].to(torch.int32), tex


def _trace_pt_any(state, r9, *, stack_size, live_packets, t_max=np.inf, anyhit=False) -> PTHits:
    """Dispatch a lean trace by scene type: K3 in lean mode over a
    :class:`QPTScene`, K2 over a :class:`PTScene`; both return the same
    :class:`PTHits` contract."""
    kw = dict(stack_size=stack_size, t_max=t_max, live_packets=live_packets, anyhit=anyhit)
    if isinstance(state, QPTScene):
        return trace_packets_q(state, r9, lean=True, **kw)
    return trace_packets_pt(state, r9, **kw)


def make_pt_tracer(scene: PTScene | QPTScene, *, stack_size: int, packet_size: int = 2048):
    """Closest-hit tracer over the lean trace (K2, or K3 over a
    :class:`QPTScene`): the kernel returns ``(t, tri, u, v)``, and the
    normal, material and texture coordinates come from one row gather of
    ``scene.shade_flat``.

    Returns ``(tracer, scene)``; ``tracer(scene, origin, direction,
    inv_direction, live_rays=None) -> KernelHits`` over ``(N, 3)`` rays,
    where ``live_rays`` (an int or a device tensor) marks a live prefix.
    """

    def tracer(state: PTScene | QPTScene, origin, direction, inv_direction, live_rays=None) -> KernelHits:
        N = origin.shape[0]
        r9, live_packets, Np = _pack_rays9(packet_size, live_rays, origin, direction, inv_direction)
        ph = _trace_pt_any(state, r9, stack_size=stack_size, live_packets=live_packets)
        tri = ph.tri.reshape(Np)[:N]
        normal, material, tex = shade_from_flat(
            state.shade_flat, tri, ph.u.reshape(Np)[:N], ph.v.reshape(Np)[:N]
        )
        return KernelHits(
            t=ph.t.reshape(Np)[:N],
            tri=tri,
            normal=normal,
            material=material,
            overflow=ph.overflow,
            inner_visits=ph.inner_visits,
            leaf_tests=ph.leaf_tests,
            texture_coords=tex,
        )

    return tracer, scene


def make_portable_tracer(arrays: BvhArrays, *, stack_size: int, packet_size: int = 256):
    """Closest-hit tracer over the portable engine
    (``render/traversal.py``: ``trace_packets`` and ``finalize_hits``), the
    counterpart of the JAX package's ``make_xla_tracer``. Pure torch on the
    device of ``arrays`` (a torch :class:`BvhArrays`); it shares no code with
    the kernels, so it checks them. Each traversal step makes one host sync:
    give it thousands of rays, not a full-size wavefront.

    Same contract as :func:`make_pt_tracer`: returns ``(tracer, arrays)``
    with ``tracer(arrays, origin, direction, inv_direction, live_rays=None)
    -> KernelHits`` over ``(N, 3)`` rays. ``live_rays`` is ignored: every
    ray is traced. The rays are padded to whole packets of ``packet_size``
    by repeating the last one. ``overflow`` is the whole trace's count, one
    element; the engine counts no visits, so ``inner_visits`` and
    ``leaf_tests`` are one zero each.
    """

    def tracer(state: BvhArrays, origin, direction, inv_direction, live_rays=None) -> KernelHits:
        del live_rays  # the engine traces the whole batch in lockstep
        N = origin.shape[0]
        rays = _packets(packet_size, origin, direction, inv_direction)
        res = trace_packets(state, rays, stack_size=stack_size)
        hits = finalize_hits(state, rays, res)
        zero = torch.zeros(1, dtype=torch.int32, device=origin.device)
        return KernelHits(
            t=res.t.reshape(-1)[:N],
            tri=res.tri.reshape(-1)[:N],
            normal=hits.normal.reshape(-1, 3)[:N],
            material=hits.material.reshape(-1)[:N],
            overflow=res.overflow.reshape(1),
            inner_visits=zero,
            leaf_tests=zero,
            texture_coords=hits.texture_coords.reshape(-1, 3)[:N],
        )

    return tracer, arrays


def _packets(packet_size: int, origin, direction, inv_direction) -> Rays:
    """``(N, 3)`` rays as ``(B, packet_size, 3)`` packets, padded as
    :func:`_pack_rays9` pads them."""
    return rays9_to_rays(_pack_rays9(packet_size, None, origin, direction, inv_direction)[0])


def make_full_tracer(scene: KernelScene | QuantizedScene, *, stack_size: int, packet_size: int = 2048):
    """Closest-hit tracer over the full kernel (K1, or K3 in full mode over
    a :class:`QuantizedScene`) through ``trace_scene``: the counterpart of
    the JAX package's ``make_pallas_tracer``. The kernel itself returns the
    float32 shading normal and the material, so nothing is gathered
    afterwards; ``texture_coords`` stays None (the bounce loop reads none).

    Same contract as :func:`make_pt_tracer`: returns ``(tracer, scene)``
    with ``tracer(scene, origin, direction, inv_direction, live_rays=None)
    -> KernelHits`` over ``(N, 3)`` rays.
    """

    def tracer(state: KernelScene | QuantizedScene, origin, direction, inv_direction, live_rays=None) -> KernelHits:
        N = origin.shape[0]
        r9, live_packets, Np = _pack_rays9(packet_size, live_rays, origin, direction, inv_direction)
        kh = trace_scene(state, r9, stack_size=stack_size, live_packets=live_packets)
        return KernelHits(
            t=kh.t.reshape(Np)[:N],
            tri=kh.tri.reshape(Np)[:N],
            normal=kh.normal.reshape(Np, 3)[:N],
            material=kh.material.reshape(Np)[:N],
            overflow=kh.overflow,
            inner_visits=kh.inner_visits,
            leaf_tests=kh.leaf_tests,
        )

    return tracer, scene


# Shadow rays run along the UNNORMALIZED segment to the light point: t is
# in segment units, so one static t_max tests "anything strictly between
# origin and origin + segment". The margin below 1 is a float32 guard band;
# geometric end-point epsilons are the caller's and absolute (the NEE loop
# pulls both ends back by _EPS world units).
_SHADOW_T_MAX = 1.0 - 1e-5


def make_pt_shadow_tracer(scene: PTScene | QPTScene, *, stack_size: int, packet_size: int = 2048):
    """Occlusion tracer over the lean trace in any-hit mode (K2, or K3 over a
    :class:`QPTScene`). Returns
    ``(shadow, scene)``; ``shadow(scene, origin, segment, live_rays=None) ->
    (N,) bool`` is True where something blocks ``origin -> origin +
    segment``.

    ``shadow.packed(scene, rays9, live_packets=None) -> (B * P,) int32``
    traces segments already in the kernel's ``(B, 9, P)`` layout (origin,
    segment, inverse segment; ``P`` is ``shadow.packet_size``) and returns
    the trace's triangle, ``>= 0`` where blocked: the entry of the shadow
    batch's kernels, which pack the rows themselves."""

    def packed(state: PTScene | QPTScene, r9, live_packets=None):
        ph = _trace_pt_any(
            state, r9, stack_size=stack_size, t_max=_SHADOW_T_MAX, live_packets=live_packets, anyhit=True
        )
        return ph.tri.reshape(-1)

    def shadow(state: PTScene | QPTScene, origin, segment, live_rays=None):
        N = origin.shape[0]
        inv = torch.where(segment == 0.0, torch.full_like(segment, torch.inf), 1.0 / segment)
        r9, live_packets, _ = _pack_rays9(packet_size, live_rays, origin, segment, inv)
        return packed(state, r9, live_packets)[:N] >= 0

    shadow.packed, shadow.packet_size = packed, packet_size
    return shadow, scene


def make_portable_shadow_tracer(arrays: BvhArrays, *, stack_size: int, packet_size: int = 256):
    """Occlusion tracer over the portable engine, the counterpart of the JAX
    package's ``make_xla_shadow_tracer``: the contract of
    :func:`make_pt_shadow_tracer` (``shadow(arrays, origin, segment,
    live_rays=None) -> (N,) bool``), ``live_rays`` ignored. The engine has
    no any-hit mode: a segment is occluded where its closest hit lies below
    ``t = 1 - 1e-5`` in segment units."""

    def shadow(state: BvhArrays, origin, segment, live_rays=None):
        del live_rays
        N = origin.shape[0]
        inv = torch.where(segment == 0.0, torch.full_like(segment, torch.inf), 1.0 / segment)
        rays = _packets(packet_size, origin, segment, inv)
        res = trace_packets(state, rays, t_max=_SHADOW_T_MAX, stack_size=stack_size)
        return res.tri.reshape(-1)[:N] >= 0

    return shadow, arrays


class _PathState(NamedTuple):
    origin: torch.Tensor  # (N, 3)
    direction: torch.Tensor  # (N, 3)
    inv_direction: torch.Tensor  # (N, 3)
    throughput: torch.Tensor  # (N, 3)
    radiance: torch.Tensor  # (N, 3)
    pixel: torch.Tensor  # (N,) i32 flat slot of the path in packet layout
    active: torch.Tensor  # (N,) bool
    # (N,) f32 BSDF pdf of `direction` at its origin vertex, 0 for camera
    # rays and delta bounces: the MIS input for emitter hits under NEE.
    # None when NEE is off.
    prev_pdf: torch.Tensor | None = None


def _direction_bin(d: torch.Tensor) -> torch.Tensor:
    """Direction -> one of 96 bins: 6 dominant-axis faces x 4x4 quantized
    minor components (a ~28-degree cone each). Branchless, the same float32
    steps as the JAX package's, so the bins agree bit for bit."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    axv, ayv, azv = torch.abs(x), torch.abs(y), torch.abs(z)
    ax0 = (axv >= ayv) & (axv >= azv)
    ax1 = (~ax0) & (ayv >= azv)
    major = torch.where(ax0, x, torch.where(ax1, y, z))
    m1 = torch.where(ax0, y, torch.where(ax1, z, x))
    m2 = torch.where(ax0, z, torch.where(ax1, x, y))
    face = 2 * ax1.to(torch.int32) + 4 * (~ax0 & ~ax1).to(torch.int32) + (major > 0).to(torch.int32)
    inv_major = 1.0 / torch.clamp(torch.abs(major), min=1e-9)
    q1 = torch.clamp(((m1 * inv_major + 1.0) * 2.0).to(torch.int32), 0, 3)
    q2 = torch.clamp(((m2 * inv_major + 1.0) * 2.0).to(torch.int32), 0, 3)
    return (face << 4) | (q1 << 2) | q2  # 0..95


def _morton16(cell: torch.Tensor) -> torch.Tensor:
    """Interleave three 4-bit cell coordinates ``(N, 3)`` into a 12-bit
    Morton code."""
    out = torch.zeros_like(cell[:, 0])
    for b in range(4):
        for ax in range(3):
            out = out | (((cell[:, ax] >> b) & 1) << (3 * b + (2 - ax)))
    return out


def _position_cells(points, mask=None):
    """``(N, 3)`` int32 cells of a 16^3 grid over the bounding box of
    ``points`` (of the rows where ``mask`` is set; other rows count as the
    origin)."""
    if mask is not None:
        points = torch.where(mask[:, None], points, torch.zeros_like(points))
        lo = torch.where(mask[:, None], points, torch.full_like(points, torch.inf)).amin(dim=0)
        hi = torch.where(mask[:, None], points, torch.full_like(points, -torch.inf)).amax(dim=0)
    else:
        lo, hi = points.amin(dim=0), points.amax(dim=0)
    scale = 16.0 / torch.clamp(hi - lo, min=1e-6)
    return torch.clamp((points - lo) * scale, 0, 15).to(torch.int32)


def _gather_rows(perm, *columns):
    """Permute several ``(N, k)`` float32 columns with one gather."""
    packed = torch.cat(columns, dim=-1)[perm]
    return torch.split(packed, [c.shape[-1] for c in columns], dim=-1)


def _compact(state: _PathState, fine_direction: bool = True) -> _PathState:
    """Coherence-restoring compaction: sort rays by (dead?, direction bin,
    Morton position cell), direction-major. Dead rays sink to a suffix, so
    the tracer's live-prefix exit skips whole packets, and live rays regain
    the directional and spatial clustering that keeps a warp's traversals
    alike.

    ``fine_direction`` uses the 96 direction bins (first bounce: directions
    still correlate with camera-facing surfaces); otherwise the 8 octants.

    The device decides the route: on a card the key and the gather are the
    kernels of ``csrc/compact.cu`` (:func:`_compact_kernel`), elsewhere plain
    PyTorch (:func:`_compact_plain`, their reference); the two return the
    same state bit for bit.
    """
    if state.origin.device.type == "cuda":
        return _compact_kernel(state, fine_direction)
    return _compact_plain(state, fine_direction)


def _compact_plain(state: _PathState, fine_direction: bool = True) -> _PathState:
    """:func:`_compact` in plain PyTorch: one ``torch.sort`` of the int32
    key, then one gather of the payload by the permutation (the pixel index
    rides along as float32 bits); ``inv_direction`` is recomputed.
    """
    cell_id = _morton16(_position_cells(state.origin))  # 12 bits
    d = state.direction
    if fine_direction:
        dbin = _direction_bin(d)  # 7 bits
    else:
        dbin = ((d[:, 0] > 0).to(torch.int32) * 4 + (d[:, 1] > 0).to(torch.int32) * 2
                + (d[:, 2] > 0).to(torch.int32))
    dead = (~state.active).to(torch.int32)
    key = (dead << 19) | (dbin << 12) | cell_id
    perm = torch.sort(key).indices
    cols = [state.origin, state.direction, state.throughput, state.radiance, state.pixel.view(torch.float32)[:, None]]
    if state.prev_pdf is not None:
        cols.append(state.prev_pdf[:, None])
    g = _gather_rows(perm, *cols)
    direction = g[1]
    n_live = state.active.sum(dtype=torch.int32)
    return _PathState(
        origin=g[0],
        direction=direction,
        inv_direction=torch.where(direction == 0.0, torch.full_like(direction, torch.inf), 1.0 / direction),
        throughput=g[2],
        radiance=g[3],
        pixel=g[4][:, 0].contiguous().view(torch.int32),
        active=torch.arange(key.shape[0], dtype=torch.int32, device=key.device) < n_live,
        prev_pdf=g[5][:, 0] if state.prev_pdf is not None else None,
    )


def _compact_kernel(state: _PathState, fine_direction: bool = True) -> _PathState:
    """:func:`_compact_plain` on the state's card: the origins' bounding box
    by the plain version's ``amin`` and ``amax``, the key pass of
    ``csrc/compact.cu`` (``render/compact.py``; it also stages each lane's
    payload in a 64-byte record and counts the live lanes), the plain
    version's ``torch.sort`` of the same key (so the same permutation, ties
    included), and the permute pass, which gathers the records and writes the
    next state with its inverse direction and its live prefix. The live count
    stays on the device."""
    N = state.origin.shape[0]
    dev = state.origin.device
    nee = state.prev_pdf is not None
    origin, s_origin = _rows(state.origin)
    direction, s_direction = _rows(state.direction)
    throughput, s_throughput = _rows(state.throughput)
    radiance, s_radiance = _rows(state.radiance)
    pixel, s_pixel = _rows(state.pixel, torch.int32)
    active, s_active = _rows(state.active, torch.bool)
    prev_pdf, s_prev_pdf = _rows(state.prev_pdf) if nee else (None, 0)
    key = torch.empty(N, dtype=torch.int32, device=dev)
    record = torch.empty((N, 16), dtype=torch.float32, device=dev)
    n_live = torch.zeros(1, dtype=torch.int32, device=dev)
    key_pass(
        dev, n=N, origin=origin, s_origin=s_origin, direction=direction, s_direction=s_direction,
        throughput=throughput, s_throughput=s_throughput, radiance=radiance, s_radiance=s_radiance, pixel=pixel,
        s_pixel=s_pixel, active=active, s_active=s_active, prev_pdf=prev_pdf, s_prev_pdf=s_prev_pdf,
        lo=state.origin.amin(dim=0), hi=state.origin.amax(dim=0), fine_direction=int(fine_direction), key=key,
        record=record, n_live=n_live,
    )
    perm = torch.sort(key).indices

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    # The rays as the first bounce has them, views of one (N, 9) tensor: the
    # trace's packing copies such views faster than three contiguous columns.
    rays = empty(N, 9)
    out = _PathState(
        origin=rays[:, 0:3], direction=rays[:, 3:6], inv_direction=rays[:, 6:9], throughput=empty(N, 3),
        radiance=empty(N, 3), pixel=empty(N, dtype=torch.int32), active=empty(N, dtype=torch.bool),
        prev_pdf=empty(N) if nee else None,
    )
    permute_pass(
        dev, n=N, record=record, perm=perm, n_live=n_live, o_rays=rays, o_throughput=out.throughput,
        o_radiance=out.radiance, o_pixel=out.pixel, o_active=out.active, o_prev_pdf=out.prev_pdf,
    )
    if recording():
        count("pt.compaction_kernel_lanes", N)
    return out


# The keys of the NEE shadow sort. "pos" (position-major) is the default;
# the others are the JAX package's measured alternatives.
SHADOW_SORTS = ("pos", "dir", "light", "fromlight")


def _check_shadow_sort(shadow_sort: str) -> None:
    if shadow_sort not in SHADOW_SORTS:
        raise ValueError(f"shadow_sort must be one of {SHADOW_SORTS}, got {shadow_sort!r}")


def shadow_sort_key(cand, origin, wi, light_i, shadow_sort: str = "pos"):
    """The int32 sort key of the NEE shadow segments: candidates first (bit
    27 marks the others), then by ``shadow_sort``:

    * ``"pos"``: the Morton cell of the surface point, then the direction
      bin of ``wi`` (segments converge on the lights, so spatial neighbours
      run nearly parallel);
    * ``"dir"``: the direction bin, then the Morton cell;
    * ``"light"``: the sampled emitter ``light_i``, then the Morton cell;
    * ``"fromlight"``: the emitter (capped at 255), the direction bin of
      ``-wi`` and the Morton cell; the caller then launches the reversed
      interval.

    The cells are a 16^3 grid over the candidates' bounding box."""
    _check_shadow_sort(shadow_sort)
    cell = _morton16(_position_cells(origin, cand))
    if shadow_sort == "dir":
        skey = (_direction_bin(wi) << 12) | cell
    elif shadow_sort == "light":
        skey = (light_i.to(torch.int32) << 12) | cell
    elif shadow_sort == "fromlight":
        skey = (torch.clamp(light_i.to(torch.int32), max=255) << 19) | (_direction_bin(-wi) << 12) | cell
    else:
        skey = (cell << 7) | _direction_bin(wi)
    return ((~cand).to(torch.int32) << 27) | skey


def _shadow_batch(cand, origin, segment, wi, light_i=None, shadow_sort: str = "pos"):
    """Sort the NEE shadow segments by :func:`shadow_sort_key` so that
    candidates form a prefix of coherent packets. Non-candidates are parked
    far outside the scene so a partial boundary packet misses at the root.
    Under ``"fromlight"`` each segment is launched reversed, from its light
    end: the same parametric range [0, 1 - 1e-5] over the same interval, so
    the same blockers. Returns ``(origin, segment, n_cand, order)`` in
    sorted order; the caller scatters results back with ``order``."""
    skey = shadow_sort_key(cand, origin, wi, light_i, shadow_sort)
    n_cand = cand.sum(dtype=torch.int32)
    order = torch.sort(skey).indices
    o_sorted, s_sorted = _gather_rows(order, origin, segment)
    if shadow_sort == "fromlight":
        o_sorted, s_sorted = o_sorted + s_sorted, -s_sorted
    cand_s = (torch.arange(cand.shape[0], device=cand.device) < n_cand)[:, None]
    return (
        torch.where(cand_s, o_sorted, torch.full_like(o_sorted, 1e9)),
        torch.where(cand_s, s_sorted, torch.ones_like(s_sorted)),
        n_cand,
        order,
    )


class _Strata(NamedTuple):
    """The stratum parameters of one call of the bounce loop: a lane's
    sample index and pixel id follow from its slot ``pixel`` (packets of
    ``lanes`` lanes, ``block_pixels`` pixels a block, sample-major)."""

    spp: int  # the stratum count over the whole render; negative: Sobol
    offset: int  # the sample index of the call's first sample
    seed: int  # the render's pairing seed, XORed into the pixel id
    block_start: int  # the frame index of the first packet's pixel block
    lanes: int
    block_pixels: int


class _ShadowQuery(NamedTuple):
    """A NEE bounce's occlusion segments and what each adds if unblocked."""

    cand: torch.Tensor  # (N,) bool: a segment to trace
    origin: torch.Tensor  # (N, 3) surface end, pulled off the surface
    segment: torch.Tensor  # (N, 3) to the light end, pulled back
    wi: torch.Tensor  # (N, 3) unit direction to the light point
    light: torch.Tensor  # (N,) the sampled light's index
    contrib: torch.Tensor  # (N, 3) MIS-weighted radiance where unblocked


def _shadow_light(tracer_state, query: _ShadowQuery, radiance, shadow_tracer, shadow_sort: str):
    """A NEE bounce's shadow batch: the segments of ``query`` sorted by
    :func:`shadow_sort_key`, traced by ``shadow_tracer``, and ``radiance``
    with each unblocked candidate's ``contrib`` added. Returns the radiance.

    The call decides the route: on a card, in the ``"pos"`` order, with a
    tracer that takes packed rows (``shadow_tracer.packed``, the lean
    kernels'), the kernels of ``csrc/shadow.cu``
    (:func:`_shadow_light_kernel`); elsewhere plain PyTorch
    (:func:`_shadow_light_plain`, their reference). The two trace the same
    packets and return the same radiance bit for bit."""
    if (radiance.device.type == "cuda" and shadow_sort == "pos"
            and getattr(shadow_tracer, "packed", None) is not None):
        return _shadow_light_kernel(tracer_state, query, radiance, shadow_tracer)
    return _shadow_light_plain(tracer_state, query, radiance, shadow_tracer, shadow_sort)


def _shadow_light_plain(tracer_state, query: _ShadowQuery, radiance, shadow_tracer, shadow_sort: str):
    """:func:`_shadow_light` in plain PyTorch: :func:`_shadow_batch`, the
    tracer, the scatter of its answers back to the lanes, and the masked
    add."""
    with span("pt.shadow_trace"):
        # The batch's sort, gathers and scatter back, around the any-hit
        # trace.
        with span("pt.shadow_batch"):
            o_s, s_s, n_cand, order = _shadow_batch(
                query.cand, query.origin, query.segment, query.wi, query.light, shadow_sort
            )
        count("pt.shadow_rays", n_cand)
        occ_s = shadow_tracer(tracer_state, o_s, s_s, n_cand)
        with span("pt.shadow_batch"):
            occluded = torch.empty_like(occ_s)
            occluded[order] = occ_s
        if recording():
            count("pt.shadow_occluded", (query.cand & occluded).sum(dtype=torch.int32))
    with span("pt.shade"):
        # The light that reached the vertex, added last, as the estimator
        # sums it.
        lit = (query.cand & ~occluded)[:, None]
        return radiance + torch.where(lit, query.contrib, 0.0)


def _shadow_light_kernel(tracer_state, query: _ShadowQuery, radiance, shadow_tracer):
    """:func:`_shadow_light_plain` in the ``"pos"`` order on the query's
    card: the box, key and pack passes of ``csrc/shadow.cu`` around the plain
    version's ``torch.sort`` of the same key (so the same permutation, ties
    included), K2's any-hit over the packed rows of the live packets, and the
    resolve pass, which adds the unblocked light into ``radiance`` in place
    (a contiguous copy where its rows are strided). The candidate, live
    packet and blocked counts stay on the device."""
    N = query.cand.shape[0]
    dev = radiance.device
    P = shadow_tracer.packet_size

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    radiance, s_radiance = _rows(radiance)
    # The candidates, the live packets, the blocked candidates, and the box
    # pass's finished blocks.
    counts = torch.zeros(4, dtype=torch.int32, device=dev)
    fields = dict(
        n=N, cand=query.cand.contiguous(), origin=query.origin.contiguous(), segment=query.segment.contiguous(),
        wi=query.wi.contiguous(), contrib=query.contrib.contiguous(), counts=counts, packet=P,
    )
    with span("pt.shadow_trace"):
        with span("pt.shadow_batch"):
            box, key = empty(6), empty(N, dtype=torch.int32)
            shadow_passes.box_pass(dev, **fields, partial=empty(shadow_passes.BOX_ROWS, 8),
                                   partial_rows=shadow_passes.BOX_ROWS, box=box)
            shadow_passes.key_pass(dev, **fields, box=box, key=key)
            order = torch.sort(key).indices
            rays = empty(-(-N // P), 9, P)
            shadow_passes.pack_pass(dev, **fields, order=order, rays=rays)
        count("pt.shadow_rays", counts[0])
        tri = shadow_tracer.packed(tracer_state, rays, counts[1:2])
        with span("pt.shadow_batch"):
            shadow_passes.resolve_pass(dev, **fields, order=order, tri=tri, radiance=radiance,
                                       s_radiance=s_radiance)
        if recording():
            count("pt.shadow_occluded", counts[2])
            count("pt.shadow_kernel_lanes", N)
    return radiance


def _shade_plain(state: _PathState, kh: KernelHits, materials: MaterialTable, env: Environment, lights, generator,
                 *, bounce: int, nee_here: bool, shadow_rr: bool, rr_start: int, rr_floor: float,
                 strata: _Strata | None, live=None):
    """One bounce's shading over the hits ``kh`` of ``state``'s rays, in
    plain PyTorch: the environment on a miss, BSDF sampling, the
    MIS-weighted emitter hit, on a NEE bounce (``nee_here``) the light sample
    and its contribution, and path roulette. Returns ``(next_state,
    query)``: ``query`` is the bounce's :class:`_ShadowQuery`, or None
    without NEE here; ``next_state.radiance`` leaves out the NEE light, which
    the caller adds where the shadow trace finds no blocker. ``live`` is not
    read: the plain version runs over every lane.

    With NEE (``state.prev_pdf`` set), the light sample runs at diffuse and
    glossy vertices: one light sample and occlusion segment a vertex,
    combined with BSDF sampling by the MIS power heuristic. The uniforms
    come from ``generator`` in a fixed order: the BSDF's four draws, then the
    light's two and the shadow roulette's, then path roulette's."""
    del live
    nee = state.prev_pdf is not None
    dev = state.origin.device
    zero3 = torch.zeros_like(state.radiance)
    with span("pt.environment_emission"):
        found = kh.tri >= 0
        hit = found & state.active
        missed = ~found & state.active

        # Environment on a miss (ends the path); it is not light-sampled,
        # so it takes no MIS weight.
        radiance = state.radiance + torch.where(
            missed[:, None], state.throughput * env.radiance(state.direction), zero3
        )

    with span("pt.bsdf_scatter"):
        # BSDF sampling at hits. With strata, each lane's sample index and
        # pixel id come from `state.pixel` (the slot in packet layout,
        # which compaction carries), with per-bounce, per-dimension salts.
        strat_b = strat_nee = None
        if strata is not None:
            P0, bp0 = strata.lanes, strata.block_pixels
            within = state.pixel % P0
            s_idx = strata.offset + within // bp0
            pid_s = ((state.pixel // P0 + strata.block_start) * bp0 + within % bp0) ^ strata.seed
            strat_b = (s_idx, pid_s, strata.spp, 8 * bounce)
            strat_nee = (s_idx, pid_s, strata.spp, 8 * bounce + 4)
        new_dir, atten, emitted, terminate, bsdf_pdf, diffuse = scatter_full(
            materials, generator, state.direction, kh.normal, kh.material, strat=strat_b
        )
    with span("pt.hit_emission"):
        if nee:
            # MIS: weight the emitter hit by how likely BSDF sampling was
            # to find it, against NEE from the previous vertex.
            pdf_l = hit_light_pdf(lights, kh.tri, state.direction, kh.t)
            pp = state.prev_pdf
            w_b = torch.where(pp > 0.0, pp * pp / (pp * pp + pdf_l * pdf_l), torch.ones_like(pp))
            emitted = emitted * w_b[:, None]
        radiance = radiance + torch.where(hit[:, None], state.throughput * emitted, zero3)
        throughput = torch.where(hit[:, None], state.throughput * atten, state.throughput)

        point = state.origin + state.direction * kh.t[:, None]
        d_dot_n = torch.sum(state.direction * kh.normal, dim=-1, keepdim=True)
        nf = torch.where(d_dot_n < 0, kh.normal, -kh.normal)

    query = None
    if nee_here:
        with span("pt.nee_light_sample"):
            # One light sample and one occlusion segment at every diffuse
            # and glossy vertex; mirror and glass lanes are delta lobes
            # NEE cannot cover, and keep full BSDF weight instead.
            kindv, fuzzv, albedo, _ = material_rows(materials, kh.material)
            glossy = (kindv == METAL) & (fuzzv >= GLOSSY_MIN_FUZZ)
            cand = (diffuse | glossy) & hit
            sh_o = point + nf * _EPS
            y, wi, pdf_nee, em_l, cos_y, light_i = sample_lights(lights, generator, sh_o, strat=strat_nee)
            cos_x = torch.sum(wi * nf, dim=-1)
            cand = cand & (cos_x > 0.0) & (cos_y > 1e-6) & (pdf_nee > 0.0)
            if shadow_rr:
                # Shadow-ray Russian roulette: drop low-throughput
                # candidates before the trace and reweight survivors by
                # 1/q (unbiased).
                q_rr = torch.clamp(throughput.amax(dim=-1), 0.05, 1.0)
                u_rr = torch.rand(q_rr.shape, generator=generator, device=dev)
                cand = cand & (u_rr < q_rr)
                rr_w = 1.0 / q_rr
            else:
                rr_w = torch.ones_like(cos_x)
            # Pull the light-side end back by an ABSOLUTE epsilon
            # (matching the surface-side offset), so the blind zone near
            # a light does not grow with its distance.
            seg = y - wi * _EPS - sh_o
            # BSDF value x cos and BSDF pdf toward the light, per lobe:
            # Lambertian albedo/pi * cos_x (pdf cos_x/pi); glossy
            # albedo * phong_pdf (the lobe's implied BRDF), pdf phong_pdf.
            refl_v = _normalize(_reflect(state.direction, nf))
            lobe_pdf_l = phong_pdf(phong_exponent(fuzzv), torch.sum(wi * refl_v, dim=-1))
            pdf_b_l = torch.where(glossy, lobe_pdf_l, cos_x / _PI)
            fcos = torch.where(glossy[:, None], albedo * lobe_pdf_l[:, None], albedo / _PI * cos_x[:, None])
            w_nee = pdf_nee * pdf_nee / (pdf_nee * pdf_nee + pdf_b_l * pdf_b_l)
            contrib = state.throughput * fcos * em_l * (w_nee / pdf_nee * rr_w)[:, None]
            query = _ShadowQuery(cand, sh_o, seg, wi, light_i, contrib)

    with span("pt.roulette_update"):
        # Dielectric transmission crosses the surface: offset along the
        # new direction's side of the surface instead of the facing
        # normal.
        offset_dir = torch.where(torch.sum(new_dir * nf, dim=-1, keepdim=True) >= 0, nf, -nf)
        new_origin = point + offset_dir * _EPS
        inv = torch.where(new_dir == 0.0, torch.full_like(new_dir, torch.inf), 1.0 / new_dir)

        active = hit & ~terminate
        # Russian roulette from `rr_start` on: survival probability is
        # the largest throughput channel (floored), survivors reweighted.
        if bounce >= rr_start:
            p_continue = torch.clamp(throughput.amax(dim=-1), rr_floor, 1.0)
            survived = torch.rand(active.shape, generator=generator, device=dev) < p_continue
            throughput = torch.where(
                (active & survived)[:, None], throughput / p_continue[:, None], throughput
            )
            active = active & survived

        state = _PathState(
            origin=torch.where(hit[:, None], new_origin, state.origin),
            direction=torch.where(hit[:, None], new_dir, state.direction),
            inv_direction=torch.where(hit[:, None], inv, state.inv_direction),
            throughput=throughput,
            radiance=radiance,
            pixel=state.pixel,
            active=active,
            # Diffuse and glossy vertices carry their lobe pdf into the
            # next vertex's MIS; vertices past nee_max_depth carry 0
            # (their direct light was not light-sampled).
            prev_pdf=(
                torch.where(hit, bsdf_pdf, torch.zeros_like(bsdf_pdf))
                if nee_here
                else (torch.zeros_like(bsdf_pdf) if nee else None)
            ),
        )
    return state, query


def _rows(x: torch.Tensor, dtype=torch.float32):
    """``x`` with the dtype the shading kernel reads and a contiguous last
    axis, and its row stride in elements."""
    x = x.to(dtype)
    if x.dim() == 2 and x.stride(-1) != 1:
        x = x.contiguous()
    return x, x.stride(0)


def _shade_kernel(state: _PathState, kh: KernelHits, materials: MaterialTable, env: Environment, lights, generator,
                  *, bounce: int, nee_here: bool, shadow_rr: bool, rr_start: int, rr_floor: float,
                  strata: _Strata | None, live=None):
    """:func:`_shade_plain` as one launch of the bounce-shading kernel
    (``render/shade.py``, ``csrc/shade.cu``) over the lanes of ``state``, on
    their card. ``live`` (None, an int or a one-element device tensor) is
    the live prefix the kernel reads from device memory: the lanes past it
    only carry their state over.

    The uniforms are drawn here, before the launch, as the plain version
    draws them (the same calls, shapes and order), so the same generator
    gives both versions the same numbers and leaves it in the same state."""
    N = state.origin.shape[0]
    dev = state.origin.device
    nee = state.prev_pdf is not None
    sobol = strata is not None and strata.spp < 0

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    u_z = u_phi = u_lobe = u_choice = u_light = u_tri = u_rr = u_path = None
    if not sobol:
        u_z, u_phi, u_lobe, u_choice = rand(N), rand(N), rand(N, 2), rand(N)
    if nee_here:
        if not sobol:
            u_light, u_tri = rand(N), rand(N, 2)
        if shadow_rr:
            u_rr = rand(N)
    if bounce >= rr_start:
        u_path = rand(N)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = _PathState(
        origin=empty(N, 3), direction=empty(N, 3), inv_direction=empty(N, 3), throughput=empty(N, 3),
        radiance=empty(N, 3), pixel=state.pixel, active=empty(N, dtype=torch.bool),
        prev_pdf=empty(N) if nee else None,
    )
    query = None
    if nee_here:
        query = _ShadowQuery(cand=empty(N, dtype=torch.bool), origin=empty(N, 3), segment=empty(N, 3),
                             wi=empty(N, 3), light=empty(N, dtype=torch.int32), contrib=empty(N, 3))
    strat = {}
    if strata is not None:
        spp = abs(strata.spp)
        gx, gy = grid_factor(spp)
        strat = dict(
            strat_mode=STRAT_SOBOL if sobol else STRAT_JITTER, spp=spp, gx=gx, gy=gy, inv_spp=1.0 / spp,
            inv_gx=1.0 / gx, inv_gy=1.0 / gy, strat_offset=strata.offset, strat_seed=strata.seed,
            block_start=strata.block_start, lanes=strata.lanes, block_pixels=strata.block_pixels,
            salt_bsdf=8 * bounce, salt_nee=8 * bounce + 4,
        )
    light_rows = {}
    if nee:
        light_rows = dict(
            l_v0=lights.v0.contiguous(), l_e1=lights.e1.contiguous(), l_e2=lights.e2.contiguous(),
            l_normal=lights.normal.contiguous(), l_area=lights.area.contiguous(),
            l_emission=lights.emission.contiguous(), l_pmf=lights.pmf.contiguous(), l_cdf=lights.cdf.contiguous(),
            l_tri_light=lights.tri_light.to(torch.int32).contiguous(), n_lights=lights.cdf.shape[0],
        )
    normal, s_normal = _rows(kh.normal)
    origin, s_origin = _rows(state.origin)
    direction, s_direction = _rows(state.direction)
    inv_direction, s_inv_direction = _rows(state.inv_direction)
    throughput, s_throughput = _rows(state.throughput)
    radiance, s_radiance = _rows(state.radiance)
    pixel, s_pixel = _rows(state.pixel, torch.int32)
    active, s_active = _rows(state.active, torch.bool)
    prev_pdf, s_prev_pdf = _rows(state.prev_pdf) if nee else (None, 0)
    launch_shade(
        dev, n=N, live=_live_count(live, dev),
        t=kh.t.to(torch.float32).contiguous(), tri=kh.tri.to(torch.int32).contiguous(), normal=normal,
        s_normal=s_normal, material=kh.material.to(torch.int32).contiguous(),
        origin=origin, s_origin=s_origin, direction=direction, s_direction=s_direction,
        inv_direction=inv_direction, s_inv_direction=s_inv_direction, throughput=throughput,
        s_throughput=s_throughput, radiance=radiance, s_radiance=s_radiance, pixel=pixel, s_pixel=s_pixel,
        active=active, s_active=s_active, prev_pdf=prev_pdf, s_prev_pdf=s_prev_pdf,
        u_z=u_z, u_phi=u_phi, u_lobe=u_lobe, u_choice=u_choice, u_light=u_light, u_tri=u_tri, u_rr=u_rr,
        u_path=u_path,
        kind=materials.kind.to(torch.int32).contiguous(), albedo=materials.albedo.contiguous(),
        emission=materials.emission.contiguous(), param=materials.param.contiguous(),
        horizon=env.horizon.to(torch.float32).contiguous(), zenith=env.zenith.to(torch.float32).contiguous(),
        **light_rows, **strat,
        nee=int(nee), nee_here=int(nee_here), shadow_rr=int(shadow_rr), roulette=int(bounce >= rr_start),
        rr_floor=float(rr_floor),
        o_origin=out.origin, o_direction=out.direction, o_inv_direction=out.inv_direction,
        o_throughput=out.throughput, o_radiance=out.radiance, o_active=out.active, o_prev_pdf=out.prev_pdf,
        **({} if query is None else dict(cand=query.cand, sh_origin=query.origin, segment=query.segment,
                                         wi=query.wi, light=query.light, contrib=query.contrib)),
    )
    if recording():
        count("pt.shade_kernel_lanes", N)
    return out, query


def _pt_trace(
    tracer_state,
    materials: MaterialTable,
    env: Environment,
    rays9: torch.Tensor,
    generator,
    *,
    tracer,
    samples: int,
    bounces: int,
    compaction: bool,
    lights: LightTable | None = None,
    shadow_tracer=None,
    shadow_sort: str = "pos",
    shadow_rr: bool = True,
    nee_max_depth: int | None = None,
    rr_start: int = 3,
    rr_floor: float = 0.05,
    min_live_frac: float | None = None,
    strat_spp: int | None = None,
    strat_offset: int = 0,
    strat_seed: int = 0,
    block_start: int = 0,
    live_rays: int | None = None,
    with_sumsq: bool = False,
    clamp: float | None = None,
):
    """The bounce loop over camera rays ``rays9`` ``(B0, 9, P0)`` (packets
    of ``samples`` x pixel-block rays, sample-major; the whole frame or one
    shard's range of it). Returns ``(B0, bp, 3)`` per-pixel sums, and with
    ``with_sumsq`` also the per-pixel sum of squared per-sample luminances
    ``(B0, bp)``.

    ``block_start`` is the frame index of the first packet's pixel block: a
    shard passes its range's start, so that the BSDF and light strata of a
    pixel are the whole frame's. ``live_rays`` marks only the first that
    many rays live: the rest are dead from bounce 0, add no radiance, and the
    tracers' live-prefix exit skips their packets (the adaptive sampler's
    rounds).

    With ``lights`` and ``shadow_tracer``, next-event estimation runs at
    diffuse and glossy vertices: one light sample and occlusion segment per
    vertex, combined with BSDF sampling by the MIS power heuristic.
    ``nee_max_depth`` caps it to the first K vertices; deeper emitter hits
    keep full BSDF weight, so the estimator stays unbiased. ``shadow_sort``
    orders the occlusion segments (:func:`shadow_sort_key`).
    """
    _check_shadow_sort(shadow_sort)
    nee = lights is not None and shadow_tracer is not None
    if nee_max_depth is not None and not nee:
        raise ValueError("nee_max_depth given without lights/shadow_tracer")
    B0, _, P0 = rays9.shape
    N = B0 * P0
    dev = rays9.device
    flat = rays9.transpose(1, 2).reshape(N, 9)
    state = _PathState(
        origin=flat[:, 0:3],
        direction=flat[:, 3:6],
        inv_direction=flat[:, 6:9],
        throughput=torch.ones((N, 3), dtype=torch.float32, device=dev),
        radiance=torch.zeros((N, 3), dtype=torch.float32, device=dev),
        pixel=torch.arange(N, dtype=torch.int32, device=dev),  # one path per slot
        active=(
            torch.ones((N,), dtype=torch.bool, device=dev)
            if live_rays is None
            else torch.arange(N, device=dev) < live_rays
        ),
        prev_pdf=torch.zeros((N,), dtype=torch.float32, device=dev) if nee else None,
    )
    strata = None if strat_spp is None else _Strata(strat_spp, strat_offset, strat_seed, block_start, P0, P0 // samples)
    # The device decides the shading: one kernel a bounce on a card, the
    # plain PyTorch version (its reference) elsewhere.
    shade = _shade_kernel if dev.type == "cuda" else _shade_plain

    for bounce in range(bounces):
        live = live_rays
        if compaction and bounce > 0:
            with span("pt.compaction"):
                state = _compact(state, fine_direction=bounce == 1)
                # Dead rays are now a suffix; the kernel reads the live count
                # from device memory and skips whole dead packets.
                live = state.active.sum(dtype=torch.int32)
                if min_live_frac is not None:
                    # Wavefront tail cut (opt-in, biased): once the live share
                    # drops below the threshold, retire the whole wavefront.
                    cut = live < int(min_live_frac * N)
                    state = state._replace(active=state.active & ~cut)
                    live = torch.where(cut, torch.zeros_like(live), live)
        if recording():
            # Lanes entering the trace, and how many of them are live.
            count("pt.lanes", N)
            if bounce == 0:
                count("pt.live_lanes", N if live_rays is None else live_rays)
            else:
                count("pt.live_lanes", live if compaction else state.active.sum(dtype=torch.int32))
        with span("pt.trace"):
            kh = tracer(tracer_state, state.origin, state.direction, state.inv_direction, live)
        nee_here = nee and (nee_max_depth is None or bounce < nee_max_depth)
        with span("pt.shade"):
            state, query = shade(
                state, kh, materials, env, lights, generator, bounce=bounce, nee_here=nee_here,
                shadow_rr=shadow_rr, rr_start=rr_start, rr_floor=rr_floor, strata=strata, live=live,
            )
        if query is not None:
            state = state._replace(
                radiance=_shadow_light(tracer_state, query, state.radiance, shadow_tracer, shadow_sort)
            )

    # `pixel` is a permutation of the slots, so the sum is exact.
    rad = torch.zeros((N, 3), dtype=torch.float32, device=dev).index_add_(0, state.pixel.long(), state.radiance)
    per_sample = rad.reshape(B0, samples, P0 // samples, 3)
    if clamp is not None:
        # Firefly clamp (opt-in, biased): cap each sample before averaging.
        per_sample = torch.clamp(per_sample, max=clamp)
    out = per_sample.sum(dim=1)
    if with_sumsq:
        from minipath_tpu_torch.utils import LUMA_WEIGHTS

        lum = per_sample @ torch.from_numpy(LUMA_WEIGHTS).to(dev)
        return out, (lum * lum).sum(dim=1)
    return out


def render_frame_pt(
    tracer,
    tracer_state,
    materials: MaterialTable,
    sampler: CameraSampler,
    generator: torch.Generator | None,
    *,
    width: int,
    height: int,
    spp: int,
    bounces: int = 6,
    env: Environment | None = None,
    px_block=(16, 16),
    samples_per_packet: int = 8,
    compaction: bool = True,
    lights: LightTable | None = None,
    shadow_tracer=None,
    shadow_sort: str = "pos",
    shadow_rr: bool = True,
    nee_max_depth: int | None = None,
    rr_start: int = 3,
    rr_floor: float = 0.05,
    min_live_frac: float | None = None,
    stratify: bool = True,
    sobol: bool = False,
    strat_total: int | None = None,
    strat_offset: int = 0,
    strat_seed: int | None = None,
    return_variance: bool = False,
    clamp: float | None = None,
    mesh=None,
):
    """Path-traced frame: mean RGB and alpha 1, ``(H, W, 4)`` float32 on the
    sampler's device (``mesh[0]`` with a mesh).

    ``(tracer, tracer_state)`` comes from :func:`make_pt_tracer` (the lean
    kernel), :func:`make_full_tracer` (the full one) or
    :func:`make_portable_tracer` (the portable engine). Pass ``lights``
    (``scene.materials.build_light_table``) together with a
    ``shadow_tracer`` (:func:`make_pt_shadow_tracer` or
    :func:`make_portable_shadow_tracer`) for next-event estimation;
    ``shadow_sort`` (``"pos"``, ``"dir"``, ``"light"`` or ``"fromlight"``,
    :func:`shadow_sort_key`) orders its occlusion segments and leaves the
    estimator as it is. The frame is traced in chunks of ``samples_per_packet``
    samples per pixel; one chunk's wavefront is ``ceil(H/16) * ceil(W/16) *
    256 * samples_per_packet`` paths.

    ``shadow_rr`` Russian-roulettes low-throughput shadow candidates
    (unbiased). ``rr_start`` is the first bounce at which path roulette may
    kill a path, ``rr_floor`` its survival-probability floor (both
    unbiased). ``min_live_frac`` (opt-in, biased) retires the wavefront once
    fewer than that share of paths is live. ``stratify`` draws the film,
    lens, BSDF and light dimensions from per-pixel jittered strata over the
    full ``spp``; ``sobol`` upgrades them to Owen-scrambled Sobol points
    (requires ``stratify``). ``strat_total`` / ``strat_offset`` widen the
    stratum window beyond this call for progressive accumulation.
    ``strat_seed`` (an int) re-randomizes the stratum pairings per render;
    when None it is drawn from ``generator`` (one host sync).
    ``return_variance`` also returns the per-pixel variance of the mean
    (luminance, ``(H, W)``). ``clamp`` (opt-in, biased) caps each sample's
    radiance.

    ``mesh``, a sequence of devices (``parallel.make_device_mesh``; it may
    repeat one), shards the frame: each device owns a contiguous range of
    the frame's pixel blocks, makes their camera rays and runs the whole
    bounce loop on them, compaction included. Rays never move between
    devices; the only traffic between them is the gather of the shards'
    sums onto ``mesh[0]`` at the end. The tracer state, materials, lights,
    sampler and environment are replicated once per distinct device, and
    the tracers take the state of whichever device they are handed. Each
    shard draws from a generator of its own, seeded from ``generator``
    (:func:`parallel.shard_generators`) after the pairing seed. A pixel's
    strata are the whole frame's, so in Sobol mode, where roulette draws
    nothing, the sharded frame traces the unsharded frame's paths.
    """
    _check_shadow_sort(shadow_sort)
    if env is None:
        env = Environment.sky(sampler.device)
    if (lights is None) != (shadow_tracer is None):
        raise ValueError("NEE needs both lights= and shadow_tracer=")
    if return_variance and spp < 2:
        raise ValueError("return_variance needs spp >= 2")
    if sobol and not stratify:
        raise ValueError("sobol=True requires stratify=True")
    bh, bw = px_block
    hc, wc = -(-height // bh), -(-width // bw)
    with span("pt.frame", request=new_request()):
        if strat_seed is None:
            # One pairing seed per render, shared by every chunk and shard.
            strat_seed = render_seed(generator)
        strat_seed = (int(strat_seed) + 2**31) % 2**32 - 2**31  # as int32
        strat_spp = (-1 if sobol else 1) * (strat_total or spp) if stratify else None
        shards = frame_shards(mesh, hc * wc, generator, tracer_state, materials, env, sampler, lights)
        acc, acc_sq = [None] * len(shards), [None] * len(shards)
        done = 0
        while done < spp:
            n = min(samples_per_packet, spp - done)
            with span("pt.chunk"):
                for i, (lo, hi, gen, (state_d, table_d, env_d, sampler_d, lights_d)) in enumerate(shards):
                    rays9 = gen_rays9_blocks(
                        sampler_d, gen, lo, block_count=hi - lo, wc=wc, px_block=px_block, samples=n,
                        strat_spp=strat_spp, strat_offset=strat_offset + done, strat_seed=strat_seed,
                    )
                    part = _pt_trace(
                        state_d, table_d, env_d, rays9, gen, tracer=tracer, samples=n, bounces=bounces,
                        compaction=compaction, lights=lights_d, shadow_tracer=shadow_tracer,
                        shadow_sort=shadow_sort, shadow_rr=shadow_rr, nee_max_depth=nee_max_depth,
                        rr_start=rr_start, rr_floor=rr_floor, min_live_frac=min_live_frac, strat_spp=strat_spp,
                        strat_offset=strat_offset + done, strat_seed=strat_seed, block_start=lo,
                        with_sumsq=return_variance, clamp=clamp,
                    )
                    if return_variance:
                        part, part_sq = part
                        acc_sq[i] = part_sq if acc_sq[i] is None else acc_sq[i] + part_sq
                    acc[i] = part if acc[i] is None else acc[i] + part
            done += n
        acc = gather(acc, mesh)
        rgb = unpack_frame(acc, width, height, (hc, wc), px_block) / spp
        img = torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)
        if return_variance:
            from minipath_tpu_torch.utils import LUMA_WEIGHTS

            lum_sum = acc @ torch.from_numpy(LUMA_WEIGHTS).to(acc.device)
            # Sample variance of the per-sample luminance over spp, divided by
            # spp: the variance of the pixel's mean.
            var = torch.clamp(gather(acc_sq, mesh) - lum_sum * lum_sum / spp, min=0.0) / ((spp - 1) * spp)
            return img, unpack_frame(var[..., None], width, height, (hc, wc), px_block)[..., 0]
        return img
