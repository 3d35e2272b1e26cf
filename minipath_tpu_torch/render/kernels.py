"""Closest-hit BVH traversal: the hand-written Hopper kernel and its plain
PyTorch version.

Replaces ``minipath_tpu/render/pallas_kernels.py::_traverse_kernel`` (its
wrapper ``trace_packets_pallas`` and the dispatch ``trace_scene``). The
kernel is CUDA C++ for ``sm_90a`` in ``csrc/traverse.cu``, built by
``nvcc`` at first use (``utils/cuda_build.py``) and called through ctypes.

The contract is the TPU kernel's; its layout is not. The TPU kernel walks one
scalar stack per 128-lane packet of rays in SMEM, with the scene resident in
VMEM. Here one thread traces one ray with its own stack of ``(link,
t_entry)`` pairs in local memory (capacity :data:`STACK_CAPACITY`), and
reads node and triangle rows straight from device memory through the
read-only cache. Per ray, the rules are the TPU kernel's: the slab test with
``1/d`` clamped to +-1e30, children pushed far-first so the nearest pops
first, an entry pruned at pop when its entry distance exceeds the ray's best
hit, two-sided Möller–Trumbore with a strict ``t < best_t``, and the shading
normal interpolated from the winning hit's barycentrics.

What bounds it on an H100: divergent, latency-bound global loads of node
rows (192 B) and triangle rows (320 B). Neighbouring threads walk different
paths, so their loads do not coalesce and a warp waits for the slowest ray.
Speeding it up is work for later: sorting rays by origin and direction,
wider or compressed nodes, and persistent threads that refill idle lanes.

The counters differ in meaning from the TPU kernel's: ``overflow``,
``inner_visits`` and ``leaf_tests`` are sums over the packet's rays of
per-ray counts, not counts of per-packet steps.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import torch

from minipath_tpu_torch.geometry.ray import Rays
from minipath_tpu_torch.scene.bvh import links as L
from minipath_tpu_torch.scene.bvh.build import BvhArrays

_NULL = L.NULL_LINK
_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "traverse.cu"

# Per-thread stack capacity, MP_STACK_CAPACITY in csrc/traverse.cu.
STACK_CAPACITY = 128
_BIG = 1e30


class KernelHits(NamedTuple):
    """Trace output, everything the parity integrator needs."""

    t: torch.Tensor  # (B, P) f32, t_max where miss
    tri: torch.Tensor  # (B, P) i32 packet*8 + lane, -1 on miss
    normal: torch.Tensor  # (B, P, 3) f32 unit shading normal, zeros on miss
    material: torch.Tensor  # (B, P) i32, 0 on miss
    # (B,) i32 sums over each packet's rays. overflow: stack pushes dropped
    # (0 means the results are exact). inner_visits / leaf_tests: inner-node
    # visits and 8-triangle leaf-packet tests, the traversal's two costs.
    overflow: torch.Tensor
    inner_visits: torch.Tensor
    leaf_tests: torch.Tensor


class KernelScene(NamedTuple):
    """Scene arrays laid out for the kernel (derived from BvhArrays).

    Counterpart of the JAX package's ``PallasScene``: the same rows, without
    the TPU's 128-lane padding concerns.
    """

    node_box: torch.Tensor  # (N, 48) f32: child c at [6c, 6c+6) = min, max
    node_links: torch.Tensor  # (N, 8) i32
    # (M, 80) f32: lane l at [9l, 9l+9) = v0, e1, e2; [72+l] = material id
    tri_data: torch.Tensor
    tri_shade: torch.Tensor  # (M, 72) f32: lane l vertex normals n0, n1, n2
    root: int  # encoded root link

    @property
    def device(self) -> torch.device:
        return self.node_box.device


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 cross product over the last axis, each term rounded as the
    JAX package's ``jnp.cross`` rounds it: a fused multiply-subtract
    ``fma(a1, b2, -(a2 * b1))``. The first product is exact in float64 and
    the difference is rounded once to float32."""

    def term(i, j):
        exact = a[..., i].double() * b[..., j].double()
        return (exact - (a[..., j] * b[..., i]).double()).to(torch.float32)

    return torch.stack([term(1, 2), term(2, 0), term(0, 1)], dim=-1)


def prepare_scene(bvh: BvhArrays) -> KernelScene:
    """Derive the kernel arrays. ``tri_shade`` holds the three vertex
    normals of each triangle lane; flat-shaded triangles get their
    unnormalized geometric normal in all three slots, so the interpolation
    needs no per-triangle flag."""
    N = bvh.node_child_links.shape[0]
    M = bvh.tri_packets.shape[0]
    node_box = torch.cat([bvh.node_child_box_min, bvh.node_child_box_max], dim=-1)
    v0 = bvh.tri_packets[:, :, 0, :]
    e1 = bvh.tri_packets[:, :, 1, :] - v0
    e2 = bvh.tri_packets[:, :, 2, :] - v0
    tri_data = torch.cat([v0, e1, e2], dim=-1).reshape(M, 72)

    vidx = bvh.tri_vidx.reshape(M, 8, 3).long()
    vnorm = bvh.vert_normal[vidx]  # (M, 8, 3, 3)
    geom = _cross(e1, e2)  # (M, 8, 3)
    flat = bvh.tri_flat.reshape(M, 8)
    vnorm = torch.where(flat[..., None, None], geom[:, :, None, :], vnorm)

    mat = bvh.tri_material.reshape(M, 8).to(torch.float32)
    return KernelScene(
        node_box=node_box.reshape(N, 48).to(torch.float32).contiguous(),
        node_links=bvh.node_child_links.to(torch.int32).contiguous(),
        tri_data=torch.cat([tri_data.to(torch.float32), mat], dim=-1).contiguous(),
        tri_shade=vnorm.reshape(M, 72).to(torch.float32).contiguous(),
        root=int(bvh.root),
    )


def rays_to_rays9(rays: Rays) -> torch.Tensor:
    """Pack rays with ``(B, P, 3)`` fields into the kernel's contiguous
    ``(B, 9, P)`` layout (rows o, d, inv_d)."""
    stacked = torch.cat([rays.origin, rays.direction, rays.inv_direction], dim=-1)
    return stacked.transpose(1, 2).contiguous()


def _check(scene: KernelScene, rays9: torch.Tensor, stack_size: int) -> None:
    if rays9.dtype != torch.float32 or rays9.dim() != 3 or rays9.shape[1] != 9:
        raise ValueError(f"rays9 must be (B, 9, P) float32, got {tuple(rays9.shape)} {rays9.dtype}")
    if not rays9.is_contiguous():
        raise ValueError("rays9 must be contiguous")
    if not 1 <= stack_size <= STACK_CAPACITY:
        raise ValueError(f"stack_size {stack_size} outside [1, {STACK_CAPACITY}]")
    for name, dtype, width in (
        ("node_box", torch.float32, 48),
        ("node_links", torch.int32, 8),
        ("tri_data", torch.float32, 80),
        ("tri_shade", torch.float32, 72),
    ):
        a = getattr(scene, name)
        if a.device != rays9.device:
            raise ValueError(f"scene.{name} is on {a.device}, rays9 on {rays9.device}")
        if a.dtype != dtype or a.dim() != 2 or a.shape[1] != width or not a.is_contiguous():
            raise ValueError(f"scene.{name} must be contiguous (n, {width}) {dtype}")


def _live_rays(live_packets, B: int, P: int) -> int:
    live = B if live_packets is None else int(live_packets)
    return max(0, min(B, live)) * P


def trace_packets(
    scene: KernelScene,
    rays9: torch.Tensor,
    *,
    stack_size: int,
    t_max: float = math.inf,
    live_packets=None,
) -> KernelHits:
    """Closest-hit trace of ``rays9`` ``(B, 9, P)`` against ``scene``.

    On CUDA tensors this launches the kernel (and raises if it cannot); on
    CPU tensors it runs :func:`trace_packets_reference`. Packets at index
    ``>= live_packets`` write miss outputs without traversal. ``stack_size``
    at most :data:`STACK_CAPACITY`; use the build's
    ``recommended_stack_size`` for a result with zero overflow.
    ``trace_packets.launches`` counts kernel launches.
    """
    _check(scene, rays9, stack_size)
    if rays9.device.type == "cpu":
        return trace_packets_reference(
            scene, rays9, stack_size=stack_size, t_max=t_max, live_packets=live_packets
        )
    if rays9.device.type != "cuda":
        raise ValueError(f"no traversal for device {rays9.device}")
    return _launch(scene, rays9, stack_size, t_max, live_packets)


trace_packets.launches = 0


def load_library():
    """Build (at first use) and load the kernel library; returns the
    :class:`~minipath_tpu_torch.utils.cuda_build.CudaLibrary`."""
    from minipath_tpu_torch.utils.cuda_build import load_cuda_library

    built = load_cuda_library(_SOURCE)
    lib = built.lib
    if lib.mp_trace_packets.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.mp_trace_packets.argtypes = [
            vp, vp, vp, vp, i32, vp, i64, i64, i32, i32, ctypes.c_float,
            vp, vp, vp, vp, vp, vp,
        ]
        lib.mp_trace_packets.restype = i32
        lib.mp_error_string.argtypes = [i32]
        lib.mp_error_string.restype = ctypes.c_char_p
        lib.mp_stack_capacity.restype = i32
        if lib.mp_stack_capacity() != STACK_CAPACITY:
            raise RuntimeError("STACK_CAPACITY disagrees with csrc/traverse.cu")
    return built


def _launch(scene, rays9, stack_size, t_max, live_packets) -> KernelHits:
    lib = load_library().lib
    B, _, P = rays9.shape
    dev = rays9.device
    for a in (scene.node_box, scene.node_links, scene.tri_data, scene.tri_shade, rays9):
        if a.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")
    t = torch.empty((B, P), dtype=torch.float32, device=dev)
    tri = torch.empty((B, P), dtype=torch.int32, device=dev)
    normal = torch.empty((B, P, 3), dtype=torch.float32, device=dev)
    material = torch.empty((B, P), dtype=torch.int32, device=dev)
    counters = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mp_trace_packets(
            scene.node_box.data_ptr(),
            scene.node_links.data_ptr(),
            scene.tri_data.data_ptr(),
            scene.tri_shade.data_ptr(),
            scene.root,
            rays9.data_ptr(),
            B * P,
            _live_rays(live_packets, B, P),
            P,
            stack_size,
            float(t_max),
            t.data_ptr(),
            tri.data_ptr(),
            normal.data_ptr(),
            material.data_ptr(),
            counters.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"traverse kernel launch failed: cudaError {err} "
            f"({lib.mp_error_string(err).decode()})"
        )
    trace_packets.launches += 1
    return KernelHits(
        t=t,
        tri=tri,
        normal=normal,
        material=material,
        overflow=counters[:, 0],
        inner_visits=counters[:, 1],
        leaf_tests=counters[:, 2],
    )


def trace_packets_reference(
    scene: KernelScene,
    rays9: torch.Tensor,
    *,
    stack_size: int,
    t_max: float = math.inf,
    live_packets=None,
) -> KernelHits:
    """Plain PyTorch version of the kernel, same signature and output.

    A per-ray lockstep traversal after ``minipath_tpu/render/traversal.py``:
    each step pops one entry for every ray whose stack is not empty, and the
    rays that popped an inner node, and those that popped a leaf, are
    processed as two batches. The slab, prune, push-order and Möller–Trumbore
    rules and their arithmetic order are the kernel's, so on one device the
    two agree bit for bit in ``t`` and ``tri``.
    """
    B, _, P = rays9.shape
    dev = rays9.device
    R = B * P
    S = stack_size
    f32, i64 = torch.float32, torch.int64
    r = rays9.permute(0, 2, 1).reshape(R, 9)
    o, d = r[:, 0:3], r[:, 3:6]
    inv = r[:, 6:9].clamp(-_BIG, _BIG)

    best_t = torch.full((R,), t_max, dtype=f32, device=dev)
    best_tri = torch.full((R,), -1, dtype=i64, device=dev)
    best_u = torch.zeros(R, dtype=f32, device=dev)
    best_v = torch.zeros(R, dtype=f32, device=dev)
    ovf = torch.zeros(R, dtype=i64, device=dev)
    ivis = torch.zeros(R, dtype=i64, device=dev)
    ltst = torch.zeros(R, dtype=i64, device=dev)
    stack_link = torch.zeros((R, S), dtype=i64, device=dev)
    stack_t = torch.zeros((R, S), dtype=f32, device=dev)
    sp = torch.zeros(R, dtype=i64, device=dev)
    n_live = _live_rays(live_packets, B, P)
    if scene.root != _NULL:
        stack_link[:n_live, 0] = scene.root
        sp[:n_live] = 1

    node_box = scene.node_box.view(-1, 8, 6)
    node_links = scene.node_links.to(i64)
    tri_rows = scene.tri_data[:, :72].reshape(-1, 8, 9)

    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() == 0:
            break
        top = sp[act] - 1
        sp[act] = top
        link = stack_link[act, top]
        keep = stack_t[act, top] <= best_t[act]
        act, link = act[keep], link[keep]
        count = link & L.COUNT_MASK
        idx = link >> L.COUNT_BITS
        inner = count == 0

        # ---- inner nodes: 8 child slab tests, push hits far-first -----------
        a, n = act[inner], idx[inner]
        if a.numel():
            ivis[a] += 1
            box = node_box[n]  # (k, 8, 6)
            clinks = node_links[n]  # (k, 8)
            oa, ia = o[a][:, None, :], inv[a][:, None, :]
            t0 = (box[..., 0:3] - oa) * ia
            t1 = (box[..., 3:6] - oa) * ia
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            near = torch.maximum(
                torch.clamp(lo[..., 0], min=0.0), torch.maximum(lo[..., 1], lo[..., 2])
            )
            far = torch.minimum(
                torch.minimum(hi[..., 0], best_t[a][:, None]),
                torch.minimum(hi[..., 1], hi[..., 2]),
            )
            hit = (near <= far) & (clinks != _NULL)
            key = torch.where(hit, near, torch.full_like(near, math.inf))
            key, order = torch.sort(key, dim=1, descending=True, stable=True)
            hit = torch.gather(hit, 1, order)
            clinks = torch.gather(clinks, 1, order)
            pos = sp[a][:, None] + torch.cumsum(hit, dim=1) - hit.long()
            fits = hit & (pos < S)
            ovf[a] += (hit & ~fits).sum(dim=1)
            rows = a[:, None].expand(-1, 8)[fits]
            stack_link[rows, pos[fits]] = clinks[fits]
            stack_t[rows, pos[fits]] = key[fits]
            sp[a] += fits.sum(dim=1)

        # ---- leaves: count packets of 8 triangles, in order -----------------
        a, first, cnt = act[~inner], idx[~inner], count[~inner]
        if a.numel():
            ltst[a] += cnt
            for j in range(L.MAX_COUNT):
                m = cnt > j
                if not bool(m.any()):
                    break
                _leaf_packet(tri_rows, first[m] + j, a[m], o, d, best_t, best_tri, best_u, best_v)

    hit = best_tri >= 0
    safe = best_tri.clamp(min=0)
    pk, lane = safe >> 3, safe & 7
    sh = scene.tri_shade.view(-1, 8, 9)[pk, lane]  # (R, 9)
    n0, n1, n2 = sh[:, 0:3], sh[:, 3:6], sh[:, 6:9]
    nrm = n0 + best_u[:, None] * (n1 - n0) + best_v[:, None] * (n2 - n0)
    sq = nrm[:, 0] * nrm[:, 0] + nrm[:, 1] * nrm[:, 1] + nrm[:, 2] * nrm[:, 2]
    nrm = nrm * torch.rsqrt(torch.clamp(sq, min=1e-30))[:, None]
    material = scene.tri_data[pk, 72 + lane].to(torch.int32)
    return KernelHits(
        t=best_t.view(B, P),
        tri=best_tri.to(torch.int32).view(B, P),
        normal=torch.where(hit[:, None], nrm, torch.zeros_like(nrm)).view(B, P, 3),
        material=torch.where(hit, material, torch.zeros_like(material)).view(B, P),
        overflow=ovf.view(B, P).sum(dim=1).to(torch.int32),
        inner_visits=ivis.view(B, P).sum(dim=1).to(torch.int32),
        leaf_tests=ltst.view(B, P).sum(dim=1).to(torch.int32),
    )


def _leaf_packet(tri_rows, pk, a, o, d, best_t, best_tri, best_u, best_v) -> None:
    """Two-sided Möller–Trumbore of rays ``a`` against the 8 lanes of packets
    ``pk``, updating their best hit in place. Lanes are taken in order with
    a strict ``t < best_t``, so the winner is the first lane of least t."""
    tr = tri_rows[pk]  # (k, 8, 9)
    v0x, v0y, v0z = tr[..., 0], tr[..., 1], tr[..., 2]
    e1x, e1y, e1z = tr[..., 3], tr[..., 4], tr[..., 5]
    e2x, e2y, e2z = tr[..., 6], tr[..., 7], tr[..., 8]
    ox, oy, oz = (o[a, k][:, None] for k in range(3))
    dx, dy, dz = (d[a, k][:, None] for k in range(3))
    bt = best_t[a]
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
    ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0) & (t < bt[:, None])
    tc = torch.where(ok, t, torch.full_like(t, math.inf))
    t_new, lane = tc.min(dim=1)
    upd = t_new < bt
    if not bool(upd.any()):
        return
    au, lu = a[upd], lane[upd][:, None]
    best_t[au] = t_new[upd]
    best_tri[au] = pk[upd] * 8 + lane[upd]
    best_u[au] = torch.gather(u[upd], 1, lu)[:, 0]
    best_v[au] = torch.gather(v[upd], 1, lu)[:, 0]
