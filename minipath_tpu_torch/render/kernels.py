"""BVH traversal: the hand-written Hopper kernels and their plain PyTorch
version.

Two TPU kernels are ported here, onto one CUDA traversal loop in
``csrc/traverse.cu`` (CUDA C++ for ``sm_90a``, built by ``nvcc`` at first
use by ``utils/cuda_build.py`` and called through ctypes):

- K1, ``minipath_tpu/render/pallas_kernels.py::_traverse_kernel`` (wrapper
  ``trace_packets_pallas``, dispatch ``trace_scene``): full closest-hit, with
  the interpolated shading normal and the material. Here
  :func:`trace_packets`, over a :class:`KernelScene`.
- K2, ``pallas_kernels.py::_traverse_kernel_pt`` (wrapper
  ``trace_packets_pallas_pt``): the path tracer's lean trace, closest-hit or
  any-hit, returning ``(t, tri, u, v)``. Here :func:`trace_packets_pt`, over
  a :class:`PTScene`; shading comes from the scene's ``shade_flat`` table
  afterwards (``render/wavefront.py::shade_from_flat``).

The contracts are the TPU kernels'; their layout is not. The TPU kernels walk
one scalar stack per 128-lane (K1) or 2048-lane (K2) packet of rays in SMEM,
with the scene resident in VMEM. Here one thread traces one ray with its own
stack of 8-byte ``(link, t_entry)`` entries in local memory (capacity
:data:`STACK_CAPACITY`), and reads node and triangle rows straight from
device memory through the read-only cache. Per ray, the rules are K1's: the
slab test with ``1/d`` clamped to +-1e30, children pushed far-first so the
nearest pops first, an entry pruned at pop when its entry distance exceeds
the ray's best hit, two-sided Möller–Trumbore with a strict ``t < best_t``,
lanes of a leaf in order. K2's octant-projection child order and its
links-only stack exist because 2048 lanes share one scalar stack; a thread
with its own stack needs neither, so K2 agrees with the JAX kernel except at
exact ties. In any-hit mode a ray stops after the first 8-triangle packet in
which it has a hit under ``t_max``; the TPU kernel's packet-wide stack drop
has no per-ray counterpart.

What bounds them on an H100: neighbouring threads walk different paths, so a
warp's 32 loads go to 32 rows, each load costs the L1 about one
pass a thread, and a warp waits for its slowest ray. The threads request
224 B an inner visit and 288 B a packet test, terabytes a second in all,
which L1 and L2 serve: load slots and cache bandwidth run short beside
latency. The loop therefore loads 16 bytes at a time (a node's boxes as 12
``float4``, a packet's vertex words as 18, two lanes' worth at a time),
keeps nothing but the stack in local memory (the hit children are sorted by
insertion straight into the stack, in the order :func:`push_ranks` states;
the nearest child stays in registers and is visited next without a round
trip through the stack), and lets a ray walk through inner nodes until it
reaches a leaf, so that a warp's rays meet at the leaf part. The per-ray
order of visits is the plain version's throughout. What is left for later:
sorting rays by origin and direction, the fused-multiply-add build, and
persistent threads that refill idle lanes.

The counters differ in meaning from the TPU kernels': ``overflow``,
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
from minipath_tpu_torch.utils.profiling import count, span

_NULL = L.NULL_LINK
_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "traverse.cu"

# Per-thread stack capacity, MP_STACK_CAPACITY in csrc/traverse.cu.
STACK_CAPACITY = 128
_BIG = 1e30
# Material ids ride the f16 shading table, which holds integers exactly up
# to 2048.
MAX_MATERIAL_ID = 2048


class KernelHits(NamedTuple):
    """Trace output, everything an integrator needs."""

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
    texture_coords: torch.Tensor | None = None  # (..., 3) f32, lean path only


class PTHits(NamedTuple):
    """Lean trace output (K2); shading is the caller's job."""

    t: torch.Tensor  # (B, P) f32, t_max where miss
    tri: torch.Tensor  # (B, P) i32, -1 on miss
    u: torch.Tensor  # (B, P) f32 barycentrics at the best hit
    v: torch.Tensor
    overflow: torch.Tensor  # (B,) i32
    inner_visits: torch.Tensor  # (B,) i32
    leaf_tests: torch.Tensor  # (B,) i32


class KernelScene(NamedTuple):
    """Scene arrays laid out for K1 (derived from BvhArrays).

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


class PTScene(NamedTuple):
    """Scene layout for the lean trace (K2): K1's node and triangle rows,
    without ``tri_shade``, plus the shading table the caller gathers from."""

    node_box: torch.Tensor  # (N, 48) f32, as KernelScene
    node_links: torch.Tensor  # (N, 8) i32, as KernelScene
    tri_data: torch.Tensor  # (M, 80) f32, as KernelScene (materials unused)
    root: int
    # (M*8, 20) f16 per triangle lane: n0, n1, n2 (9), material (1), uv0,
    # uv1, uv2 (9), pad (1); read outside the kernel (shade_from_flat).
    shade_flat: torch.Tensor

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


def _traversal_rows(bvh: BvhArrays):
    """``(node_box, node_links, tri_data, e1, e2)``: the rows K1 and K2 share,
    and the triangle edges."""
    N = bvh.node_child_links.shape[0]
    M = bvh.tri_packets.shape[0]
    node_box = torch.cat([bvh.node_child_box_min, bvh.node_child_box_max], dim=-1)
    v0 = bvh.tri_packets[:, :, 0, :]
    e1 = bvh.tri_packets[:, :, 1, :] - v0
    e2 = bvh.tri_packets[:, :, 2, :] - v0
    tri = torch.cat([v0, e1, e2], dim=-1).reshape(M, 72).to(torch.float32)
    mat = bvh.tri_material.reshape(M, 8).to(torch.float32)
    return (
        node_box.reshape(N, 48).to(torch.float32).contiguous(),
        bvh.node_child_links.to(torch.int32).contiguous(),
        torch.cat([tri, mat], dim=-1).contiguous(),
        e1,
        e2,
    )


def _vertex_normals(bvh: BvhArrays, e1, e2) -> torch.Tensor:
    """``(M, 8, 3, 3)`` per-lane vertex normals; flat-shaded triangles get
    their unnormalized geometric normal in all three slots."""
    M = bvh.tri_packets.shape[0]
    vnorm = bvh.vert_normal[bvh.tri_vidx.reshape(M, 8, 3).long()]
    flat = bvh.tri_flat.reshape(M, 8)
    return torch.where(flat[..., None, None], _cross(e1, e2)[:, :, None, :], vnorm)


def prepare_scene(bvh: BvhArrays) -> KernelScene:
    """Derive K1's arrays. ``tri_shade`` holds the three vertex normals of
    each triangle lane, so the interpolation needs no per-triangle flag."""
    node_box, node_links, tri_data, e1, e2 = _traversal_rows(bvh)
    M = bvh.tri_packets.shape[0]
    return KernelScene(
        node_box=node_box,
        node_links=node_links,
        tri_data=tri_data,
        tri_shade=_vertex_normals(bvh, e1, e2).reshape(M, 72).to(torch.float32).contiguous(),
        root=int(bvh.root),
    )


def check_material_ids(tri_material) -> None:
    """Raise ``ValueError`` unless every material id fits the f16 shading
    table (``0 <= id <`` :data:`MAX_MATERIAL_ID`)."""
    if tri_material.numel() and not (
        int(tri_material.min()) >= 0 and int(tri_material.max()) < MAX_MATERIAL_ID
    ):
        raise ValueError(f"material ids must lie in [0, {MAX_MATERIAL_ID}) for exact f16 shading rows")


def build_shade_flat(bvh: BvhArrays) -> torch.Tensor:
    """The ``(M*8, 20)`` f16 shading table of the lean trace, bit for bit the
    JAX package's ``build_shade_flat``: per triangle lane n0 n1 n2 (9),
    material (1), uv0 uv1 uv2 (9), pad (1).

    The normals are normalized here, before the f16 cast, so that f16's
    narrow range cannot flush a small cross product to zero. Material ids
    are checked first (:func:`check_material_ids`), and a uv component that
    f16 cannot hold finitely raises ``ValueError`` instead of being stored
    as inf. While tracing is on (``utils/profiling.py``), the build is the
    span ``scene.shade_table`` and the table's bytes the counter
    ``scene.shade_bytes``."""
    with span("scene.shade_table"):
        table = _shade_flat(bvh)
    count("scene.shade_bytes", table.nbytes)
    return table


def _shade_flat(bvh: BvhArrays) -> torch.Tensor:
    check_material_ids(bvh.tri_material)
    M = bvh.tri_packets.shape[0]
    v0 = bvh.tri_packets[:, :, 0, :]
    vnorm = _vertex_normals(bvh, bvh.tri_packets[:, :, 1, :] - v0, bvh.tri_packets[:, :, 2, :] - v0)
    length = torch.sqrt(torch.sum(vnorm * vnorm, dim=-1, keepdim=True))
    vnorm = vnorm / torch.clamp(length, min=1e-20)
    uvs = bvh.vert_uv[bvh.tri_vidx.reshape(M * 8, 3).long()].reshape(M * 8, 9).to(torch.float32)
    if not bool(torch.isfinite(uvs.to(torch.float16)).all()):
        raise ValueError("texture coordinates exceed the f16 range of the shading table")
    return torch.cat(
        [
            vnorm.reshape(M * 8, 9),
            bvh.tri_material.reshape(M * 8, 1).to(torch.float32),
            uvs,
            torch.zeros((M * 8, 1), dtype=torch.float32, device=uvs.device),
        ],
        dim=-1,
    ).to(torch.float16).contiguous()


def prepare_scene_pt(bvh: BvhArrays) -> PTScene:
    """Derive the lean layout: K1's node and triangle rows plus the
    shading table, which is built (and the material ids checked) first."""
    shade_flat = build_shade_flat(bvh)
    node_box, node_links, tri_data, _, _ = _traversal_rows(bvh)
    return PTScene(
        node_box=node_box,
        node_links=node_links,
        tri_data=tri_data,
        root=int(bvh.root),
        shade_flat=shade_flat,
    )


def rays_to_rays9(rays: Rays) -> torch.Tensor:
    """Pack rays with ``(B, P, 3)`` fields into the kernel's contiguous
    ``(B, 9, P)`` layout (rows o, d, inv_d)."""
    stacked = torch.cat([rays.origin, rays.direction, rays.inv_direction], dim=-1)
    return stacked.transpose(1, 2).contiguous()


def _check(scene, rays9: torch.Tensor, stack_size: int, rows) -> None:
    if rays9.dtype != torch.float32 or rays9.dim() != 3 or rays9.shape[1] != 9:
        raise ValueError(f"rays9 must be (B, 9, P) float32, got {tuple(rays9.shape)} {rays9.dtype}")
    if not rays9.is_contiguous():
        raise ValueError("rays9 must be contiguous")
    if not 1 <= stack_size <= STACK_CAPACITY:
        raise ValueError(f"stack_size {stack_size} outside [1, {STACK_CAPACITY}]")
    for name, dtype, width in rows:
        a = getattr(scene, name)
        if a is None:
            raise ValueError(f"scene.{name} is missing")
        if a.device != rays9.device:
            raise ValueError(f"scene.{name} is on {a.device}, rays9 on {rays9.device}")
        if a.dtype != dtype or a.dim() != 2 or a.shape[1] != width or not a.is_contiguous():
            raise ValueError(f"scene.{name} must be contiguous (n, {width}) {dtype}")


_K1_ROWS = (
    ("node_box", torch.float32, 48),
    ("node_links", torch.int32, 8),
    ("tri_data", torch.float32, 80),
    ("tri_shade", torch.float32, 72),
)
_K2_ROWS = _K1_ROWS[:3]


def trace_packets(
    scene: KernelScene,
    rays9: torch.Tensor,
    *,
    stack_size: int,
    t_max: float = math.inf,
    live_packets=None,
) -> KernelHits:
    """K1: closest-hit trace of ``rays9`` ``(B, 9, P)`` against ``scene``.

    ``live_packets`` is None (all live), an int, or a one-element integer
    tensor on the rays' device, which the kernel reads itself, so the
    caller makes no host sync; packets at index ``>= live_packets`` write
    miss outputs without traversal.

    On CUDA tensors this launches the kernel (and raises if it cannot); on
    CPU tensors it runs :func:`trace_packets_reference`.
    ``stack_size`` at most :data:`STACK_CAPACITY`; use the build's
    ``recommended_stack_size`` for a result with zero overflow.
    ``trace_packets.launches`` counts kernel launches.
    """
    _check(scene, rays9, stack_size, _K1_ROWS)
    if rays9.device.type == "cpu":
        return trace_packets_reference(
            scene, rays9, stack_size=stack_size, t_max=t_max, live_packets=live_packets
        )
    if rays9.device.type != "cuda":
        raise ValueError(f"no traversal for device {rays9.device}")
    return _launch(scene, rays9, stack_size, t_max, live_packets)


trace_packets.launches = 0


def intersect_bvh(bvh: BvhArrays, scene: KernelScene, rays: Rays, *, stack_size: int = 96, t_max: float = math.inf):
    """Closest hits of ``rays`` (``(B, P, 3)`` fields) traced by K1
    (:func:`trace_packets`) and finalized by the portable engine's
    ``render/traversal.py::finalize_hits`` over ``bvh``, the tree that
    ``scene`` was prepared from: the counterpart of the JAX package's
    ``intersect_bvh_pallas``. Returns ``render/hit.py``'s ``HitRecords``,
    the contract of an object's ``intersect``."""
    from minipath_tpu_torch.render.traversal import TraceResult, finalize_hits

    kh = trace_packets(scene, rays_to_rays9(rays), stack_size=stack_size, t_max=t_max)
    result = TraceResult(
        t=torch.where(kh.tri < 0, math.inf, kh.t),
        tri=kh.tri,
        steps=torch.zeros((), dtype=torch.int32, device=kh.t.device),
        overflow=kh.overflow.sum(),
    )
    return finalize_hits(bvh, rays, result)


def trace_packets_pt(
    scene: PTScene,
    rays9: torch.Tensor,
    *,
    stack_size: int,
    t_max: float = math.inf,
    live_packets=None,
    anyhit: bool = False,
    roots: torch.Tensor | None = None,
) -> PTHits:
    """K2: lean closest-hit trace of ``rays9`` ``(B, 9, P)``; with
    ``anyhit`` an occlusion trace, where only ``tri >= 0`` carries meaning
    (some triangle at ``0 <= t < t_max``).

    ``live_packets`` is None (all live), an int, or a one-element integer
    tensor on the rays' device, which the kernel reads itself, so the
    caller makes no host sync; packets at index ``>= live_packets`` write
    miss outputs. ``roots`` is an optional ``(B,)`` int32 tensor of encoded
    node links, one traversal root per packet; a NULL root writes miss
    outputs.

    On CUDA tensors this launches the kernel (and raises if it cannot); on
    CPU tensors it runs :func:`trace_packets_pt_reference`.
    ``trace_packets_pt.launches`` counts kernel launches per mode.
    """
    _check(scene, rays9, stack_size, _K2_ROWS)
    B = rays9.shape[0]
    if roots is not None and (roots.shape != (B,) or roots.device != rays9.device):
        raise ValueError(f"roots must be ({B},) on {rays9.device}")
    if rays9.device.type == "cpu":
        return trace_packets_pt_reference(
            scene, rays9, stack_size=stack_size, t_max=t_max, live_packets=live_packets,
            anyhit=anyhit, roots=roots,
        )
    if rays9.device.type != "cuda":
        raise ValueError(f"no traversal for device {rays9.device}")
    return _launch_pt(scene, rays9, stack_size, t_max, live_packets, anyhit, roots)


trace_packets_pt.launches = {"closest": 0, "anyhit": 0}


def load_library():
    """Build (at first use) and load the kernel library; returns the
    :class:`~minipath_tpu_torch.utils.cuda_build.CudaLibrary`."""
    from minipath_tpu_torch.utils.cuda_build import load_cuda_library

    built = load_cuda_library(_SOURCE)
    lib = built.lib
    if lib.mp_trace_packets.argtypes is None:
        vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.mp_trace_packets.argtypes = [
            vp, vp, vp, vp, i32, vp, vp, i64, i32, i32, f32,
            vp, vp, vp, vp, vp, vp,
        ]
        lib.mp_trace_packets.restype = i32
        lib.mp_trace_packets_pt.argtypes = [
            vp, vp, vp, i32, vp, vp, vp, i64, i32, i32, f32, i32,
            vp, vp, vp, vp, vp, vp,
        ]
        lib.mp_trace_packets_pt.restype = i32
        lib.mp_error_string.argtypes = [i32]
        lib.mp_error_string.restype = ctypes.c_char_p
        lib.mp_stack_capacity.restype = i32
        if lib.mp_stack_capacity() != STACK_CAPACITY:
            raise RuntimeError("STACK_CAPACITY disagrees with csrc/traverse.cu")
    return built


def _raise_on(lib, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"traverse kernel launch failed: cudaError {err} ({lib.mp_error_string(err).decode()})"
        )


def _live_count(live_packets, dev) -> torch.Tensor | None:
    """``live_packets`` (None, an int or a one-element tensor on ``dev``) as
    the one ``int32`` in device memory that the kernels read, or None."""
    if live_packets is None:
        return None
    if isinstance(live_packets, torch.Tensor):
        if live_packets.numel() != 1 or live_packets.device != dev:
            raise ValueError(f"live_packets must be one element on {dev}")
        return live_packets.reshape(1).to(torch.int32).contiguous()
    return torch.full((1,), int(live_packets), dtype=torch.int32, device=dev)


def _aligned(*tensors) -> None:
    for a in tensors:
        if a.data_ptr() % 16:
            raise ValueError("kernel inputs must be 16-byte aligned")


def _launch(scene, rays9, stack_size, t_max, live_packets) -> KernelHits:
    lib = load_library().lib
    B, _, P = rays9.shape
    dev = rays9.device
    _aligned(scene.node_box, scene.node_links, scene.tri_data, scene.tri_shade, rays9)
    live = _live_count(live_packets, dev)
    t = torch.empty((B, P), dtype=torch.float32, device=dev)
    tri = torch.empty((B, P), dtype=torch.int32, device=dev)
    normal = torch.empty((B, P, 3), dtype=torch.float32, device=dev)
    material = torch.empty((B, P), dtype=torch.int32, device=dev)
    counters = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.mp_trace_packets(
            scene.node_box.data_ptr(),
            scene.node_links.data_ptr(),
            scene.tri_data.data_ptr(),
            scene.tri_shade.data_ptr(),
            scene.root,
            None if live is None else live.data_ptr(),
            rays9.data_ptr(),
            B * P,
            P,
            stack_size,
            float(t_max),
            t.data_ptr(),
            tri.data_ptr(),
            normal.data_ptr(),
            material.data_ptr(),
            counters.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err)
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


def _launch_pt(scene, rays9, stack_size, t_max, live_packets, anyhit, roots) -> PTHits:
    lib = load_library().lib
    B, _, P = rays9.shape
    dev = rays9.device
    _aligned(scene.node_box, scene.node_links, scene.tri_data, rays9)
    live = _live_count(live_packets, dev)
    if roots is not None:
        roots = roots.to(torch.int32).contiguous()
    t = torch.empty((B, P), dtype=torch.float32, device=dev)
    tri = torch.empty((B, P), dtype=torch.int32, device=dev)
    u = torch.empty((B, P), dtype=torch.float32, device=dev)
    v = torch.empty((B, P), dtype=torch.float32, device=dev)
    counters = torch.zeros((B, 3), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.mp_trace_packets_pt(
            scene.node_box.data_ptr(),
            scene.node_links.data_ptr(),
            scene.tri_data.data_ptr(),
            scene.root,
            None if roots is None else roots.data_ptr(),
            None if live is None else live.data_ptr(),
            rays9.data_ptr(),
            B * P,
            P,
            stack_size,
            float(t_max),
            int(anyhit),
            t.data_ptr(),
            tri.data_ptr(),
            u.data_ptr(),
            v.data_ptr(),
            counters.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err)
    trace_packets_pt.launches["anyhit" if anyhit else "closest"] += 1
    return PTHits(
        t=t, tri=tri, u=u, v=v,
        overflow=counters[:, 0], inner_visits=counters[:, 1], leaf_tests=counters[:, 2],
    )


def push_ranks(t1: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """The push order of an inner node's hit children, as a rank: for
    ``(k, 8)`` entry distances ``t1`` and the mask ``hit`` of the children a
    ray hits, the ``(k, 8)`` int64 rank of each hit child among its node's
    hit children, -1 for a missed child. A child's rank is the number of hit
    children that are farther, or equally far with a smaller child index, and
    child ``c`` belongs at ``stack[sp + rank[c]]``: farthest first, stable in
    child order, so that the nearest pops first and, where the stack is
    short, the nearest are the first to be dropped. The kernels build this
    order by insertion into the stack (``csrc/traverse_common.cuh``), and
    :func:`_traverse_reference` by a stable descending sort."""
    c = torch.arange(8, device=t1.device)
    other, own = t1[:, None, :], t1[:, :, None]  # [k, child, other child]
    before = (other > own) | ((other == own) & (c[None, None, :] < c[None, :, None]))
    rank = (before & hit[:, None, :]).sum(dim=-1)
    return torch.where(hit, rank, torch.full_like(rank, -1))


def _traverse_reference(scene, rays9, *, stack_size, t_max, live_packets, anyhit=False, roots=None, touched=None):
    """The plain version of the traversal loop both kernels share.

    A per-ray lockstep traversal after ``minipath_tpu/render/traversal.py``:
    each step pops one entry for every ray whose stack is not empty, and the
    rays that popped an inner node, and those that popped a leaf, are
    processed as two batches. The slab, prune, push-order and Möller–Trumbore
    rules and their arithmetic order are the kernel's, so on one device the
    two agree bit for bit in ``t``, ``tri``, ``u``, ``v`` and the counters.
    In any-hit mode a ray leaves the leaf loop after the first packet of 8
    triangles in which it has a hit, and its stack empties.

    ``live_packets`` is None, an int or a one-element tensor; ``roots`` an
    optional ``(B,)`` tensor. Returns per-ray ``(t, tri, u, v)`` and the
    per-packet ``(overflow, inner_visits, leaf_tests)``. A dict given as
    ``touched`` receives boolean masks of the node rows (``"nodes"``) and
    triangle packets (``"packets"``) the traversal read.
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

    packet = torch.arange(R, device=dev) // P
    root = (
        torch.full((R,), scene.root, dtype=i64, device=dev)
        if roots is None
        else roots.to(device=dev, dtype=i64)[packet]
    )
    start = root != _NULL
    if live_packets is not None:
        live = live_packets.to(dev).reshape(()) if isinstance(live_packets, torch.Tensor) else int(live_packets)
        start &= packet < live
    stack_link[:, 0] = root
    sp = start.to(i64)

    node_box = scene.node_box.view(-1, 8, 6)
    node_links = scene.node_links.to(i64)
    tri_rows = scene.tri_data[:, :72].reshape(-1, 8, 9)
    if touched is not None:
        touched["nodes"] = torch.zeros(node_links.shape[0], dtype=torch.bool, device=dev)
        touched["packets"] = torch.zeros(tri_rows.shape[0], dtype=torch.bool, device=dev)

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
            if touched is not None:
                touched["nodes"][n] = True
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
                if anyhit:
                    m &= best_tri[a] < 0
                if not bool(m.any()):
                    break
                if touched is not None:
                    touched["packets"][first[m] + j] = True
                _leaf_packet(tri_rows, first[m] + j, a[m], o, d, best_t, best_tri, best_u, best_v)
            if anyhit:
                sp[a[best_tri[a] >= 0]] = 0

    def per_packet(x):
        return x.view(B, P).sum(dim=1).to(torch.int32)

    return best_t, best_tri, best_u, best_v, per_packet(ovf), per_packet(ivis), per_packet(ltst)


def trace_packets_reference(
    scene: KernelScene,
    rays9: torch.Tensor,
    *,
    stack_size: int,
    t_max: float = math.inf,
    live_packets=None,
) -> KernelHits:
    """Plain PyTorch version of K1, same signature and output: the shared
    traversal loop plus the shading epilogue."""
    B, _, P = rays9.shape
    best_t, best_tri, best_u, best_v, ovf, ivis, ltst = _traverse_reference(
        scene, rays9, stack_size=stack_size, t_max=t_max, live_packets=live_packets
    )
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
        overflow=ovf,
        inner_visits=ivis,
        leaf_tests=ltst,
    )


def trace_packets_pt_reference(
    scene: PTScene,
    rays9: torch.Tensor,
    *,
    stack_size: int,
    t_max: float = math.inf,
    live_packets=None,
    anyhit: bool = False,
    roots: torch.Tensor | None = None,
) -> PTHits:
    """Plain PyTorch version of K2, same signature and output."""
    B, _, P = rays9.shape
    best_t, best_tri, best_u, best_v, ovf, ivis, ltst = _traverse_reference(
        scene, rays9, stack_size=stack_size, t_max=t_max, live_packets=live_packets,
        anyhit=anyhit, roots=roots,
    )
    return PTHits(
        t=best_t.view(B, P),
        tri=best_tri.to(torch.int32).view(B, P),
        u=best_u.view(B, P),
        v=best_v.view(B, P),
        overflow=ovf,
        inner_visits=ivis,
        leaf_tests=ltst,
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
