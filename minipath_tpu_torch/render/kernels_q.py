"""The quantized traversal kernel K3, its plain PyTorch version, and the
dispatch by scene type.

K3 is the port of ``minipath_tpu/render/pallas_kernels.py::_traverse_kernel_q``
(wrapper ``trace_packets_pallas_q``): BVH traversal over the hierarchical
16-bit layout of ``scene/bvh/quantize.py``. A node row holds its children's
boxes as u16 fractions of the node's own decompressed box; a triangle row
holds its vertices as u16 fractions of the leaf's decompressed box, with u16
materials and i8 shading normals. Here it is ``csrc/traverse_q.cu`` (CUDA C++
for ``sm_90a``, its own library, built by ``nvcc`` at first use), launched
by :func:`trace_packets_q` in three modes: full closest-hit (``KernelHits``,
as K1), lean closest-hit and lean any-hit (``PTHits``, as K2).

Per ray the rules are K1's (``render/kernels.py``), and so is the 8-byte
stack entry, a link and an entry distance. The box a node's children, or a
leaf's triangles, decompress against is not carried on the stack: it is read
where it lives, an inner node's from its ``node_frame`` row and a leaf's
from words 58..63 of its packets' rows, both derived once at scene
preparation (:func:`quantized_scene_from_numpy`). The TPU
kernel's octant child order and its missing pop re-prune exist for its
2048-lane shared stack; a thread with its own stack needs neither, so K3
agrees with the JAX kernel except at exact ties and ulps of fused
multiply-adds.

The plain version decompresses the whole scene once, level by level, with
the kernel's float32 arithmetic, lays it out in K1's rows
(:func:`decompressed_kernel_scene`) and runs K1's and K2's shared plain
traversal. A BVH is a tree, so every node's decompressed child boxes and
every leaf's decompressed vertices are a function of that node alone, and
the two give the same bits on one device.

The layout the HBM-streamed TPU variant (``tri_in_hbm``) exists for is the
card's ordinary one: every row already lives in device memory, so that
variant is this same kernel.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from minipath_tpu_torch.render.kernels import (
    STACK_CAPACITY,
    KernelHits,
    KernelScene,
    PTHits,
    _aligned,
    _check,
    _live_count,
    _raise_on,
    build_shade_flat,
    trace_packets,
    trace_packets_pt_reference,
    trace_packets_reference,
)
from minipath_tpu_torch.scene.bvh import links as L
from minipath_tpu_torch.scene.bvh.build import BvhArrays, from_numpy
from minipath_tpu_torch.utils.profiling import count

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "traverse_q.cu"
_NULL = L.NULL_LINK
# float32(1 / 65535) and float32(1 / 127): MP_INV_U16 and MP_INV_127 in
# csrc/traverse_q.cu.
_INV_U16 = float(np.float32(1.0 / 65535.0))
_INV_127 = float(np.float32(1.0 / 127.0))
# Words of a triangle row that hold the leaf's own box as float bits (min xyz,
# max xyz); unused by the quantizer (scene/bvh/quantize.py).
LEAF_FRAME_WORDS = slice(58, 64)
_MODES = {(False, False): 0, (True, False): 1, (True, True): 2}
_MODE_NAMES = ("full", "closest", "anyhit")


class QuantizedScene(NamedTuple):
    """The 16-bit layout for K3; counterpart of the JAX package's
    ``QuantizedPallasScene``."""

    node_q: torch.Tensor  # (N, 32) i32: u16 child boxes (words 0..23), links (24..31)
    tri_q: torch.Tensor  # (M, 64) i32: u16 vertices, u16 materials, i8 normals
    root: int  # encoded root link
    root_box: torch.Tensor  # (6,) f32 stored scene box (min, max): the root's frame
    # (N, 8) f32: every inner node's own decompressed box (min xyz, max xyz,
    # two words of padding), the frame of its children's u16 boxes.
    node_frame: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.node_q.device


class QPTScene(NamedTuple):
    """The lean path tracer's quantized layout: :class:`QuantizedScene`'s
    rows plus K2's shading table, read outside the kernel
    (``render/wavefront.py::shade_from_flat``)."""

    node_q: torch.Tensor
    tri_q: torch.Tensor
    root: int
    root_box: torch.Tensor
    shade_flat: torch.Tensor  # (M*8, 20) f16, as PTScene
    # As QuantizedScene; the kernel needs it, the plain version does not.
    node_frame: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.node_q.device


def quantized_scene_from_numpy(fields, device) -> QuantizedScene:
    """:class:`QuantizedScene` on ``device`` from a mapping with the fields
    ``node_q``, ``tri_q``, ``root`` and ``root_box`` of
    ``scene/bvh/quantize.py``'s ``QuantizedSceneArrays`` (array-likes; the
    JAX package's arrays of the same name carry over unchanged).

    Two things are derived here, on ``device``, with the kernel's float32
    steps (:func:`decompressed_boxes`): ``node_frame``, and each leaf's own
    box, written as float bits into words 58..63 of every packet of that
    leaf in the device copy of ``tri_q``. The quantizer leaves those six
    words unused, so a leaf's frame costs no byte and arrives with the row.
    With both, a stack entry of K3 is a link and an entry distance, as K2's:
    a BVH is a tree, so a node's box is a function of the node alone."""

    def tensor(name, dtype):
        return torch.from_numpy(np.array(fields[name], dtype=dtype, copy=True)).to(device)

    node_q = tensor("node_q", np.int32).reshape(-1, 32).contiguous()
    tri_q = tensor("tri_q", np.int32).reshape(-1, 64).contiguous()
    root = int(np.asarray(fields["root"]).reshape(()))
    root_box = tensor("root_box", np.float32).reshape(6).contiguous()
    _, node_frame, leaf_box = decompressed_boxes(node_q, tri_q.shape[0], root, root_box)
    tri_q[:, LEAF_FRAME_WORDS] = leaf_box.view(torch.int32)
    return QuantizedScene(
        node_q=node_q,
        tri_q=tri_q,
        root=root,
        root_box=root_box,
        node_frame=torch.cat([node_frame, torch.zeros_like(node_frame[:, :2])], dim=1).contiguous(),
    )


def prepare_scene_quantized(bvh: BvhArrays, device) -> QuantizedScene:
    """Quantize host (NumPy) BVH arrays and move the words to ``device``."""
    from minipath_tpu_torch.scene.bvh.quantize import build_quantized_scene

    return quantized_scene_from_numpy(build_quantized_scene(bvh)._asdict(), device)


def prepare_scene_qpt(bvh: BvhArrays, device) -> QPTScene:
    """The quantized lean layout from host BVH arrays: the shading table is
    built first, so its material-id check (``< 2048``) comes before any
    quantizing."""
    shade_flat = build_shade_flat(from_numpy(bvh._asdict(), device))
    return QPTScene(**prepare_scene_quantized(bvh, device)._asdict(), shade_flat=shade_flat)


# ---- the plain version ----------------------------------------------------------


def _u16(words: torch.Tensor) -> torch.Tensor:
    """``(..., n)`` i32 words -> ``(..., 2n)`` u16 values as i64, the low half
    of each word first."""
    w = words.to(torch.int64)
    return torch.stack([w & 0xFFFF, (w >> 16) & 0xFFFF], dim=-1).flatten(-2)


def _i8(words: torch.Tensor) -> torch.Tensor:
    """``(..., n)`` i32 words -> ``(..., 4n)`` sign-extended bytes, the lowest
    byte first: ``(w << (24 - 8k)) >> 24``, an arithmetic shift on int32."""
    return torch.stack([(words << (24 - 8 * k)) >> 24 for k in range(4)], dim=-1).flatten(-2)


def _dec(lo: torch.Tensor, hi: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The kernel's decompression, each step rounded to float32: the scale
    ``(hi - lo) * (1/65535)`` first, then ``lo + q * scale``."""
    scale = (hi - lo) * torch.tensor(_INV_U16, dtype=torch.float32, device=lo.device)
    return lo + q.to(torch.float32) * scale


def decompressed_boxes(node_q: torch.Tensor, n_packets: int, root: int, root_box: torch.Tensor):
    """Every box of a quantized tree, decompressed level by level from the
    stored root box with the kernel's float32 arithmetic (:func:`_dec`):
    ``(child_box (N, 8, 6), node_frame (N, 6), leaf_box (n_packets, 6))``, the
    boxes of each inner node's children, each inner node's own box, and for
    each triangle packet the box of the leaf that holds it. Rows that the
    root does not reach stay zero."""
    dev = node_q.device
    N = node_q.shape[0]
    links = node_q[:, 24:32]
    child_box = torch.zeros((N, 8, 6), dtype=torch.float32, device=dev)
    node_frame = torch.zeros((N, 6), dtype=torch.float32, device=dev)
    leaf_box = torch.zeros((n_packets, 6), dtype=torch.float32, device=dev)

    def stamp_leaves(cl, box):
        """Packets ``idx .. idx+count`` of leaf links ``cl`` take ``box``."""
        count, idx = cl & L.COUNT_MASK, (cl >> L.COUNT_BITS).long()
        for j in range(L.MAX_COUNT):
            m = count > j
            leaf_box[idx[m] + j] = box[m]

    root = torch.tensor([root], dtype=torch.int32, device=dev)
    root_box = root_box.reshape(1, 6).to(torch.float32)
    leaf = (root != _NULL) & ((root & L.COUNT_MASK) != 0)
    stamp_leaves(root[leaf], root_box[leaf])
    inner = (root != _NULL) & ~leaf
    frontier, frames = (root[inner] >> L.COUNT_BITS).long(), root_box[inner]
    while frontier.numel():
        node_frame[frontier] = frames
        q = _u16(node_q[frontier, :24]).view(-1, 8, 6)
        lo, hi = frames[:, None, 0:3], frames[:, None, 3:6]
        child = torch.cat([_dec(lo, hi, q[..., 0:3]), _dec(lo, hi, q[..., 3:6])], dim=-1)
        child_box[frontier] = child
        cl = links[frontier]
        is_leaf = (cl != _NULL) & ((cl & L.COUNT_MASK) != 0)
        stamp_leaves(cl[is_leaf], child[is_leaf])
        is_inner = (cl != _NULL) & ~is_leaf
        frontier, frames = (cl[is_inner] >> L.COUNT_BITS).long(), child[is_inner]
    return child_box, node_frame, leaf_box


def decompressed_kernel_scene(scene) -> KernelScene:
    """K1's rows decompressed from a quantized scene, with the kernel's
    float32 arithmetic: node boxes level by level from the stored root box
    (:func:`decompressed_boxes`), each leaf's vertices against its
    decompressed box, the edges ``e1 = v1 - v0`` and ``e2 = v2 - v0`` as the
    kernel subtracts them, the i8 normals times ``1/127`` and the u16
    materials."""
    node_q, tri_q = scene.node_q, scene.tri_q
    dev = node_q.device
    N, M = node_q.shape[0], tri_q.shape[0]
    links = node_q[:, 24:32].contiguous()
    node_box, _, leaf_box = decompressed_boxes(node_q, M, scene.root, scene.root_box)

    verts = _dec(leaf_box[:, None, None, 0:3], leaf_box[:, None, None, 3:6], _u16(tri_q[:, 0:36]).view(M, 8, 3, 3))
    v0 = verts[:, :, 0]
    tri = torch.cat([v0, verts[:, :, 1] - v0, verts[:, :, 2] - v0], dim=-1).reshape(M, 72)
    material = _u16(tri_q[:, 36:40]).to(torch.float32)
    shade = _i8(tri_q[:, 40:58]).to(torch.float32) * torch.tensor(_INV_127, dtype=torch.float32, device=dev)
    return KernelScene(
        node_box=node_box.reshape(N, 48),
        node_links=links,
        tri_data=torch.cat([tri, material], dim=-1).contiguous(),
        tri_shade=shade.contiguous(),
        root=int(scene.root),
    )


def trace_packets_q_reference(
    scene,
    rays9: torch.Tensor,
    *,
    stack_size: int,
    t_max: float = math.inf,
    live_packets=None,
    lean: bool = False,
    anyhit: bool = False,
):
    """Plain PyTorch version of K3, same signature and output: K1's (full)
    or K2's (lean) plain version over :func:`decompressed_kernel_scene`."""
    if anyhit and not lean:
        raise ValueError("anyhit=True requires lean=True")
    rows = decompressed_kernel_scene(scene)
    kw = dict(stack_size=stack_size, t_max=t_max, live_packets=live_packets)
    if lean:
        return trace_packets_pt_reference(rows, rays9, anyhit=anyhit, **kw)
    return trace_packets_reference(rows, rays9, **kw)


# ---- the kernel -----------------------------------------------------------------

_ROWS = (("node_q", torch.int32, 32), ("tri_q", torch.int32, 64))
_FRAME_ROWS = (("node_frame", torch.float32, 8),)  # the kernel's alone


def trace_packets_q(
    scene,
    rays9: torch.Tensor,
    *,
    stack_size: int,
    t_max: float = math.inf,
    live_packets=None,
    lean: bool = False,
    anyhit: bool = False,
):
    """K3: trace ``rays9`` ``(B, 9, P)`` against a :class:`QuantizedScene`
    or :class:`QPTScene`.

    Full mode returns :class:`KernelHits` (t, tri, normal, material and the
    counters, as K1); ``lean`` returns :class:`PTHits` (t, tri, u, v, as
    K2), and ``lean`` with ``anyhit`` is the occlusion trace, where only
    ``tri >= 0`` carries meaning. ``live_packets`` is None, an int or a
    one-element integer tensor on the rays' device (read by the kernel, so
    no host sync); packets at index ``>= live_packets`` write misses.

    On CUDA tensors this launches the kernel (and raises if it cannot); on
    CPU tensors it runs :func:`trace_packets_q_reference`.
    ``trace_packets_q.launches`` counts kernel launches per mode
    (``full``, ``closest``, ``anyhit``); while tracing is on
    (``utils/profiling.py``), the counter ``k3.rays`` adds the rays of each
    call, ``B * P``, from the batch's shape.
    """
    if anyhit and not lean:
        raise ValueError("anyhit=True requires lean=True")
    _check(scene, rays9, stack_size, _ROWS)
    rb = scene.root_box
    if rb.device != rays9.device or rb.dtype != torch.float32 or rb.numel() != 6 or not rb.is_contiguous():
        raise ValueError(f"scene.root_box must be 6 contiguous float32 on {rays9.device}")
    count("k3.rays", rays9.shape[0] * rays9.shape[2])
    kw = dict(stack_size=stack_size, t_max=t_max, live_packets=live_packets, lean=lean, anyhit=anyhit)
    if rays9.device.type == "cpu":
        return trace_packets_q_reference(scene, rays9, **kw)
    if rays9.device.type != "cuda":
        raise ValueError(f"no traversal for device {rays9.device}")
    return _launch_q(scene, rays9, **kw)


trace_packets_q.launches = {name: 0 for name in _MODE_NAMES}


def load_library():
    """Build (at first use) and load K3's library; returns the
    :class:`~minipath_tpu_torch.utils.cuda_build.CudaLibrary`."""
    from minipath_tpu_torch.utils.cuda_build import load_cuda_library

    built = load_cuda_library(_SOURCE)
    lib = built.lib
    if lib.mp_trace_packets_q.argtypes is None:
        vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
        lib.mp_trace_packets_q.argtypes = [
            vp, vp, vp, i32, vp, vp, i64, i32, i32, f32, i32,
            vp, vp, vp, vp, vp, vp, vp,
        ]
        lib.mp_trace_packets_q.restype = i32
        lib.mp_error_string.argtypes = [i32]
        lib.mp_error_string.restype = ctypes.c_char_p
        lib.mp_stack_capacity.restype = i32
        if lib.mp_stack_capacity() != STACK_CAPACITY:
            raise RuntimeError("STACK_CAPACITY disagrees with csrc/traverse_q.cu")
    return built


def _launch_q(scene, rays9, *, stack_size, t_max, live_packets, lean, anyhit):
    lib = load_library().lib
    B, _, P = rays9.shape
    dev = rays9.device
    _check(scene, rays9, stack_size, _FRAME_ROWS)
    if scene.node_frame.shape[0] != scene.node_q.shape[0]:
        raise ValueError("scene.node_frame must have one row for each row of scene.node_q")
    _aligned(scene.node_q, scene.tri_q, scene.node_frame, rays9)
    live = _live_count(live_packets, dev)
    f32, i32 = torch.float32, torch.int32
    t = torch.empty((B, P), dtype=f32, device=dev)
    tri = torch.empty((B, P), dtype=i32, device=dev)
    if lean:
        out_a = torch.empty((B, P), dtype=f32, device=dev)  # u
        out_b = torch.empty((B, P), dtype=f32, device=dev)  # v
        material = None
    else:
        out_a = torch.empty((B, P, 3), dtype=f32, device=dev)  # normal
        out_b = None
        material = torch.empty((B, P), dtype=i32, device=dev)
    counters = torch.zeros((B, 3), dtype=i32, device=dev)
    mode = _MODES[(lean, anyhit)]

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        err = lib.mp_trace_packets_q(
            scene.node_q.data_ptr(),
            scene.tri_q.data_ptr(),
            scene.node_frame.data_ptr(),
            scene.root,
            ptr(live),
            rays9.data_ptr(),
            B * P,
            P,
            stack_size,
            float(t_max),
            mode,
            t.data_ptr(),
            tri.data_ptr(),
            out_a.data_ptr(),
            ptr(out_b),
            ptr(material),
            counters.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(lib, err)
    trace_packets_q.launches[_MODE_NAMES[mode]] += 1
    ovf, ivis, ltst = counters[:, 0], counters[:, 1], counters[:, 2]
    if lean:
        return PTHits(t=t, tri=tri, u=out_a, v=out_b, overflow=ovf, inner_visits=ivis, leaf_tests=ltst)
    return KernelHits(t=t, tri=tri, normal=out_a, material=material, overflow=ovf, inner_visits=ivis, leaf_tests=ltst)


# ---- dispatch by scene type -----------------------------------------------------


def trace_scene(scene, rays9: torch.Tensor, *, stack_size: int, t_max: float = math.inf, live_packets=None) -> KernelHits:
    """Full closest-hit trace by scene type: K3 over a quantized scene, K1
    over the f32 :class:`KernelScene` (the counterpart of the JAX package's
    ``trace_scene``)."""
    kw = dict(stack_size=stack_size, t_max=t_max, live_packets=live_packets)
    if isinstance(scene, (QuantizedScene, QPTScene)):
        return trace_packets_q(scene, rays9, **kw)
    return trace_packets(scene, rays9, **kw)
