"""16-bit quantized geometry storage.

A copy of the JAX package's ``minipath_tpu/scene/bvh/quantize.py`` (NumPy
only), so that the port builds the same words bit for bit without importing
that package. Capability counterpart of the reference's compressed
representations (``compressed_geometry.rs``): coordinates stored as u16
fractions of an enclosing box, with round-to-nearest for points and
conservative round-out for boxes (floor mins, ceil maxes —
``compress_round_out``, ``:122-131``).

Two layers live here:

* Self-contained per-record quantization helpers (``compress_tri_packets``,
  ``compress_child_boxes``, ``compress_normals_i8``) where the enclosing box
  is stored explicitly per record — used for round-trip testing and as
  building blocks.
* :func:`build_quantized_scene` — the HIERARCHICAL scene quantizer feeding
  the quantized traversal kernel K3 (``csrc/traverse_q.cu``, wrapper
  ``render/kernels_q.py::trace_packets_q``). Like the reference, child
  boxes are u16 fractions of their parent node's *decompressed* box
  (``building.rs:149-156`` — children are built against the lossy parent
  box) and leaf triangles are u16 fractions of the decompressed leaf box;
  the traversal stack carries the decompressed box down the tree exactly as
  the reference's ``StackCache`` does (``ray_bvh_intersection.rs:19-23``).
  Box round-out is validated and fixed up so the f32-decompressed child box
  always CONTAINS the exact child box. Shading normals additionally compress
  to int8 (the reference keeps normals f32; direction vectors tolerate
  8 bits).

Packed device layout (two u16 per int32 word; one row per node / triangle
packet):

* node row (32 x i32, 128 B): words ``[3c, 3c+2]`` = child ``c`` box as u16
  lo/hi pairs ``(minx|miny, minz|maxx, maxy|maxz)``; words ``[24+c]`` =
  child links (i32).
* triangle row (64 x i32, 256 B): words 0..35 = 72 u16 vertex coordinates
  (lane l, component k at flat index ``9l+k``); words 36..39 = 8 u16
  material ids; words 40..57 = 72 i8 shading-normal components (3 vertices
  x xyz per lane); words 58..63 unused.

Against the f32 layout a node row is 128 B instead of 192 + 32 B, and a
lean leaf visit reads the 144 B of vertex words instead of 320 B.

The decompression is separately rounded float32 (``_dec``: scale first,
then multiply, then add); the containment fix-up below proves containment
for exactly that arithmetic, so the kernel must not contract it into
fused multiply-adds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from minipath_tpu_torch.scene.bvh import links as L

U16_MAX = np.float32(65535.0)
INV_U16 = np.float32(1.0 / 65535.0)


def _to_unit(points, box_min, box_size):
    size = np.where(box_size > 0, box_size, 1.0)
    return (points - box_min) / size


def compress_unit(x, rounding="round") -> np.ndarray:
    """[0,1] floats -> u16 with the given rounding (reference ``:20-56``)."""
    scaled = np.asarray(x, np.float32) * U16_MAX
    if rounding == "round":
        scaled = np.rint(scaled)
    elif rounding == "floor":
        scaled = np.floor(scaled)
    elif rounding == "ceil":
        scaled = np.ceil(scaled)
    else:
        raise ValueError(rounding)
    return np.clip(scaled, 0.0, U16_MAX).astype(np.uint16)


def decompress_unit(u) -> np.ndarray:
    return np.asarray(u, np.float32) * np.float32(1.0 / 65535.0)


class QuantizedPackets(NamedTuple):
    """Triangle packets quantized relative to per-packet boxes."""

    box_min: np.ndarray  # (M, 3) f32
    box_size: np.ndarray  # (M, 3) f32
    q: np.ndarray  # (M, 8, 3, 3) u16


def compress_tri_packets(tri_packets: np.ndarray) -> QuantizedPackets:
    """Quantize ``(M, 8, 3, 3)`` packet vertices against per-packet bounds.

    Padding triangles (all-zero vertices) quantize to the box minimum and
    stay degenerate (the decompressed padding is a zero-area triangle, which
    Möller–Trumbore rejects — same invariant as the reference's zero-lane
    padding, ``compressed_geometry.rs:53,112``).
    """
    tp = np.asarray(tri_packets, np.float32)
    M = tp.shape[0]
    flat = tp.reshape(M, 24, 3)
    real = tp.reshape(M, 8, 9).any(axis=2)  # (M, 8) non-padding lanes
    mask = np.repeat(real, 3, axis=1)[..., None]  # (M, 24, 1)
    big = np.where(mask, flat, np.inf)
    small = np.where(mask, flat, -np.inf)
    box_min = np.where(real.any(1)[:, None], big.min(axis=1), 0.0).astype(np.float32)
    box_max = np.where(real.any(1)[:, None], small.max(axis=1), 0.0).astype(np.float32)
    box_size = box_max - box_min
    rel = _to_unit(flat, box_min[:, None], box_size[:, None])
    rel = np.where(mask, rel, 0.0)
    q = compress_unit(rel, "round").reshape(M, 8, 3, 3)
    return QuantizedPackets(box_min=box_min, box_size=box_size, q=q)


def decompress_tri_packets(qp: QuantizedPackets) -> np.ndarray:
    rel = decompress_unit(qp.q.reshape(qp.q.shape[0], 24, 3))
    out = qp.box_min[:, None] + rel * qp.box_size[:, None]
    return out.reshape(qp.q.shape).astype(np.float32)


class QuantizedChildBoxes(NamedTuple):
    """Per-node child AABBs quantized against the node's own box."""

    box_min: np.ndarray  # (N, 3) f32 node box
    box_size: np.ndarray  # (N, 3) f32
    q_min: np.ndarray  # (N, 8, 3) u16 (floor — rounds outward)
    q_max: np.ndarray  # (N, 8, 3) u16 (ceil — rounds outward)


def compress_child_boxes(child_min: np.ndarray, child_max: np.ndarray, valid=None) -> QuantizedChildBoxes:
    """Round-out quantization of child boxes (conservative: the decompressed
    box always CONTAINS the original, like ``compress_round_out``)."""
    cmin = np.asarray(child_min, np.float32)
    cmax = np.asarray(child_max, np.float32)
    if valid is None:
        valid = (cmax > cmin).any(axis=-1)
    v = valid[..., None]
    big = np.where(v, cmin, np.inf)
    small = np.where(v, cmax, -np.inf)
    node_min = np.where(valid.any(1)[:, None], big.min(axis=1), 0.0).astype(np.float32)
    node_max = np.where(valid.any(1)[:, None], small.max(axis=1), 0.0).astype(np.float32)
    size = node_max - node_min
    rel_min = np.where(v, _to_unit(cmin, node_min[:, None], size[:, None]), 0.0)
    rel_max = np.where(v, _to_unit(cmax, node_min[:, None], size[:, None]), 0.0)
    return QuantizedChildBoxes(
        box_min=node_min,
        box_size=size.astype(np.float32),
        q_min=compress_unit(rel_min, "floor"),
        q_max=compress_unit(rel_max, "ceil"),
    )


def decompress_child_boxes(qb: QuantizedChildBoxes):
    lo = qb.box_min[:, None] + decompress_unit(qb.q_min) * qb.box_size[:, None]
    hi = qb.box_min[:, None] + decompress_unit(qb.q_max) * qb.box_size[:, None]
    return lo.astype(np.float32), hi.astype(np.float32)


def compress_normals_i8(normals: np.ndarray) -> np.ndarray:
    """Unit-ish vectors -> int8 in [-127, 127] (shading tolerates 8 bits)."""
    return np.clip(np.rint(np.asarray(normals, np.float32) * 127.0), -127, 127).astype(
        np.int8
    )


def decompress_normals_i8(q: np.ndarray) -> np.ndarray:
    return np.asarray(q, np.float32) * np.float32(1.0 / 127.0)


# ---------------------------------------------------------------------------
# Hierarchical scene quantization (the kernel's quantized hot path)
# ---------------------------------------------------------------------------


class QuantizedSceneArrays(NamedTuple):
    """Host (numpy) arrays in the packed kernel layout (module docstring)."""

    node_q: np.ndarray  # (N, 32) i32
    tri_q: np.ndarray  # (M, 64) i32
    root: np.ndarray  # (1, 1) i32 encoded link
    root_box: np.ndarray  # (1, 6) f32 exact scene box (min, max)


def _dec(pb_min, pb_max, q):
    """f32 decompression exactly as the kernel computes it:
    ``pb_min + q * ((pb_max - pb_min) / 65535)`` (all float32)."""
    scale = ((pb_max - pb_min) * INV_U16).astype(np.float32)
    return (pb_min + q.astype(np.float32) * scale).astype(np.float32)


def root_frame(root_box: np.ndarray) -> np.ndarray:
    """The kernel reconstructs the root's box from its pseudo stack entry
    (q_min=0, q_max=65535) with f32 arithmetic; the quantizer must encode the
    root's children against that exact reconstruction, not the stored box."""
    rb = np.asarray(root_box, np.float32).reshape(6)
    lo = rb[0:3]
    hi = _dec(lo, rb[3:6], np.float32(65535.0))
    return np.concatenate([lo, hi])


def _inflate_root_box(bbox_min, bbox_max) -> np.ndarray:
    """Grow the stored root box max (by ulps) until the f32-reconstructed
    frame contains the exact scene bounds — keeps the conservative
    containment chain exact from the very top."""
    lo = np.asarray(bbox_min, np.float32)
    hi = np.asarray(bbox_max, np.float32)
    stored = hi.copy()
    for _ in range(8):
        rec = root_frame(np.concatenate([lo, stored]))[3:6]
        short = rec < hi
        if not short.any():
            break
        stored = np.where(short, np.nextafter(stored, np.inf), stored)
    return np.concatenate([lo, stored]).reshape(1, 6).astype(np.float32)


def _quantize_boxes_conservative(pb, cmin, cmax, valid):
    """Quantize child boxes (k, 8, 3) against parent boxes ``pb`` (k, 6).

    Round-out (floor mins / ceil maxes) with an f32 fix-up so the
    decompressed box always CONTAINS the exact child box — the conservative
    containment invariant of ``compress_round_out`` +
    ``building.rs:135-156``. Returns ``(q_min, q_max, dec_min, dec_max)``.
    """
    pmin = pb[:, None, 0:3]
    pmax = pb[:, None, 3:6]
    size = (pmax - pmin).astype(np.float64)
    safe = np.where(size > 0, size, 1.0)
    fmin = (cmin.astype(np.float64) - pmin) / safe
    fmax = (cmax.astype(np.float64) - pmin) / safe
    q_min = np.clip(np.floor(fmin * 65535.0), 0, 65535)
    q_max = np.clip(np.ceil(fmax * 65535.0), 0, 65535)
    q_min = np.where(valid[..., None], q_min, 0).astype(np.int64)
    q_max = np.where(valid[..., None], q_max, 0).astype(np.int64)

    # Fix-up: the kernel decompresses in f32; nudge q until containment is
    # exact under f32 arithmetic (float rounding can cost 1-2 steps).
    for _ in range(4):
        dec_min = _dec(pmin, pmax, q_min)
        dec_max = _dec(pmin, pmax, q_max)
        over = valid[..., None] & (dec_min > cmin) & (q_min > 0)
        under = valid[..., None] & (dec_max < cmax) & (q_max < 65535)
        if not (over.any() or under.any()):
            break
        q_min = q_min - over
        q_max = q_max + under
    dec_min = _dec(pmin, pmax, q_min)
    dec_max = _dec(pmin, pmax, q_max)
    # Sanity: containment must hold up to f32 rounding noise at the frame
    # boundary (where q has no room left); anything beyond ~2 quantization
    # steps indicates a quantizer/kernel frame mismatch, not rounding.
    tol = (pmax - pmin).astype(np.float64) * (2.0 / 65535.0)
    bad = valid[..., None] & (
        (dec_min > cmin + tol) | (dec_max < cmax - tol)
    )
    if bad.any():
        raise AssertionError(
            "quantized child boxes failed the conservative-containment "
            "invariant (quantizer/kernel frame mismatch?)"
        )
    return q_min, q_max, dec_min, dec_max


def _to_i32(words_u64):
    return (words_u64 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def build_quantized_scene(arrays) -> QuantizedSceneArrays:
    """Hierarchically quantize a host :class:`~minipath_tpu_torch.scene.bvh.build.BvhArrays`
    into the packed kernel layout. Pure numpy, host-side, level-vectorized."""
    links = np.asarray(arrays.node_child_links, np.int32)
    cbmin = np.asarray(arrays.node_child_box_min, np.float32)
    cbmax = np.asarray(arrays.node_child_box_max, np.float32)
    tp = np.asarray(arrays.tri_packets, np.float32)
    N = links.shape[0]
    M = tp.shape[0]
    root = int(np.asarray(arrays.root))
    root_box = _inflate_root_box(arrays.bbox_min, arrays.bbox_max)

    node_box = np.zeros((N, 6), np.float32)  # decompressed box per inner node
    leaf_box = np.zeros((M, 6), np.float32)  # decompressed box per tri packet
    node_words = np.zeros((N, 32), np.int64)

    def seed(link, box):
        """Route a link to the frontier (inner) or stamp leaf boxes."""
        count = link & L.COUNT_MASK
        idx = link >> L.COUNT_BITS
        if count:  # leaf: all its packets share the leaf's box
            leaf_box[idx : idx + count] = box
            return None
        node_box[idx] = box
        return idx

    frontier = []
    if root != L.NULL_LINK:
        r = seed(root, root_frame(root_box))
        if r is not None:
            frontier.append(r)

    while frontier:
        n = np.asarray(frontier, np.int64)
        frontier = []
        pb = node_box[n]  # (k, 6)
        ln = links[n]  # (k, 8)
        valid = ln != L.NULL_LINK
        q_min, q_max, dec_min, dec_max = _quantize_boxes_conservative(
            pb, cbmin[n], cbmax[n], valid
        )
        # Pack: per child c, 3 words (minx|miny, minz|maxx, maxy|maxz).
        w0 = (q_min[..., 0] & 0xFFFF) | ((q_min[..., 1] & 0xFFFF) << 16)
        w1 = (q_min[..., 2] & 0xFFFF) | ((q_max[..., 0] & 0xFFFF) << 16)
        w2 = (q_max[..., 1] & 0xFFFF) | ((q_max[..., 2] & 0xFFFF) << 16)
        node_words[n[:, None], np.arange(8) * 3 + 0] = w0
        node_words[n[:, None], np.arange(8) * 3 + 1] = w1
        node_words[n[:, None], np.arange(8) * 3 + 2] = w2
        node_words[n[:, None], 24 + np.arange(8)] = ln.astype(np.int64) & 0xFFFFFFFF

        # Children recurse against the DECOMPRESSED boxes (building.rs:149-156).
        # Bulk-routed (the per-child Python loop was the scaling wall on
        # Sponza-class scenes: ~1M children -> minutes of interpreter time).
        cl = ln[valid].astype(np.int64)  # (K,) child links
        boxes = np.concatenate(
            [dec_min[valid], dec_max[valid]], axis=-1
        ).astype(np.float32)  # (K, 6)
        counts = cl & L.COUNT_MASK
        idxs = cl >> L.COUNT_BITS
        is_leaf = counts != 0
        lidx, lcnt = idxs[is_leaf], counts[is_leaf]
        if lidx.size:  # leaves: every packet in the run shares the leaf box
            offs = np.arange(int(lcnt.sum())) - np.repeat(
                np.cumsum(lcnt) - lcnt, lcnt
            )
            leaf_box[np.repeat(lidx, lcnt) + offs] = np.repeat(
                boxes[is_leaf], lcnt, axis=0
            )
        inner = idxs[~is_leaf]
        node_box[inner] = boxes[~is_leaf]
        frontier = inner.tolist()

    # ---- triangles: u16 fractions of the decompressed leaf box ------------
    lb_min = leaf_box[:, None, 0:3]  # (M, 1, 3) broadcast over 24 verts
    lb_max = leaf_box[:, None, 3:6]
    size = (lb_max - lb_min).astype(np.float64)
    safe = np.where(size > 0, size, 1.0)
    verts = tp.reshape(M, 24, 3)
    frac = (verts.astype(np.float64) - lb_min) / safe
    # Round-out frames always contain their leaf's vertices, so any real
    # out-of-frame vertex means the tree's leaf boxes don't cover the full
    # triangles — the SBVH build's clipped references do exactly that,
    # and clamping them here would silently corrupt geometry. Fail loudly.
    real = tp.any(axis=(2, 3)).repeat(3, axis=1).reshape(M, 24)[..., None]
    if bool(((frac < -1e-4) | (frac > 1.0 + 1e-4))[real & (size > 0)].any()):
        raise ValueError(
            "leaf vertices extend outside their quantization frame; scenes "
            "built with spatial splits (build_bvh(spatial_splits=True)) "
            "clip leaf boxes tighter than their triangles and cannot use "
            "the quantized layout — rebuild without spatial splits"
        )
    qv = np.clip(np.rint(frac * 65535.0), 0, 65535).astype(np.int64)  # (M, 24, 3)
    qv = qv.reshape(M, 8, 9)  # lane-major: 9 coords per lane

    tri_words = np.zeros((M, 64), np.int64)
    flat_q = qv.reshape(M, 72)
    tri_words[:, 0:36] = (flat_q[:, 0::2] & 0xFFFF) | ((flat_q[:, 1::2] & 0xFFFF) << 16)

    mats = np.asarray(arrays.tri_material, np.int64).reshape(M, 8)
    if mats.max(initial=0) > 0xFFFF:
        raise ValueError("quantized layout supports at most 65536 material ids")
    tri_words[:, 36:40] = (mats[:, 0::2] & 0xFFFF) | ((mats[:, 1::2] & 0xFFFF) << 16)

    # Shading normals -> i8. Same per-lane slots as prepare_scene: flat
    # triangles carry their (normalized) geometric normal in all 3 slots.
    v0 = tp[:, :, 0, :]
    e1 = tp[:, :, 1, :] - v0
    e2 = tp[:, :, 2, :] - v0
    vidx = np.asarray(arrays.tri_vidx, np.int64).reshape(M, 8, 3)
    vnorm = np.asarray(arrays.vert_normal, np.float32)[vidx]  # (M, 8, 3, 3)
    geom = np.cross(e1, e2)[:, :, None, :]  # (M, 8, 1, 3)
    flat = np.asarray(arrays.tri_flat, bool).reshape(M, 8)
    slots = np.where(flat[..., None, None], geom, vnorm).astype(np.float64)
    norm = np.sqrt((slots * slots).sum(-1, keepdims=True))
    slots = np.where(norm > 0, slots / np.where(norm > 0, norm, 1.0), 0.0)
    q8 = np.clip(np.rint(slots * 127.0), -127, 127).astype(np.int64) & 0xFF
    q8 = q8.reshape(M, 72)
    tri_words[:, 40:58] = (
        q8[:, 0::4] | (q8[:, 1::4] << 8) | (q8[:, 2::4] << 16) | (q8[:, 3::4] << 24)
    )

    return QuantizedSceneArrays(
        node_q=_to_i32(node_words),
        tri_q=_to_i32(tri_words),
        root=np.asarray(root, np.int32).reshape(1, 1),
        root_box=root_box.astype(np.float32),
    )


def decompress_scene(qs: QuantizedSceneArrays):
    """Reference decompressor for tests: walks the quantized scene with the
    same f32 arithmetic as the kernel and returns
    ``(node_child_min, node_child_max, tri_packets, leaf_box)`` in world
    space (padding lanes of unreferenced nodes/packets stay zero);
    ``leaf_box`` is the (M, 6) decompressed frame of each packet."""
    node_q = qs.node_q.astype(np.int64) & 0xFFFFFFFF
    tri_q = qs.tri_q.astype(np.int64) & 0xFFFFFFFF
    N = node_q.shape[0]
    M = tri_q.shape[0]
    dmin = np.zeros((N, 8, 3), np.float32)
    dmax = np.zeros((N, 8, 3), np.float32)
    leaf_box = np.zeros((M, 6), np.float32)
    root = int(qs.root[0, 0])
    links = qs.node_q[:, 24:32]

    def unpack_child(row, c):
        w0, w1, w2 = row[3 * c], row[3 * c + 1], row[3 * c + 2]
        qmn = np.array([w0 & 0xFFFF, (w0 >> 16) & 0xFFFF, w1 & 0xFFFF])
        qmx = np.array([(w1 >> 16) & 0xFFFF, w2 & 0xFFFF, (w2 >> 16) & 0xFFFF])
        return qmn, qmx

    stack = []
    if root != L.NULL_LINK:
        stack.append((root, root_frame(qs.root_box)))
    while stack:
        link, box = stack.pop()
        count = link & L.COUNT_MASK
        idx = link >> L.COUNT_BITS
        if count:
            leaf_box[idx : idx + count] = box
            continue
        pmin = box[0:3].astype(np.float32)
        pmax = box[3:6].astype(np.float32)
        scale = ((pmax - pmin) * INV_U16).astype(np.float32)
        for c in range(8):
            cl = int(links[idx, c])
            if cl == L.NULL_LINK:
                continue
            qmn, qmx = unpack_child(node_q[idx], c)
            lo = (pmin + qmn.astype(np.float32) * scale).astype(np.float32)
            hi = (pmin + qmx.astype(np.float32) * scale).astype(np.float32)
            dmin[idx, c] = lo
            dmax[idx, c] = hi
            stack.append((cl, np.concatenate([lo, hi])))

    qv = np.zeros((M, 72), np.int64)
    qv[:, 0::2] = tri_q[:, 0:36] & 0xFFFF
    qv[:, 1::2] = (tri_q[:, 0:36] >> 16) & 0xFFFF
    lmin = leaf_box[:, None, 0:3]
    lscale = ((leaf_box[:, None, 3:6] - lmin) * INV_U16).astype(np.float32)
    verts = (lmin + qv.reshape(M, 24, 3).astype(np.float32) * lscale).astype(np.float32)
    return dmin, dmax, verts.reshape(M, 8, 3, 3), leaf_box
