"""The 16-bit compressed BVH decoded by its published rule, checked against
the source mesh, and laid out for the plain traversal.

Upstream minipath stores its BVH compressed to 16 bits
(``src/scene/triangle_bvh/compressed_geometry.rs``): a child's box is kept
as u16 fractions of its parent's *decompressed* box, rounded outward, so
that children are built against the lossy parent box
(``building.rs:149-156``), and a leaf's vertices as u16 fractions of the
leaf's decompressed box, rounded to nearest. The program's layout adds u16
materials and i8 shading normals (upstream keeps normals as f32). Its words:

- a node row, 32 i32: child ``c``'s box at words ``3c .. 3c+2`` as u16
  pairs, the low half first: ``(min x | min y, min z | max x, max y | max
  z)``; child links at words 24..31;
- a triangle row, 64 i32, one packet of 8 lanes: 72 u16 vertex coordinates
  at words 0..35 (lane ``l``, value ``k`` at ``9 l + k``: v0, v1, v2, each
  xyz), 8 u16 materials at 36..39, 72 i8 shading-normal components at
  40..57 in the vertices' order (the lowest byte of a word first); the rest
  is the program's own;
- a link: an i32 whose 3 low bits are a leaf's packet count (0 for an inner
  node) and whose high bits are the node's or the leaf's first packet's
  index; -8 is no child;
- the root link and the root box (min xyz, max xyz): the root's frame is
  that box decoded as a child with the fractions 0 and 65535.

The decoding rule, in float32 with each step rounded:
``scale = (hi - lo) * float32(1/65535)``, then ``lo + q * scale``; a normal
component is ``i8 * float32(1/127)``.

:func:`check` holds the decoded words to the mesh on three counts, each
a number whose sound value is a few float32 spacings at most:

- ``vertex_ulps``: how far a decoded vertex lies from its source vertex
  beyond the rule's rounding, half a step of its leaf box (the box's extent
  over 65535), in float32 spacings at the leaf box's coordinates; the
  lanes have to hold every source triangle once;
- ``box_ulps``: how far any triangle beneath a decoded box, as decoded or
  as in the mesh, lies outside it, in float32 spacings at the box's
  coordinates;
- ``box_fit_ulps``, the other direction: how far a decoded box reaches
  beyond the source triangles beneath it by more than the rule's outward
  rounding, one step of the frame it is decoded against (its parent's
  decoded box: the frame's extent over 65535), in float32 spacings at the
  frame's coordinates; the root's frame, stored in float32, gets no step.
  Boxes rounded out further than the rule allows store their vertices more
  coarsely, and the two checks above cannot see it: the decode is
  consistent and contains everything.

:func:`reference_scene` then lays the decoded triangles out for
``trace.prepare`` over the reference's own tree, its boxes refitted to
them, so that ``parity.render_pixels`` and ``estimate_pixels`` render the
geometry that the layout stores.

This module imports torch and NumPy only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import bvh, trace

NULL = -8
COUNT_BITS, COUNT_MASK = 3, 7
INV_U16 = np.float32(1.0 / 65535.0)
INV_127 = np.float32(1.0 / 127.0)
# What a word check reads where the lanes do not hold the mesh's triangles,
# each once: no vertex can be compared.
UNMATCHED = 1e30


class Words(NamedTuple):
    """The program's words on the host."""

    node_q: np.ndarray  # (N, 32) int32
    tri_q: np.ndarray  # (M, 64) int32
    root: int
    root_box: np.ndarray  # (6,) float32


class Decoded(NamedTuple):
    child_box: np.ndarray  # (N, 8, 6) float32, each valid child's decoded box
    links: np.ndarray  # (N, 8) int64
    levels: list  # arrays of the inner nodes the root reaches, level by level from the root
    root_frame: np.ndarray  # (6,) float32
    leaf_box: np.ndarray  # (M, 6) float32, the decoded box of each packet's leaf
    verts: np.ndarray  # (M, 8, 3, 3) float32
    normals: np.ndarray  # (M, 8, 3, 3) float32
    frame: np.ndarray  # (N, 6) float32, the box each reached inner node's children are decoded against


def _u16(words: np.ndarray) -> np.ndarray:
    """``(..., n)`` words -> ``(..., 2n)`` u16 values as float32, the low
    half of each word first."""
    w = words.astype(np.int64) & 0xFFFFFFFF
    return np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(*w.shape[:-1], -1).astype(np.float32)


def _i8(words: np.ndarray) -> np.ndarray:
    """``(..., n)`` words -> ``(..., 4n)`` signed bytes as float32, the
    lowest byte first."""
    b = words.astype(np.int32).view(np.uint8).reshape(*words.shape[:-1], -1)  # little-endian
    return b.view(np.int8).astype(np.float32)


def _dec(lo: np.ndarray, hi: np.ndarray, q: np.ndarray) -> np.ndarray:
    scale = ((hi - lo) * INV_U16).astype(np.float32)
    return (lo + (q * scale).astype(np.float32)).astype(np.float32)


def _leaf(link: np.ndarray):
    return (link & COUNT_MASK) != 0


def decode(words: Words) -> Decoded:
    """Every box, vertex and normal of the words, decoded level by level
    from the root box."""
    node_q = np.asarray(words.node_q, np.int32).reshape(-1, 32)
    tri_q = np.asarray(words.tri_q, np.int32).reshape(-1, 64)
    N, M = node_q.shape[0], tri_q.shape[0]
    links = node_q[:, 24:32].astype(np.int64)
    rb = np.asarray(words.root_box, np.float32).reshape(6)
    root_frame = np.concatenate([rb[:3], _dec(rb[:3], rb[3:], np.float32(65535.0))])
    child_box = np.zeros((N, 8, 6), np.float32)
    frame = np.zeros((N, 6), np.float32)
    leaf_box = np.zeros((M, 6), np.float32)

    def stamp(cl, boxes):
        for j in range(1, COUNT_MASK + 1):
            m = (cl & COUNT_MASK) >= j
            leaf_box[(cl[m] >> COUNT_BITS) + j - 1] = boxes[m]

    levels = []
    root = int(words.root)
    cl = np.array([root], np.int64)
    if root != NULL and _leaf(cl)[0]:
        stamp(cl, root_frame[None])
    frontier = cl[(cl != NULL) & ~_leaf(cl)] >> COUNT_BITS
    frames = np.repeat(root_frame[None], len(frontier), axis=0)
    while len(frontier):
        levels.append(frontier)
        frame[frontier] = frames
        q = _u16(node_q[frontier, :24]).reshape(-1, 8, 6)
        lo, hi = frames[:, None, 0:3], frames[:, None, 3:6]
        boxes = np.concatenate([_dec(lo, hi, q[..., 0:3]), _dec(lo, hi, q[..., 3:6])], axis=-1)
        child_box[frontier] = boxes
        cl = links[frontier]
        is_leaf = (cl != NULL) & _leaf(cl)
        stamp(cl[is_leaf], boxes[is_leaf])
        inner = (cl != NULL) & ~is_leaf
        frontier, frames = cl[inner] >> COUNT_BITS, boxes[inner]

    q = _u16(tri_q[:, 0:36]).reshape(M, 8, 3, 3)
    lb = leaf_box[:, None, None, :]
    verts = _dec(lb[..., 0:3], lb[..., 3:6], q)
    normals = (_i8(tri_q[:, 40:58]).reshape(M, 8, 3, 3) * INV_127).astype(np.float32)
    return Decoded(child_box, links, levels, root_frame, leaf_box, verts, normals, frame)


def lane_triangles(lane_vidx: np.ndarray, triangles: np.ndarray) -> np.ndarray | None:
    """``(M*8,)`` the source triangle of each lane, -1 on padding, from the
    vertex indices the program gives each lane (a lane whose indices are no
    triangle of the mesh is padding); None unless the lanes hold every
    triangle of the mesh exactly once."""
    lanes = np.asarray(lane_vidx, np.int64).reshape(-1, 3)
    tris = np.asarray(triangles, np.int64).reshape(-1, 3)
    _, key = np.unique(np.concatenate([tris, lanes]), axis=0, return_inverse=True)
    key = key.reshape(-1)
    tri_key, lane_key = key[: len(tris)], key[len(tris):]
    per_tri = np.bincount(tri_key, minlength=key.max(initial=0) + 1)
    real = per_tri[lane_key] > 0
    if not np.array_equal(np.bincount(lane_key[real], minlength=len(per_tri)), per_tri):
        return None
    out = np.full(len(lanes), -1, np.int64)
    # Equal triangles, if any, take the lanes that hold them in order.
    out[np.nonzero(real)[0][np.argsort(lane_key[real], kind="stable")]] = np.argsort(tri_key, kind="stable")
    return out


def _subtree_bounds(inner, first, count, packet_lo, packet_hi, levels):
    """``(lo, hi)``, each ``(N, 8, 3)``: the bounds of what lies beneath each
    child of each node, from the bounds of each packet. ``inner`` ``(N, 8)``
    is the child's node index (-1 where it is no inner node), ``first`` and
    ``count`` its packets where it is a leaf (``count`` 0 elsewhere);
    ``levels`` lists the nodes level by level from the root. Children that
    are neither bound nothing (``+inf``, ``-inf``)."""
    N = inner.shape[0]
    lo = np.full((N, 8, 3), np.inf, np.float32)
    hi = np.full((N, 8, 3), -np.inf, np.float32)
    for j in range(int(count.max(initial=0))):
        m = count > j
        lo[m] = np.minimum(lo[m], packet_lo[first[m] + j])
        hi[m] = np.maximum(hi[m], packet_hi[first[m] + j])
    node_lo = np.full((N, 3), np.inf, np.float32)
    node_hi = np.full((N, 3), -np.inf, np.float32)
    for nodes in reversed(levels):
        sub = inner[nodes]
        m = sub >= 0
        rows, cols = np.nonzero(m)
        lo[nodes[rows], cols] = node_lo[sub[m]]
        hi[nodes[rows], cols] = node_hi[sub[m]]
        node_lo[nodes] = lo[nodes].min(axis=1)
        node_hi[nodes] = hi[nodes].max(axis=1)
    return lo, hi


def _spacing(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The float32 spacing at a box's coordinates, per axis."""
    return np.spacing(np.maximum(np.abs(lo), np.abs(hi)).astype(np.float32)).astype(np.float64)


def check(decoded: Decoded, lane_tri, positions: np.ndarray, triangles: np.ndarray) -> dict:
    """``vertex_ulps``, ``box_ulps`` and ``box_fit_ulps`` (module docstring)
    of the decoded words against the mesh; ``lane_tri`` is
    :func:`lane_triangles`'s."""
    if lane_tri is None:
        return {"vertex_ulps": UNMATCHED, "box_ulps": UNMATCHED, "box_fit_ulps": UNMATCHED}
    M = decoded.verts.shape[0]
    real = lane_tri >= 0
    dec = decoded.verts.reshape(-1, 3, 3)
    src = np.zeros_like(dec)
    src[real] = positions[triangles[lane_tri[real]]].astype(np.float32)

    box = np.repeat(decoded.leaf_box, 8, axis=0)[real][:, None, :]
    lo, hi = box[..., 0:3], box[..., 3:6]
    half_step = (hi.astype(np.float64) - lo) / 65535.0 / 2.0
    beyond = (np.abs(dec[real].astype(np.float64) - src[real]) - half_step) / _spacing(lo, hi)
    vertex_ulps = max(0.0, float(beyond.max(initial=0.0)))

    both = np.concatenate([dec, src], axis=1)  # (M*8, 6, 3)
    lane_lo = np.where(real[:, None], both.min(axis=1), np.inf).reshape(M, 8, 3).min(axis=1)
    lane_hi = np.where(real[:, None], both.max(axis=1), -np.inf).reshape(M, 8, 3).max(axis=1)
    links = decoded.links
    valid = links != NULL
    is_leaf = valid & _leaf(links)
    inner = np.where(valid & ~is_leaf, links >> COUNT_BITS, -1)
    first = np.where(is_leaf, links >> COUNT_BITS, 0)
    count = np.where(is_leaf, links & COUNT_MASK, 0)
    sub_lo, sub_hi = _subtree_bounds(inner, first, count, lane_lo, lane_hi, decoded.levels)
    boxes = decoded.child_box
    reached = np.zeros(len(links), bool)
    for nodes in decoded.levels:
        reached[nodes] = True
    m = valid & reached[:, None]
    # The root's frame against everything in the tree.
    root_lo, root_hi = lane_lo.min(axis=0, initial=np.inf), lane_hi.max(axis=0, initial=-np.inf)
    box_lo = np.concatenate([boxes[m][:, 0:3], decoded.root_frame[None, 0:3]])
    box_hi = np.concatenate([boxes[m][:, 3:6], decoded.root_frame[None, 3:6]])
    in_lo = np.concatenate([sub_lo[m], root_lo[None]])
    in_hi = np.concatenate([sub_hi[m], root_hi[None]])
    out = np.maximum(box_lo.astype(np.float64) - in_lo, in_hi.astype(np.float64) - box_hi)
    out = np.where(np.isfinite(out), out, 0.0)  # a child with nothing beneath it
    box_ulps = max(0.0, float((out / _spacing(box_lo, box_hi)).max(initial=0.0)))

    # The other direction: each box against the source triangles beneath it.
    src_lo = np.where(real[:, None], src.min(axis=1), np.inf).reshape(M, 8, 3).min(axis=1)
    src_hi = np.where(real[:, None], src.max(axis=1), -np.inf).reshape(M, 8, 3).max(axis=1)
    fit_lo, fit_hi = _subtree_bounds(inner, first, count, src_lo, src_hi, decoded.levels)
    frames = np.broadcast_to(decoded.frame[:, None, :], boxes.shape)[m]
    frame_lo = np.concatenate([frames[:, 0:3], decoded.root_frame[None, 0:3]])
    frame_hi = np.concatenate([frames[:, 3:6], decoded.root_frame[None, 3:6]])
    step = (frame_hi.astype(np.float64) - frame_lo) / 65535.0
    step[-1] = 0.0
    held_lo = np.concatenate([fit_lo[m], src_lo.min(axis=0, initial=np.inf)[None]])
    held_hi = np.concatenate([fit_hi[m], src_hi.max(axis=0, initial=-np.inf)[None]])
    wide = np.maximum(held_lo - box_lo.astype(np.float64), box_hi.astype(np.float64) - held_hi) - step
    wide = np.where(np.isfinite(wide), wide, 0.0)  # a child with nothing beneath it
    box_fit_ulps = max(0.0, float((wide / _spacing(frame_lo, frame_hi)).max(initial=0.0)))
    return {"vertex_ulps": vertex_ulps, "box_ulps": box_ulps, "box_fit_ulps": box_fit_ulps}


def triangles_of(decoded: Decoded, lane_tri: np.ndarray, n_triangles: int):
    """``(vertices, normals)``, each ``(T, 3, 3)`` float32: the decoded
    triangles and shading normals in the mesh's triangle order."""
    real = lane_tri >= 0
    verts = np.zeros((n_triangles, 3, 3), np.float32)
    normals = np.zeros((n_triangles, 3, 3), np.float32)
    verts[lane_tri[real]] = decoded.verts.reshape(-1, 3, 3)[real]
    normals[lane_tri[real]] = decoded.normals.reshape(-1, 3, 3)[real]
    return verts, normals


def refit(tree: bvh.Tree, verts: np.ndarray) -> bvh.Tree:
    """The reference's tree with every box the bounds of the triangles
    ``verts`` ``(T, 3, 3)`` beneath it."""
    ids = tree.packet_tri
    v = verts[np.maximum(ids, 0)]  # (M, 8, 3, 3)
    packet_lo = np.where((ids >= 0)[..., None], v.min(axis=2), np.inf).min(axis=1).astype(np.float32)
    packet_hi = np.where((ids >= 0)[..., None], v.max(axis=2), -np.inf).max(axis=1).astype(np.float32)
    links = tree.links
    is_leaf = links < bvh.NULL
    first, count = bvh.decode_leaf(np.where(is_leaf, links, -2))
    levels, frontier = [], np.array([tree.root] if tree.root >= 0 else [], np.int64)
    while len(frontier):
        levels.append(frontier)
        sub = links[frontier]
        frontier = sub[sub >= 0]
    lo, hi = _subtree_bounds(np.where(links >= 0, links, -1), first, count, packet_lo, packet_hi, levels)
    empty = ~np.isfinite(lo).all(axis=-1)
    lo[empty], hi[empty] = 0.0, 0.0
    return tree._replace(box_min=lo, box_max=hi)


def reference_scene(decoded: Decoded, lane_tri: np.ndarray, tree: bvh.Tree, device, dtype=torch.float32):
    """``(trace.Scene, shading normals)`` of the decoded geometry over the
    reference's own tree (built on the mesh, refitted to the decoded
    triangles), in ``dtype``, for ``parity.render_pixels`` and
    ``estimate_pixels``."""
    n = int(tree.packet_tri.max()) + 1
    verts, normals = triangles_of(decoded, lane_tri, n)
    fitted = refit(tree, verts)
    scene = trace.prepare(fitted, verts.reshape(-1, 3), np.arange(3 * n).reshape(n, 3), device, dtype)
    return scene, torch.from_numpy(normals).to(device, dtype)
