"""Host-side 8-ary SAH BVH builder producing flat device arrays.

Capability counterpart of ``minipath/src/scene/triangle_bvh/building.rs``
(8-ary nodes, <=56-triangle leaves packed into 8-wide packets with degenerate
padding), but built the array way instead of translating the reference's
binned agglomerative merge: each inner node partitions its triangles into up
to 8 children by recursive binned-SAH binary splits (the standard "collapse a
binary BVH into a wide node" scheme), fully vectorized in NumPy.

Output is a :class:`BuildResult` whose :meth:`BuildResult.as_device` yields a
:class:`BvhArrays` of flat torch tensors on a chosen device, the input of
``render/kernels.py::prepare_scene``:

* per-node child boxes ``(N, 8, 3)`` min/max and child links ``(N, 8)``
* triangle packets ``(M, 8, 3, 3)`` world-space f32 vertices
* per-(padded)-triangle shading data + unified vertex normal/uv arrays.

Unlike the reference there is no lossy box-compression chain here — nodes
store exact f32 world-space child boxes (the 16-bit quantized storage of
``compressed_geometry.rs`` is an optional follow-up layered on this layout).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from minipath_tpu_torch.scene.bvh import links as L
from minipath_tpu_torch.scene.obj_loader import MeshData
from minipath_tpu_torch.utils.stats import Stats

_SAH_BINS = 16

# Spatial-split (SBVH) tuning: a group is eligible for a spatial split only
# when its best object split leaves children whose boxes overlap by more
# than ``alpha`` of the root surface area (Stich et al. 2009 §4.1), and the
# total reference count may grow to at most ``max_ref_ratio`` times the
# triangle count before spatial splitting shuts off.
_SBVH_ALPHA = 1e-5
_SBVH_MAX_REF_RATIO = 1.6


class BvhArrays(NamedTuple):
    """Flat BVH arrays: NumPy on the host, torch tensors on a device.

    ``root`` is an encoded link scalar; see ``minipath_tpu_torch.scene.bvh.links``.
    """

    node_child_box_min: "np.ndarray"  # (N, 8, 3) f32
    node_child_box_max: "np.ndarray"  # (N, 8, 3) f32
    node_child_links: "np.ndarray"  # (N, 8) i32
    tri_packets: "np.ndarray"  # (M, 8, 3, 3) f32, padding triangles all-zero
    tri_vidx: "np.ndarray"  # (M*8, 3) i32
    tri_flat: "np.ndarray"  # (M*8,) bool
    tri_material: "np.ndarray"  # (M*8,) i32
    vert_normal: "np.ndarray"  # (V, 3) f32
    vert_uv: "np.ndarray"  # (V, 3) f32
    root: "np.ndarray"  # () i32 encoded link
    bbox_min: "np.ndarray"  # (3,) f32
    bbox_max: "np.ndarray"  # (3,) f32


@dataclass
class BuildResult:
    """Builder output: NumPy arrays plus build statistics."""

    arrays: BvhArrays
    triangle_count: int
    vertex_count: int
    max_depth: int
    leaf_depth: Stats = field(default_factory=Stats)
    inner_fill: Stats = field(default_factory=Stats)  # children per inner node
    leaf_fill: Stats = field(default_factory=Stats)  # triangles per leaf

    @property
    def recommended_stack_size(self) -> int:
        # Provable worst case: the root contributes 1 entry and every
        # inner-node pop on the DFS path nets at most +7 (pop 1, push <= 8),
        # with at most ``max_depth`` inner levels above any leaf; leaf
        # continuations net 0 (pop 1, push 1). Bound = 7 * max_depth + 1,
        # plus 8 headroom (the kernel also guards pushes and reports
        # overflow, so an undersized stack degrades loudly, not silently).
        return 7 * self.max_depth + 9

    def as_device(self, device) -> BvhArrays:
        """The arrays as torch tensors on ``device``."""
        return from_numpy(self.arrays._asdict(), device)


def from_numpy(arrays, device) -> BvhArrays:
    """Torch :class:`BvhArrays` on ``device`` from a mapping of field name to
    array-like: a host :class:`BvhArrays`' ``_asdict()``, or the same fields
    taken from another build's output."""
    import torch

    return BvhArrays(
        **{
            name: torch.from_numpy(np.array(arrays[name], copy=True)).to(device)
            for name in BvhArrays._fields
        }
    )


def compute_tree_stats(arrays: BvhArrays):
    """Post-walk BVH health statistics from the flat arrays alone.

    Returns ``(max_depth, leaf_depth, inner_fill, leaf_fill)`` with the same
    meaning as the reference's recursive walk
    (``minipath/src/scene/triangle_bvh/printing.rs:11-70``): leaf
    depth distribution, children per inner node, non-padding triangles per
    leaf. Used to fill statistics for builders that don't track them inline
    (the native C++ builder).
    """
    leaf_depth, inner_fill, leaf_fill = Stats(), Stats(), Stats()
    root = int(arrays.root)
    if root == L.NULL_LINK:
        return 0, leaf_depth, inner_fill, leaf_fill

    links_arr = np.asarray(arrays.node_child_links)
    tp = np.asarray(arrays.tri_packets)
    real_lane = tp.reshape(tp.shape[0], 8, 9).any(axis=2)  # non-padding lanes
    lane_csum = np.concatenate(
        [[0], np.cumsum(real_lane.sum(axis=1, dtype=np.int64))]
    )

    max_depth = 0
    frontier = np.array([root], np.int64)  # encoded links at current depth
    depth = 0
    while frontier.size:
        counts = frontier & L.COUNT_MASK
        idxs = frontier >> L.COUNT_BITS
        is_leaf = counts != 0
        if is_leaf.any():
            first = idxs[is_leaf]
            cnt = counts[is_leaf]
            fills = lane_csum[first + cnt] - lane_csum[first]
            leaf_fill.add_samples(fills)
            leaf_depth.add_samples(np.full(first.shape, depth))
            max_depth = depth
        inner_idx = idxs[~is_leaf]
        if inner_idx.size:
            children = links_arr[inner_idx]  # (k, 8)
            valid = children != L.NULL_LINK
            inner_fill.add_samples(valid.sum(axis=1))
            frontier = children[valid].astype(np.int64)
        else:
            frontier = np.empty(0, np.int64)
        depth += 1
    return max_depth, leaf_depth, inner_fill, leaf_fill


def _surface_area(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    s = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (s[..., 0] * (s[..., 1] + s[..., 2]) + s[..., 1] * s[..., 2])


class _Refs(NamedTuple):
    """A group of triangle *references* during the build: triangle ids plus
    each reference's own AABB. Without spatial splits a reference box is its
    triangle's full box; a spatial split clips straddling references, so one
    triangle may be referenced (with disjoint boxes) from several leaves."""

    ids: np.ndarray  # (n,) int64 triangle ids (duplicates allowed)
    bmin: np.ndarray  # (n, 3) f32
    bmax: np.ndarray  # (n, 3) f32

    def __len__(self) -> int:
        return len(self.ids)

    def take(self, mask: np.ndarray) -> "_Refs":
        return _Refs(self.ids[mask], self.bmin[mask], self.bmax[mask])


def _clip_tris_to_slab(verts: np.ndarray, axis: int, lo: float, hi: float):
    """AABB of each triangle clipped to the axis slab ``[lo, hi]``.

    ``verts`` is ``(n, 3, 3)``. The clipped polygon's vertices are exactly
    the original vertices inside the slab plus the edge/plane crossing
    points, so its AABB is the masked min/max over those candidates. Empty
    results come out inverted (min > max)."""
    x = verts[:, :, axis]
    inside = (x >= lo) & (x <= hi)  # (n, 3)
    vmin = np.where(inside[..., None], verts, np.inf).min(axis=1)
    vmax = np.where(inside[..., None], verts, -np.inf).max(axis=1)
    a = verts
    b = verts[:, [1, 2, 0], :]
    xa, xb = x, x[:, [1, 2, 0]]
    d = xb - xa
    safe_d = np.where(d == 0.0, 1.0, d)
    for plane in (lo, hi):
        t = (plane - xa) / safe_d
        valid = (d != 0.0) & (t > 0.0) & (t < 1.0)
        # Clamp before the multiply: an infinite plane (the final left/right
        # chop) makes t infinite on parallel edges, and inf * 0 would emit
        # NaN warnings even though `valid` masks those lanes out.
        t = np.clip(t, 0.0, 1.0)
        pt = a + t[..., None] * (b - a)  # (n, 3, 3)
        pt[:, :, axis] = plane
        vmin = np.minimum(vmin, np.where(valid[..., None], pt, np.inf).min(axis=1))
        vmax = np.maximum(vmax, np.where(valid[..., None], pt, -np.inf).max(axis=1))
    return vmin.astype(np.float32), vmax.astype(np.float32)


class _Builder:
    def __init__(
        self,
        mesh: MeshData,
        materials: np.ndarray,
        leaf_max: int = L.LEAF_NODE_MAX_TRIANGLES,
        spatial_splits: bool = False,
    ):
        self.mesh = mesh
        self.materials = materials
        assert 1 <= leaf_max <= L.LEAF_NODE_MAX_TRIANGLES
        self.leaf_max = leaf_max
        tv = mesh.positions[mesh.triangles].astype(np.float32)  # (T,3,3)
        self.tri_verts = tv
        self.tri_min = tv.min(axis=1)
        self.tri_max = tv.max(axis=1)
        self.spatial_splits = spatial_splits
        self.ref_budget = (
            int((_SBVH_MAX_REF_RATIO - 1.0) * len(tv)) if spatial_splits else 0
        )
        if len(tv):
            self.root_sa = float(
                _surface_area(self.tri_min.min(axis=0), self.tri_max.max(axis=0))
            )
        else:
            self.root_sa = 1.0

        self.node_box_min: list = []
        self.node_box_max: list = []
        self.node_links: list = []
        self.packet_tris: list = []  # (8,3,3) arrays
        self.packet_vidx: list = []  # (8,3) arrays
        self.packet_flat: list = []  # (8,) arrays
        self.packet_material: list = []  # (8,) arrays

        self.max_depth = 0
        self.leaf_depth = Stats()
        self.inner_fill = Stats()
        self.leaf_fill = Stats()

    # -- leaves ---------------------------------------------------------------

    def build_leaf(self, refs: _Refs, depth: int) -> int:
        idx = refs.ids
        n = len(idx)
        assert 1 <= n <= self.leaf_max
        packet_count = -(-n // L.LEAF_NODE_PACKET_SIZE)
        first = len(self.packet_tris)

        verts = np.zeros((packet_count * 8, 3, 3), np.float32)
        verts[:n] = self.tri_verts[idx]
        vidx = np.zeros((packet_count * 8, 3), np.int32)
        vidx[:n] = self.mesh.triangles[idx]
        flat = np.zeros(packet_count * 8, bool)
        if self.mesh.normals.size:
            norms = self.mesh.normals[self.mesh.triangles[idx]]  # (n,3,3)
            flat[:n] = (np.sum(norms * norms, axis=-1) == 0.0).any(axis=-1)
        else:
            flat[:n] = True
        mat = np.zeros(packet_count * 8, np.int32)
        mat[:n] = self.materials[idx]

        for p in range(packet_count):
            s = slice(p * 8, (p + 1) * 8)
            self.packet_tris.append(verts[s])
            self.packet_vidx.append(vidx[s])
            self.packet_flat.append(flat[s])
            self.packet_material.append(mat[s])

        self.max_depth = max(self.max_depth, depth)
        self.leaf_depth.add_sample(depth)
        self.leaf_fill.add_sample(n)
        return L.new_leaf(first, packet_count)

    # -- splitting --------------------------------------------------------------

    def _binary_split(self, refs: _Refs):
        """Binned-SAH binary object split over reference-box centers.

        Returns ``(cost, left, right)`` or None if all centers coincide."""
        c = 0.5 * (refs.bmin + refs.bmax)
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        extent = cmax - cmin
        if not np.any(extent > 0):
            return None

        best = None  # (cost, bins, split_bin)
        for axis in range(3):
            if extent[axis] <= 0:
                continue
            scale = _SAH_BINS / extent[axis]
            b = np.minimum(
                ((c[:, axis] - cmin[axis]) * scale).astype(np.int64), _SAH_BINS - 1
            )
            counts = np.bincount(b, minlength=_SAH_BINS)
            bmin = np.full((_SAH_BINS, 3), np.inf, np.float32)
            bmax = np.full((_SAH_BINS, 3), -np.inf, np.float32)
            np.minimum.at(bmin, b, refs.bmin)
            np.maximum.at(bmax, b, refs.bmax)

            # Prefix/suffix sweeps.
            pmin = np.minimum.accumulate(bmin, axis=0)
            pmax = np.maximum.accumulate(bmax, axis=0)
            smin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
            smax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
            pcnt = np.cumsum(counts)
            scnt = np.cumsum(counts[::-1])[::-1]

            # Split after bin i (left = bins 0..i, right = bins i+1..).
            left_sa = _surface_area(pmin[:-1], pmax[:-1])
            right_sa = _surface_area(smin[1:], smax[1:])
            cost = np.where(
                (pcnt[:-1] > 0) & (scnt[1:] > 0),
                left_sa * pcnt[:-1] + right_sa * scnt[1:],
                np.inf,
            )
            i = int(np.argmin(cost))
            if np.isfinite(cost[i]) and (best is None or cost[i] < best[0]):
                best = (float(cost[i]), b, i)

        if best is None:
            return None
        cost, b, i = best
        mask = b <= i
        return cost, refs.take(mask), refs.take(~mask)

    def _spatial_split(self, refs: _Refs):
        """Binned spatial split (SBVH, Stich et al. 2009 §4.2): bins chop
        the GROUP box; straddling references contribute their triangle
        clipped to each spanned bin, and performing the split clips them
        into BOTH children. Returns ``(cost, left, right, n_dup)`` or None."""
        gmin = refs.bmin.min(axis=0)
        gmax = refs.bmax.max(axis=0)
        extent = gmax - gmin
        best = None  # (cost, axis, split_bin, scale)
        for axis in range(3):
            if extent[axis] <= 1e-12:
                continue
            scale = _SAH_BINS / float(extent[axis])
            b_lo = np.clip(
                ((refs.bmin[:, axis] - gmin[axis]) * scale).astype(np.int64),
                0,
                _SAH_BINS - 1,
            )
            b_hi = np.clip(
                np.ceil((refs.bmax[:, axis] - gmin[axis]) * scale).astype(np.int64)
                - 1,
                b_lo,
                _SAH_BINS - 1,
            )
            entry = np.bincount(b_lo, minlength=_SAH_BINS)
            exit_ = np.bincount(b_hi, minlength=_SAH_BINS)
            bmin = np.full((_SAH_BINS, 3), np.inf, np.float32)
            bmax = np.full((_SAH_BINS, 3), -np.inf, np.float32)
            whole = b_lo == b_hi  # refs entirely inside one bin
            np.minimum.at(bmin, b_lo[whole], refs.bmin[whole])
            np.maximum.at(bmax, b_lo[whole], refs.bmax[whole])
            straddle = np.nonzero(~whole)[0]
            for k in range(_SAH_BINS):
                sel = straddle[(b_lo[straddle] <= k) & (b_hi[straddle] >= k)]
                if not sel.size:
                    continue
                lo = gmin[axis] + k / scale
                hi = gmin[axis] + (k + 1) / scale
                cmin, cmax = _clip_tris_to_slab(
                    self.tri_verts[refs.ids[sel]], axis, lo, hi
                )
                cmin = np.maximum(cmin, refs.bmin[sel])
                cmax = np.minimum(cmax, refs.bmax[sel])
                ok = (cmin <= cmax).all(axis=1)
                if ok.any():
                    bmin[k] = np.minimum(bmin[k], cmin[ok].min(axis=0))
                    bmax[k] = np.maximum(bmax[k], cmax[ok].max(axis=0))

            pmin = np.minimum.accumulate(bmin, axis=0)
            pmax = np.maximum.accumulate(bmax, axis=0)
            smin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
            smax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
            pcnt = np.cumsum(entry)  # refs entering at or before bin i
            scnt = np.cumsum(exit_[::-1])[::-1]  # refs exiting at or after i
            left_sa = _surface_area(pmin[:-1], pmax[:-1])
            right_sa = _surface_area(smin[1:], smax[1:])
            cost = np.where(
                (pcnt[:-1] > 0) & (scnt[1:] > 0),
                left_sa * pcnt[:-1] + right_sa * scnt[1:],
                np.inf,
            )
            i = int(np.argmin(cost))
            if np.isfinite(cost[i]) and (best is None or cost[i] < best[0]):
                best = (float(cost[i]), axis, i, scale)

        if best is None:
            return None
        cost, axis, i, scale = best
        plane = gmin[axis] + (i + 1) / scale
        go_left = refs.bmin[:, axis] < plane
        go_right = refs.bmax[:, axis] > plane
        # Refs exactly ON the plane (zero extent at it) must land somewhere.
        neither = ~(go_left | go_right)
        go_left |= neither
        both = np.nonzero(go_left & go_right)[0]
        left = refs.take(go_left)
        right = refs.take(go_right)
        if both.size:
            # Clip the straddlers' boxes to their side of the plane via the
            # true triangle polygon (tighter than a box chop). Degenerate
            # clips (triangle only touches the plane) fall back to the chop.
            for side, mask_side, lo, hi in (
                (left, go_left, -np.inf, plane),
                (right, go_right, plane, np.inf),
            ):
                pos = np.cumsum(mask_side) - 1  # ref row in `side`
                rows = pos[both]
                cmin, cmax = _clip_tris_to_slab(
                    self.tri_verts[refs.ids[both]], axis, lo, hi
                )
                cmin = np.maximum(cmin, refs.bmin[both])
                cmax = np.minimum(cmax, refs.bmax[both])
                bad = ~(cmin <= cmax).all(axis=1)
                if bad.any():
                    cmin[bad] = refs.bmin[both[bad]]
                    cmax[bad] = refs.bmax[both[bad]]
                    cmin[bad, axis] = np.maximum(cmin[bad, axis], lo)
                    cmax[bad, axis] = np.minimum(cmax[bad, axis], hi)
                side.bmin[rows] = cmin
                side.bmax[rows] = cmax
        return cost, left, right, int(both.size)

    def _split2(self, refs: _Refs):
        """One binary split: object SAH, upgraded to a spatial split when
        the object children overlap enough and it's cheaper (SBVH)."""
        obj = self._binary_split(refs)
        if obj is None:
            return None
        cost_o, left, right = obj
        if self.spatial_splits and self.ref_budget > 0 and len(left) and len(right):
            omin = np.maximum(left.bmin.min(axis=0), right.bmin.min(axis=0))
            omax = np.minimum(left.bmax.max(axis=0), right.bmax.max(axis=0))
            if (omin <= omax).all() and (
                _surface_area(omin, omax) > _SBVH_ALPHA * self.root_sa
            ):
                sp = self._spatial_split(refs)
                if sp is not None:
                    cost_s, sl, sr, n_dup = sp
                    if (
                        cost_s < cost_o
                        and n_dup <= self.ref_budget
                        and len(sl) < len(refs)
                        and len(sr) < len(refs)
                    ):
                        self.ref_budget -= n_dup
                        return sl, sr
        return left, right

    def _split8(self, refs: _Refs) -> list:
        """Partition into 2..8 child groups."""
        groups = [refs]
        unsplittable: set = set()
        while len(groups) < L.INNER_NODE_CHILDREN:
            # Mandatory: groups over the leaf limit. Otherwise, prefer the
            # costliest (area x count) group with more than one packet.
            cand, cand_priority = None, -np.inf
            for gi, g in enumerate(groups):
                if gi in unsplittable or len(g) <= L.LEAF_NODE_PACKET_SIZE:
                    continue
                bmin = g.bmin.min(axis=0)
                bmax = g.bmax.max(axis=0)
                pri = _surface_area(bmin, bmax) * len(g)
                if len(g) > self.leaf_max:
                    pri += np.inf
                if pri > cand_priority:
                    cand, cand_priority = gi, pri
            if cand is None:
                break
            split = self._split2(groups[cand])
            if split is None:
                unsplittable.add(cand)
                continue
            left, right = split
            groups[cand] = left
            groups.append(right)

        if len(groups) == 1:
            # All centroids coincide but the group exceeds the leaf limit:
            # round-robin into 8 (terminates since each part shrinks 8x).
            groups = [
                _Refs(
                    refs.ids[k :: L.INNER_NODE_CHILDREN],
                    refs.bmin[k :: L.INNER_NODE_CHILDREN],
                    refs.bmax[k :: L.INNER_NODE_CHILDREN],
                )
                for k in range(L.INNER_NODE_CHILDREN)
            ]
            groups = [g for g in groups if len(g)]
        return groups

    # -- nodes ---------------------------------------------------------------

    def build_recursive(self, refs: _Refs, depth: int) -> int:
        if len(refs) <= self.leaf_max:
            return self.build_leaf(refs, depth)

        groups = self._split8(refs)
        node_id = len(self.node_links)
        self.node_box_min.append(np.zeros((8, 3), np.float32))
        self.node_box_max.append(np.zeros((8, 3), np.float32))
        self.node_links.append(np.full(8, L.NULL_LINK, np.int32))

        for i, g in enumerate(groups):
            self.node_box_min[node_id][i] = g.bmin.min(axis=0)
            self.node_box_max[node_id][i] = g.bmax.max(axis=0)
            link = self.build_recursive(g, depth + 1)
            self.node_links[node_id][i] = link

        self.inner_fill.add_sample(len(groups))
        return L.new_inner(node_id)


def build_bvh(
    mesh: MeshData,
    materials: np.ndarray | None = None,
    leaf_max: int = L.LEAF_NODE_MAX_TRIANGLES,
    spatial_splits: bool = False,
) -> BuildResult:
    """Build the BVH over a mesh. ``materials`` is optional per-triangle
    int32 material ids (defaults to 0, matching ``building.rs:201``);
    ``leaf_max`` tunes the leaf size (<= 56). ``spatial_splits=True``
    enables SBVH reference splitting: large triangles straddling a split
    plane are clipped into both children (bounded duplication), shrinking
    child-box overlap — fewer node visits for incoherent rays at identical
    hit results (duplicated references are the same world-space triangle,
    so closest-hit/anyhit outcomes are unchanged).

    Measured (tools/sweep_sbvh.py, 249k-tri atrium, real bounce-k PT
    wavefronts on one v5e): +8% refs/VMEM, primary packets 17% faster,
    deep bounces only ~3% faster — the deep-bounce cost is the union of
    wide *direction* spreads per packet, which tighter leaf boxes barely
    dent — at ~600x the build time (pure-numpy clipping). Off by default;
    worth it only for reused scenes dominated by coherent rays. Spatially
    split trees cannot use the quantized layout (leaf frames no longer
    contain their full triangles; build_quantized_scene rejects them) and
    dedupe their light table (materials.build_light_table)."""
    T = mesh.triangle_count
    if materials is None:
        materials = np.zeros(T, np.int32)
    materials = np.asarray(materials, np.int32)
    assert materials.shape == (T,)

    tree = _Builder(
        mesh, materials, leaf_max=leaf_max, spatial_splits=spatial_splits
    )
    if T:
        used = mesh.positions[np.unique(mesh.triangles)]
        bbox_min = used.min(axis=0).astype(np.float32)
        bbox_max = used.max(axis=0).astype(np.float32)
        sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))
        root = tree.build_recursive(
            _Refs(
                np.arange(T, dtype=np.int64),
                tree.tri_min.copy(),
                tree.tri_max.copy(),
            ),
            depth=0,
        )
    else:
        bbox_min = np.zeros(3, np.float32)
        bbox_max = np.zeros(3, np.float32)
        root = L.NULL_LINK

    # Never leave zero-size arrays: keep one dummy element so device gathers
    # (which are clamped/masked anyway) stay in bounds.
    def _stack(items, dummy):
        return np.stack(items) if items else dummy[None]

    node_box_min = _stack(tree.node_box_min, np.zeros((8, 3), np.float32))
    node_box_max = _stack(tree.node_box_max, np.zeros((8, 3), np.float32))
    node_links = _stack(tree.node_links, np.full(8, L.NULL_LINK, np.int32))
    tri_packets = _stack(tree.packet_tris, np.zeros((8, 3, 3), np.float32))
    tri_vidx = _stack(tree.packet_vidx, np.zeros((8, 3), np.int32)).reshape(-1, 3)
    tri_flat = _stack(tree.packet_flat, np.zeros(8, bool)).reshape(-1)
    tri_material = _stack(tree.packet_material, np.zeros(8, np.int32)).reshape(-1)

    vert_normal = (
        mesh.normals.astype(np.float32)
        if mesh.normals.size
        else np.zeros((1, 3), np.float32)
    )
    vert_uv = (
        mesh.texcoords.astype(np.float32)
        if mesh.texcoords.size
        else np.zeros((1, 3), np.float32)
    )

    arrays = BvhArrays(
        node_child_box_min=node_box_min,
        node_child_box_max=node_box_max,
        node_child_links=node_links,
        tri_packets=tri_packets,
        tri_vidx=tri_vidx,
        tri_flat=tri_flat,
        tri_material=tri_material,
        vert_normal=vert_normal,
        vert_uv=vert_uv,
        root=np.int32(root),
        bbox_min=bbox_min,
        bbox_max=bbox_max,
    )
    return BuildResult(
        arrays=arrays,
        triangle_count=T,
        vertex_count=mesh.vertex_count,
        max_depth=tree.max_depth,
        leaf_depth=tree.leaf_depth,
        inner_fill=tree.inner_fill,
        leaf_fill=tree.leaf_fill,
    )
