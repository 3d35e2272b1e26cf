"""Two-level binned traversal over K2's per-packet roots.

Port of ``minipath_tpu/render/twolevel.py``. Traversal runs in two phases:

1. **Broad phase (torch ops):** every live ray is slab-tested against the
   ``T`` top-level "treelet" boxes (the BVH frontier at a fixed depth), a
   dense ``(N, T)`` pass in chunks of 64 treelets that keeps each ray's
   ``K`` nearest treelets, ordered near-to-far by entry distance.
2. **Narrow phase (K2 with ``roots=``):** rays are re-bucketed by treelet
   (then direction octant, then origin Morton cell), packets are formed
   bucket-aligned, and each packet traverses only its treelet, its root
   handed to K2 per packet (``render/kernels.py::trace_packets_pt``).

Rays visit their treelets near-to-far in ``rounds`` rounds and drop out as
soon as their best hit is closer than the next treelet's entry distance;
rays that intersect more than ``K`` treelets, or want more treelets than the
rounds give, finish in one last pass from the whole tree's root. Every
(ray, subtree) pair is either traced in some round or provably occluded, so
the hits are the flat trace's, up to exact ties between triangles of two
treelets.

The reference measured the module a dead end on a TPU v5e, whose packets pay
for the union of their rays' traversals; it stays there as the user of the
kernel's per-packet roots. K2 on the card runs one thread per ray, so the
packet union that treelets shrink does not exist there, and what the module
adds is the broad phase, the sort and the scatters around each round. Most
of the roots it produces are leaves: ``build_treelets`` keeps a leaf met
above the cut as a treelet of its own.

What differs from the reference, each for the card:

- A round's trace always launches, the leftover round included: branching
  on whether any ray is left would cost a host sync. With no ray to trace
  the launch reads ``live_packets == 0`` from device memory and writes
  misses.
- The per-round counters are summed and returned (``overflow``,
  ``inner_visits``, ``leaf_tests``: one-element totals over every round,
  not per caller packet), where the reference drops them.
- Rays are packed ``(B, 9, P)`` for K2, not the TPU's ``(B, 9, P/128,
  128)``.

Nothing in a trace synchronises with the host: the counts, offsets and
packet roots of a round stay on the device. The profiler sees a trace's
parts as ``twolevel.broad_phase``, and per round ``twolevel.plan`` (the
sort, the bucket offsets and the ray gather), ``twolevel.trace`` (K2) and
``twolevel.merge`` (the scatter back and the nearer-hit update); then
``twolevel.shade``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from minipath_tpu_torch.render.kernels import KernelHits, PTScene, trace_packets_pt
from minipath_tpu_torch.render.wavefront import _pack_rays9, shade_from_flat
from minipath_tpu_torch.scene.bvh import links as L
from minipath_tpu_torch.scene.bvh.build import BvhArrays
from minipath_tpu_torch.utils.profiling import span

# Treelets slab-tested at once in the broad phase: the running top-K merge
# never holds more than an (N, CHUNK + K) buffer.
CHUNK = 64
_BIG = 1e30  # 1/d clamp, as in the kernels


class Treelets(NamedTuple):
    """Top-level BVH frontier: ``T`` subtree roots with their world boxes.

    ``links[t]`` is the encoded node link of treelet ``t``'s root (an inner
    node or a leaf); ``root_link`` is the whole tree's root (the fallback
    bucket)."""

    links: torch.Tensor  # (T,) i32 encoded links
    box_min: torch.Tensor  # (T, 3) f32
    box_max: torch.Tensor  # (T, 3) f32
    root_link: torch.Tensor  # () i32


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_treelets(arrays: BvhArrays, levels: int = 2, device="cuda") -> Treelets:
    """Host-side walk of the top ``levels`` of the BVH; the result on
    ``device``.

    Inner links expand into their children; leaf links met above the cut
    stay as their own (tiny) treelets. ``levels=2`` on an 8-ary tree gives
    up to 64 treelets.
    """
    links = _host(arrays.node_child_links)
    bmin = _host(arrays.node_child_box_min)
    bmax = _host(arrays.node_child_box_max)
    root = int(_host(arrays.root))
    frontier = [(root, _host(arrays.bbox_min), _host(arrays.bbox_max))]
    for _ in range(levels):
        nxt = []
        for link, lo, hi in frontier:
            if L.is_inner(link):
                idx = L.decode_index(link)
                for c in range(L.INNER_NODE_CHILDREN):
                    cl = int(links[idx, c])
                    if cl != L.NULL_LINK:
                        nxt.append((cl, bmin[idx, c], bmax[idx, c]))
            else:
                nxt.append((link, lo, hi))
        frontier = nxt
    return Treelets(
        links=torch.tensor([f[0] for f in frontier], dtype=torch.int32, device=device),
        box_min=torch.from_numpy(np.stack([f[1] for f in frontier]).astype(np.float32)).to(device),
        box_max=torch.from_numpy(np.stack([f[2] for f in frontier]).astype(np.float32)).to(device),
        root_link=torch.tensor(root, dtype=torch.int32, device=device),
    )


def _broad_chunk(box_min, box_max, origin, inv, live_mask):
    """Slab entry distances of every ray against one treelet chunk: returns
    ``(entry, hit)`` of shape ``(N, Tc)``, accumulated axis by axis so that
    nothing wider than ``(N, Tc)`` is made."""
    t_entry = torch.zeros((origin.shape[0], box_min.shape[0]), dtype=torch.float32, device=origin.device)
    t_exit = torch.full_like(t_entry, torch.inf)
    for ax in range(3):
        t0 = (box_min[None, :, ax] - origin[:, ax, None]) * inv[:, ax, None]
        t1 = (box_max[None, :, ax] - origin[:, ax, None]) * inv[:, ax, None]
        t_entry = torch.maximum(t_entry, torch.minimum(t0, t1))
        t_exit = torch.minimum(t_exit, torch.maximum(t0, t1))
    hit = (t_entry <= t_exit) & live_mask[:, None]
    return torch.where(hit, t_entry, torch.full_like(t_entry, torch.inf)), hit


def _nearest(entry: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of the ``k`` smallest entries of each row, nearest
    first, equal entries in column order (``jax.lax.top_k``'s order): a
    stable sort, which ``torch.topk`` is not. Adding 0.0 turns -0.0 into
    0.0 first, since the card's radix sort orders the two apart."""
    return torch.sort(entry + 0.0, dim=1, stable=True).indices[:, :k]


def broad_phase(tl: Treelets, origin, direction, inv_direction, live_mask, K: int):
    """Dense ray-vs-treelet slab test; returns each ray's ``K`` nearest
    treelets as ``(tid, entry, valid, overflow)``: ``tid`` ``(N, K)`` i32
    treelet ids ordered by entry distance, ``entry`` their entry-t (+inf on
    dead slots), ``valid`` the slot mask, ``overflow`` the rays that
    intersect more than ``K`` treelets (they fall back to a trace from the
    whole tree's root).

    Treelets go in chunks of :data:`CHUNK` with a running top-K merge: the
    running best first, then the new chunk, so that a tie resolves to the
    lower treelet id, as in the reference."""
    if K < 1:
        raise ValueError(f"K must be at least 1, got {K}")
    dev = origin.device
    inv = inv_direction.clamp(-_BIG, _BIG)  # NaN-free like the kernels
    box_min, box_max = tl.box_min.to(dev), tl.box_max.to(dev)
    T = int(box_min.shape[0])
    N = origin.shape[0]
    best_entry = best_tid = None
    count = torch.zeros((N,), dtype=torch.int32, device=dev)
    for c0 in range(0, T, CHUNK):
        c1 = min(T, c0 + CHUNK)
        entry, hit = _broad_chunk(box_min[c0:c1], box_max[c0:c1], origin, inv, live_mask)
        count = count + hit.sum(dim=-1, dtype=torch.int32)
        tid = torch.arange(c0, c1, dtype=torch.int32, device=dev).expand(N, -1)
        if best_entry is not None:
            entry = torch.cat([best_entry, entry], dim=1)
            tid = torch.cat([best_tid, tid], dim=1)
        pos = _nearest(entry, min(K, entry.shape[1]))
        best_entry = torch.gather(entry, 1, pos)
        best_tid = torch.gather(tid, 1, pos)
    if best_entry.shape[1] < K:  # fewer treelets than K slots
        pad = K - best_entry.shape[1]
        best_entry = torch.nn.functional.pad(best_entry, (0, pad), value=torch.inf)
        best_tid = torch.nn.functional.pad(best_tid, (0, pad))
    valid = torch.isfinite(best_entry)
    return best_tid, best_entry, valid, count > K


def _octant(d):
    return (
        (d[:, 0] > 0).to(torch.int32) * 4
        + (d[:, 1] > 0).to(torch.int32) * 2
        + (d[:, 2] > 0).to(torch.int32)
    )


def _morton12(o, live):
    """12-bit Morton code of each origin's cell in a 16^3 grid over the live
    origins' bounding box."""
    safe = torch.where(live[:, None], o, torch.zeros_like(o))
    lo = torch.where(live[:, None], safe, torch.full_like(safe, torch.inf)).amin(dim=0)
    hi = torch.where(live[:, None], safe, torch.full_like(safe, -torch.inf)).amax(dim=0)
    scale = 16.0 / torch.clamp(hi - lo, min=1e-6)
    cell = torch.clamp((safe - lo) * scale, 0, 15).to(torch.int32)
    out = torch.zeros_like(cell[:, 0])
    for b in range(4):
        for ax in range(3):
            out = out | (((cell[:, ax] >> b) & 1) << (3 * b + (2 - ax)))
    return out


class _RoundPlan(NamedTuple):
    """Bucket-aligned packet assignment for one narrow-phase round."""

    ray_slot: torch.Tensor  # (C,) i64 ray index per capacity lane, N = parked
    roots: torch.Tensor  # (C // P,) i32 per-packet root link (NULL = dead)
    live_packets: torch.Tensor  # () i64 on the device


def _plan_round(tid, need, origin, direction, links_table, *, n_buckets: int, packet_size: int) -> _RoundPlan:
    """Assign the rays that need this round to bucket-aligned packet lanes.

    Buckets are treelet ids (0..n_buckets-1); rays sort stably by (need,
    bucket, direction octant, origin Morton cell); each bucket's run is
    padded to whole packets so that a packet never spans two roots. The
    capacity is ``(ceil(N / P) + n_buckets) * P`` lanes, every bucket's run
    padded to a whole packet at worst."""
    N = tid.shape[0]
    P = packet_size
    dev = tid.device
    key = (tid << 15) | (_octant(direction) << 12) | _morton12(origin, need)
    key = torch.where(need, key, torch.full_like(key, 1 << 29))
    order = torch.argsort(key, stable=True)
    tid_s = tid[order].long()
    need_s = need[order]
    # Per-bucket counts by a scatter-add (torch.bincount would sync).
    counts = torch.zeros(n_buckets, dtype=torch.int64, device=dev).scatter_add_(
        0, torch.where(need, tid, torch.zeros_like(tid)).long(), need.long()
    )
    aligned = (counts + P - 1) // P * P
    starts = torch.cumsum(counts, 0) - counts
    ends_aligned = torch.cumsum(aligned, 0)
    astarts = ends_aligned - aligned
    total_aligned = ends_aligned[-1]
    C = (-(-N // P) + n_buckets) * P
    rank = torch.arange(N, device=dev) - starts[tid_s]
    dest = torch.where(need_s, astarts[tid_s] + rank, torch.full_like(rank, C))
    # Lanes no ray takes stay parked at N; the rays not needed land in the
    # extra slot C, which is cut off.
    ray_slot = torch.full((C + 1,), N, dtype=torch.int64, device=dev).scatter_(0, dest, order)[:C]
    # Per-packet roots: the bucket whose aligned run covers the packet.
    pstart = torch.arange(C // P, device=dev) * P
    bucket = torch.searchsorted(ends_aligned, pstart, right=True).clamp(0, n_buckets - 1)
    roots = torch.where(pstart < total_aligned, links_table[bucket], torch.full_like(bucket, L.NULL_LINK))
    return _RoundPlan(ray_slot=ray_slot, roots=roots.to(torch.int32), live_packets=total_aligned // P)


def _gather_rays(plan: _RoundPlan, origin, direction, inv_direction):
    """Capacity-lane ray arrays; parked lanes (origin 1e9, direction and
    inverse 1) miss at any root."""
    N = origin.shape[0]
    slot = torch.clamp(plan.ray_slot, max=N - 1)
    parked = (plan.ray_slot >= N)[:, None]
    o = torch.where(parked, torch.full_like(origin[slot], 1e9), origin[slot])
    d = torch.where(parked, torch.ones_like(direction[slot]), direction[slot])
    inv = torch.where(parked, torch.ones_like(inv_direction[slot]), inv_direction[slot])
    return o, d, inv


def _scatter_back(ray_slot, values, fill, N):
    """``values`` of the capacity lanes back at their rays' index; rays no
    lane holds get ``fill``, and parked lanes (slot N) are cut off."""
    out = torch.full((N + 1,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_(0, ray_slot, values)[:N]


def _check_scene(scene) -> None:
    if not isinstance(scene, PTScene):
        raise TypeError(
            f"the two-level tracer takes a PTScene (K2's f32 layout), got {type(scene).__name__}"
        )


def make_pt_tracer_twolevel(
    scene: PTScene,
    treelets: Treelets,
    *,
    stack_size: int,
    packet_size: int = 2048,
    K: int = 8,
    rounds: int = 2,
):
    """Two-level tracer with the ``make_pt_tracer`` contract, over K2.

    Returns ``(tracer, scene)``; ``tracer(scene, origin, direction,
    inv_direction, live=None) -> KernelHits`` over ``(N, 3)`` rays. ``live``
    is None (all rays), a live-ray count (an int or a one-element device
    tensor: a live prefix, as the compaction loop passes it) or a bool mask;
    rays are re-bucketed every round, so callers need no coherence sort.

    ``rounds`` treelet-rooted rounds run near-to-far; rays needing more
    treelets (or more than ``K``) finish in one exact pass from the whole
    tree's root. Each trace launches K2 closest-hit ``rounds + 1`` times.
    The returned ``overflow``, ``inner_visits`` and ``leaf_tests`` are
    one-element totals over all rounds and rays, not per caller packet.

    Only the f32 layout (:class:`PTScene`) is taken, as in the reference; a
    ``QPTScene`` raises ``TypeError``.
    """
    _check_scene(scene)
    if rounds > K:
        raise ValueError(f"rounds ({rounds}) cannot exceed K ({K})")
    T = int(treelets.links.shape[0])
    links_table = torch.cat([treelets.links, treelets.root_link.reshape(1)])
    n_buckets = T + 1  # bucket T = the whole tree's root (overflow and leftover rays)

    def tracer(state: PTScene, origin, direction, inv_direction, live=None) -> KernelHits:
        _check_scene(state)
        N = origin.shape[0]
        dev = origin.device
        if live is None:
            live_mask = torch.ones((N,), dtype=torch.bool, device=dev)
        elif isinstance(live, torch.Tensor) and live.dtype == torch.bool:
            live_mask = live
        else:
            live_mask = torch.arange(N, device=dev) < live
        table = links_table.to(dev)
        with span("twolevel.broad_phase"):
            tid, entry_k, valid, overflow = broad_phase(treelets, origin, direction, inv_direction, live_mask, K)

        best_t = torch.full((N,), torch.inf, dtype=torch.float32, device=dev)
        best_tri = torch.full((N,), -1, dtype=torch.int32, device=dev)
        best_u = torch.zeros((N,), dtype=torch.float32, device=dev)
        best_v = torch.zeros((N,), dtype=torch.float32, device=dev)
        counters = torch.zeros((3,), dtype=torch.int64, device=dev)

        def run_round(r_tid, need):
            nonlocal best_t, best_tri, best_u, best_v, counters
            with span("twolevel.plan"):
                plan = _plan_round(r_tid, need, origin, direction, table, n_buckets=n_buckets,
                                   packet_size=packet_size)
                r9, _, C = _pack_rays9(packet_size, None, *_gather_rays(plan, origin, direction, inv_direction))
            with span("twolevel.trace"):
                ph = trace_packets_pt(
                    state, r9, stack_size=stack_size, live_packets=plan.live_packets, roots=plan.roots
                )
            with span("twolevel.merge"):
                tri_c = ph.tri.reshape(C)
                t_c = torch.where(tri_c >= 0, ph.t.reshape(C), torch.full_like(ph.t.reshape(C), torch.inf))
                rs = plan.ray_slot
                t_r = _scatter_back(rs, t_c, torch.inf, N)
                win = t_r < best_t
                best_t = torch.where(win, t_r, best_t)
                best_tri = torch.where(win, _scatter_back(rs, tri_c, -1, N), best_tri)
                best_u = torch.where(win, _scatter_back(rs, ph.u.reshape(C), 0.0, N), best_u)
                best_v = torch.where(win, _scatter_back(rs, ph.v.reshape(C), 0.0, N), best_v)
                counters = counters + torch.stack([ph.overflow.sum(), ph.inner_visits.sum(), ph.leaf_tests.sum()])

        for r in range(rounds):
            # A ray still needs round r if the slot exists, it is not an
            # overflow ray, and its best hit is not already closer than the
            # treelet's entry (front-to-back early out).
            run_round(tid[:, r], valid[:, r] & ~overflow & (best_t >= entry_k[:, r]))
        # Leftovers: overflow rays, and rays with unvisited slots beyond the
        # round budget that are not yet provably occluded. The round always
        # launches; with no ray left it traces no packet.
        leftover = overflow & live_mask
        if rounds < K:
            leftover = leftover | (valid[:, rounds] & (best_t >= entry_k[:, rounds]))
        run_round(torch.full((N,), T, dtype=torch.int32, device=dev), leftover)

        # Shading gather, as make_pt_tracer's epilogue.
        with span("twolevel.shade"):
            normal, material, tex = shade_from_flat(state.shade_flat, best_tri, best_u, best_v)
        return KernelHits(
            t=torch.where(best_tri >= 0, best_t, torch.full_like(best_t, torch.inf)),
            tri=best_tri,
            normal=normal,
            material=material,
            overflow=counters[0:1],
            inner_visits=counters[1:2],
            leaf_tests=counters[2:3],
            texture_coords=tex,
        )

    tracer.accepts_mask = True
    return tracer, scene
