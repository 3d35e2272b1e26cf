"""Multi-device rendering: the device mesh and what the renderers share to shard.

Port of ``minipath_tpu/parallel``. The JAX package shards a frame over a 1-D
``jax.sharding.Mesh`` with ``shard_map``; here a mesh is a tuple of
``torch.device`` and a shard is the work the host issues on one of them. A
renderer takes the mesh as an argument (``mesh=``; None renders on one
device, as one shard): each device takes a contiguous range of pixel
blocks, every shard's work is issued before anything is read back, and the
shards' results are gathered onto ``mesh[0]``. Scene arrays are replicated
once per *distinct* device: a device that the mesh lists twice holds one
copy, shared by its shards. A mesh may repeat a device; that is how the
tests shard on the CPU (torch has one CPU device, where XLA can be told to
show several) and how one card runs several shards.

:func:`frame_shards` and :func:`gather` serve the whole-frame renderers
(``render/frame.py::render_frame``, ``render/wavefront.py::render_frame_pt``),
which make each shard's camera rays on its own device; :func:`map_shards`
splits a batch made on ``mesh[0]`` (``render(mesh=)``'s tile integrator,
``parallel/mesh.py``'s portable engine).
"""

from __future__ import annotations

import torch

__all__ = ["frame_shards", "gather", "make_device_mesh", "map_shards", "replicate", "shard_generators", "shard_ranges"]


def make_device_mesh(n_devices: int | None = None, device="cuda") -> tuple[torch.device, ...]:
    """A mesh of ``n_devices`` devices of ``device``'s type: the first
    ``n_devices`` CUDA devices (all of them when None; raises ``ValueError``
    when fewer are present), or ``n_devices`` copies of the CPU device (one
    when None)."""
    kind = torch.device(device).type
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    if kind == "cpu":
        return (torch.device("cpu"),) * (n_devices or 1)
    if kind != "cuda":
        raise ValueError(f"no mesh of {kind} devices")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n < 1 or n > count:
        raise ValueError(f"{n} CUDA devices asked for, {count} available")
    return tuple(torch.device("cuda", i) for i in range(n))


def _canonical(device) -> torch.device:
    """``device`` with its index made explicit (``cuda`` -> ``cuda:N`` of
    the current device), so that two names of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _to(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        fields = [_to(x, device) for x in obj]
        return obj if all(a is b for a, b in zip(fields, obj)) else type(obj)(*fields)
    return obj


def replicate(obj, mesh) -> list:
    """``obj`` (a tensor, a NamedTuple of tensors and plain values, or a
    plain value) on every device of ``mesh``, as a list parallel to it: one
    copy per distinct device, shared by every shard on that device. On the
    device ``obj`` already lives on, the copy is ``obj`` itself."""
    copies = {}
    out = []
    for device in mesh:
        key = _canonical(device)
        if key not in copies:
            copies[key] = _to(obj, key)
        out.append(copies[key])
    return out


def shard_generators(generator: torch.Generator | None, mesh) -> list:
    """One generator per shard, each on its shard's device and seeded from
    one draw of ``generator`` (one host sync where it lives on a card): the
    counterpart of ``jax.random.fold_in(key, d)``. Nones where
    ``generator`` is None."""
    if generator is None:
        return [None] * len(mesh)
    seeds = torch.randint(0, 2**62, (len(mesh),), generator=generator, device=generator.device).tolist()
    return [torch.Generator(device=_canonical(d)).manual_seed(s) for d, s in zip(mesh, seeds)]


def shard_ranges(n_items: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous ``[lo, hi)`` ranges of ``ceil(n_items / n_shards)`` items,
    one per shard; the last ones are shorter, or empty where there are
    fewer items than shards. Nothing is padded: torch needs no equal
    shapes across shards, where ``shard_map`` does."""
    step = -(-n_items // n_shards)
    return [(min(d * step, n_items), min((d + 1) * step, n_items)) for d in range(n_shards)]


def map_shards(fn, batch, mesh, *replicas):
    """``fn(batch[lo:hi], *(r[d] for r in replicas))`` on each device
    ``mesh[d]`` over :func:`shard_ranges` of the leading axis of ``batch``
    (a tensor, or a NamedTuple of tensors sharing that axis); ``replicas``
    are lists parallel to the mesh (:func:`replicate`). Every shard is
    issued before any result is read; the results are concatenated on
    ``mesh[0]`` in shard order."""
    first = batch[0] if isinstance(batch, tuple) else batch
    parts = []
    for d, (lo, hi) in enumerate(shard_ranges(first.shape[0], len(mesh))):
        if lo == hi:
            continue
        if isinstance(batch, tuple):
            local = type(batch)(*(x[lo:hi].to(mesh[d]) for x in batch))
        else:
            local = batch[lo:hi].to(mesh[d])
        parts.append(fn(local, *(r[d] for r in replicas)))
    return torch.cat([p.to(mesh[0]) for p in parts])


def frame_shards(mesh, n_blocks: int, generator: torch.Generator | None, *objs) -> list[tuple]:
    """The shards of a frame of ``n_blocks`` pixel blocks, each ``(lo, hi,
    generator, replicas)``: the blocks ``[lo, hi)``, the generator the shard
    draws from and its copies of ``objs``. Without a mesh, one shard of
    every block on the caller's ``generator`` and ``objs`` themselves: no
    draw and no copy. Over ``mesh``: ``objs`` replicated once per distinct
    device (:func:`replicate`), then one generator per shard seeded from
    ``generator`` (:func:`shard_generators`, one draw), the blocks split by
    :func:`shard_ranges`, empty shards left out."""
    if mesh is None:
        return [(0, n_blocks, generator, objs)]
    copies = [replicate(obj, mesh) for obj in objs]
    gens = shard_generators(generator, mesh)
    return [
        (lo, hi, gens[d], tuple(c[d] for c in copies))
        for d, (lo, hi) in enumerate(shard_ranges(n_blocks, len(mesh)))
        if lo < hi
    ]


def gather(parts: list, mesh) -> torch.Tensor:
    """The shards' results concatenated in shard order on ``mesh[0]``;
    without a mesh, the one shard's result itself (no copy)."""
    return parts[0] if mesh is None else torch.cat([p.to(mesh[0]) for p in parts])
