"""The benchmark's scene: a frozen NumPy copy of the port's procedural atrium.

``make_atrium`` and ``atrium_materials`` are copied from
``minipath_tpu_torch/scene/procedural.py`` as they stood when the benchmark
was defined, so that the scene is the deployment's data, fixed like a
published data set: a later change to the program's generator does not move
it. The mesh is returned as plain arrays; the harness hands the same arrays
to the program and to the reference.

This module imports NumPy only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Mesh(NamedTuple):
    triangles: np.ndarray  # (T, 3) int32
    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray  # (V, 3) float32, zero rows for flat-shaded vertices
    texcoords: np.ndarray  # (V, 3) float32


def _mesh(verts, faces, normals=None) -> Mesh:
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    if normals is None:
        normals = np.zeros_like(verts)
    return Mesh(faces, verts, np.asarray(normals, np.float32).reshape(-1, 3), np.zeros_like(verts))


def _cube(size: float = 1.0) -> Mesh:
    s = size / 2
    corners = np.array(
        [[-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s], [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]],
        np.float32,
    )
    quads = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 4, 7, 3), (1, 5, 6, 2), (3, 2, 6, 7), (0, 1, 5, 4)]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    return _mesh(corners, faces)


def _uv_sphere(radius=1.0, center=(0.0, 0.0, 0.0), rings=16, segments=32) -> Mesh:
    center = np.asarray(center, np.float32)
    verts, normals = [], []
    for i in range(rings + 1):
        theta = np.pi * i / rings
        for j in range(segments):
            phi = 2 * np.pi * j / segments
            n = np.array([np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)], np.float32)
            verts.append(center + radius * n)
            normals.append(n)
    faces = []
    for i in range(rings):
        for j in range(segments):
            a = i * segments + j
            b = i * segments + (j + 1) % segments
            c = (i + 1) * segments + j
            d = (i + 1) * segments + (j + 1) % segments
            if i > 0:
                faces.append((a, b, c))
            if i < rings - 1:
                faces.append((b, d, c))
    return _mesh(np.array(verts), faces, normals=np.array(normals))


def _merge(meshes) -> Mesh:
    tris, offset = [], 0
    for m in meshes:
        tris.append(m.triangles + offset)
        offset += m.positions.shape[0]
    return Mesh(
        np.concatenate(tris),
        np.concatenate([m.positions for m in meshes]),
        np.concatenate([m.normals for m in meshes]),
        np.concatenate([m.texcoords for m in meshes]),
    )


def make_atrium(target_triangles: int = 250_000, seed: int = 7) -> Mesh:
    """A colonnaded atrium: an inward cube shell, two rows of stretched
    sphere columns, and scattered high-poly spheres up to the budget."""
    rng = np.random.default_rng(seed)
    hall = _cube(1.0)
    hall.positions[:] = hall.positions * np.array([40.0, 15.0, 20.0], np.float32)
    hall.positions[:, 1] += 7.5
    meshes = [hall]
    ncols = 12
    for i in range(ncols):
        x = -18.0 + 36.0 * i / (ncols - 1)
        for zside in (-6.0, 6.0):
            col = _uv_sphere(1.0, rings=12, segments=24)
            pos = col.positions * np.array([1.0, 7.0, 1.0], np.float32)
            pos += np.array([x, 7.0, zside], np.float32)
            meshes.append(col._replace(positions=pos))
    base = _merge(meshes)
    budget = max(0, target_triangles - base.triangles.shape[0])
    tris_per_prop = 2 * 14 * 28 - 2 * 28
    props = []
    for _ in range(max(1, budget // tris_per_prop)):
        center = np.array([rng.uniform(-18, 18), rng.uniform(0.5, 3.0), rng.uniform(-8, 8)], np.float32)
        radius = float(rng.uniform(0.2, 0.9))
        props.append(_uv_sphere(radius, center=center, rings=14, segments=28))
    return _merge([base] + props)


# The benchmark's materials, as plain parameters: (kind, albedo or color,
# fuzz, index of refraction, emission strength).
MATERIALS = (
    ("lambertian", (0.65, 0.62, 0.58), 0.0, 1.0, 0.0),  # 0 structure
    ("lambertian", (0.7, 0.3, 0.25), 0.0, 1.0, 0.0),  # 1
    ("metal", (0.85, 0.8, 0.7), 0.15, 1.0, 0.0),  # 2
    ("dielectric", (1.0, 1.0, 1.0), 0.0, 1.5, 0.0),  # 3
    ("emissive", (1.0, 0.95, 0.85), 0.0, 1.0, 4.0),  # 4
)


def atrium_materials(mesh: Mesh, seed: int = 11) -> np.ndarray:
    """Per-triangle material ids into :data:`MATERIALS`: emissive ceiling
    panels, metal, glass and red diffuse props by height band."""
    tri_y = mesh.positions[mesh.triangles][:, :, 1].mean(axis=1)
    rng = np.random.default_rng(seed)
    mats = np.zeros(mesh.triangles.shape[0], np.int32)
    mats[tri_y > 10.0] = 4
    props = (tri_y > 0.1) & (tri_y < 4.0)
    mats[props] = rng.integers(1, 4, props.sum())
    return mats
