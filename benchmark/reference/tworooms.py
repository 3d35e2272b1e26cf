"""The two-rooms scene: a frozen NumPy copy of the port's ``make_tworooms``.

``make_tworooms`` and ``tworooms_materials`` are copied from
``minipath_tpu_torch/scene/procedural.py`` as they stood when the cell was
defined, as ``atrium.py`` freezes the atrium: a dark room lit only through a
doorway by a recessed ceiling panel in the next room, inside a closed shell,
with sphere props up to the triangle budget. The mesh is returned as
``atrium.Mesh``; the harness hands the same arrays to the program and to
the reference.

This module imports NumPy only.
"""

from __future__ import annotations

import numpy as np

from .atrium import Mesh, _cube, _merge, _mesh, _uv_sphere


def _rect(p0, p1, p2, p3) -> Mesh:
    """Two triangles through four corners, in order."""
    return _mesh(np.array([p0, p1, p2, p3], np.float32), [(0, 1, 2), (0, 2, 3)])


def make_tworooms(target_triangles: int = 150_000, seed: int = 23) -> Mesh:
    """The shell x in [-12, 12], y in [0, 6], z in [-6, 6]; a divider at
    x = 0 with a doorway |z| < 1.2, y < 3; the emissive panel at y = 5.7,
    x in [6, 8], |z| < 0.75, skirted down to y = 5; sphere props in both
    rooms up to the budget, none in the doorway."""
    rng = np.random.default_rng(seed)
    shell = _cube(1.0)
    shell.positions[:] = shell.positions * np.array([24.0, 6.0, 12.0], np.float32)
    shell.positions[:, 1] += 3.0
    meshes = [shell]

    dz, dy = 1.2, 3.0
    meshes.append(_rect((0, 0, -6), (0, 0, -dz), (0, 6, -dz), (0, 6, -6)))
    meshes.append(_rect((0, 0, dz), (0, 0, 6), (0, 6, 6), (0, 6, dz)))
    meshes.append(_rect((0, dy, -dz), (0, dy, dz), (0, 6, dz), (0, 6, -dz)))

    px0, px1, pz, py, sy = 6.0, 8.0, 0.75, 5.7, 5.0
    meshes.append(_rect((px0, py, -pz), (px1, py, -pz), (px1, py, pz), (px0, py, pz)))
    for a, b in (
        ((px0, py, -pz), (px1, py, -pz)),
        ((px1, py, -pz), (px1, py, pz)),
        ((px1, py, pz), (px0, py, pz)),
        ((px0, py, pz), (px0, py, -pz)),
    ):
        meshes.append(_rect(a, b, (b[0], sy, b[2]), (a[0], sy, a[2])))

    base = _merge(meshes)
    budget = max(0, target_triangles - base.triangles.shape[0])
    tris_per_prop = 2 * 12 * 24 - 2 * 24
    props = []
    for _ in range(max(1, budget // tris_per_prop)):
        x = rng.uniform(-11, 11)
        if abs(x) < 1.0:
            x = np.sign(x) * 1.0
        center = np.array([x, rng.uniform(0.4, 2.5), rng.uniform(-5.2, 5.2)], np.float32)
        props.append(_uv_sphere(float(rng.uniform(0.2, 0.7)), center=center, rings=12, segments=24))
    return _merge([base] + props)


# The scene's materials, as plain parameters in ``atrium.MATERIALS``' form:
# (kind, albedo or color, fuzz, index of refraction, emission strength).
MATERIALS = (
    ("lambertian", (0.6, 0.58, 0.55), 0.0, 1.0, 0.0),  # 0 structure
    ("lambertian", (0.65, 0.3, 0.25), 0.0, 1.0, 0.0),  # 1
    ("metal", (0.8, 0.78, 0.7), 0.2, 1.0, 0.0),  # 2
    ("emissive", (1.0, 0.93, 0.8), 0.0, 1.0, 60.0),  # 3 the panel
)


def tworooms_materials(mesh: Mesh, seed: int = 29) -> np.ndarray:
    """Per-triangle material ids into :data:`MATERIALS`: the panel by its
    band of height (the skirt and the ceiling fall outside it), red diffuse
    and metal props, grey structure."""
    centroid = mesh.positions[mesh.triangles].mean(axis=1)
    mats = np.zeros(mesh.triangles.shape[0], np.int32)
    panel = (np.abs(centroid[:, 1] - 5.7) < 0.05) & (centroid[:, 0] > 5.5) & (np.abs(centroid[:, 2]) < 1.0)
    mats[panel] = 3
    rng = np.random.default_rng(seed)
    props = (centroid[:, 1] > 0.1) & (centroid[:, 1] < 3.5)
    mats[props] = rng.integers(1, 3, props.sum())
    return mats
