"""Procedural mesh generation for tests and benchmarks.

The reference ships binary assets (teapot.obj, the Sponza submodule — which
is not even checked out, ``minipath/.gitmodules:1-3``); this repo
generates geometry instead. :func:`make_atrium` builds a Sponza-stand-in:
a colonnaded atrium with ~any requested triangle budget, BVH-heavy and
interior-lit like the Sponza benchmark scene in BASELINE.json.
"""

from __future__ import annotations

import numpy as np

from minipath_tpu_torch.scene.obj_loader import MeshData


def _mesh_from_soup(verts: np.ndarray, faces: np.ndarray, normals=None) -> MeshData:
    """Build MeshData from positions + faces; smooth normals optional."""
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    if normals is None:
        normals = np.zeros_like(verts)  # zero normal => flat shading
    return MeshData(
        triangles=faces,
        positions=verts,
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        texcoords=np.zeros_like(verts),
    )


def make_quad(size: float = 1.0, z: float = 0.0) -> MeshData:
    s = size / 2
    verts = [(-s, -s, z), (s, -s, z), (s, s, z), (-s, s, z)]
    faces = [(0, 1, 2), (0, 2, 3)]
    return _mesh_from_soup(verts, faces)


def make_cube(size: float = 1.0, center=(0.0, 0.0, 0.0)) -> MeshData:
    """Axis-aligned cube, 12 triangles, flat shaded (like the reference's
    cube.obj — which the reference fails to load since it is quads)."""
    s = size / 2
    c = np.asarray(center, np.float32)
    corners = np.array(
        [
            [-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
            [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s],
        ],
        np.float32,
    ) + c
    quads = [
        (0, 1, 2, 3), (4, 5, 6, 7), (0, 4, 7, 3),
        (1, 5, 6, 2), (3, 2, 6, 7), (0, 1, 5, 4),
    ]
    faces = []
    for (a, b, cc, d) in quads:
        faces += [(a, b, cc), (a, cc, d)]
    return _mesh_from_soup(corners, faces)


def make_uv_sphere(radius: float = 1.0, center=(0.0, 0.0, 0.0), rings: int = 16, segments: int = 32) -> MeshData:
    """UV sphere with smooth vertex normals."""
    center = np.asarray(center, np.float32)
    verts, normals = [], []
    for i in range(rings + 1):
        theta = np.pi * i / rings
        for j in range(segments):
            phi = 2 * np.pi * j / segments
            n = np.array(
                [np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)],
                np.float32,
            )
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
    return _mesh_from_soup(np.array(verts), faces, normals=np.array(normals))


def make_random_triangles(n: int, seed: int = 0, extent: float = 10.0, tri_size: float = 0.5) -> MeshData:
    """Random triangle soup — stress geometry for oracle tests."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n, 1, 3))
    offsets = rng.normal(0.0, tri_size, (n, 3, 3))
    verts = (centers + offsets).astype(np.float32).reshape(-1, 3)
    faces = np.arange(3 * n, dtype=np.int32).reshape(-1, 3)
    return _mesh_from_soup(verts, faces)


def make_tie_lattice(n: int = 3) -> MeshData:
    """Exact ties, for the traversal's tie rules: ``n x n x 2`` unit cubes
    that touch face to face, over a floor, with every triangle in the mesh
    twice. Sibling boxes then repeat or share faces, so that a ray along an
    axis enters several children at one distance, and every hit has a
    coplanar duplicate at the same ``t``."""
    cubes = [make_cube(1.0, (x, y, z)) for x in range(n) for y in range(n) for z in range(2)]
    once = merge_meshes(cubes + [make_quad(2.0 * n + 2.0, -0.5)])
    return merge_meshes([once, once])


def tie_lattice_rays(n: int = 3, count: int = 2048, seed: int = 0):
    """``(origins, directions)``, ``(count, 3)`` float32 each, for
    :func:`make_tie_lattice`: half of them parallel to an axis from origins
    on a quarter-unit grid (the ties), half at random."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.0, n, (count, 3)).astype(np.float32)
    d = rng.normal(size=(count, 3)).astype(np.float32)
    axis = np.arange(count) % 2 == 0
    o[axis] = np.round(o[axis] * 4.0) / 4.0
    d[axis] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, int(axis.sum()))] * rng.choice(
        np.array([-1.0, 1.0], np.float32), (int(axis.sum()), 1))
    return o, d


def merge_meshes(meshes) -> MeshData:
    tris, pos, nor, tex = [], [], [], []
    offset = 0
    for m in meshes:
        tris.append(m.triangles + offset)
        pos.append(m.positions)
        nor.append(m.normals)
        tex.append(m.texcoords)
        offset += m.vertex_count
    return MeshData(
        triangles=np.concatenate(tris),
        positions=np.concatenate(pos),
        normals=np.concatenate(nor),
        texcoords=np.concatenate(tex),
    )


def transform_mesh(mesh: MeshData, scale=1.0, rotate_y: float = 0.0, translate=(0, 0, 0)) -> MeshData:
    c, s = np.cos(rotate_y), np.sin(rotate_y)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    pos = (mesh.positions * scale) @ rot.T + np.asarray(translate, np.float32)
    nor = mesh.normals @ rot.T
    return MeshData(
        triangles=mesh.triangles.copy(),
        positions=pos.astype(np.float32),
        normals=nor.astype(np.float32),
        texcoords=mesh.texcoords.copy(),
    )


def make_atrium(target_triangles: int = 250_000, seed: int = 7) -> MeshData:
    """Sponza-stand-in benchmark scene: a colonnaded atrium.

    Floor + walls, two rows of columns (high-res cylinders via uv spheres
    stretched), and scattered high-poly spheres until the triangle budget is
    met. BVH-heavy: deep spatial subdivision, high occlusion.
    """
    rng = np.random.default_rng(seed)
    meshes = []

    # Hall: floor, ceiling, side walls (interior-facing cube shell).
    hall = transform_mesh(make_cube(1.0), scale=1.0)
    hall.positions *= np.array([40.0, 15.0, 20.0], np.float32)
    hall.positions[:, 1] += 7.5
    meshes.append(hall)

    # Column rows.
    ncols = 12
    for i in range(ncols):
        x = -18.0 + 36.0 * i / (ncols - 1)
        for zside in (-6.0, 6.0):
            col = make_uv_sphere(1.0, rings=12, segments=24)
            col.positions = col.positions * np.array([1.0, 7.0, 1.0], np.float32)
            col.positions += np.array([x, 7.0, zside], np.float32)
            meshes.append(col)

    base = merge_meshes(meshes)
    budget = max(0, target_triangles - base.triangle_count)

    # Fill the remaining budget with scattered high-poly spheres ("props").
    props = []
    tris_per_prop = 2 * 14 * 28 - 2 * 28  # uv sphere rings=14 segments=28
    n_props = max(1, budget // tris_per_prop)
    for _ in range(n_props):
        center = np.array(
            [rng.uniform(-18, 18), rng.uniform(0.5, 3.0), rng.uniform(-8, 8)],
            np.float32,
        )
        radius = float(rng.uniform(0.2, 0.9))
        props.append(make_uv_sphere(radius, center=center, rings=14, segments=28))
    return merge_meshes([base] + props)


def atrium_materials(mesh: MeshData, seed: int = 11):
    """Benchmark material assignment for :func:`make_atrium`: diffuse
    structure, metal / glass / red-diffuse props by height band, emissive
    ceiling panels. Returns ``(per-triangle material ids, material dict
    list)``; feed the list to
    ``minipath_tpu_torch.scene.materials.material_table``."""
    from minipath_tpu_torch.scene.materials import dielectric, emissive, lambertian, metal

    tri_y = mesh.positions[mesh.triangles][:, :, 1].mean(axis=1)
    rng = np.random.default_rng(seed)
    mats = np.zeros(mesh.triangle_count, np.int32)
    mats[tri_y > 10.0] = 4  # ceiling emissive panels
    props = (tri_y > 0.1) & (tri_y < 4.0)
    mats[props] = rng.integers(1, 4, props.sum())
    dicts = [
        lambertian((0.65, 0.62, 0.58)),  # 0 structure
        lambertian((0.7, 0.3, 0.25)),  # 1
        metal((0.85, 0.8, 0.7), 0.15),  # 2
        dielectric(1.5),  # 3
        emissive((1.0, 0.95, 0.85), 4.0),  # 4
    ]
    return mats, dicts


def _rect(p0, p1, p2, p3) -> MeshData:
    """Two-triangle rectangle through four corners (in order)."""
    return _mesh_from_soup(
        np.array([p0, p1, p2, p3], np.float32), [(0, 1, 2), (0, 2, 3)]
    )


def make_tworooms(target_triangles: int = 150_000, seed: int = 23) -> MeshData:
    """Hard-light-topology benchmark scene: a dark room lit only through a
    doorway from an adjacent room whose single emitter is a small RECESSED
    ceiling fixture (panel + occluding skirt).

    The counterpart to :func:`make_atrium` for next-event-estimation
    studies: in the atrium the emitters are large ceiling panels directly
    visible from most first-bounce vertices, so capping NEE at depth 1
    loses almost nothing. Here a first-bounce vertex in the camera room can
    essentially never see the fixture (the skirt blocks every shallow
    sightline through the doorway), so light arrives only via multi-bounce
    transport through the door — the topology where deep light sampling
    earns its keep.

    Geometry: outer shell x in [-12,12], y in [0,6], z in [-6,6]; divider
    wall at x=0 with a doorway |z|<1.2, y<3; emissive panel at y=5.7,
    x in [6,8], |z|<0.75, skirted down to y=5.0 around its perimeter.
    Prop spheres fill the triangle budget in both rooms.
    """
    rng = np.random.default_rng(seed)
    meshes = []

    shell = make_cube(1.0)
    shell.positions *= np.array([24.0, 6.0, 12.0], np.float32)
    shell.positions[:, 1] += 3.0
    meshes.append(shell)

    # Divider wall at x=0 (zero thickness; intersection is two-sided) with
    # a doorway hole z in [-1.2, 1.2], y in [0, 3].
    dz, dy = 1.2, 3.0
    meshes.append(_rect((0, 0, -6), (0, 0, -dz), (0, 6, -dz), (0, 6, -6)))
    meshes.append(_rect((0, 0, dz), (0, 0, 6), (0, 6, 6), (0, 6, dz)))
    meshes.append(_rect((0, dy, -dz), (0, dy, dz), (0, 6, dz), (0, 6, -dz)))

    # Recessed fixture in the lit room: downward panel + 0.7-deep skirt.
    px0, px1, pz, py, sy = 6.0, 8.0, 0.75, 5.7, 5.0
    meshes.append(_rect((px0, py, -pz), (px1, py, -pz), (px1, py, pz), (px0, py, pz)))
    for (a, b) in (
        ((px0, py, -pz), (px1, py, -pz)),
        ((px1, py, -pz), (px1, py, pz)),
        ((px1, py, pz), (px0, py, pz)),
        ((px0, py, pz), (px0, py, -pz)),
    ):
        meshes.append(_rect(a, b, (b[0], sy, b[2]), (a[0], sy, a[2])))

    base = merge_meshes(meshes)
    budget = max(0, target_triangles - base.triangle_count)
    tris_per_prop = 2 * 12 * 24 - 2 * 24
    n_props = max(1, budget // tris_per_prop)
    props = []
    for _ in range(n_props):
        x = rng.uniform(-11, 11)
        if abs(x) < 1.0:
            x = np.sign(x) * 1.0  # keep the doorway clear
        center = np.array(
            [x, rng.uniform(0.4, 2.5), rng.uniform(-5.2, 5.2)], np.float32
        )
        props.append(
            make_uv_sphere(float(rng.uniform(0.2, 0.7)), center=center,
                           rings=12, segments=24)
        )
    return merge_meshes([base] + props)


def tworooms_materials(mesh: MeshData, seed: int = 29):
    """Material assignment for :func:`make_tworooms`: grey diffuse
    structure, mixed diffuse props, one small bright emissive panel
    (identified by the fixture's y-band — the skirt and ceiling fall
    outside it). Same return contract as :func:`atrium_materials`."""
    from minipath_tpu_torch.scene.materials import emissive, lambertian, metal

    centroid = mesh.positions[mesh.triangles].mean(axis=1)
    mats = np.zeros(mesh.triangle_count, np.int32)
    panel = (
        (np.abs(centroid[:, 1] - 5.7) < 0.05)
        & (centroid[:, 0] > 5.5)
        & (np.abs(centroid[:, 2]) < 1.0)
    )
    mats[panel] = 3
    rng = np.random.default_rng(seed)
    props = (centroid[:, 1] > 0.1) & (centroid[:, 1] < 3.5)
    mats[props] = rng.integers(1, 3, props.sum())
    dicts = [
        lambertian((0.6, 0.58, 0.55)),  # 0 structure
        lambertian((0.65, 0.3, 0.25)),  # 1
        metal((0.8, 0.78, 0.7), 0.2),  # 2
        # Small area, high radiance: the whole scene's light budget
        # through ~3 m^2 of recessed panel.
        emissive((1.0, 0.93, 0.8), 60.0),  # 3
    ]
    return mats, dicts
