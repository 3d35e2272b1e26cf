"""Wavefront OBJ loading.

Behavioral counterpart of the reference loader
(``minipath/src/scene/triangle_bvh/building.rs:28-81``): each distinct
``(position, texcoord, normal)`` index tuple becomes one deduplicated vertex,
normals are normalized on load, missing texcoords/normals default to
origin/zero (a zero normal later selects flat shading).

One deliberate improvement over the reference: polygons with more than three
vertices are fan-triangulated instead of silently skipped (the reference
loads ``cube.obj`` — all quads — as zero triangles, ``building.rs:43-46``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class ObjOpenError(Exception):
    """Raised when an OBJ file cannot be read or parsed
    (``building.rs:210-217``)."""


@dataclass
class MeshData:
    """Indexed triangle mesh with unified (deduplicated) vertices."""

    # (T, 3) int32 indices into the vertex arrays.
    triangles: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))
    positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    # (V, 3): (u, v, 0) texture coordinates.
    texcoords: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))

    @property
    def triangle_count(self) -> int:
        return int(self.triangles.shape[0])

    @property
    def vertex_count(self) -> int:
        return int(self.positions.shape[0])


def _parse_index(token: str, count: int) -> int | None:
    if not token:
        return None
    i = int(token)
    return i - 1 if i > 0 else count + i


def load_obj(path) -> MeshData:
    """Parse an OBJ file into a unified-vertex triangle mesh."""
    positions: list = []
    texcoords: list = []
    normals: list = []
    vertex_index: dict = {}
    out_pos: list = []
    out_tex: list = []
    out_normal: list = []
    triangles: list = []

    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            lines = f.readlines()
    except OSError as e:
        raise ObjOpenError(f"Failed to read file: {e}") from e

    def handle_vertex(token: str) -> int:
        parts = token.split("/")
        try:
            pi = _parse_index(parts[0], len(positions))
            ti = _parse_index(parts[1], len(texcoords)) if len(parts) > 1 else None
            ni = _parse_index(parts[2], len(normals)) if len(parts) > 2 else None
        except ValueError as e:
            raise ObjOpenError(f"Failed to parse face token {token!r}") from e
        tup = (pi, ti, ni)
        idx = vertex_index.get(tup)
        if idx is None:
            idx = len(out_pos)
            vertex_index[tup] = idx
            try:
                out_pos.append(positions[pi])
            except IndexError as e:
                raise ObjOpenError(f"Vertex index out of range: {token!r}") from e
            out_tex.append(texcoords[ti] if ti is not None else (0.0, 0.0, 0.0))
            if ni is not None:
                n = np.asarray(normals[ni], np.float64)
                norm = np.linalg.norm(n)
                out_normal.append(tuple(n / norm) if norm > 0 else (0.0, 0.0, 0.0))
            else:
                out_normal.append((0.0, 0.0, 0.0))
        return idx

    for lineno, raw in enumerate(lines, 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        fields = line.split()
        tag, args = fields[0], fields[1:]
        try:
            if tag == "v":
                positions.append(tuple(float(x) for x in args[:3]))
            elif tag == "vt":
                u = float(args[0])
                v = float(args[1]) if len(args) > 1 else 0.0
                texcoords.append((u, v, 0.0))
            elif tag == "vn":
                normals.append(tuple(float(x) for x in args[:3]))
            elif tag == "f":
                if len(args) < 3:
                    continue
                idxs = [handle_vertex(t) for t in args]
                # Fan triangulation (reference skips non-triangles instead).
                for k in range(1, len(idxs) - 1):
                    triangles.append((idxs[0], idxs[k], idxs[k + 1]))
        except ObjOpenError:
            raise
        except (ValueError, IndexError) as e:
            raise ObjOpenError(f"Failed to parse line {lineno}: {raw!r}") from e

    return MeshData(
        triangles=np.asarray(triangles, np.int32).reshape(-1, 3),
        positions=np.asarray(out_pos, np.float32).reshape(-1, 3),
        normals=np.asarray(out_normal, np.float32).reshape(-1, 3),
        texcoords=np.asarray(out_tex, np.float32).reshape(-1, 3),
    )


def save_obj(path, mesh: MeshData) -> None:
    """Write a MeshData as a Wavefront OBJ (v/vn/vt + unified-index faces).

    Inverse of :func:`load_obj` for round-tripping scenes through the real
    asset pipeline (benchmarks load their procedural stand-ins from disk so
    the OBJ path is what gets measured).
    """
    import io

    buf = io.StringIO()
    has_n = bool(mesh.normals.size)
    has_t = bool(mesh.texcoords.size)
    for p in mesh.positions:
        buf.write(f"v {p[0]:.7g} {p[1]:.7g} {p[2]:.7g}\n")
    if has_n:
        for n in mesh.normals:
            buf.write(f"vn {n[0]:.7g} {n[1]:.7g} {n[2]:.7g}\n")
    if has_t:
        for t in mesh.texcoords:
            buf.write(f"vt {t[0]:.7g} {t[1]:.7g}\n")
    for tri in mesh.triangles + 1:  # OBJ indices are 1-based
        if has_n and has_t:
            buf.write(f"f {tri[0]}/{tri[0]}/{tri[0]} {tri[1]}/{tri[1]}/{tri[1]} {tri[2]}/{tri[2]}/{tri[2]}\n")
        elif has_n:
            buf.write(f"f {tri[0]}//{tri[0]} {tri[1]}//{tri[1]} {tri[2]}//{tri[2]}\n")
        else:
            buf.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
    with open(path, "w") as f:
        f.write(buf.getvalue())
