"""ctypes bindings for the native (C++) OBJ loader and BVH builder.

Port of ``minipath_tpu/scene/bvh/native.py``. It binds the repository's
``native/minipath_native.cpp`` as it is: the source has no framework
dependency, and its arrays follow the layout of ``scene/bvh/build.py``, so
:func:`build_bvh_native` returns the port's :class:`BuildResult` and
:func:`load_obj_native` its :class:`MeshData`.

The library is compiled with ``g++`` at first use into
``minipath_tpu_torch/_build/``, keyed on a hash of the source and the flags
as ``utils/cuda_build.py`` keys the CUDA libraries. :func:`is_available` says
whether a compiler and the source are present; a build that then fails
raises instead of falling back to the Python builder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from minipath_tpu_torch.scene.bvh.build import BuildResult, BvhArrays, compute_tree_stats
from minipath_tpu_torch.scene.obj_loader import MeshData, ObjOpenError

_SOURCE = Path(__file__).resolve().parents[3] / "native" / "minipath_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


class _MpBvh(ctypes.Structure):
    _fields_ = [
        ("node_links", ctypes.POINTER(ctypes.c_int32)),
        ("node_box_min", ctypes.POINTER(ctypes.c_float)),
        ("node_box_max", ctypes.POINTER(ctypes.c_float)),
        ("tri_packets", ctypes.POINTER(ctypes.c_float)),
        ("tri_vidx", ctypes.POINTER(ctypes.c_int32)),
        ("tri_flat", ctypes.POINTER(ctypes.c_uint8)),
        ("tri_material", ctypes.POINTER(ctypes.c_int32)),
        ("n_nodes", ctypes.c_int64),
        ("n_packets", ctypes.c_int64),
        ("root", ctypes.c_int32),
        ("max_depth", ctypes.c_int32),
        ("bbox_min", ctypes.c_float * 3),
        ("bbox_max", ctypes.c_float * 3),
    ]


class _MpMesh(ctypes.Structure):
    _fields_ = [
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("texcoords", ctypes.POINTER(ctypes.c_float)),
        ("tris", ctypes.POINTER(ctypes.c_int32)),
        ("n_verts", ctypes.c_int64),
        ("n_tris", ctypes.c_int64),
    ]


def is_available() -> bool:
    """True where the C++ source and ``g++`` are present."""
    return _SOURCE.exists() and shutil.which("g++") is not None


def library_path() -> Path:
    """Where the build of the current source goes."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libminipath_native-{digest}.so"


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not is_available():
            raise RuntimeError(f"the native builder needs g++ and {_SOURCE}")
        out = library_path()
        if not out.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                ["g++", *_FLAGS, str(_SOURCE), "-o", str(tmp)], capture_output=True, text=True, timeout=300
            )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {_SOURCE.name} (exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.mp_build_bvh.restype = ctypes.c_int
        lib.mp_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(_MpBvh),
        ]
        lib.mp_free_bvh.argtypes = [ctypes.POINTER(_MpBvh)]
        lib.mp_load_obj.restype = ctypes.c_int
        lib.mp_load_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(_MpMesh)]
        lib.mp_free_mesh.argtypes = [ctypes.POINTER(_MpMesh)]
        _lib = lib
        return _lib


def _as_np(ptr, shape, dtype):
    n = int(np.prod(shape))
    if n == 0:
        return np.zeros(shape, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True).reshape(shape)


def load_obj_native(path) -> MeshData:
    """Native OBJ load; returns a :class:`MeshData` or raises
    :class:`ObjOpenError`."""
    lib = _load()
    mesh = _MpMesh()
    rc = lib.mp_load_obj(os.fspath(path).encode(), ctypes.byref(mesh))
    if rc != 0:
        raise ObjOpenError(f"native OBJ load failed (code {rc}): {path}")
    try:
        V, T = int(mesh.n_verts), int(mesh.n_tris)
        return MeshData(
            triangles=_as_np(mesh.tris, (T, 3), np.int32),
            positions=_as_np(mesh.positions, (V, 3), np.float32),
            normals=_as_np(mesh.normals, (V, 3), np.float32),
            texcoords=_as_np(mesh.texcoords, (V, 3), np.float32),
        )
    finally:
        lib.mp_free_mesh(ctypes.byref(mesh))


def build_bvh_native(mesh: MeshData, materials=None, leaf_max: int = 56) -> BuildResult:
    """Native BVH build; returns a :class:`BuildResult` in the layout of
    ``scene/bvh/build.py``. The C++ builder reports only ``max_depth``; the other
    statistics come from a walk of the arrays (``compute_tree_stats``)."""
    lib = _load()
    positions = np.ascontiguousarray(mesh.positions, np.float32)
    tris = np.ascontiguousarray(mesh.triangles, np.int32)
    normals = np.ascontiguousarray(mesh.normals, np.float32) if mesh.normals.size else None
    mats = np.ascontiguousarray(materials, np.int32) if materials is not None else None

    def ptr(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype)) if a is not None else None

    out = _MpBvh()
    rc = lib.mp_build_bvh(
        ptr(positions, ctypes.c_float), ptr(normals, ctypes.c_float), mesh.vertex_count,
        ptr(tris, ctypes.c_int32), ptr(mats, ctypes.c_int32), mesh.triangle_count, leaf_max, ctypes.byref(out),
    )
    if rc != 0:
        raise RuntimeError(f"native BVH build failed (code {rc})")
    try:
        depth = int(out.max_depth)
        N, M = int(out.n_nodes), int(out.n_packets)
        nodes, packets = N > 0, M > 0
        N, M = max(N, 1), max(M, 1)
        arrays = BvhArrays(
            node_child_box_min=_as_np(out.node_box_min, (N, 8, 3), np.float32) if nodes
            else np.zeros((1, 8, 3), np.float32),
            node_child_box_max=_as_np(out.node_box_max, (N, 8, 3), np.float32) if nodes
            else np.zeros((1, 8, 3), np.float32),
            node_child_links=_as_np(out.node_links, (N, 8), np.int32) if nodes else np.full((1, 8), -8, np.int32),
            tri_packets=_as_np(out.tri_packets, (M, 8, 9), np.float32).reshape(M, 8, 3, 3) if packets
            else np.zeros((1, 8, 3, 3), np.float32),
            tri_vidx=_as_np(out.tri_vidx, (M * 8, 3), np.int32) if packets else np.zeros((8, 3), np.int32),
            tri_flat=_as_np(out.tri_flat, (M * 8,), np.uint8).astype(bool) if packets else np.zeros(8, bool),
            tri_material=_as_np(out.tri_material, (M * 8,), np.int32) if packets else np.zeros(8, np.int32),
            vert_normal=mesh.normals.astype(np.float32) if mesh.normals.size else np.zeros((1, 3), np.float32),
            vert_uv=mesh.texcoords.astype(np.float32) if mesh.texcoords.size else np.zeros((1, 3), np.float32),
            root=np.int32(out.root),
            # Copies: np.asarray would view the struct, which mp_free_bvh
            # zeroes below.
            bbox_min=np.array(out.bbox_min, np.float32, copy=True),
            bbox_max=np.array(out.bbox_max, np.float32, copy=True),
        )
    finally:
        lib.mp_free_bvh(ctypes.byref(out))
    walk_depth, leaf_depth, inner_fill, leaf_fill = compute_tree_stats(arrays)
    return BuildResult(
        arrays=arrays,
        triangle_count=mesh.triangle_count,
        vertex_count=mesh.vertex_count,
        max_depth=max(depth, walk_depth),
        leaf_depth=leaf_depth,
        inner_fill=inner_fill,
        leaf_fill=leaf_fill,
    )
