"""The port's native (C++) loader and builder against the JAX package's, on
the CPU.

Both bind the same source, ``native/minipath_native.cpp`` and the port's
byte-identical copy of it, ``minipath_tpu_torch/csrc/minipath_native.cpp``
(each builds its own library), so on the same mesh their arrays are equal
bit for bit: no tolerance. Against the port's Python builder the trees may differ,
so the check there is the closest hit of the same rays: the same hits, the
same distances within 1e-5 relative and 1e-6 absolute, as
``tests/test_native.py`` holds the JAX package's native build. Every test
skips where ``g++`` is missing.
"""

import shutil

import numpy as np
import pytest
import torch

from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.bvh import native as jax_native
from minipath_tpu_torch import TriangleBvh
from minipath_tpu_torch.geometry.ray import make_rays
from minipath_tpu_torch.render import traversal as tt
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh import native
from minipath_tpu_torch.scene.obj_loader import ObjOpenError, load_obj, save_obj

OBJ_TEXT = (
    "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
    "vn 0 0 1\nvn 0 0 -1\n"
    "vt 0.5 0.25\n"
    "f 1/1/1 2/1/1 3/1/1\n"
    "f 2/1/1 4/1/2 3/1/1\n"
    "f 1 2 4 3\n"  # a quad, fan-triangulated, no vt/vn
)

MESHES = {
    "uv_sphere": lambda P: P.make_uv_sphere(1.0, rings=14, segments=22),
    "random_1500": lambda P: P.make_random_triangles(1500, seed=77),
    "atrium_3000": lambda P: P.make_atrium(3000),
}


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable (no g++)")
    assert native.is_available() and jax_native.is_available()


def _assert_same_mesh(got, want):
    for f in ("triangles", "positions", "normals", "texcoords"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f


def test_library_is_the_ports_own(gxx):
    native.build_bvh_native(procedural.make_cube())
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build" and path.parent.parent.name == "minipath_tpu_torch"


@pytest.mark.parametrize("source", ["text", "atrium_3000"])
def test_load_obj_native_equals_the_jax_packages(gxx, tmp_path, source):
    path = tmp_path / "m.obj"
    if source == "text":
        path.write_text(OBJ_TEXT)
    else:
        save_obj(path, procedural.make_atrium(3000))
    got = native.load_obj_native(path)
    _assert_same_mesh(got, jax_native.load_obj_native(path))
    assert got.triangle_count == load_obj(path).triangle_count


def test_load_obj_native_raises_on_a_missing_file(gxx, tmp_path):
    with pytest.raises(ObjOpenError):
        native.load_obj_native(tmp_path / "absent.obj")


@pytest.mark.parametrize("leaf_max", [56, 24])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_bvh_native_equals_the_jax_packages(gxx, name, leaf_max):
    """Array for array, bit for bit, with materials, and the same
    statistics."""
    mesh_t, mesh_j = MESHES[name](procedural), MESHES[name](jax_procedural)
    _assert_same_mesh(mesh_t, mesh_j)
    mats = np.arange(mesh_t.triangle_count, dtype=np.int32) % 5
    got = native.build_bvh_native(mesh_t, materials=mats, leaf_max=leaf_max)
    want = jax_native.build_bvh_native(mesh_j, materials=mats, leaf_max=leaf_max)
    for field in want.arrays._fields:
        a, b = np.asarray(getattr(got.arrays, field)), np.asarray(getattr(want.arrays, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field
    assert (got.triangle_count, got.vertex_count, got.max_depth) == (
        want.triangle_count, want.vertex_count, want.max_depth)
    assert got.recommended_stack_size == want.recommended_stack_size
    for stat in ("leaf_depth", "inner_fill", "leaf_fill"):
        assert str(getattr(got, stat)) == str(getattr(want, stat)), stat


def test_empty_mesh(gxx):
    from minipath_tpu_torch.scene.obj_loader import MeshData

    res = native.build_bvh_native(MeshData())
    assert res.triangle_count == 0 and res.arrays.tri_packets.shape == (1, 8, 3, 3)


@pytest.mark.parametrize("leaf_max", [None, 24])
def test_with_obj_native_traces_like_the_python_build(gxx, tmp_path, leaf_max):
    """``with_obj(use_native=True)`` against ``use_native=False`` on the same
    OBJ: trees may differ, the closest hits may not."""
    path = tmp_path / "atrium.obj"
    save_obj(path, procedural.make_atrium(3000))
    fast = TriangleBvh.with_obj(path, use_native=True, leaf_max=leaf_max)
    slow = TriangleBvh.with_obj(path, use_native=False, leaf_max=leaf_max)
    assert fast.build_result.triangle_count == slow.build_result.triangle_count > 0
    rng = np.random.default_rng(5)
    lo, hi = slow.get_bounding_box().min, slow.get_bounding_box().max
    origin = torch.from_numpy(rng.uniform(lo, hi, (4, 64, 3)).astype(np.float32))
    direction = torch.from_numpy(rng.normal(size=(4, 64, 3)).astype(np.float32))
    rays = make_rays(origin, direction)
    a = tt.trace_packets(fast.arrays("cpu"), rays, stack_size=fast.recommended_stack_size)
    b = tt.trace_packets(slow.arrays("cpu"), rays, stack_size=slow.recommended_stack_size)
    hits = b.tri >= 0
    assert 0.3 < hits.float().mean() and torch.equal(a.tri >= 0, hits)
    torch.testing.assert_close(a.t[hits], b.t[hits], rtol=1e-5, atol=1e-6)
    assert int(a.overflow) == int(b.overflow) == 0
    # The default takes the native path where it is available.
    default = TriangleBvh.with_obj(path, leaf_max=leaf_max)
    assert np.array_equal(default.host_arrays.node_child_links, fast.host_arrays.node_child_links)


def test_build_use_native_is_the_native_build(gxx):
    mesh = procedural.make_uv_sphere(rings=10, segments=16)
    got = TriangleBvh.build(mesh, use_native=True).host_arrays
    want = native.build_bvh_native(mesh).arrays
    assert all(np.array_equal(getattr(got, f), getattr(want, f)) for f in want._fields)
