"""The port's copy of the 16-bit quantizer against the JAX package's.

The quantizer is NumPy on both sides, so its words are held bit for bit:
``node_q``, ``tri_q``, ``root`` and ``root_box`` from each package's own
BVH build and mesh, ``decompress_scene`` and ``root_frame``. The port's torch
decompression (``render/kernels_q.py::decompressed_kernel_scene``, the
plain K3's rows) equals NumPy's ``decompress_scene`` bit for bit too: both
take the same separately rounded float32 steps.
"""

import numpy as np
import pytest
import torch

from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.bvh import quantize as jq
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu_torch.render import kernels_q
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh import links as L
from minipath_tpu_torch.scene.bvh import quantize as tq
from minipath_tpu_torch.scene.bvh.build import build_bvh
from minipath_tpu_torch.scene.obj_loader import MeshData

_SCENES = {
    "atrium_0": lambda P: (P.make_atrium(0), None),
    "atrium_20000": lambda P: (P.make_atrium(20000), None),
    "random_700": lambda P: (P.make_random_triangles(700, seed=13), None),
    "uv_sphere": lambda P: (P.make_uv_sphere(1.0, rings=14, segments=22), None),
    "materials_50000": lambda P: (
        P.make_random_triangles(300, seed=3),
        np.random.default_rng(5).integers(0, 50000, 300).astype(np.int32),
    ),
}


@pytest.fixture(scope="module", params=sorted(_SCENES))
def quantized(request):
    """``(jax words, port words, port host arrays)`` of one scene, each
    package building from its own mesh."""
    jmesh, mats = _SCENES[request.param](jax_procedural)
    tmesh, _ = _SCENES[request.param](procedural)
    jres, tres = jax_build_bvh(jmesh, materials=mats), build_bvh(tmesh, materials=mats)
    return jq.build_quantized_scene(jres.arrays), tq.build_quantized_scene(tres.arrays), tres.arrays


def test_words_are_bit_exact(quantized):
    want, got, _ = quantized
    for name in want._fields:
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


def test_decompress_scene_is_bit_exact(quantized):
    want, got, _ = quantized
    for a, b in zip(jq.decompress_scene(want), tq.decompress_scene(got)):
        assert np.array_equal(a, b)


def test_root_frame_equals_the_stored_box(quantized):
    """The kernel seeds its root entry with the stored ``root_box``; the
    quantizer encodes the root's children against ``root_frame(root_box)``.
    The two must be the same float32 box."""
    _, got, _ = quantized
    np.testing.assert_array_equal(tq.root_frame(got.root_box), got.root_box.reshape(6))


def test_torch_decompression_equals_numpy(quantized):
    """The plain K3's rows: child boxes of every valid child, vertices (as
    v0 and the edges the kernel subtracts), the u16 materials and the i8
    normals times 1/127."""
    _, got, arrays = quantized
    rows = kernels_q.decompressed_kernel_scene(kernels_q.quantized_scene_from_numpy(got._asdict(), "cpu"))
    dmin, dmax, verts, _ = tq.decompress_scene(got)
    valid = arrays.node_child_links != L.NULL_LINK
    box = rows.node_box.numpy().reshape(-1, 8, 6)
    np.testing.assert_array_equal(box[..., 0:3][valid], dmin[valid])
    np.testing.assert_array_equal(box[..., 3:6][valid], dmax[valid])
    tri = rows.tri_data.numpy()
    v0 = verts[:, :, 0]
    np.testing.assert_array_equal(tri[:, :72].reshape(-1, 8, 9), np.concatenate(
        [v0, verts[:, :, 1] - v0, verts[:, :, 2] - v0], axis=-1))
    np.testing.assert_array_equal(tri[:, 72:].reshape(-1), np.asarray(arrays.tri_material, np.float32))
    q8 = (got.tri_q[:, 40:58].astype(np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.uint8).view(np.int8)
    np.testing.assert_array_equal(rows.tri_shade.numpy(), q8.astype(np.float32) * np.float32(1.0 / 127.0))
    assert rows.root == int(got.root[0, 0])


def test_spatial_splits_and_wide_material_ids_raise():
    """A soup over two huge floor triangles: spatial splits clip the floor
    into leaves whose boxes no longer hold its vertices."""
    floor = MeshData(
        triangles=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        positions=np.float32([[-12, -1, -12], [12, -1, -12], [12, -1, 12], [-12, -1, 12]]),
        normals=np.zeros((4, 3), np.float32),
    )
    mesh = procedural.merge_meshes([procedural.make_random_triangles(600, seed=5), floor])
    with pytest.raises(ValueError, match="spatial splits"):
        tq.build_quantized_scene(build_bvh(mesh, leaf_max=24, spatial_splits=True).arrays)
    mats = np.zeros(mesh.triangle_count, np.int32)
    mats[7] = 65536
    with pytest.raises(ValueError, match="65536 material ids"):
        tq.build_quantized_scene(build_bvh(mesh, materials=mats).arrays)


def test_empty_scene():
    want = jq.build_quantized_scene(jax_build_bvh(MeshData()).arrays)
    got = tq.build_quantized_scene(build_bvh(MeshData()).arrays)
    for name in want._fields:
        assert np.array_equal(getattr(want, name), getattr(got, name)), name
    assert int(got.root[0, 0]) == L.NULL_LINK
    scene = kernels_q.quantized_scene_from_numpy(got._asdict(), "cpu")
    assert scene.root == L.NULL_LINK and scene.root_box.shape == (6,)
    rows = kernels_q.decompressed_kernel_scene(scene)
    assert rows.node_box.shape[1] == 48 and torch.all(rows.tri_data == 0)
