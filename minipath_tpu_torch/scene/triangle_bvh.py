"""The ``TriangleBvh`` renderable object.

Public surface mirrors the reference
(``minipath/src/scene/triangle_bvh/building.rs:28,83`` and ``printing.rs:11``):
``TriangleBvh.with_obj(path)``, ``TriangleBvh.build``, ``get_bounding_box``,
``statistics``/``print_statistics``. The host-side build
(``bvh/build.py``) does the heavy lifting; :meth:`TriangleBvh.kernel_scene`
and :meth:`TriangleBvh.pt_scene` lay the arrays out for the traversal
kernels on a chosen device. A card holds
the whole scene in its device memory, so there is one kernel layout (f32) and
no fallback between layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from minipath_tpu_torch.geometry.aabb import AABB
from minipath_tpu_torch.scene.bvh.build import BuildResult, BvhArrays, build_bvh
from minipath_tpu_torch.scene.obj_loader import MeshData, load_obj


class TriangleBvh:
    """Host handle owning the flat BVH arrays of a triangle mesh."""

    def __init__(self, build_result: BuildResult):
        self._build = build_result
        self._device_arrays: dict[torch.device, BvhArrays] = {}
        self._kernel_scenes: dict = {}
        self._pt_scenes: dict = {}

    # -- constructors -----------------------------------------------------------

    @classmethod
    def with_obj(cls, path, leaf_max: int | None = None) -> "TriangleBvh":
        """Load an OBJ file and build the BVH (``building.rs:28``)."""
        return cls.build(load_obj(path), leaf_max=leaf_max)

    @classmethod
    def build(cls, mesh: MeshData, materials=None, leaf_max: int | None = None) -> "TriangleBvh":
        kw = {} if leaf_max is None else {"leaf_max": leaf_max}
        return cls(build_bvh(mesh, materials=materials, **kw))

    # -- data access ------------------------------------------------------------

    def arrays(self, device) -> BvhArrays:
        """The BVH arrays as torch tensors on ``device`` (cached)."""
        device = torch.device(device)
        if device not in self._device_arrays:
            self._device_arrays[device] = self._build.as_device(device)
        return self._device_arrays[device]

    def kernel_scene(self, device):
        """Traversal-kernel layout on ``device`` (cached; see
        ``render/kernels.py::prepare_scene``)."""
        from minipath_tpu_torch.render.kernels import prepare_scene

        device = torch.device(device)
        if device not in self._kernel_scenes:
            self._kernel_scenes[device] = prepare_scene(self.arrays(device))
        return self._kernel_scenes[device]

    def pt_scene(self, device):
        """Lean path-tracing layout on ``device`` (cached; see
        ``render/kernels.py::prepare_scene_pt``). One layout, f32, with no
        fallback: material ids are checked before it is built."""
        from minipath_tpu_torch.render.kernels import prepare_scene_pt

        device = torch.device(device)
        if device not in self._pt_scenes:
            self._pt_scenes[device] = prepare_scene_pt(self.arrays(device))
        return self._pt_scenes[device]

    @property
    def host_arrays(self) -> BvhArrays:
        return self._build.arrays

    @property
    def build_result(self) -> BuildResult:
        return self._build

    @property
    def recommended_stack_size(self) -> int:
        return self._build.recommended_stack_size

    def get_bounding_box(self) -> AABB:
        return AABB(
            np.asarray(self._build.arrays.bbox_min),
            np.asarray(self._build.arrays.bbox_max),
        )

    # -- statistics (printing.rs:11-70) ---------------------------------------------

    def statistics(self) -> dict:
        b = self._build
        return {
            "triangles": b.triangle_count,
            "vertices": b.vertex_count,
            "inner_nodes": int(b.arrays.node_child_links.shape[0]),
            "triangle_packets": int(b.arrays.tri_packets.shape[0]),
            "max_depth": b.max_depth,
            "leaf_depth": str(b.leaf_depth),
            "inner_node_fill": str(b.inner_fill),
            "leaf_fill_triangles": str(b.leaf_fill),
        }

    def print_statistics(self) -> None:
        for k, v in self.statistics().items():
            print(f"  {k}: {v}")
