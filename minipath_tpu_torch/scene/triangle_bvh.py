"""The ``TriangleBvh`` renderable object.

Public surface mirrors the reference
(``minipath/src/scene/triangle_bvh/building.rs:28,83`` and ``printing.rs:11``):
``TriangleBvh.with_obj(path)``, ``TriangleBvh.build``, ``get_bounding_box``,
``statistics``/``print_statistics``. The host-side build
(``bvh/build.py``) does the heavy lifting; :meth:`TriangleBvh.kernel_scene`
and :meth:`TriangleBvh.pt_scene` lay the arrays out for the traversal
kernels on a chosen device.

Two layouts exist: f32 (K1, K2) and the 16-bit quantized one (K3, about
half the bytes). ``kernel_scene`` and ``pt_scene`` take the f32 layout unless
its bytes exceed :data:`SCENE_BUDGET_BYTES`, as the JAX package's
``TriangleBvh.pallas_scene`` does against its VMEM budget; the choice is
made from the array shapes, before either layout is built, and an error in
the chosen layout raises instead of falling back. ``quantized_scene`` and
``quantized_pt_scene`` ask for the quantized layout outright.
"""

from __future__ import annotations

import numpy as np
import torch

from minipath_tpu_torch.geometry.aabb import AABB
from minipath_tpu_torch.scene.bvh.build import BuildResult, BvhArrays, build_bvh
from minipath_tpu_torch.scene.obj_loader import MeshData, load_obj

# Bytes the f32 layout may take before the quantized one replaces it. None
# means half the card's device memory, and no limit on the CPU.
SCENE_BUDGET_BYTES: int | None = None


def scene_budget_bytes(device) -> int | None:
    """The bytes the f32 layout may take on ``device`` (see
    :data:`SCENE_BUDGET_BYTES`)."""
    device = torch.device(device)
    if SCENE_BUDGET_BYTES is not None:
        return SCENE_BUDGET_BYTES
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 2
    return None


class TriangleBvh:
    """Host handle owning the flat BVH arrays of a triangle mesh."""

    def __init__(self, build_result: BuildResult):
        self._build = build_result
        self._device_arrays: dict[torch.device, BvhArrays] = {}
        self._kernel_scenes: dict = {}
        self._pt_scenes: dict = {}
        self._quantized_scenes: dict = {}

    # -- constructors -----------------------------------------------------------

    @classmethod
    def with_obj(cls, path, use_native: bool | None = None, leaf_max: int | None = None) -> "TriangleBvh":
        """Load an OBJ file and build the BVH (``building.rs:28``).

        Loads and builds with the native C++ code (``scene/bvh/native.py``)
        where it is available, unless ``use_native=False``.
        """
        from minipath_tpu_torch.scene.bvh import native

        if use_native is None:
            use_native = native.is_available()
        mesh = native.load_obj_native(path) if use_native else load_obj(path)
        return cls.build(mesh, use_native=use_native, leaf_max=leaf_max)

    @classmethod
    def build(
        cls, mesh: MeshData, materials=None, use_native: bool | None = None, leaf_max: int | None = None
    ) -> "TriangleBvh":
        """Build the BVH of ``mesh``: with the Python builder (the reference)
        unless ``use_native=True`` asks for the C++ one."""
        from minipath_tpu_torch.scene.bvh import native

        kw = {} if leaf_max is None else {"leaf_max": leaf_max}
        if use_native:
            return cls(native.build_bvh_native(mesh, materials=materials, **kw))
        return cls(build_bvh(mesh, materials=materials, **kw))

    # -- data access ------------------------------------------------------------

    def arrays(self, device) -> BvhArrays:
        """The BVH arrays as torch tensors on ``device`` (cached)."""
        device = torch.device(device)
        if device not in self._device_arrays:
            self._device_arrays[device] = self._build.as_device(device)
        return self._device_arrays[device]

    def f32_scene_bytes(self, pt: bool = False) -> int:
        """Bytes of the f32 layout: node rows of 48 + 8 words and triangle
        rows of 80 words, plus K1's 72-word normal rows or, for the path
        tracer, the 8 x 20 f16 shading rows of each packet."""
        N = self._build.arrays.node_child_links.shape[0]
        M = self._build.arrays.tri_packets.shape[0]
        return N * (48 + 8) * 4 + M * (80 * 4 + (8 * 20 * 2 if pt else 72 * 4))

    def _quantized(self, device: torch.device, pt: bool) -> bool:
        budget = scene_budget_bytes(device)
        return budget is not None and self.f32_scene_bytes(pt) > budget

    def kernel_scene(self, device):
        """Closest-hit layout on ``device`` (cached): the f32
        ``KernelScene`` (``render/kernels.py::prepare_scene``), or the
        :meth:`quantized_scene` where the f32 one exceeds the budget."""
        from minipath_tpu_torch.render.kernels import prepare_scene

        device = torch.device(device)
        if self._quantized(device, pt=False):
            return self.quantized_scene(device)
        if device not in self._kernel_scenes:
            self._kernel_scenes[device] = prepare_scene(self.arrays(device))
        return self._kernel_scenes[device]

    def pt_scene(self, device):
        """Lean path-tracing layout on ``device`` (cached): the f32
        ``PTScene`` (``render/kernels.py::prepare_scene_pt``), or the
        :meth:`quantized_pt_scene` where the f32 one exceeds the budget.
        Material ids are checked before either is built."""
        from minipath_tpu_torch.render.kernels import check_material_ids, prepare_scene_pt

        device = torch.device(device)
        check_material_ids(self.arrays(device).tri_material)
        if self._quantized(device, pt=True):
            return self.quantized_pt_scene(device)
        if device not in self._pt_scenes:
            self._pt_scenes[device] = prepare_scene_pt(self.arrays(device))
        return self._pt_scenes[device]

    def quantized_scene(self, device):
        """The 16-bit quantized layout for K3 on ``device`` (cached; see
        ``render/kernels_q.py::prepare_scene_quantized``). A scene built with
        spatial splits, or with material ids above 65535, raises
        ``ValueError``."""
        from minipath_tpu_torch.render.kernels_q import prepare_scene_quantized

        device = torch.device(device)
        if device not in self._quantized_scenes:
            self._quantized_scenes[device] = prepare_scene_quantized(self.host_arrays, device)
        return self._quantized_scenes[device]

    def quantized_pt_scene(self, device):
        """The quantized lean path-tracing layout (``QPTScene``) on
        ``device``: :meth:`quantized_scene`'s rows plus the f16 shading
        table, which is built, and its material ids checked, first."""
        from minipath_tpu_torch.render.kernels import build_shade_flat
        from minipath_tpu_torch.render.kernels_q import QPTScene

        device = torch.device(device)
        key = (device, "pt")
        if key not in self._quantized_scenes:
            shade_flat = build_shade_flat(self.arrays(device))
            self._quantized_scenes[key] = QPTScene(*self.quantized_scene(device), shade_flat=shade_flat)
        return self._quantized_scenes[key]

    @property
    def host_arrays(self) -> BvhArrays:
        return self._build.arrays

    @property
    def build_result(self) -> BuildResult:
        return self._build

    @property
    def recommended_stack_size(self) -> int:
        return self._build.recommended_stack_size

    def intersect(self, rays, t_max=np.inf):
        """Closest hits of ``rays`` (``(B, P, 3)`` fields, on any device)
        through the portable engine (``render/traversal.py``), with the
        build's recommended stack."""
        from minipath_tpu_torch.render.traversal import intersect_bvh

        return intersect_bvh(
            self.arrays(rays.origin.device), rays, t_max=t_max, stack_size=self.recommended_stack_size
        )

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
