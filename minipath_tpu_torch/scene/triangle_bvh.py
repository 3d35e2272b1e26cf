"""The ``TriangleBvh`` renderable object.

Public surface mirrors the reference
(``minipath/src/scene/triangle_bvh/building.rs:28,83`` and ``printing.rs:11``):
``TriangleBvh.with_obj(path)``, ``TriangleBvh.build``, ``get_bounding_box``,
``statistics``/``print_statistics``. The host-side build
(``bvh/build.py``) does the heavy lifting; :meth:`TriangleBvh.kernel_scene`
and :meth:`TriangleBvh.pt_scene` lay the arrays out for the traversal
kernels on a chosen device.

Two layouts exist: f32 (K1, K2) and the 16-bit quantized one (K3, about
half the bytes: :meth:`TriangleBvh.f32_scene_bytes` and
:meth:`TriangleBvh.quantized_scene_bytes`). ``kernel_scene`` and
``pt_scene`` take the one that the tree's ``layout`` names (one of
:data:`LAYOUTS`, given when the tree is built: the CLI's and the GUI's
``--layout``). ``"q16"`` asks for the quantized layout outright;
``"auto"``, the default, takes the f32 layout unless its bytes exceed
:data:`SCENE_BUDGET_BYTES`, as the JAX package's ``TriangleBvh.pallas_scene``
does against its VMEM budget. The choice is made from the array shapes,
before either layout is built, and an error in the chosen layout raises
instead of falling back: a ``"q16"`` tree built with spatial splits, or with
material ids above 65535, raises ``ValueError``. ``quantized_scene`` and
``quantized_pt_scene`` build the quantized layout whatever the choice, from
the host arrays: a quantized scene holds no f32 copy of the tree on its
device.
"""

from __future__ import annotations

import numpy as np
import torch

from minipath_tpu_torch.geometry.aabb import AABB
from minipath_tpu_torch.scene.bvh.build import BuildResult, BvhArrays, build_bvh
from minipath_tpu_torch.scene.obj_loader import MeshData, load_obj
from minipath_tpu_torch.utils.profiling import count, span

# Bytes the f32 layout may take before the quantized one replaces it. None
# means half the card's device memory, and no limit on the CPU.
SCENE_BUDGET_BYTES: int | None = None

# The layouts a caller may ask for (TriangleBvh.layout): the f32 one unless
# it exceeds the budget, or the 16-bit quantized one.
LAYOUTS = ("auto", "q16")

# The fields of BvhArrays that the shading table's build reads
# (render/kernels.py::build_shade_flat).
_SHADE_FIELDS = ("tri_packets", "tri_vidx", "tri_flat", "tri_material", "vert_normal", "vert_uv")


def _checked_layout(layout: str) -> str:
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: expected one of {LAYOUTS}")
    return layout


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

    def __init__(self, build_result: BuildResult, layout: str = "auto"):
        self._build = build_result
        # The layout kernel_scene and pt_scene take, one of LAYOUTS.
        self.layout = _checked_layout(layout)
        self._device_arrays: dict[torch.device, BvhArrays] = {}
        self._kernel_scenes: dict = {}
        self._pt_scenes: dict = {}
        self._quantized_scenes: dict = {}

    # -- constructors -----------------------------------------------------------

    @classmethod
    def with_obj(
        cls, path, use_native: bool | None = None, leaf_max: int | None = None, layout: str = "auto"
    ) -> "TriangleBvh":
        """Load an OBJ file and build the BVH (``building.rs:28``).

        Loads and builds with the native C++ code (``scene/bvh/native.py``)
        where it is available, unless ``use_native=False``.
        """
        from minipath_tpu_torch.scene.bvh import native

        if use_native is None:
            use_native = native.is_available()
        mesh = native.load_obj_native(path) if use_native else load_obj(path)
        return cls.build(mesh, use_native=use_native, leaf_max=leaf_max, layout=layout)

    @classmethod
    def build(
        cls,
        mesh: MeshData,
        materials=None,
        use_native: bool | None = None,
        leaf_max: int | None = None,
        layout: str = "auto",
    ) -> "TriangleBvh":
        """Build the BVH of ``mesh``: with the Python builder (the reference)
        unless ``use_native=True`` asks for the C++ one. ``layout`` is one of
        :data:`LAYOUTS`, checked before the build."""
        from minipath_tpu_torch.scene.bvh import native

        _checked_layout(layout)
        kw = {} if leaf_max is None else {"leaf_max": leaf_max}
        if use_native:
            return cls(native.build_bvh_native(mesh, materials=materials, **kw), layout)
        return cls(build_bvh(mesh, materials=materials, **kw), layout)

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

    def quantized_scene_bytes(self, pt: bool = False) -> int:
        """Bytes of the quantized layout: node rows of 32 words and their
        ``node_frame`` rows of 8, triangle rows of 64 words, plus, for the
        path tracer, the 8 x 20 f16 shading rows of each packet."""
        N = self._build.arrays.node_child_links.shape[0]
        M = self._build.arrays.tri_packets.shape[0]
        return N * (32 + 8) * 4 + M * (64 * 4 + (8 * 20 * 2 if pt else 0))

    def _quantized(self, device: torch.device, pt: bool) -> bool:
        if self.layout == "q16":
            return True
        budget = scene_budget_bytes(device)
        return budget is not None and self.f32_scene_bytes(pt) > budget

    def kernel_scene(self, device):
        """Closest-hit layout on ``device`` (cached): the f32
        ``KernelScene`` (``render/kernels.py::prepare_scene``), or the
        :meth:`quantized_scene` where ``layout`` asks for it (``"q16"``, or
        ``"auto"`` with the f32 one over the budget)."""
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
        :meth:`quantized_pt_scene` where ``layout`` asks for it, as in
        :meth:`kernel_scene`. Material ids are checked on the host before
        either is built, so that nothing reaches ``device`` before the
        layout is chosen."""
        from minipath_tpu_torch.render.kernels import check_material_ids, prepare_scene_pt

        device = torch.device(device)
        check_material_ids(torch.as_tensor(self.host_arrays.tri_material))
        if self._quantized(device, pt=True):
            return self.quantized_pt_scene(device)
        if device not in self._pt_scenes:
            self._pt_scenes[device] = prepare_scene_pt(self.arrays(device))
        return self._pt_scenes[device]

    def quantized_scene(self, device):
        """The 16-bit quantized layout for K3 on ``device`` (cached; see
        ``render/kernels_q.py::prepare_scene_quantized``). A scene built with
        spatial splits, or with material ids above 65535, raises
        ``ValueError``. While tracing is on (``utils/profiling.py``), the
        build and upload is the span ``scene.quantize`` and its bytes the
        counter ``scene.q16_bytes``."""
        from minipath_tpu_torch.render.kernels_q import prepare_scene_quantized

        device = torch.device(device)
        if device not in self._quantized_scenes:
            with span("scene.quantize"):
                scene = prepare_scene_quantized(self.host_arrays, device)
            words = (scene.node_q, scene.tri_q, scene.node_frame, scene.root_box)
            count("scene.q16_bytes", sum(t.nbytes for t in words))
            self._quantized_scenes[device] = scene
        return self._quantized_scenes[device]

    def quantized_pt_scene(self, device):
        """The quantized lean path-tracing layout (``QPTScene``) on
        ``device``: :meth:`quantized_scene`'s rows plus the f16 shading
        table, which is built, and its material ids checked, first. The
        table is built on ``device`` from the fields it reads alone,
        uploaded from the host arrays and dropped after it: the f32 arrays
        (:meth:`arrays`) stay off the device."""
        from minipath_tpu_torch.render.kernels import build_shade_flat
        from minipath_tpu_torch.render.kernels_q import QPTScene

        device = torch.device(device)
        key = (device, "pt")
        if key not in self._quantized_scenes:
            host = self.host_arrays
            fields = {name: torch.from_numpy(np.array(getattr(host, name), copy=True)).to(device)
                      if name in _SHADE_FIELDS else None for name in BvhArrays._fields}
            shade_flat = build_shade_flat(BvhArrays(**fields))
            del fields  # off the device before the quantized rows go up
            self._quantized_scenes[key] = QPTScene(**self.quantized_scene(device)._asdict(), shade_flat=shade_flat)
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
