"""minipath_tpu_torch — the minipath renderer on PyTorch and CUDA.

A port of the JAX/Pallas package ``minipath_tpu`` to PyTorch, with the
traversal kernels written by hand in CUDA C++ for NVIDIA Hopper
(``csrc/traverse.cu`` over the f32 layout, ``csrc/traverse_q.cu`` over the
16-bit quantized one). It keeps the JAX package's module layout and public
API: ``render``, ``RenderProgress``, ``RenderSettings``, ``Camera``,
``Scene``, ``TriangleBvh``, ``ScreenBlock``, and the path tracer
``render_frame_pt`` with its materials. Device code takes an explicit
``device``; random numbers come from ``torch.Generator``. Importing it never
imports JAX.

Ported so far: the parity render path (grayscale ``|d.n|`` shading, the
CLI's ``--integrator normal``), the wavefront path tracer (materials,
next-event estimation with MIS, roulette, compaction; ``--integrator pt``)
and the 16-bit quantized scene layout (``QuantizedScene``, ``QPTScene``),
which ``trace_scene`` and the path tracer's tracers dispatch to by type;
the post-process (``atrous_denoise`` with its guide buffers from
``render_aux``, the CLI's ``--denoise`` and ``--aov``), the analytic
``Sphere``, and the interactive viewer (``minipath_tpu_torch.gui``: the
tile-streaming ``GuiController`` and the progressive path-traced viewport);
multi-device rendering over a mesh of devices (``make_device_mesh``, and
the ``mesh=`` argument of ``render`` and ``render_frame_pt``; the CLI's
``--devices``) and adaptive
sampling (``render_frame_pt_adaptive``, the CLI's ``--adaptive``).
"""

from minipath_tpu_torch.camera import Camera, CameraSampler
from minipath_tpu_torch.parallel import make_device_mesh
from minipath_tpu_torch.render import RenderProgress, RenderSettings, render
from minipath_tpu_torch.render.adaptive import render_frame_pt_adaptive
from minipath_tpu_torch.render.denoise import atrous_denoise, render_aux
from minipath_tpu_torch.render.kernels_q import QPTScene, QuantizedScene, trace_scene
from minipath_tpu_torch.render.wavefront import (
    make_full_tracer,
    make_portable_shadow_tracer,
    make_portable_tracer,
    make_pt_shadow_tracer,
    make_pt_tracer,
    render_frame_pt,
)
from minipath_tpu_torch.scene import Scene
from minipath_tpu_torch.scene.materials import (
    Environment,
    build_light_table,
    dielectric,
    emissive,
    lambertian,
    material_table,
    metal,
)
from minipath_tpu_torch.scene.primitives import Sphere
from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh
from minipath_tpu_torch.screen_block import ScreenBlock

__all__ = [
    "Camera",
    "CameraSampler",
    "Environment",
    "QPTScene",
    "QuantizedScene",
    "RenderProgress",
    "RenderSettings",
    "Scene",
    "ScreenBlock",
    "Sphere",
    "TriangleBvh",
    "atrous_denoise",
    "build_light_table",
    "dielectric",
    "emissive",
    "lambertian",
    "make_device_mesh",
    "make_full_tracer",
    "make_portable_shadow_tracer",
    "make_portable_tracer",
    "make_pt_shadow_tracer",
    "make_pt_tracer",
    "material_table",
    "metal",
    "render",
    "render_aux",
    "render_frame_pt",
    "render_frame_pt_adaptive",
    "trace_scene",
]

__version__ = "0.1.0"
