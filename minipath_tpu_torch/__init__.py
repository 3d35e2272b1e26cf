"""minipath_tpu_torch — the minipath renderer on PyTorch and CUDA.

A port of the JAX/Pallas package ``minipath_tpu`` to PyTorch, with the
traversal kernel written by hand in CUDA C++ for NVIDIA Hopper
(``csrc/traverse.cu``). It keeps the JAX package's module layout and public
API: ``render``, ``RenderProgress``, ``RenderSettings``, ``Camera``,
``Scene``, ``TriangleBvh``, ``ScreenBlock``. Device code takes an explicit
``device``; random numbers come from ``torch.Generator``. Importing it never
imports JAX.

What is ported so far is the parity render path (grayscale ``|d.n|``
shading, the CLI's ``--integrator normal``); the path tracer waits.
"""

from minipath_tpu_torch.camera import Camera, CameraSampler
from minipath_tpu_torch.render import RenderProgress, RenderSettings, render
from minipath_tpu_torch.scene import Scene
from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh
from minipath_tpu_torch.screen_block import ScreenBlock

__all__ = [
    "Camera",
    "CameraSampler",
    "RenderProgress",
    "RenderSettings",
    "Scene",
    "ScreenBlock",
    "TriangleBvh",
    "render",
]

__version__ = "0.1.0"
