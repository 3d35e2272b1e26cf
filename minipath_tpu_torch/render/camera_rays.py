"""The camera rays on the card: the binding of ``csrc/camera.cu``.

The kernel does, one thread per ray, what the plain chain does for a batch of
pixel packets: the strata of ``render/stratify.py``, the thin lens of
``camera.py::sample_rays``, ``make_rays``' normalisation and inverse, and
``render/kernels.py::rays_to_rays9``'s packing into the ``(B, 9, P)`` rows
the traversal kernels read. It replaces no TPU kernel (the JAX package leaves
ray generation to XLA); it exists because on the card the plain chain is a
few dozen elementwise kernels and copies over whole int64 and float tensors,
where one pass reads each ray's uniforms and writes its rows once.
``render/frame.py::packet_rays9`` draws the uniforms, builds the packet-origin
table and calls :func:`launch`; :func:`lane_pixels` states the kernel's
index rule in PyTorch.

The arguments travel as one C struct (``CameraArgs`` in the source, mirrored
by :class:`_Args`), read on the host at the launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from minipath_tpu_torch.utils.cuda_build import KernelEntry

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "camera.cu"

_vp, _i32, _u32, _i64, _f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint32, ctypes.c_int64, ctypes.c_float


class _Args(ctypes.Structure):
    """``CameraArgs`` of ``csrc/camera.cu``, field for field: pointers to
    device memory (None for null) and scalars."""

    _fields_ = [
        ("n", _i64), ("lanes", _i32), ("block_pixels", _i32), ("block_width", _i32),
        ("origin", _vp), ("s0", _i32), ("row_stride", _u32), ("x_mask", _u32),
        ("strat_mode", _i32), ("spp", _i32), ("gx", _i32), ("inv_gx", _f32), ("inv_gy", _f32),
        ("strat_seed", _u32), ("salt", _u32),
        ("u_film", _vp), ("u_lens", _vp),
        ("center", _vp), ("up", _vp), ("right", _vp), ("film_origin_offset", _vp),
        ("pixel_scale", _vp), ("lens_radius", _vp), ("lens_weight", _vp),
        ("rays9", _vp),
    ]


# The camera rays of a batch of packets: ``launch(device, **fields)`` (see
# :class:`~minipath_tpu_torch.utils.cuda_build.KernelEntry`).
launch = KernelEntry(_SOURCE, _Args, "mp_camera", "rays")
load_library = launch.load


def lane_pixels(origin: torch.Tensor, *, px_block, samples: int, s0: int, row_stride: int, x_mask: int = -1,
                strat_seed: int = 0):
    """The kernel's index rule in PyTorch: for the packet-origin table
    ``origin`` ``(B, 2)`` (each packet's first pixel, x and y), the pixel
    ``x``, ``y``, the sample index ``s`` and the strata's pixel id ``pid``
    (a uint32 bit pattern in an int64) of every lane, each ``(B, samples *
    bh * bw)``."""
    bh, bw = px_block
    bp = bh * bw
    p = torch.arange(samples * bp, device=origin.device)
    q = p % bp
    o = origin.to(torch.int64)
    x = o[:, 0:1] + q % bw
    y = o[:, 1:2] + q // bw
    s = (s0 + p // bp).expand_as(x)
    pid = ((y * row_stride + (x & (x_mask & 0xFFFFFFFF))) ^ strat_seed) & 0xFFFFFFFF
    return x, y, s, pid
