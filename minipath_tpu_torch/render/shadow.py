"""The path tracer's NEE shadow batch on the card: the binding of
``csrc/shadow.cu``.

Four kernels around one ``torch.sort`` and K2's any-hit trace, for the
``"pos"`` order: the box pass reduces the candidates' bounding box and
leaves their count and live packets in device memory; the key pass computes,
one thread per lane, the int32 key of
``render/wavefront.py::shadow_sort_key``; the pack pass writes K2's ``(B, 9,
P)`` rows of the live packets from the sort's permutation; the resolve pass
adds each unblocked candidate's light to its lane's radiance and counts the
blocked ones. They replace no TPU kernel (the JAX package leaves the key, the
gathers and the scatter back to XLA around ``lax.sort``); they exist because
on the card the plain version is about 110 PyTorch kernels a NEE bounce, each
over every lane. ``render/wavefront.py::_shadow_light_kernel`` allocates the
outputs, sorts, traces and calls the passes; the kernels' design note is in
their source.

The arguments travel as one C struct (``ShadowArgs`` in the source, mirrored
by :class:`_Args`), read on the host at each launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from minipath_tpu_torch.utils.cuda_build import KernelEntry

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "shadow.cu"

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64

# Rows of the box pass's partials: the most blocks it launches.
BOX_ROWS = 1024


class _Args(ctypes.Structure):
    """``ShadowArgs`` of ``csrc/shadow.cu``, field for field: pointers to
    device memory (None for null), a row stride in elements, and scalars."""

    _fields_ = [
        ("n", _i64),
        ("cand", _vp), ("origin", _vp), ("segment", _vp), ("wi", _vp), ("contrib", _vp),
        ("counts", _vp), ("partial", _vp), ("partial_rows", _i64), ("box", _vp),
        ("key", _vp),
        ("order", _vp), ("packet", _i32), ("rays", _vp),
        ("tri", _vp), ("radiance", _vp), ("s_radiance", _i64),
    ]


# The passes: ``box_pass(device, **fields)`` and so on (see
# :class:`~minipath_tpu_torch.utils.cuda_build.KernelEntry`).
box_pass = KernelEntry(_SOURCE, _Args, "mp_shadow", "box")
key_pass = KernelEntry(_SOURCE, _Args, "mp_shadow", "key")
pack_pass = KernelEntry(_SOURCE, _Args, "mp_shadow", "pack")
resolve_pass = KernelEntry(_SOURCE, _Args, "mp_shadow", "resolve")
load_library = box_pass.load
