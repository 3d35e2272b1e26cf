"""The path tracer's coherence compaction on the card: the binding of
``csrc/compact.cu``.

Two kernels around one ``torch.sort``: the key pass computes, one thread per
lane, the int32 sort key that ``render/wavefront.py::_compact_plain`` builds
from the origin's Morton cell, the direction bin and the dead bit, and
stages the lane's state in one 64-byte record; the permute pass gathers, one
thread per output lane, each lane's record by the sort's permutation and
writes the state with its inverse direction and live flag.
They replace no TPU kernel (the JAX package leaves the key and the gather to
XLA around ``lax.sort``); they exist because on the card the plain version is
about ninety PyTorch kernels a call, each over whole ``(N,)`` or ``(N, 3)``
arrays, and a 15-column ``torch.cat`` and its gather.
``render/wavefront.py::_compact_kernel`` takes the bounding box, allocates
the outputs, sorts and calls :data:`key_pass` and :data:`permute_pass`; the
kernels' design note is in their source.

The arguments travel as one C struct (``CompactArgs`` in the source,
mirrored by :class:`_Args`), read on the host at each launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from minipath_tpu_torch.utils.cuda_build import KernelEntry

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "compact.cu"

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


class _Args(ctypes.Structure):
    """``CompactArgs`` of ``csrc/compact.cu``, field for field: pointers to
    device memory (None for null), row strides in elements, and scalars."""

    _fields_ = [
        ("n", _i64),
        ("origin", _vp), ("s_origin", _i64), ("direction", _vp), ("s_direction", _i64),
        ("throughput", _vp), ("s_throughput", _i64), ("radiance", _vp), ("s_radiance", _i64),
        ("pixel", _vp), ("s_pixel", _i64), ("active", _vp), ("s_active", _i64),
        ("prev_pdf", _vp), ("s_prev_pdf", _i64),
        ("lo", _vp), ("hi", _vp), ("fine_direction", _i32), ("key", _vp), ("record", _vp),
        ("perm", _vp), ("n_live", _vp),
        ("o_rays", _vp), ("o_throughput", _vp), ("o_radiance", _vp), ("o_pixel", _vp), ("o_active", _vp),
        ("o_prev_pdf", _vp),
    ]


# The two passes around the sort: ``key_pass(device, **fields)`` and
# ``permute_pass(device, **fields)`` (see
# :class:`~minipath_tpu_torch.utils.cuda_build.KernelEntry`).
key_pass = KernelEntry(_SOURCE, _Args, "mp_compact", "key")
permute_pass = KernelEntry(_SOURCE, _Args, "mp_compact", "permute")
load_library = key_pass.load
