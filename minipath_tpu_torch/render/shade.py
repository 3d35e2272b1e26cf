"""The path tracer's bounce shading on the card: the binding of
``csrc/shade.cu``.

The kernel does, one thread per lane, what the wavefront loop's plain
PyTorch shading (``render/wavefront.py::_shade_plain``) does between a
closest-hit trace and the next compaction or trace: the environment on a
miss, BSDF sampling, the strata, the MIS-weighted emitter hit, the NEE light
sample and its contribution, and path roulette. It replaces no TPU kernel
(the JAX package leaves that stretch to XLA); it exists because on the card
the plain version is a few hundred elementwise kernels a bounce, each
reading and writing whole ``(N, 3)`` arrays, where one pass reads and writes
each lane's bytes once. ``render/wavefront.py::_shade_kernel`` draws the
uniforms, allocates the outputs and calls :func:`launch`; the kernel's
design note is in its source.

The arguments travel as one C struct (``ShadeArgs`` in the source, mirrored
by :class:`_Args`), read on the host at the launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from minipath_tpu_torch.utils.cuda_build import KernelEntry

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "shade.cu"

_vp, _i32, _u32, _i64, _f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint32, ctypes.c_int64, ctypes.c_float


class _Args(ctypes.Structure):
    """``ShadeArgs`` of ``csrc/shade.cu``, field for field: pointers to
    device memory (None for null), row strides in elements, and scalars."""

    _fields_ = [
        ("n", _i64), ("live", _vp),
        ("t", _vp), ("tri", _vp), ("normal", _vp), ("s_normal", _i64), ("material", _vp),
        ("origin", _vp), ("s_origin", _i64), ("direction", _vp), ("s_direction", _i64),
        ("inv_direction", _vp), ("s_inv_direction", _i64), ("throughput", _vp), ("s_throughput", _i64),
        ("radiance", _vp), ("s_radiance", _i64), ("pixel", _vp), ("s_pixel", _i64),
        ("active", _vp), ("s_active", _i64), ("prev_pdf", _vp), ("s_prev_pdf", _i64),
        ("u_z", _vp), ("u_phi", _vp), ("u_lobe", _vp), ("u_choice", _vp),
        ("u_light", _vp), ("u_tri", _vp), ("u_rr", _vp), ("u_path", _vp),
        ("kind", _vp), ("albedo", _vp), ("emission", _vp), ("param", _vp), ("horizon", _vp), ("zenith", _vp),
        ("l_v0", _vp), ("l_e1", _vp), ("l_e2", _vp), ("l_normal", _vp), ("l_area", _vp), ("l_emission", _vp),
        ("l_pmf", _vp), ("l_cdf", _vp), ("l_tri_light", _vp), ("n_lights", _i64),
        ("strat_mode", _i32), ("spp", _i32), ("gx", _i32), ("gy", _i32),
        ("inv_spp", _f32), ("inv_gx", _f32), ("inv_gy", _f32),
        ("strat_offset", _i32), ("strat_seed", _i32), ("block_start", _i32), ("lanes", _i32),
        ("block_pixels", _i32), ("salt_bsdf", _u32), ("salt_nee", _u32),
        ("nee", _i32), ("nee_here", _i32), ("shadow_rr", _i32), ("roulette", _i32), ("rr_floor", _f32),
        ("o_origin", _vp), ("o_direction", _vp), ("o_inv_direction", _vp), ("o_throughput", _vp),
        ("o_radiance", _vp), ("o_active", _vp), ("o_prev_pdf", _vp),
        ("cand", _vp), ("sh_origin", _vp), ("segment", _vp), ("wi", _vp), ("light", _vp), ("contrib", _vp),
    ]


# The strata modes of ShadeArgs::strat_mode.
STRAT_NONE, STRAT_JITTER, STRAT_SOBOL = 0, 1, 2

# One bounce's shading: ``launch(device, **fields)`` (see
# :class:`~minipath_tpu_torch.utils.cuda_build.KernelEntry`).
launch = KernelEntry(_SOURCE, _Args, "mp_shade", "bounce")
load_library = launch.load
