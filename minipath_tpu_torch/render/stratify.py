"""Per-pixel stratified sample dimensions for the Monte-Carlo integrators.

Port of ``minipath_tpu/render/stratify.py``; the theory (hashed cyclic
stratum shifts, why the shift must mix in a per-render seed, the
Owen-scrambled Sobol mode selected by a NEGATIVE ``spp``) is documented
there and holds unchanged.

Integer arithmetic. The hashes are uint32 with wrap-around multiplies and
logical shifts. torch's ``uint32`` supports few operations, so every value
here is an int64 tensor holding a uint32 bit pattern in ``[0, 2^32)``, and
every multiply and left shift is masked back with ``& 0xFFFFFFFF``. The low
32 bits of an int64 product are exact even where the product wraps, so the
results equal the JAX package's bit for bit. Signed int32 inputs (pixel ids
XORed with a seed) map to their two's-complement bit pattern by the same
mask.

The per-render seed is an explicit ``int`` here (the JAX package derives it
from the render's PRNG key): callers XOR it into ``pid``, and
:func:`render_seed` draws one from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "grid_factor",
    "hash_shift",
    "render_seed",
    "sobol1d",
    "sobol2d",
    "strat1d",
    "strat2d",
]

_GOLDEN = 0x9E3779B9  # Weyl increment, decorrelates dimension salts
_M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int64 holding its uint32 bit pattern."""
    return x.to(torch.int64) & _M32


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """Wang-style avalanche hash on uint32 lanes (shifts, xors and
    multiplies only)."""
    x = _u32(x)
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _M32
    x = x ^ (x >> 15)
    return x


def grid_factor(spp: int) -> tuple[int, int]:
    """Factor ``spp`` into the most-square ``(gx, gy)`` grid with
    ``gx * gy == spp`` and ``gx >= gy`` (prime spp degrades to an
    ``spp x 1`` Latin strip, which is still a valid stratification)."""
    gy = max(int(math.sqrt(spp)), 1)
    while spp % gy:
        gy -= 1
    return spp // gy, gy


def render_seed(generator: torch.Generator | None) -> int:
    """A per-render int32 seed drawn from ``generator`` (one host sync when
    the generator lives on a card)."""
    device = generator.device if generator is not None else "cpu"
    return int(torch.randint(-(2**31), 2**31, (), generator=generator, device=device))


def hash_shift(pid: torch.Tensor, spp: int, salt: int) -> torch.Tensor:
    """Per-pixel stratum shift for dimension ``salt``: int64 in [0, spp)."""
    h = _hash_u32(_u32(pid) ^ ((salt * _GOLDEN) & _M32))
    return h % spp


def strat1d(u, s, pid, spp: int, salt: int):
    """Map iid uniforms ``u`` in [0,1) to jittered strata of ``[0, 1)``.

    ``s`` is each lane's sample index within its pixel's ``spp`` samples,
    ``pid`` a per-pixel id (any value unique per pixel works), ``salt`` a
    static per-dimension tag. ``spp < 0`` selects Owen-scrambled Sobol
    with ``|spp|`` samples; ``u`` is then unused and may be None.
    """
    if spp < 0:
        return sobol1d(s, pid, salt)
    j = (s + hash_shift(pid, spp, salt)) % spp
    return (j.to(u.dtype) + u) * (1.0 / spp)


def strat2d(u1, u2, s, pid, spp: int, salt: int):
    """Jointly stratify a 2-D dimension pair on a ``gx x gy`` grid.
    ``spp < 0``: Owen-scrambled 2-D Sobol instead; ``u1``/``u2`` are then
    unused and may be None."""
    if spp < 0:
        return sobol2d(s, pid, salt)
    gx, gy = grid_factor(spp)
    j = (s + hash_shift(pid, spp, salt)) % spp
    cx = (j % gx).to(u1.dtype)
    cy = (j // gx).to(u2.dtype)
    return (cx + u1) * (1.0 / gx), (cy + u2) * (1.0 / gy)


# ---- Owen-scrambled Sobol (the spp < 0 mode) ---------------------------


def _dim1_directions() -> list[int]:
    """Direction numbers of the SECOND Sobol dimension (primitive
    polynomial x + 1): v_0 = 2^31, v_j = v_{j-1} ^ (v_{j-1} >> 1). The first
    dimension is the van der Corput radical inverse and needs no table."""
    v, out = 0x80000000, []
    for _ in range(32):
        out.append(v)
        v ^= v >> 1
    return out


_DIM1 = _dim1_directions()


def _reverse_bits(x: torch.Tensor) -> torch.Tensor:
    x = (((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)) & _M32
    x = (((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)) & _M32
    x = (((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)) & _M32
    x = (((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)) & _M32
    return ((x << 16) | (x >> 16)) & _M32


def _laine_karras(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Hash-based nested-uniform permutation of ``[0, 2^32)`` in
    REVERSED-bit order (Laine & Karras 2011 as hashed by Burley 2020)."""
    x = (x + seed) & _M32
    x = (x ^ (x * 0x6C50B47C)) & _M32
    x = (x ^ (x * 0xB82F1E52)) & _M32
    x = (x ^ (x * 0xC7AFE638)) & _M32
    x = (x ^ (x * 0x8D22F6E6)) & _M32
    return x


def _owen(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    return _reverse_bits(_laine_karras(_reverse_bits(x), seed))


def _sobol_pair(index: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``index``-th point of the 2-D Sobol sequence as a uint32 pair."""
    i = _u32(index)
    x = _reverse_bits(i)
    y = torch.zeros_like(i)
    for bit in range(32):
        y = y ^ (((i >> bit) & 1) * _DIM1[bit])
    return x, y


_U32_TO_UNIT = 1.0 / 16777216.0  # top 24 bits -> [0, 1)


def _to_unit(x: torch.Tensor) -> torch.Tensor:
    return (x >> 8).to(torch.float32) * _U32_TO_UNIT


def _dim_seed(pid: torch.Tensor, salt: int, which: int) -> torch.Tensor:
    return _hash_u32(_u32(pid) ^ (((salt * 2 + which) * _GOLDEN) & _M32))


def sobol2d(s, pid, salt: int):
    """Owen-scrambled 2-D Sobol point for sample ``s`` of pixel ``pid`` in
    dimension pair ``salt`` (padded Sobol: every (pid, salt) gets its own
    scramble, all ride the same index)."""
    x, y = _sobol_pair(s)
    return (
        _to_unit(_owen(x, _dim_seed(pid, salt, 0))),
        _to_unit(_owen(y, _dim_seed(pid, salt, 1))),
    )


def sobol1d(s, pid, salt: int):
    """1-D Owen-scrambled radical inverse (Sobol dimension 0)."""
    x = _reverse_bits(_u32(s))
    return _to_unit(_owen(x, _dim_seed(pid, salt, 0)))
