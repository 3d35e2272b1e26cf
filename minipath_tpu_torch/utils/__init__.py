"""Shared utilities: streaming stats, image conversion, profiling, bit ops."""

import numpy as np

from minipath_tpu_torch.utils.image import color_to_image, save_png
from minipath_tpu_torch.utils.profiling import PhaseTimers
from minipath_tpu_torch.utils.stats import Stats


def bit_iter(mask: int):
    """Iterate indices of set bits, lowest first.

    Host-side parity with the reference's movemask scanning helper; device
    code uses dense masks instead, but build and debug tooling still wants
    this.
    """
    mask = int(mask)
    if mask < 0:
        raise ValueError(f"bit_iter needs a non-negative mask, got {mask}")
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


__all__ = ["LUMA_WEIGHTS", "PhaseTimers", "Stats", "bit_iter", "color_to_image", "save_png"]

# Rec. 709 luminance weights.
LUMA_WEIGHTS = np.array([0.2126, 0.7152, 0.0722], np.float32)
