"""Shared utilities: streaming stats, image conversion, phase timing."""

import numpy as np

from minipath_tpu_torch.utils.image import color_to_image, save_png
from minipath_tpu_torch.utils.profiling import PhaseTimers
from minipath_tpu_torch.utils.stats import Stats

__all__ = ["LUMA_WEIGHTS", "PhaseTimers", "Stats", "color_to_image", "save_png"]

# Rec. 709 luminance weights.
LUMA_WEIGHTS = np.array([0.2126, 0.7152, 0.0722], np.float32)
