"""Shared utilities: streaming stats, image conversion, phase timing."""

from minipath_tpu_torch.utils.image import color_to_image, save_png
from minipath_tpu_torch.utils.profiling import PhaseTimers
from minipath_tpu_torch.utils.stats import Stats

__all__ = ["PhaseTimers", "Stats", "color_to_image", "save_png"]
