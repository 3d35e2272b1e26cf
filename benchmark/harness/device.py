"""The card: that there is one, what it is, and what its power limit is."""

from __future__ import annotations

import subprocess

import torch


class NoCard(RuntimeError):
    pass


def require(chips: int) -> torch.device:
    """The first card, where ``chips`` cards are present; raises
    :class:`NoCard` otherwise. There is no fallback to the CPU."""
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device is available")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, {torch.cuda.device_count()} are present")
    return torch.device("cuda", 0)


def describe(device: torch.device, count: int) -> dict:
    """The result line's ``device``, its peak and the card's power limit
    read now."""
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": count, "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": count,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
        "power_limit_w": power_limit_w(),
    }


def power_limit_w() -> float | None:
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
