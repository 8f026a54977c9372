"""Echo intensity normalisation (the eval transform of the uint8 input path).

Dataset statistics of the reference (bin_to_norm): mean 0.099, std 0.171,
applied to frames scaled to [0, 1].
"""

from __future__ import annotations

import torch

NORM_MEAN = 0.099
NORM_STD = 0.171

__all__ = ["NORM_MEAN", "NORM_STD", "normalize", "unnormalize"]


def normalize(x: torch.Tensor) -> torch.Tensor:
    return (x - NORM_MEAN) / NORM_STD


def unnormalize(x: torch.Tensor) -> torch.Tensor:
    return x * NORM_STD + NORM_MEAN
