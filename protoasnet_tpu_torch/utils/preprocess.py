"""ImageNet-stats preprocessing helpers (the JAX package's
``utils/preprocess.py`` on tensors).

Mean/std normalisation and its inverse over the last axis (channels-last,
3 channels), used when inputs arrive un-normalised. The constants are in
the input's dtype and on its device.
"""

from __future__ import annotations

import torch

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "preprocess_input_function",
           "undo_preprocess_input_function"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _stats(x: torch.Tensor):
    return (torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device),
            torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device))


def preprocess_input_function(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) in [0, 1] -> ImageNet-normalised."""
    mean, std = _stats(x)
    return (x - mean) / std


def undo_preprocess_input_function(x: torch.Tensor) -> torch.Tensor:
    mean, std = _stats(x)
    return x * std + mean
