"""BatchNorm with the reference's (torch) semantics.

The JAX package's ``BatchNorm`` (flax, ``momentum=0.9``) exists to match
torch: it normalises with the biased batch variance and tracks the
Bessel-corrected variance in its running average, ``ra = 0.9*ra + 0.1*stat``.
That is exactly torch's ``BatchNorm{2,3}d(eps=1e-5, momentum=0.1)``, so the
port uses them as they are: ``BatchNorm`` over NCDHW (video trunks),
``BatchNorm2D`` over NCHW (image trunks). Eval uses the running stats;
statistics stay fp32 under bf16 autocast.
"""

from __future__ import annotations

from torch import nn

__all__ = ["BatchNorm", "BatchNorm2D"]


class BatchNorm(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` over NCDHW with the JAX module's eps/momentum."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


class BatchNorm2D(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` over NCHW with the JAX module's eps/momentum."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
