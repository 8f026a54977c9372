"""BatchNorm with the reference's (torch) semantics.

The JAX package's ``BatchNorm`` (flax, ``momentum=0.9``) exists to match
torch: it normalises with the biased batch variance and tracks the
Bessel-corrected variance in its running average, ``ra = 0.9*ra + 0.1*stat``.
That is exactly ``nn.BatchNorm3d(eps=1e-5, momentum=0.1)``, so the port uses
it as is. Eval uses the running stats; statistics stay fp32 under bf16
autocast.
"""

from __future__ import annotations

from torch import nn

__all__ = ["BatchNorm"]


class BatchNorm(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` over NCDHW with the JAX module's eps/momentum."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
