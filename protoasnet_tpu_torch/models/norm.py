"""BatchNorm with the reference's (torch) semantics.

The JAX package's ``BatchNorm`` (flax, ``momentum=0.9``) exists to match
torch: it normalises with the biased batch variance and tracks the
Bessel-corrected variance in its running average, ``ra = 0.9*ra + 0.1*stat``.
That is exactly torch's ``BatchNorm{2,3}d(eps=1e-5, momentum=0.1)``, so the
port uses them as they are: ``BatchNorm`` over NCDHW (video trunks),
``BatchNorm2D`` over NCHW (image trunks). Eval uses the running stats;
statistics stay fp32 under bf16 autocast.

``own_bn_stats(module)`` lets a block of train-mode forwards update copies
of the running statistics and puts the originals back on exit: the
TransformLoss forward of affine(x) (``train/steps.py``) and the recompute
of a rematerialised trunk block (``backbones/r2plus1d.py``) run under it,
so each train step writes the statistics once, as flax's functional
``batch_stats`` are written.
"""

from __future__ import annotations

from torch import nn

__all__ = ["BatchNorm", "BatchNorm2D", "own_bn_stats"]


class BatchNorm(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` over NCDHW with the JAX module's eps/momentum."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


class BatchNorm2D(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` over NCHW with the JAX module's eps/momentum."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


class own_bn_stats:
    """Within the block, each BatchNorm of ``module`` updates copies of its
    running statistics; on exit the originals are put back, untouched. The
    tensors are swapped, not copied into: autograd may hold the originals
    for the backward of an earlier forward."""

    def __init__(self, module: nn.Module):
        self.bns = [m for m in module.modules()
                    if isinstance(m, nn.modules.batchnorm._BatchNorm)]
        self.saved = []

    def __enter__(self):
        self.saved = [(m.running_mean, m.running_var, m.num_batches_tracked)
                      for m in self.bns]
        for m, bufs in zip(self.bns, self.saved):
            (m.running_mean, m.running_var,
             m.num_batches_tracked) = (b.clone() for b in bufs)
        return self

    def __exit__(self, *exc):
        for m, bufs in zip(self.bns, self.saved):
            m.running_mean, m.running_var, m.num_batches_tracked = bufs
        return False
