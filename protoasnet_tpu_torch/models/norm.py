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

Under data parallelism (a process group of more than one rank,
``parallel/mesh.py``) a train-mode forward normalises with the statistics
of the global batch, as the JAX module does under GSPMD: its own formula,
the fp32 (or float64) ``E[x^2] - E[x]^2`` floored at 0, from the sum, the
sum of squares and the count all-reduced across ranks (one collective),
and the running variance Bessel-corrected over the global count. The
all-reduce is differentiable (``all_reduce_sum``): the backward sums the
two moments' gradients across ranks, so each rank's input gradient is
that of the global loss. ``nn.SyncBatchNorm`` takes CUDA tensors only and
has torch's own formula. Without a group, or in eval mode, the module is
torch's BatchNorm as it is.
"""

from __future__ import annotations

import torch
from torch import nn

from protoasnet_tpu_torch.parallel.mesh import all_reduce_sum, world_size

__all__ = ["BatchNorm", "BatchNorm2D", "own_bn_stats", "global_batch_norm"]


def global_batch_norm(bn: nn.modules.batchnorm._BatchNorm,
                      x: torch.Tensor) -> torch.Tensor:
    """A train-mode forward of ``bn`` with the global batch's statistics
    (the JAX module's formula), updating its running statistics."""
    c = bn.num_features
    dims = [0] + list(range(2, x.dim()))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    moments = all_reduce_sum(torch.cat([
        xf.sum(dims), (xf * xf).sum(dims),
        xf.new_full((1,), float(x.numel() // c))]))
    n = moments[2 * c]
    mean = moments[:c] / n
    var = torch.clamp_min(moments[c:2 * c] / n - mean * mean, 0.0)
    with torch.no_grad():
        m = bn.momentum
        bessel = n / torch.clamp_min(n - 1, 1.0)  # 1 for a count of 1
        bn.running_mean.mul_(1 - m).add_(m * mean.to(bn.running_mean.dtype))
        bn.running_var.mul_(1 - m).add_(
            m * (var * bessel).to(bn.running_var.dtype))
        bn.num_batches_tracked.add_(1)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = (xf - mean.view(shape)) * torch.rsqrt(var + bn.eps).view(shape)
    y = y * bn.weight.view(shape) + bn.bias.view(shape)
    return y.to(x.dtype)


class _GlobalStats:
    """Train-mode forwards with the global batch's statistics under data
    parallelism; torch's BatchNorm otherwise."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and world_size() > 1:
            return global_batch_norm(self, x)
        return super().forward(x)


class BatchNorm(_GlobalStats, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` over NCDHW with the JAX module's eps/momentum."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


class BatchNorm2D(_GlobalStats, nn.BatchNorm2d):
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
