"""R(2+1)D-18 video trunk (torchvision ``r2plus1d_18`` layout), NCDHW.

Every 3-D conv factorises into a spatial (1,3,3) conv + BN + ReLU + a
temporal (3,1,1) conv with ``midplanes`` hidden channels. ``last_layer_num``
truncates the stage list like the reference's
``nn.Sequential(children[:last_layer_num])``:
  -3 -> stem + layer1..3, output (N, 256, T/4, H/8, W/8)
  -2 -> stem + layer1..4, output (N, 512, T/8, H/16, W/16)

Module names follow the JAX package's parameter tree (``stem_spatial``,
``layer1_0.conv1.bn_mid`` ...) so that ``models/from_jax.py`` maps one key
to one key. The stem is the plain (1,7,7)/stride-(1,2,2) conv; the JAX
package's space-to-depth stem is a TPU rewrite of the same conv and keeps
this kernel layout.

``remat=True`` (the config's ``model.remat``) checkpoints each block in a
train-mode forward that records a graph: the block's activations are not
kept, and ``backward()`` runs its forward again
(``torch.utils.checkpoint``, non-reentrant), as the JAX trunk wraps each
block in ``nn.remat``. The recompute runs under ``own_bn_stats``, so a
train step updates each BatchNorm's running statistics and
``num_batches_tracked`` once, as without remat. Eval-mode and no-grad
forwards (serving, push) run the blocks as they are; the parameters and
the state_dict are the same either way.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from protoasnet_tpu_torch.models.norm import BatchNorm, own_bn_stats

__all__ = ["R2Plus1D18", "Conv2Plus1D", "BasicBlock2Plus1D", "midplanes"]


def midplanes(inplanes: int, planes: int) -> int:
    return (inplanes * planes * 3 * 3 * 3) // (inplanes * 3 * 3 + 3 * planes)


def _conv(cin: int, cout: int, kernel, stride, padding) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, stride=stride, padding=padding,
                     bias=False)


class Conv2Plus1D(nn.Module):
    """Spatial (1,3,3) conv + BN + ReLU + temporal (3,1,1) conv."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        mid = midplanes(inplanes, planes)
        self.spatial = _conv(inplanes, mid, (1, 3, 3), (1, stride, stride),
                             (0, 1, 1))
        self.bn_mid = BatchNorm(mid)
        self.temporal = _conv(mid, planes, (3, 1, 1), (stride, 1, 1),
                              (1, 0, 0))

    def forward(self, x):
        return self.temporal(torch.relu(self.bn_mid(self.spatial(x))))


class BasicBlock2Plus1D(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2Plus1D(inplanes, planes, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2Plus1D(planes, planes, 1)
        self.bn2 = BatchNorm(planes)
        self.has_downsample = stride != 1 or inplanes != planes
        if self.has_downsample:
            self.downsample_conv = _conv(inplanes, planes, (1, 1, 1),
                                         (stride,) * 3, 0)
            self.downsample_bn = BatchNorm(planes)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + residual)


class R2Plus1D18(nn.Module):
    """Truncatable R(2+1)D-18 trunk. (N, 3, T, H, W) -> (N, C, T', H', W')."""

    def __init__(self, last_layer_num: int = -3, remat: bool = False):
        super().__init__()
        self.remat = bool(remat)
        # children = [stem, layer1, layer2, layer3, layer4, avgpool, fc]
        kept = 7 + last_layer_num if last_layer_num < 0 else last_layer_num
        n_stages = kept - 1
        if not 1 <= n_stages <= 4:
            raise ValueError(f"last_layer_num={last_layer_num} keeps no conv "
                             f"stages")
        self.out_channels = 64 * 2 ** (n_stages - 1)
        self.stem_spatial = _conv(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3))
        self.stem_bn1 = BatchNorm(45)
        self.stem_temporal = _conv(45, 64, (3, 1, 1), (1, 1, 1), (1, 0, 0))
        self.stem_bn2 = BatchNorm(64)
        self.layer_names = []
        inplanes = 64
        for i in range(n_stages):
            planes = 64 * 2 ** i
            for j in range(2):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f"layer{i + 1}_{j}"
                self.add_module(name,
                                BasicBlock2Plus1D(inplanes, planes, stride))
                self.layer_names.append(name)
                inplanes = planes

    def forward(self, x):
        x = torch.relu(self.stem_bn1(self.stem_spatial(x)))
        x = torch.relu(self.stem_bn2(self.stem_temporal(x)))
        remat = self.remat and self.training and torch.is_grad_enabled()
        for name in self.layer_names:
            block = getattr(self, name)
            if remat:
                # the blocks draw no random numbers: no RNG state to keep
                x = checkpoint(block, x, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=lambda b=block: (nullcontext(),
                                                           own_bn_stats(b)))
            else:
                x = block(x)
        return x
