"""Plain 3-D ResNet-18 (torchvision ``r3d_18`` layout) video trunk, NCDHW.

A (3,7,7) stem at stride (1,2,2), then BasicBlocks of full 3x3x3 convs.
``last_layer_num`` cuts the stage list as ``R2Plus1D18`` does:
  -3 -> stem + layer1..3, output (N, 256, T/4, H/8, W/8)
  -2 -> stem + layer1..4, output (N, 512, T/8, H/16, W/16)

Module names follow the JAX package's parameter tree (``stem_conv``,
``stem_bn``, ``layer{i}_{j}.conv1/bn1/conv2/bn2/downsample_*``) so that
``models/from_jax.py`` maps one key to one key.
"""

from __future__ import annotations

import torch
from torch import nn

from protoasnet_tpu_torch.models.norm import BatchNorm

__all__ = ["R3D18", "BasicBlock3D"]


def _conv(cin: int, cout: int, kernel, stride, padding) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, stride=stride, padding=padding,
                     bias=False)


class BasicBlock3D(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm(planes)
        self.has_downsample = stride != 1 or inplanes != planes
        if self.has_downsample:
            self.downsample_conv = _conv(inplanes, planes, 1, stride, 0)
            self.downsample_bn = BatchNorm(planes)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + residual)


class R3D18(nn.Module):
    """Truncatable r3d_18 trunk. (N, 3, T, H, W) -> (N, C, T', H', W')."""

    def __init__(self, last_layer_num: int = -3):
        super().__init__()
        kept = 7 + last_layer_num if last_layer_num < 0 else last_layer_num
        n_stages = kept - 1
        if not 1 <= n_stages <= 4:
            raise ValueError(f"last_layer_num={last_layer_num} keeps no conv "
                             f"stages")
        self.out_channels = 64 * 2 ** (n_stages - 1)
        self.stem_conv = _conv(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3))
        self.stem_bn = BatchNorm(64)
        self.layer_names = []
        inplanes = 64
        for i in range(n_stages):
            planes = 64 * 2 ** i
            for j in range(2):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f"layer{i + 1}_{j}"
                self.add_module(name, BasicBlock3D(inplanes, planes, stride))
                self.layer_names.append(name)
                inplanes = planes

    def forward(self, x):
        x = torch.relu(self.stem_bn(self.stem_conv(x)))
        for name in self.layer_names:
            x = getattr(self, name)(x)
        return x
