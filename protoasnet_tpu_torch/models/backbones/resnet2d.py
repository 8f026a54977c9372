"""2-D ResNet feature trunks (18/34/50/101/152), NCHW.

The avgpool/fc-free torchvision ResNet: (N, 3, H, W) -> (N, C, H/32, W/32)
with C = 512 (BasicBlock) or 2048 (Bottleneck). ``conv_info()`` gives the
(kernel, stride, padding) chain of the sequential conv path for the
receptive-field calculator, as the JAX package's trunk does.

Module names follow the JAX package's parameter tree (``conv1``, ``bn1``,
``layer{i}_{j}.Conv_0`` / ``BatchNorm_0`` ..., ``downsample_conv``,
``downsample_bn``) so that ``models/from_jax.py`` maps one key to one key.
The flax downsample conv has no padding argument ("SAME"), which pads 0
for a 1x1 kernel at stride 2, as ``padding=0`` does here; flax's
``max_pool`` pads with -inf, as ``nn.MaxPool2d`` does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from protoasnet_tpu_torch.models.norm import BatchNorm2D

__all__ = ["BasicBlock", "Bottleneck", "ResNetFeatures", "RESNET_SPECS"]


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                     bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, filters: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = _conv(inplanes, filters, 3, stride, 1)
        self.BatchNorm_0 = BatchNorm2D(filters)
        self.Conv_1 = _conv(filters, filters, 3, 1, 1)
        self.BatchNorm_1 = BatchNorm2D(filters)
        self.has_downsample = stride != 1 or inplanes != filters
        if self.has_downsample:
            self.downsample_conv = _conv(inplanes, filters, 1, stride)
            self.downsample_bn = BatchNorm2D(filters)

    def forward(self, x):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + residual)

    @staticmethod
    def conv_info(stride: int) -> List[Tuple[int, int, int]]:
        # main path only: the receptive-field chain is the sequential path
        return [(3, stride, 1), (3, 1, 1)]


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, filters: int, stride: int = 1):
        super().__init__()
        out = filters * self.expansion
        self.Conv_0 = _conv(inplanes, filters, 1)
        self.BatchNorm_0 = BatchNorm2D(filters)
        self.Conv_1 = _conv(filters, filters, 3, stride, 1)
        self.BatchNorm_1 = BatchNorm2D(filters)
        self.Conv_2 = _conv(filters, out, 1)
        self.BatchNorm_2 = BatchNorm2D(out)
        self.has_downsample = stride != 1 or inplanes != out
        if self.has_downsample:
            self.downsample_conv = _conv(inplanes, out, 1, stride)
            self.downsample_bn = BatchNorm2D(out)

    def forward(self, x):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + residual)

    @staticmethod
    def conv_info(stride: int) -> List[Tuple[int, int, int]]:
        return [(1, 1, 0), (3, stride, 1), (1, 1, 0)]


RESNET_SPECS = {
    "resnet18": (BasicBlock, [2, 2, 2, 2]),
    "resnet34": (BasicBlock, [3, 4, 6, 3]),
    "resnet50": (Bottleneck, [3, 4, 6, 3]),
    "resnet101": (Bottleneck, [3, 4, 23, 3]),
    "resnet152": (Bottleneck, [3, 8, 36, 3]),
}


class ResNetFeatures(nn.Module):
    """avgpool/fc-free ResNet trunk: (N, 3, H, W) -> (N, C, H/32, W/32)."""

    def __init__(self, block_name: str = "resnet18"):
        super().__init__()
        if block_name not in RESNET_SPECS:
            raise ValueError(f"unknown resnet variant {block_name!r}; "
                             f"options: {list(RESNET_SPECS)}")
        self.block_name = block_name
        block_cls, stage_sizes = RESNET_SPECS[block_name]
        self.out_channels = 512 * block_cls.expansion
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm2D(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.layer_names = []
        inplanes = 64
        for i, n_blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** i
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block_cls(inplanes, filters, stride))
                self.layer_names.append(name)
                inplanes = filters * block_cls.expansion

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for name in self.layer_names:
            x = getattr(self, name)(x)
        return x

    def conv_info(self) -> Tuple[List[int], List[int], List[int]]:
        """(kernel_sizes, strides, paddings) of the sequential conv chain."""
        block_cls, stage_sizes = RESNET_SPECS[self.block_name]
        chain = [(7, 2, 3), (3, 2, 1)]  # conv1 + maxpool
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                chain.extend(block_cls.conv_info(2 if (i > 0 and j == 0)
                                                 else 1))
        ks, ss, ps = zip(*chain)
        return list(ks), list(ss), list(ps)
