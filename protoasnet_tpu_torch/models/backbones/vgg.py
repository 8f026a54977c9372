"""VGG feature trunks (11/13/16/19, with and without BatchNorm), NCHW.

The classifier-free torchvision VGG: 3x3 convs (padding 1) with ReLU, and
2x2 max-pools at stride 2; (N, 3, H, W) -> (N, 512, H/32, W/32).
``conv_info()`` gives the (kernel, stride, padding) chain for the
receptive-field calculator, as the JAX package's trunk does.

Module names follow the JAX package's parameter tree: ``conv{i}`` (with a
bias unless ``_bn``) and ``bn{i}``, counting convs only, so that
``models/from_jax.py`` maps one key to one key.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from protoasnet_tpu_torch.models.norm import BatchNorm2D

__all__ = ["VGGFeatures", "VGG_CFGS"]

VGG_CFGS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
              512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGGFeatures(nn.Module):
    """``variant`` is "vggNN" or "vggNN_bn"."""

    out_channels = 512

    def __init__(self, variant: str = "vgg16"):
        super().__init__()
        base = variant[:-3] if variant.endswith("_bn") else variant
        if base not in VGG_CFGS:
            raise ValueError(f"unknown vgg variant {variant!r}; options: "
                             f"{list(VGG_CFGS)} and their _bn forms")
        self.variant = variant
        self.batch_norm = variant.endswith("_bn")
        self.cfg = VGG_CFGS[base]
        cin, idx = 3, 0
        for v in self.cfg:
            if v == "M":
                continue
            self.add_module(f"conv{idx}", nn.Conv2d(
                cin, v, 3, padding=1, bias=not self.batch_norm))
            if self.batch_norm:
                self.add_module(f"bn{idx}", BatchNorm2D(v))
            cin, idx = v, idx + 1

    def forward(self, x):
        idx = 0
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f"conv{idx}")(x)
            if self.batch_norm:
                x = getattr(self, f"bn{idx}")(x)
            x = torch.relu(x)
            idx += 1
        return x

    def conv_info(self) -> Tuple[List[int], List[int], List[int]]:
        """(kernel_sizes, strides, paddings) of the conv/pool chain."""
        chain = [(2, 2, 0) if v == "M" else (3, 1, 1) for v in self.cfg]
        ks, ss, ps = zip(*chain)
        return list(ks), list(ss), list(ps)
