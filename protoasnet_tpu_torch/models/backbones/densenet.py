"""DenseNet feature trunks (121/161/169/201), NCHW.

The classifier-free torchvision DenseNet: a 7x7 stride-2 ``conv0`` stem,
``norm0``, ReLU and a 3x3 stride-2 max-pool, four dense blocks (each layer
BN -> ReLU -> 1x1 conv -> BN -> ReLU -> 3x3 conv, its output concatenated
to its input) with transitions (BN -> ReLU -> 1x1 conv -> 2x2 average
pool) between them, and ``norm5`` with a ReLU at the end:
(N, 3, H, W) -> (N, C, H/32, W/32). ``conv_info()`` gives the chain for
the receptive-field calculator, as the JAX package's trunk does.

Module names follow the JAX package's parameter tree
(``denseblock{i}_layer{j}.norm1/conv1/norm2/conv2``,
``transition{i}.norm/conv``) so that ``models/from_jax.py`` maps one key
to one key.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from protoasnet_tpu_torch.models.norm import BatchNorm2D

__all__ = ["DenseNetFeatures", "DENSENET_SPECS", "DenseLayer", "Transition"]

# name -> (init_features, growth_rate, block_config)
DENSENET_SPECS = {
    "densenet121": (64, 32, (6, 12, 24, 16)),
    "densenet161": (96, 48, (6, 12, 36, 24)),
    "densenet169": (64, 32, (6, 12, 32, 32)),
    "densenet201": (64, 32, (6, 12, 48, 32)),
}
_BN_SIZE = 4


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth_rate: int):
        super().__init__()
        self.norm1 = BatchNorm2D(cin)
        self.conv1 = nn.Conv2d(cin, _BN_SIZE * growth_rate, 1, bias=False)
        self.norm2 = BatchNorm2D(_BN_SIZE * growth_rate)
        self.conv2 = nn.Conv2d(_BN_SIZE * growth_rate, growth_rate, 3,
                               padding=1, bias=False)

    def forward(self, x):
        y = self.conv1(torch.relu(self.norm1(x)))
        y = self.conv2(torch.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm = BatchNorm2D(cin)
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)

    def forward(self, x):
        return F.avg_pool2d(self.conv(torch.relu(self.norm(x))), 2, 2)


def _channels(variant: str) -> List[int]:
    """The channel count entering each block, and the trunk's output."""
    init_f, growth, blocks = DENSENET_SPECS[variant]
    out, c = [], init_f
    for i, n in enumerate(blocks):
        out.append(c)
        c += n * growth
        if i != len(blocks) - 1:
            c //= 2
    return out + [c]


class DenseNetFeatures(nn.Module):
    """(N, 3, H, W) -> (N, C, H/32, W/32) feature trunk."""

    def __init__(self, variant: str = "densenet121"):
        super().__init__()
        if variant not in DENSENET_SPECS:
            raise ValueError(f"unknown densenet variant {variant!r}; "
                             f"options: {list(DENSENET_SPECS)}")
        self.variant = variant
        init_f, growth, blocks = DENSENET_SPECS[variant]
        chans = _channels(variant)
        self.out_channels = chans[-1]
        self.conv0 = nn.Conv2d(3, init_f, 7, stride=2, padding=3, bias=False)
        self.norm0 = BatchNorm2D(init_f)
        self.stages = []  # (module names of one block, transition or None)
        for i, n_layers in enumerate(blocks):
            names = []
            for j in range(n_layers):
                name = f"denseblock{i + 1}_layer{j + 1}"
                self.add_module(name, DenseLayer(chans[i] + j * growth,
                                                 growth))
                names.append(name)
            trans = None
            if i != len(blocks) - 1:
                trans = f"transition{i + 1}"
                self.add_module(trans, Transition(
                    chans[i] + n_layers * growth, chans[i + 1]))
            self.stages.append((names, trans))
        self.norm5 = BatchNorm2D(chans[-1])

    def forward(self, x):
        x = torch.relu(self.norm0(self.conv0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for names, trans in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            if trans is not None:
                x = getattr(self, trans)(x)
        return torch.relu(self.norm5(x))

    def conv_info(self) -> Tuple[List[int], List[int], List[int]]:
        """(kernel_sizes, strides, paddings) of the sequential chain."""
        _, _, blocks = DENSENET_SPECS[self.variant]
        chain = [(7, 2, 3), (3, 2, 1)]
        for i, n_layers in enumerate(blocks):
            chain.extend([(1, 1, 0), (3, 1, 1)] * n_layers)
            if i != len(blocks) - 1:
                chain.extend([(1, 1, 0), (2, 2, 0)])
        ks, ss, ps = zip(*chain)
        return list(ks), list(ss), list(ps)
