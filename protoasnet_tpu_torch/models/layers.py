"""Head layers over channels-last tensors: add-on, occurrence, readout.

The reference's 1x1(x1) convs are ``nn.Linear`` over the trailing channel
axis, as the JAX package's ``Dense`` layers are, so one implementation
serves the image and video models. Sub-module names (``Dense_0`` ...)
follow the JAX parameter tree for the weight bridge.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["prototype_class_identity", "incorrect_connection_kernel",
           "init_weights_", "bf16_autocast", "AddOnLayers",
           "bottleneck_channel_plan", "BottleneckAddOn", "OccurrenceModule",
           "PrototypeReadout"]


def prototype_class_identity(num_prototypes: int, num_classes: int
                             ) -> np.ndarray:
    """(P, K) one-hot class identity, equal prototypes per class."""
    if num_prototypes % num_classes != 0:
        raise ValueError(f"num_prototypes ({num_prototypes}) must be "
                         f"divisible by num_classes ({num_classes})")
    per_class = num_prototypes // num_classes
    ident = np.zeros((num_prototypes, num_classes), dtype=np.float32)
    ident[np.arange(num_prototypes),
          np.arange(num_prototypes) // per_class] = 1.0
    return ident


def incorrect_connection_kernel(num_prototypes: int, num_classes: int,
                                incorrect_strength: float) -> np.ndarray:
    """(P, K) readout kernel: 1 on own-class entries, incorrect_strength
    elsewhere."""
    ident = prototype_class_identity(num_prototypes, num_classes)
    return ident + incorrect_strength * (1.0 - ident)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init of every conv, Linear and BatchNorm in
    ``model``, drawn from ``generator`` (a CPU generator): kaiming-normal
    fan-out weights, zero biases, unit BN."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            m.reset_parameters()


def bf16_autocast(x: torch.Tensor, dtype: torch.dtype):
    """bf16 autocast on ``x``'s device when the model's dtype is bf16; none
    on the ``meta`` device, where only shapes (and FLOPs) are followed."""
    if x.device.type == "meta":
        return contextlib.nullcontext()
    return torch.autocast(x.device.type, dtype=torch.bfloat16,
                          enabled=dtype == torch.bfloat16)


class AddOnLayers(nn.Module):
    """Linear(C->D) ReLU Linear(D->D) [Sigmoid: ProtoPNet's "regular"
    add-on]."""

    def __init__(self, in_features: int, features: int,
                 final_sigmoid: bool = False):
        super().__init__()
        self.final_sigmoid = final_sigmoid
        self.Dense_0 = nn.Linear(in_features, features)
        self.Dense_1 = nn.Linear(features, features)

    def forward(self, x):
        x = self.Dense_1(torch.relu(self.Dense_0(x)))
        return torch.sigmoid(x) if self.final_sigmoid else x


def bottleneck_channel_plan(in_channels: int, out_channels: int
                            ) -> List[Tuple[int, int]]:
    """(in, out) channels of each step of ProtoPNet's "bottleneck" add-on:
    halve the channels per step until ``out_channels`` is reached."""
    plan: List[Tuple[int, int]] = []
    cur = in_channels
    while cur > out_channels or not plan:
        plan.append((cur, max(out_channels, cur // 2)))
        cur = cur // 2
    return plan


class BottleneckAddOn(nn.Module):
    """ProtoPNet's "bottleneck" add-on: per step Linear ReLU Linear, ReLU
    between steps, Sigmoid at the end unless ``drop_final_activation``."""

    def __init__(self, in_channels: int, features: int,
                 drop_final_activation: bool = False):
        super().__init__()
        self.drop_final_activation = drop_final_activation
        self.n_layers = 0
        cin = in_channels
        for _, out in bottleneck_channel_plan(in_channels, features):
            self.add_module(f"Dense_{self.n_layers}", nn.Linear(cin, out))
            self.add_module(f"Dense_{self.n_layers + 1}", nn.Linear(out, out))
            self.n_layers += 2
            cin = out

    def forward(self, x):
        for i in range(0, self.n_layers, 2):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
            x = getattr(self, f"Dense_{i + 1}")(x)
            if i + 2 < self.n_layers:
                x = torch.relu(x)
            elif not self.drop_final_activation:
                x = torch.sigmoid(x)
        return x


class OccurrenceModule(nn.Module):
    """Linear(C->D) ReLU Linear(D->D/2) ReLU Linear(D/2->P, no bias).
    The caller applies |.|; ``enter`` takes the hidden features into the
    final Linear (under prototype tensor parallelism, ``copy_to_model``)."""

    def __init__(self, in_features: int, hidden: int, num_prototypes: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden // 2)
        self.Dense_2 = nn.Linear(hidden // 2, num_prototypes, bias=False)

    def forward(self, x, enter=None):
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x if enter is None else enter(x))


class PrototypeReadout(nn.Module):
    """Bias-free similarity -> logits layer."""

    def __init__(self, num_prototypes: int, num_classes: int):
        super().__init__()
        self.Dense_0 = nn.Linear(num_prototypes, num_classes, bias=False)

    def reset_incorrect_connection(self, incorrect_strength: float = 0.0):
        """The class-connection init; a zero kernel when P % K != 0, as the
        JAX init writes for pruned models (their weights come from a
        checkpoint)."""
        p, k = self.Dense_0.in_features, self.Dense_0.out_features
        with torch.no_grad():
            if p % k != 0:
                self.Dense_0.weight.zero_()
                return
            kernel = incorrect_connection_kernel(p, k, incorrect_strength)
            self.Dense_0.weight.copy_(torch.from_numpy(kernel.T))

    def forward(self, sim):
        return self.Dense_0(sim)
