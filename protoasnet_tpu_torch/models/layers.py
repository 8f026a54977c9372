"""Head layers over channels-last tensors: add-on, occurrence, readout.

The reference's 1x1x1 convs are ``nn.Linear`` over the trailing channel
axis, as the JAX package's ``Dense`` layers are. Sub-module names
(``Dense_0`` ...) follow the JAX parameter tree for the weight bridge.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["prototype_class_identity", "incorrect_connection_kernel",
           "AddOnLayers", "OccurrenceModule", "PrototypeReadout"]


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


class AddOnLayers(nn.Module):
    """Linear(C->D) ReLU Linear(D->D)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        self.Dense_1 = nn.Linear(features, features)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


class OccurrenceModule(nn.Module):
    """Linear(C->D) ReLU Linear(D->D/2) ReLU Linear(D/2->P, no bias).
    The caller applies |.|."""

    def __init__(self, in_features: int, hidden: int, num_prototypes: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, hidden // 2)
        self.Dense_2 = nn.Linear(hidden // 2, num_prototypes, bias=False)

    def forward(self, x):
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)


class PrototypeReadout(nn.Module):
    """Bias-free similarity -> logits layer."""

    def __init__(self, num_prototypes: int, num_classes: int):
        super().__init__()
        self.Dense_0 = nn.Linear(num_prototypes, num_classes, bias=False)

    def reset_incorrect_connection(self, incorrect_strength: float = 0.0):
        p, k = self.Dense_0.in_features, self.Dense_0.out_features
        kernel = incorrect_connection_kernel(p, k, incorrect_strength)
        with torch.no_grad():
            self.Dense_0.weight.copy_(torch.from_numpy(kernel.T))

    def forward(self, sim):
        return self.Dense_0(sim)
