"""Classic ProtoPNet (PPNet) baseline, PyTorch.

Backbone features -> add-on (``"bottleneck"`` with a final Sigmoid, or
``"regular"``: Linear ReLU Linear Sigmoid) -> squared L2 distance of every
patch to every prototype -> global min pool -> log or linear similarity
-> bias-free readout (incorrect-connection strength -0.5).

Forward contract, as the JAX package's ``PPNet``:
  forward      -> (logits (N,K), min_distances (N,P))
  push_forward -> (conv_features (N,H',W',D), distances (N,H',W',P))

Input images are channels-last (N, H, W, 3); the trunk runs NCHW and its
output is permuted once to channels-last. 1x1 prototypes (every shipped
config) go through the fused distance + min head (``ops/l2_min.py``: the
CUDA kernel on the card, its plain version on the CPU); other prototype
sizes through ``ops/l2conv.py``. ``dtype=torch.bfloat16`` runs the trunk
and Linears under bf16 autocast; the distances are computed in fp32.

Training differentiates through the same head: on the card the kernel's
autograd Function (``ops/l2_min_cuda.py::L2MinFunction``, the gradient of
the JAX package's Pallas head, a tied minimum's cotangent to its first
position), on the CPU torch's autograd of the plain head (a tie's
cotangent split evenly, as JAX's default "xla" head does); other
prototype sizes through torch's autograd of ``l2_patch_distances``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from protoasnet_tpu_torch.models.backbones import make_backbone
from protoasnet_tpu_torch.models.layers import (AddOnLayers, BottleneckAddOn,
                                                PrototypeReadout,
                                                bf16_autocast, init_weights_)
from protoasnet_tpu_torch.ops.l2_min import l2_min_head
from protoasnet_tpu_torch.ops.l2conv import l2_patch_distances

__all__ = ["PPNet", "EPSILON"]

EPSILON = 1e-4
_ADD_ONS = ("bottleneck", "regular")
_ACTIVATIONS = ("log", "linear")


class PPNet(nn.Module):
    def __init__(self, prototype_shape: Sequence[int], num_classes: int,
                 base_architecture: str = "resnet18",
                 prototype_activation_function: str = "log",
                 add_on_layers_type: str = "bottleneck",
                 incorrect_strength: float = -0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(prototype_shape) != 4:
            raise ValueError(f"prototype_shape {tuple(prototype_shape)} must "
                             f"be (P, D, kh, kw)")
        if add_on_layers_type not in _ADD_ONS:
            raise ValueError(f"add_on_layers_type {add_on_layers_type!r}; "
                             f"options: {_ADD_ONS}")
        if prototype_activation_function not in _ACTIVATIONS:
            raise ValueError(f"prototype_activation_function "
                             f"{prototype_activation_function!r}; options: "
                             f"{_ACTIVATIONS}")
        p, d, kh, kw = (int(s) for s in prototype_shape)
        self.prototype_shape = (p, d, kh, kw)
        self.num_classes = int(num_classes)
        self.prototype_activation_function = prototype_activation_function
        self.incorrect_strength = float(incorrect_strength)
        self.dtype = dtype
        # None: the CUDA kernel on the card, the plain head on the CPU;
        # "torch": the plain head everywhere (reference runs only)
        self.head_impl: Optional[str] = None
        self.features = make_backbone(base_architecture)
        c = self.features.out_channels
        if add_on_layers_type == "bottleneck":
            self.add_on_layers = BottleneckAddOn(c, d)
        else:
            self.add_on_layers = AddOnLayers(c, d, final_sigmoid=True)
        # (P, kh, kw, D) as in the JAX tree; set by reset_parameters
        self.prototype_vectors = nn.Parameter(torch.empty(p, kh, kw, d))
        self.last_layer = PrototypeReadout(p, self.num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init, drawn from ``generator`` (a CPU
        generator; call before moving the model to the card): kaiming-normal
        fan-out convs and Linears, zero biases, unit BN, U(0,1) prototypes,
        readout at the incorrect-connection strength."""
        init_weights_(self, generator)
        self.prototype_vectors.uniform_(0.0, 1.0, generator=generator)
        self.last_layer.reset_incorrect_connection(self.incorrect_strength)

    def _autocast(self, x: torch.Tensor):
        return bf16_autocast(x, self.dtype)

    def conv_features(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> channels-last add-on output (N, H', W', D)."""
        with self._autocast(x):
            fmap = self.features(x.permute(0, 3, 1, 2))
            return self.add_on_layers(fmap.permute(0, 2, 3, 1))

    def distance_2_similarity(self, distances: torch.Tensor) -> torch.Tensor:
        if self.prototype_activation_function == "log":
            return torch.log((distances + 1.0) / (distances + EPSILON))
        return -distances

    def _distances(self, conv: torch.Tensor):
        """(distances (N, H', W', P), min_distances (N, P))."""
        if self.prototype_shape[2:] == (1, 1):
            return l2_min_head(conv, self.prototype_vectors,
                               impl=self.head_impl)
        dist = l2_patch_distances(conv, self.prototype_vectors)
        return dist, dist.amin(dim=(1, 2))

    def forward(self, x: torch.Tensor):
        _, min_distances = self._distances(self.conv_features(x))
        activations = self.distance_2_similarity(min_distances)
        with self._autocast(x):
            logits = self.last_layer(activations)
        return logits, min_distances

    def push_forward(self, x: torch.Tensor):
        conv = self.conv_features(x)
        distances, _ = self._distances(conv)
        return conv, distances
