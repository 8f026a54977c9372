"""XProtoNet (ProtoASNet), image and video, PyTorch.

Forward contract, as the JAX package's ``XProtoNet``:
  forward                -> (logits (N,K), similarity01 (N,P), occurrence)
  push_forward           -> (roi_features (N,P,D), 1 - similarity01,
                             occurrence, logits)
  compute_occurrence_map -> occurrence

Inputs are channels-last: clips (N, T, H, W, 3) for a video trunk, images
(N, H, W, 3) for a 2-D trunk. The trunk runs channels-first (NCDHW or
NCHW); its output is permuted once to channels-last, so the head layers
are Linears over channels and the occurrence map comes back channels-last
(N, [T',] H', W', P).

``dtype=torch.bfloat16`` runs the convs and Linears under bf16 autocast
(BatchNorm statistics stay fp32); the prototype head takes the bf16
occurrence and features and computes in fp32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from protoasnet_tpu_torch.models.backbones import make_backbone
from protoasnet_tpu_torch.models.layers import (AddOnLayers, OccurrenceModule,
                                                PrototypeReadout,
                                                bf16_autocast, init_weights_)
from protoasnet_tpu_torch.ops.roi_cosine import roi_cosine_head

__all__ = ["XProtoNet"]


class XProtoNet(nn.Module):
    def __init__(self, prototype_shape: Sequence[int], num_classes: int,
                 base_architecture: str = "resnet2p1d_18",
                 backbone_last_layer_num: int = -3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        p, d = int(prototype_shape[0]), int(prototype_shape[1])
        self.prototype_shape = tuple(int(s) for s in prototype_shape)
        self.num_classes = int(num_classes)
        self.dtype = dtype
        # None: the CUDA kernel on the card, the plain head on the CPU;
        # "torch": the plain head everywhere (reference runs only)
        self.head_impl: Optional[str] = None
        self.cnn_backbone = make_backbone(base_architecture,
                                          last_layer_num=backbone_last_layer_num)
        c = self.cnn_backbone.out_channels
        self.add_on_layers = AddOnLayers(c, d)
        self.occurrence_module = OccurrenceModule(c, d, p)
        self.prototype_vectors = nn.Parameter(torch.empty(p, d))
        # set by reset_parameters (builder) or from a checkpoint
        self.last_layer = PrototypeReadout(p, self.num_classes)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init, drawn from ``generator`` (a CPU
        generator; call before moving the model to the card): kaiming-normal
        fan-out convs and Linears, zero biases, unit BN, U(0,1) prototypes,
        readout at incorrect-connection strength 0."""
        init_weights_(self, generator)
        self.prototype_vectors.uniform_(0.0, 1.0, generator=generator)
        self.last_layer.reset_incorrect_connection(0.0)

    def _autocast(self, x: torch.Tensor):
        return bf16_autocast(x, self.dtype)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """(N, [T,] H, W, 3) -> channels-last trunk output
        (N, [T',] H', W', C)."""
        nd = x.dim()
        fmap = self.cnn_backbone(x.permute(0, nd - 1, *range(1, nd - 1)))
        return fmap.permute(0, *range(2, nd), 1).contiguous()

    def _heads(self, x: torch.Tensor):
        with self._autocast(x):
            fmap = self._features(x)
            feat = self.add_on_layers(fmap)
            occ = torch.abs(self.occurrence_module(fmap))
        roi, sim = roi_cosine_head(occ, feat, self.prototype_vectors,
                                   impl=self.head_impl)
        with self._autocast(x):
            logits = self.last_layer(sim)
        return roi, sim, occ, logits

    def forward(self, x: torch.Tensor):
        _, sim, occ, logits = self._heads(x)
        return logits, sim, occ

    def compute_occurrence_map(self, x: torch.Tensor) -> torch.Tensor:
        with self._autocast(x):
            return torch.abs(self.occurrence_module(self._features(x)))

    def push_forward(self, x: torch.Tensor):
        roi, sim, occ, logits = self._heads(x)
        return roi, 1.0 - sim, occ, logits
