"""XProtoNet (ProtoASNet), image and video, PyTorch.

Forward contract, as the JAX package's ``XProtoNet``:
  forward                -> (logits (N,K), similarity01 (N,P), occurrence)
  push_forward           -> (roi_features (N,P,D), 1 - similarity01,
                             occurrence, logits)
  compute_occurrence_map -> occurrence
  occurrence_map_softmaxed(trunk features) -> the map softmaxed over
                           positions

Inputs are channels-last: clips (N, T, H, W, 3) for a video trunk, images
(N, H, W, 3) for a 2-D trunk. A convolutional trunk runs channels-first
(NCDHW or NCHW), its output permuted once to channels-last; a trunk that
is channels-last by nature (the Video Swin trunk, ``channels_last``) takes
the input as it is. So the head layers are Linears over channels and the
occurrence map comes back channels-last (N, [T',] H', W', P).

``dtype=torch.bfloat16`` runs the convs and Linears under bf16 autocast
(BatchNorm statistics stay fp32); the prototype head takes the bf16
occurrence and features and computes in fp32.

Under prototype tensor parallelism (``prototype_shard``, set by
``parallel.mesh.prototype_param_shardings``) each model rank holds P/m
prototypes, the occurrence module's final rows for them and the readout's
columns: the replicated features enter the head through ``copy_to_model``
(their gradient summed over ``model``), each rank computes its (N, S, P/m)
occurrence maps and runs the ROI head on its own prototypes (the CUDA
kernel at P/m on the card), its readout's partial logits are summed over
``model`` (``reduce_from_model``), and ``forward`` returns the whole (N, P)
similarities (``gather_from_model``). The occurrence maps and
``push_forward``'s ROI features and distances stay the rank's own.
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
from protoasnet_tpu_torch.parallel.mesh import (PrototypeShard, copy_to_model,
                                                gather_from_model,
                                                reduce_from_model)

__all__ = ["XProtoNet"]


class XProtoNet(nn.Module):
    def __init__(self, prototype_shape: Sequence[int], num_classes: int,
                 base_architecture: str = "resnet2p1d_18",
                 backbone_last_layer_num: int = -3,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        p, d = int(prototype_shape[0]), int(prototype_shape[1])
        self.prototype_shape = tuple(int(s) for s in prototype_shape)
        self.num_classes = int(num_classes)
        self.dtype = dtype
        # None: the CUDA kernel on the card, the plain head on the CPU;
        # "torch": the plain head everywhere (reference runs only)
        self.head_impl: Optional[str] = None
        self.cnn_backbone = make_backbone(
            base_architecture, last_layer_num=backbone_last_layer_num,
            remat=remat)
        c = self.cnn_backbone.out_channels
        self.add_on_layers = AddOnLayers(c, d)
        self.occurrence_module = OccurrenceModule(c, d, p)
        self.prototype_vectors = nn.Parameter(torch.empty(p, d))
        # set by reset_parameters (builder) or from a checkpoint
        self.last_layer = PrototypeReadout(p, self.num_classes)

    @property
    def prototype_shard(self) -> Optional[PrototypeShard]:
        """This model rank's block of P (``prototype_vectors``' record,
        set by ``parallel.mesh.prototype_param_shardings``), or None."""
        return getattr(self.prototype_vectors, "prototype_shard", None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init, drawn from ``generator`` (a CPU
        generator; call before moving the model to the card): kaiming-normal
        fan-out convs and Linears, zero biases, unit BN, U(0,1) prototypes,
        readout at incorrect-connection strength 0; a trunk with its own
        ``reset_parameters`` (Swin3D: torchvision's) then draws its own."""
        init_weights_(self, generator)
        if hasattr(self.cnn_backbone, "reset_parameters"):
            self.cnn_backbone.reset_parameters(generator)  # its own init
        self.prototype_vectors.uniform_(0.0, 1.0, generator=generator)
        self.last_layer.reset_incorrect_connection(0.0)

    def _autocast(self, x: torch.Tensor):
        return bf16_autocast(x, self.dtype)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """(N, [T,] H, W, 3) -> channels-last trunk output
        (N, [T',] H', W', C)."""
        if getattr(self.cnn_backbone, "channels_last", False):
            return self.cnn_backbone(x)
        nd = x.dim()
        fmap = self.cnn_backbone(x.permute(0, nd - 1, *range(1, nd - 1)))
        return fmap.permute(0, *range(2, nd), 1).contiguous()

    def _enter(self, t: torch.Tensor) -> torch.Tensor:
        return copy_to_model(t, self.prototype_shard)

    def _occurrence(self, fmap: torch.Tensor) -> torch.Tensor:
        return torch.abs(self.occurrence_module(fmap, enter=self._enter))

    def _heads(self, x: torch.Tensor):
        """(roi, sim, occ, logits) with the rank's prototypes' roi, sim and
        occurrence maps and the whole logits."""
        with self._autocast(x):
            fmap = self._features(x)
            feat = self.add_on_layers(fmap)
            occ = self._occurrence(fmap)
        roi, sim = roi_cosine_head(occ, self._enter(feat),
                                   self.prototype_vectors,
                                   impl=self.head_impl)
        with self._autocast(x):
            logits = reduce_from_model(self.last_layer(sim),
                                       self.prototype_shard)
        return roi, sim, occ, logits

    def forward(self, x: torch.Tensor):
        _, sim, occ, logits = self._heads(x)
        return logits, gather_from_model(sim, 1, self.prototype_shard), occ

    def compute_occurrence_map(self, x: torch.Tensor) -> torch.Tensor:
        with self._autocast(x):
            return self._occurrence(self._features(x))

    def occurrence_map_softmaxed(self, fmap: torch.Tensor) -> torch.Tensor:
        """The occurrence map softmax-normalised over the positions, per
        prototype (the reference's ``get_occurence_map_softmaxed``, which
        its training does not use). Takes trunk features, channels-last
        (N, [T',] H', W', C), as the JAX package's does; returns (N, [T',]
        H', W', P) in fp32."""
        with self._autocast(fmap):
            occ = self.occurrence_module(fmap, enter=self._enter)
        n, p = occ.shape[0], occ.shape[-1]
        return torch.softmax(occ.float().reshape(n, -1, p), dim=1).reshape(
            occ.shape)

    def push_forward(self, x: torch.Tensor):
        roi, sim, occ, logits = self._heads(x)
        return roi, 1.0 - sim, occ, logits
