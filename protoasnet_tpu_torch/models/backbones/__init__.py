"""Backbone factory: the flagship's R(2+1)D-18 video trunk (with
``remat``, its blocks checkpointed in training) and the 2-D ResNet trunks
(18/34/50/101/152). DenseNet, VGG and r3d_18 are still to port."""

from protoasnet_tpu_torch.models.backbones.r2plus1d import R2Plus1D18
from protoasnet_tpu_torch.models.backbones.resnet2d import (RESNET_SPECS,
                                                            ResNetFeatures)

__all__ = ["make_backbone", "R2Plus1D18", "ResNetFeatures", "RESNET_SPECS"]


def make_backbone(name: str, last_layer_num: int = -3, remat: bool = False):
    """Architecture name -> trunk module (with ``.out_channels``).
    ``last_layer_num`` cuts the video trunk and ``remat`` checkpoints its
    blocks; the 2-D trunks ignore both, as the JAX package's do."""
    if name == "resnet2p1d_18":
        return R2Plus1D18(last_layer_num=last_layer_num, remat=remat)
    if name in RESNET_SPECS:
        return ResNetFeatures(name)
    raise NotImplementedError(
        f"backbone {name!r} is not ported yet; see ROADMAP.md (section 1) "
        f"for the order in which the other backbones are ported")
