"""Backbone zoo and factory, the JAX package's ``BACKBONE_NAMES``: the
flagship's R(2+1)D-18 video trunk (with ``remat``, its blocks checkpointed
in training), the plain r3d_18 video trunk, and the 2-D ResNet
(18/34/50/101/152), DenseNet (121/161/169/201) and VGG (11/13/16/19, with
and without BatchNorm) trunks."""

from protoasnet_tpu_torch.models.backbones.densenet import (DENSENET_SPECS,
                                                            DenseNetFeatures)
from protoasnet_tpu_torch.models.backbones.r2plus1d import R2Plus1D18
from protoasnet_tpu_torch.models.backbones.r3d import R3D18
from protoasnet_tpu_torch.models.backbones.resnet2d import (RESNET_SPECS,
                                                            ResNetFeatures)
from protoasnet_tpu_torch.models.backbones.vgg import VGG_CFGS, VGGFeatures

__all__ = ["make_backbone", "BACKBONE_NAMES", "R2Plus1D18", "R3D18",
           "ResNetFeatures", "DenseNetFeatures", "VGGFeatures",
           "RESNET_SPECS", "DENSENET_SPECS", "VGG_CFGS"]

BACKBONE_NAMES = (
    tuple(RESNET_SPECS)
    + tuple(DENSENET_SPECS)
    + tuple(VGG_CFGS)
    + tuple(f"{v}_bn" for v in VGG_CFGS)
    + ("resnet2p1d_18", "r3d_18")
)


def make_backbone(name: str, last_layer_num: int = -3, remat: bool = False):
    """Architecture name -> trunk module (with ``.out_channels`` and, for
    the 2-D trunks, ``.conv_info()``). ``last_layer_num`` cuts the video
    trunks and ``remat`` checkpoints R(2+1)D's blocks; the other trunks
    ignore them, as the JAX package's do."""
    if name == "resnet2p1d_18":
        return R2Plus1D18(last_layer_num=last_layer_num, remat=remat)
    if name == "r3d_18":
        return R3D18(last_layer_num=last_layer_num)
    if name in RESNET_SPECS:
        return ResNetFeatures(name)
    if name in DENSENET_SPECS:
        return DenseNetFeatures(name)
    if name in VGG_CFGS or (name.endswith("_bn") and name[:-3] in VGG_CFGS):
        return VGGFeatures(name)
    raise ValueError(f"Unknown base_architecture {name!r}; options: "
                     f"{BACKBONE_NAMES}")
