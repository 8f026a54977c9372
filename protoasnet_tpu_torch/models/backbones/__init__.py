"""Backbone zoo and factory: the JAX package's ``BACKBONE_NAMES`` (the
flagship's R(2+1)D-18 video trunk (with ``remat``, its blocks checkpointed
in training), the plain r3d_18 video trunk, and the 2-D ResNet
(18/34/50/101/152), DenseNet (121/161/169/201) and VGG (11/13/16/19, with
and without BatchNorm) trunks), and the port's own transformer trunks,
which the JAX package does not have: Video Swin-B, ``swin3d_b``
(``swin3d.py``), and MViTv2-B, ``mvit_v2_b`` (``mvit.py``), both
channels-last; ``refuse_transformer_trunk`` names the paths the port does
not take on either."""

from protoasnet_tpu_torch.models.backbones.densenet import (DENSENET_SPECS,
                                                            DenseNetFeatures)
from protoasnet_tpu_torch.models.backbones.mvit import MVIT_SPECS, MViT
from protoasnet_tpu_torch.models.backbones.r2plus1d import R2Plus1D18
from protoasnet_tpu_torch.models.backbones.r3d import R3D18
from protoasnet_tpu_torch.models.backbones.resnet2d import (RESNET_SPECS,
                                                            ResNetFeatures)
from protoasnet_tpu_torch.models.backbones.swin3d import (SWIN3D_SPECS,
                                                          SwinTransformer3d)
from protoasnet_tpu_torch.models.backbones.vgg import VGG_CFGS, VGGFeatures

__all__ = ["make_backbone", "BACKBONE_NAMES", "R2Plus1D18", "R3D18",
           "ResNetFeatures", "DenseNetFeatures", "VGGFeatures",
           "SwinTransformer3d", "MViT", "RESNET_SPECS", "DENSENET_SPECS",
           "VGG_CFGS", "SWIN3D_SPECS", "MVIT_SPECS",
           "refuse_transformer_trunk"]

BACKBONE_NAMES = (
    tuple(RESNET_SPECS)
    + tuple(DENSENET_SPECS)
    + tuple(VGG_CFGS)
    + tuple(f"{v}_bn" for v in VGG_CFGS)
    + ("resnet2p1d_18", "r3d_18")
    + tuple(SWIN3D_SPECS)
    + tuple(MVIT_SPECS)
)

# each transformer trunk and how a refusal names it
_TRANSFORMER_TRUNKS = ((SwinTransformer3d, "a Swin3D trunk", SWIN3D_SPECS),
                       (MViT, "an MViTv2 trunk", MVIT_SPECS))


def make_backbone(name: str, last_layer_num: int = -3, remat: bool = False):
    """Architecture name -> trunk module (with ``.out_channels`` and, for
    the 2-D trunks, ``.conv_info()``). ``last_layer_num`` cuts the video
    trunks (a Swin3D or MViT trunk at -3 or -2 only) and ``remat``
    checkpoints R(2+1)D's blocks; the other trunks ignore them, as the JAX
    package's do."""
    if name in MVIT_SPECS:
        return MViT(**MVIT_SPECS[name], last_layer_num=last_layer_num)
    if name in SWIN3D_SPECS:
        return SwinTransformer3d(**SWIN3D_SPECS[name],
                                 last_layer_num=last_layer_num)
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


def refuse_transformer_trunk(model, what: str) -> None:
    """Raise for a path the port does not take on a transformer trunk
    (Swin3D or MViTv2): ``what`` is the path."""
    for m in model.modules():
        for kind, article, specs in _TRANSFORMER_TRUNKS:
            if isinstance(m, kind):
                raise NotImplementedError(
                    f"{what} is not supported on {article} "
                    f"({', '.join(specs)})")
