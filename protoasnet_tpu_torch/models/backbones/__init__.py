"""Backbone factory. This slice ports the flagship's R(2+1)D-18 trunk only."""

from protoasnet_tpu_torch.models.backbones.r2plus1d import R2Plus1D18

__all__ = ["make_backbone", "R2Plus1D18"]


def make_backbone(name: str, last_layer_num: int = -3):
    if name == "resnet2p1d_18":
        return R2Plus1D18(last_layer_num=last_layer_num)
    raise NotImplementedError(
        f"backbone {name!r} is not ported yet; see ROADMAP.md (section 1) "
        f"for the order in which the other backbones are ported")
