"""Model builder: config dict -> ``PPNet`` or ``XProtoNet`` on a device.

The names of the JAX package's registry: ``ProtoPNet`` (PPNet),
``XProtoNet`` (image) and ``Video_XProtoNet``, on every trunk of
``backbones/__init__.py``'s ``BACKBONE_NAMES``: ``Video_XProtoNet`` takes
a video trunk (``resnet2p1d_18``, ``r3d_18``, the Video Swin-B
``swin3d_b`` or the MViTv2-B ``mvit_v2_b``, whose widths the name gives),
the other two a 2-D one
(ResNet-18/34/50/101/152, DenseNet-121/161/169/201, VGG-11/13/16/19 with
and without BatchNorm). Every key of the shipped configs' ``model``
section is read: ``model.remat`` checkpoints the R(2+1)D trunk's blocks in
training (``backbones/r2plus1d.py``; the other trunks ignore it, as the
JAX package's do).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from protoasnet_tpu_torch.models.backbones import MVIT_SPECS, SWIN3D_SPECS
from protoasnet_tpu_torch.models.protopnet import PPNet
from protoasnet_tpu_torch.models.xprotonet import XProtoNet
from protoasnet_tpu_torch.utils.config import parse_prototype_shape
from protoasnet_tpu_torch.utils.device import resolve_device

__all__ = ["build_model", "example_input", "MODEL_NAMES"]

MODEL_NAMES = ("ProtoPNet", "XProtoNet", "Video_XProtoNet")
_VIDEO_BACKBONES = (("resnet2p1d_18", "r3d_18") + tuple(SWIN3D_SPECS)
                    + tuple(MVIT_SPECS))
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(model_config: Dict[str, Any],
                device: Optional[Union[str, torch.device]] = None,
                seed: int = 0) -> nn.Module:
    """An eval-mode model on ``device`` (CUDA unless "cpu" is asked for),
    with random weights drawn from ``torch.Generator().manual_seed(seed)``.

    The configs' ``head_impl: "xla" | "pallas"`` is accepted; on the card
    the prototype head is always the CUDA kernel, on the CPU its plain
    version.
    """
    dev = resolve_device(device)
    name = model_config["name"]
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model name {name!r}; options: "
                         f"{MODEL_NAMES}")
    base_arch = model_config.get("base_architecture", "resnet18")
    head_impl = model_config.get("head_impl", "xla")
    if head_impl not in ("xla", "pallas"):
        raise ValueError(f"head_impl {head_impl!r}; options: xla, pallas")
    dtype_name = model_config.get("dtype", "float32")
    if dtype_name not in _DTYPES:
        raise ValueError(f"dtype {dtype_name!r}; options: {tuple(_DTYPES)}")
    shape = parse_prototype_shape(model_config["prototype_shape"])
    num_classes = int(model_config["num_classes"])
    if name == "ProtoPNet":
        model = PPNet(
            prototype_shape=shape, num_classes=num_classes,
            base_architecture=base_arch,
            prototype_activation_function=model_config.get(
                "prototype_activation_function", "log"),
            add_on_layers_type=model_config.get("add_on_layers_type",
                                                "bottleneck"),
            dtype=_DTYPES[dtype_name])
    else:
        if name == "Video_XProtoNet" and base_arch not in _VIDEO_BACKBONES:
            raise ValueError(f"Video_XProtoNet needs a video backbone "
                             f"{_VIDEO_BACKBONES}, not {base_arch!r}")
        model = XProtoNet(
            prototype_shape=shape, num_classes=num_classes,
            base_architecture=base_arch,
            backbone_last_layer_num=int(
                model_config.get("backbone_last_layer_num", -3)),
            dtype=_DTYPES[dtype_name],
            remat=bool(model_config.get("remat", False)))
    model.reset_parameters(torch.Generator().manual_seed(int(seed)))
    return model.to(dev).eval()


def example_input(model_config: Dict[str, Any], data_config: Dict[str, Any],
                  batch_size: int = 1,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> torch.Tensor:
    """A zero input batch of the configured size: clips (N, T, H, W, 3)
    for Video_XProtoNet, images (N, H, W, 3) for the other models."""
    name = model_config["name"]
    if name not in MODEL_NAMES:
        raise ValueError(f"unknown model name {name!r}; options: "
                         f"{MODEL_NAMES}")
    img = int(data_config.get("img_size", 224))
    dev = resolve_device(device)
    if name == "Video_XProtoNet":
        frames = int(data_config.get("frames", 1))
        return torch.zeros((batch_size, frames, img, img, 3), device=dev)
    return torch.zeros((batch_size, img, img, 3), device=dev)
