"""Model builder: config dict -> ``XProtoNet`` on a device.

This slice builds the flagship ``Video_XProtoNet`` with the
``resnet2p1d_18`` trunk; other models raise ``NotImplementedError`` until
they are ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from protoasnet_tpu_torch.models.xprotonet import XProtoNet
from protoasnet_tpu_torch.utils.config import parse_prototype_shape
from protoasnet_tpu_torch.utils.device import resolve_device

__all__ = ["build_model", "example_input", "MODEL_NAMES"]

MODEL_NAMES = ("Video_XProtoNet",)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(model_config: Dict[str, Any],
                device: Optional[Union[str, torch.device]] = None,
                seed: int = 0) -> XProtoNet:
    """An eval-mode model on ``device`` (CUDA unless "cpu" is asked for),
    with random weights drawn from ``torch.Generator().manual_seed(seed)``.

    The configs' ``head_impl: "xla" | "pallas"`` is accepted; on the card
    the head is always the CUDA kernel, on the CPU its plain version.
    """
    dev = resolve_device(device)
    name = model_config["name"]
    base_arch = model_config.get("base_architecture", "resnet18")
    if name not in MODEL_NAMES or base_arch != "resnet2p1d_18":
        raise NotImplementedError(
            f"model {name!r} with backbone {base_arch!r} is not ported yet; "
            f"this slice serves Video_XProtoNet/resnet2p1d_18 (ROADMAP.md)")
    head_impl = model_config.get("head_impl", "xla")
    if head_impl not in ("xla", "pallas"):
        raise ValueError(f"head_impl {head_impl!r}; options: xla, pallas")
    dtype_name = model_config.get("dtype", "float32")
    if dtype_name not in _DTYPES:
        raise ValueError(f"dtype {dtype_name!r}; options: {tuple(_DTYPES)}")
    model = XProtoNet(
        prototype_shape=parse_prototype_shape(model_config["prototype_shape"]),
        num_classes=int(model_config["num_classes"]),
        base_architecture=base_arch,
        backbone_last_layer_num=int(
            model_config.get("backbone_last_layer_num", -3)),
        dtype=_DTYPES[dtype_name],
    )
    model.reset_parameters(torch.Generator().manual_seed(int(seed)))
    return model.to(dev).eval()


def example_input(model_config: Dict[str, Any], data_config: Dict[str, Any],
                  batch_size: int = 1,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> torch.Tensor:
    """A zero clip batch (N, T, H, W, 3) of the configured size."""
    if model_config["name"] not in MODEL_NAMES:
        raise NotImplementedError(f"model {model_config['name']!r} is not "
                                  f"ported yet (ROADMAP.md)")
    img = int(data_config.get("img_size", 224))
    frames = int(data_config.get("frames", 1))
    return torch.zeros((batch_size, frames, img, img, 3),
                       device=resolve_device(device))
