"""``pretrained: true``: load local torchvision trunk weights, if any.

The weights are looked for in ``$PROTOASNET_PRETRAINED_DIR``,
``./pretrained_models`` and ``~/pretrained_models`` as
``<arch>.pth``/``.pt``/``-weights.pth`` (or any ``<arch>*.pth``), as the
JAX package does; nothing is ever downloaded. Without a file the model
keeps its random init (with a warning). torchvision's names are renamed to
the port's: ``r2plus1d_18`` for ``resnet2p1d_18``, the ResNets for the 2-D
trunks; the head stays as initialised.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, Optional

import torch
from torch import nn

__all__ = ["find_weights", "torchvision_to_port", "load_pretrained_backbone"]


def find_weights(arch: str) -> Optional[str]:
    roots = [os.environ.get("PROTOASNET_PRETRAINED_DIR", ""),
             "pretrained_models", os.path.expanduser("~/pretrained_models")]
    names = [f"{arch}.pth", f"{arch}.pt", f"{arch}-weights.pth"]
    for root in roots:
        if not root:
            continue
        for n in names:
            p = os.path.join(root, n)
            if os.path.exists(p):
                return p
        if os.path.isdir(root):
            for f in sorted(os.listdir(root)):
                if f.startswith(arch) and f.endswith((".pth", ".pt")):
                    return os.path.join(root, f)
    return None


# torchvision r2plus1d_18 -> the port's R2Plus1D18 (``stem.2``/``.5`` and
# ``conv*.0.2`` are ReLUs)
_R2P1D = [
    (r"^stem\.0\.", "stem_spatial."), (r"^stem\.1\.", "stem_bn1."),
    (r"^stem\.3\.", "stem_temporal."), (r"^stem\.4\.", "stem_bn2."),
    (r"^layer(\d)\.(\d)\.conv(\d)\.0\.0\.", r"layer\1_\2.conv\3.spatial."),
    (r"^layer(\d)\.(\d)\.conv(\d)\.0\.1\.", r"layer\1_\2.conv\3.bn_mid."),
    (r"^layer(\d)\.(\d)\.conv(\d)\.0\.3\.", r"layer\1_\2.conv\3.temporal."),
    (r"^layer(\d)\.(\d)\.conv(\d)\.1\.", r"layer\1_\2.bn\3."),
    (r"^layer(\d)\.(\d)\.downsample\.0\.", r"layer\1_\2.downsample_conv."),
    (r"^layer(\d)\.(\d)\.downsample\.1\.", r"layer\1_\2.downsample_bn."),
]
# torchvision resnet* -> the port's ResNetFeatures
_RESNET = [
    (r"^layer(\d)\.(\d+)\.conv(\d)\.",
     lambda m: f"layer{m[1]}_{m[2]}.Conv_{int(m[3]) - 1}."),
    (r"^layer(\d)\.(\d+)\.bn(\d)\.",
     lambda m: f"layer{m[1]}_{m[2]}.BatchNorm_{int(m[3]) - 1}."),
    (r"^layer(\d)\.(\d+)\.downsample\.0\.", r"layer\1_\2.downsample_conv."),
    (r"^layer(\d)\.(\d+)\.downsample\.1\.", r"layer\1_\2.downsample_bn."),
]


def torchvision_to_port(sd: Dict[str, Any], arch: str,
                        keep: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """torchvision's state dict renamed to the trunk's keys; keys the trunk
    does not have (the classifier, stages past the cut) are dropped."""
    rules = _R2P1D if arch == "resnet2p1d_18" else _RESNET
    out = {}
    for k, v in sd.items():
        for pat, rep in rules:
            if re.match(pat, k):
                k = re.sub(pat, rep, k)
                break
        if k in keep:
            out[k] = v
    return out


def load_pretrained_backbone(model: nn.Module,
                             model_config: Dict[str, Any]) -> bool:
    """Fill the trunk from local torchvision weights; False (the random
    init stays) when there are none."""
    arch = model_config.get("base_architecture", "resnet18")
    path = find_weights(arch)
    if path is None:
        logging.warning(f"pretrained=True but no local weights for {arch!r} "
                        f"(set PROTOASNET_PRETRAINED_DIR); keeping the "
                        f"random init")
        return False
    trunk = model.cnn_backbone if hasattr(model, "cnn_backbone") \
        else model.features
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    target = trunk.state_dict()
    renamed = torchvision_to_port(sd, arch, target)
    missing = [k for k in target if k not in renamed
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"pretrained {arch} weights at {path} lack "
                         f"{missing[:8]}")
    trunk.load_state_dict(renamed, strict=False)
    logging.info(f"loaded pretrained {arch} weights from {path}")
    return True
