"""Trained checkpoints of the reference PyTorch ProtoASNet, both ways
(the JAX package's ``models/migrate.py`` without JAX).

The reference saves {epoch, iteration, state_dict, optimizer}; its model
keys follow Video_XProtoNet / XProtoNet / PPNet: the R(2+1)D trunk as
``cnn_backbone.backbone.{0: stem, i: layer i}`` (torchvision's children
in a Sequential), a ResNet trunk under ``cnn_backbone.`` or ``features.``
with torchvision's keys, a Video Swin trunk under ``cnn_backbone.`` with
torchvision's ``swin3d_b`` keys (``patch_embed.*``, ``features.*``; the
port's names are the same, and ``relative_position_index``, which the
window gives, is not carried), an MViTv2 trunk under ``cnn_backbone.``
with torchvision's ``mvit_v2_*`` keys (``conv_proj.*``,
``pos_encoding.class_token``, ``blocks.*``; the port's names are the
same), 1x1 convs in numbered Sequentials
(``add_on_layers.{0,2}``, ``occurrence_module.{0,2,4}``; PPNet's add-on
convs at its Sequential's conv indices), ``prototype_vectors`` with
trailing unit dims (PPNet's (P, D, kh, kw)), ``last_layer.weight`` and a
constant all-ones ``ones`` parameter at the prototype shape.

``convert_reference_state_dict`` renames those keys straight to the
port's ``state_dict`` keys (the trunk with ``models/pretrained.py``'s
torchvision renames, the 1x1 convs to Linears, PPNet's prototypes to
channels-last); ``export_reference_state_dict`` is its exact inverse,
``ones`` included, so a model trained with the port loads strictly into
the reference. Conv and BatchNorm tensors keep torch's layout both ways.

CLI (the reference's file is a pickle: it is loaded with
``weights_only=False``, so convert only files you trust):

    python -m protoasnet_tpu_torch.models.migrate <ref.pth> <out.pkl> \\
        --config_path=<yml>

writes what the JAX package's CLI writes, {epoch, iteration, params,
batch_stats} with the JAX layout's numpy trees, which either package's
agent loads through ``--model.checkpoint_path=<out.pkl>``;

    python -m protoasnet_tpu_torch.models.migrate <ckpt> <out.pth> \\
        --config_path=<yml> --to_reference

writes the reference's {epoch, iteration, state_dict, optimizer: None}
from the port's own checkpoint (``last.ckpt``), a JAX package ``.ckpt``
or a migrated ``.pkl``.
"""

from __future__ import annotations

import argparse
import logging
import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from protoasnet_tpu_torch.models.backbones import MVIT_SPECS, SWIN3D_SPECS
from protoasnet_tpu_torch.models.from_jax import (jax_to_state_dict,
                                                  state_dict_to_jax)
from protoasnet_tpu_torch.models.pretrained import _R2P1D, _RESNET
from protoasnet_tpu_torch.utils.config import parse_prototype_shape

__all__ = ["convert_reference_state_dict", "export_reference_state_dict",
           "main"]

_R2P1D_WRAPPER = "cnn_backbone.backbone."
# the port's R2Plus1D18 / ResNetFeatures -> torchvision's keys
_R2P1D_INV = [
    (r"^stem_spatial\.", "stem.0."), (r"^stem_bn1\.", "stem.1."),
    (r"^stem_temporal\.", "stem.3."), (r"^stem_bn2\.", "stem.4."),
    (r"^layer(\d)_(\d)\.conv(\d)\.spatial\.", r"layer\1.\2.conv\3.0.0."),
    (r"^layer(\d)_(\d)\.conv(\d)\.bn_mid\.", r"layer\1.\2.conv\3.0.1."),
    (r"^layer(\d)_(\d)\.conv(\d)\.temporal\.", r"layer\1.\2.conv\3.0.3."),
    (r"^layer(\d)_(\d)\.bn(\d)\.", r"layer\1.\2.conv\3.1."),
    (r"^layer(\d)_(\d)\.downsample_conv\.", r"layer\1.\2.downsample.0."),
    (r"^layer(\d)_(\d)\.downsample_bn\.", r"layer\1.\2.downsample.1."),
]
_RESNET_INV = [
    (r"^layer(\d)_(\d+)\.Conv_(\d)\.",
     lambda m: f"layer{m[1]}.{m[2]}.conv{int(m[3]) + 1}."),
    (r"^layer(\d)_(\d+)\.BatchNorm_(\d)\.",
     lambda m: f"layer{m[1]}.{m[2]}.bn{int(m[3]) + 1}."),
    (r"^layer(\d)_(\d+)\.downsample_conv\.", r"layer\1.\2.downsample.0."),
    (r"^layer(\d)_(\d+)\.downsample_bn\.", r"layer\1.\2.downsample.1."),
]
# the reference's 1x1-conv Sequential indices -> the port's Linears
_XPROTO_HEADS = {"add_on_layers": (0, 2), "occurrence_module": (0, 2, 4)}


def _tensor(v: Any) -> torch.Tensor:
    return (v.detach().cpu() if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v)))  # 0-d stays 0-d


def _rename(key: str, rules) -> str:
    for pat, rep in rules:
        if re.match(pat, key):
            return re.sub(pat, rep, key)
    return key


def _with_prefix(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _trunk(name: str) -> str:
    return "features" if name == "ProtoPNet" else "cnn_backbone"


def _conv_indices(sd: Dict[str, Any], module: str) -> List[int]:
    return sorted({int(k.split(".")[1]) for k in sd
                   if k.startswith(module + ".") and k.endswith(".weight")})


def convert_reference_state_dict(sd: Dict[str, Any],
                                 model_config: Dict[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """A reference model's state_dict -> the port's state_dict entries
    (every parameter and BN buffer of ``build_model(model_config)``)."""
    name = model_config["name"]
    arch = model_config.get("base_architecture", "resnet18")
    out: Dict[str, torch.Tensor] = {}
    trunk = _trunk(name)
    if arch == "resnet2p1d_18":
        for k, v in _with_prefix(sd, _R2P1D_WRAPPER).items():
            idx, rest = k.split(".", 1)
            tv = f"stem.{rest}" if idx == "0" else f"layer{idx}.{rest}"
            out[f"{trunk}.{_rename(tv, _R2P1D)}"] = _tensor(v)
    elif arch in SWIN3D_SPECS or arch in MVIT_SPECS:
        for k, v in _with_prefix(sd, "cnn_backbone.").items():
            if not k.endswith("relative_position_index"):
                out[f"{trunk}.{k}"] = _tensor(v)
    else:
        prefix = "cnn_backbone." if any(
            k.startswith("cnn_backbone.") for k in sd) else "features."
        for k, v in _with_prefix(sd, prefix).items():
            out[f"{trunk}.{_rename(k, _RESNET)}"] = _tensor(v)

    if name in ("XProtoNet", "Video_XProtoNet"):
        heads = dict(_XPROTO_HEADS)
        pv = _tensor(sd["prototype_vectors"])
        out["prototype_vectors"] = pv.reshape(pv.shape[0], pv.shape[1])
    elif name == "ProtoPNet":
        heads = {"add_on_layers": _conv_indices(sd, "add_on_layers")}
        out["prototype_vectors"] = _tensor(
            sd["prototype_vectors"]).permute(0, 2, 3, 1).contiguous()
    else:
        raise ValueError(f"Unknown model name {name!r}")
    for module, indices in heads.items():
        for i, idx in enumerate(indices):
            w = _tensor(sd[f"{module}.{idx}.weight"])
            out[f"{module}.Dense_{i}.weight"] = w.reshape(w.shape[0],
                                                          w.shape[1])
            if f"{module}.{idx}.bias" in sd:
                out[f"{module}.Dense_{i}.bias"] = _tensor(
                    sd[f"{module}.{idx}.bias"])
    out["last_layer.Dense_0.weight"] = _tensor(sd["last_layer.weight"])
    return out


def export_reference_state_dict(state_dict: Dict[str, Any],
                                model_config: Dict[str, Any]
                                ) -> Dict[str, np.ndarray]:
    """The port's state_dict -> a reference-layout state_dict (numpy),
    the exact inverse of ``convert_reference_state_dict``. A BatchNorm
    without ``num_batches_tracked`` (weights from a JAX-layout tree) gets
    0, as the JAX package's export writes."""
    name = model_config["name"]
    arch = model_config.get("base_architecture", "resnet18")
    video = name == "Video_XProtoNet"
    sd = {k: _tensor(v) for k, v in state_dict.items()}
    ref: Dict[str, np.ndarray] = {}
    trunk = _trunk(name)
    rules = {"resnet2p1d_18": _R2P1D_INV}.get(
        arch, [] if arch in SWIN3D_SPECS or arch in MVIT_SPECS
        else _RESNET_INV)
    for k, v in _with_prefix(sd, trunk + ".").items():
        tv = _rename(k, rules)
        if arch == "resnet2p1d_18":
            head, rest = tv.split(".", 1)
            idx = 0 if head == "stem" else int(head[len("layer"):])
            tv = f"{_R2P1D_WRAPPER[len('cnn_backbone.'):]}{idx}.{rest}"
        ref[f"{trunk}.{tv}"] = v.numpy()
        if k.endswith(".running_var"):
            nbt = f"{trunk}.{tv[:-len('running_var')]}num_batches_tracked"
            ref.setdefault(nbt, np.asarray(0, np.int64))

    rank = 3 if video else 2
    if name in ("XProtoNet", "Video_XProtoNet"):
        heads = dict(_XPROTO_HEADS)
        pv = sd["prototype_vectors"]
        ref["prototype_vectors"] = pv.reshape(*pv.shape,
                                              *([1] * rank)).numpy()
    elif name == "ProtoPNet":
        n = len({k.split(".")[1] for k in sd
                 if k.startswith("add_on_layers.")})
        # the reference's Sequential: conv, activation, conv, ...
        heads = {"add_on_layers": tuple(2 * i for i in range(n))}
        ref["prototype_vectors"] = sd["prototype_vectors"].permute(
            0, 3, 1, 2).contiguous().numpy()
    else:
        raise ValueError(f"Unknown model name {name!r}")
    for module, indices in heads.items():
        for i, idx in enumerate(indices):
            w = sd[f"{module}.Dense_{i}.weight"]
            ref[f"{module}.{idx}.weight"] = w.reshape(
                *w.shape, *([1] * rank)).numpy()
            if f"{module}.Dense_{i}.bias" in sd:
                ref[f"{module}.{idx}.bias"] = \
                    sd[f"{module}.Dense_{i}.bias"].numpy()
    ref["last_layer.weight"] = sd["last_layer.Dense_0.weight"].numpy()
    # the reference's constant all-ones parameter (strict loads need it)
    ref["ones"] = np.ones(parse_prototype_shape(
        model_config["prototype_shape"]), np.float32)
    return ref


def _port_state(path: str) -> Tuple[Dict[str, Any], int, int]:
    """(state_dict, epoch, iteration) of the port's checkpoint, a JAX
    package ``.ckpt`` or a migrated ``.pkl``."""
    from protoasnet_tpu_torch.utils.io import (checkpoint_format,
                                              load_checkpoint,
                                              load_migrated_pickle,
                                              read_flax_checkpoint)

    fmt = checkpoint_format(path)
    if fmt == "torch":
        blob = load_checkpoint(path)
        return blob["model"], int(blob.get("epoch", 0)), \
            int(blob.get("iteration", 0))
    blob = (load_migrated_pickle(path) if fmt == "migrated"
            else read_flax_checkpoint(path))
    return (jax_to_state_dict(blob["params"], blob["batch_stats"]),
            int(blob.get("epoch", 0)), int(blob.get("iteration", 0)))


def main(argv=None) -> None:
    from protoasnet_tpu_torch.utils.config import load_config
    from protoasnet_tpu_torch.utils.io import save_pickle

    ap = argparse.ArgumentParser(
        description="Convert a reference PyTorch ProtoASNet checkpoint "
        "(.pth) to the JAX-layout .pkl both packages load, or, with "
        "--to_reference, a trained checkpoint back to the reference's "
        ".pth. The .pth is unpickled with torch.load(weights_only=False): "
        "convert only files you trust.")
    ap.add_argument("ckpt", help="input: the reference's .pth, or with "
                    "--to_reference the port's checkpoint (last.ckpt), a "
                    "JAX package .ckpt or a migrated .pkl")
    ap.add_argument("out_ckpt", help="output path")
    ap.add_argument("--config_path", required=True)
    ap.add_argument("--to_reference", action="store_true",
                    help="reverse direction: a trained checkpoint -> the "
                    "reference's .pth")
    args = ap.parse_args(argv)
    model_config = load_config(args.config_path)["model"]

    if args.to_reference:
        sd, epoch, iteration = _port_state(args.ckpt)
        ref = export_reference_state_dict(sd, model_config)
        torch.save({"epoch": epoch, "iteration": iteration,
                    "state_dict": {k: _tensor(v) for k, v in ref.items()},
                    "optimizer": None}, args.out_ckpt)
        logging.info(f"exported {args.ckpt} -> reference-layout "
                     f"{args.out_ckpt}")
        return
    blob = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    params, stats = state_dict_to_jax(
        convert_reference_state_dict(sd, model_config))
    save_pickle({"epoch": int(blob.get("epoch", 0)),
                 "iteration": int(blob.get("iteration", 0)),
                 "params": params, "batch_stats": stats}, args.out_ckpt)
    logging.info(f"converted {args.ckpt} -> {args.out_ckpt} (load it with "
                 f"--model.checkpoint_path)")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
