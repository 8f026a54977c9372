"""Post-training w8a8 quantisation of the backbone convs, for serving
(the JAX package's ``quant.py``).

A trained model's backbone convs become static w8a8 without editing any
model code:

  1. ``calibrate_act_scales`` runs calibration batches through the
     eval-mode model, a forward pre-hook on each qualifying conv recording
     the running absmax of its input (one number per conv);
  2. ``build_qstate`` turns each calibrated conv's weight into symmetric
     per-output-channel int8 codes and scales;
  3. ``quantized_model`` (and ``apply_quantized``, its one-call form)
     returns a copy of the model in which each calibrated conv is a
     ``QuantConv``: static-scale int8 quantisation of its input, the int8
     conv with int32 sums (``ops/int8_conv.py``), per-channel
     dequantisation.

Scheme, the JAX package's: symmetric int8, per-tensor static activation
scales (absmax / 127 from calibration; post-ReLU inputs use the
non-negative half), per-output-channel weight scales. Everything outside
the backbone (add-on layers, occurrence module, the prototype head) runs
untouched at the model's precision.

The qstate is keyed by the JAX package's "/"-joined module paths
(``cnn_backbone/layer1_0/conv1/spatial``; the port's module names follow
the flax tree) and holds its arrays in the JAX layout (kernels
``(*k, I, O)``), so a qstate of either package reads in the other:

  {path: {"w_q": int8 kernel, "w_scale": (O,) f32, "a_scale": () f32
          [, "bias": (O,) f32][, "fold_m", "fold_b": (O,) f32]}}

Which convs: ``nn.Conv{1,2,3}d`` with groups 1 and dilation 1 whose path
passes the filter (default: under ``cnn_backbone``, as in the JAX
package, so a ProtoPNet, whose trunk is ``features``, quantises nothing
by default). The R(2+1)D trunk's ``stem_spatial`` is never taken: in the
JAX package it is the space-to-depth stem, not an ``nn.Conv``, so the JAX
package never quantises it. A model with a transformer trunk (Swin3D or
MViTv2) is refused: its work is in Linears and attention, which this
scheme does not quantise.
"""

from __future__ import annotations

import copy
import logging
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from protoasnet_tpu_torch.models.backbones import \
    refuse_transformer_trunk
from protoasnet_tpu_torch.ops.int8_conv import int8_conv, quantize

__all__ = ["path_key", "default_backbone_filter", "calibrate_act_scales",
           "calibrate_qstate_from_agent", "build_qstate", "quantized_model",
           "apply_quantized", "QuantConv", "qstate_to_arrays",
           "qstate_from_arrays"]

Path = Tuple[str, ...]
QState = Dict[str, Dict[str, torch.Tensor]]
_SPATIAL, _BN_MID, _TEMPORAL = "spatial", "bn_mid", "temporal"
# the JAX trunk's space-to-depth stem: not an nn.Conv there
_NOT_A_JAX_CONV = "stem_spatial"
# torch weight (O, I, *k) <-> JAX kernel (*k, I, O)
_TO_JAX = {3: (2, 1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}
_FROM_JAX = {3: (2, 1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def path_key(path: Path) -> str:
    """Module path -> the qstate's key ("/"-joined)."""
    return "/".join(path)


def _module_path(name: str) -> Path:
    return tuple(name.split(".")) if name else ()


def _module(model: nn.Module, key: str) -> nn.Module:
    return model.get_submodule(key.replace("/", ".")) if key else model


def default_backbone_filter(path: Path) -> bool:
    """Quantise only backbone convs (the FLOPs majority); heads stay put."""
    return len(path) > 0 and path[0] == "cnn_backbone"


def _is_plain_conv(m: nn.Module, path: Path) -> bool:
    """A conv the int8 path computes exactly, and the JAX package would
    quantise."""
    if not isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d)):
        return False
    if path[-1:] == (_NOT_A_JAX_CONV,):
        return False
    return (m.groups == 1 and all(d == 1 for d in m.dilation)
            and m.padding_mode == "zeros" and not isinstance(m.padding, str))


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def calibrate_act_scales(model: nn.Module, batches: Sequence[Any],
                         path_filter: Callable[[Path], bool] =
                         default_backbone_filter) -> Dict[str, torch.Tensor]:
    """Run ``batches`` through the eval-mode ``model`` (under
    ``torch.inference_mode``) recording each qualifying conv input's
    absmax. Returns {path_key: scalar float32 scale (absmax / 127)} on
    the CPU; the model's train/eval mode is restored."""
    refuse_transformer_trunk(model, "w8a8 int8 (quant.py)")
    absmax: Dict[str, torch.Tensor] = {}
    hooks = []

    def record(key):
        def hook(_module, args):
            a = args[0].abs().amax().float()
            cur = absmax.get(key)
            absmax[key] = a if cur is None else torch.maximum(cur, a)
        return hook

    for name, m in model.named_modules():
        path = _module_path(name)
        if _is_plain_conv(m, path) and path_filter(path):
            hooks.append(m.register_forward_pre_hook(record(path_key(path))))
    was_training = model.training
    dev = _device(model)
    model.eval()
    try:
        with torch.inference_mode():
            for x in batches:
                model(torch.as_tensor(x).to(dev))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    return {k: (torch.clamp_min(a, 1e-8) / 127.0).cpu()
            for k, a in absmax.items()}


def calibrate_qstate_from_agent(agent, calib_batches: int = 4,
                                **calib_kwargs) -> QState:
    """Calibrate and build a w8a8 qstate from a trained agent: the first
    ``calib_batches`` batches of its train loader, in eval mode. Both
    ``serve export --int8`` and ``server --run_dir ... --int8`` call this,
    so the calibration data can't drift between the two."""
    calib = []
    for batch in agent.data_loaders["train"]:
        calib.append(batch["cine"])
        if len(calib) >= calib_batches:
            break
    scales = calibrate_act_scales(agent.model, calib, **calib_kwargs)
    qstate = build_qstate(agent.model, scales)
    logging.info(f"calibrated {len(scales)} convs for w8a8")
    return qstate


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(device="cpu", dtype=torch.float32)


def build_qstate(model: nn.Module, act_scales: Dict[str, Any],
                 fold_conv2plus1d: bool = False,
                 fold_min_channels: int = 288) -> QState:
    """Per-output-channel symmetric int8 kernels for every calibrated conv
    of ``model`` (CPU tensors, the JAX layout; see the module docstring).

    ``fold_conv2plus1d`` (off by default, as in the JAX package, whose
    measurements found it slower end to end) gives every calibrated
    Conv2Plus1D spatial/temporal pair with at least ``fold_min_channels``
    mid channels an int8-resident epilogue: the spatial entry carries
    per-channel ``fold_m``/``fold_b`` folding the mid BatchNorm (eval
    statistics), the ReLU and the temporal conv's activation quantisation
    into one ``clip(round(i32 * fold_m + fold_b), 0, 127)`` int8 emit.
    """
    qstate: QState = {}
    for key, a_scale in act_scales.items():
        conv = _module(model, key)
        w = _f32(conv.weight)
        w_absmax = torch.clamp_min(w.abs().amax(dim=tuple(range(1, w.dim()))),
                                   1e-8)
        w_scale = w_absmax / 127.0
        shape = (-1,) + (1,) * (w.dim() - 1)
        w_q = torch.clamp(torch.round(w / w_scale.view(shape)), -127, 127)
        entry = {"w_q": w_q.to(torch.int8).permute(*_TO_JAX[w.dim()])
                 .contiguous(),
                 "w_scale": w_scale,
                 "a_scale": torch.as_tensor(a_scale, dtype=torch.float32)}
        if conv.bias is not None:
            entry["bias"] = _f32(conv.bias)
        qstate[key] = entry
    if not fold_conv2plus1d:
        return qstate
    for key in list(qstate):
        if not (key == _SPATIAL or key.endswith("/" + _SPATIAL)):
            continue
        prefix = key[:-len(_SPATIAL)]
        bn_key, temporal_key = prefix + _BN_MID, prefix + _TEMPORAL
        if temporal_key not in qstate:
            continue
        q = qstate[key]
        if q["w_q"].shape[-1] < fold_min_channels:
            continue  # measured (JAX package): early pairs run faster
        try:
            bn = _module(model, bn_key)
        except AttributeError:
            continue  # naming convention not met -> per-conv path
        if not isinstance(bn, nn.modules.batchnorm._BatchNorm):
            continue
        gamma, beta = _f32(bn.weight), _f32(bn.bias)
        mean, var = _f32(bn.running_mean), _f32(bn.running_var)
        a_t = qstate[temporal_key]["a_scale"]
        # eval BN epsilon: models/norm.py (1e-5)
        inv_std = gamma * torch.rsqrt(var + 1e-5)
        bias = q.get("bias", torch.zeros_like(mean))
        q["fold_m"] = q["a_scale"] * q["w_scale"] * inv_std / a_t
        q["fold_b"] = ((bias - mean) * inv_std + beta) / a_t
    return qstate


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))


class QuantConv(nn.Module):
    """A conv of the quantised copy: the input quantised at the static
    scale (an int8 input is a folded pair's codes, taken as they are), the
    int8 conv, then the epilogue: dequantisation, ``y * (a_scale *
    w_scale) + bias`` in fp32 cast to the conv input's dtype, or, for a
    folded spatial conv, the int8 codes ``clip(round(y * fold_m +
    fold_b), 0, 127)`` of the temporal conv's input. ``carry`` passes the
    folded pair's compute dtype from its spatial to its temporal conv."""

    def __init__(self, conv: nn.Module, entry: Dict[str, Any],
                 carry: List[torch.dtype]):
        super().__init__()
        w_q = _tensor(entry["w_q"])
        device = conv.weight.device
        self.stride, self.padding = tuple(conv.stride), tuple(conv.padding)
        self.register_buffer("w_q", w_q.permute(*_FROM_JAX[w_q.dim()])
                             .contiguous().to(device))
        a_scale = _tensor(entry["a_scale"]).float()
        self.register_buffer("inv_scale", (1.0 / a_scale).to(device))
        self.register_buffer("scale", (a_scale * _tensor(
            entry["w_scale"]).float()).to(device))
        self.register_buffer("bias", None if "bias" not in entry
                             else _tensor(entry["bias"]).float().to(device))
        fold = "fold_m" in entry
        self.register_buffer("fold_m", _tensor(entry["fold_m"]).float().to(
            device) if fold else None)
        self.register_buffer("fold_b", _tensor(entry["fold_b"]).float().to(
            device) if fold else None)
        self.carry = carry

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.int8:  # a folded pair's temporal side
            out_dtype, xq = self.carry.pop(), x
        else:
            out_dtype, xq = x.dtype, quantize(x, self.inv_scale)
        if self.fold_m is not None:
            self.carry.append(out_dtype)
            return int8_conv(xq, self.w_q, self.stride, self.padding,
                             self._emit_codes)
        return int8_conv(xq, self.w_q, self.stride, self.padding,
                         lambda y: self._dequantise(y, out_dtype))

    def _dequantise(self, y: torch.Tensor, dtype: torch.dtype):
        y = y.float().mul_(self.scale)
        if self.bias is not None:
            y.add_(self.bias)
        return y.to(dtype)

    def _emit_codes(self, y: torch.Tensor) -> torch.Tensor:
        y = torch.round(y.float() * self.fold_m + self.fold_b)
        return torch.clamp(y, 0, 127).to(torch.int8)


def _set(model: nn.Module, key: str, module: nn.Module) -> nn.Module:
    if not key:
        return module
    parent, _, name = key.replace("/", ".").rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, name, module)
    return model


def quantized_model(model: nn.Module, qstate: Dict[str, Any]) -> nn.Module:
    """An eval-mode copy of ``model`` with every conv in ``qstate`` a
    ``QuantConv`` and each folded pair's ``bn_mid`` an identity (the
    trunk's ReLU passes the int8 codes, which are >= 0, unchanged). Convs
    not in ``qstate`` run as they are; an empty qstate gives the float
    model."""
    refuse_transformer_trunk(model, "w8a8 int8 (quant.py)")
    out = copy.deepcopy(model).eval()
    carry: List[torch.dtype] = []
    for key, entry in qstate.items():
        conv = _module(out, key)
        if not _is_plain_conv(conv, tuple(key.split("/")) if key else ()):
            raise ValueError(f"qstate entry {key!r} is not a plain conv of "
                             f"the model ({type(conv).__name__})")
        out = _set(out, key, QuantConv(conv, entry, carry))
        if "fold_m" in entry:
            out = _set(out, key[:-len(_SPATIAL)] + _BN_MID, nn.Identity())
    return out


def apply_quantized(model: nn.Module, qstate: Dict[str, Any],
                    x: torch.Tensor, method: str = "forward"):
    """The quantised model's ``method`` on ``x`` (under
    ``torch.inference_mode``)."""
    qm = quantized_model(model, qstate)
    with torch.inference_mode():
        return getattr(qm, method)(x)


def qstate_to_arrays(qstate: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A flat {"<path>|<field>": numpy array} form (``np.savez``)."""
    return {f"{key}|{field}": np.asarray(_tensor(v).numpy())
            for key, entry in qstate.items() for field, v in entry.items()}


def qstate_from_arrays(arrays: Dict[str, np.ndarray]) -> QState:
    qstate: QState = {}
    for name, v in arrays.items():
        key, _, field = name.rpartition("|")
        qstate.setdefault(key, {})[field] = torch.from_numpy(np.array(v))
    return qstate
