"""Weight bridge: the JAX package's param / batch_stats trees -> the port.

The trees come in as nested dicts of numpy arrays (``np.asarray`` of the
JAX leaves), so this module needs no JAX. The port's module names follow
the JAX tree, so each JAX key maps to one state_dict key:

  .../kernel (kD,kH,kW,I,O)  -> .../weight (O,I,kD,kH,kW)   Conv3d
  .../kernel (kH,kW,I,O)     -> .../weight (O,I,kH,kW)      Conv2d
  .../kernel (I,O)           -> .../weight (O,I)            Linear
  .../bias                   -> .../bias
  .../scale                  -> .../weight                  BatchNorm
  batch_stats .../mean, var  -> .../running_mean, running_var
  prototype_vectors          -> prototype_vectors, unchanged: (P,D) for
                                XProtoNet, (P,kh,kw,D) for PPNet

Any key missing on either side, or a shape that disagrees, raises.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["jax_to_state_dict", "load_jax_variables"]


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _param_key(path: Tuple[str, ...], arr: np.ndarray
               ) -> Tuple[str, np.ndarray]:
    *mods, name = path
    prefix = ".".join(mods)
    if not mods:
        return name, arr
    if name == "kernel":
        if arr.ndim == 5:
            return f"{prefix}.weight", np.transpose(arr, (4, 3, 0, 1, 2))
        if arr.ndim == 4:
            return f"{prefix}.weight", np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:
            return f"{prefix}.weight", arr.T
        raise ValueError(f"kernel {'/'.join(path)} has rank {arr.ndim}")
    if name == "scale":
        return f"{prefix}.weight", arr
    if name == "bias":
        return f"{prefix}.bias", arr
    raise KeyError(f"unknown JAX param {'/'.join(path)}")


_STATS = {"mean": "running_mean", "var": "running_var"}


def jax_to_state_dict(params: Mapping[str, Any],
                      batch_stats: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    sd: Dict[str, np.ndarray] = {}
    for path, arr in _leaves(params):
        key, val = _param_key(path, arr)
        sd[key] = val
    for path, arr in _leaves(batch_stats):
        *mods, name = path
        if name not in _STATS or not mods:
            raise KeyError(f"unknown JAX batch stat {'/'.join(path)}")
        sd[".".join(mods) + "." + _STATS[name]] = arr
    return sd


def load_jax_variables(model: nn.Module, params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> nn.Module:
    """Fill ``model``'s parameters and BN running stats from the JAX trees
    (in place; returns the model)."""
    sd = jax_to_state_dict(params, batch_stats)
    target = model.state_dict()
    expected = {k for k in target if not k.endswith("num_batches_tracked")}
    missing = sorted(expected - sd.keys())
    extra = sorted(sd.keys() - expected)
    if missing or extra:
        raise KeyError(f"JAX variables do not match the model: missing "
                       f"{missing[:8]}{'...' if len(missing) > 8 else ''}, "
                       f"extra {extra[:8]}{'...' if len(extra) > 8 else ''}")
    with torch.no_grad():
        for k in sorted(expected):
            val = sd[k]
            if tuple(val.shape) != tuple(target[k].shape):
                raise ValueError(f"{k}: JAX shape {tuple(val.shape)} != "
                                 f"model shape {tuple(target[k].shape)}")
            target[k].copy_(torch.from_numpy(np.array(val)))  # own copy
    return model
