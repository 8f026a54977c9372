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

Any key missing on either side, or a shape that disagrees, raises. A
model under prototype tensor parallelism
(``parallel.mesh.prototype_param_shardings``) takes the full JAX arrays
and keeps its own block of each sharded one.

The optimiser state of a JAX checkpoint maps the same way: optax's
``chain(<weight decay>, scale_by_adam)`` state, serialised by flax as
{"0": {}, "1": {count, mu, nu}} (``{}`` for a stateless link), becomes the
state of the port's ``GroupAdam`` (``exp_avg`` = mu, ``exp_avg_sq`` = nu,
``step`` = count, for every parameter), and the JAX package's
``GradAccumulator`` {acc, count} the port's ``GradAccumulator`` state
(the partial sums in the parameters' order, none while count is 0). Leaves
may be numpy arrays or tensors (``utils/io.py`` reads bfloat16 leaves as
``torch.bfloat16`` tensors).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from protoasnet_tpu_torch.parallel.mesh import local_shard

__all__ = ["jax_to_state_dict", "state_dict_to_jax", "state_dict_from_jax",
           "load_jax_variables",
           "adam_state_from_jax", "accumulator_state_from_jax"]

Array = Union[np.ndarray, torch.Tensor]


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), (v if isinstance(v, torch.Tensor)
                                       else np.asarray(v))


def _transpose(arr: Array, axes: Tuple[int, ...]) -> Array:
    if isinstance(arr, torch.Tensor):
        return arr.permute(*axes)
    return np.transpose(arr, axes)


def _tensor(arr: Array) -> torch.Tensor:
    """An own, contiguous tensor of ``arr``."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().clone().contiguous()
    return torch.from_numpy(np.array(arr, order="C"))


def _param_key(path: Tuple[str, ...], arr: Array) -> Tuple[str, Array]:
    *mods, name = path
    prefix = ".".join(mods)
    if not mods:
        return name, arr
    if name == "kernel":
        if arr.ndim == 5:
            return f"{prefix}.weight", _transpose(arr, (4, 3, 0, 1, 2))
        if arr.ndim == 4:
            return f"{prefix}.weight", _transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:
            return f"{prefix}.weight", _transpose(arr, (1, 0))
        raise ValueError(f"kernel {'/'.join(path)} has rank {arr.ndim}")
    if name == "scale":
        return f"{prefix}.weight", arr
    if name == "bias":
        return f"{prefix}.bias", arr
    raise KeyError(f"unknown JAX param {'/'.join(path)}")


_STATS = {"mean": "running_mean", "var": "running_var"}


def jax_to_state_dict(params: Mapping[str, Any],
                      batch_stats: Mapping[str, Any]) -> Dict[str, Array]:
    sd: Dict[str, Array] = {}
    for path, arr in _leaves(params):
        key, val = _param_key(path, arr)
        sd[key] = val
    for path, arr in _leaves(batch_stats):
        *mods, name = path
        if name not in _STATS or not mods:
            raise KeyError(f"unknown JAX batch stat {'/'.join(path)}")
        sd[".".join(mods) + "." + _STATS[name]] = arr
    return sd


_KERNEL_AXES = {5: (2, 3, 4, 1, 0), 4: (2, 3, 1, 0), 2: (1, 0)}


def state_dict_to_jax(sd: Mapping[str, Array]
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of ``jax_to_state_dict``: the port's state_dict ->
    (params, batch_stats), nested dicts of numpy arrays in the JAX layout
    (``num_batches_tracked`` has no JAX counterpart and is dropped)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree, path, arr):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = arr

    inv_stats = {v: k for k, v in _STATS.items()}
    for key, val in sd.items():
        arr = (val.detach().cpu().numpy() if isinstance(val, torch.Tensor)
               else np.asarray(val))
        *mods, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        if not mods:
            put(params, [name], arr)
        elif name in inv_stats:
            put(stats, [*mods, inv_stats[name]], arr)
        elif name == "bias":
            put(params, [*mods, "bias"], arr)
        elif name == "weight" and arr.ndim == 1:  # BatchNorm
            put(params, [*mods, "scale"], arr)
        elif name == "weight" and arr.ndim in _KERNEL_AXES:
            put(params, [*mods, "kernel"],
                np.ascontiguousarray(arr.transpose(_KERNEL_AXES[arr.ndim])))
        else:
            raise KeyError(f"no JAX counterpart for {key} "
                           f"{tuple(arr.shape)}")
    return params, stats


def state_dict_from_jax(model: nn.Module, params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """``model``'s full state_dict with its parameters and BN running
    stats from the JAX trees (``num_batches_tracked`` kept), checked key
    for key and shape for shape."""
    sd = jax_to_state_dict(params, batch_stats)
    target = model.state_dict()
    expected = {k for k in target if not k.endswith("num_batches_tracked")}
    missing = sorted(expected - sd.keys())
    extra = sorted(sd.keys() - expected)
    if missing or extra:
        raise KeyError(f"JAX variables do not match the model: missing "
                       f"{missing[:8]}{'...' if len(missing) > 8 else ''}, "
                       f"extra {extra[:8]}{'...' if len(extra) > 8 else ''}")
    params = dict(model.named_parameters())
    out = {}
    for k, cur in target.items():
        if k not in expected:
            out[k] = cur
            continue
        val = sd[k]
        if k in params:
            val = local_shard(_tensor(val), params[k])
        if tuple(val.shape) != tuple(cur.shape):
            raise ValueError(f"{k}: JAX shape {tuple(val.shape)} != "
                             f"model shape {tuple(cur.shape)}")
        out[k] = _tensor(val)
    return out


def load_jax_variables(model: nn.Module, params: Mapping[str, Any],
                       batch_stats: Mapping[str, Any]) -> nn.Module:
    """Fill ``model``'s parameters and BN running stats from the JAX trees
    (in place, in the model's dtypes; returns the model)."""
    with torch.no_grad():
        model.load_state_dict(state_dict_from_jax(model, params,
                                                  batch_stats))
    return model


def _param_names(model: nn.Module, params: List[nn.Parameter]) -> List[str]:
    name_of = {id(p): k for k, p in model.named_parameters()}
    return [name_of[id(p)] for p in params]


def _by_name(model: nn.Module, params: List[nn.Parameter],
             tree: Mapping[str, Any], what: str) -> List[torch.Tensor]:
    """The leaves of a params-shaped JAX tree as tensors in the order of
    ``params``, each in its parameter's layout."""
    sd = jax_to_state_dict(tree, {})
    names = _param_names(model, params)
    out = []
    for name, p in zip(names, params):
        if name not in sd:
            raise KeyError(f"JAX {what} has no entry for {name}")
        val = _tensor(sd[name])
        if tuple(val.shape) != tuple(p.shape):
            raise ValueError(f"{what} {name}: JAX shape {tuple(val.shape)} "
                             f"!= parameter shape {tuple(p.shape)}")
        out.append(val)
    extra = sorted(set(sd) - set(names))
    if extra:
        raise KeyError(f"JAX {what} has entries no parameter takes: "
                       f"{extra[:8]}")
    return out


def _adam_link(opt_state: Mapping[str, Any]) -> Mapping[str, Any]:
    """The scale_by_adam state in an optax chain's state: the one link
    with {count, mu, nu}; every other link must be stateless ({})."""
    links = [opt_state[k] for k in sorted(opt_state, key=int)]
    adam = [s for s in links if {"count", "mu", "nu"} <= set(s)]
    if len(adam) != 1 or any(s for s in links if s is not adam[0]):
        raise ValueError(f"JAX optimiser state is not chain(<stateless>, "
                         f"scale_by_adam): links "
                         f"{[sorted(s) for s in links]}")
    return adam[0]


def adam_state_from_jax(optimizer, model: nn.Module,
                        opt_state: Mapping[str, Any]) -> Dict[str, Any]:
    """A ``torch.optim.Adam`` state_dict for ``optimizer`` (a
    ``GroupAdam`` over ``model``) from the JAX optimiser state: every
    parameter's moments and optax's step count (empty while count is 0,
    as a fresh optimiser's)."""
    adam = _adam_link(opt_state)
    count = int(np.asarray(adam["count"]))
    sd = optimizer.state_dict()
    sd["state"] = {}
    if count:
        mu = _by_name(model, optimizer.params, adam["mu"], "Adam mu")
        nu = _by_name(model, optimizer.params, adam["nu"], "Adam nu")
        # the state's indices follow the param groups, which is the order
        # of optimizer.params
        sd["state"] = {i: {"step": torch.tensor(float(count)),
                           "exp_avg": m, "exp_avg_sq": v}
                       for i, (m, v) in enumerate(zip(mu, nu))}
    return sd


def accumulator_state_from_jax(model: nn.Module,
                               params: List[nn.Parameter],
                               acc: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's ``GradAccumulator`` state over ``params`` from the JAX
    package's {acc, count}: the partial sums in flight, or none when the
    count is 0."""
    count = int(np.asarray(acc["count"]))
    grads = (_by_name(model, params, acc["acc"], "accumulator") if count
             else [None] * len(params))
    return {"count": count, "grads": grads}
