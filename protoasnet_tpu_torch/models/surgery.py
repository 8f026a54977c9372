"""Model surgery: prototype pruning (the JAX package's
``models/surgery.py::prune_prototypes`` on the port's modules).

Pruning returns a new model and leaves the given one as it was: the
prototype rows, the readout's input columns and, where the model has an
occurrence module (XProtoNet), its last Linear's output rows are cut to
the kept prototypes. The pruned model is a copy on the same device, in the
same train/eval mode, with ``prototype_shape`` updated; a readout whose P
is no longer a multiple of K is fine (``PrototypeReadout`` takes any P,
as the pruned models built since PR 6 do).
"""

from __future__ import annotations

import copy
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["prune_prototypes"]


def _cut_linear(layer: nn.Linear, keep: torch.Tensor, dim: int
                ) -> nn.Linear:
    """``layer`` with only the ``keep`` inputs (dim 1) or outputs (dim 0)."""
    w = layer.weight.detach().index_select(dim, keep)
    out = nn.Linear(w.shape[1], w.shape[0], bias=layer.bias is not None,
                    device=w.device, dtype=w.dtype)
    with torch.no_grad():
        out.weight.copy_(w)
        if layer.bias is not None:
            b = layer.bias.detach()
            out.bias.copy_(b.index_select(0, keep) if dim == 0 else b)
    return out


def prune_prototypes(model: nn.Module, class_identity: np.ndarray,
                     prototypes_to_prune: Sequence[int]
                     ) -> Tuple[nn.Module, np.ndarray, List[int]]:
    """Remove the given prototype indices.

    Returns (pruned model, new class identity (P', K), kept indices in
    ascending order). Raises when every prototype would go.
    """
    p = class_identity.shape[0]
    keep = sorted(set(range(p)) - {int(i) for i in prototypes_to_prune})
    if not keep:
        raise ValueError("Cannot prune all prototypes")
    out = copy.deepcopy(model)
    idx = torch.tensor(keep, device=model.prototype_vectors.device)
    with torch.no_grad():
        out.prototype_vectors = nn.Parameter(
            model.prototype_vectors.detach().index_select(0, idx).clone())
    out.last_layer.Dense_0 = _cut_linear(model.last_layer.Dense_0, idx, 1)
    occ = getattr(model, "occurrence_module", None)
    if occ is not None:
        # the last Linear maps hidden/2 -> P: keep its output rows
        last = sorted(n for n, _ in occ.named_children()
                      if n.startswith("Dense"))[-1]
        setattr(out.occurrence_module, last,
                _cut_linear(getattr(occ, last), idx, 0))
    out.prototype_shape = (len(keep), *model.prototype_shape[1:])
    return out, np.asarray(class_identity)[np.asarray(keep)], keep
