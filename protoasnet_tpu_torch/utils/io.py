"""Pickle and checkpoint IO.

The port's checkpoint is its own: a ``torch.save`` of a dict (model state,
optimiser, accumulator, scheduler, epoch, iteration, best metric), written
atomically. A checkpoint of the JAX package (flax msgpack) is not read
here.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import torch

__all__ = ["save_pickle", "load_pickle", "save_checkpoint",
           "load_checkpoint"]


def save_pickle(obj: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str) -> Any:
    """Unpickle a file this program wrote (pickles can run code: never
    load one from elsewhere)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_checkpoint(state: Dict[str, Any], path: str) -> None:
    """``torch.save`` of ``state`` to ``path`` through a temporary file and
    a rename, so a reader never sees a partial checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """A checkpoint written by ``save_checkpoint`` (tensors, numbers,
    strings, lists and dicts only)."""
    return torch.load(path, map_location=map_location, weights_only=True)
