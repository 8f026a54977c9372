"""Model FLOPs and MFU (the JAX package's ``utils/flops.py`` on
``torch.utils.flop_counter``).

``count_flops`` runs a function under ``FlopCounterMode`` and sums the
multiply-accumulate work of matmuls and convolutions (mm, addmm, bmm,
baddbmm, convolution and their backward), forward and backward if the
function runs both: the accounting of the JAX package's jaxpr walk (2 per
multiply-add, the whole kernel window charged at every output position,
elementwise and reduction work left out). Tensors may live on the card,
the CPU or the ``meta`` device (shapes only, nothing computed).

The hand-written head kernels are ctypes launches, which
``FlopCounterMode`` does not see. Each wrapper therefore reports its
kernel's products where it launches (``kernel_flops``), counted as its
plain version's torch ops are (2·N·S·P·D for the ROI pooling and for the
L2 cross term), so a count on the card equals the count on the CPU.

The JAX package's video trunk counts its space-to-depth stem as a (1,4,4)
conv over 12 channels; the port runs the plain (1,7,7)/2 conv over 3, so
the port's flagship forward counts 406,425,600 FLOP a clip less
(``tests/test_torch_port_flops.py`` works the difference out from the
shapes).

``PEAK_FLOPS`` holds the card's dense peak rates from NVIDIA's H100 SXM5
datasheet, keyed by ``torch.cuda.get_device_name()``: bf16 989.4 TFLOP/s,
TF32 494.7 TFLOP/s (PyTorch runs fp32 convolutions in TF32 by default, so
fp32 work is held against it), int8 1,979 TOP/s. A card that is not in
the table raises: no other device's rate stands in for it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["PEAK_FLOPS", "count_flops", "flops_by_op", "kernel_flops",
           "peak_flops", "mfu", "summarize"]

PEAK_FLOPS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "fp32": 494.7e12,
                              "int8": 1979e12},
}

# the open counts of count_flops calls; a kernel wrapper adds to each
_open: List[Dict[str, float]] = []


def kernel_flops(name: str, flops: float) -> None:
    """Called by a hand kernel's wrapper where it launches: ``flops`` of
    matmul work under ``name`` in every count in progress."""
    for counts in _open:
        counts[name] = counts.get(name, 0.0) + float(flops)


def flops_by_op(fn: Callable[..., Any], *args, **kwargs) -> Dict[str, float]:
    """FLOPs of ``fn(*args, **kwargs)`` by operator (``aten.convolution``,
    ``aten.bmm`` ..., and the hand kernels by their wrappers' names)."""
    extra: Dict[str, float] = {}
    _open.append(extra)
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
    finally:
        _open.remove(extra)
    out = {str(op).split(".default")[0]: float(n)
           for op, n in counter.get_flop_counts().get("Global", {}).items()}
    for name, n in extra.items():
        out[name] = out.get(name, 0.0) + n
    return out


def count_flops(fn: Callable[..., Any], *args, **kwargs) -> float:
    """Matmul + convolution FLOPs of ``fn(*args, **kwargs)``."""
    return sum(flops_by_op(fn, *args, **kwargs).values())


def peak_flops(dtype: str = "bf16", device_name: Optional[str] = None
               ) -> float:
    """The card's dense peak for ``dtype`` ("bf16", "fp32" = TF32,
    "int8"); ``device_name`` defaults to the current CUDA device's."""
    name = device_name or torch.cuda.get_device_name()
    if name not in PEAK_FLOPS:
        raise KeyError(f"no peak rate for {name!r}; known cards: "
                       f"{sorted(PEAK_FLOPS)}")
    return PEAK_FLOPS[name][dtype]


def mfu(flops_per_item: float, items_per_sec: float, dtype: str = "bf16",
        device_name: Optional[str] = None) -> float:
    """Model FLOPs utilisation: achieved FLOP/s over the card's peak."""
    return flops_per_item * items_per_sec / peak_flops(dtype, device_name)


def summarize(fn: Callable[..., Any], *args, per: int = 1,
              **kwargs) -> Dict[str, float]:
    """FLOPs in total and per item (``per`` = batch size)."""
    total = count_flops(fn, *args, **kwargs)
    return {"flops": total, "flops_per_item": total / max(1, per)}
