"""Receptive-field propagation for the ProtoPNet push (the JAX package's
``push/receptive_field.py``).

The layer-by-layer recurrence of ProtoPNet's ``receptive_field.py``: given
the conv chain's (kernel, stride, padding) triples (the trunk's
``conv_info()``), track [n_out, jump, rf_size, center] and map a
prototype's (h, w) argmin location to an input-pixel box.
"""

from __future__ import annotations

import math
from typing import List, Sequence

__all__ = [
    "compute_layer_rf_info",
    "compute_proto_layer_rf_info_v2",
    "compute_rf_prototype",
]


def compute_layer_rf_info(filter_size: int, stride: int, padding,
                          prev: Sequence[float]) -> List[float]:
    n_in, j_in, r_in, start_in = prev
    if padding == "SAME":
        n_out = math.ceil(n_in / stride)
        pad = max(filter_size - stride, 0) if n_in % stride == 0 else max(
            filter_size - (n_in % stride), 0)
    elif padding == "VALID":
        n_out = math.ceil((n_in - filter_size + 1) / stride)
        pad = 0
    else:
        pad = padding * 2
        n_out = math.floor((n_in - filter_size + pad) / stride) + 1
    p_left = math.floor(pad / 2)
    j_out = j_in * stride
    r_out = r_in + (filter_size - 1) * j_in
    start_out = start_in + ((filter_size - 1) / 2 - p_left) * j_in
    return [n_out, j_out, r_out, start_out]


def compute_proto_layer_rf_info_v2(
    img_size: int,
    layer_filter_sizes: Sequence[int],
    layer_strides: Sequence[int],
    layer_paddings: Sequence,
    prototype_kernel_size: int = 1,
) -> List[float]:
    if not len(layer_filter_sizes) == len(layer_strides) == len(
            layer_paddings):
        raise ValueError("one (kernel, stride, padding) triple per layer")
    rf = [img_size, 1, 1, 0.5]
    for k, s, p in zip(layer_filter_sizes, layer_strides, layer_paddings):
        rf = compute_layer_rf_info(k, s, p, rf)
    return compute_layer_rf_info(prototype_kernel_size, 1, "VALID", rf)


def compute_rf_prototype(img_size: int, patch_index: Sequence[int],
                         rf_info: Sequence[float]) -> List[int]:
    """patch_index = (sample_idx, h, w) -> [sample_idx, y0, y1, x0, x1]."""
    img_idx, h_idx, w_idx = patch_index[0], patch_index[1], patch_index[2]
    n, j, r, start = rf_info
    if not (h_idx < n and w_idx < n):
        raise ValueError(f"patch ({h_idx}, {w_idx}) outside the {n}x{n} map")
    center_h = start + h_idx * j
    center_w = start + w_idx * j
    return [
        int(img_idx),
        max(int(center_h - r / 2), 0),
        min(int(center_h + r / 2), img_size),
        max(int(center_w - r / 2), 0),
        min(int(center_w + r / 2), img_size),
    ]
