"""Affine warps as banded resampling matrices (no gathers, no grid_sample).

The JAX package's ``ops/affine_fast.py`` ported to torch: each transform is
a product with a weight matrix built from hat (linear-interpolation)
weights, so it is exactly the same arithmetic, and it is differentiable in
the image (the weights are linear in it).

* axis-aligned resampling (zoom about the centre, crop-resize) is separable:
  one (H_in, H_out) matrix along H, one (W_in, W_out) along W;
* rotation is Paeth's three-shear decomposition
      R(th) = ShearX(-tan(th/2)) @ ShearY(sin th) @ ShearX(-tan(th/2))
  where each shear is a per-row (or per-column) 1-D linear resample, an
  (H, W_in, W_out) banded weight tensor.

Out-of-range samples get zero weight (zero fill). A clip is (T, H, W) or
(T, H, W, C). The weights, the draws' trigonometry and the clip are fp32
(a clip of a lower precision is promoted), or all float64 for a float64
clip, as the JAX package computes them in 64-bit mode. ``grid_sample``
would give other numbers at the borders and in the shears, so it is not
used.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

__all__ = ["resample_matrix", "scale_about_center", "crop_resize_video",
           "rotate_video", "rotate_scale_video"]

Scalar = Union[float, torch.Tensor]


def _float(video: torch.Tensor) -> torch.Tensor:
    """At least fp32; float64 stays float64."""
    return video if video.dtype == torch.float64 else video.float()


def _scalar(v: Scalar, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s dtype and device."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _iota(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=like.dtype, device=like.device)


def _hw(video: torch.Tensor) -> Tuple[int, int]:
    if video.dim() == 4:
        return video.shape[-3], video.shape[-2]
    return video.shape[-2], video.shape[-1]


def resample_matrix(n_in: int, n_out: int, src_pos: torch.Tensor
                    ) -> torch.Tensor:
    """(n_in, n_out) linear-interp weights: out[j] = sum_i W[i, j] * in[i]
    with src_pos[j] the source coordinate of output j. Taps exist only in
    [0, n_in - 1], so out-of-range sources get zero weight (zero fill)."""
    taps = torch.arange(n_in, dtype=src_pos.dtype, device=src_pos.device)
    return torch.clamp(1.0 - (taps[:, None] - src_pos[None, :]).abs(),
                       0.0, 1.0)


def _apply_h(video: torch.Tensor, w_h: torch.Tensor) -> torch.Tensor:
    if video.dim() == 3:
        return torch.einsum("thw,hj->tjw", video, w_h)
    return torch.einsum("thwc,hj->tjwc", video, w_h)


def _apply_w(video: torch.Tensor, w_w: torch.Tensor) -> torch.Tensor:
    if video.dim() == 3:
        return torch.einsum("thw,wj->thj", video, w_w)
    return torch.einsum("thwc,wj->thjc", video, w_w)


def _shear_weights(n_lines: int, n: int, k: torch.Tensor) -> torch.Tensor:
    """(lines, n_in, n_out) weights of a shear along an axis of n samples:
    output j of line i samples input j + k * (i - centre of the lines)."""
    c = (n_lines - 1) / 2.0
    lines, taps = _iota(n_lines, k), _iota(n, k)
    src = taps[None, None, :] + k * (lines[:, None, None] - c)
    return torch.clamp(1.0 - (taps[None, :, None] - src).abs(), 0.0, 1.0)


def _shear_x(video: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row horizontal shear about the centre: output (i, j) samples
    input column j + k * (i - cy)."""
    h, w = _hw(video)
    wt = _shear_weights(h, w, k)  # (H, W, W)
    if video.dim() == 3:
        return torch.einsum("thw,hwj->thj", video, wt)
    return torch.einsum("thwc,hwj->thjc", video, wt)


def _shear_y(video: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-column vertical shear: output (i, j) samples row i + k*(j - cx)."""
    h, w = _hw(video)
    wt = _shear_weights(w, h, k)  # (W, H, H)
    if video.dim() == 3:
        return torch.einsum("thw,whi->tiw", video, wt)
    return torch.einsum("thwc,whi->tiwc", video, wt)


def scale_about_center(video: torch.Tensor, scale: Scalar) -> torch.Tensor:
    """Isotropic zoom about the image centre (scale > 1 zooms in), same
    output size, zero fill."""
    video = _float(video)
    h, w = _hw(video)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    inv = 1.0 / _scalar(scale, video)
    src_r = inv * (_iota(h, video) - cy) + cy
    src_c = inv * (_iota(w, video) - cx) + cx
    video = _apply_h(video, resample_matrix(h, h, src_r))
    return _apply_w(video, resample_matrix(w, w, src_c))


def crop_resize_video(video: torch.Tensor, top: Scalar, left: Scalar,
                      crop_h: Scalar, crop_w: Scalar,
                      out_hw: Tuple[int, int]) -> torch.Tensor:
    """RandomResizedCrop: separable resample of the crop box to ``out_hw``
    (half-pixel centres)."""
    video = _float(video)
    h, w = _hw(video)
    out_h, out_w = out_hw
    src_r = (_iota(out_h, video) + 0.5) * (_scalar(crop_h, video) / out_h) \
        - 0.5 + _scalar(top, video)
    src_c = (_iota(out_w, video) + 0.5) * (_scalar(crop_w, video) / out_w) \
        - 0.5 + _scalar(left, video)
    video = _apply_h(video, resample_matrix(h, out_h, src_r))
    return _apply_w(video, resample_matrix(w, out_w, src_c))


def rotate_video(video: torch.Tensor, angle_deg: Scalar) -> torch.Tensor:
    """Visual rotation by ``angle_deg`` through Paeth's three shears
    (|angle| < 90)."""
    video = _float(video)
    theta = _scalar(angle_deg, video) * (math.pi / 180.0)
    a = -torch.tan(theta / 2.0)
    b = torch.sin(theta)
    return _shear_x(_shear_y(_shear_x(video, a), b), a)


def rotate_scale_video(video: torch.Tensor, angle_deg: Scalar,
                       scale: Scalar) -> torch.Tensor:
    """The TransformLoss transform: isotropic zoom, then rotation about the
    centre (they commute)."""
    return rotate_video(scale_about_center(video, scale), angle_deg)
