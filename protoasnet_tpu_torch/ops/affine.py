"""Batched 2-D affine warps by gathers: the JAX package's ``ops/affine.py``,
the gather reference of ``ops/affine_fast.py``.

Rotation, isotropic scale, crop-resize and translation compose into one
2x3 inverse-map matrix, so a clip is resampled once. Coordinates are
(row, col) pixel indices; a transform is given in *output* space and maps
each output pixel to the input position it samples (inverse warping).
Rotation is counter-clockwise on screen for positive angles (the row axis
points down), as torchvision's. Bilinear samples from the four
neighbours, gathered by index; with ``fill_mode="zero"`` a neighbour
outside the image counts 0, with ``"edge"`` the coordinates are clamped to
the border first (resize semantics). These are the JAX package's sampling
conventions; ``F.grid_sample`` (normalised coordinates, its own
``align_corners`` and padding rules) is not used.

The matrices and the sampling run in fp32 (float64 for float64 inputs),
and the warp is differentiable in the image.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

__all__ = ["rotate_scale_matrix", "crop_resize_matrix", "compose",
           "affine_warp", "affine_warp_video"]

Scalar = Union[float, torch.Tensor]


def _t(v: Scalar, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype)


def rotate_scale_matrix(angle_deg: Scalar, scale: Scalar, height: int,
                        width: int) -> torch.Tensor:
    """Inverse-map matrix (2, 3) for a rotation by ``angle_deg`` and a zoom
    by ``scale`` about the centre: p_in = M @ [r_out, c_out, 1]. ``scale``
    > 1 zooms in, as torchvision's ``affine(..., scale=s)``."""
    angle, scale = _t(angle_deg), _t(scale)
    theta = -angle * (math.pi / 180.0)  # inverse rotation
    inv_s = 1.0 / scale
    a, b = inv_s * torch.cos(theta), inv_s * torch.sin(theta)
    lin = torch.stack([torch.stack([a, -b]), torch.stack([b, a])])
    center = torch.tensor([(height - 1) / 2.0, (width - 1) / 2.0])
    t = center - lin @ center
    return torch.cat([lin, t[:, None]], dim=1)


def crop_resize_matrix(top: Scalar, left: Scalar, crop_h: Scalar,
                       crop_w: Scalar, out_h: int, out_w: int
                       ) -> torch.Tensor:
    """Inverse-map matrix: the (out_h, out_w) output samples the crop box
    [top:top+crop_h, left:left+crop_w] of the input (RandomResizedCrop),
    with half-pixel centres: in = (out + 0.5) * scale - 0.5 + origin."""
    top, left = _t(top), _t(left)
    sy, sx = _t(crop_h) / out_h, _t(crop_w) / out_w
    zero = torch.zeros(())
    return torch.stack([
        torch.stack([sy, zero, top + 0.5 * sy - 0.5]),
        torch.stack([zero, sx, left + 0.5 * sx - 0.5])])


def compose(m_outer: torch.Tensor, m_inner: torch.Tensor) -> torch.Tensor:
    """Compose two inverse-map matrices: ``m_outer`` first on output
    coordinates, then ``m_inner`` (in image space the inner transform
    happens first)."""
    a = m_inner[:, :2] @ m_outer[:, :2]
    t = m_inner[:, :2] @ m_outer[:, 2] + m_inner[:, 2]
    return torch.cat([a, t[:, None]], dim=1)


def _sample_bilinear(img: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, fill_mode: str = "zero"
                     ) -> torch.Tensor:
    """Bilinear samples of a (H, W) or (H, W, C) image at float (rows,
    cols). "zero": a neighbour outside the image counts 0; "edge": the
    coordinates are clamped to the border."""
    if fill_mode not in ("zero", "edge"):
        raise ValueError(f"fill_mode {fill_mode!r}; options: zero, edge")
    h, w = img.shape[0], img.shape[1]
    if fill_mode == "edge":
        rows = torch.clamp(rows, 0.0, h - 1.0)
        cols = torch.clamp(cols, 0.0, w - 1.0)
    r0, c0 = torch.floor(rows), torch.floor(cols)
    dr, dc = rows - r0, cols - c0
    r0i, c0i = r0.long(), c0.long()

    def gather(ri, ci):
        valid = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
        vals = img[ri.clamp(0, h - 1), ci.clamp(0, w - 1)]
        if img.dim() == 3:
            valid = valid[..., None]
        return torch.where(valid, vals, torch.zeros((), dtype=img.dtype))

    v00, v01 = gather(r0i, c0i), gather(r0i, c0i + 1)
    v10, v11 = gather(r0i + 1, c0i), gather(r0i + 1, c0i + 1)
    if img.dim() == 3:
        dr, dc = dr[..., None], dc[..., None]
    top = v00 * (1 - dc) + v01 * dc
    bot = v10 * (1 - dc) + v11 * dc
    return top * (1 - dr) + bot * dr


def affine_warp(img: torch.Tensor, matrix: torch.Tensor,
                out_shape: Tuple[int, int], fill_mode: str = "zero"
                ) -> torch.Tensor:
    """Warp a (H, W) or (H, W, C) image by an inverse-map (2, 3) matrix."""
    img = img if img.dtype == torch.float64 else img.float()
    m = matrix.to(device=img.device, dtype=img.dtype)
    out_h, out_w = out_shape
    rr = torch.arange(out_h, dtype=img.dtype, device=img.device)[:, None]
    cc = torch.arange(out_w, dtype=img.dtype, device=img.device)[None, :]
    rows = m[0, 0] * rr + m[0, 1] * cc + m[0, 2]
    cols = m[1, 0] * rr + m[1, 1] * cc + m[1, 2]
    return _sample_bilinear(img, rows, cols, fill_mode)


def affine_warp_video(video: torch.Tensor, matrix: torch.Tensor,
                      out_shape: Tuple[int, int], fill_mode: str = "zero"
                      ) -> torch.Tensor:
    """Warp every frame of a (T, H, W) or (T, H, W, C) clip with the same
    matrix (one transform per clip, as RandomRotateVideo)."""
    return torch.stack([affine_warp(f, matrix, out_shape, fill_mode)
                        for f in video])
