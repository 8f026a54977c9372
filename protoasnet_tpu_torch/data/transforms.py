"""Input transforms on the device: uint8 windows in, model input out.

The JAX package's ``data/transforms.py`` in torch. The host only gathers
fixed-size uint8 windows from the packed CineStore; on the device, in one
pass per batch: [0, 1] scaling, temporal resize to ``frames``, the train
augmentation (random-resized crop, then rotation, both as banded
resampling matrices, ``ops/affine_fast.py``), normalisation with the
dataset statistics (mean 0.099, std 0.171) and gray -> 3 channels.

Clips are channels-last: (B, T, S, S) uint8 in, (B, frames, S, S, 3) fp32
out, or (B, S, S, 3) for single-frame models. The augmentation's draws come
from an explicit ``torch.Generator`` or are passed in (``params``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from protoasnet_tpu_torch.ops.affine_fast import (crop_resize_video,
                                                  rotate_video)

NORM_MEAN = 0.099
NORM_STD = 0.171

__all__ = ["NORM_MEAN", "NORM_STD", "normalize", "unnormalize",
           "temporal_resize", "sample_augment_params", "make_preprocess_fn"]

AugmentParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor, torch.Tensor]


def normalize(x: torch.Tensor) -> torch.Tensor:
    return (x - NORM_MEAN) / NORM_STD


def unnormalize(x: torch.Tensor) -> torch.Tensor:
    return x * NORM_STD + NORM_MEAN


def temporal_resize(clips: torch.Tensor, t_len: torch.Tensor,
                    frames_out: int) -> torch.Tensor:
    """Linear resample of the first ``t_len[b]`` frames of each padded clip
    to ``frames_out`` frames (half-pixel centres).

    clips (B, T_max, S, S) float, t_len (B,) int -> (B, frames_out, S, S).
    """
    b, t_max = clips.shape[:2]
    t_len_f = t_len.to(torch.float32)[:, None]  # (B, 1)
    j = torch.arange(frames_out, dtype=torch.float32,
                     device=clips.device)[None]
    src = (j + 0.5) * (t_len_f / frames_out) - 0.5
    src = torch.minimum(torch.clamp_min(src, 0.0), t_len_f - 1.0)
    lo = torch.floor(src).to(torch.int64)
    hi = torch.minimum(lo + 1, t_len.to(torch.int64)[:, None] - 1)
    w = (src - lo.to(torch.float32))[..., None, None]
    lo = lo.clamp(0, t_max - 1)
    hi = hi.clamp(0, t_max - 1)
    rows = torch.arange(b, device=clips.device)[:, None]
    return clips[rows, lo] * (1.0 - w) + clips[rows, hi] * w


def sample_augment_params(generator: Optional[torch.Generator], n: int,
                          img_size: int, min_crop_ratio: float,
                          rotate_degrees: float) -> AugmentParams:
    """n draws of (top, left, crop_h, crop_w, angle), each (n,) fp32:
    RandomResizedCrop (area fraction in (min_crop_ratio, 1), aspect ratio
    log-uniform in (3/4, 4/3), uniform position) and a rotation uniform in
    [-rotate_degrees, rotate_degrees]."""
    u = torch.rand((n, 5), generator=generator, dtype=torch.float32)
    area = (u[:, 0] * (1.0 - min_crop_ratio) + min_crop_ratio) \
        * (img_size * img_size)
    lo, hi = math.log(3.0 / 4.0), math.log(4.0 / 3.0)
    ratio = torch.exp(u[:, 1] * (hi - lo) + lo)
    w = torch.sqrt(area * ratio).clamp(1.0, img_size)
    h = torch.sqrt(area / ratio).clamp(1.0, img_size)
    top = u[:, 2] * (img_size - h)
    left = u[:, 3] * (img_size - w)
    angle = u[:, 4] * (2.0 * rotate_degrees) - rotate_degrees
    return top, left, h, w, angle


def make_preprocess_fn(frames_out: int, img_size: int,
                       do_normalize: bool = True, augment: bool = False,
                       rotate_degrees: float = 10.0,
                       min_crop_ratio: float = 0.7) -> Callable:
    """The (B, T_max, S, S) uint8 -> model-input transform.

    Returns fn(clips_u8, t_len, generator=None, params=None) ->
    (B, frames_out, S, S, 3) fp32, or (B, S, S, 3) when frames_out == 1,
    on the clips' device. With ``augment``, the draws are ``params`` (a
    tuple of five (B,) tensors, as ``sample_augment_params`` returns) when
    given, else they come from ``generator``.
    """

    def preprocess(clips_u8: torch.Tensor, t_len: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   params: Optional[AugmentParams] = None) -> torch.Tensor:
        x = clips_u8.to(torch.float32) * (1.0 / 255.0)
        x = temporal_resize(x, t_len.to(x.device), frames_out)
        if augment:
            if params is None:
                params = sample_augment_params(
                    generator, x.shape[0], img_size, min_crop_ratio,
                    rotate_degrees)
            top, left, h, w, angle = params
            x = torch.stack([
                rotate_video(crop_resize_video(
                    clip, top[i], left[i], h[i], w[i],
                    (img_size, img_size)), angle[i])
                for i, clip in enumerate(x)])
        if do_normalize:
            x = normalize(x)
        x = x[..., None].expand(*x.shape, 3)  # gray -> 3 channels
        if frames_out == 1:
            x = x[:, 0]
        return x.contiguous()

    return preprocess
