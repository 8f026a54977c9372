"""Rendering of one prototype's evidence, numpy + OpenCV + PIL (the part
of the JAX package's ``explain/render.py`` that the push calls).

``prototype_plot`` writes the 4-panel figure (base image, occurrence-masked
image, TURBO heatmap overlay, raw map): a PNG for an image model, an MP4
of the clip for a video model (OpenCV's MPEG-4 encoder; per-frame PNGs if
no video backend works). The occurrence map is upsampled to the clip with
separable linear weights on the host.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import numpy as np

from protoasnet_tpu_torch.data.transforms import NORM_MEAN, NORM_STD

__all__ = ["upsample_occurrence_map", "prototype_plot"]

_CAPTION_H = 22
_PROTO_LABELS = ("base", "masked", "overlay", "mask")


def _linear_up_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) half-pixel-centre triangle-kernel weights: linear
    upsampling, edge-clamped."""
    if n_out == n_in:
        return np.eye(n_in, dtype=np.float32)
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(x).astype(np.int64)
    frac = (x - lo).astype(np.float32)
    w = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(w, (rows, np.clip(lo, 0, n_in - 1)), 1.0 - frac)
    np.add.at(w, (rows, np.clip(lo + 1, 0, n_in - 1)), frac)
    return w


def upsample_occurrence_map(occ: np.ndarray, out_shape) -> np.ndarray:
    """occ (1, [T,] H, W) -> ([To,] Ho, Wo), upsampled linearly by
    separable host products (the maps are small: 8x14x14 -> 32x112x112).
    Only upsampling: a smaller ``out_shape`` raises."""
    x = np.asarray(occ[0], np.float32)
    out_shape = tuple(out_shape)
    if any(o < i for o, i in zip(out_shape, x.shape)):
        raise ValueError(f"upsample_occurrence_map: {out_shape} is smaller "
                         f"than the map {x.shape}")
    for axis, n_out in enumerate(out_shape):
        w = _linear_up_weights(x.shape[axis], n_out)
        x = np.moveaxis(np.tensordot(w, x, axes=(1, axis)), 0, axis)
    return x


def make_heatmap(rescaled: np.ndarray) -> np.ndarray:
    """[0,1] map -> RGB TURBO heatmap in [0,1]."""
    import cv2

    hm = cv2.applyColorMap(np.uint8(255 * rescaled), cv2.COLORMAP_TURBO)
    return np.float32(hm[..., ::-1]) / 255.0


def _viridis(rescaled: np.ndarray) -> np.ndarray:
    import cv2

    hm = cv2.applyColorMap(np.uint8(255 * rescaled), cv2.COLORMAP_VIRIDIS)
    return np.float32(hm[..., ::-1]) / 255.0


def compose_panel_frame(panels: Sequence[np.ndarray], title: str,
                        labels: Optional[Sequence[str]] = None,
                        colorbar: bool = False, scale: int = 2) -> np.ndarray:
    """Compose [0,1] RGB panels side by side into one captioned uint8 frame.

    Pure numpy + PIL text — ~1-2 ms/frame vs ~150 ms through matplotlib.
    """
    from PIL import Image, ImageDraw

    h = panels[0].shape[0]
    pad = np.ones((h, 6, 3), np.float32)
    row: List[np.ndarray] = []
    for p in panels:
        if row:
            row.append(pad)
        row.append(np.clip(p, 0.0, 1.0))
    if colorbar:
        grad = np.linspace(1.0, 0.0, h, dtype=np.float32)[:, None]
        row += [pad, _viridis(np.repeat(grad, 8, axis=1))]
    img8 = (np.concatenate(row, axis=1) * 255).astype(np.uint8)
    if scale > 1:
        import cv2

        img8 = cv2.resize(img8, (img8.shape[1] * scale, img8.shape[0] * scale),
                          interpolation=cv2.INTER_NEAREST)
    hh, ww, _ = img8.shape
    label_h = _CAPTION_H if labels else 0
    canvas = Image.new("RGB", (ww, hh + _CAPTION_H + label_h), "white")
    canvas.paste(Image.fromarray(img8), (0, _CAPTION_H + label_h))
    draw = ImageDraw.Draw(canvas)
    draw.text((4, 4), title[: ww // 6], fill=(0, 0, 0))
    if labels:
        panel_w = panels[0].shape[1] * scale
        for i, lab in enumerate(labels):
            draw.text((4 + i * (panel_w + 6 * scale), _CAPTION_H + 3), lab,
                      fill=(60, 60, 60))
    return np.asarray(canvas)


def write_video_frames(frames, video_path: str,
                       fps: int = 5) -> Optional[str]:
    """Write uint8 RGB frames (list, or a (T, H, W, 3) stack) as a video.
    MP4 (OpenCV MPEG-4, no ffmpeg needed) first, GIF fallback. Returns the
    written path, or None."""
    if not isinstance(frames, np.ndarray):
        frames = np.stack([np.asarray(f) for f in frames])
    try:
        import cv2

        t, h, w = frames.shape[:3]
        writer = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
        if writer.isOpened():
            # one cvtColor over the stacked sheet: per-frame [..., ::-1]
            # negative-stride copies cost more than the encode itself
            bgr = cv2.cvtColor(frames.reshape(t * h, w, 3),
                               cv2.COLOR_RGB2BGR).reshape(t, h, w, 3)
            for f in bgr:
                writer.write(f)
            writer.release()
            return video_path
        writer.release()
    except Exception:
        logging.exception(f"cv2 MP4 write failed for {video_path}")
    try:
        import imageio.v2 as imageio

        gif_path = os.path.splitext(video_path)[0] + ".gif"
        imageio.mimsave(gif_path, frames, duration=1000.0 / fps)
        return gif_path
    except Exception:
        logging.exception(f"gif fallback failed for {video_path}")
        return None


def write_video_or_frames(frames: Sequence[np.ndarray], base_path: str,
                          fps: int = 5) -> None:
    """Write an MP4 (GIF fallback) at ``base_path + '.mp4'``; if no video
    backend works, dump per-frame PNGs ``base_path_<t>.png`` instead —
    the shared fallback chain for every prototype/sample visualization."""
    out = write_video_frames(frames, base_path + ".mp4", fps=fps)
    if out is None:
        from PIL import Image

        for t, f in enumerate(frames):
            Image.fromarray(f).save(f"{base_path}_{t}.png")


def _proto_frame(unnorm_img, rescaled, title) -> np.ndarray:
    """One frame of the 4-panel layout: base | masked | TURBO overlay |
    raw map (image models; ``render_clip_panels`` composes clips)."""
    mask = rescaled[..., None]
    panels = [
        unnorm_img,
        unnorm_img * mask,
        0.5 * unnorm_img + 0.3 * make_heatmap(rescaled),
        _viridis(rescaled),  # == (upsampled - vmin)/(vmax - vmin), clipped
    ]
    return compose_panel_frame(panels, title,
                               labels=_PROTO_LABELS,
                               colorbar=True)


def u8_clip(x: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8 with the float path's truncating quantization."""
    return (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)


def heatmap_clip8(occ8: np.ndarray) -> np.ndarray:
    """(T, H, W) uint8 map -> (T, H, W, 3) uint8 TURBO RGB heatmap (one
    colormap LUT pass; exactly make_heatmap's table, no float round trip)."""
    import cv2

    t, h, w = occ8.shape
    hm = cv2.applyColorMap(occ8.reshape(t * h, w), cv2.COLORMAP_TURBO)
    return np.ascontiguousarray(hm.reshape(t, h, w, 3)[..., ::-1])


def overlay_clip8(img8: np.ndarray, heat8: np.ndarray) -> np.ndarray:
    """uint8 (0.5*img + 0.3*heat): fixed-point (128*img + 77*heat)/256."""
    a = img8.astype(np.uint16)
    b = heat8.astype(np.uint16)
    return ((a * np.uint16(128) + b * np.uint16(77) + np.uint16(128))
            >> 8).astype(np.uint8)


def mask_clip8(img8: np.ndarray, occ8: np.ndarray) -> np.ndarray:
    """uint8 img * (occ/255) via exact rounding division by 255."""
    t = img8.astype(np.uint16) * occ8[..., None]
    t += 128
    return ((t + (t >> 8)) >> 8).astype(np.uint8)


def compose_panel_clip(panels, title: str,
                       labels: Optional[Sequence[str]] = None,
                       colorbar: bool = False, scale: int = 2,
                       panels8=None) -> np.ndarray:
    """Vectorized ``compose_panel_frame`` over a leading T axis.

    panels: list of (T, H, W, 3) float [0,1] arrays (``panels8`` entries,
    if given, are pre-quantized uint8 and appended after them). Returns
    (T, Hc, Wc, 3) uint8, pixel-identical to composing each frame with
    ``compose_panel_frame`` — but with preallocated uint8 assembly, ONE
    cv2 nearest resize for the scale step, and ONE PIL caption strip
    instead of T canvases.
    """
    import cv2

    all8 = [u8_clip(p) for p in panels] + list(panels8 or [])
    t, h, w, _ = all8[0].shape
    n = len(all8)
    pad_w, cb_w = 6, 8
    wtot = n * w + (n - 1) * pad_w + (pad_w + cb_w if colorbar else 0)
    out = np.full((t, h, wtot, 3), 255, np.uint8)
    x0 = 0
    for p in all8:
        out[:, :, x0:x0 + w] = p
        x0 += w + pad_w
    if colorbar:
        grad = np.linspace(1.0, 0.0, h, dtype=np.float32)[:, None]
        out[:, :, x0:x0 + cb_w] = u8_clip(_viridis(np.repeat(grad, cb_w,
                                                        axis=1)))

    # caption + per-panel labels: identical text every frame -> render ONE
    # strip through PIL and prepend it to all frames
    from PIL import Image, ImageDraw

    hh, ww = h * scale, wtot * scale
    label_h = _CAPTION_H if labels else 0
    strip = Image.new("RGB", (ww, _CAPTION_H + label_h), "white")
    draw = ImageDraw.Draw(strip)
    draw.text((4, 4), title[: ww // 6], fill=(0, 0, 0))
    for i, lab in enumerate(labels or ()):
        draw.text((4 + i * (w + pad_w) * scale, _CAPTION_H + 3), lab,
                  fill=(60, 60, 60))

    top = _CAPTION_H + label_h
    full = np.empty((t, top + hh, ww, 3), np.uint8)
    full[:, :top] = np.asarray(strip)
    if scale > 1:
        # one cv2 nearest resize over the stacked (t*h, wtot) sheet: for an
        # exact integer scale nearest == per-frame repeat (row r maps to
        # floor(r/scale), never crossing a frame boundary) and runs ~3x
        # faster than two np.repeat passes
        big = cv2.resize(out.reshape(t * h, wtot, 3), (ww, t * hh),
                         interpolation=cv2.INTER_NEAREST)
        full[:, top:] = big.reshape(t, hh, ww, 3)
    else:
        full[:, top:] = out
    return full


def render_clip_panels(unnorm: np.ndarray, rescaled: np.ndarray,
                       title: str, scale: int = 2) -> np.ndarray:
    """All T frames of the 4-panel prototype figure in one vectorized pass.

    unnorm: (T, H, W, 3) float [0,1]; rescaled: (T, H, W) float [0,1].
    uint8-resident composition: within +-2/255 per pixel of stacking the
    float ``_proto_frame`` path, identical layout and captions; see
    compose_panel_clip for the assembly.
    """
    import cv2

    t, h, w, _ = unnorm.shape
    img8 = u8_clip(unnorm)
    occ8 = u8_clip(rescaled)
    turbo8 = heatmap_clip8(occ8)
    vir8 = cv2.applyColorMap(occ8.reshape(t * h, w), cv2.COLORMAP_VIRIDIS)
    vir8 = vir8[..., ::-1].reshape(t, h, w, 3)
    return compose_panel_clip(
        [], title, labels=_PROTO_LABELS, colorbar=True, scale=scale,
        panels8=[img8, mask_clip8(img8, occ8), overlay_clip8(img8, turbo8),
                 vir8],
    )


def prototype_plot(img, occurrence_map, proto_id, fn, pred, gt, proto_dir,
                   m: float = NORM_MEAN, std: float = NORM_STD,
                   interp: str = "bilinear") -> None:
    """Render one prototype's evidence.

    img: (3, Ho, Wo) or (3, To, Ho, Wo) normalized; occurrence_map:
    (1, H, W) or (1, T, H, W). Images unnormalize with the dataset stats.
    """
    from PIL import Image

    # no clip here: the video path quantizes via u8_clip (which clips);
    # the still path clips below before the float renderer
    unnorm = np.asarray(img, np.float32) * std + m
    video = unnorm.ndim == 4
    if video:
        unnorm = np.transpose(unnorm, (1, 2, 3, 0))  # (To, Ho, Wo, 3)
        up = upsample_occurrence_map(occurrence_map, unnorm.shape[:-1])
    else:
        unnorm = np.transpose(unnorm, (1, 2, 0))  # (Ho, Wo, 3)
        up = upsample_occurrence_map(occurrence_map, unnorm.shape[:-1])

    lo, hi = float(up.min()), float(up.max()) + 1e-7
    rescaled = (up - lo) / (hi - lo)
    pred = np.asarray(pred).reshape(-1)
    title = (f"p_{proto_id:02d} | {fn} | pred = "
             f"{[f'{v:.2f}' for v in pred]} | gt = {gt}")

    if not video:
        frame = _proto_frame(np.clip(unnorm, 0, 1), rescaled, title)
        Image.fromarray(frame).save(
            os.path.join(proto_dir, f"{proto_id:02d}_{fn}.png"))
        return

    # MP4 clips compose at native panel resolution (scale=1): lossy
    # encoding of nearest-2x-upscaled pixels costs 4x the encode time and
    # bytes for zero added information (players upscale at playback);
    # PNG stills above keep the 2x legibility bump.
    frames = render_clip_panels(unnorm, rescaled, title, scale=1)
    write_video_or_frames(
        frames, os.path.join(proto_dir, f"{proto_id:02d}_{fn}"), fps=5)
