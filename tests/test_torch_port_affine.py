"""The port's gather warp (``protoasnet_tpu_torch/ops/affine.py``) against
the JAX package's ``ops/affine.py``.

Each case of ``tests/test_affine.py`` runs on the port, and the port's
output is also held against the JAX warp on the same input and matrix
(atol 1e-5). The port's ``affine_warp_video`` is held against its own
``ops/affine_fast.py`` as ``tests/test_affine_fast.py`` holds the JAX
pair: exact for the zoom and the crop-resize, close for the rotation
(Paeth's shears interpolate differently) on band-limited clips.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.ops import affine as jaff
from protoasnet_tpu_torch.ops import affine_fast as fast
from protoasnet_tpu_torch.ops.affine import (affine_warp, affine_warp_video,
                                             compose, crop_resize_matrix,
                                             rotate_scale_matrix)

ATOL = 1e-5


def _both(img, m_port, m_jax, out_shape, fill_mode="zero"):
    """The port's warp of ``img``, checked against the JAX warp."""
    got = affine_warp(torch.from_numpy(img), m_port, out_shape,
                      fill_mode).numpy()
    want = np.asarray(jaff.affine_warp(jnp.asarray(img), m_jax, out_shape,
                                       fill_mode))
    np.testing.assert_allclose(got, want, atol=ATOL)
    return got


def _rs(angle, scale, h, w):
    return (rotate_scale_matrix(angle, scale, h, w),
            jaff.rotate_scale_matrix(jnp.float32(angle), jnp.float32(scale),
                                     h, w))


def _crop(top, left, ch, cw, oh, ow):
    return (crop_resize_matrix(top, left, ch, cw, oh, ow),
            jaff.crop_resize_matrix(jnp.float32(top), jnp.float32(left),
                                    jnp.float32(ch), jnp.float32(cw), oh, ow))


@pytest.mark.parametrize("angle, scale", [(0.0, 1.0), (180.0, 1.0),
                                          (0.0, 2.0), (30.0, 1.1),
                                          (-15.0, 0.8)])
def test_matrices_match_jax(angle, scale):
    mp, mj = _rs(angle, scale, 33, 20)
    np.testing.assert_allclose(mp.numpy(), np.asarray(mj), atol=1e-6)
    cp, cj = _crop(4, 2, 20, 24, 32, 30)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(compose(mp, cp).numpy(),
                               np.asarray(jaff.compose(mj, cj)), atol=1e-5)


def test_identity_rotation():
    img = np.random.default_rng(0).random((16, 16)).astype(np.float32)
    out = _both(img, *_rs(0.0, 1.0, 16, 16), (16, 16))
    np.testing.assert_allclose(out, img, atol=1e-5)


def test_rotation_180_is_flip():
    img = np.arange(64, dtype=np.float32).reshape(8, 8)
    out = _both(img, *_rs(180.0, 1.0, 8, 8), (8, 8))
    np.testing.assert_allclose(out, img[::-1, ::-1], atol=1e-4)


def test_scale_zoom_in_center_preserved():
    img = np.random.default_rng(1).random((33, 33)).astype(np.float32)
    out = _both(img, *_rs(0.0, 2.0, 33, 33), (33, 33))
    np.testing.assert_allclose(out[16, 16], img[16, 16], atol=1e-5)


def test_crop_full_is_identity():
    img = np.random.default_rng(2).random((12, 12)).astype(np.float32)
    out = _both(img, *_crop(0, 0, 12, 12, 12, 12), (12, 12))
    np.testing.assert_allclose(out, img, atol=1e-5)


def test_crop_quadrant():
    img = np.zeros((8, 8), np.float32)
    img[:4, :4] = 1.0
    out = _both(img, *_crop(0, 0, 4, 4, 8, 8), (8, 8), "edge")
    assert out[:7, :7].min() > 0.99


def test_compose_equals_sequential():
    img = np.random.default_rng(3).random((32, 32)).astype(np.float32)
    (cp, cj), (rp, rj) = _crop(4, 2, 20, 24, 32, 32), _rs(30.0, 1.1, 32, 32)
    once = _both(img, cp, cj, (32, 32))
    seq = _both(once, rp, rj, (32, 32))
    fused = _both(img, compose(rp, cp), jaff.compose(rj, cj), (32, 32))
    assert np.median(np.abs(seq - fused)) < 0.05


def test_channels_and_video_same_matrix_every_frame():
    vid = np.random.default_rng(4).random((3, 10, 10, 3)).astype(np.float32)
    mp, mj = _rs(15.0, 0.9, 10, 10)
    out = affine_warp_video(torch.from_numpy(vid), mp, (10, 10)).numpy()
    want = np.asarray(jaff.affine_warp_video(jnp.asarray(vid), mj, (10, 10)))
    np.testing.assert_allclose(out, want, atol=ATOL)
    per_frame = np.stack([_both(vid[t], mp, mj, (10, 10)) for t in range(3)])
    np.testing.assert_allclose(out, per_frame, atol=1e-6)


def test_warp_is_differentiable():
    img = torch.from_numpy(np.random.default_rng(5).random(
        (8, 8)).astype(np.float32)).requires_grad_()
    m = rotate_scale_matrix(10.0, 1.2, 8, 8)
    (affine_warp(img, m, (8, 8)) ** 2).sum().backward()
    assert torch.isfinite(img.grad).all() and img.grad.abs().sum() > 0


def test_fill_mode_is_checked():
    with pytest.raises(ValueError, match="fill_mode"):
        affine_warp(torch.zeros(4, 4), rotate_scale_matrix(0.0, 1.0, 4, 4),
                    (4, 4), "wrap")


def _smooth_video(t=2, h=24, w=24, c=None, seed=0):
    """A band-limited clip, so interpolation differences stay small (the
    clip of ``tests/test_affine_fast.py``)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for _ in range(t):
        f = np.zeros((h, w), np.float32)
        for _ in range(4):
            fy, fx = rng.uniform(0.05, 0.2, 2)
            f += np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3))
        frames.append(f)
    v = np.stack(frames) * 0.2 + 0.5
    if c:
        v = np.repeat(v[..., None], c, axis=-1)
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("scale", [0.7, 1.0, 1.4])
def test_zoom_equals_affine_fast(scale):
    v = _smooth_video()
    ref = affine_warp_video(v, rotate_scale_matrix(0.0, scale, 24, 24),
                            (24, 24))
    np.testing.assert_allclose(fast.scale_about_center(v, scale).numpy(),
                               ref.numpy(), atol=1e-4)


def test_crop_resize_equals_affine_fast():
    v = _smooth_video(c=3, seed=1)
    ref = affine_warp_video(v, crop_resize_matrix(3, 2, 15, 18, 24, 24),
                            (24, 24))
    out = fast.crop_resize_video(v, 3.0, 2.0, 15.0, 18.0, (24, 24))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.parametrize("angle, scale", [(-18.0, 1.0), (7.0, 1.0),
                                          (20.0, 1.0), (12.0, 1.2)])
def test_rotation_close_to_affine_fast(angle, scale):
    v = _smooth_video(h=32, w=32, seed=2)
    ref = affine_warp_video(v, rotate_scale_matrix(angle, scale, 32, 32),
                            (32, 32)).numpy()
    out = fast.rotate_scale_video(v, angle, scale).numpy()
    diff = np.abs(out - ref)[:, 6:-6, 6:-6]  # away from the fill borders
    assert np.median(diff) < 0.015, np.median(diff)
    assert diff.mean() < 0.02, diff.mean()
