"""Synthetic echo fixture dataset (the JAX package's ``data/synthetic.py``;
the manifest written with the ``csv`` module).

Random cine loops (.npy) and a CSV manifest with the dataset's columns
(path, view, split, as_label, frames, frame_time, heart_rate), so train,
eval and push run without real data. Class-conditioned blob dynamics make
the labels weakly learnable. The same seed writes the same files as the
JAX package.
"""

from __future__ import annotations

import csv
import os

import numpy as np

__all__ = ["make_synthetic_dataset"]

_FIELDS = ["path", "view", "split", "as_label", "frames", "frame_time",
           "heart_rate"]


def _synth_cine(rng: np.random.Generator, t: int, h: int, w: int,
                label: int) -> np.ndarray:
    """A noisy moving bright blob whose size and speed depend on the
    label."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h / 2.0, w / 2.0
    radius = (0.12 + 0.08 * label) * min(h, w)
    speed = 0.2 + 0.15 * label
    frames = np.empty((t, h, w), dtype=np.float32)
    phase = rng.uniform(0, 2 * np.pi)
    for i in range(t):
        ang = phase + speed * i
        by = cy + 0.25 * h * np.sin(ang)
        bx = cx + 0.25 * w * np.cos(ang)
        blob = np.exp(-(((yy - by) ** 2 + (xx - bx) ** 2)
                        / (2 * radius ** 2)))
        frames[i] = 0.55 * blob
    frames += rng.uniform(0.0, 0.25, size=(t, 1, 1)).astype(np.float32)
    frames += rng.normal(0, 0.04, size=frames.shape).astype(np.float32)
    return np.clip(frames * 255.0, 0, 255).astype(np.uint8)


def make_synthetic_dataset(root: str, num_videos: int = 24,
                           num_classes: int = 3, height: int = 80,
                           width: int = 96, min_frames: int = 24,
                           max_frames: int = 72, seed: int = 0,
                           views=("plax", "psax"),
                           splits=("train", "train", "train", "val", "test")
                           ) -> str:
    """Write cines and the manifest under ``root``; returns the CSV path."""
    rng = np.random.default_rng(seed)
    cine_dir = os.path.join(root, "cines")
    os.makedirs(cine_dir, exist_ok=True)
    rows = []
    for i in range(num_videos):
        label = int(i % num_classes)
        t = int(rng.integers(min_frames, max_frames + 1))
        cine = _synth_cine(rng, t, height, width, label)
        path = os.path.join(cine_dir, f"vid_{i:04d}.npy")
        np.save(path, cine)
        heart_rate = float(rng.uniform(55, 100))
        frame_time = float(rng.uniform(18, 35))  # ms per frame
        rows.append({"path": path, "view": views[i % len(views)],
                     "split": splits[i % len(splits)], "as_label": label,
                     "frames": t, "frame_time": frame_time,
                     "heart_rate": heart_rate})
    csv_path = os.path.join(root, "manifest.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=_FIELDS,
                                lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    return csv_path
