"""Sub-clip interval computation (numpy; the JAX package's
``data/intervals.py``).

Each cine video is cut into deterministic sub-clip windows sized in
``image`` / ``second`` / ``cycle`` units (one cycle = 60000 /
frame_time_ms / heart_rate frames). Videos shorter than one window yield a
single full-length interval; an empty manifest yields an empty table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

__all__ = ["compute_window_sizes", "compute_intervals", "IntervalTable"]


@dataclass
class IntervalTable:
    """Expanded (video, interval) table for exhaustive eval iteration."""

    video_idx: np.ndarray  # (M,) int32 — row index into the manifest
    interval_idx: np.ndarray  # (M,) int32 — the interval's index in its video
    start_frame: np.ndarray  # (M,) int32
    end_frame: np.ndarray  # (M,) int32 (exclusive)

    def __len__(self) -> int:
        return len(self.video_idx)


def compute_window_sizes(
    frames: np.ndarray,
    frame_time_ms: np.ndarray,
    heart_rate: np.ndarray,
    unit: str,
    quantity: float,
) -> np.ndarray:
    """Per-video window size in frames for the given interval unit."""
    frames = np.asarray(frames)
    if unit == "image":
        if int(quantity) < 1:
            raise ValueError("Must draw >= 1 image per video")
        window = np.full(frames.shape, int(quantity), dtype=np.int32)
    elif unit == "second":
        window = (quantity * 1000.0 / np.asarray(frame_time_ms)
                  ).astype(np.int32)
    elif unit == "cycle":
        window = (
            quantity * 60000.0 / np.asarray(frame_time_ms)
            / np.asarray(heart_rate)
        ).astype(np.int32)
    else:
        raise ValueError(f"Unit should be image/second/cycle, got {unit}")
    if (window < 1).any():
        raise ValueError("Detected proposed window size of 0")
    return window


def compute_intervals(
    frames: np.ndarray,
    frame_time_ms: np.ndarray,
    heart_rate: np.ndarray,
    unit: str,
    quantity: float,
) -> Tuple[np.ndarray, np.ndarray, IntervalTable]:
    """Returns (window_size, num_intervals, expanded interval table)."""
    frames = np.asarray(frames).astype(np.int64)
    window = compute_window_sizes(frames, frame_time_ms, heart_rate, unit,
                                  quantity)
    num_intervals = (frames // window).astype(np.int32)

    # Empty manifest (a split/view filter matching zero videos): return an
    # empty table instead of letting np.repeat raise an opaque broadcast
    # error from the length-1 offsets array below.
    if len(frames) == 0:
        z = np.zeros(0, np.int32)
        return window, num_intervals, IntervalTable(z, z, z, z)

    # Videos shorter than one window produce a single [0, frames) interval.
    counts = np.maximum(num_intervals, 1)
    video_idx = np.repeat(np.arange(len(frames), dtype=np.int32), counts)
    # interval_idx = 0..count-1 within each video
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    interval_idx = (np.arange(counts.sum())
                    - np.repeat(offsets, counts)).astype(np.int32)

    w = window[video_idx].astype(np.int32)
    start = interval_idx * w
    end = start + w
    short = num_intervals[video_idx] == 0
    start = np.where(short, 0, start).astype(np.int32)
    end = np.where(short, frames[video_idx], end).astype(np.int32)

    table = IntervalTable(video_idx, interval_idx, start, end)
    return window, num_intervals, table
