"""Host-side dataset: packed cine store, window sampling, batches on the
device (the JAX package's ``data/dataset.py`` in torch).

* Every video is decoded and spatially resized once into a packed uint8
  store (``CineStore``), memory-mapped thereafter (same files and layout
  as the JAX package's, under ``<csv dir>/packed_store/`` by default).
* Per step the host gathers fixed-size (T_max, S, S) uint8 windows; the
  temporal resize, augmentation and normalisation run on the device
  (``transforms.make_preprocess_fn``).
* The host's randomness is numpy, seeded ``SeedSequence([seed, epoch])``
  for the epoch's order and ``SeedSequence([seed, epoch, batch])`` for each
  batch's windows, so the loader yields the same uint8 windows in the same
  order as the JAX package's. Only the device augmentation's draws differ:
  they come from a ``torch.Generator`` seeded ``seed * 100003 + epoch``.
* Eval iterates every interval of every video; the final ragged batch is
  padded and carries a ``valid`` mask.

Cine sources: ``.mat`` (scipy, key "cine", (T, H, W)) and ``.npy``, uint8
[0, 255] or float [0, 1].
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from protoasnet_tpu_torch.data.manifest import Manifest
from protoasnet_tpu_torch.data.transforms import make_preprocess_fn

__all__ = ["CineStore", "ASClipDataset", "ClipLoader", "get_as_dataloader"]


def _load_cine(path: str) -> np.ndarray:
    """Load a (T, H, W) cine loop as uint8 [0, 255]."""
    if path.endswith(".npy"):
        arr = np.load(path)
    elif path.endswith(".mat"):
        from scipy.io import loadmat

        arr = loadmat(path)["cine"]
    else:
        raise ValueError(f"Unsupported cine format: {path}")
    if arr.ndim != 3:
        raise ValueError(f"Cine at {path} must be (T, H, W), got "
                         f"{arr.shape}")
    if arr.dtype != np.uint8:
        arr = np.asarray(arr, dtype=np.float32)
        if arr.max() > 1.5:  # already [0, 255]-scaled floats
            arr = arr / 255.0
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return arr


def _resize_spatial(video: np.ndarray, size: int) -> np.ndarray:
    """Resize all frames of a (T, H, W) uint8 video to (T, size, size):
    the native core (area average down, bilinear up), else OpenCV."""
    from protoasnet_tpu_torch.data.native import resize_video_u8

    native = resize_video_u8(video, size)
    if native is not None:
        return native

    import cv2

    t = video.shape[0]
    out = np.empty((t, size, size), dtype=np.uint8)
    hw_first = np.ascontiguousarray(np.transpose(video, (1, 2, 0)))
    interp = cv2.INTER_AREA if video.shape[1] > size else cv2.INTER_LINEAR
    for s in range(0, t, 4):  # INTER_AREA takes at most 4 channels
        chunk = hw_first[:, :, s:s + 4]
        resized = cv2.resize(chunk, (size, size), interpolation=interp)
        if resized.ndim == 2:
            resized = resized[:, :, None]
        out[s:s + chunk.shape[2]] = np.transpose(resized, (2, 0, 1))
    return out


class CineStore:
    """Packed, spatially resized uint8 store over a manifest's videos: one
    flat ``store_<key>.bin`` of concatenated (T_i, S, S) blocks and an
    offsets index, built once per (videos, img_size)."""

    def __init__(self, data: np.ndarray, offsets: np.ndarray,
                 lengths: np.ndarray, img_size: int):
        self._data = data  # (total_frames, S, S) uint8, maybe a memmap
        self.offsets = offsets
        self.lengths = lengths
        self.img_size = img_size

    @classmethod
    def build(cls, paths: List[str], img_size: int,
              cache_dir: Optional[str] = None) -> "CineStore":
        key = hashlib.sha1(
            json.dumps([list(paths), img_size]).encode()).hexdigest()[:16]
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            bin_path = os.path.join(cache_dir, f"store_{key}.bin")
            idx_path = os.path.join(cache_dir, f"store_{key}.idx.npz")
            if os.path.exists(bin_path) and os.path.exists(idx_path):
                idx = np.load(idx_path)
                data = np.memmap(bin_path, dtype=np.uint8, mode="r").reshape(
                    -1, img_size, img_size)
                return cls(data, idx["offsets"], idx["lengths"], img_size)

        videos = []
        lengths = np.empty(len(paths), dtype=np.int64)
        for i, p in enumerate(paths):
            v = _resize_spatial(_load_cine(p), img_size)
            videos.append(v)
            lengths[i] = v.shape[0]
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]
                                 ).astype(np.int64)
        data = np.concatenate(videos, axis=0) if videos else np.zeros(
            (0, img_size, img_size), np.uint8)
        if cache_dir is not None:
            with open(bin_path, "wb") as f:
                f.write(data.tobytes())
            np.savez(idx_path, offsets=offsets, lengths=lengths)
            data = np.memmap(bin_path, dtype=np.uint8, mode="r").reshape(
                -1, img_size, img_size)
        return cls(data, offsets, lengths, img_size)

    def window(self, video_idx: int, start: int, end: int) -> np.ndarray:
        o = self.offsets[video_idx]
        return self._data[o + start:o + end]


class ASClipDataset:
    """Index over (video, window) samples for one (split, mode) pair."""

    def __init__(self, manifest: Manifest, store: CineStore, frames: int,
                 img_size: int, mode: str, iterate_intervals: bool,
                 interval_unit: str = "cycle",
                 transform_time_dilation: float = 0.2):
        self.manifest = manifest
        self.store = store
        self.frames = frames
        self.img_size = img_size
        self.mode = mode  # train / val / test / push
        self.iterate_intervals = iterate_intervals
        self.interval_unit = interval_unit
        self.ttd = transform_time_dilation if mode == "train" else 0.0

        vid_frames = manifest.frames
        if iterate_intervals:
            table = manifest.intervals
            self.t_max = int(np.max(table.end_frame - table.start_frame))
        else:
            if interval_unit == "image":
                wmax = np.full(len(manifest), self.frames, dtype=np.int64)
            else:
                wmax = (manifest.window_size * (1.0 + self.ttd)
                        ).astype(np.int64)
            self.t_max = int(np.max(np.minimum(vid_frames,
                                               np.maximum(wmax, 1))))

    def __len__(self) -> int:
        if self.iterate_intervals:
            return len(self.manifest.intervals)
        return len(self.manifest)

    def sample_window(self, item: int, rng: np.random.Generator):
        """(video_idx, start, end, interval_idx) of sample ``item``."""
        if self.iterate_intervals:
            t = self.manifest.intervals
            return (int(t.video_idx[item]), int(t.start_frame[item]),
                    int(t.end_frame[item]), int(t.interval_idx[item]))
        vid = item
        n_frames = int(self.manifest.frames[vid])
        if self.interval_unit == "image":
            wsize = int(self.frames)
        else:
            base = int(self.manifest.window_size[vid])
            if self.ttd > 0:
                wsize = max(int(base * rng.uniform(1 - self.ttd,
                                                   1 + self.ttd)), 1)
            else:
                wsize = base
        if wsize >= n_frames:
            return vid, 0, n_frames, 0
        start = int(rng.integers(0, n_frames - wsize + 1))
        return vid, start, start + wsize, 0

    def gather(self, items: np.ndarray, rng: np.random.Generator
               ) -> Dict[str, Any]:
        """A host batch (zero-padded uint8 windows and their metadata) for
        the given sample indices; the native gather when available."""
        b = len(items)
        vids = np.empty(b, dtype=np.int32)
        w_start = np.empty(b, dtype=np.int32)
        w_end = np.empty(b, dtype=np.int32)
        interval_idx = np.empty(b, dtype=np.int32)
        for k, item in enumerate(items):
            vids[k], w_start[k], w_end[k], interval_idx[k] = \
                self.sample_window(int(item), rng)

        from protoasnet_tpu_torch.data.native import gather_windows

        clips = gather_windows(self.store._data, self.store.offsets, vids,
                               w_start, w_end, self.t_max)
        if clips is None:
            clips = np.zeros((b, self.t_max, self.img_size, self.img_size),
                             dtype=np.uint8)
            for k in range(b):
                win = self.store.window(int(vids[k]), int(w_start[k]),
                                        int(w_end[k]))
                clips[k, :win.shape[0]] = win
        return {
            "clip_u8": clips,
            "t_len": (w_end - w_start).astype(np.int32),
            "video_idx": vids,
            "target_AS": self.manifest.labels[vids].astype(np.int32),
            "interval_idx": interval_idx,
            "window_start": w_start,
            "window_end": w_end,
            "original_length": self.manifest.frames[vids].astype(np.int32),
            "filename": list(self.manifest.filenames[vids]),
        }


class ClipLoader:
    """Batched iterator: host gathers (``num_workers`` threads, numpy only)
    and the device transform in the consumer thread.

    Yields dicts with ``cine`` on ``device``, (B, frames, S, S, 3) or
    (B, S, S, 3), ``target_dev`` (int64) and ``valid_dev`` (bool) on the
    device, and the host metadata (numpy) with a ``valid`` mask over the
    final batch's padding.
    """

    def __init__(self, dataset: ASClipDataset, batch_size: int,
                 device: Union[str, torch.device] = "cuda",
                 shuffle: bool = False,
                 sample_weights: Optional[np.ndarray] = None,
                 augment: bool = False, normalize: bool = True,
                 rotate_degrees: float = 10.0, min_crop_ratio: float = 0.7,
                 seed: int = 0, prefetch: int = 2, num_workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.sample_weights = sample_weights
        self.seed = seed
        self._epoch = 0
        self.augment = augment
        self.preprocess = make_preprocess_fn(
            frames_out=dataset.frames, img_size=dataset.img_size,
            do_normalize=normalize, augment=augment,
            rotate_degrees=rotate_degrees, min_crop_ratio=min_crop_ratio)
        self.prefetch = prefetch
        self.num_workers = max(int(num_workers), 1)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _order(self, rng: np.random.Generator) -> np.ndarray:
        n = len(self.dataset)
        if self.sample_weights is not None:
            p = self.sample_weights / self.sample_weights.sum()
            return rng.choice(n, size=n, replace=True, p=p)
        idx = np.arange(n)
        if self.shuffle:
            rng.shuffle(idx)
        return idx

    def host_batches(self) -> Iterator[Dict[str, Any]]:
        """The epoch's host batches (uint8 windows and metadata), in
        order."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, self._epoch]))
        order = self._order(rng)
        b = self.batch_size
        n_batches = len(self)

        def gather_batch(bi: int) -> Dict[str, Any]:
            # per-batch RNG keyed by (seed, epoch, batch): N workers give
            # the same epoch as one
            items = order[bi * b:(bi + 1) * b]
            valid = np.ones(b, dtype=bool)
            if len(items) < b:  # pad the final batch, mask the padding
                valid[len(items):] = False
                items = np.concatenate([items,
                                        np.full(b - len(items), items[-1])])
            brng = np.random.default_rng(np.random.SeedSequence(
                [self.seed, self._epoch, bi]))
            hb = self.dataset.gather(items, brng)
            hb["valid"] = valid
            return hb

        if self.num_workers == 1:
            for bi in range(n_batches):
                yield gather_batch(bi)
            return
        # in-order sliding window of futures: up to num_workers gathers at
        # once, results in batch order
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(self.num_workers)
        try:
            pending: deque = deque()
            nxt = 0
            ahead = self.num_workers + self.prefetch
            while nxt < n_batches and len(pending) < ahead:
                pending.append(ex.submit(gather_batch, nxt))
                nxt += 1
            while pending:
                hb = pending.popleft().result()
                if nxt < n_batches:
                    pending.append(ex.submit(gather_batch, nxt))
                    nxt += 1
                yield hb
        finally:
            # an abandoned epoch drops the queued gathers
            ex.shutdown(wait=False, cancel_futures=True)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        gen = torch.Generator().manual_seed(self.seed * 100003 + self._epoch)
        batches = self.host_batches()
        try:
            for step, hb in enumerate(batches):
                clips = torch.from_numpy(hb.pop("clip_u8")).to(self.device)
                t_len = torch.from_numpy(hb["t_len"]).to(self.device)
                hb["cine"] = self.preprocess(
                    clips, t_len, generator=gen if self.augment else None)
                hb["target_dev"] = torch.from_numpy(
                    hb["target_AS"].astype(np.int64)).to(self.device)
                hb["valid_dev"] = torch.from_numpy(hb["valid"]).to(
                    self.device)
                hb["step"] = step
                yield hb
        finally:
            batches.close()


def get_as_dataloader(config: Dict[str, Any], split: str, mode: str,
                      seed: int = 0,
                      store_cache: Optional[Dict[str, CineStore]] = None,
                      device: Union[str, torch.device] = "cuda"
                      ) -> ClipLoader:
    """Config-driven loader: ``mode`` in {train, val, push, test} sets the
    augmentation, interval iteration, sampler and batch size."""
    bsize = config["batch_size"]
    augment = bool(config.get("augmentation", False))
    iterate_intervals = False
    if mode != "train":
        augment = False
        if mode != "push":
            iterate_intervals = bool(config.get("iterate_intervals", False))
        else:
            # push is forward-only: it rides the eval batch size
            bsize = int(config.get("push_batch_size")
                        or config.get("eval_batch_size")
                        or max(bsize, 32))
        if config["frames"] == 1:
            bsize = config.get("eval_batch_size", 150)
        elif mode != "push" and config.get("eval_batch_size"):
            # video eval is forward-only (BN uses running stats), so it may
            # ride a larger batch than training
            bsize = int(config["eval_batch_size"])

    manifest = Manifest.from_csv(
        config["data_info_file"], view=config.get("view", "all"),
        split=split, sample_size=config.get("sample_size"),
        interval_unit=config.get("interval_unit", "cycle"),
        interval_quant=config.get("interval_quant", 1.0), seed=seed)
    img_size = config["img_size"]
    cache_key = (f"{config['data_info_file']}::{config.get('view', 'all')}"
                 f"::{split}::{img_size}")
    if store_cache is not None and cache_key in store_cache:
        store = store_cache[cache_key]
    else:
        cache_dir = config.get("store_cache_dir")
        if cache_dir is None:
            cache_dir = os.path.join(
                os.path.dirname(config["data_info_file"]) or ".",
                "packed_store")
        store = CineStore.build(list(manifest.paths), img_size,
                                cache_dir=cache_dir)
        if store_cache is not None:
            store_cache[cache_key] = store

    dataset = ASClipDataset(
        manifest, store, frames=config["frames"], img_size=img_size,
        mode=mode, iterate_intervals=iterate_intervals,
        interval_unit=config.get("interval_unit", "cycle"),
        transform_time_dilation=config.get("transform_time_dilation", 0.2))
    weights = None
    shuffle = False
    if mode == "train":
        if config.get("sampler", "random") == "AS":
            weights = manifest.class_sample_weights()
        else:
            shuffle = True
    loader = ClipLoader(
        dataset, batch_size=bsize, device=device, shuffle=shuffle,
        sample_weights=weights, augment=augment,
        normalize=bool(config.get("normalize", True)),
        rotate_degrees=config.get("transform_rotate_degrees", 10.0),
        min_crop_ratio=config.get("transform_min_crop_ratio", 0.7),
        seed=seed, num_workers=int(config.get("num_workers", 1) or 1))
    logging.info(f"dataloader[{split}/{mode}]: {len(dataset)} samples, "
                 f"{len(loader)} batches, t_max={dataset.t_max}, "
                 f"batch={bsize}, augment={augment}")
    return loader
