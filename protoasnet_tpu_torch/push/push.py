"""Prototype push: project each prototype onto its nearest training ROI
(the JAX package's ``push/push.py`` in torch).

* the per-batch winner search runs on the device (class-masked argmin
  over the batch), and the running best per prototype stays there: the
  scan synchronises with the host once, at the end;
* the winners' source clips are re-assembled once at the end from the
  recorded (video, window) metadata;
* the abstain prototypes are not class-specific: any sample may win them;
* under data parallelism each rank finds its rows' winners and they are
  merged into the global batch's first minimum
  (``parallel.mesh.first_min_across_ranks``: a tie goes to the lowest
  global row, as the single-process argmin gives), so every rank holds
  the same winners; rank 0 writes the files;
* under prototype tensor parallelism (``prototype_vectors`` a block of
  the ``model`` axis, ``parallel.mesh.prototype_param_shardings``) each
  model rank pushes its own P/m prototypes over its data rank's rows, the
  winners merged over the ``data`` group as above; the winners are then
  gathered over ``model`` so that every rank holds all P (the pickle keeps
  the JAX package's layout), and each rank replaces its own rows.

Writes ``prototypes_info.pickle`` with the JAX package's schema
(channels-first layouts) and, with ``render``, each prototype's evidence;
returns the new prototype vectors when ``replace_prototypes``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from protoasnet_tpu_torch.parallel.mesh import (first_min_across_ranks,
                                                gather_from_model, is_main)
from protoasnet_tpu_torch.utils.io import save_pickle

__all__ = ["push_prototypes", "batch_winners"]


def batch_winners(dist, occ, roi, gt, valid, class_id, class_specific):
    """Per-prototype winner within one batch.

    dist (B, P) = 1 - cosine01; occ (B, ..., P); roi (B, P, D); gt (B,);
    valid (B,) bool; class_id (P,) int; class_specific (P,) bool. Returns
    best_dist (P,), best_idx (P,), winner_roi (P, D), winner_occ (P, ...).
    """
    allowed = valid[:, None] & ((~class_specific)[None, :]
                                | (gt[:, None] == class_id[None, :]))
    masked = torch.where(allowed, dist,
                         torch.full_like(dist, float("inf")))
    best_idx = torch.argmin(masked, dim=0)  # first minimum, as jnp.argmin
    ar = torch.arange(dist.shape[1], device=dist.device)
    best_dist = masked[best_idx, ar]
    winner_roi = roi[best_idx, ar]
    winner_occ = torch.movedim(occ, -1, 1)[best_idx, ar]
    return best_dist, best_idx, winner_roi, winner_occ


def _update_carry(carry, dist, occ, roi, logits, gt, valid, class_id,
                  class_specific):
    """Fold one batch into the running per-prototype best, on the device.
    ``<=``: a tie keeps the latest batch's winner. The isfinite guard: an
    all-masked batch gives inf, and inf <= inf would record a wrong-class
    winner for a prototype whose class never appears."""
    b_dist, b_idx, b_roi, b_occ = batch_winners(
        dist, occ, roi, gt, valid, class_id, class_specific)
    b_dist, b_idx, b_roi, b_occ, b_logits, b_gt = first_min_across_ranks(
        b_dist, b_idx, dist.shape[0], b_roi, b_occ, logits[b_idx],
        gt[b_idx])
    better = (b_dist <= carry["dist"]) & torch.isfinite(b_dist)

    def sel(new, old):
        return torch.where(better.reshape((-1,) + (1,) * (new.dim() - 1)),
                           new, old)

    return {
        "dist": torch.where(better, b_dist, carry["dist"]),
        "roi": sel(b_roi.float(), carry["roi"]),
        "occ": sel(b_occ.float(), carry["occ"]),
        "logits": sel(b_logits.float(), carry["logits"]),
        "gt": torch.where(better, b_gt, carry["gt"]),
        "batch_id": torch.where(better, carry["scan_pos"], carry["batch_id"]),
        "sample_idx": torch.where(better, b_idx, carry["sample_idx"]),
        "scan_pos": carry["scan_pos"] + 1,
    }


def _init_carry(p: int, roi, occ, logits, dev) -> Dict[str, torch.Tensor]:
    return {
        "dist": torch.full((p,), float("inf"), device=dev),
        "roi": torch.zeros(roi.shape[1:], device=dev),
        "occ": torch.zeros((p,) + tuple(occ.shape[1:-1]), device=dev),
        "logits": torch.zeros((p, logits.shape[-1]), device=dev),
        "gt": torch.full((p,), -1, dtype=torch.int64, device=dev),
        "batch_id": torch.full((p,), -1, dtype=torch.int64, device=dev),
        "sample_idx": torch.full((p,), -1, dtype=torch.int64, device=dev),
        "scan_pos": torch.zeros((), dtype=torch.int64, device=dev),
    }


@torch.no_grad()
def push_prototypes(
    dataloader,
    push_step: Callable[[torch.Tensor], Tuple[torch.Tensor, ...]],
    prototype_vectors: torch.Tensor,  # (P, D)
    class_identity: np.ndarray,  # (P, K)
    class_specific: bool = True,
    abstain_class: bool = True,
    root_dir_for_saving_prototypes: Optional[str] = None,
    epoch_number: Optional[Any] = None,
    replace_prototypes: bool = True,
    render: bool = True,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Scan the push loader; returns (new prototype vectors, info).

    ``push_step(cine)`` -> (roi, dist, occ, logits). ``info`` is the
    ``prototypes_info.pickle`` payload. The new vectors are the winning ROI
    features when ``replace_prototypes`` (unmatched prototypes keep
    theirs), else ``prototype_vectors`` itself.
    """
    t0 = time.time()
    p, k = class_identity.shape
    proto_class_specific = np.full(p, class_specific)
    if abstain_class:
        k_real = k - 1
        if k_real < 2:
            raise ValueError("Abstention-push needs >= 2 non-abstain "
                             "classes")
        proto_class_specific[k_real * (p // k):p] = False
    dev = prototype_vectors.device
    shard = getattr(prototype_vectors, "prototype_shard", None)
    mine = slice(0, p) if shard is None else slice(
        shard.offset, shard.offset + shard.local)
    class_id = torch.from_numpy(
        np.argmax(class_identity, axis=1).astype(np.int64)[mine]).to(dev)
    class_spec = torch.from_numpy(proto_class_specific[mine]).to(dev)

    carry = None
    batch_meta = []  # host window metadata per batch, by batch_id
    for batch in dataloader:
        roi, dist, occ, logits = push_step(batch["cine"])
        if carry is None:
            carry = _init_carry(roi.shape[1], roi, occ, logits, dev)
        carry = _update_carry(carry, dist.float(), occ, roi, logits,
                              batch["target_dev"], batch["valid_dev"],
                              class_id, class_spec)
        batch_meta.append({
            "filename": list(batch["filename"]),
            "video_idx": np.asarray(batch["video_idx"]),
            "window_start": np.asarray(batch["window_start"]),
            "window_end": np.asarray(batch["window_end"]),
        })
    if carry is None:
        raise ValueError("push dataloader yielded no batches")
    # every model rank's winners: all P
    host = {name: gather_from_model(t, 0, shard).cpu().numpy()
            for name, t in carry.items() if name not in ("roi", "scan_pos")}
    best_dist = host["dist"].astype(np.float64)
    best_gt = host["gt"].astype(np.int32)
    found = [j for j in range(p) if host["batch_id"][j] >= 0]
    best_occ = {j: host["occ"][j] for j in found}
    best_logits = {j: host["logits"][j] for j in found}
    best_meta: Dict[int, Dict[str, Any]] = {}
    for j in found:
        bm = batch_meta[int(host["batch_id"][j])]
        a = int(host["sample_idx"][j])
        best_meta[j] = {"filename": bm["filename"][a],
                        "video_idx": int(bm["video_idx"][a]),
                        "window_start": int(bm["window_start"][a]),
                        "window_end": int(bm["window_end"][a])}
    logging.info(f"push: scanned dataset in {time.time() - t0:.1f}s; "
                 f"{len(found)}/{p} prototypes matched")

    # the winners' source clips, deduplicated (push never augments)
    dataset = getattr(dataloader, "dataset", None)
    preprocess = getattr(dataloader, "preprocess", None)
    if found and dataset is not None and preprocess is not None:
        keys: Dict[Tuple[int, int, int], list] = {}
        for j in found:
            m = best_meta[j]
            keys.setdefault((m["video_idx"], m["window_start"],
                             m["window_end"]), []).append(j)
        uniq = list(keys)
        s = dataset.img_size
        clips_u8 = np.zeros((len(uniq), dataset.t_max, s, s), np.uint8)
        t_lens = np.ones(len(uniq), np.int32)
        for i, (vid, start, end) in enumerate(uniq):
            win = dataset.store.window(vid, start, end)
            clips_u8[i, :win.shape[0]] = win
            t_lens[i] = win.shape[0]
        clips = preprocess(torch.from_numpy(clips_u8).to(dev),
                           torch.from_numpy(t_lens).to(dev))
        winner_clips = clips.cpu().numpy()
        for i, key in enumerate(uniq):
            for j in keys[key]:
                best_meta[j]["item_clip"] = winner_clips[i]
    else:
        for j in found:
            best_meta[j].setdefault("item_clip",
                                    np.zeros((1, 1, 1, 3), np.float32))

    def to_ref_img(clip: np.ndarray) -> np.ndarray:
        # (T, S, S, 3) -> (3, T, S, S); (S, S, 3) -> (3, S, S)
        if clip.ndim == 4:
            return np.transpose(clip, (3, 0, 1, 2))
        return np.transpose(clip, (2, 0, 1))

    def to_ref_occ(occ_j: np.ndarray) -> np.ndarray:
        return occ_j[None]  # (1, [T',] H', W')

    info = {
        "prototypes_filenames": np.array(
            [best_meta[j]["filename"] if j in best_meta else ""
             for j in range(p)]),
        "prototypes_src_imgs": np.array(
            [to_ref_img(best_meta[j]["item_clip"]) if j in best_meta
             else np.zeros(0, np.float32) for j in range(p)], dtype=object)
        if len(found) < p else np.stack(
            [to_ref_img(best_meta[j]["item_clip"]) for j in range(p)]),
        "prototypes_gts": best_gt.copy(),
        "prototypes_preds": np.stack(
            [best_logits.get(j, np.zeros(k, np.float32)) for j in range(p)]),
        "prototypes_occurrence_maps": np.stack(
            [to_ref_occ(best_occ[j]) for j in range(p)])
        if len(found) == p else np.array(
            [to_ref_occ(best_occ[j]) if j in best_occ else None
             for j in range(p)], dtype=object),
        "prototypes_similarity_to_src_ROIs": 1.0 - best_dist,
    }

    proto_dir = None
    if root_dir_for_saving_prototypes is not None and is_main():
        proto_dir = (os.path.join(root_dir_for_saving_prototypes,
                                  f"epoch-{epoch_number}")
                     if epoch_number is not None
                     else root_dir_for_saving_prototypes)
        os.makedirs(proto_dir, exist_ok=True)
        save_pickle(info, os.path.join(proto_dir, "prototypes_info.pickle"))

    if render and proto_dir is not None:
        from protoasnet_tpu_torch.explain.render import prototype_plot

        for j in found:
            try:
                prototype_plot(
                    img=to_ref_img(best_meta[j]["item_clip"]),
                    occurrence_map=to_ref_occ(best_occ[j]), proto_id=j,
                    fn=str(best_meta[j]["filename"]), pred=best_logits[j],
                    gt=int(best_gt[j]), proto_dir=proto_dir)
            except Exception:  # noqa: BLE001 — one bad render, not a push
                logging.exception(f"prototype {j} visualization failed")

    new_vectors = prototype_vectors
    if replace_prototypes:
        if len(found) != p:
            logging.warning(f"push: only {len(found)}/{p} prototypes "
                            f"matched; unmatched prototypes keep their "
                            f"vectors")
        new_vectors = prototype_vectors.detach().clone()
        idx = torch.tensor([j - mine.start for j in found
                            if mine.start <= j < mine.stop],
                           dtype=torch.int64, device=dev)
        new_vectors[idx] = carry["roi"][idx].to(new_vectors.dtype)
        logging.info("push: prototype vectors replaced with winning ROI "
                     "features")
    logging.info(f"push total time: {time.time() - t0:.1f}s")
    return new_vectors, info
