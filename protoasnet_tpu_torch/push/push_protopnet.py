"""Classic ProtoPNet push: spatial-patch projection with receptive-field
boxes (the JAX package's ``push/push_protopnet.py`` in torch).

For each class-specific prototype find the training patch with the least
L2 distance across the push loader, record its conv-feature patch, the
receptive-field box and the 95th-percentile high-activation crop, save the
box arrays, the info pickle and the prototype pictures, then replace the
prototype vectors.

The per-batch, class-masked minimum over (batch, H, W) runs on the device;
only the (P,)-sized winners, their (P, D) patches and (P, H', W') distance
maps cross to the host, once per batch. The high-activation box needs
OpenCV (a bicubic upsampling), imported where it is used; the pictures are
composed with OpenCV and PIL (``explain/render.py``).

Under data parallelism each rank finds its rows' winners and they are
merged into the global first minimum (``parallel.mesh.
first_min_across_ranks``), the winning image with them; the boxes' sample
indices count the global batches' rows, and rank 0 writes the files.
Under prototype tensor parallelism (the model's ``prototype_shard``) each
model rank pushes its own P/m prototypes, the winners are gathered over
``model`` before the boxes and files, and each rank replaces its own rows.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from protoasnet_tpu_torch.data.transforms import NORM_MEAN, NORM_STD
from protoasnet_tpu_torch.parallel.mesh import (PrototypeShard,
                                                first_min_across_ranks,
                                                gather_objects_from_model,
                                                is_main)
from protoasnet_tpu_torch.push.receptive_field import (
    compute_proto_layer_rf_info_v2, compute_rf_prototype)
from protoasnet_tpu_torch.utils.io import save_pickle

__all__ = ["push_prototypes_patch", "find_high_activation_crop"]

_EPSILON = 1e-4


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy in the tensor's dtype (bf16, which numpy lacks, as
    fp32)."""
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _rows(batch: Dict[str, Any], key: str, host_key: str, dev
          ) -> torch.Tensor:
    """The rank's rows of a batch field: the loader's device tensor, else
    the host array (a batch made by hand, one process)."""
    if key in batch:
        return batch[key]
    return torch.from_numpy(np.asarray(batch[host_key])).to(dev)


def find_high_activation_crop(activation_map: np.ndarray,
                              percentile: float = 95) -> tuple:
    """(y0, y1, x0, x1): the bounding box of the activations at or above
    the percentile."""
    threshold = np.percentile(activation_map, percentile)
    mask = np.ones(activation_map.shape)
    mask[activation_map < threshold] = 0
    r = np.where(np.any(mask, axis=1))[0]
    c = np.where(np.any(mask, axis=0))[0]
    if len(r) == 0 or len(c) == 0:
        return 0, activation_map.shape[0], 0, activation_map.shape[1]
    return r[0], r[-1] + 1, c[0], c[-1] + 1


def _batch_patch_winners(dist: torch.Tensor, conv: torch.Tensor,
                        gt: torch.Tensor, valid: torch.Tensor,
                        class_id: torch.Tensor):
    """dist (B, H, W, P), conv (B, H, W, D), gt (B,), valid (B,) bool,
    class_id (P,) -> per prototype the batch's best (dist, sample, h, w,
    patch (P, D), distance map (P, H, W)) among the valid samples of its
    class: the first minimum of the flat (B*H*W) argmin; +inf where the
    batch has none."""
    b, h, w, p = dist.shape
    allowed = valid[:, None] & (gt[:, None] == class_id[None, :])  # (B, P)
    masked = torch.where(allowed[:, None, None, :], dist,
                         torch.full_like(dist, float("inf")))
    flat = masked.reshape(-1, p)
    idx = torch.argmin(flat, dim=0)  # first minimum, as jnp.argmin
    ar = torch.arange(p, device=dist.device)
    best = flat[idx, ar]
    bi = idx // (h * w)
    hi = (idx // w) % h
    wi = idx % w
    patch = conv[bi, hi, wi]
    dist_maps = torch.movedim(dist, -1, 1)[bi, ar]
    return best, bi, hi, wi, patch, dist_maps


@torch.no_grad()
def push_prototypes_patch(
    dataloader,
    push_step: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    model,
    class_identity: np.ndarray,  # (P, K)
    root_dir_for_saving_prototypes: Optional[str] = None,
    epoch_number: Optional[Any] = None,
    replace_prototypes: bool = True,
    img_size: int = 224,
    render: bool = True,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Scan the push loader; returns (new prototype vectors, info).

    ``push_step(cine)`` -> (conv_features (B, H', W', D), distances (B, H',
    W', P)); batches carry ``cine`` (B, H, W, 3) normalised images,
    ``target_AS`` and ``valid`` (host arrays). ``info`` holds ``bb``
    (P, 5: global sample index over the loader's order, y0, y1, x0, x1 of
    the high-activation box), ``bb_rf`` (the receptive-field box),
    ``prototypes_gts`` and ``prototypes_distances``. The new vectors are
    the winning patches where ``replace_prototypes`` (unmatched prototypes
    keep theirs), else ``model.prototype_vectors`` itself.
    """
    t0 = time.time()
    vectors = model.prototype_vectors
    shard = getattr(model, "prototype_shard", None)
    p = vectors.shape[0]  # this rank's; class_identity has every rank's
    lo = 0 if shard is None else shard.offset
    dev = vectors.device
    class_id = torch.from_numpy(np.argmax(
        class_identity, axis=1).astype(np.int64)[lo:lo + p]).to(dev)

    best_dist = np.full(p, np.inf)
    best_patch: Dict[int, np.ndarray] = {}
    best_img: Dict[int, np.ndarray] = {}
    best_loc: Dict[int, tuple] = {}
    best_map: Dict[int, np.ndarray] = {}
    best_gt = np.full(p, -1, np.int32)

    batch_start = 0  # running offset in the loader's order: global indices
    for batch in dataloader:
        cine = batch["cine"]  # the rank's rows
        conv, dist = push_step(cine)
        gt_h = np.asarray(batch["target_AS"])  # the global batch's
        best, bi, hi, wi, patch, maps = _batch_patch_winners(
            dist, conv, _rows(batch, "target_dev", "target_AS", dev),
            _rows(batch, "valid_dev", "valid", dev), class_id)
        best, bi, hi, wi, patch, maps, imgs = first_min_across_ranks(
            best, bi, cine.shape[0], hi, wi, patch, maps, cine[bi])
        b_best = best.double().cpu().numpy()
        # strict < as ProtoPNet's push, and the isfinite guard: a prototype
        # whose class has no valid sample in the batch gets +inf from the
        # all-masked argmin, and inf < inf must not record its index 0
        improved = np.isfinite(b_best) & (b_best < best_dist)
        if improved.any():
            b_bi, b_hi, b_wi, b_patch, b_maps, b_imgs = map(
                _host, (bi, hi, wi, patch, maps, imgs))
            for j in np.nonzero(improved)[0]:
                a = int(b_bi[j])
                best_dist[j] = b_best[j]
                best_patch[j] = b_patch[j]
                best_loc[j] = (batch_start + a, int(b_hi[j]), int(b_wi[j]))
                best_map[j] = b_maps[j]
                best_img[j] = b_imgs[j]  # (H, W, 3)
                best_gt[j] = gt_h[a]
        batch_start += len(gt_h)

    mine = sorted(best_patch)  # this rank's, for the replacement
    patches_mine = [best_patch[j] for j in mine]
    if shard is not None and shard.size > 1:
        best_dist, best_loc, best_map, best_img, best_gt = _gather_winners(
            shard, best_dist, best_loc, best_map, best_img, best_gt)
        found = sorted(best_loc)
        p = shard.total
    else:
        found = mine
    logging.info(f"protopnet push: scan {time.time() - t0:.1f}s, "
                 f"{len(found)}/{p} matched")

    ks, ss, ps = model.features.conv_info()
    rf_info = compute_proto_layer_rf_info_v2(
        img_size, ks, ss, ps, prototype_kernel_size=model.prototype_shape[2])

    proto_dir = None
    if root_dir_for_saving_prototypes is not None and is_main():
        proto_dir = (os.path.join(root_dir_for_saving_prototypes,
                                  f"epoch-{epoch_number}")
                     if epoch_number is not None
                     else root_dir_for_saving_prototypes)
        os.makedirs(proto_dir, exist_ok=True)

    bb_boxes = np.zeros((p, 5), np.int32)
    bb_rf = np.zeros((p, 5), np.int32)
    for j in found:
        a, hi, wi = best_loc[j]
        rf = compute_rf_prototype(img_size, (a, hi, wi), rf_info)
        bb_rf[j] = rf
        # the high-activation box of the upsampled similarity map
        act = np.log((best_map[j] + 1) / (best_map[j] + _EPSILON))
        import cv2

        act_up = cv2.resize(act, (img_size, img_size),
                            interpolation=cv2.INTER_CUBIC)
        y0, y1, x0, x1 = find_high_activation_crop(act_up)
        bb_boxes[j] = [a, y0, y1, x0, x1]
        if render and proto_dir is not None:
            try:
                _render_protopnet(proto_dir, j, best_img[j], act_up, rf,
                                  (y0, y1, x0, x1))
            except Exception:  # noqa: BLE001 — one bad render, not a push
                logging.exception(f"protopnet prototype {j} render failed")

    info = {"bb": bb_boxes, "bb_rf": bb_rf, "prototypes_gts": best_gt,
            "prototypes_distances": best_dist}
    if proto_dir is not None:
        np.save(os.path.join(proto_dir, "bb.npy"), bb_boxes)
        np.save(os.path.join(proto_dir, "bb-receptive_field.npy"), bb_rf)
        save_pickle(info, os.path.join(proto_dir, "prototypes_info.pickle"))

    new_vectors = vectors
    if replace_prototypes and mine:
        new_vectors = vectors.detach().clone()
        idx = torch.tensor(mine, dtype=torch.int64, device=dev)
        patches = torch.from_numpy(np.stack(patches_mine))
        new_vectors[idx, 0, 0] = patches.to(dev, new_vectors.dtype)
    logging.info(f"protopnet push total: {time.time() - t0:.1f}s")
    return new_vectors, info


def _gather_winners(shard: PrototypeShard, best_dist, best_loc, best_map,
                    best_img, best_gt):
    """Every model rank's winners (its prototypes j as j + its offset):
    (best_dist, best_loc, best_map, best_img, best_gt) over all P."""
    parts = gather_objects_from_model(
        (best_dist, best_loc, best_map, best_img, best_gt), shard)
    dists, gts = [], []
    locs, maps, imgs = {}, {}, {}
    for r, (d, loc, m, img, gt) in enumerate(parts):
        off = r * shard.local
        dists.append(d)
        gts.append(gt)
        for j in loc:
            locs[j + off], maps[j + off], imgs[j + off] = loc[j], m[j], img[j]
    return np.concatenate(dists), locs, maps, imgs, np.concatenate(gts)


def _render_protopnet(proto_dir: str, j: int, img_norm: np.ndarray,
                      act_up: np.ndarray, rf, crop_box) -> None:
    """``prototype-img{j:02d}.png``: the image, its receptive-field crop,
    its high-activation crop and the activation overlay side by side (each
    crop scaled to the image's size)."""
    import cv2
    from PIL import Image

    from protoasnet_tpu_torch.explain.render import (compose_panel_frame,
                                                     make_heatmap)

    img = np.clip(np.asarray(img_norm, np.float32) * NORM_STD + NORM_MEAN,
                  0, 1)
    h, w = img.shape[:2]

    def crop(y0, y1, x0, x1):
        part = img[y0:y1, x0:x1]
        if part.size == 0:
            return np.zeros_like(img)
        return cv2.resize(part, (w, h), interpolation=cv2.INTER_NEAREST)

    act = act_up - act_up.min()
    act = act / (act.max() + 1e-7)
    overlay = np.clip(0.5 * img + 0.3 * make_heatmap(act), 0, 1)
    frame = compose_panel_frame(
        [img, crop(*rf[1:]), crop(*crop_box), overlay],
        f"prototype {j:02d}",
        labels=("original", "receptive field", "high activation crop",
                "activation overlay"))
    Image.fromarray(frame).save(os.path.join(proto_dir,
                                             f"prototype-img{j:02d}.png"))
