"""Local (per-sample) explanations, the JAX package's
``explain/local.py`` in torch.

For each eval sample the prototypes are ranked by contribution (similarity
times the readout weight of the predicted class), and each of the top-k
(sample, prototype) pairs is rendered as a panel: the input with its
occurrence overlay beside the prototype's source evidence from the latest
push.

The products (similarities, occurrence maps, logits, readout weights, the
clips) come from one no-grad sweep of ``agent.push_step`` over the eval
loader (on the card, the ROI-cosine kernel through ``push_forward``) and
are cached in ``<save_dir>/explain_<mode>/model_products.pickle``. A
sanity report of the cached predictions (mean F1, confusion matrix,
per-class report) uses the port's numpy metrics.

Under data parallelism every rank sweeps its rows and the outputs are
gathered into the global batches (``parallel/mesh.py``); rank 0 writes the
cache and the panels.
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from protoasnet_tpu_torch.data.transforms import NORM_MEAN, NORM_STD
from protoasnet_tpu_torch.explain.render import (compose_panel_clip,
                                                 compose_panel_frame,
                                                 heatmap_clip8, make_heatmap,
                                                 overlay_clip8, u8_clip,
                                                 upsample_occurrence_map,
                                                 write_video_or_frames)
from protoasnet_tpu_torch.parallel.mesh import (broadcast_object,
                                                gather_rows,
                                                global_batch_from_local,
                                                is_main)
from protoasnet_tpu_torch.train.metrics import _report, confusion, \
    f1_per_class
from protoasnet_tpu_torch.utils.io import load_pickle, save_pickle
from protoasnet_tpu_torch.utils.run import makedir

__all__ = ["TOP_K", "explain_local", "collect_model_products", "sweep",
           "latest_push_pickle"]

TOP_K = 3  # panels per sample: its prototypes of largest contribution


def latest_push_pickle(img_root: str) -> Optional[str]:
    """Path of the newest epoch dir's prototypes_info.pickle, or None.

    Push dirs are named ``epoch-{N}[_pushed]`` with N unpadded, so the
    sort is numeric: a lexicographic one would take epoch-9 over
    epoch-10."""
    if not os.path.isdir(img_root):
        return None

    def _epoch_key(name):
        m = re.search(r"\d+", name)
        return (int(m.group()) if m else -1, name)

    for e in sorted(os.listdir(img_root), key=_epoch_key, reverse=True):
        cand = os.path.join(img_root, e, "prototypes_info.pickle")
        if os.path.exists(cand):
            return cand
    return None


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def sweep(agent, mode: str):
    """One no-grad pass of ``agent.push_step`` over ``mode``'s loader.
    Yields, per batch: the batch, its valid-sample mask (numpy bool), the
    valid samples' similarities (1 - distance, numpy (n, P)), and the
    whole batch's occurrence maps and logits as the step returns them
    (every rank's rows, with the batch's clips, under data parallelism)."""
    loader = agent.data_loaders[mode.split("_")[0]]
    with torch.no_grad():
        for batch in loader:
            _, dist, occ, logits = agent.push_step(batch["cine"])
            dist, occ, logits = map(gather_rows, (dist, occ, logits))
            batch = global_batch_from_local(batch)
            v = np.asarray(batch["valid"]).astype(bool)
            yield batch, v, 1.0 - _host(dist)[v], occ, logits


def collect_model_products(agent, mode: str = "test") -> Dict[str, Any]:
    """Per-sample similarities, occurrence maps, logits, targets, file
    names and clips of the valid samples (one ``sweep``), and the readout
    kernel (P, K)."""
    sims, occs, logits_all, targets, files, clips = [], [], [], [], [], []
    for batch, v, sim, occ, logits in sweep(agent, mode):
        sims.append(sim)
        occs.append(_host(occ)[v])
        logits_all.append(_host(logits)[v])
        targets.append(np.asarray(batch["target_AS"])[v])
        files.extend([f for f, ok in zip(batch["filename"], v) if ok])
        cine = batch["cine"]
        clips.append((_host(cine) if isinstance(cine, torch.Tensor)
                      else np.asarray(cine, np.float32))[v])
    fc = _host(agent.model.last_layer.Dense_0.weight.detach().T)  # (P, K)
    return {
        "similarities": np.concatenate(sims),
        "occurrence_maps": np.concatenate(occs),
        "logits": np.concatenate(logits_all),
        "targets": np.concatenate(targets),
        "filenames": np.array(files),
        "clips": np.concatenate(clips),
        "fc_kernel": fc,
    }


def _sanity_report(products: Dict[str, Any], abstain: bool,
                   class_labels=None) -> Dict[str, Any]:
    """Mean F1, confusion matrix and per-class report of the cached
    predictions over the labels that occur (scikit-learn's defaults),
    logged and returned."""
    logits = products["logits"]
    k = logits.shape[1] - 1 if abstain else logits.shape[1]
    pred = logits[:, :k].argmax(axis=1)
    y = np.asarray(products["targets"])
    labels = [int(c) for c in np.union1d(y, pred)]
    names = [class_labels[c] if class_labels and c < len(class_labels)
             else str(c) for c in labels]
    f1 = float(np.mean(f1_per_class(y, pred, labels)))
    cm = confusion(y, pred, labels)
    report = _report(y, pred, labels, names)
    logging.info("explain sanity check — cached predictions:")
    logging.info(f"mean F1: {f1:.4f}")
    logging.info(f"confusion:\n{cm}")
    logging.info("\n" + report)
    return {"f1_mean": f1, "confusion": cm, "report": report}


def _overlay_panels(clip_norm: np.ndarray, occ_j: np.ndarray,
                    proto_img: Optional[np.ndarray],
                    proto_occ: Optional[np.ndarray],
                    title: str, out_base: str) -> None:
    """Four panels per frame: input, input overlay, prototype overlay,
    prototype; an MP4 for a clip, a PNG for an image or a one-frame
    clip."""
    from PIL import Image

    video = clip_norm.ndim == 4
    img = np.clip(clip_norm * NORM_STD + NORM_MEAN, 0, 1)
    up = upsample_occurrence_map(occ_j[None], img.shape[:-1])
    up = (up - up.min()) / (up.max() - up.min() + 1e-7)

    if proto_img is not None:
        p_img = np.clip(np.moveaxis(proto_img, 0, -1) * NORM_STD + NORM_MEAN,
                        0, 1)
        p_up = upsample_occurrence_map(proto_occ, p_img.shape[:-1])
        p_up = (p_up - p_up.min()) / (p_up.max() - p_up.min() + 1e-7)
    else:
        p_img = p_up = None

    labels = ("input", "input overlay", "prototype overlay", "prototype")
    if video:
        t_len = img.shape[0]
        img8 = u8_clip(img)
        panels8 = [img8, overlay_clip8(img8, heatmap_clip8(u8_clip(up)))]
        if p_img is not None:
            ti = np.arange(t_len)
            pc = (p_img[ti % p_img.shape[0]] if p_img.ndim == 4
                  else np.broadcast_to(p_img, (t_len,) + p_img.shape))
            pu = (p_up[ti % p_up.shape[0]] if p_up.ndim == 3
                  else np.broadcast_to(p_up, (t_len,) + p_up.shape))
            pc8 = u8_clip(pc)
            panels8 += [overlay_clip8(pc8, heatmap_clip8(u8_clip(pu))), pc8]
        # scale 1 for MP4s (the player upscales), 2 for a one-frame PNG
        frames = compose_panel_clip([], title,
                                    labels=labels[: len(panels8)],
                                    scale=1 if t_len > 1 else 2,
                                    panels8=panels8)
        if len(frames) > 1:
            write_video_or_frames(frames, out_base, fps=5)
        else:
            Image.fromarray(frames[0]).save(out_base + ".png")
        return

    panels = [img, 0.5 * img + 0.3 * make_heatmap(up)]
    if p_img is not None:
        panels += [0.5 * p_img + 0.3 * make_heatmap(p_up), p_img]
    frame = compose_panel_frame(panels, title, labels=labels[: len(panels)])
    Image.fromarray(frame).save(out_base + ".png")


def _separate_overlays(clip_norm, occ, contribution, out_root, sample_id):
    """``input_overlaid/<sample>``: the input overlaid with its top
    prototype's occurrence heatmap, alone."""
    from PIL import Image

    j = int(np.argmax(contribution))
    occ_j = np.moveaxis(occ, -1, 0)[j]
    img = np.clip(clip_norm * NORM_STD + NORM_MEAN, 0, 1)
    up = upsample_occurrence_map(occ_j[None], img.shape[:-1])
    up = (up - up.min()) / (up.max() - up.min() + 1e-7)
    out_dir = os.path.join(out_root, "input_overlaid")
    makedir(out_dir)
    if img.ndim == 4:
        frames = overlay_clip8(u8_clip(img), heatmap_clip8(u8_clip(up)))
        if len(frames) > 1:
            write_video_or_frames(
                frames, os.path.join(out_dir, f"{sample_id:04d}"), fps=5)
            return
        frame = frames[0]
    else:
        overlay = np.clip(0.5 * img + 0.3 * make_heatmap(up), 0, 1)
        frame = (overlay * 255).astype(np.uint8)
    Image.fromarray(frame).save(
        os.path.join(out_dir, f"{sample_id:04d}_0.png"))


def explain_local(agent, mode: str = "test") -> Dict[str, Any]:
    """Render local explanations of the eval set into
    ``<save_dir>/explain_<mode>/``: ``TOP_K`` panels per sample, its
    prototypes of largest contribution. Config ``explain_separate_overlays:
    true`` adds the standalone ``input_overlaid/`` renders. Returns the
    counts and seconds: samples, panels, sweep_s (0 when the products came
    from the cache), render_s and the sanity report (nothing on a rank
    other than 0, which only sweeps its rows).
    """
    out_dir = os.path.join(agent.save_dir, f"explain_{mode}")
    if is_main():
        makedir(out_dir)

    cand = latest_push_pickle(os.path.join(agent.save_dir, "img"))
    proto_info = None
    if cand is not None:
        proto_info = load_pickle(cand)
        logging.info(f"explain: using prototype evidence from {cand}")
    else:
        logging.warning("explain: no prototypes_info.pickle found — run "
                        "push first; prototype panels will be omitted")

    cache = os.path.join(out_dir, "model_products.pickle")
    sweep_s = 0.0
    if broadcast_object(os.path.exists(cache)):  # rank 0 decides
        if not is_main():
            return {}
        products = load_pickle(cache)
        logging.info(f"explain: reloaded cached products from {cache}")
    else:
        t0 = time.perf_counter()
        products = collect_model_products(agent, mode)
        sweep_s = time.perf_counter() - t0
        if not is_main():
            return {}
        save_pickle(products, cache)
    sanity = _sanity_report(products, agent.abstain_class,
                           getattr(agent, "class_labels", None))

    t0 = time.perf_counter()
    sims = products["similarities"]  # (N, P)
    fc = products["fc_kernel"]  # (P, K)
    n = len(sims)
    panels = 0
    for i in range(n):
        logits = products["logits"][i]
        k_eval = len(logits) - 1 if agent.abstain_class else len(logits)
        pred_class = int(np.argmax(logits[:k_eval]))
        contribution = sims[i] * fc[:, pred_class]  # (P,)
        order = np.argsort(-contribution)[:TOP_K]
        clip = products["clips"][i]
        if agent.config.get("explain_separate_overlays", False):
            try:
                _separate_overlays(clip, products["occurrence_maps"][i],
                                   contribution, out_dir, i)
            except Exception:  # noqa: BLE001 — one render; logged
                logging.exception(f"separate overlay failed for sample {i}")
        for rank, j in enumerate(order):
            occ_j = np.moveaxis(products["occurrence_maps"][i], -1, 0)[j]
            p_img = p_occ = None
            if proto_info is not None:
                p_img = proto_info["prototypes_src_imgs"][j]
                p_occ = proto_info["prototypes_occurrence_maps"][j]
                if p_occ is None or np.size(p_img) == 0:
                    p_img = p_occ = None  # the push found no sample for j
            title = (f"{products['filenames'][i]} | proto {j:02d} "
                     f"(rank {rank}) | sim {sims[i, j]:.3f} x w "
                     f"{fc[j, pred_class]:.3f} = {contribution[j]:.3f} | "
                     f"pred {pred_class} gt {int(products['targets'][i])}")
            base = os.path.join(out_dir, f"{i:04d}_rank{rank}_p{j:02d}")
            try:
                _overlay_panels(clip, occ_j, p_img, p_occ, title, base)
                panels += 1
            except Exception:  # noqa: BLE001 — one render; logged
                logging.exception(f"explain render failed for sample {i} "
                                  f"proto {j}")
    render_s = time.perf_counter() - t0
    logging.info(f"explain_local: wrote explanations for {n} samples to "
                 f"{out_dir}")
    return {"samples": n, "panels": panels, "sweep_s": sweep_s,
            "render_s": render_s, "sanity": sanity}
