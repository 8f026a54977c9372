"""Headline benchmark of the port: the video flagship's clips/s on one
NVIDIA GPU, with its MFU, the w8a8 int8 path, the train step and, on
request, the image model and the suite of end-to-end loops.

    python -m protoasnet_tpu_torch.bench [--quick] [--no-train] [--suite]
        [--batch 128] [--train-batch N] [--accum N] [--remat] [--fp32]
        [--no-int8] [--device cuda|cpu] [--detail_out PATH]

The port's counterpart of the root ``bench.py``, at its shapes and dtypes.
It prints ONE JSON line on stdout, with the root bench's keys:

    {"metric": "protoasnet_video_infer_clips_per_sec", "value": N,
     "unit": "clips/s", "vs_baseline": N, "mfu": N, "extra": {...}}

``vs_baseline`` is ``value`` over ``torch_cpu_infer_clips_per_sec`` of
``BASELINE_MEASURED.json`` (read, never written); ``extra`` holds every
other result rounded to 3 places, and ``train_vs_baseline`` over its
``torch_cpu_train_clips_per_sec``. The card's name and power limit
(``nvidia-smi``) and each section's ``roi_cosine_cuda`` launches go to
stderr. ``main(argv)`` returns the printed object with ``launches`` (by
section) added.

Sections, each on the flagship (R(2+1)D-18 cut after layer3, 40x256
prototypes, 32x112x112 clips, seeded random weights), bf16 unless
``--fp32``:

(a) the served forward at ``--batch`` (128): ``infer_clips_per_sec`` and
    ``infer_mfu`` of the model on a device-resident batch;
    ``serving_clips_per_sec`` and ``serving_mfu`` of
    ``serve.make_serving_fn``, the function the daemon's batcher calls
    (numpy in, host -> device copy, forward, numpy out). In the root
    bench "serving" meant the forward compiled with the weights as
    constants; on the card it is what the daemon runs;
(b) w8a8 int8 unless ``--no-int8``: the same two rates and MFUs of the
    ``quant.quantized_model`` of the model (activation scales calibrated
    on the first 8 clips), MFU against the card's int8 peak;
(c) the train step unless ``--no-train``: ``train.steps.make_xprotonet_
    steps`` with the root bench's criterion (``CRITERION``, its two zero
    weights included), ``GroupAdam`` (weight decay 1e-3, lr 1e-4) and
    ``--accum`` micro-steps an update, at ``--train-batch`` (default
    ``min(batch, 8)``, ``min(batch, 16)`` with ``--remat``; not the
    flagship config's train batch of 5): ``train_clips_per_sec``,
    ``flops_per_clip_train``, ``train_mfu``;
(d) with ``--quick`` or ``--suite``, the image ProtoASNet (ResNet-18,
    40x512 prototypes, 224x224, batch 128): ``image_infer_imgs_per_sec_
    bf16`` (``image_infer_imgs_per_sec`` with ``--fp32``),
    ``image_infer_mfu`` and, unless ``--no-int8``,
    ``image_infer_imgs_per_sec_int8``;
(e) with ``--suite``: the push scan over synthetic sets of 128 and 384
    videos at the push batch of 128 (``push_scan_clips_per_sec``; the same
    batches staged on the device first, ``push_scan_compute_clips_per_
    sec``; the two sets' difference, ``push_scan_marginal_clips_per_sec``,
    when the larger took measurably longer), a train epoch through the
    loader with augmentation (``train_epoch_clips_per_sec``), an eval
    epoch at batch 128 into ``DeviceEpochBuffer`` and ``EpochMetrics``
    (``eval_epoch_clips_per_sec``; on staged batches,
    ``eval_epoch_compute_clips_per_sec``) and 8 rendered prototype panels
    (``explain_render_clips_per_sec``). ``--detail_out PATH`` writes the
    results to PATH as JSON; nothing else is written outside a temporary
    directory.

Device sections are timed with CUDA events after warm-up
(``experiments/common.py::time_ms``); the suite's loops, which include the
host's work, on the host clock after a synchronize. MFU is the port's
FLOP count (``utils/flops.py``) times the rate over the card's peak. On
the card every section that runs the flagship or the image model, and the
push, must launch the ROI-cosine kernel, or the bench raises.

Without a card and without ``--device cpu`` it exits non-zero and prints
no rate. ``--device cpu`` runs every section on the CPU (host-clock
timings; MFU null, there being no peak rate for a CPU), for tests at the
small sizes they set in the module's config dicts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from protoasnet_tpu_torch.experiments.common import (card_line, time_ms,
                                                     wall_ms)
from protoasnet_tpu_torch.utils.device import resolve_device

__all__ = ["main", "make_train_step", "quantize", "VIDEO", "CLIP",
           "IMAGE", "IMAGE_SAMPLE", "IMAGE_BATCH", "SUITE", "CRITERION",
           "EPOCH_CRITERION", "METRIC"]

METRIC = "protoasnet_video_infer_clips_per_sec"
BASELINE = Path(__file__).resolve().parents[1] / "BASELINE_MEASURED.json"

# the flagship and its clip (bench.py:140-148)
VIDEO: Dict[str, Any] = {
    "name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
    "backbone_last_layer_num": -3, "prototype_shape": (40, 256, 1, 1, 1),
    "num_classes": 4, "img_size": 112}
CLIP = (32, 112, 112, 3)
# the image ProtoASNet (bench.py:438-446)
IMAGE: Dict[str, Any] = {
    "name": "XProtoNet", "base_architecture": "resnet18",
    "prototype_shape": (40, 512, 1, 1), "num_classes": 4, "img_size": 224}
IMAGE_SAMPLE = (224, 224, 3)
IMAGE_BATCH = 128
# the suite's sizes (bench.py:545-590, :598-610, :700-712): videos in
# the two push sets, their frame range, the loaders' batches, the train
# loader's gather threads, the rendered panels and their frames and map
SUITE: Dict[str, Any] = {
    "push_sets": (128, 384), "frames": (32, 48), "push_batch": 128,
    "train_batch": 8, "eval_batch": 128, "num_workers": 2,
    "render": 8, "render_frames": 32, "render_map": (8, 14, 14)}
# the train section's criterion (bench.py:315-323)
CRITERION: Dict[str, Dict[str, Any]] = {
    "CeLossAbstain": {"loss_weight": 1, "ab_weight": 0.3,
                      "ab_logitpath": "joined", "reduction": "mean"},
    "ClusterRoiFeat": {"loss_weight": 0.8, "reduction": "mean"},
    "SeparationRoiFeat": {"loss_weight": 0.08, "reduction": "mean"},
    "OrthogonalityLoss": {"loss_weight": 0.0, "mode": "per_class"},
    "Lnorm_occurrence": {"p": 2, "loss_weight": 0.0, "reduction": "mean"},
    "trans_occurrence": {"loss_weight": 0.001, "reduction": "mean"},
    "Lnorm_FC": {"p": 1, "loss_weight": 1e-4},
}
# the suite's train epoch criterion (bench.py:611-618)
EPOCH_CRITERION = {k: v for k, v in CRITERION.items()
                   if k not in ("OrthogonalityLoss", "Lnorm_occurrence")}
LR, WEIGHT_DECAY = 1e-4, 1e-3


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m protoasnet_tpu_torch.bench",
        description="the port's headline benchmark (one JSON line)")
    ap.add_argument("--quick", action="store_true",
                    help="shorter timings; adds the image model")
    ap.add_argument("--train", dest="train", action="store_true",
                    default=True, help="time the train step (default on)")
    ap.add_argument("--no-train", dest="train", action="store_false")
    ap.add_argument("--suite", action="store_true",
                    help="also the image model, the push scan, the train "
                         "and eval epochs and the explain render")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--train-batch", type=int, default=None,
                    help="train-step batch (default: min(batch, 8), or "
                         "min(batch, 16) with --remat)")
    ap.add_argument("--accum", type=int, default=1,
                    help="grad-accumulation micro-steps in the train step")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint the trunk's blocks in the train step")
    ap.add_argument("--bf16", dest="bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false",
                    help="fp32 instead of the bf16 default")
    ap.add_argument("--int8", dest="int8", action="store_true", default=True,
                    help="also the w8a8 int8 path (default on)")
    ap.add_argument("--no-int8", dest="int8", action="store_false")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (tests, small sizes)")
    ap.add_argument("--detail_out", default=None,
                    help="with --suite: write the results here as JSON")
    return ap.parse_args(argv)


class _Bench:
    """The device, the timers and the kernel's launch count by section."""

    def __init__(self, dev: torch.device, quick: bool):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.target_ms = 200.0 if quick else 1000.0
        self.launches: Dict[str, int] = {}

    def ms(self, fn: Callable[[], object]) -> float:
        """Device ms of ``fn()`` (CUDA events; the host clock on the CPU)."""
        if self.cuda:
            return time_ms(fn, target_ms=self.target_ms)
        return wall_ms(fn)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def mfu(self, flops: float, rate: float, dtype: str) -> Optional[float]:
        if not self.cuda:
            return None
        from protoasnet_tpu_torch.utils.flops import mfu

        return mfu(flops, rate, dtype, torch.cuda.get_device_name(self.dev))

    def section(self, name: str, fn: Callable[[], Dict[str, Any]],
                need_kernel: bool = True) -> Dict[str, Any]:
        """Run one section, counting ``roi_cosine_cuda``'s launches in it
        (a difference: the count is not reset, so a caller's count of the
        whole run stays whole)."""
        from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

        before = roi_cosine_cuda.launches
        out = fn()
        n = roi_cosine_cuda.launches - before
        self.launches[name] = n
        log(f"[{name}] roi_cosine_cuda launches {n}")
        if self.cuda and need_kernel and n == 0:
            raise RuntimeError(f"bench section {name!r} never launched the "
                               f"ROI-cosine kernel on {self.dev}")
        return out

    def free(self) -> None:
        if self.cuda:
            torch.cuda.empty_cache()


def _mfu_dtype(bf16: bool) -> str:
    return "bf16" if bf16 else "fp32"


def _model_cfg(cfg: Dict[str, Any], bf16: bool) -> Dict[str, Any]:
    out = dict(cfg)
    if bf16:
        out["dtype"] = "bfloat16"
    return out


def _forward_flops(model: torch.nn.Module, x1: torch.Tensor) -> float:
    from protoasnet_tpu_torch.utils.flops import count_flops

    with torch.inference_mode():
        return count_flops(lambda: model(x1))


def _served(b: _Bench, model, x: torch.Tensor, xnp: np.ndarray,
            flops: float, dtype: str, suffix: str) -> Dict[str, float]:
    """The forward's and the serving function's rates and MFUs."""
    from protoasnet_tpu_torch.serve import make_serving_fn

    n = len(x)
    with torch.inference_mode():
        ms = b.ms(lambda: model(x))
    fn = make_serving_fn(model)
    serve_ms = b.ms(lambda: fn(xnp))
    rate, serve_rate = n / ms * 1e3, n / serve_ms * 1e3
    log(f"inference{suffix}: {rate:.2f} clips/s ({ms:.2f} ms/batch-{n}); "
        f"serving fn (numpy in/out): {serve_rate:.2f} clips/s "
        f"({serve_ms:.2f} ms)")
    return {f"infer_clips_per_sec{suffix}": rate,
            f"infer_mfu{suffix}": b.mfu(flops, rate, dtype),
            f"serving_clips_per_sec{suffix}": serve_rate,
            f"serving_mfu{suffix}": b.mfu(flops, serve_rate, dtype)}


def quantize(model: torch.nn.Module, calib: torch.Tensor):
    """The w8a8 ``quant.quantized_model`` of ``model``, its activation
    scales calibrated once on the batch ``calib``."""
    from protoasnet_tpu_torch.quant import (build_qstate,
                                            calibrate_act_scales,
                                            quantized_model)

    t0 = time.perf_counter()
    qstate = build_qstate(model, calibrate_act_scales(model, [calib]))
    log(f"int8 calibration: {time.perf_counter() - t0:.1f}s "
        f"({len(qstate)} convs)")
    return quantized_model(model, qstate)


def make_train_step(model: torch.nn.Module, accum: int = 1,
                    criterion: Optional[Dict[str, Any]] = None):
    """The bench's train micro-step over ``model``: ``make_xprotonet_
    steps`` with ``criterion`` (default ``CRITERION``), 4 classes with
    abstention, ``GroupAdam`` at weight decay 1e-3 and an update every
    ``accum`` micro-steps. Returns ``train_step(cine, target, valid, lrs,
    affine=None, generator=None)``."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps

    opt = GroupAdam(model, {g: WEIGHT_DECAY for g in GROUPS})
    bundle = LossBundle(CRITERION if criterion is None else criterion,
                        num_classes=4, abstain_class=True)
    return make_xprotonet_steps(model, bundle, opt,
                                GradAccumulator(opt.params, accum),
                                stage="all")


def _train(b: _Bench, args, cfg, x: np.ndarray, rng) -> Dict[str, float]:
    """(c): the train micro-step's clips/s, FLOPs a clip and MFU."""
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import GROUPS
    from protoasnet_tpu_torch.utils.flops import count_flops

    if args.train_batch is not None:
        tb = args.train_batch
    else:
        tb = min(args.batch, 16) if args.remat else min(args.batch, 8)
    xt = x[:tb] if tb <= len(x) else rng.normal(
        size=(tb, *x.shape[1:])).astype(np.float32)
    model = build_model(dict(cfg, remat=bool(args.remat)), device=b.dev,
                        seed=0)
    step = make_train_step(model, args.accum)[0]
    xt = torch.from_numpy(np.ascontiguousarray(xt)).to(b.dev)
    y = torch.from_numpy(rng.integers(0, 3, size=tb)).to(b.dev)
    valid = torch.ones(tb, dtype=torch.bool, device=b.dev)
    lrs = {g: LR for g in GROUPS}
    gen = torch.Generator().manual_seed(0)
    ms = b.ms(lambda: step(xt, y, valid, lrs, generator=gen))
    rate = tb / ms * 1e3
    flops = count_flops(lambda: step(xt, y, valid, lrs, generator=gen)) / tb
    out = {"train_clips_per_sec": rate, "flops_per_clip_train": flops,
           "train_mfu": b.mfu(flops, rate, _mfu_dtype(args.bf16))}
    log(f"train: {rate:.2f} clips/s ({ms:.1f} ms/micro-step at batch {tb}, "
        f"accum {args.accum}{', remat' if args.remat else ''}); "
        f"{flops / 1e9:.1f} GFLOP/clip (fwd+bwd)")
    return out


def _image(b: _Bench, args, rng) -> Dict[str, float]:
    """(d): the image ProtoASNet's forward at batch ``IMAGE_BATCH``."""
    from protoasnet_tpu_torch.models.builder import build_model

    model = build_model(_model_cfg(IMAGE, args.bf16), device=b.dev, seed=0)
    ixnp = rng.normal(size=(IMAGE_BATCH, *IMAGE_SAMPLE)).astype(np.float32)
    ix = torch.from_numpy(ixnp).to(b.dev)
    with torch.inference_mode():
        ms = b.ms(lambda: model(ix))
    rate = IMAGE_BATCH / ms * 1e3
    flops = _forward_flops(model, ix[:1])
    key = ("image_infer_imgs_per_sec_bf16" if args.bf16
           else "image_infer_imgs_per_sec")
    out = {key: rate,
           "image_infer_mfu": b.mfu(flops, rate, _mfu_dtype(args.bf16))}
    log(f"image inference ({_mfu_dtype(args.bf16)}): {rate:.1f} imgs/s "
        f"({ms:.2f} ms/batch-{IMAGE_BATCH}; {flops / 1e9:.2f} GFLOP/img)")
    if args.int8:
        qmodel = quantize(model, ix[:16])
        with torch.inference_mode():
            qms = b.ms(lambda: qmodel(ix))
        out["image_infer_imgs_per_sec_int8"] = IMAGE_BATCH / qms * 1e3
        log(f"image inference (int8): {IMAGE_BATCH / qms * 1e3:.1f} imgs/s "
            f"({ms / qms:.2f}x)")
    return out


def _suite(b: _Bench, args, rng, tmp: str) -> Dict[str, float]:
    """(e): push scan, train epoch, eval epoch and explain render."""
    from protoasnet_tpu_torch.data.dataset import get_as_dataloader
    from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.models.layers import prototype_class_identity
    from protoasnet_tpu_torch.push.push import push_prototypes
    from protoasnet_tpu_torch.train.device_metrics import DeviceEpochBuffer
    from protoasnet_tpu_torch.train.metrics import EpochMetrics
    from protoasnet_tpu_torch.train.optim import GROUPS

    out: Dict[str, float] = {}
    t, s = CLIP[0], CLIP[1]
    vcfg = _model_cfg(VIDEO, args.bf16)
    p, k = int(VIDEO["prototype_shape"][0]), int(VIDEO["num_classes"])
    model = build_model(vcfg, device=b.dev, seed=0)
    push_step = make_train_step(model)[2]
    identity = prototype_class_identity(p, k)
    lo, hi = SUITE["frames"]
    base = {"view": "all", "sample_size": None, "sampler": "random",
            "normalize": True, "img_size": s, "frames": t,
            "iterate_intervals": False}

    def make_loader(n_videos: int, sub: str):
        csv = make_synthetic_dataset(
            os.path.join(tmp, sub), num_videos=n_videos, height=s, width=s,
            min_frames=lo, max_frames=hi, seed=0, splits=("train",))
        dcfg = dict(base, data_info_file=csv, augmentation=False,
                    batch_size=SUITE["train_batch"],
                    eval_batch_size=SUITE["push_batch"],
                    interval_unit="image", interval_quant=float(t))
        return get_as_dataloader(dcfg, "train", "push", seed=0,
                                 device=b.dev), csv

    def run_push(loader) -> float:
        b.sync()
        t0 = time.perf_counter()
        push_prototypes(loader, push_step, model.prototype_vectors,
                        class_identity=identity, abstain_class=True,
                        render=False, root_dir_for_saving_prototypes=None,
                        replace_prototypes=True)
        b.sync()
        return time.perf_counter() - t0

    def push_section():
        res = {}
        (small, _), (big, big_csv) = (make_loader(n, sub) for n, sub in zip(
            SUITE["push_sets"], ("s", "b")))
        n_s, n_b = len(small.dataset), len(big.dataset)
        run_push(small)  # warm: the kernel build, cuDNN's choices
        dt_s, dt_b = run_push(small), run_push(big)
        res["push_scan_clips_per_sec"] = n_s / dt_s
        log(f"push scan: {n_s} clips in {dt_s:.2f}s -> {n_s / dt_s:.1f} "
            f"clips/s; {n_b} clips in {dt_b:.2f}s")
        staged = list(small)  # every batch already on the device
        dt_c = run_push(staged)
        res["push_scan_compute_clips_per_sec"] = n_s / dt_c
        log(f"push scan (device-resident, loading excluded): {n_s} clips "
            f"in {dt_c:.2f}s -> {n_s / dt_c:.1f} clips/s")
        if dt_b > dt_s * 1.05:
            res["push_scan_marginal_clips_per_sec"] = \
                (n_b - n_s) / (dt_b - dt_s)
            log(f"push marginal: "
                f"{res['push_scan_marginal_clips_per_sec']:.1f} clips/s")
        else:
            log("push marginal: SKIPPED, the larger set was not measurably "
                "slower")
        return res, big_csv

    res, big_csv = b.section("e push", push_section)
    out.update(res)
    del model
    b.free()

    dtrain = dict(base, data_info_file=big_csv, augmentation=True,
                  transform_rotate_degrees=10, transform_min_crop_ratio=0.7,
                  transform_time_dilation=0.2,
                  batch_size=SUITE["train_batch"], interval_unit="cycle",
                  interval_quant=1.0, num_workers=SUITE["num_workers"])
    tmodel = build_model(vcfg, device=b.dev, seed=0)
    tstep, estep, _ = make_train_step(tmodel, 1, EPOCH_CRITERION)
    lrs = {g: LR for g in GROUPS}
    gen = torch.Generator().manual_seed(0)

    def train_epoch():
        tloader = get_as_dataloader(dtrain, "train", "train", seed=0,
                                    device=b.dev)

        def run_epoch(epoch: int):
            tloader.set_epoch(epoch)
            n = 0
            b.sync()
            t0 = time.perf_counter()
            for bt in tloader:
                tstep(bt["cine"], bt["target_dev"], bt["valid_dev"], lrs,
                      generator=gen)
                n += int(bt["cine"].shape[0])
            b.sync()
            return n, time.perf_counter() - t0

        run_epoch(0)  # warm
        n_e, dt_e = run_epoch(1)
        log(f"train epoch (loader, augmentation, step): {n_e} clips in "
            f"{dt_e:.2f}s -> {n_e / dt_e:.1f} clips/s")
        return {"train_epoch_clips_per_sec": n_e / dt_e}

    out.update(b.section("e train epoch", train_epoch))

    def eval_epoch():
        dval = dict(dtrain, augmentation=False,
                    eval_batch_size=SUITE["eval_batch"])
        vloader = get_as_dataloader(dval, "train", "val", seed=0,
                                    device=b.dev)

        def run_eval(batches, n_batches: int):
            buf, n = None, 0
            b.sync()
            t0 = time.perf_counter()
            for bt in batches:
                m = estep(bt["cine"], bt["target_dev"], bt["valid_dev"],
                          generator=gen)
                if buf is None:
                    buf = DeviceEpochBuffer(
                        n_batches=n_batches,
                        batch_size=m["logits"].shape[0],
                        num_logits=m["logits"].shape[1],
                        num_prototypes=m["similarities"].shape[1],
                        loss_names=sorted(k for k in m
                                          if k.startswith("loss")),
                        device=m["logits"].device)
                buf.update(m, bt["target_dev"], bt["valid_dev"])
                n += int(bt["cine"].shape[0])
            em = EpochMetrics(num_classes=k, abstain_class=True,
                              num_prototypes=p)
            buf.finalize(em)
            em.compute()
            return n, time.perf_counter() - t0

        vloader.set_epoch(0)
        run_eval(vloader, len(vloader))  # warm
        vloader.set_epoch(1)
        n_v, dt_v = run_eval(vloader, len(vloader))
        log(f"eval epoch (batch {SUITE['eval_batch']}, device metrics): "
            f"{n_v} clips in {dt_v:.2f}s -> {n_v / dt_v:.1f} clips/s")
        vloader.set_epoch(2)
        staged = list(vloader)
        n_c, dt_c = run_eval(staged, len(staged))
        log(f"eval epoch (device-resident, loading excluded): {n_c} clips "
            f"in {dt_c:.2f}s -> {n_c / dt_c:.1f} clips/s")
        return {"eval_epoch_clips_per_sec": n_v / dt_v,
                "eval_epoch_compute_clips_per_sec": n_c / dt_c}

    out.update(b.section("e eval epoch", eval_epoch))
    del tmodel, tstep, estep
    b.free()

    def render():
        from protoasnet_tpu_torch.explain.render import prototype_plot

        n = SUITE["render"]
        clip = rng.uniform(0, 1, size=(3, SUITE["render_frames"], s, s)
                           ).astype(np.float32)
        occ = rng.uniform(0, 1, size=(1, *SUITE["render_map"])
                          ).astype(np.float32)
        t0 = time.perf_counter()
        for j in range(n):
            prototype_plot(img=clip, occurrence_map=occ, proto_id=j,
                           fn=f"bench_{j}", pred=np.zeros(k, np.float32),
                           gt=0, proto_dir=tmp)
        dt = time.perf_counter() - t0
        log(f"explain render: {n} clip panels ({SUITE['render_frames']} "
            f"frames, MP4) in {dt:.2f}s -> {n / dt:.1f} clips/s")
        return {"explain_render_clips_per_sec": n / dt}

    out.update(b.section("e render", render, need_kernel=False))
    return out


def _baseline() -> Dict[str, Any]:
    if not BASELINE.exists():
        return {}
    with open(BASELINE) as f:
        return json.load(f)


def _round(v):
    return None if v is None else round(v, 3)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = _parse(argv)
    dev = resolve_device(args.device)
    b = _Bench(dev, args.quick)
    if b.cuda:
        log(f"device: {torch.cuda.get_device_name(dev)}; card "
            f"{card_line()}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}")
    else:
        log(f"device: cpu (rates on the CPU are no measure of the card); "
            f"torch {torch.__version__}")
    from protoasnet_tpu_torch.models.builder import build_model

    cfg = _model_cfg(VIDEO, args.bf16)
    dtype = _mfu_dtype(args.bf16)
    rng = np.random.default_rng(0)
    xnp = rng.normal(size=(args.batch, *CLIP)).astype(np.float32)
    result: Dict[str, Any] = {}
    model = build_model(cfg, device=dev, seed=0)
    x = torch.from_numpy(xnp).to(dev)

    def served():
        flops = _forward_flops(model, x[:1])
        out = {"flops_per_clip_fwd": flops,
               **_served(b, model, x, xnp, flops, dtype, "")}
        log(f"fwd: {flops / 1e9:.1f} GFLOP/clip -> infer MFU "
            f"{out['infer_mfu']} ({dtype} peak)")
        return out

    result.update(b.section("a served", served))
    if args.int8:
        result.update(b.section("b int8", lambda: _served(
            b, quantize(model, x[:8]), x, xnp,
            result["flops_per_clip_fwd"], "int8", "_int8")))
    del model, x
    b.free()
    if args.train:
        result.update(b.section("c train", lambda: _train(b, args, cfg, xnp,
                                                          rng)))
        b.free()
    if args.suite or args.quick:
        result.update(b.section("d image", lambda: _image(b, args, rng)))
        b.free()
    if args.suite:
        with tempfile.TemporaryDirectory(prefix="bench_suite_") as tmp:
            result.update(_suite(b, args, rng, tmp))
        if args.detail_out:
            with open(args.detail_out, "w") as f:
                json.dump({k: _round(v) for k, v in result.items()}, f,
                          indent=2)
            log(f"wrote {args.detail_out}")

    infer = result["infer_clips_per_sec"]
    base = _baseline()
    ref = base.get("torch_cpu_infer_clips_per_sec")
    vs_baseline = infer / ref if ref else None
    extra = {k: _round(v) for k, v in result.items()
             if k != "infer_clips_per_sec"}
    base_train = base.get("torch_cpu_train_clips_per_sec")
    if base_train and "train_clips_per_sec" in extra:
        extra["train_vs_baseline"] = round(
            extra["train_clips_per_sec"] / base_train, 3)
    log(f"roi_cosine_cuda launches by section: {b.launches}")
    line = {"metric": METRIC, "value": round(infer, 3), "unit": "clips/s",
            "vs_baseline": _round(vs_baseline),
            "mfu": None if result["infer_mfu"] is None
            else round(result["infer_mfu"], 4),
            "extra": extra}
    print(json.dumps(line), flush=True)
    return dict(line, launches=dict(b.launches))


if __name__ == "__main__":
    main(sys.argv[1:])
