"""Chip smoke of the PyTorch/H100 port: the serving paths of the video
flagship (Video ProtoASNet), the ProtoPNet baseline and the image
ProtoASNet on one NVIDIA GPU, through the hand-written CUDA kernels, and
the experiment entry points of the R(2+1)D block kernels.

    python3 chip_smoke.py

Phases (each prints one or more informational lines; any failed check
raises and the script exits non-zero without printing a result):

1. build the CUDA kernels from ``protoasnet_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together) and print ptxas' registers, shared
   memory and spills of each kernel instantiation;
2. hold each kernel against its plain PyTorch version on the card and time
   the wrapper call, the kernel alone on the device (profiler), the plain
   version, their bound and a library reference: ``roi_cosine_cuda`` at
   the video head shape (N=128, S=8*14*14, P=40, D=256) and at the image
   head shape (N=128, S=7*7, P=40, D=512), fp32 and bf16 inputs, beside
   ``torch.bmm`` of the roi product in the same dtype; ``l2_min_cuda`` at
   ProtoPNet's head shape (N=128 and 8, S=7*7, P=30, D=512) beside
   ``torch.cdist``; both against a float64 plain version;
3. build each model at full width with seeded random weights; at fp32
   with TF32 off hold the kernel-head outputs against the plain-head
   outputs on the card, and the card's logits against the same model on
   the CPU (for ProtoPNet also the ``push_forward`` distance map); fold
   three of the flagship's stride-1 Conv2Plus1D blocks (layer1_0.conv1,
   layer2_1.conv1, layer3_1.conv1, with seeded BN statistics) and hold
   ``fused_c2p1d_cuda`` against the float64 plain version and the
   module's own eval forward (fp32, 1e-5 of max |ref|) and the plain
   version on the same bf16 inputs (bf16, 1e-2);
4. the main paths, one after the other: write a port bundle,
   ``server.serve_forever`` on port 0 in a thread, POST samples to
   /v1/predict, check the logits against a direct forward and against the
   plain head, read /healthz and /v1/stats, stop. The kernels' launch
   counts are set to 0 just before each path and read just after it;
5. samples/s of each model's forward at batch 32 and 128 and of the
   serving function at 128;
6. the R(2+1)D kernels' path: ``main`` of both experiment entry points
   (``protoasnet_tpu_torch.experiments.temporal_conv`` at the trunk's four
   stride-1 temporal-conv shapes, stem, layer1, layer2 and layer3, in fp32
   and bf16; ``...fused_c2p1d`` at layer1, layer2 and layer3 in bf16 and
   fp32, with its tiling), each holding its kernel against the float64
   (fp32) or bf16 plain version within the limits of phase 3 and timing
   kernel, plain version, cuDNN and the bound. Both launch counts are set
   to 0 just before and read just after; each kernel must have launched.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import io
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# the bounds use the H100's published peaks (HBM3 bytes/s; FLOP/s for the
# input dtype at fp32 accuracy: bf16 on the tensor cores, fp32 as 3xTF32 on
# them); fp32 references run with TF32 off
from protoasnet_tpu_torch.experiments.common import BATCH, TOL
from protoasnet_tpu_torch.experiments.common import bound_ms as _bound
from protoasnet_tpu_torch.experiments.common import max_rel_err, no_tf32

REPO = Path(__file__).resolve().parent
CONFIGS = REPO / "protoasnet_tpu" / "configs"
SOURCES = ("roi_cosine.cu", "l2_min.cu", "temporal_conv.cu",
           "fused_c2p1d.cu")
# the three served models: config, per-sample input, what a sample is
VIDEO = dict(label="video flagship", config="ours_protoasnet_video.yml",
             sample=(32, 112, 112, 3), unit="clips")
PPNET = dict(label="ProtoPNet", config="baseline_protopnet.yml",
             sample=(224, 224, 3), unit="images")
IMAGE = dict(label="image ProtoASNet", config="ours_protoasnet_image.yml",
             sample=(224, 224, 3), unit="images")
CLIP = VIDEO["sample"]
# the heads' shapes in the server's default (and largest) bucket, 128
HEAD = dict(n=128, s=8 * 14 * 14, p=40, d=256)  # video ROI-cosine head
IMAGE_HEAD = dict(n=128, s=7 * 7, p=40, d=512)  # image ROI-cosine head
L2_HEAD = dict(n=128, s=7 * 7, p=30, d=512)  # ProtoPNet's L2 + min head


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events over ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, name: str, iters: int = 50):
    """Mean device time in ms of the CUDA kernels whose name contains
    ``name`` per call of ``fn``, from ``torch.profiler``; None if the
    profiler recorded no device time for them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if name in e.key and e.device_type == torch.autograd.DeviceType.CUDA:
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
    return us / 1e3 / iters if us > 0 else None


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def head_bound_ms(n, s, p, d, dtype):
    """Least time for the ROI-cosine head on an H100: every input read once
    (occ, feat in ``dtype``; protos fp32) and every output written once
    (roi, sim fp32) at HBM rate, vs 2*N*S*P*D pooling FLOPs plus the
    cosine epilogue's ~4*N*P*D at the card's peak for ``dtype``."""
    in_bytes = torch.empty((), dtype=dtype).element_size()
    nbytes = n * s * (p + d) * in_bytes + p * d * 4 + p * 4 \
        + n * p * d * 4 + n * p * 4
    return _bound(nbytes, 2 * n * s * p * d + 4 * n * p * d, dtype)


def l2_bound_ms(n, s, p, d, in_bytes=4):
    """Least time for the L2 + min head on an H100: x (N,S,D), w (P,D) and
    p2 (P,) read once, dist (N,S,P) and min_d (N,P) fp32 written once, vs
    2*N*S*P*D product FLOPs + 2*N*S*D for |x|^2 + 5*N*S*P for the relu
    epilogue and the min, at the fp32 rate (fp32 accuracy: 3xTF32)."""
    nbytes = n * s * d * in_bytes + p * d * 4 + p * 4 + n * s * p * 4 \
        + n * p * 4
    flops = 2 * n * s * p * d + 2 * n * s * d + 5 * n * s * p
    return _bound(nbytes, flops, torch.float32)


def phase_build():
    from protoasnet_tpu_torch.ops import cuda_build

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(SOURCES)) as ex:  # one nvcc per source
        list(ex.map(cuda_build.build_library, SOURCES))
    for src in SOURCES:
        cuda_build.load_library(src)
    log(f"[1 build] {', '.join(SOURCES)} -> sm_90a in "
        f"{time.monotonic() - t0:.1f}s")
    for src, text in cuda_build.build_logs.items():
        kernel = ""
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '([^']+)'", line)
            if entry:
                kernel = _demangle(entry.group(1))
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"[1 build] {src} {kernel}: {line.strip()}")


def _demangle(name: str) -> str:
    """A kernel's mangled name as name<template arguments> (c++filt), or
    as it is where c++filt is missing."""
    try:
        out = subprocess.run(["c++filt"], input=name, capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except OSError:
        return name
    return re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", out) or name


def _head_errors(occ, feat, protos):
    """Kernel vs a float64 plain version: (roi abs, roi rel, sim abs, sim
    rel) max errors; raises past the tolerance."""
    from protoasnet_tpu_torch.ops.roi_cosine import roi_cosine_torch
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

    roi, sim = roi_cosine_cuda(occ, feat, protos)
    torch.cuda.synchronize()
    ref_roi, ref_sim = roi_cosine_torch(occ.double(), feat.double(),
                                        protos.double())
    err_roi = (roi.double() - ref_roi).abs().max().item()
    err_sim = (sim.double() - ref_sim).abs().max().item()
    rel_roi = err_roi / ref_roi.abs().max().item()
    rel_sim = err_sim / ref_sim.abs().max().item()
    # fp32 sums of up to 1568 terms in another order than float64: ~1e-6
    # relative; 1e-5 leaves a margin and still catches a wrong index
    if not (rel_roi < 1e-5 and err_sim < 1e-5):
        raise AssertionError(f"roi_cosine_cuda {occ.dtype} N={len(occ)} "
                             f"D={feat.shape[-1]}: roi rel err "
                             f"{rel_roi:.3e}, sim abs err {err_sim:.3e}")
    return err_roi, rel_roi, err_sim, rel_sim


def phase_head(dev, shape, label):
    """ROI-cosine kernel vs plain version at ``shape``, at the server's
    largest default bucket (128) and the smoke's served bucket (8);
    returns the bf16 (main-path dtype) record at 128."""
    from protoasnet_tpu_torch.ops.roi_cosine import roi_cosine_torch
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

    n, s, p, d = shape["n"], shape["s"], shape["p"], shape["d"]
    g = torch.Generator(device=dev).manual_seed(1)
    occ32 = torch.rand((n, s, p), device=dev, generator=g) * 0.05
    feat32 = torch.randn((n, s, d), device=dev, generator=g)
    protos = torch.rand((p, d), device=dev, generator=g)
    record = None
    for dtype in (torch.float32, torch.bfloat16):
        occ, feat = occ32.to(dtype), feat32.to(dtype)
        e8 = _head_errors(occ[:8], feat[:8], protos)
        err_roi, rel_roi, err_sim, rel_sim = _head_errors(occ, feat, protos)
        # plain, kernel, kernel, plain: both in turns on one card
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = roi_cosine_torch if which == "plain" else roi_cosine_cuda
            times[which].append(time_ms(lambda: fn(occ, feat, protos), 20))
        ms = min(times["kernel"])
        plain_ms = min(times["plain"])
        # the yardstick in the kernel's own input dtype
        bmm_ms = time_ms(lambda: torch.bmm(occ.transpose(1, 2), feat), 20)
        dev_ms = kernel_device_ms(lambda: roi_cosine_cuda(occ, feat, protos),
                                  "roi_cosine_kernel")
        bound_ms, bound_by = head_bound_ms(n, s, p, d, dtype)
        log(f"[2 head {label}] {str(dtype)[6:]} N={n} S={s} P={p} D={d}: "
            f"roi max abs err {err_roi:.3e} (rel {rel_roi:.3e}), sim max abs "
            f"err {err_sim:.3e} (rel {rel_sim:.3e}); wrapper call {ms:.4f} "
            f"ms, kernel alone on the device "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} "
            f"(profiler), plain {plain_ms:.4f} ms, {str(dtype)[6:]} bmm of "
            f"roi alone {bmm_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), kernel runs {times['kernel']} plain runs "
            f"{times['plain']}; at N=8 roi max abs err {e8[0]:.3e}, sim "
            f"{e8[2]:.3e}")
        if dtype == torch.bfloat16:
            record = {"max_abs_err": max(err_roi, err_sim), "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": bmm_ms,
                      "kernel_device_ms": dev_ms}
    return record


def _l2_errors(x, w):
    """l2_min_cuda vs a float64 plain version: (max abs err, scale);
    raises past the tolerance or if min_d is not dist's minimum."""
    from protoasnet_tpu_torch.ops.l2_min import l2_min_torch
    from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda

    dist, min_d = l2_min_cuda(x, w)
    torch.cuda.synchronize()
    ref_dist, ref_min = l2_min_torch(x.double(), w.double())
    err = max((dist.double() - ref_dist).abs().max().item(),
              (min_d.double() - ref_min).abs().max().item())
    # the cancellation error follows |x|^2 + |w|^2, not dist: fp32 sums of
    # D=512 products are off by ~sqrt(D)*2^-24 of that; 1e-5 of it leaves
    # a margin and still catches a wrong index (an error of order dist)
    scale = ((x.double() ** 2).sum(-1).max()
             + (w.double() ** 2).sum(-1).max()).item()
    if err > 1e-5 * scale:
        raise AssertionError(f"l2_min_cuda N={len(x)}: max abs err "
                             f"{err:.3e} > 1e-5 * {scale:.1f}")
    if not torch.equal(min_d, dist.amin(1)):
        raise AssertionError("l2_min_cuda: min_d is not dist.amin(1)")
    return err, scale


def phase_l2(dev):
    """L2 + min kernel vs its float64 plain version at ProtoPNet's head
    shape (sigmoid-range features as the "regular" add-on gives, U(0,1)
    prototypes as the init draws), at batch 128 and 8; returns its record
    at 128."""
    from protoasnet_tpu_torch.ops.l2_min import l2_min_torch
    from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda

    n, s, p, d = L2_HEAD["n"], L2_HEAD["s"], L2_HEAD["p"], L2_HEAD["d"]
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.sigmoid(torch.randn((n, s, d), device=dev, generator=g))
    w = torch.rand((p, 1, 1, d), device=dev, generator=g)
    err8, _ = _l2_errors(x[:8], w)
    err, scale = _l2_errors(x, w)
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = l2_min_torch if which == "plain" else l2_min_cuda
        times[which].append(time_ms(lambda: fn(x, w), 200))
    ms = min(times["kernel"])
    plain_ms = min(times["plain"])
    x2d, w2d = x.reshape(n * s, d), w.reshape(p, d)
    cdist_ms = time_ms(lambda: torch.cdist(
        x2d, w2d, compute_mode="use_mm_for_euclid_dist"), 200)
    dev_ms = kernel_device_ms(lambda: l2_min_cuda(x, w), "l2_min_kernel")
    bound_ms, bound_by = l2_bound_ms(n, s, p, d)
    log(f"[2 l2_min] fp32 N={n} S={s} P={p} D={d}: max abs err {err:.3e} "
        f"(scale |x|^2+|w|^2 = {scale:.1f}; at N=8 {err8:.3e}), min_d == "
        f"dist.amin(1); wrapper call {ms:.4f} ms, kernel alone on the "
        f"device {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}"
        f" (profiler), plain {plain_ms:.4f} ms, torch.cdist (unsquared "
        f"distances, no min) {cdist_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); kernel runs {times['kernel']} plain runs "
        f"{times['plain']}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cdist_ms, "kernel_device_ms": dev_ms}


def _hold(label, out, ref, tol):
    """Max abs error of ``out`` against ``ref`` and that over max |ref|;
    raises past ``tol`` of max |ref|."""
    err, rel = max_rel_err(out, ref)
    if not rel <= tol:
        raise AssertionError(f"{label}: max abs err {err:.3e} is {rel:.3e} "
                             f"of max |ref|, past {tol:g}")
    return err, rel


def _hold_both(label, kernel, plain, args32):
    """Run ``kernel`` on fp32 and bf16 copies of ``args32`` (float tensors;
    1-D ones, the affine, stay fp32) and hold it against ``plain``: fp32
    against float64, bf16 against bf16. Returns {dtype: (err, rel, err64)}
    with err64 the error against float64."""
    out = {}
    ref64 = plain(*(a.double() for a in args32))
    for dtype in (torch.float32, torch.bfloat16):
        args = [a if a.dim() == 1 else a.to(dtype) for a in args32]
        got = kernel(*args)
        torch.cuda.synchronize()
        if got.dtype != dtype or got.shape != ref64.shape:
            raise AssertionError(f"{label}: {got.dtype} {tuple(got.shape)}")
        ref = ref64 if dtype == torch.float32 else plain(*args)
        err, rel = _hold(f"{label} {dtype}", got, ref, TOL[dtype])
        out[dtype] = (err, rel, (got.double() - ref64).abs().max().item())
    return out


def _log_both(tag, label, res):
    log(f"[{tag}] {label}: " + "; ".join(
        f"{str(dt)[6:]} max abs err {e:.3e} ({r:.3e} of max |ref|, limit "
        f"{TOL[dt]:g}; vs float64 {e64:.3e})"
        for dt, (e, r, e64) in res.items()))


# three of the flagship's stride-1 blocks, each the shape of the fused
# experiment's --block, run at the experiments' batch
FLAGSHIP_BLOCKS = {"layer1_0.conv1": "layer1", "layer2_1.conv1": "layer2",
                   "layer3_1.conv1": "layer3"}


def phase_flagship_blocks(dev, cfg):
    """The fused kernel on the seeded full-width flagship's own blocks
    (BN statistics drawn from a seeded generator, so that the affine and
    relu(shift) != 0 are exercised), folded with ``fold_conv2plus1d``:
    against the plain version and the module's eval forward."""
    from protoasnet_tpu_torch.experiments.fused_c2p1d import BLOCKS
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.ops.fused_c2p1d import (fold_conv2plus1d,
                                                      fused_c2p1d_torch)
    from protoasnet_tpu_torch.ops.fused_c2p1d_cuda import fused_c2p1d_cuda

    model = build_model(dict(cfg["model"], dtype="float32"), device=dev,
                        seed=0)
    g = torch.Generator(device=dev).manual_seed(7)
    for name, block in FLAGSHIP_BLOCKS.items():
        t, h, w, c, cm, co = BLOCKS[block]
        module = model.cnn_backbone.get_submodule(name).eval()
        bn = module.bn_mid
        widths = (module.spatial.in_channels, bn.num_features,
                  module.temporal.out_channels)
        if widths != (c, cm, co):  # the experiment times this block's shape
            raise AssertionError(f"{name}: (C, Cm, Co) = {widths}, the fused "
                                 f"experiment's {block} has {(c, cm, co)}")
        with torch.no_grad():
            bn.running_mean.copy_(torch.randn(cm, device=dev, generator=g)
                                  * 0.2)
            bn.running_var.copy_(torch.rand(cm, device=dev, generator=g)
                                 * 1.5 + 0.5)
            bn.weight.copy_(torch.rand(cm, device=dev, generator=g) + 0.5)
            bn.bias.copy_(torch.randn(cm, device=dev, generator=g) * 0.2)
        x = torch.randn((BATCH, t, h, w, c), device=dev, generator=g)
        with no_tf32(), torch.inference_mode():
            folded = fold_conv2plus1d(module)
            res = _hold_both(f"fused_c2p1d_cuda {name}", fused_c2p1d_cuda,
                             fused_c2p1d_torch, (x, *folded))
            ref = module(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
            err_m, rel_m = _hold(f"fused_c2p1d_cuda {name} vs the module",
                                 fused_c2p1d_cuda(x, *folded), ref,
                                 TOL[torch.float32])
        _log_both("3 blocks", f"{name} ({c}->{cm}->{co} at {t}x{h}x{w}, "
                  f"B={BATCH})", res)
        log(f"[3 blocks] {name}: fp32 kernel vs the module's eval forward "
            f"(cuDNN, TF32 off) max abs err {err_m:.3e} ({rel_m:.3e} of "
            f"max |ref|)")
        del x, ref


def load_model_config(spec):
    from protoasnet_tpu_torch.utils.config import load_config

    return load_config(str(CONFIGS / spec["config"]))


def _max_diff(a, b) -> float:
    return (a.float().cpu() - b.float().cpu()).abs().max().item()


def phase_model(dev, cfg):
    """fp32 flagship: kernel head vs plain head on the card, and the card
    vs the CPU (the plain path the tests hold against the JAX package)."""
    from protoasnet_tpu_torch.models.builder import build_model

    mcfg = dict(cfg["model"], dtype="float32")
    model = build_model(mcfg, device=dev, seed=0)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, *CLIP)).astype(np.float32))
    with no_tf32(), torch.inference_mode():
        lk, sk, ok = model(x.to(dev))
        model.head_impl = "torch"
        lp, sp, op = model(x.to(dev))
        model.head_impl = None
        cpu_model = build_model(mcfg, device="cpu", seed=0)
        lc, sc, _ = cpu_model(x)
    occ_shape = (2, CLIP[0] // 4, CLIP[1] // 8, CLIP[2] // 8, 40)
    if lk.shape != (2, 4) or ok.shape != occ_shape:
        raise AssertionError(f"shapes {tuple(lk.shape)} {tuple(ok.shape)}")
    for t in (lk, sk, ok):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite model output")
    d_head = max(_max_diff(lk, lp), _max_diff(sk, sp))
    d_cpu = max(_max_diff(lk, lc), _max_diff(sk, sc))
    scale = lc.abs().max().item()
    log(f"[3 model] flagship fp32 (N=2, 32x112x112): kernel head vs plain "
        f"head max abs diff {d_head:.3e}; card vs CPU max abs diff "
        f"{d_cpu:.3e} (|logits| up to {scale:.3f})")
    # same trunk outputs, heads differ only in fp32 summation order
    if d_head > 1e-4:
        raise AssertionError(f"kernel head vs plain head: {d_head:.3e}")
    # cuDNN vs CPU convolutions in fp32 (TF32 off) through 17 convs
    if d_cpu > 1e-3 * max(1.0, scale):
        raise AssertionError(f"card vs CPU logits: {d_cpu:.3e}")


def phase_model_2d(dev, spec):
    """fp32 image model at 224x224, N=2: kernel head vs plain head on the
    card, and the card vs the CPU; ProtoPNet also through
    ``push_forward`` (its per-patch distance map)."""
    from protoasnet_tpu_torch.models.builder import build_model

    mcfg = dict(load_model_config(spec)["model"], dtype="float32")
    ppnet = mcfg["name"] == "ProtoPNet"
    model = build_model(mcfg, device=dev, seed=0)
    cpu_model = build_model(mcfg, device="cpu", seed=0)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, *spec["sample"])).astype(np.float32))

    def run(m, xx):
        outs = list(m(xx))
        if ppnet:
            outs += list(m.push_forward(xx))
        return outs

    with no_tf32(), torch.inference_mode():
        kern = run(model, x.to(dev))
        model.head_impl = "torch"
        plain = run(model, x.to(dev))
        model.head_impl = None
        cpu = run(cpu_model, x)
    for t in kern:
        if not torch.isfinite(t).all():
            raise AssertionError(f"{spec['label']}: non-finite output")
    k = int(mcfg["num_classes"])
    if tuple(kern[0].shape) != (2, k):
        raise AssertionError(f"{spec['label']}: logits {kern[0].shape}")
    names = (["logits", "min_distances", "conv_features", "distances"]
             if ppnet else ["logits", "sim01", "occurrence"])
    d_head = {n: _max_diff(a, b) for n, a, b in zip(names, kern, plain)}
    d_cpu = {n: _max_diff(a, b) for n, a, b in zip(names, kern, cpu)}
    scale = cpu[0].abs().max().item()
    log(f"[3 model] {spec['label']} fp32 (N=2, {spec['sample'][0]}x"
        f"{spec['sample'][1]}): kernel head vs "
        f"plain head max abs diff {d_head}; card vs CPU {d_cpu} (|logits| "
        f"up to {scale:.3f})")
    if ppnet:
        conv, protos = kern[2].double(), model.prototype_vectors.double()
        # as in phase 2: the cancellation error follows |x|^2 + |w|^2
        l2_scale = ((conv ** 2).sum(-1).max()
                    + (protos ** 2).sum(-1).max()).item()
        dist_scale = max(1.0, cpu[3].abs().max().item())
        if max(d_head["min_distances"], d_head["distances"]) \
                > 1e-5 * l2_scale:
            raise AssertionError(f"kernel vs plain distances: {d_head}")
        if max(d_cpu["min_distances"], d_cpu["distances"]) \
                > 1e-3 * dist_scale:
            raise AssertionError(f"card vs CPU distances: {d_cpu}")
    elif d_head["sim01"] > 1e-4:
        raise AssertionError(f"kernel head vs plain head: {d_head}")
    # the heads' fp32 rounding moves the logits far less than this
    if d_head["logits"] > 1e-4:
        raise AssertionError(f"kernel head vs plain head logits: {d_head}")
    # cuDNN vs CPU convolutions in fp32 (TF32 off) through 20 convs
    if d_cpu["logits"] > 1e-3 * max(1.0, scale):
        raise AssertionError(f"card vs CPU logits: {d_cpu}")


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/v1/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()))


def _counters():
    from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

    return {"roi_cosine_cuda": roi_cosine_cuda, "l2_min_cuda": l2_min_cuda}


def phase_serve(dev, spec, cfg):
    """One main path: bundle -> serve_forever -> POST -> logits. Returns
    the kernels' launch counts of this path (set to 0 at its start, read
    once the server has stopped, before the reference forwards)."""
    from protoasnet_tpu_torch import server
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.serve import (load_serving_bundle,
                                            make_serving_fn,
                                            save_serving_bundle)

    sample, label = spec["sample"], spec["label"]
    model = build_model(cfg["model"], device="cpu", seed=0)
    bf16 = model.dtype == torch.bfloat16
    counters = _counters()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "bundle.zip")
        save_serving_bundle(path, model, cfg["model"], sample)
        ready, stop = threading.Event(), threading.Event()
        errors = []

        def run():
            try:
                server.serve_forever(path, host="127.0.0.1", port=0,
                                     max_batch=8, max_delay_ms=2.0,
                                     warmup=True, ready_event=ready,
                                     stop_event=stop, device=dev)
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)
                ready.set()

        served = []
        for fn in counters.values():
            fn.launches = 0
        t = threading.Thread(target=run, name="smoke-server", daemon=True)
        t.start()
        try:
            if not ready.wait(600) or errors:
                raise RuntimeError(f"server did not start: {errors}")
            url = f"http://127.0.0.1:{ready.port}"
            rng = np.random.default_rng(3)
            t0 = time.monotonic()
            for n in (1, 3, 8, 2):
                x = rng.normal(size=(n, *sample)).astype(np.float32)
                served.append((x, _post(url, x)))
            serve_s = time.monotonic() - t0
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                health = r.read().decode()
            with urllib.request.urlopen(url + "/v1/stats", timeout=30) as r:
                stats = json.loads(r.read())
        finally:
            stop.set()
            t.join(120)
        launches = {name: fn.launches for name, fn in counters.items()}
        if t.is_alive() or errors:
            raise RuntimeError(f"server did not stop cleanly: {errors}")
        direct = load_serving_bundle(path, device=dev)
        worst = 0.0
        k = int(cfg["model"]["num_classes"])
        for x, out in served:
            n = len(x)
            if out.shape != (n, k) or not np.isfinite(out).all():
                raise AssertionError(f"{label}: served logits {out.shape}")
            # the batcher pads to the next bucket with zero samples; the
            # direct forward gets the same padded batch
            bucket = next(b for b in (1, 2, 4, 8) if b >= n)
            xp = np.zeros((bucket, *sample), np.float32)
            xp[:n] = x
            worst = max(worst, float(np.abs(out - direct(xp)[:n]).max()))
        # the 8-sample request against the same weights with the plain head
        x8, out8 = served[2]
        model.to(dev).head_impl = "torch"
        d_plain = float(np.abs(out8 - make_serving_fn(model)(x8)).max())
    log(f"[4 serve {label}] 4 POSTs (1,3,8,2 {spec['unit']}, "
        f"{'bf16' if bf16 else 'fp32'}) in {serve_s:.2f}s; served vs direct "
        f"forward max abs diff {worst:.3e}, 8 {spec['unit']} vs plain head "
        f"{d_plain:.3e}; healthz {health!r}; stats "
        f"requests={stats['requests']} samples={stats['samples']} "
        f"batches={stats['batches']} p50={stats['latency_ms_p50']}ms; "
        f"launches {launches}")
    # the same padded batch through the same weights on the same card
    if worst > 1e-3:
        raise AssertionError(f"{label}: served logits differ from direct: "
                             f"{worst}")
    # bf16: same trunk; the heads' fp32 outputs differ by ~1e-6, which can
    # flip one bf16 rounding (2^-9) before the bf16 readout. fp32: only the
    # heads' summation order differs
    if d_plain > (2e-2 if bf16 else 1e-4):
        raise AssertionError(f"{label}: served logits vs plain head: "
                             f"{d_plain}")
    if health != "ok" or stats["samples"] != 14 or stats["errors"]:
        raise AssertionError(f"{label}: server stats {stats}")
    return launches


def phase_throughput(dev, spec, cfg):
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.serve import make_serving_fn

    model = build_model(cfg["model"], device=dev, seed=0)
    dt = "bf16" if model.dtype == torch.bfloat16 else "fp32"
    label, unit, sample = spec["label"], spec["unit"], spec["sample"]
    out = {}
    for b in (32, 128):
        x = torch.randn((b, *sample), device=dev)
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: model(x), iters=5, warmup=2)
        out[b] = b / ms * 1e3
        log(f"[5 throughput] {label} {dt} forward batch {b}: {ms:.2f} "
            f"ms/batch, {out[b]:.1f} {unit}/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # the serving function as the batcher calls it: numpy samples in (host
    # to device copy included), numpy logits out, host clock
    fn = make_serving_fn(model)
    x = np.random.default_rng(4).normal(
        size=(128, *sample)).astype(np.float32)
    fn(x)
    t0 = time.perf_counter()
    for _ in range(3):
        fn(x)
    ms = (time.perf_counter() - t0) / 3 * 1e3
    log(f"[5 throughput] {label} {dt} serving fn batch 128 (numpy in/out): "
        f"{ms:.2f} ms/batch, {128 / ms * 1e3:.1f} {unit}/s")
    return out


# the experiment runs of phase 6: (label, module, argv); each module's
# script default (RECORDS) gives the kernel's record
EXPERIMENTS = (
    ("temporal fp32 layer1", "temporal_conv", []),
    ("temporal bf16 layer1", "temporal_conv", ["--bf16"]),
    *((f"temporal {dt} {shape}", "temporal_conv",
       ["--shape", shape] + (["--bf16"] if dt == "bf16" else []))
      for shape in ("stem", "layer2", "layer3") for dt in ("fp32", "bf16")),
    ("fused bf16 layer1", "fused_c2p1d", []),
    ("fused fp32 layer1", "fused_c2p1d", ["--fp32"]),
    *((f"fused {dt} {block}", "fused_c2p1d",
       ["--block", block] + (["--fp32"] if dt == "fp32" else []))
      for block in ("layer2", "layer3") for dt in ("bf16", "fp32")),
)
RECORDS = {"temporal_conv_cuda": "temporal fp32 layer1",
           "fused_c2p1d_cuda": "fused bf16 layer1"}


def _r2p1d_counters():
    from protoasnet_tpu_torch.ops.fused_c2p1d_cuda import fused_c2p1d_cuda
    from protoasnet_tpu_torch.ops.temporal_conv_cuda import \
        temporal_conv_cuda

    return {"temporal_conv_cuda": temporal_conv_cuda,
            "fused_c2p1d_cuda": fused_c2p1d_cuda}


def phase_experiments():
    """The R(2+1)D kernels' path: both experiment entry points' ``main``,
    as ``python -m protoasnet_tpu_torch.experiments.<name>`` runs it.
    Returns ({label: result dict}, launch counts of this path)."""
    import importlib

    counters = _r2p1d_counters()
    runs = {}
    for fn in counters.values():
        fn.launches = 0
    for label, name, argv in EXPERIMENTS:
        log(f"[6 experiments] {label}: python -m "
            f"protoasnet_tpu_torch.experiments.{name} {' '.join(argv)}")
        runs[label] = importlib.import_module(
            f"protoasnet_tpu_torch.experiments.{name}").main(argv)
    launches = {name: fn.launches for name, fn in counters.items()}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the experiments' path never "
                             f"launched: {launches}")
    for label, r in runs.items():
        if "rows_per_block" in r:
            tile = (f", {r['rows_per_block']} positions per block, taps "
                    f"{'resident' if r['taps_resident'] else 'in chunks'}")
        else:
            tile = (f", {r['tile'][0]}x{r['tile'][1]} positions per block, "
                    f"Cm in {r['splits']} slice(s) of {r['mid_per_block']}, "
                    f"{r['blocks']} blocks")
        log(f"[6 experiments] {label}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['gflop']:.1f} "
            f"GFLOP; max abs err {r['max_abs_err']:.3e} (rel "
            f"{r['rel_err']:.3e}){tile}")
    log(f"[6 experiments] launches on the path: {launches}")
    return runs, launches


def _record(r):
    return {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from protoasnet_tpu_torch.ops import fused_c2p1d_cuda as fused_mod
    from protoasnet_tpu_torch.ops import l2_min_cuda as l2_mod
    from protoasnet_tpu_torch.ops import roi_cosine_cuda as roi_mod
    from protoasnet_tpu_torch.ops import temporal_conv_cuda as temporal_mod

    dev = torch.device("cuda")
    card = card_line()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; {card}")
    cfgs = {spec["label"]: load_model_config(spec)
            for spec in (VIDEO, PPNET, IMAGE)}
    phase_build()
    head = phase_head(dev, HEAD, "video")
    phase_head(dev, IMAGE_HEAD, "image")
    l2 = phase_l2(dev)
    phase_model(dev, cfgs[VIDEO["label"]])
    phase_flagship_blocks(dev, cfgs[VIDEO["label"]])
    phase_model_2d(dev, PPNET)
    phase_model_2d(dev, IMAGE)
    # each main path with the counts set to 0 just before it and read just
    # after it; each must launch the kernel(s) of its head
    launches = {name: 0 for name in _counters()}
    for spec, kernels in ((VIDEO, ["roi_cosine_cuda"]),
                          (PPNET, ["l2_min_cuda"]),
                          (IMAGE, ["roi_cosine_cuda"])):
        got = phase_serve(dev, spec, cfgs[spec["label"]])
        if not all(got[k] for k in kernels):
            raise AssertionError(f"{spec['label']}: a kernel of its path "
                                 f"never launched: {got}")
        for name, count in got.items():
            launches[name] += count
    log(f"[4 serve] kernels: {json.dumps(sorted(launches))}; launches on "
        f"the main paths: {launches}")
    for spec in (VIDEO, PPNET, IMAGE):
        phase_throughput(dev, spec, cfgs[spec["label"]])
    runs, r2p1d_launches = phase_experiments()
    launches.update(r2p1d_launches)
    print(card)
    print(json.dumps({"kernels": [
        dict(name="roi_cosine_cuda", route="cuda", source=roi_mod.SOURCE,
             replaces=roi_mod.REPLACES,
             launches=launches["roi_cosine_cuda"], **head),
        dict(name="l2_min_cuda", route="cuda", source=l2_mod.SOURCE,
             replaces=l2_mod.REPLACES, launches=launches["l2_min_cuda"],
             **l2),
        dict(name="temporal_conv_cuda", route="cuda",
             source=temporal_mod.SOURCE, replaces=temporal_mod.REPLACES,
             launches=launches["temporal_conv_cuda"],
             **_record(runs[RECORDS["temporal_conv_cuda"]])),
        dict(name="fused_c2p1d_cuda", route="cuda", source=fused_mod.SOURCE,
             replaces=fused_mod.REPLACES,
             launches=launches["fused_c2p1d_cuda"],
             **_record(runs[RECORDS["fused_c2p1d_cuda"]])),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
