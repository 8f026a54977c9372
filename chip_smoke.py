"""Chip smoke of the PyTorch/H100 port: the serving paths of the video
flagship (Video ProtoASNet), the ProtoPNet baseline and the image
ProtoASNet on one NVIDIA GPU, through the hand-written CUDA kernels, the
experiment entry points of the R(2+1)D block kernels, the training
paths of the video flagship, the ProtoPNet baseline and the image
ProtoASNet, the trained runs explained, exported, served live, reloaded
and tuned, the training loop's instrumentation, ``model.remat``, the
reference's ``.pth`` both ways, the flagship served as w8a8 int8, and the
last trunks (r3d_18, VGG, DenseNet), data parallelism through
``torch.distributed.run``, prototype tensor parallelism, and the repo's
measuring tools (the headline bench, serving latency, daemon load, int8
accuracy), the Video Swin-B trunk's window attention kernel and its
served path, the served R(2+1)D trunk's conv epilogue kernel, and the
MViTv2-B trunk's pooling attention kernel and its served path.

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
   to 0 just before and read just after; each kernel must have launched;
7. the training path: ``protoasnet_tpu_torch.main.main`` on 12 synthetic
   videos with the full-width bf16 flagship (train batch 5, two
   micro-steps, val, a push without and one with replacement, val_push,
   checkpoints), checking the run's files, finite losses and moved
   weights, with ``roi_cosine_cuda``'s launch and backward counts set to 0
   just before and read just after (both must be > 0); the head's gradient
   through ``RoiCosineFunction`` at the train shape (N=5) against the
   plain head's autograd (fp32 inputs vs float64, 1e-5 of max |ref|; bf16
   vs bf16, 1e-2), timed against its bound; one fp32 train step on the
   card against the same step on the CPU; clips/s of the bf16 micro-step
   at batch 5 and its top device ops;
8. the 2-D heads' gradients at their train heads (batch 20): the L2
   head's through ``L2MinFunction`` (N=20, S=49, P=30, D=512, fp32)
   against ``l2_min_backward`` in float64 and the plain head's float64
   autograd (1e-5 of max |ref|), timed as trained (only min_d used)
   against its bound, the plain autograd and the two products as
   ``torch.matmul``; the ROI head's at the image head (N=20, S=49, P=40,
   D=512) as in phase 7;
9. the ProtoPNet training path: ``main`` on ``baseline_protopnet.yml``
   at full width (ResNet-18, 224x224, 30x512 prototypes, fp32, train
   batch 20) on 12 synthetic videos, cut with the config's own keys (two
   epochs: warm, then joint with a push, val_push and the two last-layer
   epochs; one micro-step an Adam step), checking ``bb.npy``,
   ``bb-receptive_field.npy``, ``prototypes_info.pickle``, one picture per
   prototype found, finite losses, the groups each stage moved (the
   stages' Adam moments) and ``l2_min_cuda``'s launch and backward counts,
   set to 0 just before and read just after (both > 0);
10. the image ProtoASNet's training path: ``main`` on
   ``ours_protoasnet_image.yml`` (bf16, train batch 20, one epoch with its
   push), the same checks with ``roi_cosine_cuda``'s counts;
11. ProtoPNet's fp32 train step on the card against the CPU's (loss terms
   within 1e-5 relative);
12. images/s of the ProtoPNet fp32 and the image ProtoASNet bf16 train
   micro-steps at batch 20 on a device-resident batch, each with its
   device-busy share and top device ops;
13. phase 7's run (kept, full width, bf16) explained: ``main`` of
   ``python -m protoasnet_tpu_torch.explain --explain_locally=true
   --explain_globally=true --eval_data_type=test`` in process, with
   ``roi_cosine_cuda``'s launches set to 0 just before and read just after
   (> 0); the products' similarities and logits against the same agent
   with the plain head on the same clips (2e-2, the bf16 limit), the
   sanity report, three panels per test clip; then ``serve export
   --run_dir`` of the run, the bundle served over HTTP (launches counted
   again, > 0) and its logits against the agent's eval step and against
   the plain head on the same clips (2e-2); the seconds of the sweep (2
   clips: fixed costs), the render and the export, and the bundle's MB;
   then the sweep at size: ``collect_model_products`` over a test split
   of its own (288 synthetic videos, four eval batches of 128) with phase
   7's weights, one launch per batch counted, its seconds and clips/s,
   the loader alone and the sweep's passes alone over the same split;
14. phase 9's ProtoPNet run exported and served the same way, with
   ``l2_min_cuda``'s launches counted (> 0), its logits against the
   rebuilt agent's eval step (fp32, 1e-3) and against the plain head on
   the same batch (fp32, 1e-4);
15. the trained runs served live (``server.serve_live``, the daemon's
   default ``max_batch`` of 128, every bucket of its ladder warmed at
   start and on each reload) and reached through the port's
   ``ServingClient``: (a) phase 7's run, ``LIVE_CLIPS`` clips in one call
   of a client whose request ceiling is one clip over ``max_batch`` (the
   client and the daemon both chunk), the logits within 2e-2 of the
   rebuilt agent's eval step and of the plain head on the same padded
   batches and bit-equal to phase 13's bundle on the same batches,
   ``roi_cosine_cuda`` launches counted (> 0), /v1/spec's buckets the
   ladder; (b) ``RELOADS`` hot reloads, to a second flagship run (phase
   7's checkpoint with the readout moved by seeded noise) and back,
   ending on it, while four threads post requests of ``TRAFFIC_SIZES``
   clips, which the batcher groups (bucket 128 among them): no request
   fails or waits ``SLOWEST_S``, every row of a response is within 2e-2
   of one weight set's logits and of only that one,
   and all rows of a response of the same set; each reload's generation;
   the new logits within 2e-2 of the new run's eval step; the reloads'
   load and warm-up seconds, peak allocated and reserved device memory
   across them, request p50 before and during; (c) a reload to phase
   10's image run ends in ``error`` (its input contract differs) and the
   flagship keeps serving; (d) phase 9's ProtoPNet run served live,
   ``l2_min_cuda`` launches counted (> 0), within 1e-3 of its eval step
   and 1e-4 of the plain head; (e) ``python -m protoasnet_tpu_torch.serve
   tune`` on phase 13's bundle at batches 32, 64, 128 and 256
   (``--points 4 20``), its rate at 128 beside phase 5's forward rate,
   then one forward of the bundle at each of those batches with the
   kernel and with the plain head (bf16, 2e-2; not counted).
16. the training loop's instrumentation on phase 7's run (its config and
   ``last.ckpt``): a bf16 training epoch with ``train.on_device_metrics``
   false and true, the epoch metrics equal within 1e-5, each path's
   ``cudaStreamSynchronize`` calls and device -> host copies per
   micro-step (``utils/profiling.py::device_window``) and its ms a
   micro-step (the StepTimer of a second epoch); a third agent with
   ``profile_dir`` writes a trace at ``profile_epoch`` holding
   ``roi_cosine_kernel`` events, read back from the file; the port's FLOP
   counts of the forward and the train micro-step equal on the card and
   the CPU, and the MFU of the served flagship at 128 (phase 5's rate)
   and of the train micro-step (phase 7's rate) against the card's bf16
   peak;
17. ``model.remat``: the bf16 flagship micro-step at batch 5 with remat
   false and true, ms and peak allocated memory; in fp32 (TF32 off,
   batch 2) gradients, weights and BatchNorm statistics with remat equal
   those without within 1e-5 of each tensor's max;
18. phase 7's and phase 9's runs through the reference's ``.pth`` and
   back (``protoasnet_tpu_torch.models.migrate``, ``--to_reference`` and
   then to a ``.pkl``), loaded by the port's agent through
   ``model.checkpoint_path`` and served on the card at 128: logits
   bit-equal to the run's own, each kernel's launches counted;
19. w8a8 int8 serving: phase 7's run through ``python -m
   protoasnet_tpu_torch.serve export --int8 --calib_batches 4``, the
   bundle served over HTTP at ``max_batch`` 128 on 128 clips: (a) every
   int8 conv geometry of the flagship at its batch-128 shape, the card's
   int32 sums (``torch._int_mm`` GEMMs) bit-equal to the plain version's
   on seeded codes; (b) the served logits within 2e-2 * max(1, |logits|)
   of the same bundle on the CPU; (c) against phase 13's bf16 bundle on
   the same clips, max relative error < 0.08, cosine > 0.995, argmax
   agreement >= 0.75; (d) ``roi_cosine_cuda``'s launches and the int8
   GEMMs counted (> 0); (e) clips/s and peak allocated memory of the int8
   and the bf16 forwards at 128 beside phase 5's rate, and each int8
   conv's ms beside bf16 cuDNN's at the same shape; (f) ``serve_live
   --int8`` of the run answers one request bit-equal to the int8 bundle;
20. the last trunks at full width with seeded weights, fp32: ``r3d_18``
   in the flagship's Video_XProtoNet (32x112x112), ``vgg16_bn`` and
   ``densenet121`` in ProtoPNet's PPNet (224x224): the card's forward at
   batch 8 (TF32 off) within 1e-3 * max(1, |logits|) of the CPU's, and
   the w8a8-quantised forward within 2e-2 * max(1, |logits|) of the
   CPU's, each head kernel's launches counted (> 0);
21. distribution (``parallel/``): (a) phase 7's command line under
   ``python -m torch.distributed.run --standalone --nproc_per_node=1``
   (NCCL, world 1), its per-step train losses within 1e-4 relative of the
   same command without the launcher and one ``last.ckpt``; (b) two gloo
   ranks on cuda:0, one fp32 step at the global batch 6: its loss within
   2e-5 of the single-process step, the replicas bit-identical after it;
   (c) world-1 NCCL: the bf16 micro-step at batch 5 beside phase 7's,
   the fp32 step data-parallel against FSDP2 (losses within 2e-5, peak
   memory of each); (d) ``server.serve_live`` over every local card
   bit-equal to phase 15's logits; (e) the ROI kernel launched in each of
   (a)-(c). The workers of (a)-(c) are this script under the launcher:
   ``chip_smoke.py dp_main|dp_gloo|dp_nccl``;
22. prototype tensor parallelism (``parallel/mesh.py``: ``make_mesh_2d``,
   ``prototype_param_shardings``): (a) ``roi_cosine_cuda`` at the sharded
   heads (N=3, 5 and 128, S=1568, P=20 and 10, D=256; bf16 and fp32) within
   phase 2's limits of float64, and ``l2_min_cuda`` at N=20, S=49, P=15,
   D=512, each timed beside its plain version and bound; (b) four gloo
   ranks on cuda:0 as a 2 x 2 (data, model) mesh, the full-width fp32
   flagship step at the global batch 6 (TF32 off): its loss within 2e-5
   relative of the single-process step, the data replicas of
   each shard bit-identical, the ROI kernel launched on every rank at
   P=20, and the global batch's gradient gathered whole within 1e-4 of
   each tensor's max of a data-parallel run's on two gloo ranks (2 x 1:
   the same data split and BatchNorm moments, all P on each rank); against
   one process the gradients are reported (fp32 BatchNorm's backward
   drifts, ROADMAP §3), as are the parameters after Adam's first update
   (it moves a gradient that sums to about 0 by +-lr); (c) a 1 x 2 mesh,
   the bf16 micro-step at batch 5 beside phase 7's (a correctness run:
   the collectives go through the host); (d) the push on the 2 x 2 mesh:
   its winners and similarities those of one process; (e) ProtoPNet on a
   1 x 2 mesh at batch 20: ``l2_min_cuda`` at P=15, the step's loss
   within 2e-5 of one process. The workers are ``chip_smoke.py
   tp_gloo|tp_ref|tp_pair`` under the launcher;
23. the repo's measuring tools, each in process with ``roi_cosine_cuda``'s
   count set to 0 just before it and read just after: (a) ``python -m
   protoasnet_tpu_torch.bench --quick``, every key the root bench.py
   prints for those flags present, finite and positive, the kernel
   launched in each section (served, int8, train, image), ``value``
   within 0.8-1.25x of phase 5's forward rate at 128; (b)
   ``experiments.serving_latency --batches 1 8 128``, bf16 and int8, the
   rates at 128 within the same band of (a)'s; (c) ``experiments.
   daemon_load --null`` for 3 s, then the flagship through the daemon for
   10 s under 4 clients (``--req_batch 4 --max_batch 16``): no request
   fails, the kernel launched; (d) ``experiments.int8_accuracy`` on phase
   7's run (finite metrics, int8 logits within 0.08 relative of float),
   then on phase 7's weights and config with a val split of 36 synthetic
   videos, 12 of each class: AUROC defined for both models. Before them,
   ``roi_cosine_cuda`` at the batches the tools launch it at (N=1-64 at
   the flagship's S, P, D, fp32 and bf16) within phase 2's limits, and
   its backward at the bench's train batch of 8;
24. the Video Swin-B trunk: (a) ``window_attn_cuda`` against the plain
   route at the three stage shapes of 32x112x112 clips at batch 128,
   bf16 and fp32, shifted and not, every clip against float64 (computed
   16 clips at a time; fp32 within 1e-5 of max |ref|, bf16 on the same
   bf16 inputs within 1e-2), and each timed (``experiments.window_attn``:
   the wrapper call, the kernel on the device, its bound, the plain route
   and the library's fused attention with the bias broadcast); (b) a
   bf16 ``swin3d_b`` bundle (uint8 gray) served by
   ``server.serve_forever`` at ``max_batch`` 128 with ``window_attn_cuda.
   launches`` set to 0 just before and read just after: 22 a batch, the
   warm-up's buckets and the served batches; the served logits against a
   direct forward of the same padded batch and against the model with
   the plain route in the kernel's place;
25. the served R(2+1)D trunk's conv epilogue: (a) ``conv_epilogue_cuda``
   against its plain route run in fp32 at each distinct (C, T, H·W) of
   the flagship's served trunk at batch 128, with and without a residual,
   bf16 (within one bf16 ulp) and fp32 (exactly), each timed (CUDA
   events: the wrapper call back to back, the plain route) beside its
   byte bound; (b) the bf16 flagship served at batch 128 by
   ``serve.make_serving_fn`` (the main path's ``_device_forward`` and its
   folded copy) with ``conv_epilogue_cuda.launches`` set to 0 just before
   and read just after (26 a forward), its logits against a folded copy
   built by hand with the plain route in the kernel's place and against
   the model's own forward, and that copy's forward timed through each
   route.
26. the MViTv2-B trunk: (a) ``pool_attn_cuda`` at the five call shapes
   of its served trunk on 32x112x112 clips at batch 128 (queries x keys,
   heads: 12545x257, 1; 3137x785, 2; 3137x257, 2; 785x785, 4; 785x257,
   4), fp32 (TF32 off) and bf16 from fp32 inputs under autocast, every
   clip against the float64 plain route ``pool_attention_torch`` on the
   same inputs (16 clips at a time; fp32 within 1e-5 of max |ref|, bf16
   within 1e-2 and no further than twice the plain route under
   autocast), each timed in bf16 (CUDA events: the wrapper call; the
   kernel on the device; the plain route) beside its bound
   (``perfbench/kernels/pool_attn.py``); (b) the configuration's model
   (random init) served at batch 128 by ``serve.make_serving_fn`` (uint8
   gray, bf16) with ``pool_attn_cuda.launches`` set to 0 just before and
   read just after (21, one a block), its logits against the same model
   with the plain route in the kernel's place (within 0.1 of max(1,
   |logits|), the cell's ``logit_gap`` limit).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
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
from protoasnet_tpu_torch.experiments.common import (BATCH,
                                                     HBM_BYTES_PER_S, TOL)
from protoasnet_tpu_torch.experiments.common import bound_ms as _bound
from protoasnet_tpu_torch.experiments.common import (card_line, max_rel_err,
                                                     no_tf32)

REPO = Path(__file__).resolve().parent
CONFIGS = REPO / "protoasnet_tpu" / "configs"
SOURCES = ("roi_cosine.cu", "l2_min.cu", "temporal_conv.cu",
           "fused_c2p1d.cu", "window_attn.cu", "conv_epilogue.cu",
           "pool_attn.cu")
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


def kernel_device_ms(fn, name: str, iters: int = 50) -> float:
    """Mean device time in ms of one recorded CUDA kernel whose name
    contains ``name`` over ``iters`` calls of ``fn`` (one launch a call),
    from ``utils/profiling.py::device_window``; raises if the window holds
    none of them (ROADMAP.md §3, F4)."""
    from protoasnet_tpu_torch.utils.profiling import device_window

    return device_window(fn, iters=iters).device_ms(name)


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
            f"ms, kernel alone on the device {dev_ms:.4f} ms (profiler), "
            f"plain {plain_ms:.4f} ms, {str(dtype)[6:]} bmm of roi alone "
            f"{bmm_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), kernel "
            f"runs {times['kernel']} plain runs {times['plain']}; at N=8 roi max abs err {e8[0]:.3e}, sim "
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
        f"device {dev_ms:.4f} ms (profiler), plain {plain_ms:.4f} ms, "
        f"torch.cdist (unsquared distances, no min) {cdist_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}); kernel runs {times['kernel']} plain runs "
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
    """Max |a - b| of two tensors or numpy arrays, in fp32."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
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


@contextlib.contextmanager
def _serving(serve, *args, **kwargs):
    """``serve`` (``server.serve_forever`` or ``server.serve_live``) on
    port 0 in a thread; yields its URL and stops it on exit, raising if it
    failed or did not stop."""
    ready, stop = threading.Event(), threading.Event()
    errors = []

    def run():
        try:
            serve(*args, host="127.0.0.1", port=0, ready_event=ready,
                  stop_event=stop, **kwargs)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)
            ready.set()

    t = threading.Thread(target=run, name="smoke-server", daemon=True)
    t.start()
    try:
        if not ready.wait(600) or errors:
            raise RuntimeError(f"server did not start: {errors}")
        yield f"http://127.0.0.1:{ready.port}"
    finally:
        stop.set()
        t.join(120)
    if t.is_alive() or errors:
        raise RuntimeError(f"server did not stop cleanly: {errors}")


def _serve_posts(path, dev, xs):
    """``server.serve_forever`` on ``path`` (port 0, a thread, warmed, up
    to 8 samples a batch), one POST per array of ``xs``, then /healthz and
    /v1/stats; returns (the served logits, the seconds of the POSTs, the
    health text, the stats). The server has stopped when it returns."""
    from protoasnet_tpu_torch import server

    with _serving(server.serve_forever, path, max_batch=8, max_delay_ms=2.0,
                  warmup=True, device=dev) as url:
        t0 = time.monotonic()
        served = [_post(url, x) for x in xs]
        seconds = time.monotonic() - t0
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = r.read().decode()
        with urllib.request.urlopen(url + "/v1/stats", timeout=30) as r:
            stats = json.loads(r.read())
    return served, seconds, health, stats


def phase_serve(dev, spec, cfg):
    """One main path: bundle -> serve_forever -> POST -> logits. Returns
    the kernels' launch counts of this path (set to 0 at its start, read
    once the server has stopped, before the reference forwards)."""
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
        rng = np.random.default_rng(3)
        xs = [rng.normal(size=(n, *sample)).astype(np.float32)
              for n in (1, 3, 8, 2)]
        for fn in counters.values():
            fn.launches = 0
        outs, serve_s, health, stats = _serve_posts(path, dev, xs)
        launches = {name: fn.launches for name, fn in counters.items()}
        served = list(zip(xs, outs))
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


# phase 7: the training path of the flagship, through the port's own main
TRAIN_ARGS = ("--train.batch_size=5", "--train.accumulation_steps=2",
              "--train.num_train_epochs=1", "--train.num_warm_epochs=0",
              "--train.push_start=0", "--train.push_rate=1",
              "--data.num_workers=1")
TRAIN_HEAD = dict(n=5, s=8 * 14 * 14, p=40, d=256)  # the head at batch 5


def _finite_losses(path: Path):
    """Every loss value logged in metrics.jsonl, which must be finite."""
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    losses = [v for r in rows for k, v in r.items() if "loss" in k]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"{path}: losses {losses[:8]} ...")
    modes = {k.split("/")[1] for r in rows for k in r
             if k.startswith("epoch/")}
    return len(losses), modes


def phase_train(dev, cfg, work: Path):
    """The main training path: ``protoasnet_tpu_torch.main.main`` on 12
    synthetic videos with the full-width bf16 flagship: one train epoch
    (batch 5, two micro-steps, one Adam step), val, a non-replacing and a
    replacing push, val_push and the checkpoints. The ROI kernel's launch
    and backward counts are set to 0 just before and read just after. The
    run stays under ``work`` for phase 13."""
    from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from protoasnet_tpu_torch.main import main as train_main
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

    csv = make_synthetic_dataset(str(work / "video_data"), num_videos=12,
                                 seed=3)
    args = [f"--config_path={CONFIGS / VIDEO['config']}",
            f"--save_dir={work / 'video_runs'}",
            f"--data.data_info_file={csv}", *TRAIN_ARGS]
    roi_cosine_cuda.launches = 0
    roi_cosine_cuda.backward_calls = 0
    t0 = time.monotonic()
    agent = train_main(args)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = roi_cosine_cuda.launches
    backward_calls = roi_cosine_cuda.backward_calls
    run = Path(agent.save_dir)
    for name in ("last.ckpt", "metrics.jsonl",
                 "img/epoch-0_pushed/prototypes_info.pickle"):
        if not (run / name).exists():
            raise AssertionError(f"training run lacks {name}")
    n_losses, modes = _finite_losses(run / "metrics.jsonl")
    if not {"train", "val", "val_push"} <= modes:
        raise AssertionError(f"epoch rows of {sorted(modes)} only")
    init = build_model(cfg["model"], device="cpu",
                       seed=int(cfg["train"]["seed"])).state_dict()
    moved = [k for k, v in agent.model.state_dict().items()
             if k.endswith("weight") and not torch.equal(v.cpu(), init[k])]
    if "cnn_backbone.stem_spatial.weight" not in moved or \
            "last_layer.Dense_0.weight" not in moved:
        raise AssertionError(f"the optimiser did not step: {moved[:4]}")
    renders = len(list((run / "img" / "epoch-0_pushed").glob("*.mp4")))
    if not (launches and backward_calls):
        raise AssertionError(f"training path: roi_cosine_cuda launches "
                             f"{launches}, backward calls {backward_calls}")
    log(f"[7 train] python -m protoasnet_tpu_torch.main {' '.join(args[2:])}"
        f": train, val, push, push + replace, val_push, checkpoint in "
        f"{seconds:.1f}s; {n_losses} finite loss values; {len(moved)} weight "
        f"tensors moved by the optimiser; {renders} prototype clips "
        f"rendered; roi_cosine_cuda launches {launches}, backward calls "
        f"{backward_calls}")
    return {"roi_cosine_cuda": launches, "backward_calls": backward_calls,
            "run": run, "args": args}


def head_grad_bound_ms(n, s, p, d, dtype):
    """Least time for the head's backward on an H100: occ, feat (``dtype``),
    roi, g_roi (fp32), g_sim and the prototypes read once, g_occ, g_feat
    (``dtype``) and g_protos written once at HBM rate, against the FLOPs of
    the two products (2 * 2*N*S*P*D) at the card's peak for ``dtype``."""
    b = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * n * s * (p + d) * b + 2 * n * p * d * 4 + n * p * 4 \
        + 2 * p * d * 4
    return _bound(nbytes, 4 * n * s * p * d, dtype)


def phase_head_grad(dev, shape=TRAIN_HEAD, tag="7 head grad"):
    """The head's gradient through ``RoiCosineFunction`` at a train shape
    (the flagship's N=5, S=1568, P=40, D=256 unless ``shape`` says
    otherwise): fp32 inputs against a float64 plain-head autograd (TF32
    off, 1e-5 of max |ref|), bf16 inputs against the plain head's autograd
    on the same bf16 inputs (1e-2); the backward timed against its bound.
    Returns the bf16 record."""
    from protoasnet_tpu_torch.ops.roi_cosine import (roi_cosine_backward,
                                                     roi_cosine_torch)
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

    n, s, p, d = (shape[k] for k in "nspd")
    g = torch.Generator(device=dev).manual_seed(5)
    occ32 = torch.rand((n, s, p), device=dev, generator=g) * 0.05
    feat32 = torch.randn((n, s, d), device=dev, generator=g)
    protos = torch.rand((p, d), device=dev, generator=g)
    g_roi = torch.randn((n, p, d), device=dev, generator=g) * 1e-3
    g_sim = torch.randn((n, p), device=dev, generator=g)
    record = None
    for dtype, ref_dt, tol in ((torch.float32, torch.float64, 1e-5),
                               (torch.bfloat16, torch.float32, 1e-2)):
        leaves = [t.clone().requires_grad_(True)
                  for t in (occ32.to(dtype), feat32.to(dtype), protos)]
        ref_in = [t.detach().to(ref_dt).requires_grad_(True)
                  for t in leaves]
        with no_tf32():
            roi, sim = roi_cosine_cuda(*leaves)
            ((roi * g_roi).sum() + (sim * g_sim).sum()).backward()
            r_roi, r_sim = roi_cosine_torch(*ref_in)
            ((r_roi * g_roi.to(ref_dt)).sum()
             + (r_sim * g_sim.to(ref_dt)).sum()).backward()
        torch.cuda.synchronize()
        errs = [max_rel_err(t.grad, r.grad) for t, r in zip(leaves, ref_in)]
        dtypes = [t.grad.dtype for t in leaves]
        if dtypes != [dtype, dtype, torch.float32] or \
                max(r for _, r in errs) >= tol:
            raise AssertionError(f"head gradient {dtype}: {dtypes}, errors "
                                 f"{errs} (limit {tol:g} of max |ref|)")
        # the backward alone: roi_cosine_backward on the saved residuals,
        # the plain head's autograd backward on the same graph, and the two
        # products as one torch.bmm each (the library's share of the work)
        occ, feat = leaves[0].detach(), leaves[1].detach()
        roi_d = roi.detach()

        def bwd():
            return roi_cosine_backward(occ, feat, protos, roi_d, g_roi,
                                       g_sim)

        p_in = [t.detach().requires_grad_(True) for t in leaves]
        p_roi, p_sim = roi_cosine_torch(*p_in)

        def plain_bwd():
            return torch.autograd.grad((p_roi, p_sim), p_in, (g_roi, g_sim),
                                       retain_graph=True)

        g_tot = torch.randn((n, p, d), device=dev, generator=g).to(dtype)

        def bmm_pair():
            return (torch.bmm(occ, g_tot), torch.bmm(feat,
                                                     g_tot.transpose(1, 2)))

        with no_tf32():
            times = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                times[which].append(time_ms(
                    plain_bwd if which == "plain" else bwd, 50))
            lib_ms = time_ms(bmm_pair, 50)
        bound_ms, bound_by = head_grad_bound_ms(n, s, p, d, dtype)
        ms, plain_ms = min(times["kernel"]), min(times["plain"])
        err = max(e for e, _ in errs)
        log(f"[{tag}] {str(dtype)[6:]} N={n} S={s} P={p} D={d}: "
            f"g_occ/g_feat/g_protos max abs err "
            f"{[f'{e:.3e}' for e, _ in errs]} "
            f"({[f'{r:.3e}' for _, r in errs]} of max |ref|, limit {tol:g}, "
            f"vs {str(ref_dt)[6:]} plain autograd); cotangents "
            f"{[str(t)[6:] for t in dtypes]}; backward {ms:.4f} ms (runs "
            f"{times['kernel']}), plain autograd backward {plain_ms:.4f} ms, "
            f"two torch.bmm {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
        if dtype == torch.bfloat16:
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": lib_ms}
    return record


def _step_vs_cpu(dev, tag, label, mcfg, make_step, sample, target, lr,
                 term_tol, **step_kw):
    """One fp32 train step (TF32 off, batch 2, full width) of the model of
    ``mcfg`` on the card against the same step of the port on the CPU:
    same weights and batch (and ``step_kw``, the affine draw);
    ``make_step(model, optimizer)`` gives the train step. Held: the loss terms within ``term_tol``
    relative (cuDNN and CPU convolutions in another order); the
    prototypes' and readout's gradients within 1e-4 of their max; on each
    device the update is Adam's first step, -lr * g / (|g| + eps) with g
    the gradient plus the weight decay, within 2.5e-7 (the fp32 rounding of
    the parameters, |p| < 2); and no update flips its sign."""
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import GROUPS, GroupAdam

    wd, eps = 1e-3, 1e-8
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, *sample)).astype(np.float32))
    valid = torch.tensor([True, True])
    names = ("prototype_vectors", "last_layer.Dense_0.weight")
    out = []
    for device in (torch.device("cpu"), dev):
        model = build_model(dict(mcfg, dtype="float32"), device=device,
                            seed=0)
        opt = GroupAdam(model, {gr: wd for gr in GROUPS})
        step = make_step(model, opt)
        with no_tf32():
            m = step(x.to(device), target.to(device), valid.to(device),
                     {gr: lr for gr in GROUPS}, **step_kw)
            if m["applied"]:
                raise AssertionError("micro-step 1 of 2 applied")
            params = dict(model.named_parameters())
            grads = {k: params[k].grad.detach().double().cpu() for k in names}
            before = {k: params[k].detach().double().cpu() for k in names}
            opt.step({gr: lr for gr in GROUPS})
        out.append(dict(
            terms={k: float(v) for k, v in m.items()
                   if k.startswith("loss")},
            grads=grads, moved={k: params[k].detach().double().cpu()
                                - before[k] for k in names},
            adam={k: -lr * (grads[k] + wd * before[k])
                  / ((grads[k] + wd * before[k]).abs() + eps)
                  for k in names}))
        del model, opt, step
    cpu, card = out
    term_rel = max(abs(card["terms"][k] - v) / max(abs(v), 1e-12)
                   for k, v in cpu["terms"].items() if v)
    grad_rel = max((card["grads"][k] - g).abs().max().item()
                   / g.abs().max().item() for k, g in cpu["grads"].items())
    adam_err = max((o["moved"][k] - o["adam"][k]).abs().max().item()
                   for o in out for k in names)
    upd_diff = max((card["moved"][k] - cpu["moved"][k]).abs().max().item()
                   for k in names)
    flips = sum(int(((card["moved"][k] * cpu["moved"][k]) < 0).sum())
                for k in names)
    log(f"[{tag}] {label} fp32 batch 2 card vs CPU: loss terms max rel diff "
        f"{term_rel:.3e} (limit {term_tol:g}; {cpu['terms']['loss_all']:.6f}"
        f" vs {card['terms']['loss_all']:.6f}); prototype_vectors/last_layer"
        f" gradients max diff {grad_rel:.3e} of their max; updates vs Adam's "
        f"first step {adam_err:.3e}; card vs CPU updates max abs diff "
        f"{upd_diff:.3e} (lr {lr:g}), {flips} sign flips")
    if term_rel > term_tol or grad_rel > 1e-4 or adam_err > 2.5e-7 or flips:
        raise AssertionError(f"{label}: card train step differs from the "
                             f"CPU's")


def phase_train_step_vs_cpu(dev, cfg):
    """The flagship's fp32 train step (its loss weights and lr) on the card
    against the CPU's, loss terms within 1e-4 relative."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.train.optim import GradAccumulator
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps

    bundle = LossBundle(cfg["train"]["criterion"], num_classes=4,
                        abstain_class=True)
    _step_vs_cpu(dev, "7 train step", "flagship", cfg["model"],
                 lambda model, opt: make_xprotonet_steps(
                     model, bundle, opt, GradAccumulator(opt.params, 2))[0],
                 CLIP, torch.tensor([0, 2]),
                 float(cfg["train"]["optimizer"]["lr_same"]), 1e-4,
                 affine=(11.0, 1.25))


def _train_rate(tag, what, step, x, target, unit, **kw):
    """Samples/s of ``step`` (a train micro-step) on the device-resident
    batch ``x``, the device-busy share and the top device ops of two
    profiled micro-steps; returns (samples/s, busy share)."""
    from protoasnet_tpu_torch.train.optim import GROUPS
    from protoasnet_tpu_torch.utils.profiling import device_window

    n = len(x)
    valid = torch.ones(n, dtype=torch.bool, device=x.device)
    lrs = {gr: 1e-4 for gr in GROUPS}
    for _ in range(4):
        step(x, target, valid, lrs, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        step(x, target, valid, lrs, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    window = device_window(lambda: step(x, target, valid, lrs, **kw),
                           iters=2, warmup=0)
    events = window.events
    # kernels only: a user annotation's range (``Optimizer.step#Adam.step``)
    # spans the kernels launched inside it and the gaps between them
    rows = [(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 2e3, e.key,
             e.count // 2) for e in window.kernel_events]
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    host = sorted(((e.self_cpu_time_total / 2e3, e.key, e.count // 2)
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  reverse=True)
    log(f"[{tag}] {what}: {ms:.2f} ms, {n / ms * 1e3:.1f} {unit}/s, peak "
        f"memory {peak:.2f} GiB; device busy {busy:.2f} ms per micro-step "
        f"({100 * busy / ms:.1f}% of it; kernels only, profiler, 2 "
        f"micro-steps: {window.kernel_records} kernel records for "
        f"{window.launch_calls} kernel launch calls)")
    for dev_ms, name, count in rows[:12]:
        log(f"[{tag}]   {dev_ms:9.3f} ms {100 * dev_ms / busy:5.1f}% "
            f"x{count:<4d} {name[:110]}")
    log(f"[{tag}] host: self CPU ms per micro-step (profiler; the "
        f"profiler's own cost included), top 8 of "
        f"{sum(h[0] for h in host):.2f} ms:")
    for cpu_ms, name, count in host[:8]:
        log(f"[{tag}]   {cpu_ms:9.3f} ms x{count:<4d} {name[:110]}")
    return n / ms * 1e3, busy / ms


def phase_train_rate(dev, cfg):
    """Clips/s of the bf16 flagship's train micro-step at batch 5 (the
    pair forward, all terms, backward, one Adam step every 2), and the
    top device ops of one profiled micro-step."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps

    model = build_model(cfg["model"], device=dev, seed=0)
    opt = GroupAdam(model, {gr: 1e-3 for gr in GROUPS})
    step, _, _ = make_xprotonet_steps(
        model, LossBundle(cfg["train"]["criterion"], num_classes=4,
                          abstain_class=True),
        opt, GradAccumulator(opt.params, 2))
    rate, _ = _train_rate(
        "7 train rate", "bf16 flagship train micro-step at batch 5 (pair "
        "forward, 7 terms, backward, Adam every 2)", step,
        torch.randn((5, *CLIP), device=dev),
        torch.tensor([0, 1, 2, 0, 1], device=dev), "clips",
        generator=torch.Generator().manual_seed(8))
    return rate


# phases 8-12: the 2-D family's training paths
L2_TRAIN_HEAD = dict(n=20, s=7 * 7, p=30, d=512)  # ProtoPNet at batch 20
IMAGE_TRAIN_HEAD = dict(n=20, s=7 * 7, p=40, d=512)  # image ProtoASNet
# the 2-D training runs, cut with the configs' own keys: two epochs (warm,
# then joint with the push), one micro-step an Adam step; the image
# ProtoASNet one epoch with its push
TRAIN_2D_ARGS = {
    PPNET["label"]: ("--train.num_train_epochs=2",
                     "--train.num_warm_epochs=1", "--train.push_start=1",
                     "--train.push_rate=1", "--train.accumulation_steps=1"),
    IMAGE["label"]: ("--train.num_train_epochs=1",
                     "--train.num_warm_epochs=0", "--train.push_start=0",
                     "--train.push_rate=1", "--train.accumulation_steps=1"),
}


def l2_grad_bound_ms(n, s, p, d, with_g_dist):
    """Least time for the L2 head's backward on an H100: x (N,S,D), w
    (P,D), dist (N,S,P), g_min (N,P) and, when the distances are used,
    g_dist (N,S,P) read once, g_x and g_w written once, all fp32, against
    the FLOPs of the two products (2 * 2*N*S*P*D) at the fp32 rate."""
    nbytes = (2 * n * s * d + 2 * p * d + n * s * p * (2 if with_g_dist
                                                       else 1)
              + n * p) * 4
    return _bound(nbytes, 4 * n * s * p * d, torch.float32)


def phase_l2_grad(dev):
    """The L2 head's gradient through ``L2MinFunction`` at ProtoPNet's train
    head (N=20, S=49, P=30, D=512, fp32): against ``l2_min_backward`` in
    float64 on the same inputs and the kernel's distances, and against the
    plain head's float64 autograd (these inputs have no ties), both within
    1e-5 of max |ref|. The backward timed as the training path calls it
    (only min_d is used, so g_dist is None) against its bound, the plain
    head's autograd backward and the two products as ``torch.matmul``.
    Returns its record."""
    from protoasnet_tpu_torch.ops.l2_min import (l2_min_backward,
                                                 l2_min_torch)
    from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda

    n, s, p, d = (L2_TRAIN_HEAD[k] for k in "nspd")
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.sigmoid(torch.randn((n, s, d), device=dev, generator=g))
    w = torch.rand((p, 1, 1, d), device=dev, generator=g)
    g_dist = torch.randn((n, s, p), device=dev, generator=g)
    g_min = torch.randn((n, p), device=dev, generator=g)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    with no_tf32():
        dist, min_d = l2_min_cuda(xr, wr)
        ((dist * g_dist).sum() + (min_d * g_min).sum()).backward()
        ref = l2_min_backward(x.double(), w.double().reshape(p, d),
                              dist.detach(), g_dist.double(),
                              g_min.double())
        x64 = x.double().requires_grad_(True)
        w64 = w.double().requires_grad_(True)
        r_dist, r_min = l2_min_torch(x64, w64)
        ((r_dist * g_dist.double()).sum()
         + (r_min * g_min.double()).sum()).backward()
    torch.cuda.synchronize()
    errs = [max_rel_err(xr.grad, ref[0]),
            max_rel_err(wr.grad, ref[1].reshape(w.shape)),
            max_rel_err(xr.grad, x64.grad), max_rel_err(wr.grad, w64.grad)]
    if (xr.grad.dtype, wr.grad.dtype) != (torch.float32, torch.float32) or \
            max(r for _, r in errs) >= 1e-5:
        raise AssertionError(f"L2 gradient: {xr.grad.dtype}, "
                             f"{wr.grad.dtype}, errors {errs} (limit 1e-5 "
                             f"of max |ref|)")
    dist_d, w2 = dist.detach(), w.reshape(p, d)

    def bwd():
        return l2_min_backward(x, w2, dist_d, None, g_min)

    p_in = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    _, p_min = l2_min_torch(*p_in)

    def plain_bwd():
        return torch.autograd.grad(p_min, p_in, g_min, retain_graph=True)

    g_full = torch.randn((n, s, p), device=dev, generator=g)
    x2 = x.reshape(n * s, d)

    def matmul_pair():
        return (torch.matmul(g_full, w2),
                torch.matmul(g_full.reshape(n * s, p).T, x2))

    with no_tf32():
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            times[which].append(time_ms(
                plain_bwd if which == "plain" else bwd, 100))
        lib_ms = time_ms(matmul_pair, 100)
    bound_ms, bound_by = l2_grad_bound_ms(n, s, p, d, with_g_dist=False)
    ms, plain_ms = min(times["kernel"]), min(times["plain"])
    log(f"[8 l2 grad] fp32 N={n} S={s} P={p} D={d}: g_x/g_w max abs err vs "
        f"float64 l2_min_backward {errs[0][0]:.3e}/{errs[1][0]:.3e} "
        f"({errs[0][1]:.3e}/{errs[1][1]:.3e} of max |ref|), vs float64 "
        f"plain autograd {errs[2][1]:.3e}/{errs[3][1]:.3e} of max |ref| "
        f"(limit 1e-5); backward as trained (g_min only) {ms:.4f} ms (runs "
        f"{times['kernel']}), plain autograd backward {plain_ms:.4f} ms, "
        f"the two products as torch.matmul {lib_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": max(errs[0][0], errs[1][0]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def phase_train_2d(dev, spec, cfg, counter, tag, work: Path):
    """``protoasnet_tpu_torch.main.main`` on 12 synthetic videos (images
    at 224x224, frames=1) with the full-width model of ``spec``'s config
    and its own batch, cut by ``TRAIN_2D_ARGS``. ``counter``'s launch and
    backward counts are set to 0 just before and read just after. Checks
    the run's files, the push's pictures against the prototypes found,
    finite losses, which groups each stage moved and that the optimiser
    stepped. Returns (launches, backward calls, the run dir, which stays
    under ``work``)."""
    import pickle

    from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from protoasnet_tpu_torch.main import main as train_main
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import group_of

    ppnet = spec is PPNET
    key = spec["label"].replace(" ", "_")
    csv = make_synthetic_dataset(str(work / f"{key}_data"), num_videos=12,
                                 seed=3)
    args = [f"--config_path={CONFIGS / spec['config']}",
            f"--save_dir={work / f'{key}_runs'}",
            f"--data.data_info_file={csv}", *TRAIN_2D_ARGS[spec["label"]]]
    counter.launches = 0
    counter.backward_calls = 0
    t0 = time.monotonic()
    agent = train_main(args)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches, calls = counter.launches, counter.backward_calls
    run = Path(agent.save_dir)
    push = run / "img" / f"epoch-{1 if ppnet else 0}_pushed"
    files = (["bb.npy", "bb-receptive_field.npy"] if ppnet else []) + [
        "prototypes_info.pickle"]
    for name in ["last.ckpt", "metrics.jsonl"] + [
            str(push.relative_to(run) / f) for f in files]:
        if not (run / name).exists():
            raise AssertionError(f"{spec['label']}: training run lacks "
                                 f"{name}")
    with open(push / "prototypes_info.pickle", "rb") as f:
        info = pickle.load(f)
    found = int((np.asarray(info["prototypes_gts"]) >= 0).sum())
    pngs = len(list(push.glob("*.png")))
    if not found or pngs != found:
        raise AssertionError(f"{spec['label']}: {pngs} pictures for "
                             f"{found} prototypes found")
    n_losses, modes = _finite_losses(run / "metrics.jsonl")
    if not {"train", "val", "val_push"} <= modes:
        raise AssertionError(f"{spec['label']}: epoch rows of "
                             f"{sorted(modes)} only")
    init = build_model(cfg["model"], device="cpu",
                       seed=int(cfg["train"]["seed"])).state_dict()
    moved = {group_of(k) for k, v in agent.model.named_parameters()
             if not torch.equal(v.detach().cpu(), init[k])}
    if moved != {group_of(k) for k, _ in
                 agent.model.named_parameters()}:
        raise AssertionError(f"{spec['label']}: groups moved {moved}")
    stages = {}
    if ppnet:
        # a stage's Adam moments are nonzero exactly for the groups it
        # moved: frozen groups get no gradient and no weight decay
        from protoasnet_tpu_torch.utils.io import load_checkpoint

        ckpt = load_checkpoint(str(run / "last.ckpt"))
        name_of = {id(v): k for k, v in agent.model.named_parameters()}
        for st in ("warm", "last"):
            # the state's indices follow the optimiser's parameter order
            names = [name_of[id(v)]
                     for v in agent.stages.optimizers[st].params]
            state = ckpt[f"optimizer_{st}"]["state"]
            stages[st] = sorted({group_of(names[i]) for i, v in
                                 state.items() if v["exp_avg"].any()})
        if stages != {"warm": ["add_on", "prototypes"],
                      "last": ["last_layer"]}:
            raise AssertionError(f"ProtoPNet: stages moved {stages}")
    if not (launches and calls):
        raise AssertionError(f"{spec['label']} training path: kernel "
                             f"launches {launches}, backward calls {calls}")
    log(f"[{tag}] python -m protoasnet_tpu_torch.main --config_path="
        f"{spec['config']} {' '.join(args[3:])} (full width, "
        f"{agent.model.dtype}, train batch "
        f"{agent.data_loaders['train'].batch_size}): done in "
        f"{seconds:.1f}s; {n_losses} finite loss values; {found} prototypes "
        f"found, {pngs} pictures; groups moved {sorted(moved)}"
        + (f"; Adam moments by stage {stages}" if stages else "")
        + f"; {counter.__name__} launches {launches}, backward calls "
        f"{calls}")
    return launches, calls, run


def phase_ppnet_step_vs_cpu(dev, cfg):
    """ProtoPNet's fp32 train step on the card against the CPU's, loss
    terms within 1e-5 relative."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.train.optim import GradAccumulator
    from protoasnet_tpu_torch.train.steps import make_protopnet_steps

    bundle = LossBundle(cfg["train"]["criterion"], num_classes=3,
                        abstain_class=False)
    _step_vs_cpu(dev, "11 train step", "ProtoPNet", cfg["model"],
                 lambda model, opt: make_protopnet_steps(
                     model, bundle, opt, GradAccumulator(opt.params, 2))[0],
                 PPNET["sample"], torch.tensor([0, 2]), 1e-4, 1e-5)


def phase_train_rate_2d(dev, cfgs):
    """Images/s of the train micro-steps at batch 20 (one Adam step each)
    on a device-resident batch: ProtoPNet fp32 and the image ProtoASNet
    bf16, each with its busy share and top device ops."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import (make_protopnet_steps,
                                                  make_xprotonet_steps)

    out = {}
    for spec, make, k in ((PPNET, make_protopnet_steps, 3),
                          (IMAGE, make_xprotonet_steps, 4)):
        cfg = cfgs[spec["label"]]
        model = build_model(cfg["model"], device=dev, seed=0)
        opt = GroupAdam(model, {gr: 1e-3 for gr in GROUPS})
        step = make(model, LossBundle(cfg["train"]["criterion"],
                                      num_classes=k,
                                      abstain_class=spec is IMAGE),
                    opt, GradAccumulator(opt.params, 1))[0]
        dt = "bf16" if model.dtype == torch.bfloat16 else "fp32"
        # the image ProtoASNet draws its TransformLoss affine from this
        kw = {} if spec is PPNET else {
            "generator": torch.Generator().manual_seed(8)}
        out[spec["label"]] = _train_rate(
            "12 train rate", f"{spec['label']} {dt} train micro-step at "
            f"batch 20 (forward, terms, backward, Adam)", step,
            torch.randn((20, *spec["sample"]), device=dev),
            torch.arange(20, device=dev) % 3, "images", **kw)
        del model, opt, step
    return out


# phases 13-14: from a trained run to explanations and a served bundle;
# the explain sweep's timed test split: 288 synthetic videos (about 390
# clips, one per heart cycle: four eval batches of 128) beside 6 train and
# 6 val videos
SWEEP_SPLITS = ("train", "val") + ("test",) * 48
SWEEP_VIDEOS = 6 * len(SWEEP_SPLITS)


def _export(run: Path, out: Path, dev):
    """``python -m protoasnet_tpu_torch.serve export --run_dir`` in
    process on ``dev``; returns its seconds and the bundle's MB."""
    from protoasnet_tpu_torch.serve import main as serve_main

    t0 = time.monotonic()
    serve_main(["export", "--run_dir", str(run), "--out", str(out),
                "--device", dev.type])
    return time.monotonic() - t0, out.stat().st_size / 1e6


def _eval_logits(agent, x: np.ndarray) -> np.ndarray:
    """The agent's own eval step on ``x`` (every sample valid; a staged
    agent's is the joint stage's)."""
    n = len(x)
    dev = agent.device
    eval_step = agent._steps_for("default")[1]
    m = eval_step(torch.from_numpy(x).to(dev),
                        torch.zeros(n, dtype=torch.long, device=dev),
                        torch.ones(n, dtype=torch.bool, device=dev))
    return m["logits"].float().cpu().numpy()


def _padded(fn, x: np.ndarray) -> np.ndarray:
    """``fn`` on ``x`` padded with zero samples to the server's bucket, as
    the server runs it (every ladder of the smoke's servers is the powers
    of two up to 128); the outputs of ``x``'s samples."""
    n = len(x)
    xp = np.zeros((1 << (n - 1).bit_length(), *x.shape[1:]), np.float32)
    xp[:n] = x
    return fn(xp)[:n]


def _plain_served(model, x: np.ndarray) -> np.ndarray:
    """``model``'s plain-head eval forward on ``x`` padded to the server's
    bucket; the logits of ``x``'s samples."""
    from protoasnet_tpu_torch.serve import make_serving_fn

    model.eval().head_impl = "torch"
    try:
        return _padded(make_serving_fn(model), x)
    finally:
        model.head_impl = None


def phase_explain_export(dev, train):
    """13: the flagship's trained run of phase 7 (full width, bf16) through
    ``python -m protoasnet_tpu_torch.explain --explain_locally=true
    --explain_globally=true --eval_data_type=test`` (in process;
    ``roi_cosine_cuda``'s launches set to 0 just before, > 0 just after),
    its products against the same agent with the plain head on the same
    clips (bf16 limit 2e-2), the sanity report and the panels (TOP_K per
    sample); then ``serve export --run_dir`` and the bundle served over
    HTTP (launches counted again), its logits against the agent's own
    eval step and against the plain head on the same clips (2e-2). The
    test split holds 2 clips: the seconds are fixed costs, and the sweep's
    rate is timed at size in ``phase_sweep``. Returns (sweep launches,
    serve launches)."""
    import pickle

    from protoasnet_tpu_torch.explain.__main__ import main as explain_main
    from protoasnet_tpu_torch.explain.local import TOP_K
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

    run = train["run"]
    args = [*train["args"], "--explain_locally=true",
            "--explain_globally=true", "--eval_data_type=test"]
    roi_cosine_cuda.launches = 0
    t0 = time.monotonic()
    out = explain_main(args)
    torch.cuda.synchronize()
    explain_s = time.monotonic() - t0
    sweep_launches = roi_cosine_cuda.launches
    if not sweep_launches:
        raise AssertionError("explain: roi_cosine_cuda never launched")
    agent, summary = out["agent"], out["local"]
    if Path(agent.save_dir) != run:
        raise AssertionError(f"explain ran in {agent.save_dir}, not {run}")
    with open(run / "explain_test" / "model_products.pickle", "rb") as f:
        prod = pickle.load(f)
    n = len(prod["similarities"])
    on_disk = {p.name.split(".")[0]
               for p in (run / "explain_test").glob("*_rank*")}
    if not n or summary["samples"] != n or \
            summary["panels"] != TOP_K * n or len(on_disk) != TOP_K * n:
        raise AssertionError(f"explain: {n} samples, summary {summary}, "
                             f"{len(on_disk)} panels on disk")
    sanity = summary["sanity"]
    if not (np.isfinite(sanity["f1_mean"])
            and sanity["confusion"].sum() == n):
        raise AssertionError(f"explain: sanity report {sanity}")
    if not (np.isfinite(prod["logits"]).all()
            and prod["clips"].shape == (n, *CLIP)):
        raise AssertionError(f"explain: products {prod['clips'].shape}")
    # the same clips through the plain head
    model = agent.model
    model.head_impl = "torch"
    sims, logits = [], []
    with torch.no_grad():
        for i in range(0, n, 8):
            x = torch.from_numpy(prod["clips"][i:i + 8]).to(dev)
            _, dist, _, lg = model.push_forward(x)
            sims.append(1.0 - dist.float().cpu().numpy())
            logits.append(lg.float().cpu().numpy())
    model.head_impl = None
    d_sim = _max_diff(prod["similarities"], np.concatenate(sims))
    d_logit = _max_diff(prod["logits"], np.concatenate(logits))
    if max(d_sim, d_logit) > 2e-2:
        raise AssertionError(f"explain vs plain head: similarities "
                             f"{d_sim}, logits {d_logit}")

    bundle = run.parent / "flagship_bundle.zip"
    roi_cosine_cuda.launches = 0
    export_s, mb = _export(run, bundle, dev)
    xs = [prod["clips"][:8]]  # the test clips, up to one bucket
    served, serve_s, _, _ = _serve_posts(str(bundle), dev, xs)
    serve_launches = roi_cosine_cuda.launches
    if not serve_launches:
        raise AssertionError("served export: roi_cosine_cuda never launched")
    d_served = _max_diff(served[0], _eval_logits(agent, xs[0]))
    # bf16: the heads' fp32 outputs differ by ~1e-6, which can flip one
    # bf16 rounding before the bf16 readout (as in phase 4)
    d_served_plain = _max_diff(served[0], _plain_served(model, xs[0]))
    if served[0].shape != (len(xs[0]), 4) or \
            max(d_served, d_served_plain) > 2e-2:
        raise AssertionError(f"served export vs eval step {d_served}, vs "
                             f"plain head {d_served_plain}")
    log(f"[13 explain+export] python -m protoasnet_tpu_torch.explain on "
        f"phase 7's run (bf16 flagship, {n} test clips; fixed costs): "
        f"{explain_s:.2f}s in all; sweep {summary['sweep_s']:.3f}s (data "
        f"loading included), render {summary['render_s']:.3f}s for "
        f"{summary['panels']} panels "
        f"({summary['render_s'] / summary['panels']:.4f} s/panel); sanity "
        f"mean F1 {sanity['f1_mean']:.4f}; vs plain head: similarities "
        f"{d_sim:.3e}, logits {d_logit:.3e}; roi_cosine_cuda launches "
        f"{sweep_launches} (sweep and global push); serve export "
        f"{export_s:.2f}s, bundle {mb:.1f} MB; served {len(xs[0])} test "
        f"clips in {serve_s:.2f}s, vs eval step {d_served:.3e}, vs plain "
        f"head {d_served_plain:.3e}; roi_cosine_cuda launches "
        f"{serve_launches} (served)")
    return sweep_launches, serve_launches


def phase_sweep(dev, cfg, train, work: Path):
    """13: the explain sweep (``collect_model_products``) at full width
    over a test split of real size: ``SWEEP_VIDEOS`` synthetic videos of
    their own manifest, the agent of phase 7's config with phase 7's
    ``last.ckpt`` (``--model.checkpoint_path``) and the config's own
    loader workers. ``roi_cosine_cuda``'s launches are set to 0 just
    before the sweep and read just after: one per eval batch. Then the
    loader alone over the same split, and the sweep's passes without the
    products' host copies. Returns the launches."""
    from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
    from protoasnet_tpu_torch.explain.local import (collect_model_products,
                                                    sweep)
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.train.agents import build_agent
    from protoasnet_tpu_torch.utils.config import updated_config

    t0 = time.monotonic()
    csv = make_synthetic_dataset(str(work / "sweep_data"),
                                 num_videos=SWEEP_VIDEOS, seed=13,
                                 splits=SWEEP_SPLITS)
    args = [a for a in train["args"] if not a.startswith(
        ("--save_dir", "--data.data_info_file", "--data.num_workers"))]
    config = updated_config([*args, f"--save_dir={work / 'sweep_run'}",
                             f"--data.data_info_file={csv}",
                             "--model.checkpoint_path="
                             f"{train['run'] / 'last.ckpt'}"])
    (work / "sweep_run").mkdir()
    agent = build_agent(config)
    setup_s = time.monotonic() - t0
    if agent.current_iteration == 0:
        raise AssertionError("sweep: phase 7's checkpoint did not load")
    loader = agent.data_loaders["test"]
    roi_cosine_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    prod = collect_model_products(agent, "test")
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = roi_cosine_cuda.launches
    n = len(prod["similarities"])
    per = int(cfg["data"]["eval_batch_size"])
    if n != len(loader.dataset) or len(loader) != -(-n // per) or \
            launches != len(loader):
        raise AssertionError(f"sweep: {n} clips of {len(loader.dataset)}, "
                             f"{len(loader)} batches, {launches} launches")
    if prod["clips"].shape != (n, *CLIP) or not all(
            np.isfinite(prod[k]).all() for k in
            ("similarities", "occurrence_maps", "logits")):
        raise AssertionError(f"sweep: products {prod['clips'].shape}")
    del prod
    # the loader alone over the same split (gather, copy, device
    # transform), then the sweep's passes alone (the loader, push_step,
    # the similarities to the host; no products kept)
    t0 = time.monotonic()
    for _ in loader:
        pass
    torch.cuda.synchronize()
    data_s = time.monotonic() - t0
    t0 = time.monotonic()
    for _ in sweep(agent, "test"):
        pass
    torch.cuda.synchronize()
    passes_s = time.monotonic() - t0
    log(f"[13 sweep] collect_model_products, the explain sweep, at full "
        f"width (bf16, phase 7's weights) over a test split of {n} clips "
        f"({len(loader)} batches of up to {per}, "
        f"{loader.num_workers} loader workers): {seconds:.3f}s, "
        f"{n / seconds:.1f} clips/s, data loading and the clips' copy to "
        f"the host included; the loader alone over the same split "
        f"{data_s:.3f}s, the sweep's passes alone (no products kept) "
        f"{passes_s:.3f}s; set-up (the {SWEEP_VIDEOS} videos written, the "
        f"agent built, its packed stores and the checkpoint) "
        f"{setup_s:.2f}s; roi_cosine_cuda launches {launches}")
    del agent
    return launches


def phase_export_ppnet(dev, run: Path):
    """14: ProtoPNet's trained run of phase 9 through ``serve export
    --run_dir`` and served over HTTP, ``l2_min_cuda``'s launches set to 0
    just before the export and read once the server has stopped (> 0);
    the served logits against the rebuilt agent's eval step (fp32, 1e-3).
    Returns the launches."""
    from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda
    from protoasnet_tpu_torch.serve import load_trained_agent

    bundle = run.parent / "ppnet_bundle.zip"
    l2_min_cuda.launches = 0
    export_s, mb = _export(run, bundle, dev)
    x = np.random.default_rng(14).normal(
        size=(4, *PPNET["sample"])).astype(np.float32)
    served, serve_s, _, _ = _serve_posts(str(bundle), dev, [x])
    launches = l2_min_cuda.launches
    if not launches:
        raise AssertionError("ProtoPNet export: l2_min_cuda never launched")
    agent, _ = load_trained_agent(str(run), dev)
    d = _max_diff(served[0], _eval_logits(agent, x))
    # fp32: only the heads' summation order differs (as in phase 4)
    d_plain = _max_diff(served[0], _plain_served(agent.model, x))
    if served[0].shape != (4, 3) or d > 1e-3 or d_plain > 1e-4:
        raise AssertionError(f"ProtoPNet served export vs eval step {d}, "
                             f"vs plain head {d_plain}")
    log(f"[14 export ProtoPNet] serve export of phase 9's run: "
        f"{export_s:.2f}s, bundle {mb:.1f} MB; served 4 images in "
        f"{serve_s:.2f}s, vs eval step {d:.3e}, vs plain head "
        f"{d_plain:.3e}; l2_min_cuda launches {launches}")
    return launches


# phase 15: a trained run served live, reloaded under traffic, tuned
LIVE_BATCH = 128  # the daemon's default max_batch: buckets 1, 2, ..., 128
LIVE_CLIPS = LIVE_BATCH + 2
# (a)'s batches: the client splits at LIVE_BATCH + 1 clips, the daemon
# the first request into max_batch + 1
LIVE_CHUNKS = ((0, LIVE_BATCH), (LIVE_BATCH, LIVE_BATCH + 1),
               (LIVE_BATCH + 1, LIVE_CLIPS))
# clips per request of each of the four posting threads: the batcher
# groups whatever is queued, and 72 with any other request fills bucket 128
TRAFFIC_SIZES = (1, 3, 8, 72)
TRAFFIC_BEFORE = 300  # requests answered before the first reload
RELOADS = 5  # to the second run and back, ending on the second
SLOWEST_S = 10.0  # no request may wait this long (F3 stalled one for 63 s)
MATCH_TOL = 2e-2  # bf16 logits
TUNE_BATCHES = "32,64,128,256"


def _chunked(fn, x):
    """``fn`` on ``x`` in (a)'s batches, concatenated."""
    return np.concatenate([fn(x[a:b]) for a, b in LIVE_CHUNKS])


def _reload_target(run: Path, work: Path) -> Path:
    """A second flagship run under ``work``: ``run``'s configs and its
    ``last.ckpt`` with the readout's weights moved by seeded noise,
    written by the port's ``save_checkpoint``."""
    import shutil

    from protoasnet_tpu_torch.utils.io import load_checkpoint, save_checkpoint

    target = work / "video_runs_reload" / run.name
    target.mkdir(parents=True)
    for cfg in run.glob("config_*.yml"):
        shutil.copy(cfg, target / cfg.name)
    ckpt = load_checkpoint(str(run / "last.ckpt"))
    key = "last_layer.Dense_0.weight"
    w = ckpt["model"][key]
    g = torch.Generator().manual_seed(15)
    ckpt["model"][key] = w + torch.randn(w.shape, generator=g).to(w.dtype)
    save_checkpoint(ckpt, str(target / "last.ckpt"))
    return target


def _traffic(client, xs, stop, records):
    """Post ``xs[i]`` from thread i until ``stop``; each record is (i,
    start, end, logits or the exception)."""
    def post(i):
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                out = client.predict(xs[i])
            except Exception as e:  # noqa: BLE001 — checked by the caller
                out = e
            records.append((i, t0, time.monotonic(), out))

    threads = [threading.Thread(target=post, args=(i,), name=f"traffic{i}")
               for i in range(len(xs))]
    for t in threads:
        t.start()
    return threads


def _which_set(out, sets):
    """For each row of ``out``, the one weight set whose logits (``sets``,
    one array per set) it is within ``MATCH_TOL`` of, and that gap; raises
    when a row is within it of none or of more than one."""
    gaps = np.stack([np.abs(out - r).max(axis=1) for r in sets])
    near = gaps <= MATCH_TOL
    if not (near.sum(axis=0) == 1).all():
        raise AssertionError(f"reload: a response's rows are within "
                             f"{MATCH_TOL} of {near.sum(axis=0)} sets "
                             f"(gaps {gaps})")
    return near.argmax(axis=0), gaps.min(axis=0)


def _p50(records, keep):
    """p50 in ms and count of the requests (start, end) that ``keep``
    holds."""
    lat = sorted((end - t0) * 1e3 for _, t0, end, _ in records
                 if keep(t0, end))
    return (lat[len(lat) // 2] if lat else None), len(lat)


def _ms(v):
    return "none" if v is None else f"{v:.2f} ms"


def _gib(v):
    return f"{v / 2**30:.3f}"


def _watch_reload(client, poll_s=0.02):
    """Poll GET /v1/reload until the reload ends; returns (final status,
    the monotonic time each state was first seen)."""
    seen = {}
    while True:
        st = client.reload_status()
        seen.setdefault(st["state"], time.monotonic())
        if st["state"] in ("serving", "error"):
            return st, seen
        time.sleep(poll_s)


def _reloads_under_traffic(client, targets, xs):
    """Post ``xs`` from one thread each until ``TRAFFIC_BEFORE`` requests
    have answered, then reload to each of ``targets`` in turn (each warmed
    and swapped before the next), the threads posting throughout. Returns
    (the records, one (POST, warm-up start, swap, peak allocated, peak
    reserved) per reload, memory (allocated, reserved) before the first
    and after the last)."""
    records, stop = [], threading.Event()
    threads = _traffic(client, xs, stop, records)
    try:
        t0 = time.monotonic()
        while len(records) < TRAFFIC_BEFORE and time.monotonic() - t0 < 120:
            time.sleep(0.05)
        torch.cuda.synchronize()
        mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
        windows = []
        for k, target in enumerate(targets):
            torch.cuda.reset_peak_memory_stats()
            t_post = time.monotonic()
            accepted = client.reload(str(target), wait=False)
            st, seen = _watch_reload(client)
            if accepted["generation"] != k or st["state"] != "serving" or \
                    st["generation"] != k + 1:
                raise AssertionError(f"reload {k + 1}: accepted {accepted}, "
                                     f"ended {st}")
            windows.append((t_post, seen.get("compiling", seen["serving"]),
                            seen["serving"],
                            torch.cuda.max_memory_allocated(),
                            torch.cuda.max_memory_reserved()))
            time.sleep(0.5)  # requests of one weight set between reloads
        torch.cuda.synchronize()
        mem1 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    finally:
        stop.set()
        for t in threads:
            t.join(300)
    if any(t.is_alive() for t in threads):
        raise AssertionError("reload: a traffic thread did not stop")
    return records, windows, mem0, mem1


def phase_live(dev, train, image_run: Path, work: Path):
    """15 (a)-(c): phase 7's bf16 flagship run served live
    (``server.serve_live`` at ``LIVE_BATCH``, reload on, rooted at
    ``work``) and reached through the port's ``ServingClient``.

    (a) ``LIVE_CLIPS`` clips in one ``predict`` of a client whose request
    ceiling is ``LIVE_BATCH + 1`` clips: it splits them, the daemon its
    first request into ``LIVE_CHUNKS``; the logits within 2e-2 of the
    rebuilt agent's eval step and the plain head on the same padded
    batches, bit-equal to phase 13's exported bundle on the same batches;
    /v1/spec's buckets are the ladder. (b) ``RELOADS`` reloads between a
    second run (``_reload_target``) and phase 7's, ending on the second,
    while one thread per ``TRAFFIC_SIZES`` posts: the batcher groups the
    requests; none fails or waits ``SLOWEST_S``; every row of a response
    is within ``MATCH_TOL`` of one set's logits (each request's alone) and
    all of a response's rows of one set; each reload's generation; the new
    logits within 2e-2 of the new run's eval step; no error in /v1/stats;
    the reloads' seconds (load, warm-up), peak allocated and reserved
    memory across them, request p50 before and during. (c) a reload to
    phase 10's image run ends in ``error`` with the contract message, and
    the current logits keep serving. ``roi_cosine_cuda``'s launches are
    set to 0 before (a) and before (b) and read after each. Returns
    (launches of (a), of (b)-(c), (a)'s logits)."""
    from protoasnet_tpu_torch import server
    from protoasnet_tpu_torch.client import ServingClient, ServingError
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.serve import (load_serving_bundle,
                                            load_trained_agent)

    run = train["run"]
    target = _reload_target(run, work)
    rng = np.random.default_rng(15)
    x = rng.normal(size=(LIVE_CLIPS, *CLIP)).astype(np.float32)
    xs = [rng.normal(size=(k, *CLIP)).astype(np.float32)
          for k in TRAFFIC_SIZES]
    roi_cosine_cuda.launches = 0
    t0 = time.monotonic()
    with _serving(server.serve_live, str(run), max_batch=LIVE_BATCH,
                  warmup=True, allow_reload=True, reload_root=str(work),
                  device=dev) as url:
        start_s = time.monotonic() - t0
        client = ServingClient(url, timeout_s=300, retries=0)
        spec = client.spec()
        # as against a daemon whose body cap holds LIVE_BATCH + 1 clips
        splitting = ServingClient(url, timeout_s=300, retries=0)
        splitting._spec = dict(spec, max_request_samples=LIVE_BATCH + 1)
        t0 = time.monotonic()
        live = splitting.predict(x)
        live_s = time.monotonic() - t0
        launches_a = roi_cosine_cuda.launches
        if spec["buckets"] != list(server._bucket_ladder(LIVE_BATCH)):
            raise AssertionError(f"live: /v1/spec buckets {spec['buckets']}")
        if not launches_a:
            raise AssertionError("live: roi_cosine_cuda never launched")

        # (b) the reloads under traffic
        old = [client.predict(xi) for xi in xs]
        roi_cosine_cuda.launches = 0
        stats0 = client.stats()
        targets = [target if k % 2 == 0 else run for k in range(RELOADS)]
        records, windows, mem0, mem1 = _reloads_under_traffic(
            client, targets, xs)
        stats1 = client.stats()
        new = [client.predict(xi) for xi in xs]

        # (c) a reload whose input contract differs
        try:
            client.reload(str(image_run), poll_s=0.01)
            raise AssertionError("reload to the image run was accepted")
        except ServingError as e:
            contract_error = str(e)
        if "serving contract" not in contract_error:
            raise AssertionError(f"image run reload: {contract_error}")
        after_c = client.predict(xs[0])
        stats = client.stats()
        launches_b = roi_cosine_cuda.launches
    if not np.array_equal(after_c, new[0]) or stats["errors"] or \
            stats["reload"]["generation"] != RELOADS:
        raise AssertionError(f"after the refused reload: logits "
                             f"{_max_diff(after_c, new[0])}, stats {stats}")
    if not launches_b:
        raise AssertionError("reload: roi_cosine_cuda never launched")

    failed = [r for r in records if isinstance(r[3], Exception)]
    if failed:
        raise AssertionError(f"reload: {len(failed)} requests failed, "
                             f"first {failed[0][3]!r}")
    slowest = max(end - t0 for _, t0, end, _ in records)
    if slowest > SLOWEST_S:
        raise AssertionError(f"reload: a request took {slowest:.3f}s")
    served_by, worst_gap, exact = [0, 0], 0.0, 0
    for i, _, _, out in records:
        which, gaps = _which_set(out, (old[i], new[i]))
        if len(set(which)) != 1:
            raise AssertionError(f"reload: a response mixes weight sets "
                                 f"across its rows: {which}")
        served_by[which[0]] += 1
        worst_gap = max(worst_gap, float(gaps.max()))
        exact += bool(gaps.max() == 0.0)
    d_moved = max(_max_diff(a, b) for a, b in zip(old, new))
    requests = stats1["requests"] - stats0["requests"]
    batches = stats1["batches"] - stats0["batches"]
    buckets = {b: n - stats0["bucket_counts"].get(b, 0)
               for b, n in stats1["bucket_counts"].items()}
    if batches >= requests or not buckets.get(str(LIVE_BATCH)):
        raise AssertionError(f"reload: the batcher grouped nothing: "
                             f"{requests} requests in {batches} batches, "
                             f"buckets {buckets}")
    t_first = windows[0][0]
    p50_before, n_before = _p50(records, lambda t0, end: end <= t_first)
    # during: every request that overlaps a reload, then those over its
    # load (the agent's build on the reloader thread) and over its warm-up
    # (the buckets on the side stream) apart
    p50_during, n_during = _p50(records, lambda t0, end: any(
        t0 < swap and end > post for post, _, swap, _, _ in windows))
    p50_load, n_load = _p50(records, lambda t0, end: any(
        t0 < warm and end > post for post, warm, _, _, _ in windows))
    p50_warm, n_warm = _p50(records, lambda t0, end: any(
        t0 < swap and end > warm for _, warm, swap, _, _ in windows))
    load_s = [warm - post for post, warm, _, _, _ in windows]
    warm_s = [swap - warm for _, warm, swap, _, _ in windows]
    peak = max(w[3] for w in windows)
    peak_reserved = max(w[4] for w in windows)

    # (a)'s references: phase 13's bundle, the eval step, the plain head
    bundle = load_serving_bundle(str(run.parent / "flagship_bundle.zip"),
                                 dev)
    d_bundle = _max_diff(live, _chunked(bundle, x))
    agent, _ = load_trained_agent(str(run), dev)
    d_eval = _max_diff(live, _chunked(
        lambda b: _padded(lambda p: _eval_logits(agent, p), b), x))
    d_plain = _max_diff(live, _chunked(
        lambda b: _plain_served(agent.model, b), x))
    del agent
    new_agent, _ = load_trained_agent(str(target), dev)
    d_new_eval = max(_max_diff(n, _padded(
        lambda p: _eval_logits(new_agent, p), xi)) for n, xi in zip(new, xs))
    del new_agent
    if live.shape != (LIVE_CLIPS, 4) or not np.isfinite(live).all() or \
            d_bundle != 0.0 or max(d_eval, d_plain, d_new_eval) > 2e-2:
        raise AssertionError(f"live logits {live.shape}: vs bundle "
                             f"{d_bundle}, eval step {d_eval}, plain head "
                             f"{d_plain}; reloaded vs its eval step "
                             f"{d_new_eval}")
    log(f"[15 live] server.serve_live of phase 7's run (the flagship, "
        f"max_batch {LIVE_BATCH}, buckets {spec['buckets']}, each warmed): "
        f"started in {start_s:.2f}s; ServingClient.predict of {LIVE_CLIPS} "
        f"clips in {live_s:.3f}s (batches {LIVE_CHUNKS}); vs phase 13's "
        f"bundle {d_bundle:.3e}, vs eval step {d_eval:.3e}, vs plain head "
        f"{d_plain:.3e}; roi_cosine_cuda launches {launches_a}")
    log(f"[15 reload] {RELOADS} reloads, to a second run and back, under "
        f"{len(TRAFFIC_SIZES)} posting threads of {TRAFFIC_SIZES} clips a "
        f"request: load {', '.join(f'{v:.3f}' for v in load_s)} s, warm-up "
        f"of {len(spec['buckets'])} buckets "
        f"{', '.join(f'{v:.3f}' for v in warm_s)} s; device memory before "
        f"{_gib(mem0[0])} GiB allocated / {_gib(mem0[1])} reserved, peak "
        f"across the reloads {_gib(peak)} / {_gib(peak_reserved)} (each "
        f"reload's: {', '.join(_gib(w[3]) for w in windows)} / "
        f"{', '.join(_gib(w[4]) for w in windows)}), after "
        f"{_gib(mem1[0])} / {_gib(mem1[1])}; request p50 "
        f"{_ms(p50_before)} before ({n_before} requests), "
        f"{_ms(p50_during)} during ({n_during}: {_ms(p50_load)} over the "
        f"loads ({n_load}), {_ms(p50_warm)} over the warm-ups ({n_warm})); "
        f"{len(records)} requests in {batches} batches (buckets {buckets}), "
        f"the slowest {slowest:.3f}s, 0 failed, {served_by[0]} by phase "
        f"7's and {served_by[1]} by the second run's weights, {exact} "
        f"bit-equal to that set's lone request, the largest gap "
        f"{worst_gap:.3e}; the swap moved the logits by "
        f"up to {d_moved:.3e}, reloaded vs its eval step {d_new_eval:.3e}; "
        f"reload to the image run refused ({contract_error!r}); "
        f"roi_cosine_cuda launches {launches_b}")
    return launches_a, launches_b, live


def phase_live_ppnet(dev, run: Path):
    """15 (d): phase 9's ProtoPNet run (fp32) served live at
    ``LIVE_BATCH``, one request of 4 images; ``l2_min_cuda``'s launches
    set to 0 before and read after (> 0); the logits within 1e-3 of the
    rebuilt agent's eval step and within 1e-4 of the plain head on the
    same batch. Returns the launches."""
    from protoasnet_tpu_torch import server
    from protoasnet_tpu_torch.client import ServingClient
    from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda
    from protoasnet_tpu_torch.serve import load_trained_agent

    x = np.random.default_rng(16).normal(
        size=(4, *PPNET["sample"])).astype(np.float32)
    l2_min_cuda.launches = 0
    with _serving(server.serve_live, str(run), max_batch=LIVE_BATCH,
                  warmup=True, device=dev) as url:
        live = ServingClient(url, timeout_s=300, retries=0).predict(x)
    launches = l2_min_cuda.launches
    agent, _ = load_trained_agent(str(run), dev)
    d = _max_diff(live, _eval_logits(agent, x))
    # fp32: only the heads' summation order differs (as in phase 4)
    d_plain = _max_diff(live, _plain_served(agent.model, x))
    if not launches or live.shape != (4, 3) or d > 1e-3 or d_plain > 1e-4:
        raise AssertionError(f"ProtoPNet live: launches {launches}, logits "
                             f"{live.shape} vs eval step {d}, vs plain head "
                             f"{d_plain}")
    log(f"[15 live ProtoPNet] server.serve_live of phase 9's run (fp32, "
        f"max_batch {LIVE_BATCH}): 4 images vs eval step {d:.3e}, vs plain "
        f"head {d_plain:.3e}; l2_min_cuda launches {launches}")
    return launches


def phase_tune(dev, bundle: Path, forward_128: float):
    """15 (e): ``python -m protoasnet_tpu_torch.serve tune`` on phase 13's
    flagship bundle at ``TUNE_BATCHES`` (in process); every candidate has
    a rate or an error entry and the recommendation is one of them.
    ``roi_cosine_cuda``'s launches set to 0 before and read after. The
    rate at 128 is printed beside phase 5's forward rate at 128. Then one
    forward of the bundle at each candidate with a rate, with the kernel
    and with the plain head on the same seeded clips (bf16, 2e-2); those
    launches are not counted. Returns the launches."""
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.serve import (_device_forward,
                                            load_bundle_model)
    from protoasnet_tpu_torch.serve import main as serve_main

    out = io.StringIO()
    roi_cosine_cuda.launches = 0
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        serve_main(["tune", "--bundle", str(bundle), "--batches",
                    TUNE_BATCHES, "--points", "4", "20", "--device",
                    dev.type])
    seconds = time.monotonic() - t0
    launches = roi_cosine_cuda.launches
    lines = out.getvalue().strip().splitlines()
    for line in lines[:-1]:
        log(f"[15 tune] {line}")
    report = json.loads(lines[-1])
    results = report["results"]
    want = TUNE_BATCHES.split(",")
    if sorted(results, key=int) != want or not all(
            "samples_per_sec" in r or "error" in r for r in results.values()):
        raise AssertionError(f"tune: {report}")
    if str(report["recommended_max_batch"]) not in want or not launches:
        raise AssertionError(f"tune: {report}, launches {launches}")
    # the tuned forwards against the plain head at each candidate batch
    model, _, _, uint8_gray = load_bundle_model(str(bundle), dev)
    forward = _device_forward(model, uint8_gray)
    # a serving forward copies the model's attributes when it is built
    model.head_impl = "torch"
    plain = _device_forward(model, uint8_gray)
    model.head_impl = None
    g = torch.Generator(device=dev).manual_seed(17)
    vs_plain = {}
    with torch.inference_mode():
        for b in (b for b in want if "samples_per_sec" in results[b]):
            xb = torch.randn((int(b), *CLIP), generator=g, device=dev)
            kernel = forward(xb).float()
            vs_plain[b] = (kernel - plain(xb).float()).abs().max().item()
            del xb, kernel
    del model, forward, plain
    if not vs_plain or max(vs_plain.values()) > 2e-2:
        raise AssertionError(f"tune: kernel vs plain head {vs_plain}")
    at_128 = results["128"].get("samples_per_sec")
    log(f"[15 tune] serve tune --batches {TUNE_BATCHES} --points 4 20 in "
        f"{seconds:.1f}s: {json.dumps(report)}; at 128 {at_128} clips/s "
        f"beside phase 5's forward {forward_128:.1f} clips/s; "
        f"roi_cosine_cuda launches {launches}; the bundle's forward vs "
        f"the plain head at each batch {vs_plain}")
    return launches


# phases 16-18: the training loop's instrumentation, remat, the reference's
# .pth both ways
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def _run_agent(run: Path, work: Path, name: str, checkpoint=None,
               top=None, **train_keys):
    """An agent of a training run's config writing to ``work/name``, with
    the run's ``last.ckpt`` (or ``checkpoint``) as
    ``model.checkpoint_path``, the top-level keys of ``top`` and
    ``train_keys`` in its ``train`` section."""
    from protoasnet_tpu_torch.train.agents import build_agent
    from protoasnet_tpu_torch.utils.config import load_config

    cfg = load_config(str(run / "config_train.yml"))
    cfg.update(top or {})
    cfg["save_dir"] = str(work / name)
    cfg["model"]["checkpoint_path"] = str(checkpoint or run / "last.ckpt")
    cfg["train"].update(auto_resume=False, **train_keys)
    return build_agent(cfg)


def _epoch_row(agent, mode: str):
    rows = [json.loads(line) for line in
            (Path(agent.save_dir) / "metrics.jsonl").read_text().splitlines()]
    return [r for r in rows if f"epoch/{mode}/loss_all" in r][-1]


def _trace_kernels(log_dir: Path, name: str) -> int:
    """Kernel events named like ``name`` in the trace files of
    ``log_dir``, read back from the JSON."""
    files = sorted(log_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"profile_dir holds {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel"
               and name in e.get("name", ""))


def _step_flops(cfg, device, batch):
    """FLOPs of one flagship train micro-step (fp32 weights, the config's
    loss terms) at ``batch`` on ``device``, and of the forward of one
    clip."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps
    from protoasnet_tpu_torch.utils.flops import count_flops

    model = build_model(dict(cfg["model"], dtype="float32"), device=device,
                        seed=0)
    opt = GroupAdam(model, {gr: 1e-3 for gr in GROUPS})
    step = make_xprotonet_steps(
        model, LossBundle(cfg["train"]["criterion"], num_classes=4,
                          abstain_class=True),
        opt, GradAccumulator(opt.params, 2))[0]
    x = torch.from_numpy(np.random.default_rng(16).normal(
        size=(batch, *CLIP)).astype(np.float32)).to(device)
    target = torch.arange(batch, device=device) % 3
    train = count_flops(lambda: step(
        x, target, torch.ones(batch, dtype=torch.bool, device=device),
        {gr: 1e-4 for gr in GROUPS}, affine=(11.0, 1.25)))
    with torch.no_grad():
        fwd = count_flops(lambda: model.eval()(x[:1]))
    return train, fwd


def phase_instrumentation(dev, cfg, train, work: Path, serve_rate: float,
                          train_rate: float) -> int:
    """16: phase 7's bf16 training epoch (its run's config and weights) on
    the host metric path and on the device path: the epoch metrics agree
    to 1e-5; per micro-step the host's stream / device synchronisations
    and the device -> host copies of each path (profiler), and its ms
    (the StepTimer of an unprofiled second epoch); a third run with
    ``profile_dir`` writes a trace holding ``roi_cosine_kernel`` events;
    the MFU of the served flagship at 128 (phase 5's rate) and of the
    train micro-step at batch 5 (phase 7's rate), from the port's FLOP
    counts, which are the same on the card as on the CPU.
    ``roi_cosine_cuda``'s launches are set to 0 before and read after."""
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.utils.flops import mfu
    from protoasnet_tpu_torch.utils.profiling import device_window

    roi_cosine_cuda.launches = 0
    res, rows = {}, {}
    for on_device in (False, True):
        agent = _run_agent(train["run"], work, f"epoch_device_{on_device}",
                           on_device_metrics=on_device)
        steps = len(agent.data_loaders["train"])
        window = device_window(
            lambda: res.__setitem__(on_device, agent.run_epoch(0, "train")),
            warmup=0)
        rows[on_device] = _epoch_row(agent, "train")
        syncs = window.host_counts(SYNCS)
        dtoh = window.device_counts("Memcpy DtoH")
        agent.run_epoch(1, "train")  # unprofiled: the StepTimer's ms
        t = agent.epoch_timer
        ms = {k: 1e3 * v / steps for k, v in t.totals.items()}
        log(f"[16 metrics] {'device' if on_device else 'host'} path, "
            f"train epoch of {steps} micro-steps: per micro-step "
            f"{syncs['cudaStreamSynchronize'] / steps:g} "
            f"cudaStreamSynchronize, "
            f"{syncs['cudaDeviceSynchronize'] / steps:g} "
            f"cudaDeviceSynchronize, {dtoh / steps:g} device->host copies "
            f"(profiled epoch); {sum(ms.values()):.2f} ms a micro-step "
            f"(data {ms['data']:.2f}, step {ms['step']:.2f}, host_metrics "
            f"{ms['host_metrics']:.2f}; second epoch, StepTimer)")
        agent.finalize()
    keys = sorted(k for k in rows[False] if k.startswith("epoch/train/"))
    diffs = [abs(a - b) for a, b in zip(res[False], res[True])] + [
        abs(rows[False][k] - rows[True][k]) / max(1.0, abs(rows[False][k]))
        for k in keys]
    log(f"[16 metrics] (accuracy, f1, AUC) host {res[False]} device "
        f"{res[True]}; {len(keys)} epoch values, largest difference "
        f"{max(diffs):.3e} (limit 1e-5)")
    if max(diffs) > 1e-5 or set(keys) != {k for k in rows[True]
                                          if k.startswith("epoch/train/")}:
        raise AssertionError("the device metric path disagrees with the "
                             "host path")

    prof = work / "profile"
    agent = _run_agent(train["run"], work, "epoch_profiled",
                       top={"profile_dir": str(prof), "profile_epoch": 0})
    agent.run_epoch(0, "train")
    agent.finalize()
    n_roi = _trace_kernels(prof, "roi_cosine_kernel")
    if not n_roi:
        raise AssertionError("the profiled epoch's trace holds no "
                             "roi_cosine_kernel event")

    step_card, fwd_card = _step_flops(cfg, dev, 2)
    step_cpu, fwd_cpu = _step_flops(cfg, torch.device("cpu"), 2)
    step5, _ = _step_flops(cfg, dev, 5)
    if (step_card, fwd_card) != (step_cpu, fwd_cpu):
        raise AssertionError(f"FLOPs on the card {step_card, fwd_card} != "
                             f"on the CPU {step_cpu, fwd_cpu}")
    launches = roi_cosine_cuda.launches
    if not launches:
        raise AssertionError("phase 16: roi_cosine_cuda never launched")
    log(f"[16 trace] profile_dir at profile_epoch 0: "
        f"{sorted(p.name for p in prof.iterdir())}, {n_roi} "
        f"roi_cosine_kernel events read back from the file")
    log(f"[16 flops] flagship forward {fwd_card:.0f} FLOP a clip, train "
        f"micro-step at batch 2 {step_card:.0f} (card == CPU), at batch 5 "
        f"{step5:.0f} ({step5 / 5:.0f} a clip); MFU against the bf16 peak "
        f"989.4 TFLOP/s: served at 128 {mfu(fwd_card, serve_rate):.4f} "
        f"({serve_rate:.1f} clips/s), train micro-step "
        f"{mfu(step5 / 5, train_rate):.4f} ({train_rate:.1f} clips/s); "
        f"roi_cosine_cuda launches {launches}")
    return launches


def phase_remat(dev, cfg) -> int:
    """17: the bf16 flagship's train micro-step at batch 5 (an Adam step
    every 2, as phase 7's) with ``model.remat`` false and true: ms and
    peak allocated memory; in fp32 (TF32 off, batch 2) the gradients and
    the BatchNorm statistics after one micro-step with remat equal those
    without, to 1e-5 of each tensor's max. ``roi_cosine_cuda``'s launches are set to 0 before and read
    after."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps

    def make(remat, dtype, batch):
        model = build_model(dict(cfg["model"], remat=remat, dtype=dtype),
                            device=dev, seed=0)
        opt = GroupAdam(model, {gr: 1e-3 for gr in GROUPS})
        step = make_xprotonet_steps(
            model, LossBundle(cfg["train"]["criterion"], num_classes=4,
                              abstain_class=True),
            opt, GradAccumulator(opt.params, 2))[0]
        x = torch.from_numpy(np.random.default_rng(17).normal(
            size=(batch, *CLIP)).astype(np.float32)).to(dev)
        target = torch.arange(batch, device=dev) % 3
        valid = torch.ones(batch, dtype=torch.bool, device=dev)
        return model, lambda: step(x, target, valid,
                                   {gr: 1e-4 for gr in GROUPS},
                                   affine=(11.0, 1.25))

    roi_cosine_cuda.launches = 0
    report = {}
    for remat in (False, True):
        model, run = make(remat, "bfloat16", 5)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(10):
            run()
        torch.cuda.synchronize()
        report[remat] = ((time.perf_counter() - t0) / 10 * 1e3,
                         torch.cuda.max_memory_allocated() / 2 ** 30)
        del model, run
    worst = {}
    with no_tf32():
        states = []
        for remat in (False, True):
            model, run = make(remat, "float32", 2)
            run()  # one micro-step of two: its gradient stays in .grad
            states.append({
                **{f"grad:{k}": p.grad.detach().clone()
                   for k, p in model.named_parameters()},
                **{k: v.detach().clone()
                   for k, v in model.state_dict().items()}})
            del model, run
    for k, ref in states[0].items():
        got = states[1][k]
        if not ref.is_floating_point():
            worst[k] = float(not torch.equal(got, ref))
            continue
        worst[k] = ((got - ref).abs().max()
                    / ref.abs().max().clamp_min(1e-30)).item()
    name = max(worst, key=worst.get)
    launches = roi_cosine_cuda.launches
    log(f"[17 remat] bf16 flagship train micro-step at batch 5: remat "
        f"false {report[False][0]:.2f} ms, peak {report[False][1]:.3f} "
        f"GiB; remat true {report[True][0]:.2f} ms, peak "
        f"{report[True][1]:.3f} GiB; fp32 (TF32 off, batch 2) remat vs "
        f"not over {len(worst)} gradients, weights and BN buffers after a "
        f"micro-step: largest "
        f"{worst[name]:.3e} of the tensor's max ({name}; limit 1e-5); "
        f"roi_cosine_cuda launches {launches}")
    if worst[name] > 1e-5 or not launches:
        raise AssertionError("remat: the step differs from the plain step")
    if report[True][1] >= report[False][1]:
        raise AssertionError("remat did not lower the peak memory")
    return launches


def phase_reference_pth(dev, train, ppnet_run: Path, work: Path):
    """18: phase 7's flagship run and phase 9's ProtoPNet run through the
    reference's ``.pth`` and back: ``python -m
    protoasnet_tpu_torch.models.migrate <last.ckpt> <.pth> --to_reference``,
    then ``<.pth> <.pkl>`` (the CLI's ``main`` in process), the ``.pkl``
    loaded by the port's agent through ``model.checkpoint_path`` and
    served on the card at 128 (``make_serving_fn``): its logits bit-equal
    to the run's own (``load_trained_agent``). Each kernel's launches are
    set to 0 before its model and read after; returns
    {kernel: launches}."""
    from protoasnet_tpu_torch.models.migrate import main as migrate_main
    from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.serve import (load_trained_agent,
                                            make_serving_fn)

    out = {}
    for label, run, kernel, sample in (
            ("flagship", train["run"], roi_cosine_cuda, CLIP),
            ("ProtoPNet", ppnet_run, l2_min_cuda, PPNET["sample"])):
        cfg_path = f"--config_path={run / 'config_train.yml'}"
        pth, pkl = work / f"{label}_ref.pth", work / f"{label}_back.pkl"
        t0 = time.monotonic()
        migrate_main([str(run / "last.ckpt"), str(pth), cfg_path,
                      "--to_reference"])
        migrate_main([str(pth), str(pkl), cfg_path])
        seconds = time.monotonic() - t0
        kernel.launches = 0
        own, _ = load_trained_agent(str(run), dev)
        back = _run_agent(run, work, f"{label}_from_pth", checkpoint=pkl)
        x = np.random.default_rng(18).normal(
            size=(128, *sample)).astype(np.float32)
        want = make_serving_fn(own.model.eval())(x)
        got = make_serving_fn(back.model.eval())(x)
        out[kernel.__name__] = kernel.launches
        same = np.array_equal(got, want)
        log(f"[18 reference pth] {label}: last.ckpt -> {pth.name} "
            f"({pth.stat().st_size / 1e6:.1f} MB) -> {pkl.name} in "
            f"{seconds:.2f}s; served at 128 from the .pkl vs the run's own: "
            f"{'bit-equal' if same else _max_diff(got, want)}; "
            f"{kernel.__name__} launches {kernel.launches}")
        if not same or kernel.launches < 2:
            raise AssertionError(f"{label}: the .pth round trip changed the "
                                 f"served logits")
        own.finalize()
        back.finalize()
    return out


# phases 19-20: w8a8 int8 serving of the flagship, the last trunks
INT8_BATCH = 128  # the daemon's default bucket
INT8_CPU_CLIPS = 2  # the served clips held against the bundle on the CPU
NEW_TRUNKS = (  # (trunk, config to take the model from, head kernel)
    ("r3d_18", VIDEO, "roi_cosine_cuda"),
    ("vgg16_bn", PPNET, "l2_min_cuda"),
    ("densenet121", PPNET, "l2_min_cuda"),
)
NEW_TRUNK_BATCH = 8


def _int8_geometries(model, x):
    """{(input shape, weight shape, stride, padding): (module name, the
    module, the input's strides)} of every ``QuantConv`` call of
    ``model``'s forward on ``x``."""
    from protoasnet_tpu_torch.quant import QuantConv

    seen, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, QuantConv):
            def hook(mod, args, name=name):
                key = (tuple(args[0].shape), tuple(mod.w_q.shape),
                       mod.stride, mod.padding)
                seen.setdefault(key, (name, mod, args[0].stride()))
            hooks.append(m.register_forward_pre_hook(hook))
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return seen


def _int8_conv_checks(dev, geometries):
    """19 (a) and (e): each int8 conv geometry at its served shape, on
    seeded int8 codes: the card version's int32 sums bit-equal to the
    plain version's (float64 on the card, 16 samples at a time); the
    QuantConv's ms (quantise, GEMMs, dequantise to bf16, on its
    channels-last input) beside bf16 cuDNN's conv at the same shape
    (NCDHW, as the bf16 model runs), and where the int8 ms go: the
    quantisation alone, the GEMMs alone (one chunk's ``_int_mm`` on random
    columns, times the chunks), the columns and the int32 copy-out (the
    int32 conv's ms less the GEMMs), and the dequantisation less the int32
    copy-out it replaces (the conv with the dequantising epilogue less the
    int32 conv; negative where writing bf16 costs less than writing
    int32). Returns {name: (int8 ms, cuDNN ms, quantise, columns, GEMMs,
    dequantise)}."""
    from torch.nn import functional as F

    from protoasnet_tpu_torch.ops.int8_conv import (int8_conv_cuda,
                                                    int8_conv_torch, int_mm,
                                                    plan, quantize)

    g = torch.Generator(device=dev).manual_seed(19)
    out = {}
    for (shape, wshape, stride, pad), (name, mod, strides) in \
            geometries.items():
        xq = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        card = int8_conv_cuda(xq, mod.w_q, stride, pad)
        bad = 0
        for b0 in range(0, shape[0], 16):
            plain = int8_conv_torch(xq[b0:b0 + 16], mod.w_q, stride, pad)
            bad += int((plain != card[b0:b0 + 16]).sum())
        del card, plain
        if bad:
            raise AssertionError(f"int8 conv {name} {shape}: {bad} int32 "
                                 f"sums differ from the plain version")
        x = torch.empty_strided(shape, strides, device=dev,
                                dtype=torch.bfloat16).normal_(generator=g)
        xb = x.contiguous()
        w = torch.randn(wshape, generator=g, device=dev,
                        dtype=torch.bfloat16)
        conv = F.conv3d if len(shape) == 5 else F.conv2d
        pl = plan(shape, wshape, stride, pad)
        cols = torch.randint(-127, 128, (pl.step * pl.rows, pl.kk),
                             generator=g, device=dev, dtype=torch.int8)
        w2 = torch.randint(-127, 128, (pl.op, pl.kk), generator=g,
                           device=dev, dtype=torch.int8)
        chunks = -(-shape[0] // pl.step)
        with torch.inference_mode():
            ms8 = time_ms(lambda: mod(x), iters=3, warmup=1)
            ms16 = time_ms(lambda: conv(xb, w, stride=stride, padding=pad),
                           iters=3, warmup=1)
            q_ms = time_ms(lambda: quantize(x, mod.inv_scale), iters=3,
                           warmup=1)
            sums_ms = time_ms(lambda: int8_conv_cuda(
                xq, mod.w_q, stride, pad), iters=3, warmup=1)
            deq_ms = time_ms(lambda: int8_conv_cuda(
                xq, mod.w_q, stride, pad,
                lambda y: mod._dequantise(y, torch.bfloat16)), iters=3,
                warmup=1)
            gemm_ms = chunks * time_ms(lambda: int_mm(cols, w2.t()),
                                       iters=3, warmup=1)
        parts = (q_ms, sums_ms - gemm_ms, gemm_ms, deq_ms - sums_ms)
        out[name] = (ms8, ms16, *parts)
        ops = 2 * shape[0] * pl.rows * pl.kk * pl.op
        log(f"[19 int8 conv] {name}: x {shape} w {wshape} stride {stride} "
            f"pad {pad}: int32 sums bit-equal to the plain version; "
            f"{ms8:.3f} ms (int8) vs {ms16:.3f} ms (bf16 cuDNN); int8: "
            f"quantise {parts[0]:.3f}, columns + int32 copy-out "
            f"{parts[1]:.3f}, GEMMs {parts[2]:.3f} ({chunks} x M="
            f"{pl.step * pl.rows} K={pl.kk} N={pl.op}, "
            f"{ops / parts[2] / 1e9:.1f} TOP/s), dequantise less the int32 "
            f"copy-out {parts[3]:.3f}")
        del x, xb, w, xq, cols, w2
        torch.cuda.empty_cache()
    return out


def _fidelity(fp: np.ndarray, q: np.ndarray):
    """tests/test_quant.py's measures: max relative error, cosine, argmax
    agreement."""
    fp, q = fp.astype(np.float64), q.astype(np.float64)
    rel = np.abs(fp - q).max() / (np.abs(fp).max() + 1e-9)
    cos = (fp * q).sum() / (np.linalg.norm(fp) * np.linalg.norm(q) + 1e-12)
    return rel, cos, (fp.argmax(1) == q.argmax(1)).mean()


def _rate_and_peak(model, x):
    """(samples/s, peak allocated GiB) of ``model``'s forward on the
    device-resident batch ``x``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = time_ms(lambda: model(x), iters=3, warmup=1)
    return len(x) / ms * 1e3, torch.cuda.max_memory_allocated() / 2**30


def phase_int8(dev, train, work: Path, bf16_rate: float):
    """19: phase 7's trained flagship run exported with ``python -m
    protoasnet_tpu_torch.serve export --int8 --calib_batches 4`` (in
    process) and served at full width. (a) every int8 conv geometry of the
    flagship at its batch-128 shape: the card version's int32 sums
    bit-equal to the plain version's on seeded codes; (b) the bundle
    served over HTTP (``serve_forever``, max_batch 128) on 128 clips: the
    first ``INT8_CPU_CLIPS`` within 2e-2 * max(1, |logits|) of the same
    bundle on the CPU; (c) against phase 13's bf16 bundle on the same 128
    clips, the fidelity limits of tests/test_quant.py (max relative error
    < 0.08, cosine > 0.995, argmax agreement >= 0.75); (d)
    ``roi_cosine_cuda``'s launches (and the int8 GEMMs) set to 0 before the
    served path and read after (> 0); (e) clips/s and peak allocated
    memory of the int8 and bf16 bundles' forwards at 128 (int8's at most
    bf16's), beside phase 5's bf16 rate, and each int8 conv's ms beside
    bf16 cuDNN's, with where the int8 ms go; (f)
    ``serve_live --int8`` of the run answers one ``ServingClient`` request
    bit-equal to the int8 bundle on the same padded batch. Returns the
    served paths' ``roi_cosine_cuda`` launches."""
    from protoasnet_tpu_torch import server
    from protoasnet_tpu_torch.client import ServingClient
    from protoasnet_tpu_torch.ops import int8_conv
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.serve import (load_bundle_model,
                                            load_serving_bundle)
    from protoasnet_tpu_torch.serve import main as serve_main

    start = time.monotonic()
    run = train["run"]
    bundle = work / "flagship_int8.zip"
    t0 = time.monotonic()
    serve_main(["export", "--run_dir", str(run), "--out", str(bundle),
                "--int8", "--calib_batches", "4", "--device", dev.type])
    export_s = time.monotonic() - t0
    x = np.random.default_rng(19).normal(
        size=(INT8_BATCH, *CLIP)).astype(np.float32)
    # (b), (d): the served path, its launches counted
    roi_cosine_cuda.launches, int8_conv.LAUNCHES = 0, 0
    with _serving(server.serve_forever, str(bundle), max_batch=INT8_BATCH,
                  max_delay_ms=2.0, warmup=False, device=dev) as url:
        served = ServingClient(url, timeout_s=600, retries=0).predict(x)
    launches, gemms = roi_cosine_cuda.launches, int8_conv.LAUNCHES
    if served.shape != (INT8_BATCH, 4) or not np.isfinite(served).all():
        raise AssertionError(f"int8 served logits {served.shape}")
    if not (launches and gemms):
        raise AssertionError(f"int8 served path: roi_cosine_cuda launches "
                             f"{launches}, int8 GEMMs {gemms}")
    cpu = load_serving_bundle(str(bundle), device="cpu")(
        x[:INT8_CPU_CLIPS])
    d_cpu = _max_diff(served[:INT8_CPU_CLIPS], cpu)
    if d_cpu > 2e-2 * max(1.0, float(np.abs(cpu).max())):
        raise AssertionError(f"int8 served vs CPU: {d_cpu}")
    # (c): against phase 13's bf16 bundle on the same clips
    bf16 = load_serving_bundle(str(run.parent / "flagship_bundle.zip"),
                               device=dev)(x)
    rel, cos, agree = _fidelity(bf16, served)
    log(f"[19 int8] serve export --int8 --calib_batches 4 of phase 7's run "
        f"in {export_s:.2f}s ({bundle.stat().st_size / 1e6:.1f} MB); "
        f"{INT8_BATCH} clips served over HTTP (max_batch {INT8_BATCH}): "
        f"roi_cosine_cuda launches {launches}, int8 GEMMs {gemms}; first "
        f"{INT8_CPU_CLIPS} vs the bundle on the CPU max abs diff "
        f"{d_cpu:.3e}; vs phase 13's bf16 bundle: max rel err {rel:.4f}, "
        f"cosine {cos:.6f}, argmax agreement {agree:.3f}")
    if not (rel < 0.08 and cos > 0.995 and agree >= 0.75):
        raise AssertionError(f"int8 fidelity: rel {rel}, cos {cos}, "
                             f"agreement {agree}")
    # (a), (e): the int8 convs at their served shapes, rates and memory
    xd = torch.from_numpy(x).to(dev)
    model8 = load_bundle_model(str(bundle), dev)[0]
    geometries = _int8_geometries(model8, xd)
    convs = _int8_conv_checks(dev, geometries)
    rate8, peak8 = _rate_and_peak(model8, xd)
    del model8
    model16 = load_bundle_model(str(run.parent / "flagship_bundle.zip"),
                                dev)[0]
    rate16, peak16 = _rate_and_peak(model16, xd)
    del model16, xd
    torch.cuda.empty_cache()
    if peak8 > peak16:  # the chunks keep int8's transients small
        raise AssertionError(f"int8 forward peak {peak8:.3f} GiB over "
                             f"bf16's {peak16:.3f}")
    sums = [sum(v[i] for v in convs.values()) for i in range(6)]
    log(f"[19 int8] forward at {INT8_BATCH}: int8 {rate8:.1f} clips/s, "
        f"peak {peak8:.3f} GiB; bf16 {rate16:.1f} clips/s, peak "
        f"{peak16:.3f} GiB (phase 5's bf16 forward {bf16_rate:.1f} "
        f"clips/s); {len(geometries)} int8 conv geometries, summed: int8 "
        f"{sums[0]:.3f} ms vs bf16 cuDNN {sums[1]:.3f} ms; int8 quantise "
        f"{sums[2]:.3f}, columns + copy-out {sums[3]:.3f}, GEMMs "
        f"{sums[4]:.3f}, dequantise less the copy-out {sums[5]:.3f}")
    # (f): the run served live as int8, bit-equal to the bundle
    direct = load_serving_bundle(str(bundle), device=dev)
    roi_cosine_cuda.launches = 0
    with _serving(server.serve_live, str(run), max_batch=INT8_BATCH,
                  warmup=False, int8=True, calib_batches=4,
                  device=dev) as url:
        live = ServingClient(url, timeout_s=600, retries=0).predict(x[:3])
    live_launches = roi_cosine_cuda.launches
    same = np.array_equal(live, _padded(direct, x[:3]))
    log(f"[19 int8 live] serve_live --int8 --calib_batches 4 of phase 7's "
        f"run: 3 clips {'bit-equal' if same else 'DIFFER'} to the int8 "
        f"bundle on the same padded batch; roi_cosine_cuda launches "
        f"{live_launches}; phase 19 in {time.monotonic() - start:.1f}s")
    if not same or not live_launches:
        raise AssertionError(f"int8 live: bit-equal {same}, launches "
                             f"{live_launches}")
    return launches + live_launches


def _trunk_config(trunk, spec):
    mcfg = dict(load_model_config(spec)["model"], base_architecture=trunk,
                dtype="float32")
    keep = "cnn_backbone" if mcfg["name"] != "ProtoPNet" else "features"
    return mcfg, keep


def phase_new_trunks(dev):
    """20: the last trunks at full width with seeded weights: ``r3d_18``
    in the flagship's Video_XProtoNet (32x112x112) and ``vgg16_bn`` and
    ``densenet121`` in ProtoPNet's PPNet (224x224), fp32. For each, the
    card's forward at batch ``NEW_TRUNK_BATCH`` (TF32 off) within
    1e-3 * max(1, |logits|) of the port on the CPU, with its head kernel's
    launches set to 0 before and read after (> 0); then the model
    quantised (calibrated on the card on a seeded batch of 4, its trunk's
    convs) and its int8 forward on the card within 2e-2 * max(1,
    |logits|) of the same qstate on the CPU, launches counted the same way.
    Returns {kernel: launches}."""
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.ops import int8_conv
    from protoasnet_tpu_torch.quant import (build_qstate,
                                            calibrate_act_scales,
                                            quantized_model)

    counters = _counters()
    out = {name: 0 for name in counters}
    rng = np.random.default_rng(20)
    for trunk, spec, kernel in NEW_TRUNKS:
        t0 = time.monotonic()
        mcfg, keep = _trunk_config(trunk, spec)
        card = build_model(mcfg, device=dev, seed=0)
        cpu = build_model(mcfg, device="cpu", seed=0)
        x = torch.from_numpy(rng.normal(
            size=(NEW_TRUNK_BATCH, *spec["sample"])).astype(np.float32))
        calib = torch.from_numpy(rng.normal(
            size=(4, *spec["sample"])).astype(np.float32))
        counter = counters[kernel]
        with no_tf32(), torch.inference_mode():
            counter.launches = 0
            lk = card(x.to(dev))[0].float().cpu()
            fp_launches = counter.launches
            lc = cpu(x)[0]
        d_fp = _max_diff(lk, lc)
        scale = lc.abs().max().item()
        qstate = build_qstate(card, calibrate_act_scales(
            card, [calib.to(dev)], path_filter=lambda p: p[:1] == (keep,)))
        q_card, q_cpu = quantized_model(card, qstate), \
            quantized_model(cpu, qstate)
        with no_tf32(), torch.inference_mode():
            counter.launches, int8_conv.LAUNCHES = 0, 0
            qk = q_card(x.to(dev))[0].float().cpu()
            q_launches, gemms = counter.launches, int8_conv.LAUNCHES
            qc = q_cpu(x)[0]
        d_q = _max_diff(qk, qc)
        q_scale = qc.abs().max().item()
        out[kernel] += fp_launches + q_launches
        log(f"[20 trunks] {mcfg['name']} on {trunk} (fp32, batch "
            f"{NEW_TRUNK_BATCH}, {'x'.join(map(str, spec['sample']))}): "
            f"card vs CPU max abs diff {d_fp:.3e} (|logits| up to "
            f"{scale:.3f}); int8 ({len(qstate)} convs of {keep}) card vs "
            f"CPU {d_q:.3e} (|logits| up to {q_scale:.3f}), int8 GEMMs "
            f"{gemms}; {kernel} launches {fp_launches} + {q_launches}; "
            f"{time.monotonic() - t0:.1f}s")
        if not (fp_launches and q_launches and gemms and qstate):
            raise AssertionError(f"{trunk}: launches {fp_launches}, "
                                 f"{q_launches}, GEMMs {gemms}")
        if not (torch.isfinite(lk).all() and torch.isfinite(qk).all()):
            raise AssertionError(f"{trunk}: non-finite logits")
        if d_fp > 1e-3 * max(1.0, scale) or d_q > 2e-2 * max(1.0, q_scale):
            raise AssertionError(f"{trunk}: card vs CPU fp32 {d_fp}, int8 "
                                 f"{d_q}")
        del card, cpu, q_card, q_cpu
        torch.cuda.empty_cache()
    return out


# phase 21: distribution (parallel/), data-parallel through torchrun
# (a): phase 7's command line with the per-batch losses logged
DP_TRAIN_ARGS = ("--train.on_device_metrics=false",
                 "--render_prototypes=false")
DP_BATCH = 6  # (b)-(c): the global batch, 3 rows a rank at world 2
DP_AFFINE = (12.5, 1.25)  # (b)-(c): the TransformLoss draw, fixed
REPORTS = "CHIP_SMOKE_REPORTS"  # where a torchrun worker writes its report


def _torchrun(nproc: int, *args: str, timeout: float = 300):
    """``python -m torch.distributed.run --standalone --nproc_per_node=
    nproc chip_smoke.py <args>`` in its own session (killed whole on a
    timeout); returns the workers' reports (a JSON file each: the ranks'
    output shares one pipe), rank order."""
    import os
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(REPO / "chip_smoke.py"), *args]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_reports_") as tmp:
        proc = subprocess.Popen(cmd, cwd=str(REPO), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True,
                                env=dict(os.environ, **{REPORTS: tmp}))
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise AssertionError(f"torchrun {args[0]}: timed out")
        if proc.returncode:  # the first errors (a rank's own cause), the end
            first = [line for line in out.splitlines()
                     if re.search(r"Error|error:|out of memory", line)][:12]
            raise AssertionError(
                f"torchrun {args[0]} exited {proc.returncode}:\n"
                + "\n".join(first) + f"\n...\n{out[-6000:]}")
        reports = [json.loads(f.read_text())
                   for f in Path(tmp).glob("rank*.json")]
    if len(reports) != nproc:
        raise AssertionError(f"torchrun {args[0]}: {len(reports)} reports:"
                             f"\n{out[-6000:]}")
    return sorted(reports, key=lambda r: r["rank"])


def _report(**kw) -> None:
    """This worker's report, a JSON file in the directory ``_torchrun``
    names."""
    import os

    import torch.distributed as dist

    report = dict(kw, rank=dist.get_rank(), world=dist.get_world_size(),
                  backend=dist.get_backend())
    (Path(os.environ[REPORTS]) / f"rank{report['rank']}.json").write_text(
        json.dumps(report))


def _batch_losses(run: Path):
    rows = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    return [r["batch_train/loss_all"] for r in rows
            if "batch_train/loss_all" in r]


def _flagship_step(dev, cfg, dtype, every, fsdp=False, mesh=None):
    """(model, train step, accumulator) of the flagship at full width on ``dev`` (seed
    0, ``dtype``), replicated from rank 0, FSDP2-sharded if asked, its
    prototypes split over ``mesh``'s model axis if given."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.parallel.mesh import (fsdp_param_shardings,
                                                    make_mesh,
                                                    prototype_param_shardings,
                                                    replicate)
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps

    mcfg = dict(cfg["model"], dtype=dtype)
    model = replicate(build_model(mcfg, device=dev, seed=0))
    if fsdp:
        fsdp_param_shardings(model, make_mesh())
    if mesh is not None:
        prototype_param_shardings(model, mesh)
    opt = GroupAdam(model, {gr: 1e-3 for gr in GROUPS})
    acc = GradAccumulator(opt.params, every)
    step, _, _ = make_xprotonet_steps(
        model, LossBundle(cfg["train"]["criterion"], num_classes=4,
                          abstain_class=True), opt, acc)
    return model, step, acc


def _dp_batch(dev):
    """This rank's rows of the seeded global batch of ``DP_BATCH``."""
    from protoasnet_tpu_torch.parallel.mesh import shard_batch

    rng = np.random.default_rng(21)
    part = shard_batch({
        "cine": rng.normal(size=(DP_BATCH, *CLIP)).astype(np.float32),
        "target_dev": np.array([0, 1, 2, 0, 1, 2]),
        "valid_dev": np.ones(DP_BATCH, bool)}, dev)
    return part["cine"], part["target_dev"], part["valid_dev"]


def _fp32_step(dev, cfg, fsdp=False):
    """One fp32 step (TF32 off) of the flagship on the global batch of
    ``DP_BATCH``: {loss (the reported, global one), sha (sha256 of the
    parameters after it), peak (allocated GiB during the step beyond what
    was allocated before it), rest (that allocation), logits (the rank's
    rows), step_s (host clock, synchronised)}."""
    import hashlib

    from protoasnet_tpu_torch.train.optim import GROUPS

    with no_tf32():
        model, step, _ = _flagship_step(dev, cfg, "float32", 1, fsdp)
        x, y, v = _dp_batch(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        m = step(x, y, v, {gr: 1e-4 for gr in GROUPS}, affine=DP_AFFINE)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
        sha = hashlib.sha256()
        for p in model.parameters():
            p = p.full_tensor() if hasattr(p, "full_tensor") else p
            sha.update(p.detach().cpu().numpy().tobytes())
    return {"loss": float(m["loss_all"]), "sha": sha.hexdigest(),
            "peak": peak, "rest": before / 2 ** 30, "step_s": step_s,
            "logits": m["logits"].float().cpu().tolist()}


def worker_dp_main(*argv: str) -> None:
    """(a), under torchrun: the training entry point's ``main`` with
    ``argv`` in a group of NCCL's; reports the ROI kernel's counts."""
    from protoasnet_tpu_torch.main import main as train_main
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.parallel.mesh import (
        maybe_initialize_distributed, shutdown_distributed)

    maybe_initialize_distributed()
    roi_cosine_cuda.launches = roi_cosine_cuda.backward_calls = 0
    t0 = time.monotonic()
    agent = train_main(list(argv))
    torch.cuda.synchronize()
    _report(run=str(agent.save_dir), seconds=time.monotonic() - t0,
            launches=roi_cosine_cuda.launches,
            backward_calls=roi_cosine_cuda.backward_calls)
    shutdown_distributed()


def worker_dp_gloo() -> None:
    """(b), under torchrun with two ranks: gloo on CUDA tensors, both ranks
    on cuda:0; one fp32 step at the global batch of ``DP_BATCH``."""
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.parallel.mesh import (
        maybe_initialize_distributed, shutdown_distributed)

    dev = torch.device("cuda", 0)
    maybe_initialize_distributed(dev, backend="gloo")
    roi_cosine_cuda.launches = 0
    t0 = time.monotonic()
    _report(**_fp32_step(dev, load_model_config(VIDEO)),
            seconds=time.monotonic() - t0, launches=roi_cosine_cuda.launches)
    shutdown_distributed()


def worker_dp_nccl(plain_ms: str) -> None:
    """(c), under torchrun with one rank (NCCL): the bf16 train micro-step
    at batch 5 timed as phase 7 times it, then one fp32 step at the global
    batch of ``DP_BATCH`` data-parallel and one under FSDP2, with their
    peak memory."""
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.parallel.mesh import (
        local_device, maybe_initialize_distributed, shutdown_distributed)
    from protoasnet_tpu_torch.train.optim import GROUPS

    maybe_initialize_distributed()
    dev = local_device()
    cfg = load_model_config(VIDEO)
    roi_cosine_cuda.launches = 0
    _, step, _ = _flagship_step(dev, cfg, cfg["model"]["dtype"], 2)
    x = torch.randn((5, *CLIP), device=dev)
    y = torch.tensor([0, 1, 2, 0, 1], device=dev)
    v = torch.ones(5, dtype=torch.bool, device=dev)
    lrs = {gr: 1e-4 for gr in GROUPS}
    gen = torch.Generator().manual_seed(8)
    for _ in range(4):
        step(x, y, v, lrs, generator=gen)
    torch.cuda.synchronize()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        step(x, y, v, lrs, generator=gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    del step
    torch.cuda.empty_cache()
    dp = _fp32_step(dev, cfg)
    torch.cuda.empty_cache()
    fsdp = _fp32_step(dev, cfg, fsdp=True)
    _report(ms=ms, plain_ms=float(plain_ms), dp=dp, fsdp=fsdp,
            launches=roi_cosine_cuda.launches)
    shutdown_distributed()


WORKERS = {"dp_main": worker_dp_main, "dp_gloo": worker_dp_gloo,
           "dp_nccl": worker_dp_nccl}


def phase_distribution(dev, cfg, train, work: Path, train_rate: float,
                       live15: np.ndarray) -> int:
    """21: the port's data parallelism (``parallel/``) on the card.

    (a) ``protoasnet_tpu_torch.main`` under ``python -m
    torch.distributed.run --standalone --nproc_per_node=1`` (NCCL, world
    1; the worker calls the entry point's ``main`` with the command line
    and reports the ROI kernel's counts) on phase 7's command line with
    the per-batch host metrics: its per-step training losses within 1e-4
    relative of the same command without the launcher (in this process),
    one ``last.ckpt``; (b) two gloo ranks on cuda:0, one fp32 step (TF32
    off) at the global batch of ``DP_BATCH``: the step-1 loss within 2e-5
    relative of this process's single-process step, the two replicas'
    parameters bit-identical after it (a correctness run: the all-reduces
    cross the host); (c) world-1 NCCL: the bf16 micro-step at batch 5
    beside phase 7's, the fp32 step data-parallel and under FSDP2 (losses
    within 2e-5, peak memory of each); (d) ``server.serve_live`` with its
    default devices (every local card) bit-equal to phase 15's logits;
    (e) the ROI kernel launched in each of (a)-(c). Returns the launches
    of (a)-(d)."""
    from protoasnet_tpu_torch import server
    from protoasnet_tpu_torch.client import ServingClient
    from protoasnet_tpu_torch.main import main as train_main
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

    t_phase = time.monotonic()
    torch.cuda.empty_cache()  # the workers share the card with this process
    args = [a.replace(str(work / "video_runs"), str(work / "dp_runs"))
            for a in train["args"]] + list(DP_TRAIN_ARGS)
    ref_args = [a.replace("dp_runs", "dp_ref_runs") for a in args]
    # (a) and (b), which time nothing, at once: the launcher's run beside
    # the same command without it, the gloo ranks beside one process
    with ThreadPoolExecutor(2) as pool:
        fut_a = pool.submit(_torchrun, 1, "dp_main", *args)
        fut_b = pool.submit(_torchrun, 2, "dp_gloo")
        ref = Path(train_main(ref_args).save_dir)
        one = _fp32_step(dev, cfg)
        (a,), b = fut_a.result(), fut_b.result()
    torch.cuda.empty_cache()
    run = Path(a["run"])
    dp_losses, ref_losses = _batch_losses(run), _batch_losses(ref)
    rel = max(abs(p - q) / abs(q) for p, q in zip(dp_losses, ref_losses))
    ckpts = sorted(p.name for p in run.glob("*.ckpt"))
    if (a["backend"], a["world"]) != ("nccl", 1) or not dp_losses or \
            len(dp_losses) != len(ref_losses) or rel > 1e-4 or \
            ckpts.count("last.ckpt") != 1 or not a["launches"]:
        raise AssertionError(f"(a) {a}: losses {dp_losses} vs {ref_losses} "
                             f"({rel}), checkpoints {ckpts}")
    log(f"[21 dp train] python -m torch.distributed.run --standalone "
        f"--nproc_per_node=1 -m protoasnet_tpu_torch.main {' '.join(args[2:])}"
        f" ({a['backend']}, world {a['world']}): {a['seconds']:.1f}s; "
        f"per-step train losses {[round(v, 6) for v in dp_losses]}, max "
        f"relative diff {rel:.3e} from the same command without the "
        f"launcher (limit 1e-4); checkpoints {ckpts}; roi_cosine_cuda "
        f"launches {a['launches']}, backward calls {a['backward_calls']}")

    # (b) two gloo ranks on one card against this process's step
    rel_b = abs(b[0]["loss"] - one["loss"]) / abs(one["loss"])
    d_logits = _max_diff(sum((r["logits"] for r in b), []), one["logits"])
    if {(r["backend"], r["world"], len(r["logits"])) for r in b} != {
            ("gloo", 2, DP_BATCH // 2)} or rel_b > 2e-5 or \
            b[0]["loss"] != b[1]["loss"] or b[0]["sha"] != b[1]["sha"] or \
            not all(r["launches"] for r in b):
        raise AssertionError(f"(b) {b} vs one process {one}")
    log(f"[21 dp gloo] 2 gloo ranks on cuda:0 (a correctness run, the "
        f"all-reduces go through the host), fp32 step at the global batch "
        f"{DP_BATCH} ({DP_BATCH // 2} rows a rank): loss {b[0]['loss']!r} "
        f"vs one process {one['loss']!r} (relative {rel_b:.3e}, limit "
        f"2e-5), the ranks' logits vs its {d_logits:.3e}; replicas "
        f"bit-identical after it (sha256 {b[0]['sha'][:16]}); the step "
        f"{1e3 * max(r['step_s'] for r in b):.1f} ms against one process's "
        f"{1e3 * one['step_s']:.1f} ms (first steps, each run beside (a)); "
        f"roi_cosine_cuda launches {[r['launches'] for r in b]}")

    # (c) world-1 NCCL: the micro-step, DP against FSDP2
    (c,) = _torchrun(1, "dp_nccl", f"{1e3 * 5 / train_rate:.4f}")
    dp, fs = c["dp"], c["fsdp"]
    rel_c = abs(fs["loss"] - dp["loss"]) / abs(dp["loss"])
    if c["backend"] != "nccl" or rel_c > 2e-5 or not c["launches"]:
        raise AssertionError(f"(c) {c}")
    log(f"[21 dp nccl] world-1 NCCL: bf16 train micro-step at batch 5 "
        f"{c['ms']:.2f} ms against phase 7's {c['plain_ms']:.2f} ms "
        f"without a group ({c['ms'] / c['plain_ms']:.3f}x); fp32 step at "
        f"the batch {DP_BATCH}: data-parallel loss {dp['loss']!r}, FSDP2 "
        f"{fs['loss']!r} (relative {rel_c:.3e}, limit 2e-5); memory "
        f"allocated at rest {dp['rest']:.3f} / {fs['rest']:.3f} GiB, peak "
        f"of the step beyond it {dp['peak']:.3f} / {fs['peak']:.3f} GiB, "
        f"the first step {1e3 * dp['step_s']:.1f} / "
        f"{1e3 * fs['step_s']:.1f} ms (DP / FSDP2); "
        f"roi_cosine_cuda launches {c['launches']}")

    # (d) serve_live over every local card
    x = np.random.default_rng(15).normal(
        size=(LIVE_CLIPS, *CLIP)).astype(np.float32)
    roi_cosine_cuda.launches = 0
    devices = server.live_devices()
    with _serving(server.serve_live, str(train["run"]),
                  max_batch=LIVE_BATCH, warmup=True) as url:
        client = ServingClient(url, timeout_s=300, retries=0)
        spec = client.spec()
        splitting = ServingClient(url, timeout_s=300, retries=0)
        splitting._spec = dict(spec, max_request_samples=LIVE_BATCH + 1)
        live = splitting.predict(x)
    d_launches = roi_cosine_cuda.launches
    if not np.array_equal(live, live15) or not d_launches:
        raise AssertionError(f"(d) serve_live over {devices}: vs phase 15 "
                             f"{_max_diff(live, live15)}")
    log(f"[21 dp serve] server.serve_live over {[str(d) for d in devices]} "
        f"(buckets {spec['buckets']}): {LIVE_CLIPS} clips bit-equal to "
        f"phase 15's; roi_cosine_cuda launches {d_launches}")
    log(f"[21 dp] (e) roi_cosine_cuda launched in (a) {a['launches']}, (b) "
        f"{[r['launches'] for r in b]}, (c) {c['launches']}, (d) "
        f"{d_launches}; phase 21 took {time.monotonic() - t_phase:.1f}s")
    return a["launches"] + sum(r["launches"] for r in b) + c["launches"] \
        + d_launches


# phase 22: prototype tensor parallelism on a 2-D (data, model) mesh
TP_HEADS = [dict(n=n, s=8 * 14 * 14, p=p, d=256) for p in (20, 10)
            for n in (3, 5, 128)]  # the flagship's head split over 2 and 4:
# 3 rows a data rank in (b) and (d), 5 in (c), 128 the eval batch
TP_PPNET_BATCH = 20  # (e): the ProtoPNet train batch of phase 9
TP_L2 = dict(n=TP_PPNET_BATCH, s=7 * 7, p=15, d=512)  # ProtoPNet's over 2
TP_PUSH_BATCHES = 2  # (d): push batches of DP_BATCH clips


def _tp_group(n_data: int, n_model: int):
    """A gloo group on cuda:0 (under the launcher) and its 2-D mesh."""
    from protoasnet_tpu_torch.parallel.mesh import (
        make_mesh_2d, maybe_initialize_distributed)

    dev = torch.device("cuda", 0)
    maybe_initialize_distributed(dev, backend="gloo")
    return dev, make_mesh_2d(n_data, n_model)


def _tp_step(dev, cfg, out: str, mesh=None):
    """The fp32 flagship (TF32 off) at the global batch of ``DP_BATCH`` in
    two micro-steps of one accumulation on the same rows: after the first,
    the global batch's gradient (the accumulator's saved partial sum:
    summed over ``data``, gathered over ``model``); after the second, which
    updates, the parameters gathered whole. Rank 0 saves both to ``out``.
    Returns {loss (step 1's, global), sha (of the rank's own parameters
    after the update), local_p, step_s (the first micro-step)}."""
    import hashlib

    from protoasnet_tpu_torch.parallel.mesh import gather_shard, is_main
    from protoasnet_tpu_torch.train.optim import GROUPS

    lrs = {gr: 1e-4 for gr in GROUPS}
    with no_tf32():
        model, step, acc = _flagship_step(dev, cfg, "float32", 2, mesh=mesh)
        x, y, v = _dp_batch(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(x, y, v, lrs, affine=DP_AFFINE)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        name_of = {id(p): k for k, p in model.named_parameters()}
        grads = {name_of[id(p)]: g.cpu() for p, g in
                 zip(acc.params, acc.state_dict()["grads"])}
        if not step(x, y, v, lrs, affine=DP_AFFINE)["applied"]:
            raise AssertionError("micro-step 2 of 2 did not update")
        sha = hashlib.sha256()
        after = {}
        for k, p in model.named_parameters():
            sha.update(p.detach().cpu().numpy().tobytes())
            after[k] = gather_shard(p.detach(), p).cpu()
        if is_main():
            torch.save({"grads": grads, "after": after}, out)
    return {"loss": float(m["loss_all"]), "sha": sha.hexdigest(),
            "local_p": int(model.prototype_vectors.shape[0]),
            "step_s": step_s}


def _tp_push(dev, cfg, mesh=None):
    """The push of the full-width fp32 flagship (seed 0) over
    ``TP_PUSH_BATCHES`` seeded global batches, each rank its rows:
    {filenames, gts, sims} of the JAX-layout info, and the ROI kernel's
    launches."""
    from protoasnet_tpu_torch.models.layers import prototype_class_identity
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.parallel.mesh import shard_batch
    from protoasnet_tpu_torch.push.push import push_prototypes

    rng = np.random.default_rng(22)
    loader = []
    for b in range(TP_PUSH_BATCHES):
        rows = shard_batch({
            "cine": rng.normal(size=(DP_BATCH, *CLIP)).astype(np.float32),
            "target_dev": rng.integers(0, 3, DP_BATCH),
            "valid_dev": np.ones(DP_BATCH, bool)}, dev)
        loader.append(dict(
            rows, filename=[f"clip{b}_{i}" for i in range(DP_BATCH)],
            video_idx=np.arange(DP_BATCH) + b * DP_BATCH,
            window_start=np.zeros(DP_BATCH, int),
            window_end=np.full(DP_BATCH, CLIP[0])))
    with no_tf32():
        model, _, _ = _flagship_step(dev, cfg, "float32", 1, mesh=mesh)

        @torch.no_grad()
        def push(cine):
            model.eval()
            return model.push_forward(cine)

        roi_cosine_cuda.launches = 0
        _, info = push_prototypes(
            loader, push, model.prototype_vectors,
            class_identity=prototype_class_identity(
                model.prototype_shape[0], model.num_classes), render=False)
        torch.cuda.synchronize()
    return {"filenames": info["prototypes_filenames"].tolist(),
            "gts": info["prototypes_gts"].tolist(),
            "sims": info["prototypes_similarity_to_src_ROIs"].tolist(),
            "launches": roi_cosine_cuda.launches}


def _ppnet_step(dev, mesh=None):
    """One fp32 step (TF32 off) of ProtoPNet at full width (seed 0) on a
    seeded batch of ``TP_PPNET_BATCH`` images: {loss, local_p, launches of
    l2_min_cuda}."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda
    from protoasnet_tpu_torch.parallel.mesh import (prototype_param_shardings,
                                                    replicate)
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_protopnet_steps

    cfg = load_model_config(PPNET)
    rng = np.random.default_rng(23)
    n = TP_PPNET_BATCH
    x = torch.from_numpy(rng.normal(size=(n, *PPNET["sample"])).astype(
        np.float32)).to(dev)
    y = torch.arange(n, device=dev) % 3
    v = torch.ones(n, dtype=torch.bool, device=dev)
    with no_tf32():
        model = replicate(build_model(dict(cfg["model"], dtype="float32"),
                                      device=dev, seed=0))
        if mesh is not None:
            prototype_param_shardings(model, mesh)
        opt = GroupAdam(model, {gr: 1e-3 for gr in GROUPS})
        step, _, _ = make_protopnet_steps(
            model, LossBundle(cfg["train"]["criterion"], num_classes=3,
                              abstain_class=False),
            opt, GradAccumulator(opt.params, 1))
        l2_min_cuda.launches = 0
        m = step(x, y, v, {gr: 1e-4 for gr in GROUPS})
        torch.cuda.synchronize()
    return {"loss": float(m["loss_all"]),
            "local_p": int(model.prototype_vectors.shape[0]),
            "launches": l2_min_cuda.launches}


def worker_tp_gloo(work: str) -> None:
    """(b) and (d), under torchrun with four ranks: gloo on cuda:0 as a
    2 x 2 mesh; ``_tp_step`` at the global batch of ``DP_BATCH``, then the
    push."""
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.parallel.mesh import shutdown_distributed

    dev, mesh = _tp_group(2, 2)
    cfg = load_model_config(VIDEO)
    roi_cosine_cuda.launches = 0
    step = _tp_step(dev, cfg, str(Path(work) / "tp_step.pt"), mesh)
    launches = roi_cosine_cuda.launches
    torch.cuda.empty_cache()
    _report(**step, launches=launches, push=_tp_push(dev, cfg, mesh),
            mesh=[mesh.data_rank, mesh.model_rank])
    shutdown_distributed()


def worker_tp_pair(plain_ms: str) -> None:
    """(c) and (e), under torchrun with two ranks: gloo on cuda:0 as a
    1 x 2 mesh; the bf16 micro-step at batch 5 timed as phase 7 times it,
    then ProtoPNet's fp32 step."""
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.parallel.mesh import shutdown_distributed
    from protoasnet_tpu_torch.train.optim import GROUPS

    dev, mesh = _tp_group(1, 2)
    cfg = load_model_config(VIDEO)
    roi_cosine_cuda.launches = 0
    model, step, _ = _flagship_step(dev, cfg, cfg["model"]["dtype"], 2,
                                    mesh=mesh)
    rng = np.random.default_rng(7)  # the same batch on both model ranks
    x = torch.from_numpy(rng.normal(size=(5, *CLIP)).astype(
        np.float32)).to(dev)
    y = torch.tensor([0, 1, 2, 0, 1], device=dev)
    v = torch.ones(5, dtype=torch.bool, device=dev)
    lrs = {gr: 1e-4 for gr in GROUPS}
    gen = torch.Generator().manual_seed(8)
    losses = [float(step(x, y, v, lrs, generator=gen)["loss_all"])
              for _ in range(2)]
    torch.cuda.synchronize()
    iters = 8
    t0 = time.perf_counter()
    for _ in range(iters):
        step(x, y, v, lrs, generator=gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    c = {"ms": ms, "plain_ms": float(plain_ms), "losses": losses,
         "local_p": int(model.prototype_vectors.shape[0]),
         "launches": roi_cosine_cuda.launches}
    del model, step
    torch.cuda.empty_cache()
    _report(c=c, e=_ppnet_step(dev, mesh))
    shutdown_distributed()


def worker_tp_ref(work: str) -> None:
    """(b)'s data-parallel reference, under torchrun with two ranks: gloo
    on cuda:0 as a 2 x 1 mesh (every prototype on each rank), the same
    ``_tp_step``."""
    from protoasnet_tpu_torch.parallel.mesh import shutdown_distributed

    dev, mesh = _tp_group(2, 1)
    _report(**_tp_step(dev, load_model_config(VIDEO),
                       str(Path(work) / "tp_dp.pt"), mesh))
    shutdown_distributed()


WORKERS.update(tp_gloo=worker_tp_gloo, tp_pair=worker_tp_pair,
               tp_ref=worker_tp_ref)


def _roi_records(dev, shapes, g, tag: str):
    """``roi_cosine_cuda`` at each of ``shapes``, fp32 and bf16, against
    its float64 plain version within phase 2's limits, timed (CUDA events)
    beside the plain version, the library call and the bound; returns
    the records."""
    from protoasnet_tpu_torch.ops.roi_cosine import roi_cosine_torch
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

    out = []
    for shape in shapes:
        n, s, p, d = shape["n"], shape["s"], shape["p"], shape["d"]
        occ32 = torch.rand((n, s, p), device=dev, generator=g) * 0.05
        feat32 = torch.randn((n, s, d), device=dev, generator=g)
        protos = torch.rand((p, d), device=dev, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            occ, feat = occ32.to(dtype), feat32.to(dtype)
            err_roi, rel_roi, err_sim, _ = _head_errors(occ, feat, protos)
            ms = time_ms(lambda: roi_cosine_cuda(occ, feat, protos), 20)
            plain_ms = time_ms(lambda: roi_cosine_torch(occ, feat, protos),
                               20)
            bmm_ms = time_ms(lambda: torch.bmm(occ.transpose(1, 2), feat),
                             20)
            bound_ms, bound_by = head_bound_ms(n, s, p, d, dtype)
            rec = dict(shape, dtype=str(dtype)[6:], max_abs_err=max(
                err_roi, err_sim), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=bmm_ms)
            out.append(rec)
            log(f"[{tag}] roi_cosine_cuda {rec['dtype']} N={n} S={s} "
                f"P={p} D={d} (staging "
                f"{'aligned' if (p * occ.element_size()) % 16 == 0 else 'unaligned'}"
                f"): roi max abs err {err_roi:.3e} (rel {rel_roi:.3e}), sim "
                f"{err_sim:.3e} (limits of phase 2); wrapper call {ms:.4f} "
                f"ms, plain {plain_ms:.4f} ms, bmm of roi alone "
                f"{bmm_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return out


def _tp_kernels(dev):
    """(a): the head kernels at the sharded shapes against their float64
    plain versions, timed (CUDA events) beside the plain version, the
    library call and the bound; returns {kernel: [records]}."""
    from protoasnet_tpu_torch.ops.l2_min import l2_min_torch
    from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda

    g = torch.Generator(device=dev).manual_seed(22)
    out = {"roi_cosine_cuda": _roi_records(dev, TP_HEADS, g, "22 tp head"),
           "l2_min_cuda": []}
    n, s, p, d = TP_L2["n"], TP_L2["s"], TP_L2["p"], TP_L2["d"]
    x = torch.sigmoid(torch.randn((n, s, d), device=dev, generator=g))
    w = torch.rand((p, 1, 1, d), device=dev, generator=g)
    err, scale = _l2_errors(x, w)
    ms = time_ms(lambda: l2_min_cuda(x, w), 200)
    plain_ms = time_ms(lambda: l2_min_torch(x, w), 200)
    cdist_ms = time_ms(lambda: torch.cdist(
        x.reshape(n * s, d), w.reshape(p, d),
        compute_mode="use_mm_for_euclid_dist"), 200)
    bound_ms, bound_by = l2_bound_ms(n, s, p, d)
    out["l2_min_cuda"].append(dict(
        TP_L2, dtype="float32", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=cdist_ms))
    log(f"[22 tp head] l2_min_cuda fp32 N={n} S={s} P={p} D={d} (a partial "
        f"32-prototype tile): max abs err {err:.3e} (limit 1e-5 * "
        f"{scale:.1f}), min_d == dist.amin(1); wrapper call {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, torch.cdist {cdist_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return out


def phase_tensor_parallel(dev, cfg, work: Path, train_rate: float):
    """22: prototype tensor parallelism on the card (module docstring).
    Returns ({kernel: launches on the main paths (b)-(e)}, {kernel:
    records of (a)})."""
    from protoasnet_tpu_torch.train.optim import group_of

    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    records = _tp_kernels(dev)

    # (b) and (d) on four ranks beside the single-process step and push,
    # then the data-parallel reference on two (2 x 1)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_torchrun, 4, "tp_gloo", str(work), timeout=600)
        one = _tp_step(dev, cfg, str(work / "tp_one.pt"))
        torch.cuda.empty_cache()
        one_push = _tp_push(dev, cfg)
        torch.cuda.empty_cache()
        b = fut.result()
    dp = _torchrun(2, "tp_ref", str(work), timeout=600)
    rel_b = max(abs(r["loss"] - one["loss"]) / abs(one["loss"]) for r in b)
    got, ref, dp_ref = (torch.load(work / f"tp_{w}.pt")
                        for w in ("step", "one", "dp"))

    def rel(a, b, keep=lambda k: True):
        """(max |a - b| over max |b| of a tensor, its name): the largest
        over the tensors that ``keep``."""
        return max(((a[k] - t).abs().max().item()
                    / max(t.abs().max().item(), 1e-30), k)
                   for k, t in b.items() if keep(k))

    # held against the data-parallel run on the same two data ranks: the
    # same BatchNorm moments and data split, only the prototypes split;
    # against one process, reported: in fp32 train-mode BatchNorm's
    # backward (the global moments' formula on two data ranks, torch's in
    # one process) moves the trunk's gradients by a few % of a tensor's max
    # (ROADMAP §3; equal in float64 on the CPU,
    # tests/test_torch_port_tensor_parallel.py)
    head = lambda k: group_of(k) != "backbone"  # noqa: E731
    d_grad = rel(got["grads"], dp_ref["grads"])
    d_one = rel(got["grads"], ref["grads"], head)
    d_trunk = rel(got["grads"], ref["grads"], lambda k: not head(k))
    d_dp = rel(dp_ref["grads"], ref["grads"])
    d_param = rel(got["after"], ref["after"])
    # Adam's first update is lr * g / (|g| + eps): a gradient that sums to
    # about 0 takes +-lr on the fp32 rounding of its terms, so the
    # parameters after it are reported and the gradient is held
    flips = sum(int(((got["after"][k] - ref["after"][k]).abs()
                     > 1e-5 * t.abs().max()).sum())
                for k, t in ref["after"].items())
    if abs(dp[0]["loss"] - one["loss"]) > 2e-5 * abs(one["loss"]):
        raise AssertionError(f"(b) the 2 x 1 reference {dp} vs one "
                             f"process {one}")
    replicas = [b[0]["sha"] == b[2]["sha"], b[1]["sha"] == b[3]["sha"]]
    if [r["mesh"] for r in b] != [[0, 0], [0, 1], [1, 0], [1, 1]] or \
            {r["local_p"] for r in b} != {one["local_p"] // 2} or \
            rel_b > 2e-5 or d_grad[0] > 1e-4 or not all(replicas) or \
            set(got["after"]) != set(ref["after"]) or \
            not all(r["launches"] for r in b):
        raise AssertionError(
            f"(b) {[dict(r, push=None) for r in b]} vs one process {one}; "
            f"gradients vs 2 x 1 {d_grad}, vs one process {d_one} (head), "
            f"{d_trunk} (trunk), parameters {d_param}")
    log(f"[22 tp step] 4 gloo ranks on cuda:0 as a 2 x 2 (data, model) "
        f"mesh (a correctness run, the collectives go through the host), "
        f"fp32 flagship step at the global batch {DP_BATCH}, "
        f"{b[0]['local_p']} prototypes a model rank: losses "
        f"{[r['loss'] for r in b]} vs one process {one['loss']!r} (max "
        f"relative {rel_b:.3e}, limit 2e-5); the global batch's gradient "
        f"gathered whole vs the 2 x 1 data-parallel run's (loss "
        f"{dp[0]['loss']!r}): max {d_grad[0]:.3e} of a tensor's max "
        f"({d_grad[1]}; limit 1e-4, phase 11's for fp32 gradients); vs one "
        f"process's, reported: the head's (add-on, occurrence, prototypes, "
        f"readout) {d_one[0]:.3e} ({d_one[1]}), the trunk's "
        f"{d_trunk[0]:.3e} ({d_trunk[1]}), the 2 x 1 run's {d_dp[0]:.3e} "
        f"({d_dp[1]}); the parameters after the update: max "
        f"{d_param[0]:.3e} of a tensor's max, {flips} elements past 1e-5 of "
        f"it "
        f"(Adam's first step, reported); data replicas of each shard "
        f"bit-identical {replicas}; the first micro-step "
        f"{1e3 * max(r['step_s'] for r in b):.1f} ms against one "
        f"process's {1e3 * one['step_s']:.1f} ms (side by side); "
        f"roi_cosine_cuda launches {[r['launches'] for r in b]}")
    for r in b:
        got = r["push"]
        if got["filenames"] != one_push["filenames"] or \
                got["gts"] != one_push["gts"] or not np.allclose(
                    got["sims"], one_push["sims"], rtol=1e-5, atol=1e-6) \
                or not got["launches"]:
            raise AssertionError(f"(d) rank {r['rank']} push {got} vs one "
                                 f"process {one_push}")
    d_sims = max(float(np.abs(np.subtract(r["push"]["sims"],
                                          one_push["sims"])).max())
                 for r in b)
    log(f"[22 tp push] the push on the 2 x 2 mesh over {TP_PUSH_BATCHES} "
        f"batches of {DP_BATCH} clips: the winners and their classes of one "
        f"process on every rank, similarities within {d_sims:.3e}; "
        f"roi_cosine_cuda launches {[r['push']['launches'] for r in b]} "
        f"(one process {one_push['launches']})")

    # (c) and (e) on a 1 x 2 mesh, nothing else on the card
    pair = _torchrun(2, "tp_pair", f"{1e3 * 5 / train_rate:.4f}",
                     timeout=600)
    ppnet_one = _ppnet_step(dev)
    c = [r["c"] for r in pair]
    e = [r["e"] for r in pair]
    if c[0]["losses"] != c[1]["losses"] or \
            not np.all(np.isfinite(c[0]["losses"])) or \
            {r["local_p"] for r in c} != {one["local_p"] // 2} or \
            not all(r["launches"] for r in c):
        raise AssertionError(f"(c) {c}")
    log(f"[22 tp bf16] 2 gloo ranks on cuda:0 as a 1 x 2 mesh, "
        f"{c[0]['local_p']} prototypes a rank (bf16: the unaligned staging): "
        f"bf16 train micro-step at batch 5 {c[0]['ms']:.2f} / "
        f"{c[1]['ms']:.2f} ms (ranks) against phase 7's "
        f"{c[0]['plain_ms']:.2f} ms in one process (a correctness run); "
        f"losses {c[0]['losses']} equal on both ranks; roi_cosine_cuda "
        f"launches {[r['launches'] for r in c]}")
    rel_e = max(abs(r["loss"] - ppnet_one["loss"]) / abs(ppnet_one["loss"])
                for r in e)
    if rel_e > 2e-5 or {r["local_p"] for r in e} != {
            ppnet_one["local_p"] // 2} or not all(r["launches"] for r in e):
        raise AssertionError(f"(e) {e} vs one process {ppnet_one}")
    log(f"[22 tp ppnet] ProtoPNet on the 1 x 2 mesh, {e[0]['local_p']} "
        f"prototypes a rank: fp32 step loss {[r['loss'] for r in e]} vs one "
        f"process {ppnet_one['loss']!r} (max relative {rel_e:.3e}, limit "
        f"2e-5); l2_min_cuda launches {[r['launches'] for r in e]}")
    launches = {
        "roi_cosine_cuda": sum(r["launches"] + r["push"]["launches"]
                               for r in b) + sum(r["launches"] for r in c),
        "l2_min_cuda": sum(r["launches"] for r in e)}
    log(f"[22 tp] launches on the tensor-parallel paths (b)-(e): "
        f"{launches}; phase 22 took {time.monotonic() - t_phase:.1f}s")
    return launches, records


# phase 23: the measuring tools
TOOLS_BAND = (0.8, 1.25)  # a tool's flagship rate over another's, same call
BENCH_ARGS = ["--quick"]
BENCH_SECTIONS = ("a served", "b int8", "c train", "d image")
LATENCY_BATCHES = ["1", "8", "128"]
NULL_ARGS = ["--null", "--seconds", "3"]
DAEMON_ARGS = ["--seconds", "10", "--clients", "4", "--req_batch", "4",
               "--max_batch", "16"]
# the head at the batches the tools launch it at beyond phase 2's 128: the
# daemon's buckets (1-16), the latency curve (1-128), the bench's train
# batch (8), int8_accuracy's calibration on phase 7's train loader (5);
# its backward at the bench's train batch
TOOL_HEADS = [dict(HEAD, n=n) for n in (1, 2, 4, 5, 8, 16, 32, 64)]
TOOL_TRAIN_HEAD = dict(HEAD, n=8)
# (d): phase 7's weights on a val split that holds every class, so that
# AUROC is defined: 3 of every 5 videos in val, labels cycling over 3
ACC_VIDEOS = 60
ACC_SPLITS = ("train", "val", "val", "val", "test")


def phase_tool_kernels(dev):
    """23, before the tools: ``roi_cosine_cuda`` at ``TOOL_HEADS`` and its
    backward at ``TOOL_TRAIN_HEAD``, each against its plain version within
    phase 2's and phase 7's limits. Returns the records."""
    t0 = time.monotonic()
    g = torch.Generator(device=dev).manual_seed(23)
    out = {"forward": _roi_records(dev, TOOL_HEADS, g, "23 tool head"),
           "backward": dict(TOOL_TRAIN_HEAD, dtype="bfloat16",
                            **phase_head_grad(dev, TOOL_TRAIN_HEAD,
                                              "23 tool head grad"))}
    log(f"[23 tool head] {len(TOOL_HEADS)} shapes x 2 dtypes and the "
        f"backward in {time.monotonic() - t0:.1f}s")
    return out


def _all_class_run(run: Path, work: Path) -> Path:
    """A run directory with ``run``'s config and ``last.ckpt`` whose
    manifest is ``ACC_VIDEOS`` new synthetic videos split by
    ``ACC_SPLITS``."""
    import shutil

    import yaml

    from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset

    csv = make_synthetic_dataset(str(work / "acc_data"),
                                 num_videos=ACC_VIDEOS, seed=23,
                                 splits=ACC_SPLITS)
    out = work / "acc_run"
    out.mkdir()
    config = yaml.safe_load((run / "config_train.yml").read_text())
    config["data"]["data_info_file"] = csv
    (out / "config_train.yml").write_text(yaml.safe_dump(config))
    shutil.copy(run / "last.ckpt", out / "last.ckpt")
    return out


def _tool(tag: str, fn, argv):
    """``fn(argv)`` (a tool's ``main``) with ``roi_cosine_cuda``'s count
    set to 0 just before and read just after; its stdout logged with the
    phase's tag (the smoke's last two stdout lines stay its own). Returns
    (the tool's result, the launches)."""
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

    out = io.StringIO()
    roi_cosine_cuda.launches = 0
    with contextlib.redirect_stdout(out):
        res = fn(argv)
    launches = roi_cosine_cuda.launches
    for line in out.getvalue().strip().splitlines():
        log(f"[{tag}] {line}")
    return res, launches


def _in_band(tag: str, what: str, rate: float, ref: float) -> float:
    lo, hi = TOOLS_BAND
    ratio = rate / ref
    if not lo <= ratio <= hi:
        raise AssertionError(f"{tag}: {what} {rate:.2f} is {ratio:.3f}x "
                             f"{ref:.2f}, outside {TOOLS_BAND}")
    return ratio


def phase_tools(dev, train, work: Path, forward_128: float) -> int:
    """23: the repo's measuring tools on the card, each in process, with
    ``roi_cosine_cuda``'s count set to 0 just before and read just after.
    (a) ``python -m protoasnet_tpu_torch.bench --quick``: every key the
    root bench.py prints for ``--quick`` present, finite and positive, the
    kernel launched in each section, ``value`` within ``TOOLS_BAND`` of
    phase 5's forward rate at 128; (b) ``experiments.serving_latency`` at
    ``LATENCY_BATCHES``, bf16 and int8: the rates at 128 within the band
    of (a)'s bf16 and int8 forward rates; (c) ``experiments.daemon_load
    --null`` for 3 s (the daemon's own cost), then the flagship through
    the daemon for 10 s under 4 clients (``DAEMON_ARGS``): no request
    fails (``run_load`` raises), the kernel launched; (d)
    ``experiments.int8_accuracy`` on phase 7's run (2 val clips of one
    class: finite metrics, the int8 logits within 0.08 relative of the
    float ones), then on ``_all_class_run`` of it: the same, every val
    video's clips counted and AUROC defined for both models. Returns the
    launches of (a)-(d)."""
    from protoasnet_tpu_torch import bench
    from protoasnet_tpu_torch.experiments import (daemon_load,
                                                  int8_accuracy,
                                                  serving_latency)

    t_phase = time.monotonic()
    on = ["--device", dev.type]
    top = int(LATENCY_BATCHES[-1])  # the bench's batch, 128
    total = 0
    t0 = time.monotonic()
    line, a = _tool("23 bench", bench.main, BENCH_ARGS + on)
    a_s = time.monotonic() - t0
    keys = {"value", "vs_baseline", "mfu"} | {
        "flops_per_clip_fwd", "infer_mfu", "serving_clips_per_sec",
        "serving_mfu", "infer_clips_per_sec_int8", "infer_mfu_int8",
        "serving_clips_per_sec_int8", "serving_mfu_int8",
        "train_clips_per_sec", "flops_per_clip_train", "train_mfu",
        "image_infer_imgs_per_sec_bf16", "image_infer_mfu",
        "image_infer_imgs_per_sec_int8", "train_vs_baseline"}
    numbers = {k: line.get(k, line["extra"].get(k)) for k in keys}
    bad = {k: v for k, v in numbers.items()
           if not isinstance(v, (int, float)) or not math.isfinite(v)
           or v <= 0}
    if bad or line["metric"] != "protoasnet_video_infer_clips_per_sec" \
            or line["unit"] != "clips/s":
        raise AssertionError(f"23 (a) bench: missing or bad keys {bad}")
    if not all(line["launches"].get(s) for s in BENCH_SECTIONS):
        raise AssertionError(f"23 (a) bench: a section never launched the "
                             f"kernel: {line['launches']}")
    ratio = _in_band("23 (a) bench", "value", line["value"], forward_128)
    total += a
    log(f"[23 bench] bench --quick in {a_s:.1f}s: value {line['value']} "
        f"clips/s ({ratio:.3f}x phase 5's {forward_128:.1f}), mfu "
        f"{line['mfu']}, serving {line['extra']['serving_clips_per_sec']}, "
        f"int8 {line['extra']['infer_clips_per_sec_int8']}, train "
        f"{line['extra']['train_clips_per_sec']} (its train batch), image "
        f"{line['extra']['image_infer_imgs_per_sec_bf16']} imgs/s; "
        f"roi_cosine_cuda launches {a} by section {line['launches']}")
    t0 = time.monotonic()
    rows, b = _tool("23 latency", serving_latency.main,
                    ["--batches", *LATENCY_BATCHES, *on])
    at = {r["batch"]: r for r in rows}
    if sorted(at) != sorted(int(x) for x in LATENCY_BATCHES) or not b:
        raise AssertionError(f"23 (b) latency: {rows}, launches {b}")
    r_bf = _in_band("23 (b) latency", f"bf16 at {top}",
                    at[top]["bf16_clips_per_sec"], line["value"])
    r_q = _in_band("23 (b) latency", f"int8 at {top}",
                   at[top]["int8_clips_per_sec"],
                   line["extra"]["infer_clips_per_sec_int8"])
    total += b
    log(f"[23 latency] {len(rows)} batches in {time.monotonic() - t0:.1f}s; "
        f"at {top} bf16 {at[top]['bf16_ms']:.2f} ms ({r_bf:.3f}x (a)), "
        f"int8 {at[top]['int8_ms']:.2f} ms ({r_q:.3f}x (a)); roi_cosine_cuda "
        f"launches {b}")
    null, _ = _tool("23 daemon", daemon_load.main, NULL_ARGS)
    t0 = time.monotonic()
    rec, c = _tool("23 daemon", daemon_load.main, DAEMON_ARGS + on)
    if not c or not rec["requests"]:
        raise AssertionError(f"23 (c) daemon: {rec}, launches {c}")
    total += c
    log(f"[23 daemon] null: {null['overhead_us_per_sample']} us a sample, "
        f"{null['samples_per_sec']} samples/s; flagship in "
        f"{time.monotonic() - t0:.1f}s: {rec['samples_per_sec']} clips/s, "
        f"p50 {rec['latency_ms_p50']} ms, p95 {rec['latency_ms_p95']} ms, "
        f"mean batch {rec['mean_batch']}; no request failed; "
        f"roi_cosine_cuda launches {c}")
    acc, d = _tool("23 int8 accuracy", int8_accuracy.main,
                   ["--run_dir", str(train["run"]), *on])
    if not d or not acc["clips"] or not 0 <= acc["logit_rel_err"] < 0.08 \
            or not all(math.isfinite(acc[k]) for k in (
                "bal_acc_fp", "bal_acc_int8", "f1_fp", "f1_int8")):
        raise AssertionError(f"23 (d) int8 accuracy: {acc}, launches {d}")
    log(f"[23 int8 accuracy] phase 7's run, {acc['clips']} val clips: "
        f"AUROC {acc['auroc_fp']} -> {acc['auroc_int8']}, bal-acc delta "
        f"{acc['bal_acc_delta']:+.4f}, F1 delta {acc['f1_delta']:+.4f}, "
        f"logit rel err {acc['logit_rel_err']:.4f}; roi_cosine_cuda "
        f"launches {d}")
    t0 = time.monotonic()
    wide = _all_class_run(train["run"], work)
    acc, e = _tool("23 int8 accuracy", int8_accuracy.main,
                   ["--run_dir", str(wide), *on])
    n_val = ACC_SPLITS.count("val") * ACC_VIDEOS // len(ACC_SPLITS)
    if not e or acc["clips"] < n_val \
            or not 0 <= acc["logit_rel_err"] < 0.08 \
            or not all(math.isfinite(acc[k]) for k in (
                "auroc_fp", "auroc_int8", "bal_acc_fp", "bal_acc_int8",
                "f1_fp", "f1_int8")):
        raise AssertionError(f"23 (d) int8 accuracy, every class: {acc}, "
                             f"launches {e}")
    total += d + e
    log(f"[23 int8 accuracy] phase 7's weights on {acc['clips']} val clips "
        f"of every class ({time.monotonic() - t0:.1f}s): AUROC fp "
        f"{acc['auroc_fp']:.4f} int8 {acc['auroc_int8']:.4f} delta "
        f"{acc['auroc_delta']:+.4f}, bal-acc {acc['bal_acc_fp']:.4f} -> "
        f"{acc['bal_acc_int8']:.4f}, F1 {acc['f1_fp']:.4f} -> "
        f"{acc['f1_int8']:.4f}, logit rel err {acc['logit_rel_err']:.4f}; "
        f"roi_cosine_cuda launches {e}")
    log(f"[23 tools] launches (a)-(d): {total}; phase 23 took "
        f"{time.monotonic() - t_phase:.1f}s")
    return total


SWIN_CONFIG = REPO / "perfbench/configs/swin3d/protoasnet_video_swin3d_b.json"
SWIN_BATCH = 128  # the daemon's default max_batch, the cell's bucket
SWIN_REQUESTS = (128, 1, 3)  # clips a POST: buckets 128, 1 and 4
SWIN_CHUNK = 16  # clips a float64 reference call


def _swin_stage_checks(dev, stage):
    """The kernel against float64 at one stage shape, batch 128, both
    dtypes, shifted and not: the largest error over max |ref| of each."""
    from protoasnet_tpu_torch.experiments.window_attn import STAGES, WINDOW
    from protoasnet_tpu_torch.ops import window_attn
    from protoasnet_tpu_torch.ops.window_attn_cuda import window_attn_cuda

    size, c, heads, shifted_by = STAGES[stage]
    g = torch.Generator(device=dev).manual_seed(100 + stage)
    qkv = torch.randn((SWIN_BATCH, *size, 3 * c), generator=g, device=dev)
    table = torch.randn((15 * 13 * 13, heads), generator=g, device=dev)
    index = window_attn.relative_position_index(WINDOW, dev)
    errs = {}
    for shift in ((0, 0, 0), shifted_by):
        for dtype in (torch.float32, torch.bfloat16):
            x = qkv.to(dtype)
            with no_tf32():
                got = window_attn_cuda(x, table, index, heads, WINDOW, shift,
                                       WINDOW)
                worst, top = 0.0, 0.0
                for i in range(0, SWIN_BATCH, SWIN_CHUNK):
                    want = window_attn.window_attention_torch(
                        x[i:i + SWIN_CHUNK].double(), table.double(), index,
                        heads, WINDOW, shift)
                    worst = max(worst, float(
                        (got[i:i + SWIN_CHUNK].double() - want).abs().max()))
                    top = max(top, float(want.abs().max()))
            key = f"{'bf16' if dtype == torch.bfloat16 else 'fp32'}" \
                  f"{'-shifted' if any(shift) else ''}"
            errs[key] = worst / top
            if not worst <= TOL[dtype] * top:
                raise AssertionError(f"[24 swin] stage {stage} {key}: the "
                                     f"kernel is {worst / top:.3e} of max "
                                     f"|ref| off float64")
    return errs


def phase_swin(dev):
    """Phase 24: the window attention kernel at the served stage shapes,
    then a Swin-B bundle through the daemon. Returns the kernels-line
    record (the stage-1 shifted shape's times first) and the launches of
    the served path."""
    from protoasnet_tpu_torch import server
    from protoasnet_tpu_torch.experiments import window_attn as exp
    from protoasnet_tpu_torch.models.backbones import swin3d
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.ops import window_attn
    from protoasnet_tpu_torch.ops.window_attn_cuda import window_attn_cuda
    from protoasnet_tpu_torch.serve import (load_serving_bundle,
                                            make_serving_fn,
                                            save_serving_bundle)

    stages = []
    for stage in exp.STAGES:
        errs = _swin_stage_checks(dev, stage)
        for shifted in (False, True):
            r = exp._stage(stage, SWIN_BATCH, shifted, 2, dev)
            stages.append(dict(stage=stage, shifted=shifted,
                               max_rel_err=errs, ms=r["kernel_ms"],
                               device_ms=r["device_ms"],
                               plain_ms=r["plain_ms"],
                               library_ms=r["library_ms"],
                               bound_ms=r["bound_ms"],
                               bound_by=r["bound_by"]))
            log(f"[24 swin] stage {stage} {'shifted' if shifted else 'plain'}"
                f" at {SWIN_BATCH}: kernel {r['kernel_ms']:.4f} ms (device "
                f"{r['device_ms']:.4f}), bound {r['bound_ms']:.4f} "
                f"({r['bound_by']}), plain {r['plain_ms']:.3f}, library "
                f"{r['library_ms']:.3f}; vs float64 {errs}")
        torch.cuda.empty_cache()

    mcfg = json.loads(SWIN_CONFIG.read_text())
    model = build_model(mcfg, device="cpu", seed=0)
    sample = (int(mcfg["frames"]), int(mcfg["img_size"]),
              int(mcfg["img_size"]), 3)
    rng = np.random.default_rng(24)
    xs = [rng.integers(0, 256, size=(n, *sample[:3]), dtype=np.uint8)
          for n in SWIN_REQUESTS]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "swin_bundle.zip")
        save_serving_bundle(path, model, mcfg, sample, uint8_gray=True)
        window_attn_cuda.launches = 0
        with _serving(server.serve_forever, path, max_batch=SWIN_BATCH,
                      max_delay_ms=5.0, warmup=True, device=dev) as url:
            outs = [_post(url, x) for x in xs]
            with urllib.request.urlopen(url + "/v1/stats", timeout=30) as r:
                stats = json.loads(r.read())
        launches = window_attn_cuda.launches
        batches = len(server._bucket_ladder(SWIN_BATCH)) + stats["batches"]
        blocks = sum(isinstance(m, swin3d.ShiftedWindowAttention3d)
                     for m in model.modules())  # 22 in swin3d_b cut at -3
        if launches != blocks * batches:
            raise AssertionError(f"[24 swin] {launches} kernel launches for "
                                 f"{batches} batches (warm-up and served); "
                                 f"{blocks} a batch expected")
        direct = load_serving_bundle(path, device=dev)
        model.to(dev)
        fused = swin3d.window_attention

        def plain(qkv, table, index, heads, window, shift, table_window):
            return window_attn.window_attention_torch(qkv, table, index,
                                                      heads, window, shift)

        worst, d_plain = 0.0, 0.0
        for x, out in zip(xs, outs):
            n = len(x)
            if out.shape != (n, int(mcfg["num_classes"])) or \
                    not np.isfinite(out).all():
                raise AssertionError(f"[24 swin] served logits {out.shape}")
            bucket = next(b for b in server._bucket_ladder(SWIN_BATCH)
                          if b >= n)
            xp = np.zeros((bucket, *sample[:3]), np.uint8)
            xp[:n] = x
            worst = max(worst, float(np.abs(out - direct(xp)[:n]).max()))
            swin3d.window_attention = plain
            try:
                ref = make_serving_fn(model, uint8_gray=True)(x)
            finally:
                swin3d.window_attention = fused
            d_plain = max(d_plain, float(np.abs(out - ref).max()
                                         / max(np.abs(ref).max(), 1.0)))
    log(f"[24 swin] served {SWIN_REQUESTS} clips at max_batch {SWIN_BATCH}: "
        f"{stats['batches']} batches + the warm-up's "
        f"{len(server._bucket_ladder(SWIN_BATCH))}, window_attn_cuda "
        f"launches {launches} ({blocks} a batch); served vs direct "
        f"{worst:.3e}, vs the plain route {d_plain:.3e} of max(1, "
        f"|logits|)")
    if worst > 1e-3 or d_plain > 5e-2:
        raise AssertionError(f"[24 swin] served logits: vs direct {worst}, "
                             f"vs the plain route {d_plain}")
    del model, direct
    torch.cuda.empty_cache()
    head = next(r for r in stages if r["stage"] == 1 and r["shifted"])
    return dict(head, stages=stages), launches


EPILOGUE_BATCH = 128  # the daemon's default max_batch, the cells' bucket
EPILOGUE_CHUNK = 16  # clips a plain-route reference call


def _epilogue_calls(dev, cfg):
    """The bf16 flagship's served copy on the card and the (C, T, H·W,
    residual) of each of its epilogues, in order, from one clip."""
    from protoasnet_tpu_torch.models import aligned
    from protoasnet_tpu_torch.models.builder import build_model

    model = build_model(dict(cfg["model"], dtype="bfloat16"), device=dev,
                        seed=0).eval()
    served = aligned.aligned_serving_model(model)
    calls = []

    def record(mod, inp, out):
        y = inp[0]
        calls.append((y.shape[1], y.shape[2], y.shape[3] * y.shape[4],
                      len(inp) > 1 and inp[1] is not None))

    handles = [m.register_forward_hook(record)
               for m in served.cnn_backbone.modules()
               if isinstance(m, aligned._Epilogue)]
    with torch.inference_mode():
        x = torch.zeros((1, *CLIP), device=dev)
        served(aligned.aligned_input(x, torch.bfloat16))
    for h in handles:
        h.remove()
    return model, served, calls


def phase_conv_epilogue(dev, cfg):
    """Phase 25: the conv epilogue kernel at every distinct served shape,
    then the flagship's served copy through it. Returns the kernels-line
    record and the launches of the served forwards."""
    from protoasnet_tpu_torch.experiments.common import time_ms as events_ms
    from protoasnet_tpu_torch.models import aligned
    from protoasnet_tpu_torch.ops import conv_epilogue_cuda as epi

    model, served, calls = _epilogue_calls(dev, cfg)
    if len(calls) != 26:
        raise AssertionError(f"[25 epilogue] {len(calls)} epilogues a "
                             f"forward, 26 expected")
    n = EPILOGUE_BATCH
    g = torch.Generator(device=dev).manual_seed(25)
    shapes, timed = [], {}
    for c, t, hw, _ in sorted(set(calls)):
        if (c, t, hw) in {s["shape"][:3] for s in shapes}:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            for residual in (False, True):
                shape = (n, c, t, hw, 1)
                cl = torch.channels_last_3d
                x = torch.randn(shape, device=dev, generator=g).to(
                    dtype).contiguous(memory_format=cl)
                b = torch.randn(c, device=dev, generator=g)
                r = torch.randn(shape, device=dev, generator=g).to(
                    dtype).contiguous(memory_format=cl) if residual else None
                with torch.inference_mode():
                    got = epi.conv_epilogue_cuda(x.clone(memory_format=cl),
                                                 b, r)
                    bad = 0
                    for i in range(0, n, EPILOGUE_CHUNK):
                        part = slice(i, i + EPILOGUE_CHUNK)
                        ref = epi.conv_epilogue_torch(
                            x[part].float(), b,
                            None if r is None else r[part].float())
                        if dtype == torch.float32:
                            bad += int((got[part] != ref).sum())
                        else:  # one bf16 ulp: 2^(exponent - 7)
                            e = torch.floor(torch.log2(
                                ref.abs().clamp_min(2.0 ** -126)))
                            bad += int(((got[part].float() - ref).abs()
                                        > torch.exp2(e - 7)).sum())
                    ref = got = e = None
                    if bad:
                        raise AssertionError(
                            f"[25 epilogue] C={c} T={t} HW={hw} {dtype} "
                            f"residual={residual}: {bad} elements off the "
                            f"plain route")
                    ms = events_ms(lambda: epi.conv_epilogue_cuda(x, b, r))
                    plain = events_ms(lambda: epi.conv_epilogue_torch(x, b,
                                                                      r))
                bound = epi.bytes_moved(x.numel(), x.element_size(), c,
                                        residual) / HBM_BYTES_PER_S * 1e3
                key = (c, t, hw, residual, dtype == torch.bfloat16)
                timed[key] = ms
                shapes.append(dict(shape=(c, t, hw), residual=residual,
                                   dtype=str(dtype)[6:], ms=ms,
                                   bound_ms=bound, plain_ms=plain))
                log(f"[25 epilogue] N={n} C={c} T={t} HW={hw} "
                    f"{str(dtype)[6:]} {'+r' if residual else '  '}: "
                    f"kernel {ms:.4f} ms, bound {bound:.4f} "
                    f"({100 * bound / ms:.1f}%), plain {plain:.4f}")
                del x, r
                torch.cuda.empty_cache()
    # the served forward's 26 epilogues at batch 128, bf16
    total = sum(timed[(c, t, hw, res, True)] for c, t, hw, res in calls)
    total_bound = sum(epi.bytes_moved(n * c * t * hw, 2, c, res)
                      for c, t, hw, res in calls) / HBM_BYTES_PER_S * 1e3
    log(f"[25 epilogue] a served forward's 26 epilogues at {n}, bf16: "
        f"{total:.3f} ms ({total / n:.4f} ms a clip), bound "
        f"{total_bound:.3f} ({100 * total_bound / total:.1f}%)")

    # the launch count from the main path: serve.py's serving function
    # (its _device_forward builds its own folded copy); the copy built
    # above, run by hand, for the plain-route comparison and the timings
    from protoasnet_tpu_torch.serve import make_serving_fn

    rng = np.random.default_rng(25)
    xn = rng.normal(size=(n, *CLIP)).astype(np.float32)
    x = torch.from_numpy(xn).to(dev)
    xa = aligned.aligned_input(x, torch.bfloat16)
    serving = make_serving_fn(model)
    epi.conv_epilogue_cuda.launches = 0
    logits = torch.from_numpy(serving(xn)).to(dev)
    launches = epi.conv_epilogue_cuda.launches
    with torch.inference_mode():
        fwd_ms = events_ms(lambda: served(xa))
        fused = aligned.conv_epilogue
        aligned.conv_epilogue = epi.conv_epilogue_torch
        try:
            plain_logits = served(xa)[0].float()
            plain_ms = events_ms(lambda: served(xa))
        finally:
            aligned.conv_epilogue = fused
        direct = model(x)[0].float()
    if launches != 26:
        raise AssertionError(f"[25 epilogue] {launches} launches in one "
                             f"served forward, 26 expected")
    top = max(1.0, direct.abs().max().item())
    d_plain = (logits - plain_logits).abs().max().item() / top
    d_direct = (logits - direct).abs().max().item() / top
    log(f"[25 epilogue] served at {n}, bf16 (make_serving_fn): {launches} "
        f"launches; the copy's forward {fwd_ms:.2f} ms through the kernel, "
        f"{plain_ms:.2f} through the plain route; served logits vs the "
        f"plain route {d_plain:.3e}, vs the model's own forward "
        f"{d_direct:.3e} of max(1, |logits|)")
    if d_plain > 1e-3 or d_direct > 5e-2:
        raise AssertionError(f"[25 epilogue] served logits: vs the plain "
                             f"route {d_plain}, vs the model {d_direct}")
    del model, served, serving, x, xa
    torch.cuda.empty_cache()
    return dict(shapes=shapes, forward_epilogue_ms=total,
                forward_epilogue_bound_ms=total_bound, forward_ms=fwd_ms,
                forward_plain_ms=plain_ms), launches


MVIT_CONFIG = REPO / "perfbench/configs/mvit/protoasnet_video_mvitv2_b.json"
MVIT_BATCH = 128  # the daemon's default max_batch, the cell's bucket
MVIT_CHUNK = 16  # clips a float64 plain-route call


def _mvit_calls():
    """The served MViTv2-B trunk's distinct attention calls in block order,
    (q sides, k sides, heads), and how many of its blocks make each."""
    from protoasnet_tpu_torch.models.backbones import mvit

    calls = {}
    for b in mvit.block_schedule(**mvit.MVIT_SPECS["mvit_v2_b"], stages=3):
        key = (tuple(b["q_thw"]), tuple(b["kv_thw"]), b["heads"])
        calls[key] = calls.get(key, 0) + 1
    return calls


def _pool_attn_errors(toks, tables, heads):
    """The kernel against the float64 plain route on the same inputs, fp32
    (TF32 off) and bf16 from fp32 (autocast, as the served trunk calls
    it): the largest error over max |ref| of each, beside the plain route's
    own under autocast."""
    from protoasnet_tpu_torch.ops.pool_attn import pool_attention_torch
    from protoasnet_tpu_torch.ops.pool_attn_cuda import pool_attn_cuda

    n = len(toks[0]) // heads
    errs = {}
    for key, bf16 in (("fp32", False), ("bf16", True)):
        with torch.no_grad(), no_tf32(), torch.autocast(
                "cuda", dtype=torch.bfloat16, enabled=bf16):
            got = pool_attn_cuda(*toks, *tables, heads)
            worst, plain, top = 0.0, 0.0, 0.0
            for i in range(0, n, MVIT_CHUNK):
                rows = slice(i * heads, (i + MVIT_CHUNK) * heads)
                part = [t[rows] for t in toks]
                with torch.autocast("cuda", enabled=False):
                    want = pool_attention_torch(
                        *[t.double() for t in part],
                        *[t.double() for t in tables], heads)
                worst = max(worst, float(
                    (got[i:i + MVIT_CHUNK].double() - want).abs().max()))
                top = max(top, float(want.abs().max()))
                if bf16:
                    mine = pool_attention_torch(*part, *tables, heads)
                    plain = max(plain, float(
                        (mine.double() - want).abs().max()))
                    mine = None
                want = None
        errs[key] = worst / top
        # fp32: sums in another order than float64 (TOL); bf16: its
        # products, positional terms and P rounded as the plain route
        # rounds them under autocast, so no further from float64 than
        # twice that route, and within TOL of the largest |ref|
        if not worst <= TOL[torch.bfloat16 if bf16 else torch.float32] * top \
                or bf16 and worst > max(2.0 * plain, 1e-3 * top):
            raise AssertionError(
                f"[26 mvit] {key}: the kernel is {worst / top:.3e} of max "
                f"|ref| off float64 (the plain route under autocast "
                f"{plain / top:.3e})")
        if bf16:
            errs["bf16_plain"] = plain / top
        got = None
    return errs


def phase_pool_attn(dev):
    """Phase 26: the pooling attention kernel at the MViTv2-B trunk's five
    served call shapes, then the trunk's served path. Returns the
    kernels-line record (a served forward's 21 calls, then each shape) and
    the launches of the served forward."""
    from perfbench.kernels import pool_attn as work
    from protoasnet_tpu_torch.models.backbones import mvit
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.ops import pool_attn
    from protoasnet_tpu_torch.ops import pool_attn_cuda as mod
    from protoasnet_tpu_torch.serve import make_serving_fn

    n, d = MVIT_BATCH, mod.HEAD_DIM
    calls = _mvit_calls()
    if len(calls) != 5 or sum(calls.values()) != 21:
        raise AssertionError(f"[26 mvit] call shapes {calls}: 5 shapes of "
                             f"21 blocks expected")
    shapes = []
    for c, ((q_thw, k_thw, heads), blocks) in enumerate(calls.items()):
        g = torch.Generator(device=dev).manual_seed(260 + c)

        def rand(*shape):
            return torch.randn(shape, generator=g, device=dev)

        rows = n * heads
        toks = [rand(rows, d), rand(rows, *q_thw, d), rand(rows, d),
                rand(rows, *k_thw, d), rand(rows, d), rand(rows, *k_thw, d)]
        tables = [rand(pool_attn.table_rows(q, k), d) / math.sqrt(d)
                  for q, k in zip(q_thw, k_thw)]
        errs = _pool_attn_errors(toks, tables, heads)
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            def fused():
                return mod.pool_attn_cuda(*toks, *tables, heads)

            def plain():
                return pool_attn.pool_attention_torch(*toks, *tables, heads)

            ms = time_ms(fused, 20)
            device_ms = kernel_device_ms(fused, mod.KERNEL, 20)
            plain_ms = time_ms(plain, 3, warmup=1)
        call = work.call_of(q_thw, k_thw, heads, d)
        bound, bound_by = _bound(work.bytes_moved(rows, call, 4, 2),
                                 work.flops(rows, call), torch.bfloat16)
        lq, lk = call[:2]
        shapes.append(dict(lq=lq, lk=lk, heads=heads, blocks=blocks,
                           max_rel_err=errs, ms=ms, device_ms=device_ms,
                           plain_ms=plain_ms, bound_ms=bound,
                           bound_by=bound_by))
        log(f"[26 mvit] {lq}x{lk}, {heads} head(s), {blocks} block(s), at "
            f"{n}, bf16 from fp32: kernel {ms:.4f} ms (device "
            f"{device_ms:.4f}), bound {bound:.4f} ({bound_by}, "
            f"{100 * bound / device_ms:.1f}%), plain {plain_ms:.3f}; vs "
            f"float64 {errs}")
        del toks, tables
        torch.cuda.empty_cache()
    forward = {k: sum(r[k] * r["blocks"] for r in shapes)
               for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    log(f"[26 mvit] a served forward's 21 calls at {n}: kernel "
        f"{forward['ms']:.3f} ms (device {forward['device_ms']:.3f}), bound "
        f"{forward['bound_ms']:.3f} "
        f"({100 * forward['bound_ms'] / forward['device_ms']:.1f}%), plain "
        f"{forward['plain_ms']:.3f}")

    # the launch count from the main path: serve.py's serving function on
    # the configuration's model; its logits against the same model with the
    # plain route in the kernel's place
    mcfg = json.loads(MVIT_CONFIG.read_text())
    model = build_model(mcfg, device="cpu", seed=0).to(dev)
    rng = np.random.default_rng(26)
    x = rng.integers(0, 256, size=(n, int(mcfg["frames"]),
                                   int(mcfg["img_size"]),
                                   int(mcfg["img_size"])), dtype=np.uint8)
    serving = make_serving_fn(model, uint8_gray=True)
    mod.pool_attn_cuda.launches = 0
    logits = serving(x)
    launches = mod.pool_attn_cuda.launches
    if launches != 21:
        raise AssertionError(f"[26 mvit] {launches} kernel launches in one "
                             f"served batch, 21 expected")
    fused = mvit.pool_attention
    mvit.pool_attention = pool_attn.pool_attention_torch
    try:
        ref = serving(x)
    finally:
        mvit.pool_attention = fused
    if logits.shape != (n, int(mcfg["num_classes"])) or \
            not np.isfinite(logits).all():
        raise AssertionError(f"[26 mvit] served logits {logits.shape}")
    d_plain = float(np.abs(logits - ref).max()
                    / max(np.abs(ref).max(), 1.0))
    log(f"[26 mvit] served {n} clips (make_serving_fn, uint8 gray, bf16): "
        f"pool_attn_cuda launches {launches}; vs the plain route "
        f"{d_plain:.3e} of max(1, |logits|)")
    # the cell's logit_gap limit, against the fp32 reference: 0.1
    if d_plain > 0.1:
        raise AssertionError(f"[26 mvit] served logits vs the plain route: "
                             f"{d_plain}")
    del model, serving
    torch.cuda.empty_cache()
    return dict(forward, calls=shapes), launches


def _record(r):
    return {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}


def main() -> int:
    if len(sys.argv) > 1:  # a worker of phase 21 or 22, under torchrun
        WORKERS[sys.argv[1]](*sys.argv[2:])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}; {card}")
    cfgs = {spec["label"]: load_model_config(spec)
            for spec in (VIDEO, PPNET, IMAGE)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return _phases(dev, card, cfgs, Path(tmp))


def _phases(dev, card: str, cfgs, work: Path) -> int:
    """Phases 1-26; the training runs stay under ``work`` for 13-23."""
    t_start = time.monotonic()
    from protoasnet_tpu_torch.ops import conv_epilogue_cuda as epi_mod
    from protoasnet_tpu_torch.ops import fused_c2p1d_cuda as fused_mod
    from protoasnet_tpu_torch.ops import l2_min_cuda as l2_mod
    from protoasnet_tpu_torch.ops import pool_attn_cuda as pool_mod
    from protoasnet_tpu_torch.ops import roi_cosine_cuda as roi_mod
    from protoasnet_tpu_torch.ops import temporal_conv_cuda as temporal_mod
    from protoasnet_tpu_torch.ops import window_attn_cuda as swin_mod

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
    rates = {spec["label"]: phase_throughput(dev, spec, cfgs[spec["label"]])
             for spec in (VIDEO, PPNET, IMAGE)}
    runs, r2p1d_launches = phase_experiments()
    launches.update(r2p1d_launches)
    train_counts = phase_train(dev, cfgs[VIDEO["label"]], work)
    launches["roi_cosine_cuda"] += train_counts["roi_cosine_cuda"]
    backward = phase_head_grad(dev)
    phase_train_step_vs_cpu(dev, cfgs[VIDEO["label"]])
    train_rate = phase_train_rate(dev, cfgs[VIDEO["label"]])
    # the 2-D family's training: each path with its kernel's counts set to
    # 0 just before it and read just after it
    l2_backward = phase_l2_grad(dev)
    phase_head_grad(dev, IMAGE_TRAIN_HEAD, "8 head grad image")
    l2_train, l2_calls, ppnet_run = phase_train_2d(
        dev, PPNET, cfgs[PPNET["label"]], l2_mod.l2_min_cuda,
        "9 train ProtoPNet", work)
    launches["l2_min_cuda"] += l2_train
    roi_train, roi_calls, image_run = phase_train_2d(
        dev, IMAGE, cfgs[IMAGE["label"]], roi_mod.roi_cosine_cuda,
        "10 train image ProtoASNet", work)
    launches["roi_cosine_cuda"] += roi_train
    phase_ppnet_step_vs_cpu(dev, cfgs[PPNET["label"]])
    phase_train_rate_2d(dev, cfgs)
    # from the trained runs to explanations and served bundles: each path
    # with its kernel's count set to 0 just before it and read just after
    for count in phase_explain_export(dev, train_counts):
        launches["roi_cosine_cuda"] += count
    launches["roi_cosine_cuda"] += phase_sweep(dev, cfgs[VIDEO["label"]],
                                               train_counts, work)
    launches["l2_min_cuda"] += phase_export_ppnet(dev, ppnet_run)
    # the trained runs served live, reloaded and tuned: each path with its
    # kernel's count set to 0 just before it and read just after
    live_a, live_b, live15 = phase_live(dev, train_counts, image_run, work)
    launches["roi_cosine_cuda"] += live_a + live_b
    launches["l2_min_cuda"] += phase_live_ppnet(dev, ppnet_run)
    launches["roi_cosine_cuda"] += phase_tune(
        dev, train_counts["run"].parent / "flagship_bundle.zip",
        rates[VIDEO["label"]][128])
    # the training loop's instrumentation, remat and the reference's .pth:
    # each path with its kernel's count set to 0 just before it and read
    # just after
    launches["roi_cosine_cuda"] += phase_instrumentation(
        dev, cfgs[VIDEO["label"]], train_counts, work,
        rates[VIDEO["label"]][128], train_rate)
    launches["roi_cosine_cuda"] += phase_remat(dev, cfgs[VIDEO["label"]])
    for name, count in phase_reference_pth(dev, train_counts, ppnet_run,
                                           work).items():
        launches[name] += count
    # w8a8 int8 serving and the last trunks: each path with its kernels'
    # counts set to 0 just before it and read just after
    launches["roi_cosine_cuda"] += phase_int8(dev, train_counts, work,
                                              rates[VIDEO["label"]][128])
    for name, count in phase_new_trunks(dev).items():
        launches[name] += count
    # distribution: the data-parallel paths with the counts set to 0 just
    # before each and read just after
    launches["roi_cosine_cuda"] += phase_distribution(
        dev, cfgs[VIDEO["label"]], train_counts, work, train_rate, live15)
    # prototype tensor parallelism: each 2-D path with the counts set to 0
    # just before it and read just after
    tp_launches, tp_records = phase_tensor_parallel(
        dev, cfgs[VIDEO["label"]], work, train_rate)
    for name, count in tp_launches.items():
        launches[name] += count
    # the measuring tools: the head at their shapes, then each tool with
    # the count set to 0 just before it and read just after
    tool_records = phase_tool_kernels(dev)
    launches["roi_cosine_cuda"] += phase_tools(dev, train_counts, work,
                                               rates[VIDEO["label"]][128])
    # the Swin trunk: its kernel at the served shapes, then its served path
    # with the kernel's count set to 0 just before it and read just after
    swin, launches["window_attn_cuda"] = phase_swin(dev)
    # the served R(2+1)D trunk's conv epilogue: the kernel at its shapes,
    # then the served copy with the count set to 0 just before it and read
    # just after
    epilogue, launches["conv_epilogue_cuda"] = phase_conv_epilogue(
        dev, cfgs[VIDEO["label"]])
    # the MViTv2-B trunk: its kernel at the served call shapes, then its
    # served path with the kernel's count set to 0 just before it and read
    # just after
    mvit, launches["pool_attn_cuda"] = phase_pool_attn(dev)
    log(f"[smoke] phases 1-26 took {time.monotonic() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": [
        dict(name="roi_cosine_cuda", route="cuda", source=roi_mod.SOURCE,
             replaces=roi_mod.REPLACES,
             launches=launches["roi_cosine_cuda"], **head,
             backward=dict(backward, calls=train_counts["backward_calls"]
                           + roi_calls),
             sharded=tp_records["roi_cosine_cuda"], tools=tool_records),
        dict(name="l2_min_cuda", route="cuda", source=l2_mod.SOURCE,
             replaces=l2_mod.REPLACES, launches=launches["l2_min_cuda"],
             **l2, backward=dict(l2_backward, calls=l2_calls),
             sharded=tp_records["l2_min_cuda"]),
        dict(name="temporal_conv_cuda", route="cuda",
             source=temporal_mod.SOURCE, replaces=temporal_mod.REPLACES,
             launches=launches["temporal_conv_cuda"],
             **_record(runs[RECORDS["temporal_conv_cuda"]])),
        dict(name="fused_c2p1d_cuda", route="cuda", source=fused_mod.SOURCE,
             replaces=fused_mod.REPLACES,
             launches=launches["fused_c2p1d_cuda"],
             **_record(runs[RECORDS["fused_c2p1d_cuda"]])),
        dict(name="window_attn_cuda", route="cuda", source=swin_mod.SOURCE,
             replaces=swin_mod.REPLACES,
             launches=launches["window_attn_cuda"], **swin),
        dict(name="conv_epilogue_cuda", route="cuda", source=epi_mod.SOURCE,
             replaces=epi_mod.REPLACES,
             launches=launches["conv_epilogue_cuda"], **epilogue),
        dict(name="pool_attn_cuda", route="cuda", source=pool_mod.SOURCE,
             replaces=pool_mod.REPLACES, launches=launches["pool_attn_cuda"],
             **mvit),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
