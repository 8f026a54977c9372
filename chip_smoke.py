"""Chip smoke of the PyTorch/H100 port: the serving path of the flagship
Video ProtoASNet on one NVIDIA GPU, through the hand-written CUDA head.

    python3 chip_smoke.py

Phases (each prints one or more informational lines; any failed check
raises and the script exits non-zero without printing a result):

1. build the CUDA kernel(s) from ``protoasnet_tpu_torch/csrc``;
2. hold ``roi_cosine_cuda`` against its plain PyTorch version at the
   flagship head shape (N=128, S=8*14*14, P=40, D=256), fp32 and bf16
   inputs, and time kernel, plain version and their bound;
3. build the flagship model (``ours_protoasnet_video.yml``) at full width
   with seeded random weights; at fp32 hold the kernel-head outputs
   against the plain-head outputs on the card, and the card's logits
   against the same model on the CPU;
4. the main path: write a port bundle, ``server.serve_forever`` on port 0
   in a thread, POST clips to /v1/predict, check the logits against a
   direct forward, read /healthz and /v1/stats, stop. The kernels' launch
   counts are read around this phase only;
5. clips/s of the bf16 forward at batch 32 and 128.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "protoasnet_tpu" / "configs" / "ours_protoasnet_video.yml"
CLIP = (32, 112, 112, 3)
# the head's shape in the server's default (and largest) bucket, 128 clips
HEAD = dict(n=128, s=8 * 14 * 14, p=40, d=256)
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and
# FLOP/s for the head's input dtype: bf16 inputs on the tensor cores (a
# bf16 product with fp32 accumulation is exact), fp32 inputs outside them
# (TF32 would round the inputs)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}


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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def head_bound_ms(n, s, p, d, dtype):
    """Least time for the head on an H100: every input read once
    (occ, feat in ``dtype``; protos fp32) and every output written once
    (roi, sim fp32) at HBM rate, vs 2*N*S*P*D pooling FLOPs plus the
    cosine epilogue's ~4*N*P*D at the card's peak for ``dtype``."""
    in_bytes = torch.empty((), dtype=dtype).element_size()
    nbytes = n * s * (p + d) * in_bytes + p * d * 4 + p * 4 \
        + n * p * d * 4 + n * p * 4
    flops = 2 * n * s * p * d + 4 * n * p * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOP_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from protoasnet_tpu_torch.ops import cuda_build

    t0 = time.monotonic()
    cuda_build.load_library("roi_cosine.cu")
    log(f"[1 build] roi_cosine.cu -> sm_90a in "
        f"{time.monotonic() - t0:.1f}s")
    for src, text in cuda_build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[1 build] {src}: {line.strip()}")


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
    # fp32 sums of 1568 terms in another order than float64: ~1e-6
    # relative; 1e-5 leaves a margin and still catches a wrong index
    if not (rel_roi < 1e-5 and err_sim < 1e-5):
        raise AssertionError(f"roi_cosine_cuda {occ.dtype} N={len(occ)}: "
                             f"roi rel err {rel_roi:.3e}, sim abs err "
                             f"{err_sim:.3e}")
    return err_roi, rel_roi, err_sim, rel_sim


def phase_head(dev):
    """Kernel vs plain version at the flagship head shape, at the server's
    largest default bucket (128) and the smoke's served bucket (8); returns
    the bf16 (main-path dtype) record at 128."""
    from protoasnet_tpu_torch.ops.roi_cosine import roi_cosine_torch
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

    n, s, p, d = HEAD["n"], HEAD["s"], HEAD["p"], HEAD["d"]
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
        occ2, feat2 = occ.float(), feat.float()
        bmm_ms = time_ms(lambda: torch.bmm(occ2.transpose(1, 2), feat2), 20)
        bound_ms, bound_by = head_bound_ms(n, s, p, d, dtype)
        log(f"[2 head] {str(dtype)[6:]} N={n} S={s} P={p} D={d}: roi max abs "
            f"err {err_roi:.3e} (rel {rel_roi:.3e}), sim max abs err "
            f"{err_sim:.3e} (rel {rel_sim:.3e}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bmm of roi alone {bmm_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), kernel runs "
            f"{times['kernel']} plain runs {times['plain']}; at N=8 roi "
            f"max abs err {e8[0]:.3e}, sim {e8[2]:.3e}")
        if dtype == torch.bfloat16:
            record = {"max_abs_err": max(err_roi, err_sim), "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}
    return record


def load_flagship_config():
    from protoasnet_tpu_torch.utils.config import load_config

    return load_config(str(CONFIG))


def phase_model(dev, cfg):
    """fp32 flagship: kernel head vs plain head on the card, and the card
    vs the CPU (the plain path the tests hold against the JAX package)."""
    from protoasnet_tpu_torch.models.builder import build_model

    mcfg = dict(cfg["model"], dtype="float32")
    model = build_model(mcfg, device=dev, seed=0)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, *CLIP)).astype(np.float32))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            lk, sk, ok = model(x.to(dev))
            model.head_impl = "torch"
            lp, sp, op = model(x.to(dev))
            model.head_impl = None
            cpu_model = build_model(mcfg, device="cpu", seed=0)
            lc, sc, _ = cpu_model(x)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    occ_shape = (2, CLIP[0] // 4, CLIP[1] // 8, CLIP[2] // 8, 40)
    if lk.shape != (2, 4) or ok.shape != occ_shape:
        raise AssertionError(f"shapes {tuple(lk.shape)} {tuple(ok.shape)}")
    for t in (lk, sk, ok):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite model output")
    d_head = max((lk - lp).abs().max().item(), (sk - sp).abs().max().item())
    d_cpu = max((lk.cpu() - lc).abs().max().item(),
                (sk.cpu() - sc).abs().max().item())
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


def _post(url, arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(url + "/v1/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()))


def phase_serve(dev, cfg):
    """The main path: bundle -> serve_forever -> POST -> logits. Returns
    the kernels' launch counts of this path (set to 0 at its start, read
    once the server has stopped, before the reference forwards)."""
    from protoasnet_tpu_torch import server
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda
    from protoasnet_tpu_torch.serve import (load_serving_bundle,
                                            make_serving_fn,
                                            save_serving_bundle)

    model = build_model(cfg["model"], device="cpu", seed=0)  # bf16 config
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "flagship.zip")
        save_serving_bundle(path, model, cfg["model"], CLIP)
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
        roi_cosine_cuda.launches = 0
        t = threading.Thread(target=run, name="smoke-server", daemon=True)
        t.start()
        try:
            if not ready.wait(600) or errors:
                raise RuntimeError(f"server did not start: {errors}")
            url = f"http://127.0.0.1:{ready.port}"
            rng = np.random.default_rng(3)
            t0 = time.monotonic()
            for n in (1, 3, 8, 2):
                x = rng.normal(size=(n, *CLIP)).astype(np.float32)
                served.append((x, _post(url, x)))
            serve_s = time.monotonic() - t0
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                health = r.read().decode()
            with urllib.request.urlopen(url + "/v1/stats", timeout=30) as r:
                stats = json.loads(r.read())
        finally:
            stop.set()
            t.join(120)
        launches = {"roi_cosine_cuda": roi_cosine_cuda.launches}
        if t.is_alive() or errors:
            raise RuntimeError(f"server did not stop cleanly: {errors}")
        direct = load_serving_bundle(path, device=dev)
        worst = 0.0
        for x, out in served:
            n = len(x)
            if out.shape != (n, 4) or not np.isfinite(out).all():
                raise AssertionError(f"served logits {out.shape}")
            # the batcher pads to the next bucket with zero clips; the
            # direct forward gets the same padded batch
            bucket = next(b for b in (1, 2, 4, 8) if b >= n)
            xp = np.zeros((bucket, *CLIP), np.float32)
            xp[:n] = x
            worst = max(worst, float(np.abs(out - direct(xp)[:n]).max()))
        # the 8-clip request against the same weights with the plain head
        x8, out8 = served[2]
        model.to(dev).head_impl = "torch"
        d_plain = float(np.abs(out8 - make_serving_fn(model)(x8)).max())
    log(f"[4 serve] 4 POSTs (1,3,8,2 clips, bf16 flagship) in "
        f"{serve_s:.2f}s; served vs direct forward max abs diff {worst:.3e}, "
        f"8 clips vs plain head {d_plain:.3e}; "
        f"healthz {health!r}; stats requests={stats['requests']} "
        f"samples={stats['samples']} batches={stats['batches']} "
        f"p50={stats['latency_ms_p50']}ms")
    # the same padded batch through the same weights on the same card
    if worst > 1e-3:
        raise AssertionError(f"served logits differ from direct: {worst}")
    # same bf16 trunk; the heads' fp32 sims differ by ~1e-6, which can flip
    # one bf16 rounding of a sim (2^-9) before the bf16 readout
    if d_plain > 2e-2:
        raise AssertionError(f"served logits vs plain head: {d_plain}")
    if health != "ok" or stats["samples"] != 14 or stats["errors"]:
        raise AssertionError(f"server stats {stats}")
    return launches


def phase_throughput(dev, cfg):
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.serve import make_serving_fn

    model = build_model(cfg["model"], device=dev, seed=0)  # bf16
    out = {}
    for b in (32, 128):
        x = torch.randn((b, *CLIP), device=dev)
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: model(x), iters=5, warmup=2)
        out[b] = b / ms * 1e3
        log(f"[5 throughput] bf16 forward batch {b}: {ms:.2f} ms/batch, "
            f"{out[b]:.1f} clips/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # the serving function as the batcher calls it: numpy clips in (host
    # to device copy included), numpy logits out, host clock
    fn = make_serving_fn(model)
    x = np.random.default_rng(4).normal(size=(128, *CLIP)).astype(np.float32)
    fn(x)
    t0 = time.perf_counter()
    for _ in range(3):
        fn(x)
    ms = (time.perf_counter() - t0) / 3 * 1e3
    log(f"[5 throughput] bf16 serving fn batch 128 (numpy in/out): "
        f"{ms:.2f} ms/batch, {128 / ms * 1e3:.1f} clips/s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    from protoasnet_tpu_torch.ops.roi_cosine_cuda import REPLACES, SOURCE

    dev = torch.device("cuda")
    card = card_line()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    cfg = load_flagship_config()
    phase_build()
    head = phase_head(dev)
    phase_model(dev, cfg)
    launches = phase_serve(dev, cfg)
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    log(f"[4 serve] kernels: {json.dumps(sorted(launches))}; launches on "
        f"the main path: {launches}")
    phase_throughput(dev, cfg)
    print(card)
    print(json.dumps({"kernels": [dict(
        name="roi_cosine_cuda", route="cuda", source=SOURCE,
        replaces=REPLACES, launches=launches["roi_cosine_cuda"],
        library_ms=None, **head)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
