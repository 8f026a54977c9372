"""Serving bundle of the port: one zip with the model config and weights.

A JAX bundle holds StableHLO, which cannot run without JAX; the port's
bundle holds ``config.json`` (model config, per-sample input shape, input
kind) and ``weights.npz`` (the state_dict as numpy). Loading rebuilds the
model on the device and returns a numpy-in, numpy-out function. Video
models take clips (T, H, W, 3) per sample, image models (ProtoPNet,
XProtoNet) images (H, W, 3):

    save_serving_bundle("b.zip", model, model_config, (32, 112, 112, 3))
    fn, shape, dtype = load_serving_bundle_with_spec("b.zip")  # CUDA
    shape, dtype = bundle_input_spec("b.zip")  # config.json only
    logits = fn(x)  # x (b, 32, 112, 112, 3) float32 -> (b, K) float32
    save_serving_bundle("i.zip", ppnet, ppnet_config, (224, 224, 3))

A trained run (the port's own, or the JAX package's: its flax
``last.ckpt`` or a migrated reference ``.pkl``) becomes a bundle through
``export``, which rebuilds the run's agent from its training config
(``config_train.yml``, else another dumped ``config_*.yml``) and its
``last.ckpt`` (``load_trained_agent``). ``export --int8`` calibrates the
backbone convs on ``--calib_batches`` batches of the run's train loader
(``quant.calibrate_qstate_from_agent``) and writes the w8a8 qstate beside
the weights (``qstate.npz``, ``"int8": true`` in ``config.json``); the
bundle then loads as the quantised model (``quant.quantized_model``), so
``predict``, ``tune`` and the daemon serve int8 as they serve float.

``tune`` sweeps serving batch sizes for a bundle on the card and
recommends the daemon's ``--max_batch``, with the JAX package's method
and JSON (``protoasnet_tpu/serve.py::_tune_cmd``).

CLI:
    python -m protoasnet_tpu_torch.serve export --run_dir <run> \
        --out b.zip [--uint8_input] [--int8 [--calib_batches 4]] \
        [--device cuda]
    python -m protoasnet_tpu_torch.serve predict --bundle b.zip \
        --input x.npy [--out logits.npy] [--batch 128] [--device cuda]
    python -m protoasnet_tpu_torch.serve tune --bundle b.zip \
        [--batches 16,32,64,128,256] [--points 4 20] [--device cuda]
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import time
import zipfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from protoasnet_tpu_torch.data.transforms import normalize
from protoasnet_tpu_torch.models.aligned import (aligned_input,
                                                 aligned_serving_model)
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.quant import (calibrate_qstate_from_agent,
                                        qstate_from_arrays, qstate_to_arrays,
                                        quantized_model)
from protoasnet_tpu_torch.utils.device import resolve_device
from protoasnet_tpu_torch.utils.profiling import count, span

__all__ = ["save_serving_bundle", "load_serving_bundle",
           "load_serving_bundle_with_spec", "load_bundle_model",
           "bundle_input_spec",
           "make_serving_fn", "make_sharded_serving_fn",
           "load_trained_agent", "export_run",
           "recommend", "tune_bundle", "serving_model"]

_FORMAT = "protoasnet_tpu_torch.bundle/1"


def save_serving_bundle(path: str, model: torch.nn.Module,
                        model_config: Dict[str, Any],
                        input_shape: Sequence[int],
                        uint8_gray: bool = False,
                        qstate: Optional[Dict[str, Any]] = None) -> None:
    """Write ``model``'s weights and config to a one-file bundle.

    input_shape: per-sample shape WITHOUT the batch dim: (T, H, W, 3) for
    Video_XProtoNet, e.g. (32, 112, 112, 3), and (H, W, 3) for the image
    models, e.g. (224, 224, 3). uint8_gray: the bundle takes raw grayscale
    uint8 frames, (T, H, W) or (H, W) (input_shape minus the channel dim),
    and applies the eval transform (/255, normalise, gray -> 3 channels) on
    the device. qstate: the w8a8 state of ``quant.build_qstate`` (the
    bundle then serves the quantised model); ``model`` is the float one.
    """
    input_shape = tuple(int(s) for s in input_shape)
    rank = 4 if model_config["name"] == "Video_XProtoNet" else 3
    if len(input_shape) != rank or input_shape[-1] != 3:
        raise ValueError(f"{model_config['name']} takes samples of rank "
                         f"{rank} with 3 trailing channels, not input_shape "
                         f"{input_shape}")
    meta = {"format": _FORMAT, "model": dict(model_config),
            "input_shape": list(input_shape), "uint8_gray": bool(uint8_gray),
            "int8": qstate is not None}
    buf = io.BytesIO()
    np.savez(buf, **{k: v.detach().cpu().numpy()
                     for k, v in model.state_dict().items()})
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("config.json", json.dumps(meta, indent=1))
        z.writestr("weights.npz", buf.getvalue())
        if qstate is not None:
            qbuf = io.BytesIO()
            np.savez(qbuf, **qstate_to_arrays(qstate))
            z.writestr("qstate.npz", qbuf.getvalue())


def _device_forward(model: torch.nn.Module, uint8_gray: bool = False
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A batch already on ``model``'s device, in the bundle's input dtype
    -> logits on the device; the caller holds the grad mode.

    Which copy serves: a float R(2+1)D model serves through its copy laid
    out for cuDNN with its eval BatchNorms folded into its convs
    (``models/aligned.py``), built here once, on the batch as that copy's
    stem takes it; each such forward counts ``serve.aligned_trunk`` on the
    innermost span open (the daemon's ``batcher.batch``), and its 26 conv
    epilogues ``serve.conv_epilogue`` (the CUDA kernel) or
    ``serve.conv_epilogue.plain``. Every other model serves through
    ``model`` itself: a Video Swin model under its bf16 autocast with the
    fused window attention kernel (each block's attention counts
    ``swin.window_attn`` there), an int8 model, the image models and the
    other video trunks."""
    served = aligned_serving_model(model)

    def forward(xt: torch.Tensor) -> torch.Tensor:
        if uint8_gray:
            xt = normalize(xt.to(torch.float32) * (1.0 / 255.0))
            xt = xt[..., None].expand(*xt.shape, 3)
        if served is None:
            return model(xt.to(torch.float32))[0]
        count("serve.aligned_trunk")
        return served(aligned_input(xt, served.dtype))[0]

    return forward


def make_serving_fn(model: torch.nn.Module, uint8_gray: bool = False
                    ) -> Callable[[np.ndarray], np.ndarray]:
    """numpy clips or images -> numpy float32 logits on ``model``'s device,
    through the copy ``_device_forward`` picks: for a float R(2+1)D model,
    the aligned copy made here, whose trunk is a snapshot of ``model``'s
    trunk as it is now (its head modules are ``model``'s own), so a trunk
    weight or attribute changed on ``model`` later does not reach it; for
    every other model, ``model`` itself."""
    return make_sharded_serving_fn(
        model, [next(model.parameters()).device], uint8_gray)


def make_sharded_serving_fn(model: torch.nn.Module,
                            devices: Sequence[Union[str, torch.device]],
                            uint8_gray: bool = False
                            ) -> Callable[[np.ndarray], np.ndarray]:
    """numpy clips or images -> numpy float32 logits, data-parallel over
    ``devices`` (the JAX package's ``make_sharded_serving_fn``).

    Each device holds one replica of the eval-mode ``model`` (float or
    quantised; ``model`` itself where it already lies on that device).
    Each batch is split into equal shards of consecutive rows, padded by
    repeating its last row where it does not split, each shard runs on its
    device (the launches are asynchronous, so the cards overlap) and the
    logits come back in order. A sample's logits depend on that sample
    only, so no collective is needed. One device is ``make_serving_fn``.

    ``fn.host_buffer(shape, dtype)`` gives an array to build batches in
    (``server.DynamicBatcher`` keeps two): pinned host memory when every
    device is a card, so each shard's copy is a DMA from it, else
    ``np.empty``.
    """
    devices = [torch.device(d) for d in devices]
    home = next(model.parameters()).device
    forwards = [_device_forward(
        model if d == home else copy.deepcopy(model).to(d), uint8_gray)
        for d in devices]

    def on(d: torch.device):
        return (torch.cuda.device(d) if d.type == "cuda"
                else contextlib.nullcontext())

    def fn(x: np.ndarray) -> np.ndarray:
        b, n = x.shape[0], len(devices)
        k = -(-b // n)  # rows a shard
        if k * n > b:
            x = np.concatenate([x, np.repeat(x[-1:], k * n - b, axis=0)])
        with torch.inference_mode():
            outs = []
            for i, (d, forward) in enumerate(zip(devices, forwards)):
                with on(d):
                    with span("serve.h2d"):
                        xt = torch.from_numpy(np.ascontiguousarray(
                            x[i * k:(i + 1) * k])).to(d)
                    outs.append(forward(xt))
            return np.concatenate([o.float().cpu().numpy()
                                   for o in outs])[:b]

    def host_buffer(shape: Sequence[int], dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        if any(d.type != "cuda" for d in devices):
            return np.empty(shape, dtype)
        # page-locked bytes viewed as the batch; the array keeps them alive
        pinned = torch.empty(int(np.prod(shape)) * dtype.itemsize,
                             dtype=torch.uint8, pin_memory=True)
        return pinned.numpy().view(dtype).reshape(shape)

    fn.host_buffer = host_buffer
    return fn


def _bundle_meta(z: zipfile.ZipFile, path: str) -> Dict[str, Any]:
    meta = json.loads(z.read("config.json"))
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{path}: not a port bundle (format "
                         f"{meta.get('format')!r})")
    return meta


def _input_spec(meta: Dict[str, Any]) -> Tuple[Tuple, Any]:
    sample = tuple(meta["input_shape"])
    if meta["uint8_gray"]:
        return (None, *sample[:-1]), np.dtype(np.uint8)
    return (None, *sample), np.dtype(np.float32)


def bundle_input_spec(path: str) -> Tuple[Tuple, Any]:
    """(shape, dtype) of a bundle's input batch, the batch dim None, from
    its ``config.json`` alone: no model is built and no weights are read
    (a serving host sizes its warm-up buffers with it)."""
    with zipfile.ZipFile(path) as z:
        return _input_spec(_bundle_meta(z, path))


def load_bundle_model(path: str,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Tuple[torch.nn.Module, Tuple, Any, bool]:
    """Load a bundle's model; returns (model in eval mode on ``device``,
    (None, *per-sample input shape), input dtype, uint8_gray). An int8
    bundle's model is the quantised one."""
    dev = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        meta = _bundle_meta(z, path)
        npz = np.load(io.BytesIO(z.read("weights.npz")))
        weights = {k: npz[k] for k in npz.files}
        qstate = None
        if meta.get("int8", False):
            qnpz = np.load(io.BytesIO(z.read("qstate.npz")))
            qstate = qstate_from_arrays({k: qnpz[k] for k in qnpz.files})
    model = build_model(meta["model"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    model = serving_model(model.to(dev), qstate)
    shape, dtype = _input_spec(meta)
    return model, shape, dtype, bool(meta["uint8_gray"])


def serving_model(model: torch.nn.Module,
                  qstate: Optional[Dict[str, Any]] = None) -> torch.nn.Module:
    """The eval-mode model a bundle or a live run serves: ``model``
    itself, or its quantised copy for a w8a8 ``qstate``."""
    model = model.eval()
    return model if qstate is None else quantized_model(model, qstate)


def load_serving_bundle_with_spec(
        path: str, device: Optional[Union[str, torch.device]] = None
) -> Tuple[Callable, Tuple, Any]:
    """Load a bundle; returns (fn, input_shape, input_dtype), where
    input_shape is (None, *per-sample shape) and fn maps a numpy batch to
    numpy float32 logits on ``device`` (CUDA unless "cpu" is asked for)."""
    model, shape, dtype, uint8_gray = load_bundle_model(path, device)
    return make_serving_fn(model, uint8_gray), shape, dtype


def load_serving_bundle(path: str,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Callable:
    """Load a bundle; returns fn(x) -> logits."""
    return load_serving_bundle_with_spec(path, device)[0]


def load_trained_agent(run_dir: str,
                       device: Optional[Union[str, torch.device]] = None):
    """Rebuild the agent of a run directory from its training config and
    its ``last.ckpt``, whichever package wrote them, on ``device`` (CUDA
    unless "cpu" is asked for). Returns (agent, per-sample input shape).
    Raises when no trained checkpoint was loaded.

    The config is the training command's ``config_train.yml``, else the
    agent's own ``config_agent.yml``, else the first other
    ``config_*.yml``: explain and eval commands dump theirs into the same
    directory, possibly with another ``--model.checkpoint_path``. The
    run's ``last.ckpt``, where there is one, is loaded whatever the
    config's ``checkpoint_path`` says; without one, that path is."""
    import glob
    import os

    import yaml

    from protoasnet_tpu_torch.train.agents import build_agent

    dev = resolve_device(device)
    cfgs = [os.path.join(run_dir, f"config_{n}.yml")
            for n in ("train", "agent")]
    cfgs = [c for c in cfgs if os.path.exists(c)] or sorted(
        glob.glob(os.path.join(run_dir, "config_*.yml")))
    if not cfgs:
        raise FileNotFoundError(f"no dumped config_*.yml under {run_dir}")
    with open(cfgs[0]) as f:
        config = yaml.safe_load(f)
    config["save_dir"] = run_dir
    last = os.path.join(run_dir, "last.ckpt")
    if os.path.exists(last):
        config["model"]["checkpoint_path"] = last
    config["train"]["save"] = False
    config["device"] = dev.type
    agent = build_agent(config)
    # iteration counts micro-steps: > 0 for any trained checkpoint
    if agent.current_iteration == 0 and agent.current_epoch == 0:
        raise RuntimeError(f"no trained checkpoint loaded from {run_dir}")
    data = config.get("data", {})
    s = int(data.get("img_size", 112))
    frames = int(data.get("frames", 32))
    input_shape = (frames, s, s, 3) if frames > 1 else (s, s, 3)
    return agent, input_shape


def export_run(run_dir: str, out: str, uint8_input: bool = False,
               device: Optional[Union[str, torch.device]] = None,
               int8: bool = False, calib_batches: int = 4):
    """Write the bundle of a trained run to ``out`` (with ``int8``, the
    w8a8 backbone calibrated on ``calib_batches`` train batches); returns
    (agent, per-sample input shape)."""
    agent, input_shape = load_trained_agent(run_dir, device)
    qstate = (calibrate_qstate_from_agent(agent, calib_batches) if int8
              else None)
    save_serving_bundle(out, agent.model, agent.model_config, input_shape,
                        uint8_gray=uint8_input, qstate=qstate)
    return agent, input_shape


def _export_cmd(args) -> None:
    import os

    _, input_shape = export_run(args.run_dir, args.out, args.uint8_input,
                                args.device, args.int8, args.calib_batches)
    shown = input_shape[:-1] if args.uint8_input else input_shape
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"input (b, {', '.join(map(str, shown))})"
          f"{' uint8 gray' if args.uint8_input else ''}"
          f"{', int8 backbone' if args.int8 else ''})")


def _predict_cmd(args) -> None:
    fn, _, want_dtype = load_serving_bundle_with_spec(args.bundle,
                                                      args.device)
    x = np.load(args.input)
    if x.dtype != want_dtype:
        if not np.can_cast(x.dtype, want_dtype, casting="same_kind"):
            raise SystemExit(
                f"input dtype {x.dtype} not safely castable to the bundle's "
                f"input dtype {want_dtype.name} (uint8 bundles take raw gray "
                f"frames, not normalized float clips)")
        x = x.astype(want_dtype)
    logits = np.concatenate([fn(x[i:i + args.batch])
                             for i in range(0, len(x), args.batch)])
    if args.out:
        np.save(args.out, logits)
        print(f"wrote {args.out}: logits {logits.shape}")
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = e / e.sum(axis=1, keepdims=True)
    for i, (p, k) in enumerate(zip(probs, probs.argmax(axis=1))):
        print(f"{i}: class {k} p={p[k]:.3f}")


def recommend(results: Dict[int, dict]
              ) -> Tuple[Optional[int], Optional[int]]:
    """(pick, best) among the candidates that have a rate: the best rate's
    batch, and the smallest batch within 5% of it (it cuts p50 latency at
    low load for about nothing); (None, None) when none has a rate."""
    ok = {b: r["samples_per_sec"] for b, r in results.items()
          if "samples_per_sec" in r}
    if not ok:
        return None, None
    best = max(ok, key=ok.get)
    return min(b for b in ok if ok[b] >= 0.95 * ok[best]), best


def tune_bundle(path: str, batches: Sequence[int],
                points: Sequence[int] = (4, 20),
                device: Optional[Union[str, torch.device]] = None) -> dict:
    """Time the bundle's forward at each candidate batch on ``device``
    (CUDA unless "cpu" is asked for); returns ``{"results": {b: {...}},
    "recommended_max_batch": b}``, the JAX package's schema.

    Each candidate runs N forwards of a batch already on the device,
    chained by a data-dependent zero folded back into the input (``x + (sum
    of logits > inf)``, so no forward can start before the previous one
    ends), then reads one scalar back; a two-point fit over N1 and N2
    cancels the host's fixed costs. ``compile_s`` is the first call's
    seconds: the kernels' build and load, cuDNN's choice of plans for the
    shape and the allocator's growth. A candidate that fails (out of
    memory, say) is recorded by its exception's name."""
    n1, n2 = (int(p) for p in points)
    if n2 <= n1 or n1 < 1:
        raise SystemExit(
            f"--points must be two increasing call counts >= 1 "
            f"(got {n1} {n2}); the two-point fit divides by their gap — "
            f"keep them >= 16 apart so per-call jitter cancels")
    model, shape, dtype, uint8_gray = load_bundle_model(path, device)
    forward = _device_forward(model, uint8_gray)
    dev = next(model.parameters()).device
    sample_shape = shape[1:]
    rng = np.random.default_rng(0)
    results: Dict[int, dict] = {}
    for b in batches:
        full = (b,) + sample_shape
        if np.dtype(dtype) == np.uint8:
            x0 = rng.integers(0, 256, size=full).astype(np.uint8)
        else:
            x0 = rng.normal(size=full).astype(np.float32)

        def chained(n, x):
            with torch.inference_mode():
                for _ in range(n):
                    bump = (forward(x).sum() > math.inf).to(x.dtype)
                    x = x + bump
                # one scalar back: the whole batch would drown the fit
                return float(x.reshape(-1)[0])

        xd = None
        try:
            xd = torch.from_numpy(x0).to(dev)
            t0 = time.perf_counter()
            chained(1, xd)
            compile_s = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — out of memory, say
            xd = None  # before empty_cache, so its blocks go back too
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            results[b] = {"error": type(e).__name__}
            print(f"batch {b:4d}: FAILED ({type(e).__name__})", flush=True)
            continue

        def run(n):
            t0 = time.perf_counter()
            chained(n, xd)
            return time.perf_counter() - t0

        ta, tb = run(n1), run(n2)
        per = (tb - ta) / (n2 - n1)
        if per <= 0:
            results[b] = {"error": "degenerate fit — timing jitter beat "
                                   f"the {n2 - n1}-batch signal; rerun "
                                   "with wider --points"}
            print(f"batch {b:4d}: DEGENERATE FIT (ta={ta:.2f}s "
                  f"tb={tb:.2f}s); widen --points", flush=True)
            continue
        results[b] = {"ms_per_batch": round(per * 1000, 2),
                      "samples_per_sec": round(b / per, 1),
                      "compile_s": round(compile_s, 1)}
        print(f"batch {b:4d}: {b / per:8.1f} samples/s "
              f"({per * 1000:7.2f} ms/batch, compile {compile_s:.1f}s)",
              flush=True)
    pick, best = recommend(results)
    if pick is None:
        print("no candidate succeeded")
    else:
        print(f"recommended: --max_batch {pick}"
              + (f" (peak rate at {best}, within 5%)" if pick != best else ""))
    return {"results": results, "recommended_max_batch": pick}


def _tune_cmd(args) -> None:
    batches = [int(b) for b in args.batches.split(",")]
    print(json.dumps(tune_bundle(args.bundle, batches, args.points,
                                 args.device)))


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m protoasnet_tpu_torch.serve")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="trained run dir -> port bundle")
    ex.add_argument("--run_dir", required=True)
    ex.add_argument("--out", required=True)
    ex.add_argument("--uint8_input", action="store_true",
                    help="the bundle takes raw grayscale uint8 frames and "
                         "normalizes on the device")
    ex.add_argument("--int8", action="store_true",
                    help="w8a8 post-training quantisation of the backbone "
                         "convs (calibrated on the run's train loader)")
    ex.add_argument("--calib_batches", type=int, default=4,
                    help="(--int8 only) calibration batches")
    ex.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ex.set_defaults(fn=_export_cmd)
    pr = sub.add_parser("predict", help="bundle + .npy input -> logits")
    pr.add_argument("--bundle", required=True)
    pr.add_argument("--input", required=True,
                    help=".npy array: clips (b, T, H, W, 3) for a video "
                         "bundle or images (b, H, W, 3) for an image "
                         "bundle, float32; uint8 bundles take the same "
                         "without the trailing 3")
    pr.add_argument("--out", default=None)
    pr.add_argument("--batch", type=int, default=128)
    pr.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    pr.set_defaults(fn=_predict_cmd)
    tn = sub.add_parser(
        "tune", help="sweep serving batch sizes on the card; recommends "
                     "--max_batch for the daemon",
        description="Times the bundle's forward on a batch already on the "
                    "device at each candidate size (two-point fit over N1 "
                    "and N2 chained forwards) and prints one JSON line: "
                    "{results: {b: {ms_per_batch, samples_per_sec, "
                    "compile_s} or {error}}, recommended_max_batch}. "
                    "compile_s is the first call's seconds (the kernels' "
                    "build and load, cuDNN's choice of plans, the "
                    "allocator's growth); PyTorch compiles nothing ahead "
                    "of time.")
    tn.add_argument("--bundle", required=True)
    tn.add_argument("--batches", default="16,32,64,128,256",
                    help="comma-separated candidate batch sizes")
    tn.add_argument("--points", type=int, nargs=2, default=(4, 20),
                    metavar=("N1", "N2"),
                    help="two-point-fit loop lengths (>=16 apart so the "
                         "signal beats per-call jitter)")
    tn.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    tn.set_defaults(fn=_tune_cmd)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
