"""Serving bundle of the port: one zip with the model config and weights.

A JAX bundle holds StableHLO, which cannot run without JAX; the port's
bundle holds ``config.json`` (model config, per-sample input shape, input
kind) and ``weights.npz`` (the state_dict as numpy). Loading rebuilds the
model on the device and returns a numpy-in, numpy-out function. Video
models take clips (T, H, W, 3) per sample, image models (ProtoPNet,
XProtoNet) images (H, W, 3):

    save_serving_bundle("b.zip", model, model_config, (32, 112, 112, 3))
    fn, shape, dtype = load_serving_bundle_with_spec("b.zip")  # CUDA
    logits = fn(x)  # x (b, 32, 112, 112, 3) float32 -> (b, K) float32
    save_serving_bundle("i.zip", ppnet, ppnet_config, (224, 224, 3))

A trained run (the port's own, or the JAX package's: its flax
``last.ckpt`` or a migrated reference ``.pkl``) becomes a bundle through
``export``, which rebuilds the run's agent from its training config
(``config_train.yml``, else another dumped ``config_*.yml``) and its
``last.ckpt`` (``load_trained_agent``).

CLI:
    python -m protoasnet_tpu_torch.serve export --run_dir <run> \
        --out b.zip [--uint8_input] [--device cuda]
    python -m protoasnet_tpu_torch.serve predict --bundle b.zip \
        --input x.npy [--out logits.npy] [--batch 128] [--device cuda]
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from protoasnet_tpu_torch.data.transforms import normalize
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.utils.device import resolve_device

__all__ = ["save_serving_bundle", "load_serving_bundle",
           "load_serving_bundle_with_spec", "make_serving_fn",
           "load_trained_agent", "export_run"]

_FORMAT = "protoasnet_tpu_torch.bundle/1"


def save_serving_bundle(path: str, model: torch.nn.Module,
                        model_config: Dict[str, Any],
                        input_shape: Sequence[int],
                        uint8_gray: bool = False) -> None:
    """Write ``model``'s weights and config to a one-file bundle.

    input_shape: per-sample shape WITHOUT the batch dim: (T, H, W, 3) for
    Video_XProtoNet, e.g. (32, 112, 112, 3), and (H, W, 3) for the image
    models, e.g. (224, 224, 3). uint8_gray: the bundle takes raw grayscale
    uint8 frames, (T, H, W) or (H, W) (input_shape minus the channel dim),
    and applies the eval transform (/255, normalise, gray -> 3 channels) on
    the device.
    """
    input_shape = tuple(int(s) for s in input_shape)
    rank = 4 if model_config["name"] == "Video_XProtoNet" else 3
    if len(input_shape) != rank or input_shape[-1] != 3:
        raise ValueError(f"{model_config['name']} takes samples of rank "
                         f"{rank} with 3 trailing channels, not input_shape "
                         f"{input_shape}")
    meta = {"format": _FORMAT, "model": dict(model_config),
            "input_shape": list(input_shape), "uint8_gray": bool(uint8_gray)}
    buf = io.BytesIO()
    np.savez(buf, **{k: v.detach().cpu().numpy()
                     for k, v in model.state_dict().items()})
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("config.json", json.dumps(meta, indent=1))
        z.writestr("weights.npz", buf.getvalue())


def make_serving_fn(model: torch.nn.Module, uint8_gray: bool = False
                    ) -> Callable[[np.ndarray], np.ndarray]:
    """numpy clips or images -> numpy float32 logits through ``model`` on
    its device."""
    device = next(model.parameters()).device

    def fn(x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            if uint8_gray:
                xt = normalize(xt.to(torch.float32) * (1.0 / 255.0))
                xt = xt[..., None].expand(*xt.shape, 3)
            else:
                xt = xt.to(torch.float32)
            logits = model(xt)[0]
            return logits.float().cpu().numpy()

    return fn


def load_serving_bundle_with_spec(
        path: str, device: Optional[Union[str, torch.device]] = None
) -> Tuple[Callable, Tuple, Any]:
    """Load a bundle; returns (fn, input_shape, input_dtype), where
    input_shape is (None, *per-sample shape) and fn maps a numpy batch to
    numpy float32 logits on ``device`` (CUDA unless "cpu" is asked for)."""
    dev = resolve_device(device)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("config.json"))
        npz = np.load(io.BytesIO(z.read("weights.npz")))
        weights = {k: npz[k] for k in npz.files}
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{path}: not a port bundle (format "
                         f"{meta.get('format')!r})")
    model = build_model(meta["model"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    model = model.to(dev).eval()
    uint8_gray = bool(meta["uint8_gray"])
    sample = tuple(meta["input_shape"])
    if uint8_gray:
        sample, dtype = sample[:-1], np.dtype(np.uint8)
    else:
        dtype = np.dtype(np.float32)
    return make_serving_fn(model, uint8_gray), (None, *sample), dtype


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
               device: Optional[Union[str, torch.device]] = None):
    """Write the bundle of a trained run to ``out``; returns (agent,
    per-sample input shape)."""
    agent, input_shape = load_trained_agent(run_dir, device)
    save_serving_bundle(out, agent.model, agent.model_config, input_shape,
                        uint8_gray=uint8_input)
    return agent, input_shape


def _export_cmd(args) -> None:
    import os

    if args.int8:
        raise SystemExit("--int8: the w8a8 export (quant.py) is not ported "
                         "yet (ROADMAP.md §1 item 5); no bundle written")
    _, input_shape = export_run(args.run_dir, args.out, args.uint8_input,
                                args.device)
    shown = input_shape[:-1] if args.uint8_input else input_shape
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"input (b, {', '.join(map(str, shown))})"
          f"{' uint8 gray' if args.uint8_input else ''})")


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
                    help="w8a8 backbone: not ported yet, refused")
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
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
