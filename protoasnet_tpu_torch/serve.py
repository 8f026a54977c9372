"""Serving bundle of the port: one zip with the model config and weights.

A JAX bundle holds StableHLO, which cannot run without JAX; the port's
bundle holds ``config.json`` (model config, per-sample input shape, input
kind) and ``weights.npz`` (the state_dict as numpy). Loading rebuilds the
model on the device and returns a numpy-in, numpy-out function.

    save_serving_bundle("b.zip", model, model_config, (32, 112, 112, 3))
    fn, shape, dtype = load_serving_bundle_with_spec("b.zip")  # CUDA
    logits = fn(x)  # x (b, 32, 112, 112, 3) float32 -> (b, K) float32

CLI:
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
           "load_serving_bundle_with_spec", "make_serving_fn"]

_FORMAT = "protoasnet_tpu_torch.bundle/1"


def save_serving_bundle(path: str, model: torch.nn.Module,
                        model_config: Dict[str, Any],
                        input_shape: Sequence[int],
                        uint8_gray: bool = False) -> None:
    """Write ``model``'s weights and config to a one-file bundle.

    input_shape: per-sample shape WITHOUT the batch dim, e.g.
    (32, 112, 112, 3). uint8_gray: the bundle takes raw grayscale uint8
    frames (input_shape minus the channel dim) and applies the eval
    transform (/255, normalise, gray -> 3 channels) on the device.
    """
    input_shape = tuple(int(s) for s in input_shape)
    if uint8_gray and input_shape[-1] != 3:
        raise ValueError("uint8_gray expects an input_shape with a trailing "
                         "channel dim of 3")
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
    """numpy clips -> numpy float32 logits through ``model`` on its device."""
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
    pr = sub.add_parser("predict", help="bundle + .npy input -> logits")
    pr.add_argument("--bundle", required=True)
    pr.add_argument("--input", required=True,
                    help=".npy array (b, T, H, W, 3) float32")
    pr.add_argument("--out", default=None)
    pr.add_argument("--batch", type=int, default=128)
    pr.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    pr.set_defaults(fn=_predict_cmd)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
