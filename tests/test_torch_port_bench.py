"""``python -m protoasnet_tpu_torch.bench``, the port's headline benchmark,
against the root ``bench.py`` of the JAX package, on the CPU
(``--device cpu``) at a small size: the flagship at 8 frames of 32x32 with
P=8, D=64 (the trunk at full width), the image model at 64x64 with P=8,
D=64, batch 2 and the suite's sets of 4 and 8 videos, set in the module's
config dicts (``SMALL``), as ``chip_smoke.py`` phase 23 rehearses them.

- The JSON line: the root bench's keys for ``--quick``, listed here from
  ``bench.py`` by line, and ``--suite``'s; the returned dict is the line
  and the launches by section.
- Without a card and without ``--device cpu`` the command exits non-zero
  and prints no rate.
- FLOPs a clip against the JAX package's ``count_flops`` on the same
  configuration, exact once the two counters' known differences are
  worked out from the shapes: the JAX trunk's space-to-depth stem (as in
  ``tests/test_torch_port_flops.py``) and, in the train step, the JAX
  walker charging a strided conv's input gradient at its dilated size
  (the transposed conv's whole window at every input position: prod(stride)
  times the forward's products, where torch's counter charges the
  forward's). The train step is held against JAX's two-pass step
  (``combine_transform=False``), the semantics the port implements: the
  root bench's default pair-vmapped step also runs the add-on and the head
  on the transformed half, which the two-pass step never computes.
- The first train micro-step's loss under the root bench's criterion
  (its two zero weights included) in float64 with the JAX weights (carried
  over by ``models/from_jax.py``) equals the JAX ``make_xprotonet_steps``
  loss to 1e-7 relative.
- ``--suite --detail_out`` writes only the detail file.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.losses.bundle import LossBundle as JaxBundle
from protoasnet_tpu.losses.losses import (
    sample_affine_params as jax_affine_draw)
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu.train.optim import GROUPS as JAX_GROUPS
from protoasnet_tpu.train.optim import make_adam
from protoasnet_tpu.train.steps import TrainState, make_xprotonet_steps
from protoasnet_tpu.utils.flops import count_flops as jax_count
from protoasnet_tpu_torch import bench
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import load_jax_variables
from protoasnet_tpu_torch.train.optim import GROUPS
from torch_port_isolation import isolated, subprocess_env

_isolated = isolated(2)

REPO = Path(__file__).resolve().parents[1]

# the sizes the tests set (chip_smoke.py phase 23's CPU rehearsal too)
SMALL = {
    "VIDEO": dict(bench.VIDEO, prototype_shape=(8, 64, 1, 1, 1),
                  img_size=32),
    "CLIP": (8, 32, 32, 3),
    "IMAGE": dict(bench.IMAGE, prototype_shape=(8, 64, 1, 1), img_size=64),
    "IMAGE_SAMPLE": (64, 64, 3),
    "IMAGE_BATCH": 4,
    "SUITE": dict(bench.SUITE, push_sets=(4, 8), frames=(8, 12),
                  push_batch=4, train_batch=2, eval_batch=4, num_workers=1,
                  render=2, render_frames=8, render_map=(2, 4, 4)),
}
BATCH = 2

# the root bench's JSON line (bench.py:413-423) and the keys of its
# ``extra`` for ``--quick`` with the default flags: (a) bench.py:201,
# :207-211, :238-239; (b) :271-272, :306-307; (c) :362-366; (d) :461-466,
# :494; train_vs_baseline :409-412
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "mfu", "extra"}
QUICK_EXTRA = {
    "flops_per_clip_fwd", "infer_mfu", "serving_clips_per_sec",
    "serving_mfu", "infer_clips_per_sec_int8", "infer_mfu_int8",
    "serving_clips_per_sec_int8", "serving_mfu_int8",
    "train_clips_per_sec", "flops_per_clip_train", "train_mfu",
    "image_infer_imgs_per_sec_bf16", "image_infer_mfu",
    "image_infer_imgs_per_sec_int8", "train_vs_baseline"}
# --suite adds (bench.py:558, :575, :586, :641, :692, :706, :716)
SUITE_EXTRA = {
    "push_scan_clips_per_sec", "push_scan_compute_clips_per_sec",
    "push_scan_marginal_clips_per_sec", "train_epoch_clips_per_sec",
    "eval_epoch_clips_per_sec", "eval_epoch_compute_clips_per_sec",
    "explain_render_clips_per_sec"}
# the root bench's train criterion, bench.py:315-323
JAX_CRITERION = {
    "CeLossAbstain": {"loss_weight": 1, "ab_weight": 0.3,
                      "ab_logitpath": "joined", "reduction": "mean"},
    "ClusterRoiFeat": {"loss_weight": 0.8, "reduction": "mean"},
    "SeparationRoiFeat": {"loss_weight": 0.08, "reduction": "mean"},
    "OrthogonalityLoss": {"loss_weight": 0.0, "mode": "per_class"},
    "Lnorm_occurrence": {"p": 2, "loss_weight": 0.0, "reduction": "mean"},
    "trans_occurrence": {"loss_weight": 0.001, "reduction": "mean"},
    "Lnorm_FC": {"p": 1, "loss_weight": 1e-4},
}


@pytest.fixture(scope="module")
def small():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL.items():
            mp.setattr(bench, name, value)
        yield


def _run(argv, capsys):
    out = bench.main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 1
    return out, json.loads(lines[0])


@pytest.fixture(scope="module")
def quick(small):
    """``--quick`` at the small size: the returned dict."""
    out = bench.main(["--device", "cpu", "--quick", "--batch", str(BATCH)])
    return out


def test_quick_line_has_the_root_bench_keys(small, capsys):
    out, line = _run(["--device", "cpu", "--quick", "--batch", str(BATCH),
                      "--no-train"], capsys)
    assert set(line) == LINE_KEYS
    assert set(line["extra"]) == QUICK_EXTRA - {
        "train_clips_per_sec", "flops_per_clip_train", "train_mfu",
        "train_vs_baseline"}
    assert line["metric"] == "protoasnet_video_infer_clips_per_sec"
    assert line["unit"] == "clips/s" and line["value"] > 0
    # the ratio over BASELINE_MEASURED.json's CPU rate
    base = json.loads((REPO / "BASELINE_MEASURED.json").read_text())
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / base["torch_cpu_infer_clips_per_sec"], rel=1e-2)
    # no peak rate for a CPU
    assert line["mfu"] is None and line["extra"]["infer_mfu"] is None
    assert {k: v for k, v in out.items() if k != "launches"} == line
    assert set(out["launches"]) == {"a served", "b int8", "d image"}


def test_quick_with_train_has_every_key(quick):
    assert set(quick) - {"launches"} == LINE_KEYS
    assert set(quick["extra"]) == QUICK_EXTRA
    assert quick["extra"]["train_clips_per_sec"] > 0
    assert set(quick["launches"]) == {"a served", "b int8", "c train",
                                      "d image"}
    # launches count only on the card
    assert not any(quick["launches"].values())


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "-m", "protoasnet_tpu_torch.bench",
                        "--quick"], cwd=REPO, capture_output=True, text=True,
                       env=subprocess_env(), timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA is not available" in r.stderr


def test_criterion_is_the_root_bench_criterion():
    assert bench.CRITERION == JAX_CRITERION
    assert bench.EPOCH_CRITERION == {
        k: v for k, v in JAX_CRITERION.items()
        if k not in ("OrthogonalityLoss", "Lnorm_occurrence")}


def _strided_input_grad_excess(model, x1):
    """FLOPs a clip and pass that the JAX walker charges over torch's
    counter for the input gradients of the trunk's strided convs past the
    stem: (prod(stride) - 1) times each one's forward products."""
    excess, hooks = [], []

    def hook(m, args, out):
        k = int(np.prod(m.kernel_size)) * m.in_channels // m.groups
        excess.append((int(np.prod(m.stride)) - 1) * 2 * out.numel() * k)

    stem, *convs = [m for m in model.modules()
                    if isinstance(m, torch.nn.Conv3d)]
    assert stem.in_channels == 3  # the clip's: no input gradient in either
    for m in convs:
        if any(s > 1 for s in m.stride):
            hooks.append(m.register_forward_hook(hook))
    with torch.no_grad():
        model.compute_occurrence_map(x1)
    for h in hooks:
        h.remove()
    return sum(excess)


def _stem_difference(clip):
    """The JAX space-to-depth stem's (1,4,4) conv over 12 channels against
    the port's (1,7,7)/2 conv over 3, on the same (T, H/2, W/2, 45)
    output (tests/test_torch_port_flops.py)."""
    t, h, w, _ = clip
    out = t * (h // 2) * (w // 2) * 45
    return 2 * out * (12 * 4 * 4) - 2 * out * (3 * 7 * 7)


@pytest.mark.parametrize("which", ["fwd", "train"])
def test_flops_per_clip_equal_the_jax_count(small, quick, which):
    cfg = dict(bench.VIDEO)
    jm = jax_build_model(cfg)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(BATCH, *bench.CLIP)).astype(np.float32))
    params, stats = init_model(jm, x[:1], seed=0)
    stem = _stem_difference(bench.CLIP)
    if which == "fwd":
        ref = jax_count(lambda v, xc: jm.apply(v, xc, train=False)[0],
                        {"params": params, "batch_stats": stats}, x[:1])
        assert quick["extra"]["flops_per_clip_fwd"] == ref - stem
        return
    tx = make_adam(weight_decay_by_group={g: 1e-3 for g in JAX_GROUPS},
                   params=params)
    step, _, _ = make_xprotonet_steps(
        jm, JaxBundle(JAX_CRITERION, num_classes=4, abstain_class=True), tx,
        accumulation_steps=1, stage="all", donate=False,
        combine_transform=False)
    y = jnp.asarray(np.array([0, 2], np.int32))
    ref = jax_count(step, TrainState.create(params, stats, tx), x, y,
                    jnp.ones(BATCH, jnp.bool_), jax.random.PRNGKey(0),
                    {g: jnp.float32(1e-4) for g in JAX_GROUPS}) / BATCH
    # x and affine(x): two trunk passes, each stem forward and weight
    # gradient; each strided conv's input gradient
    tm = build_model(cfg, device="cpu")
    strided = _strided_input_grad_excess(
        tm, torch.zeros((1, *bench.CLIP)))
    assert strided > 0
    assert quick["extra"]["flops_per_clip_train"] == \
        ref - 2 * 2 * stem - 2 * strided


def test_first_train_step_loss_float64_equals_jax(small):
    """The bench's train micro-step (``make_train_step``) in float64 at
    the JAX weights against the root bench's JAX step."""
    cfg = dict(bench.VIDEO)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(BATCH, *bench.CLIP))
    y = rng.integers(0, 3, size=BATCH).astype(np.int32)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(True):
        jm = jax_build_model(cfg, dtype=jnp.float64)
        params, stats = init_model(jm, jnp.asarray(x[:1]), seed=0)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), jax.device_get(params))
        stats = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), jax.device_get(stats))
        # off-class readout weights (0 at init), so that L1(FC) counts
        kernel = params["last_layer"]["Dense_0"]["kernel"]
        params["last_layer"]["Dense_0"]["kernel"] = \
            kernel + rng.normal(scale=0.05, size=kernel.shape)
        tx = make_adam(weight_decay_by_group={g: 1e-3 for g in JAX_GROUPS},
                       params=params)
        step, _, _ = make_xprotonet_steps(
            jm, JaxBundle(JAX_CRITERION, num_classes=4, abstain_class=True),
            tx, accumulation_steps=1, stage="all", donate=False)
        _, metrics = step(TrainState.create(params, stats, tx),
                          jnp.asarray(x), jnp.asarray(y),
                          jnp.ones(BATCH, jnp.bool_), key,
                          {g: jnp.float64(1e-4) for g in JAX_GROUPS})
        ref = float(metrics["loss_all"])
        draw = tuple(float(a) for a in jax_affine_draw(key))
    tm = build_model(dict(cfg, dtype="float32"), device="cpu").double()
    load_jax_variables(tm, params, stats)
    got = bench.make_train_step(tm)[0](
        torch.from_numpy(x), torch.from_numpy(y).long(),
        torch.ones(BATCH, dtype=torch.bool), {g: 1e-4 for g in GROUPS},
        affine=draw)
    assert ref != 0.0
    assert abs(float(got["loss_all"]) - ref) <= 1e-7 * abs(ref)


def test_suite_writes_only_its_detail_file(small, tmp_path, monkeypatch,
                                           capsys):
    detail = REPO / "BENCH_DETAIL.json"
    before = detail.read_bytes()
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    out, line = _run(["--device", "cpu", "--suite", "--no-train",
                      "--no-int8", "--batch", str(BATCH), "--detail_out",
                      str(work / "detail.json")], capsys)
    assert sorted(os.listdir(work)) == ["detail.json"]
    assert detail.read_bytes() == before
    assert set(line["extra"]) >= SUITE_EXTRA - {
        "push_scan_marginal_clips_per_sec"}
    assert {"image_infer_imgs_per_sec_bf16",
            "image_infer_mfu"} <= set(line["extra"])
    written = json.loads((work / "detail.json").read_text())
    assert written["infer_clips_per_sec"] == line["value"]
    assert set(written) - {"infer_clips_per_sec"} == set(line["extra"])
    assert set(out["launches"]) == {"a served", "d image", "e push",
                                    "e train epoch", "e eval epoch",
                                    "e render"}
