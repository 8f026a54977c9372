"""The port's training entry point on the CPU, at a tiny size: the video
flagship config (``Video_XProtoNet_e2e``) cut to 8 frames of 32x32, P=8,
D=64, fp32, on the synthetic fixture.

``python -m protoasnet_tpu_torch.main --device cpu`` trains one epoch,
validates, pushes (without and with replacement), validates the pushed
model and writes the checkpoint; a second run with the same seed in this
process gives the same checkpoint bit for bit; a third run on the first
run's directory resumes from its ``last.ckpt``.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
from protoasnet_tpu_torch.main import main
from protoasnet_tpu_torch.utils.io import load_checkpoint
from torch_port_isolation import isolated, removed_after, subprocess_env

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "protoasnet_tpu" / "configs" / "ours_protoasnet_video.yml"


_isolated = isolated(2)


def _args(csv, save_dir, epochs=1):
    return [f"--config_path={CONFIG}", f"--save_dir={save_dir}",
            "--device", "cpu", f"--data.data_info_file={csv}",
            "--data.img_size=32", "--data.frames=8",
            "--data.eval_batch_size=4", "--data.num_workers=2",
            "--model.prototype_shape=(8, 64, 1, 1, 1)",
            "--model.dtype=float32", "--train.batch_size=2",
            "--train.accumulation_steps=2",
            f"--train.num_train_epochs={epochs}",
            "--train.num_warm_epochs=0", "--train.push_start=0",
            "--train.push_rate=1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("agent")
    csv = make_synthetic_dataset(str(root / "data"), num_videos=12, seed=3)
    env = subprocess_env(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    cli = subprocess.run(
        [sys.executable, "-m", "protoasnet_tpu_torch.main",
         *_args(csv, root / "a")], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=600)
    assert cli.returncode == 0, cli.stderr[-4000:]
    agent = main(_args(csv, root / "b"))
    with removed_after(root):
        yield dict(csv=csv, root=root, a=root / "a" / "ours_protoasnet_video",
                b=root / "b" / "ours_protoasnet_video", agent=agent)


def test_cli_trains_validates_pushes_and_checkpoints(runs):
    run = runs["a"]
    for name in ("last.ckpt", "model_best.ckpt", "metrics.jsonl",
                 "config_train.yml"):
        assert (run / name).exists(), name
    info = run / "img" / "epoch-0_pushed" / "prototypes_info.pickle"
    assert info.exists()
    rows = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    losses = [v for r in rows for k, v in r.items() if "loss" in k]
    assert losses and all(v == v and abs(v) < 1e6 for v in losses)
    modes = {k.split("/")[1] for r in rows for k in r
             if k.startswith("epoch/")}
    assert {"train", "val", "val_push"} <= modes
    assert list((run / "csv_val_push").glob("*_video_level.csv"))
    ckpt = load_checkpoint(str(run / "last.ckpt"))
    assert set(ckpt) == {"epoch", "iteration", "model", "optimizer",
                         "accumulator", "scheduler", "best_metric"}
    assert ckpt["iteration"] == 4  # 8 training clips at batch 2
    # two accumulated Adam steps, taken by every parameter
    steps = {float(s["step"]) for s in ckpt["optimizer"]["state"].values()}
    assert steps == {2.0}


def test_two_seeded_runs_are_equal(runs):
    a = load_checkpoint(str(runs["a"] / "last.ckpt"))
    b = load_checkpoint(str(runs["b"] / "last.ckpt"))
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert a["best_metric"] == b["best_metric"]


def test_resume_from_last_checkpoint(runs):
    """The same save_dir with two epochs: ``last.ckpt`` is loaded (the
    iteration count goes on from the first run's) and training continues."""
    agent = main(_args(runs["csv"], runs["root"] / "b", epochs=2))
    assert agent.save_dir == str(runs["b"])
    ckpt = load_checkpoint(str(runs["b"] / "last.ckpt"))
    assert ckpt["epoch"] == 1
    assert ckpt["iteration"] > runs["agent"].current_iteration
    log = (runs["b"] / "info_train.log").read_text()
    assert "auto-resume from" in log
