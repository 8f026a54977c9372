"""Import hygiene of the port and its device policy.

Every module of ``protoasnet_tpu_torch`` (and ``chip_smoke.py``) imports
in a fresh interpreter without pulling in JAX, flax, msgpack,
scikit-learn or the JAX package (the card's machine has none of them),
and no source names one in an import statement; the entry points run on
CUDA unless the caller asks for the CPU, so without a card they raise
instead of carrying on on the CPU.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
       "num_classes": 4, "img_size": 32}

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import protoasnet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack",
                                    "sklearn", "protoasnet_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _run(args, cwd, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_imports_no_jax():
    proc = _run(["-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("ops.roi_cosine_cuda", "ops.l2_min_cuda", "ops.l2_min",
                 "ops.l2conv", "models.protopnet",
                 "models.backbones.resnet2d", "server", "ops.temporal_conv",
                 "ops.temporal_conv_cuda", "ops.fused_c2p1d",
                 "ops.fused_c2p1d_cuda", "experiments.common",
                 "experiments.temporal_conv", "experiments.fused_c2p1d",
                 "ops.affine_fast", "losses.losses", "losses.bundle",
                 "train.optim", "train.steps", "train.metrics",
                 "train.aggregate", "train.agents", "train.agents.base",
                 "train.agents.xprotonet", "train.agents.protopnet",
                 "push.receptive_field", "push.push_protopnet",
                 "data.intervals",
                 "data.manifest", "data.native", "data.synthetic",
                 "data.dataset", "push.push", "explain.render",
                 "tracking.trackers", "utils.io", "utils.run",
                 "models.pretrained", "main", "explain.local",
                 "explain.__main__", "serve", "models.from_jax",
                 "client", "utils.preprocess", "utils.profiling",
                 "utils.flops", "models.surgery", "models.migrate",
                 "train.device_metrics"):
        assert "protoasnet_tpu_torch." + name in out["modules"], name
    assert out["bad"] == []


FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "sklearn", "protoasnet_tpu")


def _imported_modules(path):
    """The module of every import statement in ``path`` (at any depth)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_name_no_jax():
    """No import statement of the port (at module level or inside a
    function) names a forbidden package; the port's own ``from_jax``
    module is its weight bridge and imports none of them."""
    for path in [REPO / "chip_smoke.py",
                 *sorted((REPO / "protoasnet_tpu_torch").rglob("*.py"))]:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_client_needs_only_the_standard_library_and_numpy():
    """A machine that only talks to the daemon needs nothing else."""
    mods = set(_imported_modules(REPO / "protoasnet_tpu_torch" / "client.py"))
    assert {m.split(".")[0] for m in mods} - set(sys.stdlib_module_names) \
        - {"__future__"} == {"numpy"}


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-card refusal cannot be shown")


def test_entry_points_refuse_without_cuda(tmp_path):
    _no_card()
    from protoasnet_tpu_torch.models.builder import build_model, example_input
    from protoasnet_tpu_torch.serve import (load_serving_bundle_with_spec,
                                            save_serving_bundle)
    from protoasnet_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example_input(CFG, {"img_size": 32, "frames": 8})
    model = build_model(CFG, device="cpu")
    path = str(tmp_path / "b.zip")
    save_serving_bundle(path, model, CFG, (8, 32, 32, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_serving_bundle_with_spec(path)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("cpu").type == "cpu"


def test_server_cli_refuses_without_cuda(tmp_path):
    _no_card()
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.serve import save_serving_bundle

    path = str(tmp_path / "b.zip")
    save_serving_bundle(path, build_model(CFG, device="cpu"), CFG,
                        (8, 32, 32, 3))
    proc = _run(["-m", "protoasnet_tpu_torch.server", "--bundle", path,
                 "--port", "0", "--no_warmup"], REPO)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_live_server_and_tune_refuse_without_cuda(tmp_path):
    """``serve_live``, the server's ``--run_dir`` and ``serve tune``
    without ``device="cpu"`` / ``--device cpu``: they raise before they
    load anything."""
    _no_card()
    from protoasnet_tpu_torch import server
    from protoasnet_tpu_torch.models.builder import build_model
    from protoasnet_tpu_torch.serve import save_serving_bundle, tune_bundle

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.serve_live(str(tmp_path), port=0)
    path = str(tmp_path / "b.zip")
    save_serving_bundle(path, build_model(CFG, device="cpu"), CFG,
                        (8, 32, 32, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tune_bundle(path, [1])
    for cmd in (["-m", "protoasnet_tpu_torch.server", "--run_dir",
                 str(tmp_path), "--port", "0"],
                ["-m", "protoasnet_tpu_torch.serve", "tune", "--bundle",
                 path, "--batches", "1"]):
        proc = _run(cmd, REPO)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr


def test_training_entry_point_refuses_without_cuda(tmp_path):
    """``protoasnet_tpu_torch.main`` without ``--device cpu``: it raises
    before it writes a run directory, called and as a command."""
    _no_card()
    from protoasnet_tpu_torch.main import main

    cfg = REPO / "protoasnet_tpu" / "configs" / "ours_protoasnet_video.yml"
    args = [f"--config_path={cfg}", f"--save_dir={tmp_path / 'run'}"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)
    assert not (tmp_path / "run").exists()
    proc = _run(["-m", "protoasnet_tpu_torch.main", *args], REPO)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_explain_and_export_refuse_without_cuda(tmp_path):
    """The explain and export entry points without ``--device cpu``: they
    raise, called and as commands, before they build anything."""
    _no_card()
    from protoasnet_tpu_torch.explain.__main__ import main as explain_main
    from protoasnet_tpu_torch.serve import load_trained_agent

    cfg = REPO / "protoasnet_tpu" / "configs" / "ours_protoasnet_video.yml"
    args = [f"--config_path={cfg}", f"--save_dir={tmp_path / 'run'}",
            "--explain_locally=true"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        explain_main(args)
    assert not (tmp_path / "run").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_trained_agent(str(tmp_path))
    for cmd in (["-m", "protoasnet_tpu_torch.explain", *args],
                ["-m", "protoasnet_tpu_torch.serve", "export", "--run_dir",
                 str(tmp_path), "--out", str(tmp_path / "b.zip")]):
        proc = _run(cmd, REPO)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
    assert not (tmp_path / "b.zip").exists()


EXPERIMENTS = ["protoasnet_tpu_torch.experiments.temporal_conv",
               "protoasnet_tpu_torch.experiments.fused_c2p1d"]


@pytest.mark.parametrize("module", EXPERIMENTS)
def test_experiment_runs_plain_on_cpu(module):
    """``--device cpu``: the plain version at the small size against the
    library sequence in float64, in both dtypes; the CLI as a user runs it
    too."""
    import importlib

    main = importlib.import_module(module).main
    for flag in ([], ["--bf16"] if "temporal" in module else ["--fp32"]):
        res = main(["--device", "cpu", *flag])
        assert res["device"] == "cpu" and res["rel_err"] <= res["tol"]
        assert "ms" not in res  # no device time from a CPU run
    proc = _run(["-m", module, "--device", "cpu"], REPO)
    assert proc.returncode == 0, proc.stderr
    assert "max abs err" in proc.stdout


@pytest.mark.parametrize("module", EXPERIMENTS)
def test_experiment_refuses_without_cuda(module):
    _no_card()
    import importlib

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        importlib.import_module(module).main([])
    proc = _run(["-m", module], REPO)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path, where):
    """No card: exit non-zero and print no result. A directory holding
    chip_smoke.py and nothing else of the repo: the same."""
    if where == "repo":
        _no_card()
        proc = _run([str(REPO / "chip_smoke.py")], REPO)
    else:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, "chip_smoke.py"],
                              cwd=str(tmp_path), env=env, capture_output=True,
                              text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
