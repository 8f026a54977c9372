"""The port's explanations against the JAX package's, on the CPU.

- ``collect_model_products`` of both packages at identical weights (video
  XProtoNet, 8 frames of 32x32, P=8, D=64, K=4 with abstain, fp32, random
  BN running stats, an off-class readout) over one synthetic loader (the
  same batches, one sample masked out): similarities, occurrence maps and
  logits at the forward parity tolerance (rtol 1e-3, atol 1e-4); targets,
  file names, clips and the readout kernel equal;
- ``latest_push_pickle``: the newest epoch by number, not by string, in
  both packages;
- ``get_sim_scores``: the same .npz name and arrays (similarities at the
  parity tolerance), and ``load_sim_scores`` reads them back;
- ``explain_local`` from the same cached products and prototype evidence
  writes the same file names as the JAX package's (panels and
  ``input_overlaid/``); the sanity report's mean F1 and confusion matrix
  equal scikit-learn's;
- ``python -m protoasnet_tpu_torch.explain --device cpu`` end to end on a
  tiny run trained by the port's ``main``: ``config_explain_test.yml``,
  ``explain_test/model_products.pickle``, top-k panels per sample, the
  global push; it refuses a run without a trained checkpoint.
"""

import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.explain import local as jax_local
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu.train.agents.xprotonet import \
    _XProtoNetAgentCommon as JaxCommon
from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
from protoasnet_tpu_torch.explain import local
from protoasnet_tpu_torch.explain.__main__ import main as explain_main
from protoasnet_tpu_torch.main import main as train_main
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import load_jax_variables
from protoasnet_tpu_torch.train.agents.xprotonet import \
    _XProtoNetAgentCommon as PortCommon
from torch_port_isolation import isolated, subprocess_env

_isolated = isolated(2)

REPO = Path(__file__).resolve().parents[1]
P, D, K = 8, 64, 4
CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (P, D, 1, 1, 1),
       "num_classes": K, "img_size": 32, "head_impl": "xla"}
RTOL, ATOL = 1e-3, 1e-4


def _random_stats(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(scale=0.2, size=v.shape).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)
    return out


def _batches(rng):
    """Three batches of 3 clips; the last sample of the last batch is
    padding (valid False)."""
    out = []
    for b in range(3):
        valid = np.array([True, True, b < 2])
        out.append({
            "cine": rng.normal(size=(3, 8, 32, 32, 3)).astype(np.float32),
            "valid": valid,
            "target_AS": rng.integers(0, 3, size=3).astype(np.int32),
            "filename": [f"clip_{b}_{i}.npy" for i in range(3)]})
    return out


@pytest.fixture(scope="module")
def agents(tmp_path_factory):
    """Stub agents of both packages over the same weights and batches:
    what ``collect_model_products``, ``get_sim_scores`` and
    ``explain_local`` read of an agent."""
    rng = np.random.default_rng(0)
    jm = jax_build_model(CFG)
    params, _ = init_model(jm, jnp.zeros((1, 8, 32, 32, 3)), seed=0)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    kernel = params["last_layer"]["Dense_0"]["kernel"]
    params["last_layer"]["Dense_0"]["kernel"] = (
        kernel + rng.normal(scale=0.05, size=kernel.shape)
    ).astype(np.float32)
    _, stats = init_model(jm, jnp.zeros((1, 8, 32, 32, 3)), seed=0)
    stats = _random_stats(jax.device_get(stats), rng)
    batches = _batches(rng)

    def jax_push(p, s, x):
        return jm.apply({"params": p, "batch_stats": s}, x, train=False,
                        method=jm.push_forward)

    root = tmp_path_factory.mktemp("explain")
    common = dict(abstain_class=True, current_epoch=3,
                  config={"explain_separate_overlays": True},
                  class_labels=["No AS", "Early AS", "Significant AS"])
    jax_agent = SimpleNamespace(
        params=params, batch_stats=stats, push_step=jax.jit(jax_push),
        data_loaders={"test": batches}, save_dir=str(root / "jax"),
        **common)
    tm = build_model(CFG, device="cpu")
    load_jax_variables(tm, params, stats)
    tm.eval()
    port_batches = [{**b, "cine": torch.from_numpy(b["cine"])}
                    for b in batches]
    port_agent = SimpleNamespace(
        model=tm, push_step=tm.push_forward,
        data_loaders={"test": port_batches}, save_dir=str(root / "port"),
        **common)
    return jax_agent, port_agent


@pytest.fixture(scope="module")
def products(agents):
    jax_agent, port_agent = agents
    return (jax_local.collect_model_products(jax_agent, "test"),
            local.collect_model_products(port_agent, "test"))


@pytest.mark.parametrize("key", ["similarities", "occurrence_maps",
                                 "logits"])
def test_products_match_the_jax_package(products, key):
    ref, got = products
    assert got[key].shape == ref[key].shape
    assert got[key].shape[0] == 8  # the padding sample is dropped
    np.testing.assert_allclose(got[key], np.asarray(ref[key], np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("key", ["targets", "filenames", "clips",
                                 "fc_kernel"])
def test_products_metadata_equal(products, key):
    ref, got = products
    np.testing.assert_array_equal(got[key], ref[key])
    assert set(got) == set(ref)


@pytest.mark.parametrize("dirs, want", [
    (["epoch-9_pushed", "epoch-10_pushed", "epoch-2_pushed"],
     "epoch-10_pushed"),
    (["epoch-10", "epoch-9_pushed", "epoch-11_pushed"], "epoch-10"),
    (["epoch-100_pushed", "epoch-99_pushed", "notes"], "epoch-100_pushed"),
    ([], None)])
def test_latest_push_pickle_sorts_epochs_by_number(tmp_path, dirs, want):
    for i, d in enumerate(dirs):
        os.makedirs(tmp_path / d)
        if not d.startswith("epoch-11"):  # a push dir without its pickle
            (tmp_path / d / "prototypes_info.pickle").write_bytes(b"x")
    got = local.latest_push_pickle(str(tmp_path))
    assert got == jax_local.latest_push_pickle(str(tmp_path))
    assert got == (None if want is None else str(
        tmp_path / want / "prototypes_info.pickle"))
    assert local.latest_push_pickle(str(tmp_path / "none")) is None


def test_sim_scores_match_the_jax_package(agents):
    jax_agent, port_agent = agents
    JaxCommon.get_sim_scores(jax_agent, mode="test")
    path = PortCommon.get_sim_scores(port_agent, mode="test")
    name = "sim_scores_test_epoch3.npz"
    assert os.path.basename(path) == name
    ref = np.load(os.path.join(jax_agent.save_dir, "ranking_prototypes",
                               name))
    got = np.load(path)
    assert set(got.files) == set(ref.files) == {"sim_scores", "targets"}
    np.testing.assert_allclose(got["sim_scores"], ref["sim_scores"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got["targets"], ref["targets"])
    sims, targets = PortCommon.load_sim_scores(port_agent, 3, "test")
    np.testing.assert_array_equal(sims, got["sim_scores"])
    np.testing.assert_array_equal(targets, got["targets"])


def _proto_info(rng):
    """Prototype evidence in the push's schema: (3, T, H, W) clips and
    (1, T', H', W') occurrence maps."""
    return {"prototypes_src_imgs": rng.normal(
                size=(P, 3, 8, 32, 32)).astype(np.float32),
            "prototypes_occurrence_maps": rng.uniform(
                size=(P, 1, 4, 2, 2)).astype(np.float32)}


def _files(root):
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _, fs in os.walk(root) for f in fs)


def test_explain_local_writes_the_jax_file_names(agents, products):
    """The same cached products and prototype evidence in both run dirs:
    the same panels and standalone overlays, by name."""
    jax_agent, port_agent = agents
    _, prod = products
    info = _proto_info(np.random.default_rng(4))
    for a in (jax_agent, port_agent):
        for path, obj in (
                (("img", "epoch-3_pushed", "prototypes_info.pickle"), info),
                (("explain_test", "model_products.pickle"), prod)):
            os.makedirs(os.path.join(a.save_dir, *path[:-1]), exist_ok=True)
            with open(os.path.join(a.save_dir, *path), "wb") as f:
                pickle.dump(obj, f)
    jax_local.explain_local(jax_agent, mode="test")
    summary = local.explain_local(port_agent, mode="test")
    got = _files(os.path.join(port_agent.save_dir, "explain_test"))
    assert got == _files(os.path.join(jax_agent.save_dir, "explain_test"))
    panels = [f for f in got if "_rank" in f]
    assert summary["samples"] == 8 and summary["panels"] == 3 * 8
    assert len({f.split(".")[0] for f in panels}) == 3 * 8
    assert len([f for f in got if f.startswith("input_overlaid")]) >= 8
    assert summary["sweep_s"] == 0.0  # the products came from the cache

    from sklearn.metrics import confusion_matrix, f1_score

    y = prod["targets"]
    pred = prod["logits"][:, :K - 1].argmax(axis=1)
    assert summary["sanity"]["f1_mean"] == pytest.approx(
        f1_score(y, pred, average="macro", zero_division=0), abs=1e-12)
    np.testing.assert_array_equal(summary["sanity"]["confusion"],
                                  confusion_matrix(y, pred))


def test_panels_without_evidence_for_an_unfound_prototype(agents, products,
                                                          tmp_path):
    """A prototype the push found no sample for (an empty entry in the
    pickle) still gets its panel, without the prototype's half."""
    _, port_agent = agents
    _, prod = products
    info = _proto_info(np.random.default_rng(5))
    imgs = np.empty(P, dtype=object)
    occs = np.empty(P, dtype=object)
    for j in range(P):
        imgs[j] = info["prototypes_src_imgs"][j] if j else np.zeros(0)
        occs[j] = info["prototypes_occurrence_maps"][j] if j else None
    agent = SimpleNamespace(**{**vars(port_agent),
                               "save_dir": str(tmp_path)})
    os.makedirs(tmp_path / "img" / "epoch-1_pushed")
    with open(tmp_path / "img" / "epoch-1_pushed" / "prototypes_info.pickle",
              "wb") as f:
        pickle.dump({"prototypes_src_imgs": imgs,
                     "prototypes_occurrence_maps": occs}, f)
    os.makedirs(tmp_path / "explain_test")
    with open(tmp_path / "explain_test" / "model_products.pickle", "wb") as f:
        pickle.dump(prod, f)
    summary = local.explain_local(agent, mode="test")
    assert summary["panels"] == 3 * 8


# ---------------- the command line ----------------

TRAIN = ("--data.img_size=32", "--data.frames=8", "--data.eval_batch_size=4",
         "--model.prototype_shape=(8, 64, 1, 1, 1)", "--model.dtype=float32",
         "--train.batch_size=2", "--data.num_workers=1")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    csv = make_synthetic_dataset(str(root / "data"), num_videos=12, seed=3)
    cfg = REPO / "protoasnet_tpu" / "configs" / "ours_protoasnet_video.yml"
    args = [f"--config_path={cfg}", f"--save_dir={root / 'runs'}",
            "--device", "cpu", f"--data.data_info_file={csv}", *TRAIN]
    agent = train_main(args + ["--train.num_train_epochs=1",
                               "--train.push_start=0",
                               "--train.push_rate=1"])
    yield dict(args=args, run=Path(agent.save_dir), root=root)
    shutil.rmtree(root, ignore_errors=True)


def test_explain_cli_end_to_end(trained):
    env = subprocess_env(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "protoasnet_tpu_torch.explain",
         *trained["args"], "--explain_locally=true",
         "--explain_globally=true", "--eval_data_type=test"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    run = trained["run"]
    assert (run / "config_explain_test.yml").exists()
    with open(run / "explain_test" / "model_products.pickle", "rb") as f:
        prod = pickle.load(f)
    n = len(prod["similarities"])
    assert n and prod["clips"].shape == (n, 8, 32, 32, 3)
    assert np.isfinite(prod["logits"]).all()
    panels = {f.split(".")[0] for f in os.listdir(run / "explain_test")
              if "_rank" in f}
    assert len(panels) == 3 * n
    log = (run / "info_explain_test.log").read_text()
    assert "explain sanity check" in log
    assert "Checkpoint (torch) loaded" in log
    # the global explanation: a push without replacement at the run's epoch
    assert (run / "img" / "epoch-0_pushed" / "prototypes_info.pickle"
            ).exists()


def test_explain_in_process_matches_a_second_sweep(trained):
    """``main`` returns the agent and the local summary; the cached
    products equal a fresh sweep of the same agent."""
    out = explain_main([*trained["args"], "--explain_locally=true",
                        "--eval_data_type=val"])
    agent, summary = out["agent"], out["local"]
    assert summary["panels"] == 3 * summary["samples"]
    assert summary["sweep_s"] > 0.0
    with open(trained["run"] / "explain_val" / "model_products.pickle",
              "rb") as f:
        cached = pickle.load(f)
    fresh = local.collect_model_products(agent, "val")
    for key in ("similarities", "logits", "occurrence_maps"):
        np.testing.assert_array_equal(cached[key], fresh[key])


def test_explain_refuses_untrained_weights(trained, tmp_path):
    args = [a for a in trained["args"] if not a.startswith("--save_dir")]
    with pytest.raises(RuntimeError, match="no trained checkpoint"):
        explain_main([*args, f"--save_dir={tmp_path}",
                      "--explain_locally=true", "--eval_data_type=test"])
    assert not list(tmp_path.rglob("explain_test"))
