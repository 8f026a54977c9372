"""The port's prototype push against the JAX package's on the synthetic
fixture, at identical weights (video XProtoNet, 8 frames of 32x32, P=8,
D=64, K=4 with abstain, fp32, random BN running stats).

Both scan the same push loader (the same uint8 windows, no augmentation):
the winners (file, class, batch position) must be equal, and the winners'
numbers within the forward parity tolerance of
``tests/test_torch_port_model.py`` (rtol 1e-3, atol 1e-4). The pickle has
the JAX package's keys, shapes and dtypes.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.data.dataset import get_as_dataloader as j_loader
from protoasnet_tpu.data.synthetic import make_synthetic_dataset
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu.push.push import push_prototypes as j_push
from protoasnet_tpu_torch.data.dataset import get_as_dataloader
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import load_jax_variables
from protoasnet_tpu_torch.models.layers import prototype_class_identity
from protoasnet_tpu_torch.push.push import batch_winners, push_prototypes
from torch_port_isolation import isolated

_isolated = isolated(1)

P, D, K = 8, 64, 4
CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (P, D, 1, 1, 1),
       "num_classes": K, "img_size": 32, "head_impl": "xla"}


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


@pytest.fixture(scope="module")
def pushed(tmp_path_factory):
    root = tmp_path_factory.mktemp("push")
    csv = make_synthetic_dataset(str(root / "data"), num_videos=14, seed=2)
    dcfg = {"data_info_file": csv, "view": "all", "sampler": "AS",
            "augmentation": False, "normalize": True, "img_size": 32,
            "frames": 8, "batch_size": 2, "push_batch_size": 3,
            "iterate_intervals": True, "interval_unit": "cycle",
            "interval_quant": 1.0}
    rng = np.random.default_rng(0)
    jm = jax_build_model(CFG)
    params, stats = init_model(jm, jnp.zeros((1, 8, 32, 32, 3)), seed=0)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    stats = _random_stats(jax.device_get(stats), rng)
    push_step = jax.jit(lambda p, s, c: jm.apply(
        {"params": p, "batch_stats": s}, c, method=jm.push_forward))
    j_params, j_info = j_push(
        j_loader(dcfg, "train", "push", seed=0), push_step, params, stats,
        class_identity=jm.class_identity(), abstain_class=True,
        root_dir_for_saving_prototypes=str(root / "jax"), epoch_number=0,
        render=False)

    tm = build_model(CFG, device="cpu")
    load_jax_variables(tm, params, stats)
    t_vectors, t_info = push_prototypes(
        get_as_dataloader(dcfg, "train", "push", seed=0, device="cpu"),
        lambda c: tm.push_forward(c), tm.prototype_vectors.detach(),
        class_identity=prototype_class_identity(P, K), abstain_class=True,
        root_dir_for_saving_prototypes=str(root / "port"), epoch_number=0,
        render=True)
    return dict(j_params=j_params, j_info=j_info, t_vectors=t_vectors,
                t_info=t_info, root=root, before=params["prototype_vectors"])


def test_winners_match_jax(pushed):
    j, t = pushed["j_info"], pushed["t_info"]
    np.testing.assert_array_equal(t["prototypes_filenames"],
                                  j["prototypes_filenames"])
    np.testing.assert_array_equal(t["prototypes_gts"], j["prototypes_gts"])
    assert (t["prototypes_filenames"] != "").all()  # every one matched
    for k in ("prototypes_preds", "prototypes_similarity_to_src_ROIs",
              "prototypes_occurrence_maps", "prototypes_src_imgs"):
        np.testing.assert_allclose(np.asarray(t[k], np.float64),
                                   np.asarray(j[k], np.float64),
                                   rtol=1e-3, atol=1e-4, err_msg=k)


def test_abstain_prototypes_are_not_class_specific(pushed):
    """Class prototypes win only on their own class; the abstain ones
    (the last P/K) on any."""
    gts = pushed["t_info"]["prototypes_gts"]
    own = np.argmax(prototype_class_identity(P, K), axis=1)
    per = P // K
    assert (gts[:-per] == own[:-per]).all()
    assert ((gts[-per:] >= 0) & (gts[-per:] < K - 1)).all()


def test_replaced_vectors_match_jax(pushed):
    ref = np.asarray(pushed["j_params"]["prototype_vectors"])
    got = pushed["t_vectors"].numpy()
    assert not np.allclose(got, pushed["before"])
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_pickle_schema_matches_jax(pushed):
    root = pushed["root"]
    with open(root / "jax" / "epoch-0" / "prototypes_info.pickle",
              "rb") as f:
        j = pickle.load(f)
    with open(root / "port" / "epoch-0" / "prototypes_info.pickle",
              "rb") as f:
        t = pickle.load(f)
    assert set(t) == set(j)
    for k in j:
        assert np.asarray(t[k]).shape == np.asarray(j[k]).shape, k
        assert np.asarray(t[k]).dtype == np.asarray(j[k]).dtype, k
    assert t["prototypes_src_imgs"].shape[1:] == (3, 8, 32, 32)
    renders = os.listdir(root / "port" / "epoch-0")
    assert sum(f.endswith(".mp4") for f in renders) == P


def test_batch_winners_masks_and_ties():
    """A masked-out batch row never wins; ties go to the first row, as
    ``jnp.argmin``; the class mask applies to class-specific prototypes
    only."""
    dist = torch.tensor([[0.5, 0.2], [0.1, 0.2], [0.0, 0.0]])
    occ = torch.arange(3 * 2 * 2, dtype=torch.float32).reshape(3, 2, 2)
    roi = torch.arange(3 * 2 * 3, dtype=torch.float32).reshape(3, 2, 3)
    gt = torch.tensor([0, 0, 1])
    valid = torch.tensor([True, True, False])
    best, idx, w_roi, w_occ = batch_winners(
        dist, occ, roi, gt, valid, torch.tensor([0, 1]),
        torch.tensor([True, False]))
    assert idx.tolist() == [1, 0]
    assert best.tolist() == pytest.approx([0.1, 0.2])
    assert torch.equal(w_roi[0], roi[1, 0]) and torch.equal(w_occ[1],
                                                             occ[0, :, 1])
