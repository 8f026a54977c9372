"""The port's data parallelism (``protoasnet_tpu_torch/parallel/``) on two
CPU ranks against one process and the JAX package.

Two processes spawned with ``torch.multiprocessing`` join a gloo group
through a ``FileStore`` and run ``tests/torch_parallel_driver.py``'s
scenarios on their rows of the global batches; this process runs the same
scenarios without a group (the single-process port) and the JAX package's
own train step on one device. The model is the tiny flagship of
``tests/test_multiprocess.py`` (8 frames of 32x32, P=8, D=64, K=4; its
global batches from numpy seeds 17 and 23) with the JAX package's initial
weights (``models/from_jax.py``; the readout's off-class weights moved
off 0), trained on every loss term, the batch-free orthogonality and L1
terms too. Held:

- the world-2 step-1 loss within rtol 2e-5 of the JAX package's
  single-process step, the step-2 loss within 1e-3 (Adam's first step,
  lr * sign(g), amplifies the last bits of the gradient sum, as
  ``tests/test_multiprocess.py`` allows), the padded batch's loss within
  2e-5 and different from the full batch's;
- FSDP2's step-1 loss equal to the data-parallel one (rtol 2e-5), its
  placement the JAX package's rule, its Adam state saved as full tensors
  equal to the data-parallel one's, which loads into FSDP2 and saves back
  bit for bit;
- in float64, the gradients summed across ranks (the accumulator's saved
  partial sum) within 1e-10 of each tensor's max |g| of the single-process
  port's, the BN running statistics within 1e-12, an accumulation saved
  and resumed updating as one process does (1e-10), and both ranks'
  parameters bit-identical after the step; ProtoPNet (the L2 head) the
  same way;
- the push: winners, file names and similarities of the single-process
  push; one agent epoch: the same summary rows and one run directory with
  one ``last.ckpt``; the explain entry point's products on that run equal
  to one process's;
- ``make_sharded_serving_fn`` over two CPU devices bit-equal to one, and
  ``serve_live``'s buckets multiples of the device count.

The bring-up is held too: no process group without the launcher's
variables, and a raise (not a fallback) when one is requested and cannot
be joined.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_driver as drv
from protoasnet_tpu.losses.bundle import LossBundle as JaxBundle
from protoasnet_tpu.losses.losses import (
    sample_affine_params as jax_affine_draw)
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu.train.optim import GROUPS, make_adam
from protoasnet_tpu.train.steps import TrainState, make_xprotonet_steps
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import load_jax_variables
from protoasnet_tpu_torch.parallel import mesh
from torch_port_isolation import isolated, removed_after

_isolated = isolated(1)

WORLD = 2
JOIN_S = 600  # a rank that hangs fails the test, far inside the run's limit


def _jax_steps(params, stats):
    """The JAX package's train step on one device: step-1 and step-2
    losses on the global batch and the padded batch's step-1 loss."""
    model = jax_build_model(drv.CFG)
    tx = make_adam(weight_decay_by_group={g: drv.WD for g in GROUPS},
                   params=params)
    step, _, _ = make_xprotonet_steps(
        model, JaxBundle(drv.CRITERION, num_classes=drv.K,
                         abstain_class=True), tx, accumulation_steps=1,
        stage="all", donate=False)
    lrs = {g: jnp.float32(drv.LR) for g in GROUPS}
    state = TrainState.create(params, stats, tx)
    x, y, v = (jnp.asarray(a) for a in drv.global_batch())
    st, m1 = step(state, x, y, v, jax.random.PRNGKey(0), lrs)
    _, m2 = step(st, x, y, v, jax.random.PRNGKey(1), lrs)
    xp, yp, vp = (jnp.asarray(a) for a in drv.padded_global_batch())
    _, mp_ = step(state, xp, yp, vp, jax.random.PRNGKey(0), lrs)
    return (float(m1["loss_all"]), float(m2["loss_all"]),
            float(mp_["loss_all"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results beside this process's references."""
    from protoasnet_tpu_torch.data.dataset import get_as_dataloader
    from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset

    tmp = tmp_path_factory.mktemp("parallel")
    csv = make_synthetic_dataset(str(tmp / "data"), num_videos=12, seed=3)
    for split in ("train", "val", "test"):  # the packed stores, once
        get_as_dataloader({"data_info_file": csv, "batch_size": 4,
                           "frames": 8, "img_size": 32}, split, "val",
                          device="cpu")
    x = drv.global_batch()[0]
    params, stats = jax.device_get(init_model(
        jax_build_model(drv.CFG), jnp.asarray(x[:1]), seed=0))
    # off-class readout weights (0 at init), so that L1(FC) is not 0
    kernel = params["last_layer"]["Dense_0"]["kernel"]
    params["last_layer"]["Dense_0"]["kernel"] = kernel + np.random.default_rng(
        11).normal(scale=0.05, size=kernel.shape).astype(np.float32)
    tm = load_jax_variables(build_model(drv.CFG, device="cpu"), params,
                            stats)
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    torch.save(sd, tmp / "weights.pt")
    draws = [tuple(float(a) for a in jax_affine_draw(jax.random.PRNGKey(k)))
             for k in (0, 1)]
    inputs = {"weights": str(tmp / "weights.pt"), "draws": draws,
              "csv": csv}

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=drv.run_rank, args=(
        r, WORLD, str(tmp / "store"), str(tmp),
        dict(inputs, push_root=str(tmp / "push_w2"),
             agent_dir=str(tmp / "agent_w2")))) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # the references, while the ranks run
        ref = {"jax": _jax_steps(params, stats),
               "xprotonet": drv.xprotonet_steps(sd, draws),
               "float64": drv.float64_step(sd, draws),
               "ppnet": drv.ppnet_step(),
               "push": drv.push(sd, csv, str(tmp / "push_w1"))}
        drv.agent_epoch(csv, str(tmp / "agent_w1"))
        for p in procs:
            p.join(JOIN_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD, \
        f"rank exit codes {[p.exitcode for p in procs]}"
    # the world-2 run explained in one process, from a copy without its
    # cached products
    shutil.copytree(tmp / "agent_w2", tmp / "explain_w1")
    for d in (tmp / "explain_w1").glob("*/explain_test"):
        shutil.rmtree(d)
    drv.explain(csv, str(tmp / "explain_w1"))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    with removed_after(tmp):
        yield {"ref": ref, "ranks": ranks, "tmp": tmp}


# ---------------- bring-up ----------------


def test_no_launcher_no_group(monkeypatch):
    for var in ("WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.distributed_requested() is False
    assert mesh.maybe_initialize_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    assert (mesh.world_size(), mesh.rank(), mesh.is_main()) == (1, 0, True)


def test_requested_group_that_fails_raises(monkeypatch):
    """A requested run whose group cannot be joined raises instead of
    running on as an independent single process."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    assert mesh.distributed_requested() is True
    calls = []

    def boom(backend, *a, **k):
        calls.append(backend)
        raise RuntimeError("connection refused")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="refusing to fall back"):
        mesh.maybe_initialize_distributed("cpu")
    assert calls == ["gloo"]  # gloo on the CPU
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.local_device("cuda") == torch.device("cuda", 3)
    assert mesh.local_device("cpu") == torch.device("cpu")


def test_batch_sizes_round_to_the_ranks():
    from protoasnet_tpu_torch.train.agents.base import \
        resolve_loader_batch_sizes

    out = resolve_loader_batch_sizes({"frames": 32}, {"batch_size": 5}, 2)
    assert (out["batch_size"], out["push_batch_size"]) == (6, 32)
    assert "eval_batch_size" not in out  # video eval rides the train batch
    out = resolve_loader_batch_sizes({"frames": 1}, {"batch_size": 20}, 4)
    assert (out["batch_size"], out["eval_batch_size"]) == (20, 152)
    one = resolve_loader_batch_sizes({"frames": 32, "eval_batch_size": 7},
                                     {"batch_size": 5}, 1)
    assert (one["batch_size"], one["eval_batch_size"],
            one["push_batch_size"]) == (5, 7, 7)


def test_fsdp_placement_rule():
    model = build_model(drv.CFG, device="cpu")
    plan = mesh.fsdp_placements(model, 2, min_size=1 << 10)
    for name, p in model.named_parameters():
        dim = plan[name]
        if dim is None:
            assert p.numel() < (1 << 10) or all(d % 2 for d in p.shape)
        else:
            assert p.shape[dim] % 2 == 0
            assert p.shape[dim] == max(d for d in p.shape if d % 2 == 0)
    assert any(d is not None for d in plan.values())
    assert any(d is None for d in plan.values())


# ---------------- the train step ----------------


def test_ranks_report_the_same_global_loss(runs):
    a, b = (r["xprotonet"] for r in runs["ranks"])
    for key in ("loss", "loss2", "pad_loss"):
        assert a[key] == b[key], key


def test_step_losses_match_jax_single_process(runs):
    ours = runs["ranks"][0]["xprotonet"]
    loss1, loss2, pad = runs["ref"]["jax"]
    np.testing.assert_allclose(ours["loss"], loss1, rtol=2e-5)
    np.testing.assert_allclose(ours["loss2"], loss2, rtol=1e-3)
    np.testing.assert_allclose(ours["pad_loss"], pad, rtol=2e-5)
    assert abs(ours["pad_loss"] - ours["loss"]) > 1e-6


def test_step_matches_single_process_port(runs):
    ours, one = runs["ranks"], runs["ref"]["xprotonet"]
    np.testing.assert_allclose(ours[0]["xprotonet"]["loss"], one["loss"],
                               rtol=2e-5)
    logits = torch.cat([r["xprotonet"]["logits"] for r in ours])
    np.testing.assert_allclose(logits.numpy(), one["logits"].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_fsdp_step_equals_data_parallel(runs):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["fsdp"]["loss"], r["xprotonet"]["loss"],
                                   rtol=2e-5)
    fsdp = runs["ranks"][0]["fsdp"]
    assert set(fsdp["adam"]) == set(fsdp["dp_adam"])
    for i, dp in fsdp["dp_adam"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            got = fsdp["adam"][i][k]
            assert type(got) is torch.Tensor  # full, not a DTensor
            np.testing.assert_allclose(got.numpy(), dp[k].numpy(),
                                       rtol=1e-5, atol=1e-12)
            # DP's state loaded into FSDP2 (sharded again) and saved back
            assert torch.equal(fsdp["reloaded"][i][k], dp[k])


def test_float64_gradients_match_single_process(runs):
    """The accumulator's saved partial sum is the global batch's."""
    one = runs["ref"]["float64"]["saved"]
    for r in runs["ranks"]:
        got = r["float64"]["saved"]
        assert got["count"] == one["count"] == 1
        assert len(got["grads"]) == len(one["grads"])
        for i, (a, g) in enumerate(zip(got["grads"], one["grads"])):
            scale = g.abs().max().item()
            err = (a - g).abs().max().item()
            assert err <= 1e-10 * scale + 1e-300, (i, err, scale)


def test_resumed_accumulation_matches_single_process(runs):
    """A run saved in the middle of an accumulation and resumed: the
    update equals one process's."""
    one = runs["ref"]["float64"]["resumed"]
    before = runs["ref"]["float64"]["state"]
    for r in runs["ranks"]:
        got = r["float64"]["resumed"]
        moved = 0
        for k, v in one.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-10, err_msg=k)
            moved += "running_" not in k and not torch.equal(v, before[k])
        assert moved > 0


def test_float64_bn_statistics_match_single_process(runs):
    one = runs["ref"]["float64"]["state"]
    got = runs["ranks"][0]["float64"]["state"]
    names = [k for k in one if "running_" in k]
    assert names
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), one[k].numpy(),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(runs["ranks"][0]["float64"]["loss"],
                               runs["ref"]["float64"]["loss"], rtol=1e-12)


def test_replicas_bit_identical_after_the_step(runs):
    a, b = (r["float64"]["after"] for r in runs["ranks"])
    before = runs["ref"]["float64"]["state"]
    moved = 0
    for k in a:
        assert torch.equal(a[k], b[k]), k
        moved += not torch.equal(a[k], before[k])
    assert moved > 0


def test_protopnet_step_matches_single_process(runs):
    one = runs["ref"]["ppnet"]
    for r in runs["ranks"]:
        got = r["ppnet"]
        for k, v in one["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, rtol=1e-12,
                                       atol=1e-15, err_msg=k)
        for name, g in one["grads"].items():
            scale = g.abs().max().item()
            err = (got["grads"][name] - g).abs().max().item()
            assert err <= 1e-10 * scale + 1e-300, (name, err, scale)
        for k in (k for k in one["state"] if "running_" in k):
            np.testing.assert_allclose(got["state"][k].numpy(),
                                       one["state"][k].numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=k)


# ---------------- push, agent ----------------


def test_sharded_push_equals_single_process(runs):
    one = runs["ref"]["push"]
    for r in runs["ranks"]:
        got = r["push"]
        np.testing.assert_array_equal(got["info"]["prototypes_filenames"],
                                      one["info"]["prototypes_filenames"])
        np.testing.assert_array_equal(got["info"]["prototypes_gts"],
                                      one["info"]["prototypes_gts"])
        np.testing.assert_allclose(
            got["info"]["prototypes_similarity_to_src_ROIs"],
            one["info"]["prototypes_similarity_to_src_ROIs"], rtol=1e-5)
        np.testing.assert_allclose(got["vectors"].numpy(),
                                   one["vectors"].numpy(), rtol=1e-5,
                                   atol=1e-6)
    # rank 0 alone wrote the pickle
    assert os.path.exists(runs["tmp"] / "push_w2" / "epoch-0" /
                          "prototypes_info.pickle")


def _epoch_rows(root):
    (run,) = [d for d in os.listdir(root)]
    rows = [json.loads(line) for line in
            open(os.path.join(root, run, "metrics.jsonl"))]
    return run, [{k: v for k, v in r.items() if k != "_t"} for r in rows]


def test_agent_epoch_equals_single_process(runs):
    tmp = runs["tmp"]
    run1, rows1 = _epoch_rows(tmp / "agent_w1")
    run2, rows2 = _epoch_rows(tmp / "agent_w2")  # one run dir: rank 0's
    assert run1 == run2
    assert [sorted(r) for r in rows2] == [sorted(r) for r in rows1]
    for r1, r2 in zip(rows1, rows2):
        for k, v in r1.items():
            np.testing.assert_allclose(r2[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    files = os.listdir(tmp / "agent_w2" / run2)
    assert files.count("last.ckpt") == 1
    ckpt = torch.load(tmp / "agent_w2" / run2 / "last.ckpt",
                      weights_only=False)
    assert ckpt["epoch"] == 0


def test_explain_sweep_equals_single_process(runs):
    from protoasnet_tpu_torch.utils.io import load_pickle

    tmp = runs["tmp"]
    (two,) = (tmp / "agent_w2").glob("*/explain_test/model_products.pickle")
    (one,) = (tmp / "explain_w1").glob("*/explain_test/model_products.pickle")
    two, one = load_pickle(str(two)), load_pickle(str(one))
    assert list(two["filenames"]) == list(one["filenames"])
    np.testing.assert_array_equal(two["targets"], one["targets"])
    for k in ("similarities", "logits", "occurrence_maps", "clips"):
        assert two[k].shape == one[k].shape, k
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    (run,) = (tmp / "agent_w2").glob("*/explain_test")
    assert len(list(run.glob("*_rank0_p*"))) == len(one["filenames"])


# ---------------- serving ----------------


def test_sharded_serving_bit_equal_to_one_device():
    from protoasnet_tpu_torch.serve import (make_serving_fn,
                                            make_sharded_serving_fn)

    model = build_model(drv.CFG, device="cpu").eval()
    x = np.random.default_rng(5).normal(
        size=(6, 8, 32, 32, 3)).astype(np.float32)
    one = make_serving_fn(model)
    two = make_sharded_serving_fn(model, ["cpu", "cpu"])
    np.testing.assert_array_equal(two(x), np.concatenate([one(x[:3]),
                                                          one(x[3:])]))
    np.testing.assert_allclose(two(x), one(x), rtol=1e-5, atol=1e-6)
    # an odd batch: the last shard padded, the padding's logits dropped
    np.testing.assert_array_equal(two(x[:5]), np.concatenate(
        [one(x[:3]), one(np.concatenate([x[3:5], x[4:5]]))[:2]]))


def test_serve_live_buckets_are_device_multiples():
    from protoasnet_tpu_torch.server import (_bucket_ladder, live_devices,
                                             sharded_buckets)

    assert sharded_buckets(128, 1) == (128, _bucket_ladder(128))
    assert sharded_buckets(128, 2) == (128, (2, 4, 8, 16, 32, 64, 128))
    assert sharded_buckets(100, 3) == (99, (3, 6, 12, 24, 48, 96, 99))
    assert sharded_buckets(2, 4) == (4, (4,))
    assert live_devices("cpu") == [torch.device("cpu")]
    assert live_devices(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2


def test_serve_live_replicates_over_the_devices(monkeypatch):
    """serve_live builds one replica a device and hands the batcher the
    ladder in multiples of the device count."""
    import protoasnet_tpu_torch.serve as serve_mod
    import protoasnet_tpu_torch.server as server_mod

    model = build_model(drv.CFG, device="cpu")

    class Agent:
        pass

    agent = Agent()
    agent.model = model
    monkeypatch.setattr(serve_mod, "load_trained_agent",
                        lambda run, dev: (agent, (8, 32, 32, 3)))
    seen = {}

    def loop(fn, sample_shape, dtype, host, port, max_batch, *a, **k):
        seen.update(fn=fn, max_batch=max_batch, buckets=k["buckets"])

    monkeypatch.setattr(server_mod, "_serve_loop", loop)
    server_mod.serve_live("run", max_batch=10, devices=["cpu", "cpu"])
    assert seen["max_batch"] == 10
    assert seen["buckets"] == (2, 4, 8, 10)
    x = np.random.default_rng(1).normal(
        size=(4, 8, 32, 32, 3)).astype(np.float32)
    one = serve_mod.make_serving_fn(model.eval())
    np.testing.assert_array_equal(seen["fn"](x), np.concatenate(
        [one(x[:2]), one(x[2:])]))
