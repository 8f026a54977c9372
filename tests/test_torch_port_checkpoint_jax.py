"""The JAX package's checkpoints read by the port, without JAX in the port.

- ``read_flax_checkpoint`` / ``decode_flax_bytes`` against
  ``flax.serialization.msgpack_restore``, bit for bit and dtype for dtype:
  fp32, bf16 (a ``torch.bfloat16`` tensor on the port's side), int32, 0-d
  arrays, numpy scalars, Python floats and ints of every msgpack width,
  empty dicts, strings, bools and None, and flax's chunked arrays
  (``MAX_CHUNK_SIZE`` set small); malformed input raises with its byte
  offset;
- the real checkpoints of the JAX agents (``Video_XProtoNet_e2e``,
  ``XProtoNet_Base``, ``ProtoPNet_Base``, ``ProtoPNet_e2e``, tiny): the
  reader equals ``msgpack_restore`` on each file, and the port's agent
  loads each (``--model.checkpoint_path`` and auto-resume from
  ``last.ckpt``) with the JAX forward's logits at fp32 tolerance (1e-4 of
  max |logit|), its epoch, iteration, best metric and lr scales;
- resume across packages in float64: the JAX agent takes k micro-steps
  (accumulation 2; in every stage of a staged agent, so that each stage
  has Adam moments, a step count and a partial sum in flight) and saves;
  the port loads that file and takes micro-step k+1, which applies Adam.
  Parameters, their updates, the stepped stage's Adam moments and step
  count and the BN running stats match the JAX package's step k+1 within
  1e-7 of each tensor's max (the float64 pattern of
  ``tests/test_torch_port_train.py``: in fp32 train-mode BN's backward
  drifts ~2% of a tensor's max between the frameworks). The learning
  rates are powers of two, so the JAX package's float32 lrs are exact;
- a reference checkpoint migrated by ``protoasnet_tpu.models.migrate``
  (``.pickle``) loads with its epoch and iteration and a fresh optimiser,
  and the port's forward equals the reference torch model's at fp32
  tolerance; the restricted unpickler refuses other globals.
"""

import copy
import io
import os
import pickle
import shutil

import flax.serialization as fs
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from protoasnet_tpu.losses.losses import \
    sample_affine_params as jax_affine_draw
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.train.optim import GradAccumulator as JaxAcc
from protoasnet_tpu.train.steps import TrainState
from protoasnet_tpu.train.steps import \
    make_protopnet_steps as jax_protopnet_steps
from protoasnet_tpu.train.steps import \
    make_xprotonet_steps as jax_xprotonet_steps
from protoasnet_tpu_torch.data.synthetic import make_synthetic_dataset
from protoasnet_tpu_torch.models.from_jax import jax_to_state_dict
from protoasnet_tpu_torch.train.agents import build_agent
from protoasnet_tpu_torch.utils.io import (checkpoint_format,
                                          decode_flax_bytes,
                                          load_migrated_pickle,
                                          read_flax_checkpoint)

from torch_port_isolation import isolated  # noqa: E402
from torch_port_jax_agents import (AGENTS, PPNETS, STAGED,  # noqa: E402
                                   _jax_logits, _jax_run, agent_config,
                                   sample_batch)
from torch_port_isolation import isolated

_isolated = isolated(2)

STAGES = ("warm", "joint", "last")
TOL = 1e-7

# ---------------- the reader against msgpack_restore ----------------

def _same(ref, got, path="root"):
    """Leaf for leaf, bit for bit, dtype for dtype."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(ref) == list(got), path
        for k in ref:
            _same(ref[k], got[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            _same(a, b, f"{path}/{i}")
    elif getattr(ref, "dtype", None) == jnp.bfloat16:
        assert isinstance(got, torch.Tensor), path
        assert got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(ref), path
        assert np.array_equal(np.asarray(ref).view(np.uint16),
                              got.view(torch.int16).numpy().view(np.uint16))
    elif isinstance(ref, np.ndarray):
        assert type(got) is np.ndarray, (path, type(got))
        assert (got.dtype, got.shape) == (ref.dtype, ref.shape), path
        assert got.tobytes() == ref.tobytes(), path
    else:
        assert type(got) is type(ref), (path, type(ref), type(got))
        if isinstance(ref, float) and np.isnan(ref):
            assert np.isnan(got), path
        else:
            assert got == ref, (path, ref, got)


def _tree(case, rng):
    if case == "fp32":
        return {"w": rng.normal(size=(3, 5)).astype(np.float32),
                "v": rng.normal(size=(40,)).astype(np.float32)}
    if case == "bf16":
        return {"w": jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16),
                "n": np.asarray(jnp.asarray(rng.normal(size=(7,)),
                                            jnp.bfloat16))}
    if case == "int32":
        return {"i": np.arange(-6, 6, dtype=np.int32).reshape(3, 4),
                "u8": np.arange(300).astype(np.uint8),
                "i64": np.array([-2 ** 40, 2 ** 40], np.int64)}
    if case == "0-d":
        return {"f": np.array(2.5, np.float32), "step": jnp.int32(7),
                "count": np.zeros((), np.int32), "f64": np.array(-1e-300),
                "empty": np.zeros((0, 3), np.float32)}
    if case == "numpy scalars":
        return {"f": np.float32(1.5), "i": np.int64(-3), "b": np.bool_(True)}
    if case == "python floats":
        return {"lr": 0.5, "best": 0.123456789, "tiny": 5e-324,
                "big": -1.5e300, "inf": float("inf"), "nan": float("nan")}
    if case == "python ints":
        return {str(i): v for i, v in enumerate(
            (0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
             -2 ** 63))}
    if case == "empty dicts":
        return {"opt_state": {"0": {}, "1": {"count": np.int32(0),
                                             "mu": {}, "nu": {}}},
                "e": {}, "x": {"y": {}}}
    if case == "other":
        return {"s": "x" * 40, "long": "é" * 300, "t": True, "f": False,
                "n": None, "pair": (1, 2.0), "list": [np.float32(1), 3]}
    raise KeyError(case)


CASES = ["fp32", "bf16", "int32", "0-d", "numpy scalars", "python floats",
         "python ints", "empty dicts", "other"]


@pytest.mark.parametrize("case", CASES)
def test_reader_equals_msgpack_restore(case):
    data = fs.to_bytes(_tree(case, np.random.default_rng(0)))
    _same(fs.msgpack_restore(data), decode_flax_bytes(data))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_reader_unchunks_like_flax(monkeypatch, dtype):
    """Arrays above ``MAX_CHUNK_SIZE`` bytes are written in pieces, at
    the top of the tree and nested."""
    rng = np.random.default_rng(1)
    big = np.asarray(jnp.asarray(rng.normal(size=(7, 5)) * 9, dtype))
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 16)
    tree = {"params": {"w": big, "b": big[0]}, "small": big[0, :2]}
    data = fs.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    _same(fs.msgpack_restore(data), decode_flax_bytes(data))
    whole = fs.to_bytes(big)
    _same(fs.msgpack_restore(whole), decode_flax_bytes(whole))


def _offset_of(data, marker):
    i = data.find(marker)
    assert i >= 0
    return i


@pytest.mark.parametrize("fault", ["trailing", "truncated", "ext type",
                                   "map key", "type byte", "ndarray"])
def test_reader_refuses_malformed_input_with_its_offset(fault):
    good = fs.to_bytes({"a": np.ones(3, np.float32), "b": 1.0})
    if fault == "trailing":
        data, at = good + b"\xc0", len(good)
    elif fault == "truncated":
        data = good[:-4]
        at = _offset_of(good, b"\xa1b") + 2  # the float's type byte
    elif fault == "ext type":
        data = msgpack.packb({"a": msgpack.ExtType(5, b"xyz")})
        at = data.find(b"xyz")  # the ext's payload
    elif fault == "map key":
        data, at = msgpack.packb({"a": {7: 1}}), 4  # the inner map's key
    elif fault == "type byte":
        data, at = b"\x81\xa1a\xc1", 3
    else:  # an ndarray whose byte count disagrees with its shape
        inner = msgpack.packb(((2, 2), "float32", b"\0" * 12),
                              use_bin_type=True)
        data = msgpack.packb({"a": msgpack.ExtType(1, inner)})
        at = data.find(inner)
    with pytest.raises(ValueError, match=f"at byte {at}$"):
        decode_flax_bytes(data)


def test_checkpoint_format_by_content(tmp_path):
    flax_file = tmp_path / "a.ckpt"
    flax_file.write_bytes(fs.to_bytes({"epoch": 1}))
    torch_file = tmp_path / "b.ckpt"
    torch.save({"epoch": 1}, torch_file)
    pkl = tmp_path / "c.pkl"
    pkl.write_bytes(pickle.dumps({"epoch": 1}))
    pkl_as_ckpt = tmp_path / "d.ckpt"  # a pickle starts with 0x80 too
    pkl_as_ckpt.write_bytes(pickle.dumps({"epoch": 1}))
    assert checkpoint_format(str(flax_file)) == "flax"
    assert checkpoint_format(str(torch_file)) == "torch"
    assert checkpoint_format(str(pkl)) == "migrated"
    assert checkpoint_format(str(pkl_as_ckpt)) == "flax"
    with pytest.raises(ValueError, match="bytes after the document"):
        read_flax_checkpoint(str(pkl_as_ckpt))
    (tmp_path / "e.ckpt").write_bytes(b"\x93\x01\x02\x03")
    with pytest.raises(ValueError, match="neither"):
        checkpoint_format(str(tmp_path / "e.ckpt"))


# ---------------- the JAX agents' real checkpoints ----------------

@pytest.fixture(scope="module")
def csv(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("data")),
                                  num_videos=12, seed=3)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture
def scratch(tmp_path):
    """A tmp_path removed after the test (the checkpoints are large)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_run(request, csv, tmp_path_factory):
    """One agent's run at a time (indirect parametrisation by name), its
    directory removed once its tests are done."""
    name = request.param
    run = tmp_path_factory.mktemp(name)
    agent = _jax_run(name, csv, run)
    yield dict(name=name, agent=agent, dir=str(run),
               path=os.path.join(str(run), "last.ckpt"))
    shutil.rmtree(run, ignore_errors=True)


@pytest.mark.parametrize("jax_run", list(AGENTS), indirect=True)
def test_real_checkpoint_reads_like_msgpack_restore(jax_run):
    name, path = jax_run["name"], jax_run["path"]
    with open(path, "rb") as f:
        ref = fs.msgpack_restore(f.read())
    got = read_flax_checkpoint(path)
    _same(ref, got)
    keys = {"opt_state_warm", "acc_last", "lr_scale_joint"} \
        if name == "XProtoNet_Base" else \
        {"opt_state_warm", "acc_last", "lr_scale"} if name in STAGED else \
        {"opt_state", "acc", "lr_scale"}
    assert keys <= set(got), sorted(got)


@pytest.mark.parametrize("how", ["checkpoint_path", "auto_resume"])
@pytest.mark.parametrize("jax_run", list(AGENTS), indirect=True)
def test_port_agent_loads_the_jax_checkpoint(jax_run, csv, tmp_path, how):
    run, name = jax_run, jax_run["name"]
    if how == "checkpoint_path":
        cfg = agent_config(name, csv, str(tmp_path),
                           f"--model.checkpoint_path={run['path']}")
    else:
        cfg = agent_config(name, csv, run["dir"])
        cfg["train"]["save"] = False
    agent = build_agent(cfg)
    assert (agent.current_epoch, agent.current_iteration,
            agent.best_metric) == (2, 7, 0.375)
    if name == "XProtoNet_Base":
        assert (agent.schedulers["joint"].lr,
                agent.schedulers["last"].lr) == (0.5, 0.25)
    elif name in STAGED:
        assert agent.schedulers["joint"].lr == 0.5
    else:
        assert agent.scheduler.lr == 0.5
    x = sample_batch(name, 5)[0].astype(np.float32)
    agent.model.eval()
    with torch.no_grad():
        got = agent.model(torch.from_numpy(x))[0].numpy()
    ref = _jax_logits(run["agent"], x)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max() + 1e-6


# ---------------- resume across packages, float64 ----------------

def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  _np_tree(tree))


def _to_f64(agent, name):
    """The JAX agent's model, state and steps rebuilt in float64 (two-pass
    TransformLoss, as the port's step; no donation, so states persist)."""
    jm = jax_build_model(agent.model_config, dtype=jnp.float64)
    params, stats = _f64(agent.params), _f64(agent.batch_stats)
    every = int(agent.train_config["accumulation_steps"])

    def steps(stage):
        if name in PPNETS:
            return jax_protopnet_steps(jm, agent.bundle, agent.tx,
                                       accumulation_steps=every,
                                       stage=stage, donate=False)
        return jax_xprotonet_steps(jm, agent.bundle, agent.tx,
                                   accumulation_steps=every, stage=stage,
                                   donate=False, combine_transform=False)

    agent.model = jm
    agent.state = TrainState.create(params, stats, agent.tx)
    if name in STAGED:
        agent._stage_steps = {s: steps(s)[:2] for s in STAGES}
        agent.opt_states = {s: agent.tx.init(params) for s in STAGES}
        agent.accs = {s: JaxAcc.init(params) for s in STAGES}
    else:
        agent._train_step, agent._eval_step, _ = steps("all")


def _jax_micro_step(agent, name, stage, seed, commit=True):
    """One micro-step through the JAX agent's own state plumbing (its
    run_epoch's), in ``stage``; returns (new state, metrics, affine)."""
    opt = stage if name in STAGED else "default"
    if name in STAGED:
        agent._active_stage = stage
    x, y, v = sample_batch(name, seed)
    key = jax.random.PRNGKey(seed)
    train_step, _ = agent._steps_for(opt)
    state, m = train_step(agent._state_for(opt), jnp.asarray(x),
                          jnp.asarray(y), jnp.asarray(v), key, agent._lrs())
    if commit:
        agent._set_state_for(opt, state)
        agent.current_iteration += 1
    aff = None if name in PPNETS else tuple(
        float(a) for a in jax_affine_draw(key))
    return state, _np_tree(m), aff


RESUME = [("Video_XProtoNet_e2e", "all"),
          *(("XProtoNet_Base", s) for s in STAGES),
          *(("ProtoPNet_Base", s) for s in STAGES)]
K_STEPS = 5  # per stage: two Adam steps and one partial sum in flight


@pytest.fixture(scope="module")
def resumed(request, csv, tmp_path_factory):
    """One agent at a time (indirect parametrisation by name): k
    micro-steps of each of its stages in float64 through the JAX agent, its
    save, then from that state micro-step k+1 of each stage (not
    committed). Yields {name, path, stage: JAX step k+1}; the float64
    checkpoint is removed once the agent's tests are done."""
    name = request.param
    run = tmp_path_factory.mktemp(name + "_f64")
    out = {"name": name, "path": str(run / "last.ckpt")}
    agent = _jax_run(name, csv, run)  # built at fp32, as a run starts
    with jax.enable_x64(True):
        _to_f64(agent, name)
        stages = STAGES if name in STAGED else ("all",)
        seed = 100
        for stage in stages:
            for _ in range(K_STEPS):
                _jax_micro_step(agent, name, stage, seed)
                seed += 1
        agent.save_checkpoint()
        for stage in stages:
            state, m, aff = _jax_micro_step(agent, name, stage, 999,
                                            commit=False)
            assert bool(m["applied"]), stage
            adam = state.opt_state[-1]  # chain(weight decay, adam)
            out[stage] = dict(
                params=jax_to_state_dict(_np_tree(state.params), {}),
                stats=jax_to_state_dict({}, _np_tree(state.batch_stats)),
                mu=jax_to_state_dict(_np_tree(adam.mu), {}),
                nu=jax_to_state_dict(_np_tree(adam.nu), {}),
                count=int(adam.count), affine=aff,
                before=jax_to_state_dict(_np_tree(agent.params), {}))
    yield out
    shutil.rmtree(run, ignore_errors=True)


def _hold(got, ref, what):
    assert set(got) == set(ref), what
    for k, r in ref.items():
        g = got[k].detach().cpu().numpy()
        scale = np.abs(r).max()
        err = np.abs(g - r).max()
        assert err <= TOL * scale + 1e-300, (what, k, err, scale)


@pytest.mark.parametrize("resumed, stage", RESUME, indirect=["resumed"])
def test_port_resumes_a_jax_run_in_float64(resumed, csv, tmp_path, stage):
    name, path, ref = resumed["name"], resumed["path"], resumed[stage]
    cfg = agent_config(name, csv, str(tmp_path))
    agent = build_agent(cfg)  # fresh: nothing to resume in tmp_path
    agent.model.double()
    agent.load_checkpoint_file(path)
    n_stages = 3 if name in STAGED else 1
    assert agent.current_iteration == 7 + K_STEPS * n_stages
    x, y, v = sample_batch(name, 999)
    args = (torch.from_numpy(x), torch.from_numpy(y).long(),
            torch.from_numpy(v))
    if name in STAGED:
        agent._active_stage = stage
        agent.stages.activate(stage)
        train_step = agent._stage_steps[stage][0]
        optimizer = agent.stages.optimizers[stage]
    else:
        train_step, optimizer = agent.train_step, agent.optimizer
    kw = {} if name in PPNETS else {"affine": ref["affine"]}
    m = train_step(*args, agent._lrs(), **kw)
    assert m["applied"]
    params = dict(agent.model.named_parameters())
    _hold(params, ref["params"], "params")
    delta = {k: params[k].detach()
             - torch.from_numpy(np.array(ref["before"][k])) for k in params}
    _hold(delta, {k: ref["params"][k] - ref["before"][k] for k in params},
          "updates")
    state = optimizer.optimizer.state
    _hold({k: state[p]["exp_avg"] for k, p in params.items()}, ref["mu"],
          "Adam mu")
    _hold({k: state[p]["exp_avg_sq"] for k, p in params.items()}, ref["nu"],
          "Adam nu")
    assert {float(state[p]["step"]) for p in params.values()} == \
        {float(ref["count"])}
    sd = agent.model.state_dict()
    _hold({k: sd[k] for k in ref["stats"]}, ref["stats"], "BN stats")


# ---------------- the migrated reference checkpoint ----------------

def test_migrated_pickle_loads_with_a_fresh_optimiser(csv, scratch):
    import yaml

    from protoasnet_tpu.models.migrate import main as migrate_main
    from tests.test_migrate import RefVideoXProtoNet

    ref = RefVideoXProtoNet().eval()
    pth = str(scratch / "ref_last.pth")
    torch.save({"epoch": 7, "iteration": 123,
                "state_dict": ref.state_dict()}, pth)
    cfg = agent_config("Video_XProtoNet_e2e", csv, str(scratch / "logs"))
    cfg_path = str(scratch / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    pkl = str(scratch / "migrated.pickle")
    migrate_main([pth, pkl, f"--config_path={cfg_path}"])
    assert checkpoint_format(pkl) == "migrated"
    blob = load_migrated_pickle(pkl)
    assert (blob["epoch"], blob["iteration"]) == (7, 123)

    cfg["model"]["checkpoint_path"] = pkl
    agent = build_agent(cfg)
    assert (agent.current_epoch, agent.current_iteration) == (7, 123)
    assert agent.optimizer.state_dict()["state"] == {}
    assert agent.accumulator.count == 0
    assert agent.scheduler.lr == 1.0
    x = np.random.default_rng(10).normal(
        size=(2, 8, 32, 32, 3)).astype(np.float32)
    agent.model.eval()
    with torch.no_grad():
        got = agent.model(torch.from_numpy(x))[0].numpy()
        want = ref(torch.from_numpy(np.transpose(x, (0, 4, 1, 2, 3))))[0]
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-3, atol=1e-4)


def test_migrated_pickle_refuses_other_globals(tmp_path):
    class Boom:
        def __reduce__(self):
            return (os.system, ("true",))

    path = tmp_path / "evil.pkl"
    path.write_bytes(pickle.dumps({"params": Boom(), "batch_stats": {}}))
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        load_migrated_pickle(str(path))
    ok = io.BytesIO()
    pickle.dump({"params": {"a": np.ones(2)}, "batch_stats": {},
                 "epoch": np.int64(3)}, ok, protocol=5)
    path.write_bytes(ok.getvalue())
    blob = load_migrated_pickle(str(path))
    assert blob["epoch"] == 3 and blob["params"]["a"].tolist() == [1, 1]
    assert copy.deepcopy(blob)["params"]["a"].dtype == np.float64
