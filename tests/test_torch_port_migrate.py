"""The reference's trained ``.pth`` in the port, both ways
(``protoasnet_tpu_torch/models/migrate.py``), against the reference twins
of ``tests/test_migrate.py`` and the JAX package's ``models/migrate.py``.

- A twin (``RefVideoXProtoNet``, ``RefPPNet``; seeded weights, BatchNorm
  statistics drawn from a seeded generator) converted by the port gives
  the twin's logits in the port (``rtol=1e-5``).
- The port's state_dict from a reference dict is bit-equal to the JAX
  route (the JAX package's ``convert_reference_state_dict``, then
  ``from_jax``), and ``export_reference_state_dict`` is bit-equal, key by
  key and dtype by dtype, to the JAX package's export of the same weights,
  the constant ``ones`` included.
- Both directions round-trip bit-identically.
- The CLI's ``.pkl`` loads into the port's agent and the JAX package's
  (``tests/test_migrate.py``'s pattern), and ``--to_reference`` turns the
  port's own checkpoint into a ``.pth`` that loads strictly into the twin
  and gives the port's logits, and the JAX agent's flax checkpoint into
  the twin's weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu.models.migrate import \
    convert_reference_state_dict as jax_convert
from protoasnet_tpu.models.migrate import \
    export_reference_state_dict as jax_export
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import (load_jax_variables,
                                                  state_dict_from_jax)
from protoasnet_tpu_torch.models.migrate import (
    convert_reference_state_dict, export_reference_state_dict, main)
from tests.test_migrate import D, K, P, RefPPNet, RefVideoXProtoNet
from torch_port_isolation import isolated, scratch_path  # noqa: F401

_isolated = isolated(1)

VIDEO = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
         "backbone_last_layer_num": -3, "prototype_shape": (P, D, 1, 1, 1),
         "num_classes": K, "img_size": 32}
PPNET = {"name": "ProtoPNet", "base_architecture": "resnet18",
         "prototype_shape": (6, D, 1, 1), "num_classes": 3, "img_size": 64,
         "add_on_layers_type": "regular"}
CASES = {"video": (VIDEO, RefVideoXProtoNet, (2, 8, 32, 32, 3)),
         "ppnet": (PPNET, RefPPNet, (2, 64, 64, 3))}


def _twin(ref_cls):
    """The twin in eval mode with seeded BatchNorm statistics."""
    ref = ref_cls().eval()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return ref


def _twin_logits(ref, x):
    perm = (0, 4, 1, 2, 3) if x.ndim == 5 else (0, 3, 1, 2)
    with torch.no_grad():
        return ref(torch.from_numpy(np.transpose(x, perm)))[0].numpy()


def _port(cfg, sd):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    return model


def _port_logits(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x))[0].numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_pth_gives_the_twins_logits(case):
    cfg, ref_cls, shape = CASES[case]
    ref = _twin(ref_cls)
    x = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    model = _port(cfg, convert_reference_state_dict(ref.state_dict(), cfg))
    np.testing.assert_allclose(_port_logits(model, x), _twin_logits(ref, x),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_conversion_is_bit_equal_to_the_jax_route(case):
    cfg, ref_cls, _ = CASES[case]
    sd = _twin(ref_cls).state_dict()
    got = _port(cfg, convert_reference_state_dict(sd, cfg)).state_dict()
    params, stats = jax_convert(sd, cfg)
    want = state_dict_from_jax(build_model(cfg, device="cpu"), params, stats)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_is_bit_equal_to_the_jax_export(case):
    cfg, _, shape = CASES[case]
    params, stats = init_model(jax_build_model(cfg),
                               jnp.zeros((1, *shape[1:])), seed=2)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    stats = jax.tree_util.tree_map(np.asarray, jax.device_get(stats))
    want = jax_export(params, stats, cfg)
    model = load_jax_variables(build_model(cfg, device="cpu"), params, stats)
    got = export_reference_state_dict(model.state_dict(), cfg)
    assert sorted(got) == sorted(want)
    assert "ones" in got
    for k, v in want.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_directions_round_trip(case):
    cfg, ref_cls, _ = CASES[case]
    # port -> reference -> port
    sd = build_model(cfg, device="cpu", seed=5).state_dict()
    back = convert_reference_state_dict(export_reference_state_dict(sd, cfg),
                                        cfg)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # reference -> port -> reference
    ref_sd = _twin(ref_cls).state_dict()
    again = export_reference_state_dict(
        convert_reference_state_dict(ref_sd, cfg), cfg)
    assert set(ref_sd) <= set(again)
    assert set(again) - set(ref_sd) <= {"ones"}  # RefPPNet has none
    for k, v in ref_sd.items():
        np.testing.assert_array_equal(again[k], v.numpy(), err_msg=k)


def _agent_config(csv, tmp_path):
    return {
        "agent": "Video_XProtoNet_e2e", "abstain_class": True,
        "wandb_mode": "disabled", "run_name": "m", "device": "cpu",
        "save_dir": str(tmp_path / "logs"), "render_prototypes": False,
        "model": {"checkpoint_path": "", "name": "Video_XProtoNet",
                  "base_architecture": "resnet2p1d_18",
                  "backbone_last_layer_num": -3,
                  "prototype_shape": f"({P}, {D}, 1, 1, 1)",
                  "num_classes": K},
        "train": {"seed": 0, "num_train_epochs": 1, "save": True,
                  "save_step": None, "num_warm_epochs": 0, "batch_size": 4,
                  "accumulation_steps": 1, "push_start": 99, "push_rate": 1,
                  "auto_resume": False,
                  "criterion": {"CeLossAbstain": {"loss_weight": 1},
                                "Lnorm_FC": {"p": 1, "loss_weight": 0}},
                  "optimizer": {"name": "Adam", "mode": "lr_same",
                                "lr_same": 1e-4},
                  "lr_schedule": {"name": "StepLR", "step_size": 5,
                                  "gamma": 0.1}},
        "data": {"data_info_file": csv, "sample_size": None,
                 "sampler": "AS", "view": "all", "augmentation": False,
                 "normalize": True, "img_size": 32, "frames": 8,
                 "iterate_intervals": True, "interval_unit": "cycle",
                 "interval_quant": 1.0, "num_workers": 1},
    }


def test_cli_both_ways_through_both_agents(synthetic_csv, scratch_path):
    from protoasnet_tpu.train.agents import build_agent as jax_agent
    from protoasnet_tpu_torch.train.agents import build_agent

    ref = _twin(RefVideoXProtoNet)
    pth = str(scratch_path / "ref_last.pth")
    torch.save({"epoch": 7, "iteration": 123, "state_dict": ref.state_dict(),
                "optimizer": None}, pth)
    cfg = _agent_config(synthetic_csv, scratch_path)
    cfg_path = str(scratch_path / "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    pkl = str(scratch_path / "migrated.pkl")
    main([pth, pkl, f"--config_path={cfg_path}"])

    x = np.random.default_rng(10).normal(
        size=(1, 8, 32, 32, 3)).astype(np.float32)
    want = _twin_logits(ref, x)
    cfg["model"]["checkpoint_path"] = pkl
    port = build_agent(cfg)
    assert (port.current_epoch, port.current_iteration) == (7, 123)
    np.testing.assert_allclose(_port_logits(port.model, x), want,
                               rtol=1e-5, atol=1e-6)
    jax_cfg = dict(cfg, save_dir=str(scratch_path / "jax_logs"))
    jax_cfg.pop("device")
    agent = jax_agent(jax_cfg)
    assert agent.current_epoch == 7
    logits, _, _ = agent.model.apply(
        {"params": agent.params, "batch_stats": agent.batch_stats},
        jnp.asarray(x), train=False)
    np.testing.assert_allclose(np.asarray(logits), want, rtol=1e-3,
                               atol=1e-4)
    # the JAX agent's flax checkpoint back to the reference's .pth
    agent.save_checkpoint()
    from_jax = str(scratch_path / "from_jax.pth")
    main([f"{agent.save_dir}/last.ckpt", from_jax,
          f"--config_path={cfg_path}", "--to_reference"])
    blob = torch.load(from_jax, map_location="cpu", weights_only=True)
    assert blob["epoch"] == 7
    for k, v in ref.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(blob["state_dict"][k], v), k

    # the port's own checkpoint back to the reference's .pth
    port.save_checkpoint()
    out = str(scratch_path / "back.pth")
    main([f"{port.save_dir}/last.ckpt", out, f"--config_path={cfg_path}",
          "--to_reference"])
    blob = torch.load(out, map_location="cpu", weights_only=True)
    assert (blob["epoch"], blob["iteration"]) == (7, 123)
    twin = RefVideoXProtoNet().eval()
    twin.load_state_dict(blob["state_dict"], strict=True)
    np.testing.assert_allclose(_twin_logits(twin, x),
                               _port_logits(port.model, x), rtol=1e-5,
                               atol=1e-6)
    for k, v in ref.state_dict().items():
        assert torch.equal(blob["state_dict"][k], v), k
    port.finalize()
