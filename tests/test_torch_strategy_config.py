"""The combinations that the JAX package refuses for the strategies of
this slice (its strategies' constructors, ``engine/round.py:213-216,
297-316`` and ``engine/server.py:606-620, 632-636, 824-830``): each raises
``ValueError`` from the port's config gate, and the same config raises
``ValueError`` when the JAX package builds its server.  The features of
later slices stay refused with ``NotImplementedError``.  The new keys
themselves parse."""

import copy

import numpy as np
import pytest

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.data import ArraysDataset
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu_torch.config import FLUTEConfig, RLConfig

BASE = {
    "model_config": {"model_type": "LR", "num_classes": 4, "input_dim": 8},
    "strategy": "fedavg",
    "server_config": {"max_iteration": 1, "num_clients_per_iteration": 2,
                      "optimizer_config": {"type": "sgd", "lr": 1.0},
                      "initial_val": False,
                      "data_config": {"val": {"batch_size": 8}}},
    "client_config": {"optimizer_config": {"type": "sgd", "lr": 0.1},
                      "data_config": {"train": {"batch_size": 4}}},
}


def _with(strategy, *edits):
    raw = copy.deepcopy(BASE)
    raw["strategy"] = strategy
    for path, value in edits:
        node = raw
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return raw


def _dataset(seed=0):
    rng = np.random.default_rng(seed)
    return ArraysDataset(
        [f"u{i}" for i in range(4)],
        [{"x": rng.normal(size=(6, 8)).astype(np.float32),
          "y": rng.integers(0, 4, 6).astype(np.int32)} for _ in range(4)])


def _jax_server(raw, tmp_path):
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    return JaxServer(jax_make_task(cfg.model_config), cfg, _dataset(),
                     val_dataset=_dataset(1),
                     server_train_dataset=_dataset(2),
                     model_dir=str(tmp_path), mesh=make_mesh(num_devices=1),
                     seed=0)


LOCAL_DP = {"enable_local_dp": True, "eps": -1.0, "max_grad": 1.0,
            "max_weight": 10.0, "min_weight": 0.0, "weight_scaler": 1.0}
REPLAY = {"server_iterations": 1,
          "optimizer_config": {"type": "sgd", "lr": 0.01}}

REFUSED = {
    "qffl_local_dp": _with("qffl", ("dp_config", LOCAL_DP)),
    "qffl_global_dp": _with("qffl", ("dp_config", {
        "enable_global_dp": True, "global_sigma": 1.0, "max_grad": 1.0})),
    "qffl_negative_q": _with("qffl", ("server_config.qffl_q", -1.0)),
    "fedac_adaptive_clipping": _with("fedac", ("dp_config", {
        **LOCAL_DP, "adaptive_clipping": {"target_quantile": 0.5}})),
    "fedac_adam_server": _with("fedac", (
        "server_config.optimizer_config", {"type": "adam", "lr": 0.1})),
    "fedbuff_adam_server": _with("fedbuff", (
        "server_config.optimizer_config", {"type": "adam", "lr": 0.1})),
    "fedbuff_zero_staleness": _with("fedbuff", (
        "server_config.fedbuff", {"max_staleness": 0})),
    "fedbuff_negative_exponent": _with("fedbuff", (
        "server_config.fedbuff", {"staleness_exponent": -0.5})),
    "fedbuff_unknown_key": _with("fedbuff", (
        "server_config.fedbuff", {"buffer": 3})),
    "fedbuff_not_a_block": _with("fedbuff", ("server_config.fedbuff", 3)),
    "fedac_with_replay": _with("fedac", (
        "server_config.server_replay_config", REPLAY), (
        "server_config.data_config.train.train_data_server", "s.json")),
    "fedbuff_with_replay": _with("fedbuff", (
        "server_config.server_replay_config", REPLAY), (
        "server_config.data_config.train.train_data_server", "s.json")),
    "rl_on_fedac": _with("fedac", ("server_config.wantRL", True)),
    "rl_on_fedbuff": _with("fedbuff", ("server_config.wantRL", True)),
    "rl_on_scaffold": _with("scaffold", ("server_config.wantRL", True)),
    "rl_on_ef_quant": _with("ef_quant", ("server_config.wantRL", True)),
    "rl_on_fedlabels": _with("fedlabels", ("server_config.wantRL", True)),
    "rl_device_resident": _with("dga", ("server_config.wantRL", True), (
        "client_config.data_config.train.device_resident", True)),
    "scaffold_device_resident": _with("scaffold", (
        "client_config.data_config.train.device_resident", True)),
    "ef_quant_device_resident": _with("ef_quant", (
        "client_config.data_config.train.device_resident", True)),
    "device_controls_without_scaffold": _with("fedavg", (
        "server_config.scaffold_device_controls", True)),
    "device_residuals_without_ef_quant": _with("scaffold", (
        "server_config.ef_device_residuals", True)),
    "scaffold_local_dp": _with("scaffold", ("dp_config", LOCAL_DP)),
    "scaffold_momentum": _with("scaffold", (
        "client_config.optimizer_config",
        {"type": "sgd", "lr": 0.1, "momentum": 0.9})),
    "scaffold_adam": _with("scaffold", (
        "client_config.optimizer_config", {"type": "adam", "lr": 0.1})),
    "scaffold_fedprox": _with("scaffold", ("client_config.fedprox_mu",
                                           0.01)),
    "scaffold_clip": _with("scaffold", ("client_config.max_grad_norm",
                                        1.0)),
    "scaffold_freeze": _with("scaffold", ("client_config.freeze_layer",
                                          ["Dense_0"])),
    "scaffold_quant": _with("scaffold", ("client_config.quant_thresh",
                                         0.5)),
    "ef_quant_17_bits": _with("ef_quant", ("client_config.quant_bits",
                                           17)),
    "ef_quant_threshold_one": _with("ef_quant", (
        "client_config.quant_thresh", 1.0)),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_combination_raises_value_error_in_both(name, tmp_path):
    raw = REFUSED[name]
    with pytest.raises(ValueError):
        FLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(ValueError):
        _jax_server(raw, tmp_path)


@pytest.mark.parametrize("path,value", [
    ("server_config.dump_norm_stats", True),
    ("server_config.clients_per_chunk", 2),
])
def test_round_options_build_under_scaffold_as_in_the_jax_package(
        path, value, tmp_path):
    """``dump_norm_stats`` and ``clients_per_chunk`` beside SCAFFOLD's host
    rounds: both packages build the server, the host rounds stay (their
    payload program reads neither), and the port's engine holds the
    option."""
    from msrflute_tpu_torch.data.dataset import ArraysDataset as PortDataset
    from msrflute_tpu_torch.engine.server import OptimizationServer
    from msrflute_tpu_torch.models import make_task
    raw = _with("scaffold", (path, value))
    jax_server = _jax_server(raw, tmp_path / "jax")
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    jds = _dataset()
    server = OptimizationServer(
        make_task(cfg.model_config), cfg,
        PortDataset(jds.user_list, [jds.user_arrays(i) for i in range(4)]),
        model_dir=str(tmp_path / "port"), device="cpu", seed=0)
    assert server.scaffold_store is not None and \
        jax_server.scaffold_store is not None
    key = path.split(".")[-1]
    assert getattr(server.engine, key) == getattr(jax_server.engine, key) \
        == value


@pytest.mark.parametrize("path,value", [
    ("server_config.chaos", {"infra": {"writer_error_rate": 0.1}}),
])
def test_later_slices_stay_refused(path, value):
    strategy = value if path == "strategy" else "scaffold"
    edits = () if path == "strategy" else ((path, value),)
    if path == "server_config.chaos":
        # the infra services run beside the fleet paged carry; without it
        # (SCAFFOLD's host rounds here) the JAX server's ValueError
        from msrflute_tpu_torch.config import INFRA_NEEDS_PAGING
        with pytest.raises(ValueError) as info:
            FLUTEConfig.from_dict(_with(strategy, *edits))
        assert str(info.value) == INFRA_NEEDS_PAGING
        paged = _with(strategy, *edits, ("server_config.fused_carry", True),
                      ("server_config.fleet", {"enable": True}))
        FLUTEConfig.from_dict(paged)
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        FLUTEConfig.from_dict(_with(strategy, *edits))


@pytest.mark.parametrize("path,value", [
    ("server_config.cohort_bucketing", {"enable": True})])
def test_bucketing_refuses_scaffold_host_rounds_as_the_jax_server(
        path, value, tmp_path):
    """``cohort_bucketing`` beside SCAFFOLD's host rounds (no
    ``fused_carry``): the config parses and both servers raise the JAX
    server's ``ValueError`` (``server.py:505-514``)."""
    from msrflute_tpu_torch.data.dataset import ArraysDataset as PortDataset
    from msrflute_tpu_torch.engine.server import OptimizationServer
    from msrflute_tpu_torch.models import make_task
    raw = _with("scaffold", (path, value))
    with pytest.raises(ValueError, match="host-side") as want:
        _jax_server(raw, tmp_path / "jax")
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    jds = _dataset()
    with pytest.raises(ValueError) as got:
        OptimizationServer(
            make_task(cfg.model_config), cfg,
            PortDataset(jds.user_list, [jds.user_arrays(i)
                                        for i in range(4)]),
            model_dir=str(tmp_path / "port"), device="cpu", seed=0)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("path,value", [("server_config.fused_carry", True)])
def test_fused_carry_builds_as_in_the_jax_package(path, value, tmp_path):
    """SCAFFOLD under ``fused_carry``: the JAX package builds its carry
    server (no host rounds), and so does the port, its controls in
    ``strategy_state``."""
    from msrflute_tpu_torch.data.dataset import ArraysDataset as PortDataset
    from msrflute_tpu_torch.engine.server import OptimizationServer
    from msrflute_tpu_torch.models import make_task
    raw = _with("scaffold", (path, value))
    jax_server = _jax_server(raw, tmp_path / "jax")
    assert not jax_server.strategy.host_rounds
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    jds = _dataset()
    server = OptimizationServer(
        make_task(cfg.model_config), cfg,
        PortDataset(jds.user_list, [jds.user_arrays(i) for i in range(4)]),
        model_dir=str(tmp_path / "port"), device="cpu", seed=0)
    assert server.strategy.device_carry and server.scaffold_store is None
    assert sorted(server.state.strategy_state) == ["c", "ci"]
    assert server.state.strategy_state["ci"].shape[0] == 4


@pytest.mark.parametrize("strategy,edits", [
    ("qffl", (("server_config.qffl_q", 0.0),)),
    ("fedac", (("server_config.fedac_eta", 0.5),
               ("server_config.fedac_gamma", 2.0),
               ("server_config.fedac_alpha", 3.0),
               ("server_config.fedac_beta", 4.0))),
    ("fedbuff", (("server_config.fedbuff",
                  {"max_staleness": 4, "staleness_exponent": 0.5}),)),
    ("scaffold", (("server_config.scaffold_device_controls", True),
                  ("server_config.scaffold_flush_freq", 3))),
    ("efquant", (("server_config.ef_device_residuals", True),
                 ("server_config.ef_flush_freq", 2),
                 ("client_config.quant_bits", 2),
                 ("client_config.quant_thresh", 0.5),
                 ("client_config.quant_anneal", 0.99),
                 ("client_config.quant_approx", True))),
    ("dga", (("server_config.wantRL", True),
             ("server_config.RL", {"wantLSTM": True, "minibatch_size": 4,
                                   "network_params": [8, 16, 2],
                                   "optimizer_config": {"type": "adam",
                                                        "lr": 0.001}}))),
    ("fedavg", (("server_config.wantRL", True),)),
])
def test_new_keys_parse(strategy, edits, tmp_path):
    """... in both packages (the JAX server builds on them, so a refusal
    above is the combination's, not the base config's)."""
    _jax_server(_with(strategy, *edits), tmp_path)
    cfg = FLUTEConfig.from_dict(_with(strategy, *edits))
    assert cfg.strategy == strategy
    for path, value in edits:
        section, key = path.split(".", 1)
        assert cfg[section].get(key) is not None


def test_rl_block_takes_the_jax_defaults():
    cfg = FLUTEConfig.from_dict(_with("dga", ("server_config.wantRL", True),
                                      ("server_config.RL",
                                       {"initial_epsilon": 0.2})))
    rl = cfg.server_config.RL
    assert isinstance(rl, RLConfig)
    assert rl.initial_epsilon == 0.2
    assert rl.model_descriptor_RL == "marginalUpdate"
    assert rl.optimizer_config.type == "sgd" and rl.optimizer_config.lr == \
        0.01
    with pytest.raises(ValueError, match="unknown config key"):
        FLUTEConfig.from_dict(_with("dga", ("server_config.RL",
                                            {"epsilon": 0.2})))
