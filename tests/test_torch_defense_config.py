"""The config gate of the defense slice: ``server_config.chaos``,
``robust`` and ``secure_agg``, and ``dp_config`` under FedAvg.

- Every combination that the JAX package refuses (its schema, the
  constructors of ``SecureAgg``, ``RobustFedAvg`` and ``FedAvg``, its round
  engine and its server) raises ``ValueError`` from the port's config gate,
  and the same config raises ``ValueError`` when the JAX package builds its
  server.
- What is left out raises ``NotImplementedError`` naming the key: chaos's
  infra services and ``cohort_bucketing``.  ``fused_carry`` under FedAvg
  builds, as in the JAX package, and so do chaos's checkpoint-IO faults
  and preemption drill, ``dump_norm_stats``, ``clients_per_chunk``, and DP
  under FedAC, FedBuff, EF quantization and FedLabels.
- The slice's keys parse: ``strategy: secure_agg`` and its aliases, a
  ``robust`` block with each aggregator, chaos client faults and
  corruption, local DP with adaptive clipping under FedAvg and FedProx, and
  ``enable_global_dp`` under FedAvg (accepted and ignored).
"""

import copy

import pytest

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine.server import select_server as jax_select_server
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.strategies.fedavg import FedAvg
from msrflute_tpu_torch.strategies.robust import RobustFedAvg
from msrflute_tpu_torch.strategies.secure_agg import SecureAgg
from test_torch_strategy_config import _dataset, _with

LOCAL_DP = {"enable_local_dp": True, "eps": -1.0, "max_grad": 1.0}
ADAPTIVE = dict(LOCAL_DP, adaptive_clipping={"target_quantile": 0.5})
FAULTS = {"seed": 1, "dropout_rate": 0.2, "corrupt_nan_rate": 0.1}

REFUSED = {
    "secagg_local_dp": _with("secure_agg", ("dp_config", LOCAL_DP)),
    "secagg_global_dp": _with("secure_agg", ("dp_config", {
        "enable_global_dp": True, "global_sigma": 1.0})),
    "secagg_adaptive_clipping": _with("secure_agg", ("dp_config", ADAPTIVE)),
    "secagg_dump_norm_stats": _with("secure_agg", (
        "server_config.dump_norm_stats", True)),
    "secagg_want_rl": _with("secure_agg", ("server_config.wantRL", True)),
    "secagg_over_int32_range": _with("secure_agg", (
        "server_config.secure_agg", {"frac_bits": 24, "clip": 4.0})),
    "secagg_bad_graph": _with("secure_agg", (
        "server_config.secure_agg", {"graph": "ring"})),
    "secagg_unknown_option": _with("secure_agg", (
        "server_config.secure_agg", {"mask_bits": 32})),
    "secagg_block_under_fedavg": _with("fedavg", (
        "server_config.secure_agg", {"frac_bits": 12})),
    "median_under_secagg": _with("secure_agg", (
        "server_config.robust", {"aggregator": "median"})),
    "trimmed_mean_under_secagg": _with("secure_agg", (
        "server_config.robust", {"aggregator": "trimmed_mean"})),
    "median_with_adaptive_clipping": _with("fedavg", (
        "server_config.robust", {"aggregator": "median"}), (
        "dp_config", ADAPTIVE)),
    "screened_mean_with_adaptive_clipping": _with("fedavg", (
        "server_config.robust", {"aggregator": "mean"}), (
        "dp_config", ADAPTIVE)),
    "median_under_qffl": _with("qffl", (
        "server_config.robust", {"aggregator": "median"})),
    "trimmed_mean_under_fedbuff": _with("fedbuff", (
        "server_config.robust", {"aggregator": "trimmed_mean"})),
    "robust_under_dga": _with("dga", ("server_config.robust", {})),
    "robust_with_want_rl": _with("fedavg", ("server_config.wantRL", True), (
        "server_config.robust", {"aggregator": "mean"})),
    "robust_under_scaffold": _with("scaffold", (
        "server_config.robust", {"aggregator": "mean"})),
    "robust_bad_aggregator": _with("fedavg", (
        "server_config.robust", {"aggregator": "krum"})),
    "robust_trim_half": _with("fedavg", (
        "server_config.robust", {"aggregator": "trimmed_mean",
                                 "trim_fraction": 0.5})),
    "robust_unknown_key": _with("fedavg", (
        "server_config.robust", {"quorum": 3})),
    "chaos_with_want_rl": _with("dga", ("server_config.wantRL", True), (
        "server_config.chaos", FAULTS)),
    "chaos_under_scaffold": _with("scaffold", ("server_config.chaos",
                                               FAULTS)),
    "chaos_under_ef_quant": _with("ef_quant", ("server_config.chaos", {
        "corrupt_sign_flip_rate": 0.2})),
    "chaos_rates_over_one": _with("fedavg", ("server_config.chaos", {
        "corrupt_nan_rate": 0.6, "corrupt_scale_rate": 0.6})),
    "chaos_unknown_key": _with("fedavg", ("server_config.chaos", {
        "drop_rate": 0.1})),
    "adaptive_without_local_dp": _with("fedavg", ("dp_config", {
        "adaptive_clipping": {"target_quantile": 0.5}})),
    "adaptive_under_dga": _with("dga", ("dp_config", ADAPTIVE)),
}


def _jax_server(raw, tmp_path):
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    cls = jax_select_server(cfg.server_config.get("type"))
    return cls(jax_make_task(cfg.model_config), cfg, _dataset(),
               val_dataset=_dataset(1), model_dir=str(tmp_path),
               mesh=make_mesh(num_devices=1), seed=0)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_combination_raises_value_error_in_both(name, tmp_path):
    raw = REFUSED[name]
    with pytest.raises(ValueError):
        FLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(ValueError):
        _jax_server(raw, tmp_path)


@pytest.mark.parametrize("block", [{"aggregator": "mean"},
                                   {"dropout_rate": 0.3}], ids=str)
def test_personalization_refuses_robust_and_chaos(block):
    """The personalization server's hooked sampling is a host round: its
    ``robust`` block and chaos client faults raise (``server.py:195-222``),
    in the config gate and in the server itself."""
    key = "robust" if "aggregator" in block else "chaos"
    raw = _with("fedavg", ("server_config.type", "personalization"),
                (f"server_config.{key}", block))
    with pytest.raises(ValueError, match="host-side"):
        FLUTEConfig.from_dict(copy.deepcopy(raw))
    from unittest import mock
    from msrflute_tpu_torch.engine.personalization import \
        PersonalizationServer
    from msrflute_tpu_torch.data.dataset import ArraysDataset
    with mock.patch("msrflute_tpu_torch.config.validate"):
        cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    data = _dataset()
    port_data = ArraysDataset(data.user_list,
                              [data.user_arrays(i) for i in range(4)])
    with pytest.raises(ValueError, match="host-side"):
        PersonalizationServer(make_task(cfg.model_config), cfg, port_data,
                              device="cpu")


NOT_PORTED = {
    "chaos_infra": ("fedavg", "server_config.chaos",
                    {"infra": {"store_write_error_rate": 0.1}}, "infra"),
}


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_left_out_raises_not_implemented_naming_the_key(name, tmp_path):
    """Chaos's infra services run since the fleet paged carry: without it
    they raise the JAX server's ValueError, naming the key."""
    strategy, path, value, key = NOT_PORTED[name]
    raw = _with(strategy, (path, value))
    with pytest.raises(ValueError, match=key) as got:
        FLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(ValueError) as want:
        _jax_server(raw, tmp_path / "jax")
    assert str(got.value) == str(want.value)


LIFTED = {
    "chaos_ckpt_io": ("fedavg", "server_config.chaos",
                      {"ckpt_io_error_rate": 0.1}),
    "chaos_preempt": ("fedavg", "server_config.chaos",
                      {"dropout_rate": 0.1, "preempt_at_round": 3}),
    "dump_norm_stats": ("fedavg", "server_config.dump_norm_stats", True),
    "clients_per_chunk": ("fedavg", "server_config.clients_per_chunk", 2),
    "dp_under_fedac": ("fedac", "dp_config", LOCAL_DP),
    "dp_under_fedbuff": ("fedbuff", "dp_config", LOCAL_DP),
    "dp_under_ef_quant": ("ef_quant", "dp_config", LOCAL_DP),
    "dp_under_fedlabels": ("fedlabels", "dp_config", LOCAL_DP),
    "secure_agg_cohort_bucketing": ("secure_agg",
                                    "server_config.cohort_bucketing",
                                    {"enable": True}),
    "traffic": ("secure_agg", "server_config.traffic", {"mode": "buffered"}),
}


@pytest.mark.parametrize("name", sorted(LIFTED))
def test_lifted_keys_build_as_in_the_jax_package(name, tmp_path):
    """Each key that the port once refused builds its server in the port
    and in the JAX package, with the same strategy and chaos schedule."""
    strategy, path, value = LIFTED[name]
    raw = _with(strategy, (path, value))
    from msrflute_tpu_torch.data.dataset import ArraysDataset
    data = _dataset()
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    server = OptimizationServer(
        make_task(cfg.model_config), cfg,
        ArraysDataset(data.user_list, [data.user_arrays(i)
                                       for i in range(4)]),
        model_dir=str(tmp_path / "port"), device="cpu")
    jax_server = _jax_server(raw, tmp_path / "jax")
    assert type(server.strategy).__name__ == \
        type(jax_server.strategy).__name__
    assert (server.chaos is None) == (jax_server.chaos is None)
    if server.chaos is not None:
        assert server.chaos.describe() == jax_server.chaos.describe()


@pytest.mark.parametrize("name", ["fused_carry"])
def test_fused_carry_under_fedavg_builds_as_in_the_jax_package(name,
                                                              tmp_path):
    """``fused_carry: true`` under FedAvg: no carry state, the plain round
    on the ring, in the JAX package and in the port."""
    raw = _with("fedavg", (f"server_config.{name}", True))
    from msrflute_tpu_torch.data.dataset import ArraysDataset
    data = _dataset()
    server = OptimizationServer(
        make_task(FLUTEConfig.from_dict(copy.deepcopy(raw)).model_config),
        FLUTEConfig.from_dict(copy.deepcopy(raw)),
        ArraysDataset(data.user_list, [data.user_arrays(i)
                                       for i in range(4)]),
        model_dir=str(tmp_path), device="cpu")
    assert type(server.strategy) is FedAvg and server._pipeline_ok()
    assert not server.strategy.device_carry and \
        server.state.strategy_state == {}
    jax_server = _jax_server(raw, tmp_path / "jax")
    assert not getattr(jax_server.strategy, "device_carry", False)


ADMITTED = {
    "secure_agg": ("secure_agg", (), SecureAgg),
    "secagg": ("secagg", (("server_config.secure_agg",
                           {"graph": "log", "min_survivors": 2}),),
               SecureAgg),
    "secureagg_screened": ("SecureAgg", (
        ("server_config.robust", {"norm_multiplier": 3.0}),
        ("server_config.chaos", dict(FAULTS, straggler_rate=0.5))),
        SecureAgg),
    "screened_mean": ("fedavg", (("server_config.robust", {}),), FedAvg),
    "trimmed_mean": ("fedprox", (("server_config.robust", {
        "aggregator": "trimmed_mean", "trim_fraction": 0.2}),),
        RobustFedAvg),
    "median_under_chaos": ("fedavg", (
        ("server_config.robust", {"aggregator": "median"}),
        ("server_config.chaos", {
            "dropout_rate": 0.2, "straggler_rate": 0.2,
            "straggler_inflation": 3.0, "corrupt_nan_rate": 0.1,
            "corrupt_scale_rate": 0.1, "corrupt_scale_factor": 50.0,
            "corrupt_sign_flip_rate": 0.1,
            "corrupt_sign_flip_scale": 2.0})), RobustFedAvg),
    "zero_rate_chaos_on_host_rounds": ("scaffold", (
        ("server_config.chaos", {"seed": 2, "dropout_rate": 0.0}),), None),
    "chaos_under_qffl": ("qffl", (("server_config.chaos", FAULTS),), None),
    "local_dp_adaptive": ("fedavg", (("dp_config", ADAPTIVE),), FedAvg),
    "local_dp_fedprox": ("fedprox", (("dp_config", dict(
        LOCAL_DP, eps=8.0, delta=1e-6)),), FedAvg),
    "global_dp_under_fedavg": ("fedavg", (("dp_config", {
        "enable_global_dp": True, "global_sigma": 1.0}),), FedAvg),
}


@pytest.mark.parametrize("name", sorted(ADMITTED))
def test_slice_keys_parse(name, tmp_path):
    strategy, edits, cls = ADMITTED[name]
    raw = _with(strategy, *edits)
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    if cls is None:
        return
    from msrflute_tpu_torch.data.dataset import ArraysDataset
    data = _dataset()
    server = OptimizationServer(
        make_task(cfg.model_config), cfg,
        ArraysDataset(data.user_list, [data.user_arrays(i)
                                       for i in range(4)]),
        model_dir=str(tmp_path), device="cpu")
    assert type(server.strategy) is cls
    _jax_server(raw, tmp_path / "jax")      # the JAX package admits it too
