"""The port's config gate: the published configs of the slice parse, and every
config outside the slice fails loudly — ``NotImplementedError`` for a
feature the port does not have yet, ``ValueError`` for an unknown key —
instead of running as something else."""

import copy
import os
import re

import pytest
import yaml

from msrflute_tpu_torch.config import FLUTEConfig, parse_clients_per_round

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = {
    "model_config": {"model_type": "CNN", "num_classes": 62},
    "strategy": "fedavg",
    "server_config": {"max_iteration": 2, "num_clients_per_iteration": 10,
                      "optimizer_config": {"type": "sgd", "lr": 1.0},
                      "megakernel": {"pallas_apply": True}},
    "client_config": {"optimizer_config": {"type": "sgd", "lr": 0.1},
                      "data_config": {"train": {"batch_size": 20}}},
}


@pytest.mark.parametrize("name", ["cv_cnn_femnist", "cv_lr_mnist"])
def test_published_configs_parse(name):
    with open(os.path.join(REPO, "experiments", name, "config.yaml")) as fh:
        cfg = FLUTEConfig.from_dict(yaml.safe_load(fh))
    assert cfg.strategy == "fedavg"
    assert cfg.client_config.data_config.train.batch_size in (10, 20)


def _nlg_gru():
    with open(os.path.join(REPO, "experiments", "nlg_gru",
                           "config.yaml")) as fh:
        return yaml.safe_load(fh)


def test_nlg_gru_config_with_dp_and_quantization_parses():
    raw = _nlg_gru()
    raw["dp_config"] = {"enable_local_dp": True, "eps": 100.0,
                        "delta": 1e-7, "max_grad": 1.0,
                        "max_weight": 10000.0, "min_weight": 0.0,
                        "weight_scaler": 0.0001, "enable_global_dp": True,
                        "global_sigma": 1.0}
    raw["model_config"].update(quant_threshold=0.7, quant_bits=10)
    raw["client_config"].update(quant_anneal=0.99, quant_approx=False)
    raw["server_config"]["megakernel"] = {"pallas_apply": True}
    cfg = FLUTEConfig.from_dict(raw)
    assert cfg.strategy == "dga"
    assert cfg.dp_config["enable_global_dp"] is True
    assert cfg.server_config.optimizer_config.get("amsgrad") is True
    cfg.validate("/data")
    assert cfg.model_config["vocab_dict"] == \
        "/data/mockup/vocab_reddit.vocab"
    assert cfg.client_config.data_config.train["vocab_dict"] == \
        "/data/mockup/vocab_reddit.vocab"


@pytest.mark.parametrize("path,value", [
    ("server_config.dump_norm_stats", True),
    ("server_config.chaos", {"preempt_at_round": 2}),
])
def test_dga_config_takes_the_round_options_and_the_drill(path, value):
    """``dump_norm_stats`` and chaos's ``preempt_at_round`` on the DGA
    config parse in the port, as in the JAX package."""
    raw = _nlg_gru()
    node = raw
    keys = path.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    assert cfg.server_config.get(keys[1]) == value
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    JaxFLUTEConfig.from_dict(copy.deepcopy(raw))


@pytest.mark.parametrize("path,value", [
    ("mesh_config.model_axis_size", 4),
    ("strategy", "secure_agg"),
])
def test_keys_outside_the_dga_slice_still_raise(path, value):
    raw = _nlg_gru()
    node = raw
    keys = path.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FLUTEConfig.from_dict(raw)


@pytest.mark.parametrize("path,value", [
    ("server_config.softmax_beta", 2.0),
    ("client_config.quant_thresh", 0.5),
    ("model_config.quant_threshold", 0.7),
    ("server_config.stale_prob", 0.3),
    ("client_config.quant_anneal", 0.99),
])
def test_dga_features_refused_under_fedavg(path, value):
    """Quantization, staleness and DGA's softmax weighting run inside DGA
    only; a FedAvg config that asks for them raises instead of running
    without them.  (Local DP and adaptive clipping run under FedAvg since
    the defense slice, ``tests/test_torch_dp_fedavg.py``.)"""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FLUTEConfig.from_dict(_with(path, value))


def _with(path, value):
    raw = copy.deepcopy(BASE)
    node = raw
    keys = path.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value
    return raw


@pytest.mark.parametrize("path,value", [
    ("server_config.checkpoint_backend", "orbax"),
    ("strategy", "robust"),
    ("mesh_config.model_axis_size", 2),
    ("server_config.telemetry", {"enable": True}),
    ("server_config.chaos", {"enable": True, "infra": {
        "writer_error_rate": 0.1}}),
    ("server_config.chaos", {"enable": True, "infra": {
        "store_read_error_rate": 0.2}}),
    ("client_config.quant_bits", 8),
])
def test_unported_features_raise(path, value):
    if path == "server_config.telemetry":
        # telemetry runs since its slice: the block is accepted, as the
        # JAX schema accepts it
        cfg = FLUTEConfig.from_dict(_with(path, value))
        assert cfg.server_config.get("telemetry") == value
        from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
        JaxFLUTEConfig.from_dict(_with(path, value))
        return
    if path == "server_config.chaos":
        # chaos's infra services run since the fleet paged carry; without
        # it they raise the JAX server's ValueError
        from msrflute_tpu_torch.config import INFRA_NEEDS_PAGING
        with pytest.raises(ValueError) as info:
            FLUTEConfig.from_dict(_with(path, value))
        assert str(info.value) == INFRA_NEEDS_PAGING
        return
    with pytest.raises(NotImplementedError, match="not yet ported"):
        FLUTEConfig.from_dict(_with(path, value))


@pytest.mark.parametrize("path,value", [
    ("server_config.cohort_bucketing", {"enable": True}),
    ("server_config.megabatch", {"enable": True}),
])
def test_throughput_blocks_parse_as_in_the_jax_package(path, value):
    """``cohort_bucketing`` and ``megabatch``, once refused as not ported:
    the bucketing block parses in both packages, and megabatch without it
    is the JAX schema's error in both (``schema.py:1032-1043``)."""
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    from msrflute_tpu_torch.config import SchemaError
    raw = _with(path, value)
    if path.endswith("megabatch"):
        with pytest.raises(ValueError) as want:
            JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
        with pytest.raises(SchemaError) as got:
            FLUTEConfig.from_dict(copy.deepcopy(raw))
        assert got.value.errors == want.value.errors
        return
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    assert cfg.server_config.get("cohort_bucketing") == value
    JaxFLUTEConfig.from_dict(copy.deepcopy(raw))


@pytest.mark.parametrize("path,value", [
    ("server_config.checkpoint_retry", {"retries": 3}),
    ("server_config.clients_per_chunk", 2),
    ("server_config.chaos", {"enable": True, "ckpt_io_error_rate": 0.1}),
    ("server_config.chaos", {"enable": True, "seed": 0, "dropout_rate": 0.1,
                             "ckpt_io_error_rate": 0.1}),
    ("server_config.chaos", {"enable": True, "seed": 0, "dropout_rate": 0.1,
                             "preempt_at_round": 2}),
], ids=["checkpoint_retry", "clients_per_chunk", "ckpt_io",
        "checkpoint-IO", "preemption"])
def test_resilience_and_round_options_parse_as_in_the_jax_package(path,
                                                                  value):
    """Checkpoint retry, chaos's checkpoint-IO faults and preemption drill
    and ``clients_per_chunk`` parse in the port and in the JAX package."""
    raw = _with(path, value)
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    assert cfg.server_config.get(path.split(".")[1]) == value
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    JaxFLUTEConfig.from_dict(copy.deepcopy(raw))


@pytest.mark.parametrize("path", ["server_config.initial_lr_clients",
                                  "client_config.optimizer_config.lrr",
                                  "server_config.megakernel.pallas"])
def test_unknown_keys_raise(path):
    with pytest.raises(ValueError, match="unknown config key"):
        FLUTEConfig.from_dict(_with(path, 1))


def test_features_left_off_and_dispatch_knobs_pass():
    raw = _with("server_config.wantRL", False)
    raw["server_config"].update(pipeline_depth=2, rounds_per_step=25,
                                compilation_cache_dir=".jax_cache")
    raw["dp_config"] = {"enable_local_dp": False}
    raw["server_config"]["cohort_bucketing"] = {"enable": False}
    cfg = FLUTEConfig.from_dict(raw)
    assert cfg.server_config.rounds_per_step == 25


def test_clients_per_round_range():
    import numpy as np
    rng = np.random.default_rng(0)
    draws = {parse_clients_per_round("3:5", rng) for _ in range(50)}
    assert draws == {3, 4, 5}
    assert parse_clients_per_round(7, rng) == 7


def _ringlm():
    with open(os.path.join(REPO, "experiments", "ringlm",
                           "config.yaml")) as fh:
        return yaml.safe_load(fh)


def test_ringlm_config_parses_and_ignores_the_tile_knobs():
    from msrflute_tpu_torch.models import make_task
    raw = _ringlm()
    raw["model_config"].update(flash_attention=True)
    raw["server_config"]["megakernel"] = {"pallas_apply": True}
    plain = make_task(FLUTEConfig.from_dict(raw).model_config)
    raw["model_config"].update(flash_block_q=256, flash_block_k=512)
    cfg = FLUTEConfig.from_dict(raw)
    assert cfg.model_config.model_type == "RINGLM"
    task = make_task(cfg.model_config)
    assert task.param_spec() == plain.param_spec()
    assert task.module.block_0._MHA_0.use_flash


@pytest.mark.parametrize("key,value", [
    ("flash_attention", "auto"),
    ("remat", True),
    ("moe_experts", 2),
])
def test_ringlm_features_outside_the_slice_raise(key, value):
    """RingLM's last three options were refused until the model-options
    slice; now each parses and builds its task
    (``tests/test_torch_ringlm_options.py`` holds them to the JAX
    package): ``"auto"`` at the shipped ``seq_len`` (1,023 tokens) takes
    the dense arm, ``remat`` keeps the parameter tree, and the MoE FFN
    replaces each block's MLP."""
    from msrflute_tpu_torch.models import make_task
    raw = _ringlm()
    plain = make_task(FLUTEConfig.from_dict(_ringlm()).model_config)
    raw["model_config"][key] = value
    task = make_task(FLUTEConfig.from_dict(raw).model_config)
    block = task.module.block_0
    if key == "moe_experts":
        assert [n for n, _ in task.param_spec() if n.startswith(
            "block_0.")][-3:] == ["block_0.moe_ffn.router",
                                  "block_0.moe_ffn.w_in",
                                  "block_0.moe_ffn.w_out"]
        assert not hasattr(block, "Dense_0")
    else:
        assert task.param_spec() == plain.param_spec()
        assert block.remat == (key == "remat")
        assert not block._MHA_0.use_flash


def test_ringlm_task_refuses_what_the_config_refuses():
    from msrflute_tpu_torch.models import make_task
    mc = dict(_ringlm()["model_config"], moe_experts=4, moe_ep_axis="expert")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_task(mc)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FLUTEConfig.from_dict(dict(_ringlm(), model_config=mc))
    with pytest.raises(ValueError, match="bool or 'auto'"):
        FLUTEConfig.from_dict(dict(_ringlm(), model_config=dict(
            _ringlm()["model_config"], flash_attention="sometimes")))


@pytest.mark.parametrize("name,model_type,params", [
    ("cv_resnet_fedcifar100", "RESNET", 11_227_812),
    ("nlp_rnn_fedshakespeare", "RNN", 820_522),
    ("classif_cnn", "CIFAR_CNN", 319_178),
])
def test_slice_six_configs_parse_and_build_their_task(name, model_type,
                                                      params):
    """The published configs of ResNet-18-GN, the Shakespeare LSTM and
    CIFAR_CNN parse (``compilation_cache_dir`` ignored) and build their
    task at the published widths."""
    from msrflute_tpu_torch.models import make_task
    with open(os.path.join(REPO, "experiments", name, "config.yaml")) as fh:
        cfg = FLUTEConfig.from_dict(yaml.safe_load(fh))
    assert cfg.model_config.model_type == model_type
    assert make_task(cfg.model_config).layout().numel == params


@pytest.mark.parametrize("model_type", ["ResNet", "LSTM"])
def test_model_type_aliases_build_the_same_task(model_type):
    from msrflute_tpu_torch.models import make_task
    alias = FLUTEConfig.from_dict(_with("model_config.model_type",
                                        model_type)).model_config
    canon = dict(alias, model_type={"ResNet": "RESNET",
                                    "LSTM": "RNN"}[model_type])
    assert make_task(alias).param_spec() == make_task(canon).param_spec()


@pytest.mark.parametrize("model_type,key,value", [
    ("RNN", "quant_threshold", 0.7),
])
def test_keys_the_new_models_do_not_port_still_raise(model_type, key, value):
    raw = _with("model_config.model_type", model_type)
    raw["model_config"][key] = value
    with pytest.raises(NotImplementedError, match="not yet ported"):
        FLUTEConfig.from_dict(raw)


@pytest.mark.parametrize("model_type,key,value", [
    ("RINGLM", "remat", True),
    ("RESNET", "pretrained_model_path", "resnet.msgpack"),
])
def test_keys_the_model_options_slice_ports_parse(model_type, key, value):
    """``remat`` and ``pretrained_model_path``, refused until the
    model-options slice, parse now (the warm start reads its file when
    the server is built: ``tests/test_torch_pretrained.py``)."""
    raw = _with("model_config.model_type", model_type)
    raw["model_config"][key] = value
    cfg = FLUTEConfig.from_dict(raw)
    assert cfg.model_config[key] == value


def test_classif_cnn_hdf5_blobs_are_refused_at_load(tmp_path):
    """``experiments/classif_cnn`` points at hdf5 blobs, which the reader
    now reads (``tests/test_torch_hdf5.py``); a file that is not hdf5
    under that extension is refused at load instead of misread."""
    from msrflute_tpu_torch.data import load_user_blob
    path = tmp_path / "train.hdf5"
    path.write_bytes(b"")
    with pytest.raises(OSError):
        load_user_blob(str(path))


@pytest.mark.parametrize("name,strategy,server_type", [
    ("hello_mlp", "fedavg", "model_optimization"),
    ("cv", "fedavg", "personalization"),
    ("semisupervision", "fedlabels", "optimization"),
])
def test_slice_seven_configs_parse(name, strategy, server_type):
    """The plugin, personalization and FedLabels configs the repo ships
    parse as published."""
    with open(os.path.join(REPO, "experiments", name, "config.yaml")) as fh:
        cfg = FLUTEConfig.from_dict(yaml.safe_load(fh))
    assert cfg.strategy == strategy
    assert cfg.server_config.type == server_type


def _semisup():
    with open(os.path.join(REPO, "experiments", "semisupervision",
                           "config.yaml")) as fh:
        return yaml.safe_load(fh)


@pytest.mark.parametrize("path,value,error", [
    ("client_config.semisupervision.comp", "entropy", NotImplementedError),
    ("client_config.semisupervision.tau", 1.0, ValueError),
    ("client_config.data_config.train.augment.type", "autoaugment",
     NotImplementedError),
    ("client_config.data_config.train.augment.ops", 2, ValueError),
    ("dp_config", {"enable_local_dp": True,
                   "adaptive_clipping": {"target_quantile": 0.5}},
     ValueError),
    ("server_config.personalization_init", "zeros", ValueError),
    ("server_config.personalization_interp", "logits", ValueError),
    ("client_config.convex_model_interp", 1.5, ValueError),
    ("server_config.type", "replay", NotImplementedError),
])
def test_slice_seven_keys_outside_the_slice_raise(path, value, error):
    """FedLabels with adaptive clipping (its local DP is accepted and reads
    nothing, ``tests/test_torch_dp_strategies.py``), a pseudo-label
    comparison other than ``var``, another augmentation, and out-of-range
    personalization keys still fail loudly."""
    raw = _semisup()
    node = raw
    keys = path.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value
    with pytest.raises(error):
        FLUTEConfig.from_dict(raw)


def _build_both(raw, tmp_path):
    """The JAX package's server and the port's on ``raw`` (four users of
    arrays the constructors never read): each outcome, None when the
    server is built, else the exception's type."""
    import numpy as np
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    from msrflute_tpu.data import ArraysDataset as JaxArraysDataset
    from msrflute_tpu.engine.server import select_server as jax_select
    from msrflute_tpu.models import make_task as jax_make_task
    from msrflute_tpu.parallel import make_mesh
    from msrflute_tpu_torch.data.dataset import ArraysDataset
    from msrflute_tpu_torch.engine.server import select_server
    from msrflute_tpu_torch.models import make_task

    def data(cls, seed):
        rng = np.random.default_rng(seed)
        return cls([f"u{i}" for i in range(4)],
                   [{"x": rng.random((6, 4), dtype=np.float32),
                     "y": rng.integers(0, 4, 6).astype(np.int32)}
                    for _ in range(4)])

    def jax_server():
        cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
        jax_select(cfg.server_config.get("type"))(
            jax_make_task(cfg.model_config), cfg, data(JaxArraysDataset, 0),
            val_dataset=data(JaxArraysDataset, 1),
            model_dir=str(tmp_path / "jax"), mesh=make_mesh(num_devices=1),
            seed=0)

    def port_server():
        cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
        server = select_server(cfg.server_config.get("type"))(
            make_task(cfg.model_config), cfg, data(ArraysDataset, 0),
            val_dataset=data(ArraysDataset, 1),
            model_dir=str(tmp_path / "port"), device="cpu", seed=0)
        # no carry on these strategies: the plain round, on the ring
        assert not server.strategy.device_carry and server._pipeline_ok()

    outcomes = []
    for build in (jax_server, port_server):
        try:
            build()
            outcomes.append(None)
        except Exception as exc:   # the type is what is compared
            outcomes.append(type(exc))
    return outcomes


@pytest.mark.parametrize("config", ["fedavg_cnn", "fedlabels"])
def test_fused_carry_does_what_the_jax_package_does(config, tmp_path):
    """``server_config.fused_carry: true`` on a strategy without carry
    state (the FedAvg CNN of :data:`BASE`, the shipped FedLabels config):
    the JAX package builds its server and runs the plain round; so does
    the port."""
    raw = copy.deepcopy(BASE) if config == "fedavg_cnn" else _semisup()
    raw["server_config"]["fused_carry"] = True
    # the JAX round refuses megakernel.pallas_apply on the CPU backend
    raw["server_config"].pop("megakernel", None)
    jax_outcome, port_outcome = _build_both(raw, tmp_path)
    assert jax_outcome is None and port_outcome is None, \
        (jax_outcome, port_outcome)


def _shipped(name):
    with open(os.path.join(REPO, "experiments", name, "config.yaml")) as fh:
        return yaml.safe_load(fh)


@pytest.mark.parametrize("name,client_opt", [
    ("ecg_cnn", "adam"), ("fednewsrec", "adam"), ("mlm_bert", "adamW")])
def test_slice_eight_shipped_configs_load(name, client_opt):
    """The three configs slice 8 ports load as shipped (mlm_bert on one
    device: ``model_axis_size: 1``), client Adam family included."""
    raw = _shipped(name)
    if name == "mlm_bert":
        raw["mesh_config"]["model_axis_size"] = 1
    cfg = FLUTEConfig.from_dict(raw)
    assert cfg.client_config.optimizer_config.type == client_opt
    if name == "mlm_bert":
        pm = cfg.privacy_metrics_config
        assert pm.apply_metrics and pm.adaptive_leakage_threshold == 0.95
        assert pm.attacker_optimizer_config.type == "adamax"


@pytest.mark.parametrize("size", [4, 2])
def test_mlm_bert_model_axis_raises_naming_multi_gpu(size):
    raw = _shipped("mlm_bert")
    raw["mesh_config"]["model_axis_size"] = size
    with pytest.raises(NotImplementedError,
                       match=r"multi-GPU.*ROADMAP\.md §A"):
        FLUTEConfig.from_dict(raw)


def _shipped_with(path, value):
    raw = _shipped("fednewsrec" if path == "model_config.arch"
                   else "mlm_bert")
    raw.setdefault("mesh_config", {})["model_axis_size"] = 1
    node = raw
    keys = path.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value
    return raw


@pytest.mark.parametrize("path,value", [
    ("model_config.BERT.model.model_name_or_path", "/ckpt"),
])
def test_slice_eight_options_not_ported_raise(path, value):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        FLUTEConfig.from_dict(_shipped_with(path, value))


@pytest.mark.parametrize("path,value", [
    ("model_config.arch", "fednewsrec"),
    ("model_config.BERT.model.mlm_head", "gathered"),
    ("model_config.BERT.model.dtype", "bfloat16"),
    ("model_config.dtype", "bfloat16"),
])
def test_slice_eight_options_ported_since_parse(path, value):
    """NRMS's reference net and BERT's gathered head and dtype, refused
    until the model-options slice, parse and build their task."""
    import torch
    from msrflute_tpu_torch.models import make_task
    raw = _shipped_with(path, value)
    if path != "model_config.arch":
        # BERT-base would take seconds to build on the CPU
        raw["model_config"]["BERT"]["model"].update(
            hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, vocab_size=100)
    task = make_task(FLUTEConfig.from_dict(raw).model_config)
    if path == "model_config.arch":
        assert type(task).__name__ == "FedNewsRecRefTask"
    elif path.endswith("mlm_head"):
        assert task.mlm_head == "gathered" and task.gathered_slots == 40
    else:
        assert task.compute_dtype == torch.bfloat16


# ----------------------------------------------------------------------
# the optimizer family, layer controls, precision policy and model dtype
# ----------------------------------------------------------------------
@pytest.mark.parametrize("path,value", [
    ("model_config.dtype", "bfloat16"),
    ("model_config.dtype", "f16"),
    ("server_config.precision", {"params": "bfloat16",
                                 "compute": "bfloat16",
                                 "stats": "float32"}),
    ("server_config.precision", {"enable": False, "compute": "float16"}),
    ("client_config.optimizer_config", {"type": "sgd", "lr": 0.1,
                                        "momentum": 0.9, "nesterov": True,
                                        "weight_decay": 1e-4}),
    ("server_config.optimizer_config", {"type": "lamb", "lr": 0.01,
                                        "weight_decay": 0.01}),
    ("server_config.optimizer_config", {"type": "lars", "lr": 0.1,
                                        "momentum": 0.9}),
    ("server_config.optimizer_config", {"type": "LarsSGD", "lr": 0.1}),
    ("server_config.optimizer_config", {"type": "yogi", "lr": 0.01,
                                        "betas": [0.9, 0.99], "eps": 1e-3,
                                        "weight_decay": 1e-4}),
    ("client_config.optimizer_config", {"type": "adamW", "lr": 1e-3,
                                        "weight_decay": 0.01}),
    ("server_config.annealing_config", {
        "type": "rampup-keep-expdecay-keep", "peak_lr": 1.0,
        "floor_lr": 0.01, "rampup_steps": 10, "hold_steps": 5,
        "decay_steps": 100}),
    ("client_config.freeze_layer", ["Conv_0", "Dense_1/bias"]),
    ("client_config.freeze_layer", "Conv_1"),
    ("server_config.server_replay_config", {
        "server_iterations": 2, "updatable_names": [r"Dense_\d\.kernel"],
        "optimizer_config": {"type": "sgd", "lr": 0.01}}),
    ("server_config.data_config.train.train_data_server", "server.json"),
])
def test_optimizer_layer_and_precision_keys_are_accepted(path, value):
    FLUTEConfig.from_dict(_with(path, value))


@pytest.mark.parametrize("path,value,error", [
    ("model_config.dtype", "int8", ValueError),
    ("server_config.precision", {"compute": "float64"}, ValueError),
    ("server_config.precision", {"cast": "bfloat16"}, ValueError),
    ("server_config.precision", "bfloat16", ValueError),
    ("server_config.precision", {"enable": "yes"}, ValueError),
    ("client_config.optimizer_config.type", "rmsprop", ValueError),
    ("server_config.optimizer_config", {"type": "lamb", "momentum": 0.9},
     NotImplementedError),
    ("server_config.annealing_config", {"type": "cosine"}, ValueError),
    ("client_config.freeze_layer", [1, 2], ValueError),
    ("server_config.server_replay_config", {"updatable_names": "Dense"},
     ValueError),
    ("server_config.server_replay_config", {"data_config": {"a": 1}},
     NotImplementedError),
])
def test_optimizer_layer_and_precision_keys_refuse_bad_values(path, value, error):
    with pytest.raises(error):
        FLUTEConfig.from_dict(_with(path, value))


@pytest.mark.parametrize("model_type", ["GRU", "ECG_CNN", "NRMS"])
def test_precision_casts_refused_where_no_layer_casts(model_type):
    """A 16-bit ``params`` or ``compute`` needs per-layer casts, which the
    models that never read ``dtype`` lack; ``stats`` alone is fine."""
    raw = _with("model_config.model_type", model_type)
    raw["server_config"]["megakernel"] = {}
    raw["server_config"]["precision"] = {"compute": "bfloat16"}
    with pytest.raises(NotImplementedError, match="per layer"):
        FLUTEConfig.from_dict(raw)
    raw["server_config"]["precision"] = {"stats": "bfloat16"}
    FLUTEConfig.from_dict(raw)


@pytest.mark.parametrize("model", [
    {"model_type": "GRU", "vocab_size": 50, "embed_dim": 8,
     "hidden_dim": 16},
    {"model_type": "ECG_CNN"},
    {"model_type": "NRMS", "vocab_size": 50, "embed_dim": 12,
     "num_heads": 2, "head_dim": 6, "max_history": 3,
     "max_title_length": 5},
])
def test_dtype_is_accepted_and_ignored_where_jax_ignores_it(model):
    """GRU, ECG_CNN and NRMS never call ``parse_dtype`` in the JAX package:
    their ``dtype`` changes nothing (ROADMAP.md §C)."""
    from msrflute_tpu_torch.models import make_task
    raw = _with("model_config", dict(model, dtype="bfloat16"))
    raw["server_config"]["megakernel"] = {}
    cfg = FLUTEConfig.from_dict(raw)
    task = make_task(cfg.model_config)
    plain = make_task(dict(model))
    assert task.param_spec() == plain.param_spec()
    assert getattr(task.module, "dtype", None) is None


def test_client_updatable_layers_is_accepted_and_ignored():
    """The JAX round never passes ``client_config.updatable_layers`` into
    its client update (only server replay's ``updatable_names`` reaches
    one): the port reads it nowhere either (ROADMAP.md §C)."""
    import torch
    from msrflute_tpu_torch.engine.round import RoundEngine
    from msrflute_tpu_torch.models import make_task
    from msrflute_tpu_torch.strategies import select_strategy
    raw = _with("client_config.updatable_layers", [r"Dense_0\..*"])
    raw["server_config"]["megakernel"] = {}
    cfg = FLUTEConfig.from_dict(raw)
    task = make_task(cfg.model_config)
    engine = RoundEngine(task, cfg, select_strategy(cfg.strategy)(cfg),
                         torch.device("cpu"))
    assert engine.hparams.updatable_layers is None
    assert engine.hparams.freeze_layers == ()


def _bert(**model):
    raw = _shipped("mlm_bert")
    raw["mesh_config"]["model_axis_size"] = 1
    raw["model_config"]["BERT"]["model"].update(model)
    return raw


def _chaos(**chaos):
    return _with("server_config.chaos", {"enable": True, "seed": 0,
                                         "dropout_rate": 0.1, **chaos})


@pytest.mark.parametrize("feature,raw", [
    ("infra services", lambda: _chaos(infra={"writer_error_rate": 0.1})),
    ("multi-GPU", lambda: _shipped("mlm_bert")),
    ("Hugging Face weights", lambda: _bert(model_name_or_path="/ckpt")),
    ("expert-parallel MoE dispatch", lambda: dict(_ringlm(), model_config=dict(
        _ringlm()["model_config"], moe_experts=4, moe_ep_axis="expert"))),
])
def test_refusal_messages_name_the_feature_and_the_roadmap_section(feature,
                                                                   raw):
    """Each refusal names its feature and ``ROADMAP.md §A``, and no item
    number, which goes stale as the queue moves.  The infra services, ported
    with the fleet paged carry, raise the JAX server's ValueError without
    it, which names no roadmap section."""
    if feature == "infra services":
        from msrflute_tpu_torch.config import INFRA_NEEDS_PAGING
        with pytest.raises(ValueError) as info:
            FLUTEConfig.from_dict(raw())
        assert str(info.value) == INFRA_NEEDS_PAGING
        assert not re.search(r"item\s*\d", str(info.value))
        return
    with pytest.raises(NotImplementedError) as info:
        FLUTEConfig.from_dict(raw())
    message = str(info.value)
    assert feature in message and "ROADMAP.md §A" in message, message
    assert not re.search(r"item\s*\d", message), message


#: every key of the JAX schema's telemetry block (``schema.py:334-403``)
FULL_TELEMETRY = {
    "enable": True, "trace": True, "devbus": True, "profile_rounds": "3:5",
    "xla": True, "scorecard": True, "rollup": True, "rollup_window": 4,
    "flight": True, "flight_events": 32, "max_log_mb": 64,
    "watchdog": {
        "nan_loss": "abort", "round_time_action": "log",
        "round_time_factor": 2.5, "round_time_window": 8,
        "ckpt_failure_action": "mark", "ckpt_failure_streak": 3,
        "quarantine_rate_action": "mark", "quarantine_rate_threshold": 0.5,
        "recompile_storm_action": "log", "recompile_storm_threshold": 3,
        "recompile_storm_warmup_rounds": 2, "stall_action": "off",
        "stall_factor": 10.0, "stall_poll_secs": 5.0,
        "stall_grace_secs": 30.0, "rss_leak_action": "log",
        "rss_leak_window": 32, "rss_leak_mb_per_round": 1.0,
        "throughput_drift_action": "log", "throughput_drift_window": 16,
        "throughput_drift_factor": 1.5}}


def test_full_telemetry_block_is_accepted_as_in_the_jax_package():
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    from msrflute_tpu_torch.config import (TELEMETRY_KEYS, WATCHDOG_KEYS)
    from msrflute_tpu import schema
    assert set(FULL_TELEMETRY) == TELEMETRY_KEYS == schema.TELEMETRY_KEYS
    assert set(FULL_TELEMETRY["watchdog"]) == WATCHDOG_KEYS == \
        schema.WATCHDOG_KEYS
    raw = _with("server_config.telemetry", copy.deepcopy(FULL_TELEMETRY))
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    assert cfg.server_config.get("telemetry") == FULL_TELEMETRY
    JaxFLUTEConfig.from_dict(raw)


@pytest.mark.parametrize("block", [
    {"telemetry": {"enalbe": True}},
    {"telemetry": {"watchdog": {"nan_loss": "explode"}}},
    {"telemetry": {"profile_rounds": "7:3"}},
    {"telemetry": {"watchdog": {"round_time_factor": 0.5}}},
    {"telemetry": {"watchdog": "abort"}},
    {"telemetry": True},
    {"telemetry": {"rollup_window": 0, "flight_events": 2,
                   "watchdog": {"stall_action": "panic", "stal": 1}}},
], ids=["unknown", "action", "window", "factor", "watchdog_str", "bool",
        "several"])
def test_bad_telemetry_blocks_raise_the_jax_message(block):
    """Each case of ``test_telemetry.py::
    test_schema_rejects_bad_telemetry_blocks``, and one with several
    faults: the port's ``SchemaError`` lists the JAX schema's messages."""
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    from msrflute_tpu_torch.config import SchemaError
    raw = copy.deepcopy(BASE)
    raw["server_config"].update(copy.deepcopy(block))
    with pytest.raises(ValueError) as want:
        JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(SchemaError) as got:
        FLUTEConfig.from_dict(copy.deepcopy(raw))
    assert got.value.errors == want.value.errors


@pytest.mark.parametrize("path,value", [
    ("server_config.send_dicts", "yes"),
    ("server_config.initial_lr", -1),
    ("client_config.copying_train_data", 1),
    ("client_config.ignore_subtask", "no"),
    ("server_config.data_config.val.wantLogits", "true"),
    ("server_config.data_config.test.per_user_stats", 1),
])
def test_inert_keys_and_eval_outputs_check_types_as_the_jax_schema(path,
                                                                   value):
    """The inert keys and the eval outputs are accepted with the JAX
    schema's types only: a wrong type raises its ``SchemaError`` message
    in both packages."""
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    from msrflute_tpu_torch.config import SchemaError
    with pytest.raises(SchemaError, match=re.escape(path)):
        FLUTEConfig.from_dict(_with(path, value))
    with pytest.raises(ValueError, match=re.escape(path)):
        JaxFLUTEConfig.from_dict(_with(path, value))


@pytest.mark.parametrize("path,value", [
    ("client_config.meta_learning", "maml"),
    ("client_config.meta_optimizer_config", {"type": "adam", "lr": 0.1}),
    ("server_config.nbest_task_scheduler", {"num_tasks": [1, 2]}),
    ("client_config.data_config.train.min_words_per_utt", 3),
    ("server_config.data_config.val.wantLogits", True),
    ("server_config.data_config.test.per_user_stats", True),
])
def test_inert_keys_and_eval_outputs_are_accepted_as_in_the_jax_package(
        path, value):
    """Any value of a key nothing in the JAX package reads is accepted
    (``client_config.meta_learning: maml`` was refused before), and the eval
    outputs parse, in both packages."""
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    FLUTEConfig.from_dict(_with(path, value))
    JaxFLUTEConfig.from_dict(_with(path, value))
