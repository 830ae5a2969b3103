"""The port's config gate: the published configs of the slice parse, and every
config outside the slice fails loudly — ``NotImplementedError`` for a
feature the port does not have yet, ``ValueError`` for an unknown key —
instead of running as something else."""

import copy
import os

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


def _with(path, value):
    raw = copy.deepcopy(BASE)
    node = raw
    keys = path.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value
    return raw


@pytest.mark.parametrize("path,value", [
    ("strategy", "dga"),
    ("strategy", "scaffold"),
    ("model_config.model_type", "CIFAR_CNN"),
    ("model_config.dtype", "bfloat16"),
    ("client_config.optimizer_config.type", "adam"),
    ("client_config.optimizer_config.nesterov", True),
    ("server_config.optimizer_config.type", "yogi"),
    ("server_config.cohort_bucketing", {"enable": True}),
    ("server_config.megabatch", {"enable": True}),
    ("server_config.traffic", {"mode": "buffered"}),
    ("server_config.fleet", {"enable": True}),
    ("server_config.chaos", {"enable": True, "dropout_rate": 0.1}),
    ("server_config.precision", {"compute": "bfloat16"}),
    ("client_config.quant_bits", 8),
    ("client_config.data_config.train.lazy", True),
    ("client_config.optimizer_config.dampening", 0.1),
    ("server_config.wantRL", True),
    ("client_config.freeze_layer", ["Conv_0"]),
    ("dp_config", {"enable_local_dp": True}),
    ("server_config.annealing_config", {"type": "rampup-keep-expdecay-keep"}),
])
def test_unported_features_raise(path, value):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        FLUTEConfig.from_dict(_with(path, value))


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
