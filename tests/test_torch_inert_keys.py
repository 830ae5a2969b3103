"""The ten keys that the JAX config parses and nothing in the JAX package
reads (``msrflute_tpu/config.py:200-201, 450-453, 497-503``) are accepted
and ignored by the port, as there: each, set to a value that is not its
"off" one, gives a 2-round FedAvg LR run through the port's CLI on
``-device cpu`` whose params, val losses and status log are bitwise those
of the run without it."""

import copy
import json

import pytest
import torch
import yaml

from msrflute_tpu_torch import e2e_trainer
from test_torch_checkpoint import _write_blob
from test_torch_pretrained import _raw

INERT = [
    ("server_config.send_dicts", True),
    ("server_config.initial_lr", 0.5),
    ("server_config.num_skip_decoding", 2),
    ("server_config.nbest_task_scheduler", {"num_tasks": [1, 2],
                                            "iteration_per_task": [5, 5]}),
    ("client_config.meta_learning", "maml"),
    ("client_config.copying_train_data", True),
    ("client_config.ignore_subtask", True),
    ("client_config.meta_optimizer_config", {"type": "adam", "lr": 0.01}),
    ("client_config.data_config.train.max_batch_size", 64),
    ("client_config.data_config.train.min_words_per_utt", 5),
]


def _run(raw, data_dir, out):
    out.mkdir()
    (out / "cfg.yaml").write_text(yaml.safe_dump(raw))
    server = e2e_trainer.main(["-config", str(out / "cfg.yaml"),
                               "-dataPath", data_dir, "-outputPath",
                               str(out / "run"), "-device", "cpu"])
    losses = [h["loss"] for h in server.history if h["split"] == "val"]
    status = json.loads((out / "run" / "models" / "status_log.json")
                        .read_text())
    return server.state.params, losses, status["i"]


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    d = tmp_path_factory.mktemp("inert")
    _write_blob(d / "train.json", 12, seed=0)
    _write_blob(d / "val.json", 4, seed=1)
    return str(d), _run(_raw(2), str(d), d / "plain")


@pytest.mark.parametrize("path,value", INERT,
                         ids=[p.rsplit(".", 1)[-1] for p, _ in INERT])
def test_inert_key_changes_nothing(baseline, tmp_path, path, value):
    data_dir, (params, losses, last) = baseline
    raw = copy.deepcopy(_raw(2))
    node = raw
    keys = path.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value
    got_params, got_losses, got_last = _run(raw, data_dir, tmp_path / "run")
    assert torch.equal(got_params, params)
    assert got_losses == losses and len(losses) == 3
    assert got_last == last == 2
