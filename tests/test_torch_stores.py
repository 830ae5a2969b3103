"""SCAFFOLD's control store and table and EF quantization's residual store
and table (``strategies/scaffold.py``, ``strategies/ef_quant.py``), with
the JAX server's discipline (``msrflute_tpu/engine/server.py:771-858,
2505-2552``):

- padded client slots (id -1) read zero and write no row, on the host
  stores and the device tables (a -1 index would wrap to the last row in
  torch; the JAX package drops it out of range);
- a resume with a round marker that matches the checkpoint keeps the
  rows; a marker from another round resets them;
- a run stopped after round 2 and resumed to round 4 ends with the params
  and the rows of an uninterrupted 4-round run, bit for bit (host store
  and device table, SCAFFOLD and EF with an annealed threshold).
"""

import copy
import os

import numpy as np
import pytest
import torch

from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.strategies.ef_quant import (DeviceResidualTable,
                                                    ResidualStore)
from msrflute_tpu_torch.strategies.scaffold import (ControlStore,
                                                    DeviceControlTable,
                                                    Scaffold)
from msrflute_tpu_torch.tasks import build_task_datasets

from test_torch_strategies import lr_config, write_lr_blob

CPU = torch.device("cpu")
N, P = 6, 5
IDS = np.asarray([3, -1, 0, -1])


def _pgs(seed=0):
    return np.random.default_rng(seed).normal(size=(len(IDS), P)).astype(
        np.float32)


@pytest.mark.parametrize("on_device", [False, True])
def test_padded_ids_write_no_control_row(on_device, tmp_path):
    store = ControlStore(P, str(tmp_path))
    strat = Scaffold(FLUTEConfig.from_dict(lr_config("scaffold")))
    steps = np.asarray([3, 3, 2, 0])
    ws = np.asarray([1.0, 1.0, 2.0, 0.0], np.float32)
    if on_device:
        table = DeviceControlTable(store, N, CPU)
        table.table[N - 1] = 7.0          # where a -1 would wrap to
        off = table.offsets(IDS)
        table.update(IDS, steps, torch.from_numpy(_pgs()),
                     torch.from_numpy(ws), 0.1, total_clients=N)
        assert torch.equal(table.table[N - 1], torch.full((P,), 7.0))
        assert not table.table[[1, 2, 4]].any()
        table.flush()
    else:
        off = torch.from_numpy(store.offsets(IDS))
        strat.update_controls(store, IDS, steps, _pgs(), 0.1,
                              total_clients=N, weights=ws)
    assert not off[[1, 3]].any()
    assert store.persisted_client_ids() == [0, 3]
    for cid, row in ((3, 0), (0, 2)):
        want = _pgs()[row] / (steps[row] * np.float32(0.1))
        np.testing.assert_allclose(store.ci(cid), want, rtol=1e-6)
    np.testing.assert_allclose(store.c, (store.ci(0) + store.ci(3)) / N,
                               rtol=1e-6)


@pytest.mark.parametrize("on_device", [False, True])
def test_padded_ids_write_no_residual_row(on_device, tmp_path):
    store = ResidualStore(P, str(tmp_path))
    ws = np.asarray([1.0, 1.0, 2.0, 0.0], np.float32)
    new = _pgs(1)
    if on_device:
        table = DeviceResidualTable(store, N, CPU)
        table.table[N - 1] = 7.0
        assert not table.rows(IDS).any()
        table.update(IDS, torch.from_numpy(new), torch.from_numpy(ws))
        assert torch.equal(table.table[N - 1], torch.full((P,), 7.0))
        np.testing.assert_array_equal(table.rows(IDS)[[0, 2]].numpy(),
                                      new[[0, 2]])
        assert not table.rows(IDS)[[1, 3]].any()
        table.flush()
    else:
        store.update(IDS, new, (IDS >= 0) & (ws > 0))
    assert store.persisted_client_ids() == [0, 3]
    got = store.rows(IDS)
    np.testing.assert_array_equal(got[[0, 2]], new[[0, 2]])
    assert not got[[1, 3]].any()


@pytest.fixture(scope="module")
def lr_blob(tmp_path_factory):
    d = tmp_path_factory.mktemp("stores_blob")
    write_lr_blob(d / "train.json", 10, 6, 20, seed=9)
    write_lr_blob(d / "val.json", 2, 6, 20, seed=10)
    return str(d)


LEGS = {
    "scaffold_host": ("scaffold", {}, {"num_epochs": 2}),
    "scaffold_device": ("scaffold", {"scaffold_device_controls": True},
                        {"num_epochs": 2}),
    "ef_quant_host": ("ef_quant", {}, {"quant_bits": 3, "quant_thresh": 0.3,
                                       "quant_anneal": 0.9}),
    "ef_quant_device": ("ef_quant", {"ef_device_residuals": True},
                        {"quant_bits": 3, "quant_thresh": 0.3,
                         "quant_anneal": 0.9}),
}


def _server(leg, rounds, data_dir, model_dir, resume=False):
    strategy, server, client = LEGS[leg]
    raw = lr_config(strategy, rounds=rounds, server={
        **server, "resume_from_checkpoint": resume, "val_freq": 2},
        client=client)
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(data_dir)
    task = make_task(cfg.model_config)
    train, val, _ = build_task_datasets(cfg, task)
    return OptimizationServer(task, cfg, train, val_dataset=val,
                              model_dir=model_dir, device="cpu", seed=0)


def _rows(server):
    """Every client's stored row, and SCAFFOLD's ``c``."""
    store = server.scaffold_store or server.ef_store
    ids = np.arange(len(server.train_dataset))
    if server.scaffold_store is not None:
        return np.stack([store.ci(i) for i in ids] + [store.c])
    return store.rows(ids)


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_resume_is_bit_for_bit(leg, lr_blob, tmp_path):
    full = _server(leg, 4, lr_blob, str(tmp_path / "full"))
    full.train()
    first = _server(leg, 2, lr_blob, str(tmp_path / "cut"))
    first.train()
    resumed = _server(leg, 4, lr_blob, str(tmp_path / "cut"), resume=True)
    assert resumed.state.round == 2
    assert _rows(resumed).any()             # the rows came back
    resumed.train()
    assert torch.equal(resumed.state.params, full.state.params)
    np.testing.assert_array_equal(_rows(resumed), _rows(full))
    if leg.startswith("ef_quant"):
        # the resume replays the anneal as ``anneal ** round`` (the JAX
        # server's fast-forward), an ulp of a double off the repeated
        # product; the quantile takes the threshold as float32
        assert np.float32(resumed.strategy.quant_thresh) == \
            np.float32(full.strategy.quant_thresh)


@pytest.mark.parametrize("leg", ["scaffold_host", "ef_quant_device"])
@pytest.mark.parametrize("marker", [2, 1, -1])
def test_resume_keeps_rows_only_with_a_matching_marker(leg, marker, lr_blob,
                                                       tmp_path):
    first = _server(leg, 2, lr_blob, str(tmp_path))
    first.train()
    before = _rows(first)
    store = first.scaffold_store or first.ef_store
    store.set_round(marker)
    resumed = _server(leg, 4, lr_blob, str(tmp_path), resume=True)
    assert resumed.state.round == 2
    if marker == 2:
        np.testing.assert_array_equal(_rows(resumed), before)
    else:
        assert not _rows(resumed).any()
        sub = "scaffold" if leg.startswith("scaffold") else "ef_residuals"
        assert not [f for f in os.listdir(tmp_path / sub)
                    if not f.endswith("round.npy")]


def test_fresh_run_deletes_a_previous_runs_rows(lr_blob, tmp_path):
    first = _server("scaffold_host", 2, lr_blob, str(tmp_path))
    first.train()
    fresh = _server("scaffold_host", 2, lr_blob, str(tmp_path))
    assert not _rows(fresh).any()
