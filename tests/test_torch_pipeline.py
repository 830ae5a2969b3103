"""The port's dispatch/drain plane (``engine/server.py``'s ring,
``engine/round.py``'s staging and packed stats, ``engine/checkpoint.py``'s
async ``latest``), the twin of ``tests/test_server_pipeline.py`` and
``tests/test_input_staging.py``:

- the port's CLI at ``pipeline_depth`` 0, 1 and 2 x ``rounds_per_step`` 1
  and 3 on an LR blob, across val boundaries with plateau and client-LR
  decay and privacy-stats rounds: params, optimizer state,
  ``metrics.jsonl`` (timing keys aside), ``status_log.json`` and the
  checkpoint files bitwise equal;
- the port at depth 1 against the JAX package at depth 1 on one LR blob,
  within the trajectory tolerance of ``test_torch_trainer.py``;
- the host-fed paths (RL, SCAFFOLD, EF, server replay, the adaptive
  leakage threshold, personalization) run serial;
- ``checkpoint_async`` defaults on when pipelined, and ``false`` wins;
- a run stopped after round 3 (or 4) and resumed at depth 1 equals the
  uninterrupted run bitwise;
- ``latest`` holds the state after a fall-back or a server replay, and a
  resume there replays the run; a resume whose status log is a chunk
  ahead of the loaded slot (an async save in flight, a torn ``latest``)
  takes the status ring's entry for that slot;
- ``pack_round_batches`` gives the JAX package's grids (gathered by its
  native packer) for the same draws;
- staged and per-leaf inputs give bitwise-equal params, chaos on and off;
  a staged dispatch makes one host-to-device copy per dtype group, and
  the stats are fetched once a chunk.
"""

import copy
import json
import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch
import yaml

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.data.batching import \
    pack_round_batches as jax_pack_round_batches
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch import e2e_trainer
from msrflute_tpu_torch.config import FLUTEConfig, SchemaError
from msrflute_tpu_torch.data.batching import pack_round_batches
from msrflute_tpu_torch.data.dataset import ArraysDataset
from msrflute_tpu_torch.engine import round as round_mod
from msrflute_tpu_torch.engine.checkpoint import (CheckpointManager,
                                                  read_verified)
from msrflute_tpu_torch.engine.server import select_server
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params
from msrflute_tpu_torch.tasks import build_task_datasets

ROUNDS = 9


def _write_blob(path, num_users, lo, hi, seed, random_labels=False):
    """8-feature, 4-class users; labels from one shared weight matrix, or
    random ones (a val split on which the val loss worsens as the model
    fits the train split: a plateau and client-LR decay every time)."""
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(99).normal(size=(8, 4))
    users = [f"u{seed}_{i:03d}" for i in range(num_users)]
    data, labels, counts = {}, {}, []
    for u in users:
        n = int(rng.integers(lo, hi + 1))
        x = rng.normal(size=(n, 8))
        y = (rng.integers(0, 4, n) if random_labels else
             np.argmax(x @ w + 0.1 * rng.normal(size=(n, 4)), axis=1))
        data[u] = {"x": x.tolist()}
        labels[u] = y.tolist()
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": counts, "user_data": data,
                   "user_data_label": labels}, fh)


@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline_blob")
    _write_blob(d / "train.json", 16, 6, 24, seed=0)
    _write_blob(d / "val.json", 4, 12, 12, seed=5, random_labels=True)
    _write_blob(d / "val_clean.json", 3, 6, 24, seed=1)
    _write_blob(d / "server.json", 2, 10, 10, seed=2)
    return str(d)


def _raw(depth, rps=1, rounds=ROUNDS, **server_over):
    raw = {
        "model_config": {"model_type": "LR", "num_classes": 4,
                         "input_dim": 8},
        "strategy": "fedavg",
        # the privacy stats cross in the packed buffer and are processed
        # in the host tail; no adaptive threshold, so the ring may run
        "privacy_metrics_config": {"apply_metrics": True},
        "server_config": {
            "max_iteration": rounds, "num_clients_per_iteration": 4,
            "initial_lr_client": 0.2, "pipeline_depth": depth,
            "rounds_per_step": rps,
            # the host-tail state the ring must not reorder: plateau
            # server-LR decay and client-LR decay at val boundaries, epoch
            # backups between boundaries
            "lr_decay_factor": 0.5, "model_backup_freq": 2,
            "val_freq": 3, "rec_freq": 1000, "initial_val": False,
            "best_model_criterion": "loss",
            "optimizer_config": {"type": "sgd", "lr": 1.0,
                                 "momentum": 0.5},
            "annealing_config": {"type": "val_loss", "patience": 0,
                                 "factor": 0.5},
            "data_config": {"val": {"batch_size": 8,
                                    "val_data": "val.json"}}},
        "client_config": {
            "optimizer_config": {"type": "sgd", "lr": 0.2},
            "data_config": {"train": {"batch_size": 4,
                                      "list_of_train_data": "train.json"}}},
    }
    raw["server_config"].update(server_over)
    return raw


def _cli(raw, data_dir, out):
    os.makedirs(out, exist_ok=True)
    cfg_path = os.path.join(out, "cfg.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(raw, fh)
    return e2e_trainer.main(["-config", cfg_path, "-dataPath", data_dir,
                             "-outputPath", os.path.join(out, "run"),
                             "-device", "cpu"])


def _records(out):
    """metrics.jsonl in order, less the wall-clock fields: ``ts`` and the
    timing summaries."""
    with open(os.path.join(out, "run", "log", "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs
            if "name" in r and not r["name"].startswith("secs")]


def _files(out):
    """Every checkpoint file's bytes, and the status log."""
    models = os.path.join(out, "run", "models")
    blobs = {name: open(os.path.join(models, name), "rb").read()
             for name in sorted(os.listdir(models))
             if name != "status_log.json"}
    with open(os.path.join(models, "status_log.json")) as fh:
        return blobs, json.load(fh)


SETTINGS = [(d, r) for r in (1, 3) for d in (0, 1, 2)]


@pytest.fixture(scope="module")
def runs(blob, tmp_path_factory):
    out = {}
    for depth, rps in SETTINGS:
        d = str(tmp_path_factory.mktemp(f"d{depth}_r{rps}"))
        server = _cli(_raw(depth, rps), blob, d)
        out[(depth, rps)] = (server, _records(d), *_files(d))
    return out


@pytest.mark.parametrize("rps", [1, 3])
def test_pipeline_depths_are_bit_identical(rps, runs):
    """Each depth against depth 0 at one chunk size.  (The chunk size
    itself changes the draw order, a chunk sampling its R cohorts before
    it packs them, in both packages.)"""
    base_srv, base_recs, base_files, base_status = runs[(0, rps)]
    names = {r["name"] for r in base_recs}
    # the state machinery under test fired
    assert "Dropped clients" in names
    lrs = [r["value"] for r in base_recs if r["name"] == "LR for agg. opt."]
    assert len(set(lrs)) > 1, "plateau decay never fired"
    clrs = [r["value"] for r in base_recs
            if r["name"] == "Client learning rate"]
    assert len(set(clrs)) > 1, "client-LR decay never fired"
    assert base_status["i"] == ROUNDS
    for depth in (1, 2):
        srv, recs, files, status = runs[(depth, rps)]
        assert srv.state.round == ROUNDS
        assert torch.equal(srv.state.params, base_srv.state.params), depth
        assert set(srv.state.opt_state) == set(base_srv.state.opt_state)
        for k, v in srv.state.opt_state.items():
            assert torch.equal(v, base_srv.state.opt_state[k]), depth
        assert recs == base_recs, depth
        assert status == base_status, depth
        # latest, its previous slot, the epoch backups and best models,
        # byte for byte
        assert files == base_files, depth


def test_ring_overlapped_and_timed(runs):
    # depth >= 1 with 9 one-round chunks: 6 sit strictly inside the val
    # boundaries at 3, 6 and 9 and drain behind a later dispatch
    assert runs[(0, 1)][0].pipelined_chunks == 0
    assert runs[(0, 3)][0].pipelined_chunks == 0
    assert runs[(1, 1)][0].pipelined_chunks == 6
    assert runs[(2, 1)][0].pipelined_chunks == 6
    # 3-round chunks end on every boundary: nothing overlaps
    assert runs[(1, 3)][0].pipelined_chunks == 0
    srv = runs[(1, 1)][0]
    for key in ("secsPerRound", "secsPerRoundPack", "secsPerRoundStage",
                "secsPerRoundDispatch", "secsPerRoundDrainWait",
                "secsPerRoundHostTail", "secsPerRoundCkptSubmit",
                "secsPerRoundHousekeeping"):
        assert len(srv.run_stats[key]) == ROUNDS, key
    # one entry a round: a chunk's rounds share its value
    secs = runs[(1, 3)][0].run_stats["secsPerRound"]
    assert len(secs) == ROUNDS and len(set(secs[:3])) == 1
    assert srv.ckpt.async_latest and not runs[(0, 1)][0].ckpt.async_latest


def test_checkpoint_files_load_back(runs):
    _, _, files, status = runs[(2, 1)]
    assert {"latest_model.pt", "latest_model.pt.prev", "epoch2.pt",
            "epoch4.pt", "epoch8.pt"} <= set(files)
    srv = runs[(2, 1)][0]
    payload = read_verified(os.path.join(srv.ckpt.model_dir,
                                         "latest_model.pt"))
    assert payload["round"] == status["i"] == ROUNDS
    assert read_verified(os.path.join(srv.ckpt.model_dir,
                                      "epoch4.pt"))["round"] == 4


def test_port_at_depth_1_matches_jax_at_depth_1(blob, tmp_path):
    raw = _raw(1, 1, initial_val=True, lr_decay_factor=1.0,
               annealing_config={"type": "step_lr", "step_size": 100,
                                 "gamma": 1.0},
               data_config={"val": {"batch_size": 8,
                                    "val_data": "val_clean.json"}})
    raw["server_config"]["optimizer_config"] = {"type": "sgd", "lr": 1.0}
    jcfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    jcfg.validate(blob)
    jtask = jax_make_task(jcfg.model_config)
    jtrain, jval, _ = jax_build_datasets(jcfg, jtask)
    jserver = JaxServer(jtask, jcfg, jtrain, val_dataset=jval,
                        model_dir=str(tmp_path / "jax"),
                        mesh=make_mesh(num_devices=1), seed=0)
    assert jserver.pipeline_depth == 1
    init = jax.device_get(jserver.state.params)
    want, evaluate = [], jserver._maybe_eval

    def recording(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        want.append((round_no, jserver._last_val["loss"].value,
                     jserver._last_val["acc"].value))
        return improved

    jserver._maybe_eval = recording
    jserver.train()
    assert jserver.pipelined_chunks == 6

    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(blob)
    task = make_task(cfg.model_config)
    train, val, _ = build_task_datasets(cfg, task)
    server = select_server("optimization")(
        task, cfg, train, val_dataset=val, model_dir=str(tmp_path / "port"),
        device="cpu", seed=0, init_params=from_jax_params(task, init))
    server.train()
    assert server.pipelined_chunks == 6
    got = [(h["round"], h["loss"], h["acc"]) for h in server.history
           if h["split"] == "val"]
    n_val = sum(val.num_samples)
    assert [r for r, _, _ in got] == [r for r, _, _ in want] == [0, 3, 6, 9]
    for (r, gl, ga), (_, wl, wa) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (r, gl, wl)
        assert abs(ga - wa) * n_val <= 1.0 + 1e-9, (r, ga, wa)
    assert got[-1][1] < got[0][1]


def _server(raw, data_dir, model_dir, server_data=False):
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(data_dir)
    task = make_task(cfg.model_config)
    train, val, _ = build_task_datasets(cfg, task)
    extra = {}
    if server_data:
        extra["server_train_dataset"] = train
    return select_server(cfg.server_config.get("type"))(
        task, cfg, train, val_dataset=val, model_dir=model_dir,
        device="cpu", seed=0, **extra)


def _serial_legs():
    rl = {"wantRL": True, "aggregate_median": "softmax",
          "softmax_beta": 1.0,
          "RL": {"initial_epsilon": 0.6, "minibatch_size": 4,
                 "network_params": [16, 8, 4],
                 "optimizer_config": {"type": "sgd", "lr": 0.05}}}
    return {
        "rl": (_raw(1, 3, **rl), "dga", {}),
        "scaffold": (_raw(1, 3), "scaffold", {}),
        "ef_quant": (_raw(1, 3), "ef_quant",
                     {"quant_bits": 4, "quant_thresh": 0.2}),
        "server_replay": (_raw(1, 1, server_replay_config={
            "server_iterations": 1,
            "optimizer_config": {"type": "sgd", "lr": 0.05}}),
            "fedavg", {}),
        "adaptive_leakage": (_raw(1, 3), "fedavg", {}),
        "personalization": (_raw(1, 3, type="personalization"),
                            "fedavg", {"convex_model_interp": 0.75}),
    }


@pytest.mark.parametrize("leg", list(_serial_legs()))
def test_host_fed_paths_run_serial(leg, blob, tmp_path):
    raw, strategy, client = _serial_legs()[leg]
    raw = copy.deepcopy(raw)
    raw["strategy"] = strategy
    raw["server_config"].pop("annealing_config")
    raw["server_config"]["optimizer_config"] = {"type": "sgd", "lr": 1.0}
    raw["server_config"].update(max_iteration=4, val_freq=2)
    raw["client_config"].update(client)
    if leg == "adaptive_leakage":
        raw["privacy_metrics_config"]["adaptive_leakage_threshold"] = 0.9
    else:
        raw.pop("privacy_metrics_config")
    server = _server(raw, blob, str(tmp_path),
                     server_data=leg == "server_replay")
    assert server.pipeline_depth == 1
    assert not server._pipeline_ok()
    assert not server.ckpt.async_latest
    server.train()
    assert server.state.round == 4
    assert server.pipelined_chunks == 0


def test_personalization_hook_forces_serial(blob, tmp_path):
    raw = _raw(2, 1, type="personalization", max_iteration=3)
    raw.pop("privacy_metrics_config")
    raw["client_config"]["convex_model_interp"] = 0.75
    server = _server(raw, blob, str(tmp_path))
    assert server._sample_hooked and not server._pipeline_capable
    server.train()
    assert server.pipelined_chunks == 0
    assert server.store.alpha        # the hook ran


def test_explicit_sync_checkpoint_wins(blob, tmp_path):
    server = _server(_raw(1, 1, max_iteration=4, checkpoint_async=False),
                     blob, str(tmp_path / "sync"))
    assert server._pipeline_ok() and not server.ckpt.async_latest
    server.train()
    assert server.pipelined_chunks > 0
    assert os.path.exists(tmp_path / "sync" / "latest_model.pt")
    forced = _server(_raw(0, 1, max_iteration=2, checkpoint_async=True),
                     blob, str(tmp_path / "async"))
    assert forced.ckpt.async_latest
    forced.train()
    assert forced.ckpt.load(torch.device("cpu")).round == 2


@pytest.mark.parametrize("value,match", [
    (9, "exceeds the supported maximum 8"), (-1, "must be >= 0"),
    ("2", "must be an integer")])
def test_pipeline_depth_is_checked_like_the_jax_schema(value, match):
    with pytest.raises(SchemaError, match=match):
        FLUTEConfig.from_dict(_raw(value))
    with pytest.raises(SchemaError, match="rounds_per_step: must be >= 1"):
        FLUTEConfig.from_dict(_raw(1, 0))


@pytest.mark.parametrize("stop", [3, 4])
def test_resume_at_depth_1_is_bitwise(stop, runs, blob, tmp_path):
    out = str(tmp_path / "resumed")
    _cli(_raw(1, 1, rounds=stop), blob, out)
    resumed = _cli(_raw(1, 1, resume_from_checkpoint=True), blob, out)
    full, _, files, status = runs[(1, 1)]
    assert resumed.state.round == ROUNDS
    assert resumed.pipelined_chunks > 0
    assert torch.equal(resumed.state.params, full.state.params)
    for k, v in resumed.state.opt_state.items():
        assert torch.equal(v, full.state.opt_state[k])
    got_files, got_status = _files(out)
    assert got_status == status
    assert got_files["latest_model.pt"] == files["latest_model.pt"]


def test_pack_round_batches_equals_the_jax_packages():
    """The port gathers with numpy; the JAX package, by default, with its
    native packer: the same draws give the same bytes."""
    rng = np.random.default_rng(0)
    per = [{"x": rng.normal(size=(n, 4, 2)).astype(np.float32),
            "y": rng.integers(0, 5, n).astype(np.int64),
            "pix": rng.integers(0, 256, (n, 6)).astype(np.uint8)}
           for n in rng.integers(1, 30, 9)]
    ds = ArraysDataset([f"u{i}" for i in range(9)], per)
    cohort = [0, 3, 5, 7, 8]
    a = pack_round_batches(ds, cohort, 4, 5, rng=np.random.default_rng(42),
                           desired_max_samples=17)
    b = jax_pack_round_batches(ds, cohort, 4, 5,
                               rng=np.random.default_rng(42),
                               desired_max_samples=17)
    for k in a.arrays:
        assert a.arrays[k].dtype == b.arrays[k].dtype
        assert a.arrays[k].tobytes() == b.arrays[k].tobytes()
    for field in ("sample_mask", "num_samples", "client_mask",
                  "client_ids"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def _chaos_raw(staging, chaos):
    raw = _raw(1, 2, input_staging=staging, max_iteration=4)
    raw.pop("privacy_metrics_config")
    if chaos:
        raw["server_config"]["chaos"] = {
            "seed": 3, "dropout_rate": 0.3, "straggler_rate": 0.3,
            "corrupt_scale_rate": 0.3, "corrupt_scale_factor": 5.0}
    return raw


@pytest.mark.parametrize("chaos", [False, True])
def test_staged_and_per_leaf_inputs_are_bit_identical(chaos, blob,
                                                      tmp_path):
    a = _server(_chaos_raw(True, chaos), blob, str(tmp_path / "a"))
    b = _server(_chaos_raw(False, chaos), blob, str(tmp_path / "b"))
    assert a.engine.input_staging and not b.engine.input_staging
    a.train()
    b.train()
    assert torch.equal(a.state.params, b.state.params)
    if chaos:
        assert a.chaos.counters == b.chaos.counters
        assert a.chaos.counters["dropped"] > 0


class _Counter:
    """Counts the engine's host-to-device copies and stats fetches."""

    def __init__(self, monkeypatch):
        self.copies, self.fetches = [], 0
        real_copy, real_fetch = round_mod.to_device, \
            round_mod.PackedStats.fetch

        def counting_copy(host, device):
            self.copies.append(str(host.dtype))
            return real_copy(host, device)

        def counting_fetch(packed):
            self.fetches += 1
            self.groups = sorted(packed.host)
            return real_fetch(packed)

        monkeypatch.setattr(round_mod, "to_device", counting_copy)
        monkeypatch.setattr(round_mod.PackedStats, "fetch", counting_fetch)


@pytest.mark.parametrize("chaos", [False, True])
def test_staged_dispatch_makes_one_copy_per_dtype_group(chaos, blob,
                                                        tmp_path,
                                                        monkeypatch):
    counter = _Counter(monkeypatch)
    server = _server(_chaos_raw(True, chaos), blob, str(tmp_path / "s"))
    server.train()
    # 4 rounds in chunks of at most 2, cut at the val boundary at 3:
    # three dispatches, each staging the LR grids
    # (float32 x, int32 y) and the float32 masks; the chaos vectors
    # (float32 faults, int32 corruption modes) ride the same two groups
    groups = ["float32", "int32"]
    per_dispatch = sorted(counter.copies[:len(groups)])
    assert per_dispatch == ["torch." + g for g in groups]
    assert len(counter.copies) == 3 * len(groups)
    # the stats of a chunk: one fetch, one float32 buffer
    assert counter.fetches == 3 and counter.groups == ["float32"]
    staged = len(counter.copies)
    legacy = _Counter(monkeypatch)
    _server(_chaos_raw(False, chaos), blob, str(tmp_path / "l")).train()
    assert len(legacy.copies) > staged


@pytest.mark.parametrize("pallas", [False, True])
def test_a_dispatch_leaves_the_state_it_started_from(pallas, blob,
                                                     tmp_path):
    """The ring keeps a dispatched chunk's state (for its ``latest``
    save) while later chunks run: no round writes the server state in
    place, kernel B1's plain version included."""
    raw = _raw(1, 1, max_iteration=2, megakernel={"pallas_apply": pallas})
    server = _server(raw, blob, str(tmp_path))
    state = server.state
    before = (state.params.clone(),
              {k: v.clone() for k, v in state.opt_state.items()})
    batches = server._pack_chunk(2)
    new, packed = server.engine.dispatch_rounds(
        state, batches, [0.2, 0.2], [1.0, 1.0])
    assert len(packed.fetch()) == 2 and new.round == state.round + 2
    assert not torch.equal(new.params, state.params)
    assert torch.equal(state.params, before[0])
    for k, v in state.opt_state.items():
        assert torch.equal(v, before[1][k])


def _latest_legs():
    """Runs whose host tail replaces the state after its round: a
    fall-back to the best model (the val loss on random labels worsens)
    and server replay after every round."""
    fall_back = _raw(1, 1, fall_back_to_best_model=True)
    replay = _raw(1, 1, server_replay_config={
        "server_iterations": 1,
        "optimizer_config": {"type": "sgd", "lr": 0.05}})
    for raw in (fall_back, replay):
        raw.pop("privacy_metrics_config")
    return {"fall_back": (fall_back, False, 6), "server_replay": (replay,
                                                                  True, 4)}


@pytest.mark.parametrize("leg", list(_latest_legs()))
def test_latest_holds_the_state_the_run_ended_with(leg, blob, tmp_path):
    """``latest`` is the state after the chunk's host tail, and a resume
    from a run stopped there goes on as the uninterrupted run does."""
    raw, server_data, stop = _latest_legs()[leg]
    full = _server(raw, blob, str(tmp_path / "full"),
                   server_data=server_data)
    fell_back = []
    if leg == "fall_back":
        real = full._fall_back
        full._fall_back = lambda: (fell_back.append(full.state.round),
                                   real())
    full.train()
    if leg == "fall_back":
        assert fell_back and fell_back[-1] == ROUNDS, fell_back
    latest = full.ckpt.load(torch.device("cpu"))
    assert latest.round == full.state.round == ROUNDS
    assert torch.equal(latest.params, full.state.params)
    for k, v in full.state.opt_state.items():
        assert torch.equal(latest.opt_state[k], v)

    part = copy.deepcopy(raw)
    part["server_config"]["max_iteration"] = stop
    resumed_dir = str(tmp_path / "resumed")
    _server(part, blob, resumed_dir, server_data=server_data).train()
    again = copy.deepcopy(raw)
    again["server_config"]["resume_from_checkpoint"] = True
    resumed = _server(again, blob, resumed_dir, server_data=server_data)
    assert resumed.state.round == stop
    resumed.train()
    assert torch.equal(resumed.state.params, full.state.params)
    for k, v in resumed.state.opt_state.items():
        assert torch.equal(v, full.state.opt_state[k])


@pytest.mark.parametrize("crash", ["save_in_flight", "torn_latest"])
def test_resume_pairs_the_status_ring_with_the_loaded_slot(crash, runs,
                                                           blob, tmp_path,
                                                           monkeypatch):
    """A crash leaves the status log a chunk ahead of the loadable
    ``latest``: the async save of round 5 had not started writing (the
    status of round 5 already on disk), or ``latest`` is torn and its
    ``.prev`` slot loads.  The resume takes the ring's entry for the
    loaded round and replays the uninterrupted run bitwise."""
    model_dir = str(tmp_path / "models")
    if crash == "save_in_flight":
        crashed = str(tmp_path / "crashed")
        real = CheckpointManager._write_latest
        real_status = CheckpointManager.update_status
        copied = threading.Event()

        def stopping(ckpt, payload):
            if payload["round"] == 5 and not os.path.exists(crashed):
                # the training thread's own temporary files may come and
                # go during the copy
                shutil.copytree(ckpt.model_dir, crashed,
                                ignore=shutil.ignore_patterns("*.tmp"))
                copied.set()
            return real(ckpt, payload)

        def status_after_copy(ckpt, update):
            # round 6's status waits for the copy: the crash is the
            # moment round 5's status is on disk and its save is not
            if update.get("i") == 6:
                assert copied.wait(timeout=60), "the copy never ran"
            return real_status(ckpt, update)

        monkeypatch.setattr(CheckpointManager, "_write_latest", stopping)
        monkeypatch.setattr(CheckpointManager, "update_status",
                            status_after_copy)
        server = _server(_raw(1, 1), blob, model_dir)
        assert server.ckpt.async_latest
        server.train()
        monkeypatch.undo()
        model_dir = crashed
    else:
        _server(_raw(1, 1, max_iteration=5), blob, model_dir).train()
        with open(os.path.join(model_dir, "latest_model.pt"), "r+b") as fh:
            fh.truncate(64)
    with open(os.path.join(model_dir, "status_log.json")) as fh:
        status = json.load(fh)
    assert status["i"] == 5
    assert [e[0] for e in status["status_ring"]] == [1, 2, 3, 4, 5]
    resumed = _server(_raw(1, 1, resume_from_checkpoint=True), blob,
                      model_dir)
    assert resumed.state.round == 4
    resumed.train()
    full = runs[(1, 1)][0]
    assert torch.equal(resumed.state.params, full.state.params)
    for k, v in resumed.state.opt_state.items():
        assert torch.equal(v, full.state.opt_state[k])
