"""Default-run parity of the port with the JAX package
(``msrflute_tpu_torch/config.py``, ``utils/logging.py``,
``engine/server.py``, ``engine/checkpoint.py``, ``engine/evaluation.py``,
``resilience/preemption.py``):

- the thirteen keys the JAX schema accepts and no JAX module reads pass
  both packages' validation of ``experiments/classif_cnn/config.yaml``,
  and a wrong type raises the JAX schema's message in both;
- ``do_profiling`` (server or client) writes a ``torch.profiler`` trace of
  one chunk under ``<model_dir>/profile``;
- the event records of a run with chaos's client faults and corruption,
  fluteshield's quarantine, checkpoint-IO faults and the preemption drill
  equal the JAX server's in kind, order and fields (``ts`` and ``thread``
  aside): in order on each thread, since the async ``latest`` writer
  emits its faults on its own thread in both packages; a non-finite eval
  writes ``eval_nonfinite_skipped``; an event off the main thread names
  its thread;
- a ranged cohort (``"2:5"``) packed two rounds a chunk, host-packed and
  pooled: the cohorts and val losses are the JAX server's, the port's
  ``paddingEfficiency`` and ``hostToDeviceBytesPerRound`` are those of its
  own per-round grids, and the JAX meters exceed them by exactly its
  padding clients (the kept difference of ROADMAP.md §C).
"""

import copy
import json
import threading

import numpy as np
import pytest
import yaml

import msrflute_tpu.telemetry.metrics as jax_metrics
from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu_torch.config import FLUTEConfig, SchemaError
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.tasks import build_task_datasets
from msrflute_tpu_torch.utils.logging import MetricsLog
from test_torch_strategies import (jax_history, lr_blob, lr_config,  # noqa
                                   port_cli_history)

SHIPPED = "experiments/classif_cnn/config.yaml"

#: ``(path, value)``: each key at a value the JAX schema accepts
SCHEMA_ONLY = [
    ("server_config.best_model_metric", "acc"),
    ("server_config.updatable_names", ["Dense_0.*"]),
    ("client_config.ss_config", {"mode": "fixmatch"}),
    ("client_config.data_config.train.max_seq_length", 64),
    ("client_config.data_config.train.num_frames", 187),
    ("client_config.data_config.train.max_samples_per_user", 100),
    ("client_config.data_config.train.max_grad_norm", 1.0),
    ("client_config.data_config.train.utterance_mvn", True),
    ("client_config.data_config.train.unsorted_batch", True),
    ("client_config.optimizer_config.dampening", 0.1),
    ("dp_config.enable_prod", True),
    ("dp_config.max_bound", 1.0),
    ("dp_config.min_bound", 0.0),
]


def _shipped():
    with open(SHIPPED) as fh:
        return yaml.safe_load(fh)


def _set(raw, path, value):
    node = raw
    keys = path.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value
    return raw


@pytest.mark.parametrize("path,value", SCHEMA_ONLY)
def test_schema_only_keys_pass_both_validations(path, value):
    raw = _set(_shipped(), path, value)
    JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    assert cfg.model_config["model_type"] == "CIFAR_CNN"


@pytest.mark.parametrize("path,value", [
    ("client_config.data_config.train.max_seq_length", 0),
    ("client_config.data_config.train.unsorted_batch", "yes"),
    ("client_config.optimizer_config.dampening", 2.0),
    ("dp_config.enable_prod", 1),
    ("server_config.do_profiling", "on"),
    ("client_config.do_profiling", 1),
])
def test_wrong_types_raise_the_jax_schema_message(path, value):
    raw = _set(_shipped(), path, value)
    with pytest.raises(ValueError) as want:
        JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(SchemaError) as got:
        FLUTEConfig.from_dict(copy.deepcopy(raw))
    assert got.value.errors[0] in str(want.value)


# ----------------------------------------------------------------------
# do_profiling
# ----------------------------------------------------------------------
@pytest.mark.parametrize("section", ["server_config", "client_config"])
def test_do_profiling_writes_a_torch_profiler_trace(section, lr_blob,
                                                    tmp_path):
    raw = lr_config("fedavg", rounds=2)
    raw[section]["do_profiling"] = True
    cfg = FLUTEConfig.from_dict(raw)
    cfg.validate(lr_blob)
    task = make_task(cfg.model_config)
    train, val, _ = build_task_datasets(cfg, task)
    server = OptimizationServer(task, cfg, train, val_dataset=val,
                                model_dir=str(tmp_path), device="cpu")
    server.train()
    traces = sorted((tmp_path / "profile").iterdir())
    # the second chunk of two, as the JAX server picks it
    assert [p.name for p in traces] == ["chunk_r1.pt.trace.json"]
    with open(traces[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert any("addmm" in str(n) or "mm" in str(n) for n in names)


# ----------------------------------------------------------------------
# event records
# ----------------------------------------------------------------------
def _norm(value):
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, (int, float, np.number)):
        return float(value)
    if isinstance(value, str):
        return value.replace(".msgpack", ".pt")
    if isinstance(value, (list, tuple, np.ndarray)):
        return [_norm(v) for v in value]
    return value


def normalized(events):
    """``[(kind, {field: value})]`` less ``ts`` and ``thread``, numbers as
    floats and checkpoint names as the port's."""
    return [(e["event"], {k: _norm(v) for k, v in e.items()
                          if k not in ("ts", "event", "thread")})
            for e in events]


def by_thread(events):
    """:func:`normalized` records of the main thread and of the others,
    each in emission order: how records of two threads interleave is a
    race in both packages."""
    return {off: normalized([e for e in events if ("thread" in e) == off])
            for off in (False, True)}


@pytest.fixture
def jax_events(monkeypatch):
    """The JAX package's event records of the test, in order (its
    metrics-stream sink recorded)."""
    seen = []

    def record(kind, **fields):
        emitter = threading.current_thread()
        off = ({} if emitter is threading.main_thread()
               else {"thread": emitter.name})
        seen.append({"event": kind, **fields, **off})

    monkeypatch.setattr(jax_metrics, "log_event", record)
    return seen


EVENT_RUN = lr_config("fedavg", rounds=5, server={
    "val_freq": 2, "rounds_per_step": 2, "pipeline_depth": 1,
    "chaos": {"seed": 3, "dropout_rate": 0.3, "straggler_rate": 0.3,
              "corrupt_nan_rate": 0.3, "ckpt_io_error_rate": 0.3,
              "preempt_at_round": 4},
    "robust": {"screen_nonfinite": True, "norm_multiplier": 0.0},
    "checkpoint_retry": {"retries": 8, "backoff_base_s": 0.0,
                         "jitter": 0.0}})


def port_run(raw, data_dir, out, init_jax=None):
    """The port's server on ``raw`` (from the JAX package's initial weights
    when given), its metrics stream in ``out/log``; trained."""
    from msrflute_tpu_torch.models.convert import from_jax_params
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(data_dir)
    task = make_task(cfg.model_config)
    train, val, _ = build_task_datasets(cfg, task)
    log = MetricsLog(str(out / "log"))
    server = OptimizationServer(
        task, cfg, train, val_dataset=val, model_dir=str(out / "models"),
        device="cpu", metrics=log,
        init_params=(None if init_jax is None
                     else from_jax_params(task, init_jax)))
    try:
        server.train()
    finally:
        log.close()
    return server


def test_event_records_equal_the_jax_servers(lr_blob, tmp_path, jax_events):
    init, _, _ = jax_history(EVENT_RUN, lr_blob, str(tmp_path / "jax"))
    server = port_run(EVENT_RUN, lr_blob, tmp_path / "port", init)
    assert server.preempted
    got = normalized(server.metrics.events)
    kinds = {k for k, _ in got}
    assert {"chaos_faults", "chaos_corruption", "quarantine",
            "ckpt_io_fault", "preemption", "preempted_exit"} <= kinds
    assert by_thread(server.metrics.events) == by_thread(jax_events)
    assert by_thread(server.metrics.events)[True]   # the writer's faults
    assert sum(k == "ckpt_io_fault" for k, _ in got) == \
        server.chaos.counters["ckpt_io_faults"]
    # the same records, in order, in the run's metrics stream
    with open(tmp_path / "port" / "log" / "metrics.jsonl") as fh:
        stream = [json.loads(line) for line in fh]
    assert normalized([r for r in stream if "event" in r]) == got


def test_eval_nonfinite_and_off_thread_events(lr_blob, tmp_path):
    raw = lr_config("fedavg", rounds=1)
    cfg = FLUTEConfig.from_dict(raw)
    cfg.validate(lr_blob)
    task = make_task(cfg.model_config)
    train, val, _ = build_task_datasets(cfg, task)
    log = MetricsLog(str(tmp_path / "log"))
    server = OptimizationServer(task, cfg, train, val_dataset=val,
                                model_dir=str(tmp_path / "m"), device="cpu",
                                metrics=log)
    server.state.params.fill_(float("nan"))
    server._maybe_eval("val", 0)
    kinds = [(e["event"], e.get("steps"), e.get("metric"))
             for e in log.events]
    steps = server._staged_eval("val")["sample_mask"].shape[0]
    assert kinds[0] == ("eval_nonfinite_skipped", steps, None)
    assert {m for k, _, m in kinds[1:]} == {"loss", "acc"}
    assert all(k == "eval_nonfinite_skipped" for k, _, _ in kinds)
    worker = threading.Thread(target=log.event, args=("probe",),
                              kwargs={"n": np.int64(3)}, name="writer-x")
    worker.start()
    worker.join()
    assert log.events[-1]["thread"] == "writer-x"
    assert log.events[-1]["n"] == 3
    log.close()


# ----------------------------------------------------------------------
# ROADMAP.md §C: a ranged cohort packed two rounds a chunk
# ----------------------------------------------------------------------
RANGED = lr_config("fedavg", rounds=4, server={
    "num_clients_per_iteration": "2:5", "rounds_per_step": 2,
    "val_freq": 2})


def _ranged(pool):
    raw = copy.deepcopy(RANGED)
    if pool:
        raw["client_config"]["data_config"]["train"]["device_resident"] = \
            True
    return raw


@pytest.mark.parametrize("pool", [False, True], ids=["host", "pool"])
def test_ranged_cohort_meters_are_the_ports_own_grids(pool, lr_blob,
                                                      tmp_path, monkeypatch):
    from msrflute_tpu.engine import server as jax_server_module
    raw = _ranged(pool)
    jax_cohorts, port_cohorts = [], []
    sample = jax_server_module.OptimizationServer._sample

    def jax_sample(self):
        jax_cohorts.append([int(c) for c in sample(self)])
        return jax_cohorts[-1]

    monkeypatch.setattr(jax_server_module.OptimizationServer, "_sample",
                        jax_sample)
    jservers = []
    init_server = jax_server_module.OptimizationServer.__init__

    def keep(self, *a, **kw):
        init_server(self, *a, **kw)
        jservers.append(self)

    monkeypatch.setattr(jax_server_module.OptimizationServer, "__init__",
                        keep)
    init, want, n_val = jax_history(raw, lr_blob, str(tmp_path / "jax"))
    jserver = jservers[0]
    port_sample = OptimizationServer._sample

    def record(self):
        port_cohorts.append([int(c) for c in port_sample(self)])
        return port_cohorts[-1]

    monkeypatch.setattr(OptimizationServer, "_sample", record)
    server, got = port_cli_history(raw, lr_blob, tmp_path / "port", init,
                                   monkeypatch)
    assert port_cohorts == jax_cohorts
    assert len({len(c) for c in port_cohorts}) > 1
    assert [r for r, _, _ in got] == [r for r, _, _ in want]
    for (r, gl, _), (_, wl, _) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (r, gl, wl)

    # the port's meters are its per-round grids': each round's real
    # clients times the chunk's S x B slots, at the bytes a slot stages
    # (x and y, or a pool index, and the sample mask)
    B = server.batch_size
    slot_bytes = (4 if pool else 8 * 4 + 4) + 4
    ns = np.asarray(server.train_dataset.num_samples)
    chunks = [port_cohorts[i:i + 2] for i in range(0, len(port_cohorts), 2)]
    rows = zip(chunks, server.run_stats["paddingEfficiency"],
               server.run_stats["hostToDeviceBytesPerRound"],
               jserver.run_stats["paddingEfficiency"],
               jserver.run_stats["hostToDeviceBytesPerRound"])
    for chunk, eff, h2d, jeff, jh2d in rows:
        need = max(int(np.max(-(-ns[c] // B))) for c in chunk)
        S = min(server.max_steps, 1 << (need - 1).bit_length())
        real = sum(int(ns[c].sum()) for c in chunk)
        clients = sum(len(c) for c in chunk)
        k_max = max(len(c) for c in chunk)
        assert eff == pytest.approx(real / (clients * S * B), rel=1e-12)
        assert h2d == pytest.approx(clients * S * B * slot_bytes / 2,
                                    rel=1e-12)
        # the JAX grids pad every round to the chunk's largest cohort
        padding = 2 * k_max - clients
        assert jeff == pytest.approx(real / (2 * k_max * S * B), rel=1e-12)
        assert jh2d - h2d == pytest.approx(padding * S * B * slot_bytes / 2,
                                           rel=1e-12)
    assert len(server.run_stats["paddingEfficiency"]) == len(chunks) == 2
