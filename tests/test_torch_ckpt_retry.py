"""Checkpoint retry and escalation, and chaos's checkpoint-IO faults, in the
port (``msrflute_tpu_torch/resilience/integrity.py``, ``chaos.py``,
``engine/checkpoint.py``) against the JAX package:

- ``RetryPolicy``'s defaults, ``from_config`` and ``delay`` (exponential,
  capped, no jitter at ``jitter: 0``) equal the JAX policy's;
  ``checkpoint_retry`` out of range raises the JAX schema's
  ``SchemaError`` messages;
- ``run_with_retry`` retries an ``Exception`` and lets
  ``KeyboardInterrupt`` and ``SystemExit`` through on the first attempt;
- the IO-fault decisions of 200 calls, and the counter, are bitwise the
  JAX ``ChaosSchedule``'s;
- a run with faults (rate 0.3, six attempts a save) is bitwise the clean
  run, and its fault counter equals the JAX server's on the same config
  (the same physical attempts, in the same order of logical writes);
- a save that fails below ``escalation_threshold`` warns and the run goes
  on, at depth 0 and through the async writer at depth 1; at the
  threshold the training thread raises ``CheckpointEscalationError``.
"""

import copy
import logging

import jax
import numpy as np
import pytest
import torch

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.resilience import chaos as jax_chaos
from msrflute_tpu.resilience import integrity as jax_integrity
from msrflute_tpu.schema import SchemaError as JaxSchemaError
from msrflute_tpu.schema import validate as jax_validate
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch.config import FLUTEConfig, SchemaError
from msrflute_tpu_torch.resilience import chaos, integrity
from msrflute_tpu_torch.resilience.integrity import (
    CheckpointEscalationError, RetryPolicy, run_with_retry)
from test_torch_chaos import lr_blob, port_cli  # noqa: F401
from test_torch_strategies import lr_config

NO_WAIT = {"backoff_base_s": 0.0, "jitter": 0.0}


def test_retry_policy_matches_jax():
    assert RetryPolicy() .__dict__ == jax_integrity.RetryPolicy().__dict__
    for raw in (None, {}, {"retries": 6, "backoff_base_s": 0.1},
                {"backoff_max_s": 2.0, "jitter": 0.0,
                 "escalation_threshold": 3}):
        got = RetryPolicy.from_config(raw)
        want = jax_integrity.RetryPolicy.from_config(raw)
        assert got.__dict__ == want.__dict__
    policy = RetryPolicy(backoff_base_s=0.25, backoff_max_s=3.0, jitter=0.0)
    jpolicy = jax_integrity.RetryPolicy(backoff_base_s=0.25,
                                        backoff_max_s=3.0, jitter=0.0)
    delays = [policy.delay(a) for a in range(8)]
    assert delays == [jpolicy.delay(a) for a in range(8)]
    assert delays == [0.25, 0.5, 1.0, 2.0, 3.0, 3.0, 3.0, 3.0]
    jittered = RetryPolicy(backoff_base_s=1.0, jitter=0.25)
    assert all(0.75 <= jittered.delay(0) <= 1.25 for _ in range(50))


@pytest.mark.parametrize("block", [
    {"retries": 0}, {"backoff_base_s": -1.0}, {"jitter": 1.5},
    {"escalation_threshold": 0}, {"retries": 2.5},
    {"backoff_max_s": "long"}, {"retries": True}], ids=str)
def test_out_of_range_retry_raises_the_jax_schema_error(block):
    raw = lr_config("fedavg")
    raw["server_config"]["checkpoint_retry"] = block
    with pytest.raises(SchemaError) as port:
        FLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(JaxSchemaError) as jax_err:
        jax_validate(copy.deepcopy(raw))
    assert port.value.errors == [
        e for e in jax_err.value.errors if "checkpoint_retry" in e]


def test_unknown_retry_key_raises():
    raw = lr_config("fedavg")
    raw["server_config"]["checkpoint_retry"] = {"retry": 3}
    with pytest.raises(ValueError, match="unknown config key"):
        FLUTEConfig.from_dict(raw)


@pytest.mark.parametrize("exc", [KeyboardInterrupt, SystemExit])
def test_run_with_retry_lets_interrupts_through(exc):
    calls = []

    def fn():
        calls.append(1)
        raise exc()

    with pytest.raises(exc):
        run_with_retry(fn, RetryPolicy(retries=5, **NO_WAIT),
                       sleep=lambda s: None)
    assert calls == [1]


def test_run_with_retry_retries_then_gives_up(caplog):
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")

    policy = RetryPolicy(retries=4, backoff_base_s=0.5, jitter=0.0)
    assert run_with_retry(flaky, policy, sleep=slept.append)
    assert len(calls) == 3 and slept == [0.5, 1.0]

    def broken():
        raise OSError("down")

    slept.clear()
    with caplog.at_level(logging.WARNING):
        assert not run_with_retry(broken, policy, sleep=slept.append)
    assert slept == [0.5, 1.0, 2.0]
    assert "attempt 4/4 failed" in caplog.text


@pytest.mark.parametrize("seed,rate", [(0, 0.3), (17, 0.05), (5, 1.0),
                                       (9, 0.0)])
def test_io_fault_stream_is_bitwise_the_jax_schedule(seed, rate):
    port = chaos.ChaosSchedule(seed=seed, ckpt_io_error_rate=rate)
    ref = jax_chaos.ChaosSchedule(seed=seed, ckpt_io_error_rate=rate)
    got = [port.io_fault() for _ in range(200)]
    assert got == [ref.io_fault() for _ in range(200)]
    assert port.counters["ckpt_io_faults"] == \
        ref.counters["ckpt_io_faults"] == sum(got)
    hook = chaos.ChaosSchedule(seed=seed, ckpt_io_error_rate=rate)
    raised = 0
    for _ in range(200):
        try:
            hook.io_fault_hook()
        except OSError as exc:
            raised += 1
            assert "injected checkpoint IO fault" in str(exc)
    assert raised == sum(got)
    assert port.describe() == ref.describe()


def _jax_server(raw, data_dir, model_dir):
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(data_dir)
    task = jax_make_task(cfg.model_config)
    train, val, _ = jax_build_datasets(cfg, task)
    return JaxServer(task, cfg, train, val_dataset=val, model_dir=model_dir,
                     mesh=make_mesh(num_devices=1), seed=0)


def _faulty(rate, depth=0, **retry):
    raw = lr_config("fedavg", rounds=4, server={
        "pipeline_depth": depth, "val_freq": 2,
        "chaos": {"seed": 3, "ckpt_io_error_rate": rate},
        "checkpoint_retry": dict(NO_WAIT, **retry)})
    return raw


def test_faulty_run_is_bitwise_the_clean_run_and_counts_as_jax(lr_blob,
                                                               tmp_path):
    raw = _faulty(0.3, retries=6)
    clean = copy.deepcopy(raw)
    del clean["server_config"]["chaos"]
    a, records = port_cli(raw, lr_blob, tmp_path / "faulty")
    b, clean_records = port_cli(clean, lr_blob, tmp_path / "clean")
    assert torch.equal(a.state.params, b.state.params)
    assert records == clean_records
    # every logical write (latest a round, a best model an improvement)
    # landed after its faults
    assert a.ckpt.escalator.total == 0
    faults = a.chaos.counters["ckpt_io_faults"]
    assert faults > 0
    # the host replay of the stream over the attempts the run made
    replay = chaos.ChaosSchedule(seed=3, ckpt_io_error_rate=0.3)
    assert sum(replay.io_fault() for _ in range(a.chaos._io_calls)) == faults
    jserver = _jax_server(raw, lr_blob, str(tmp_path / "jax"))
    jserver.train()
    assert jserver.chaos._io_calls == a.chaos._io_calls
    assert jserver.chaos.counters["ckpt_io_faults"] == faults


@pytest.mark.parametrize("depth", [0, 1])
def test_failed_saves_below_the_threshold_warn_and_continue(
        depth, lr_blob, tmp_path):
    """Every save fails (one attempt each) and the run goes on, bitwise the
    clean run, with one warning a failed save."""
    raw = _faulty(1.0, depth=depth, retries=1, escalation_threshold=100)
    clean = copy.deepcopy(raw)
    del clean["server_config"]["chaos"]
    a, _ = port_cli(raw, lr_blob, tmp_path / "faulty")
    b, _ = port_cli(clean, lr_blob, tmp_path / "clean")
    assert torch.equal(a.state.params, b.state.params)
    assert a.ckpt.async_latest == (depth > 0)
    failed = a.ckpt.escalator.total
    assert failed == a.ckpt.escalator.consecutive == a.chaos._io_calls > 4
    log = (tmp_path / "faulty" / "run" / "log" / "log.out").read_text()
    assert log.count("checkpoint failure #") == failed
    assert not (tmp_path / "faulty" / "run" / "models" /
                "latest_model.pt").exists()


@pytest.mark.parametrize("depth", [0, 1])
def test_escalation_raises_on_the_training_thread(depth, lr_blob, tmp_path):
    """At ``escalation_threshold`` consecutive failed saves the run stops
    with ``CheckpointEscalationError``, raised from ``train`` on the
    calling thread, as the JAX server does on the same config."""
    raw = _faulty(1.0, depth=depth, retries=1, escalation_threshold=2)
    with pytest.raises(CheckpointEscalationError, match="2 consecutive"):
        port_cli(raw, lr_blob, tmp_path / "port")
    jserver = _jax_server(raw, lr_blob, str(tmp_path / "jax"))
    with pytest.raises(jax_integrity.CheckpointEscalationError):
        jserver.train()
    assert jserver.ckpt.escalator.consecutive == 2


def test_escalator_counts_consecutive_failures():
    esc = integrity.FailureEscalator(3)
    esc.record_failure("a")
    esc.record_failure("b")
    esc.check()
    esc.record_success()
    assert esc.consecutive == 0 and esc.total == 2
    for _ in range(3):
        esc.record_failure("c")
    with pytest.raises(CheckpointEscalationError):
        esc.check()
    assert integrity.FailureEscalator(0).threshold == 1


def test_jax_params_unchanged_by_faults(lr_blob, tmp_path):
    """The JAX server's own run with faults ends at its clean run's params
    too: the fault stream never reaches the round."""
    raw = _faulty(0.3, retries=6)
    clean = copy.deepcopy(raw)
    del clean["server_config"]["chaos"]
    a = _jax_server(raw, lr_blob, str(tmp_path / "a"))
    a.train()
    b = _jax_server(clean, lr_blob, str(tmp_path / "b"))
    b.train()
    for x, y in zip(jax.tree.leaves(a.state.params),
                    jax.tree.leaves(b.state.params)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
