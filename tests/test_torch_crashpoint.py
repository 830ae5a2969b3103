"""Crash-point matrix of the port, the twin of ``tools/crashpoint.py`` and
``tests/test_crashpoint.py``: a kill switch counts every durable commit
(``os.replace``, ``os.rename``, ``os.link`` under the model directory) of
a 3-round run, then kills a fresh run at each of them in turn with
:class:`CrashPoint` (a ``BaseException``, which no retry loop and no
``except Exception`` may absorb, as a process death would not be) and
relaunches it with ``resume_from_checkpoint``.  Every relaunch must end at
the uninterrupted run's params and server optimizer state, and log the
same evaluations for the rounds it runs, bitwise.

Both loops: depth 0 (synchronous saves, one thread) and depth 1, where
``latest`` goes through the async writer thread and the status ring
pairs the loaded slot with its round; a kill on the writer thread is
raised on the training thread at its next submit or wait.
"""

import os
import threading

import pytest
import torch

from msrflute_tpu_torch.engine.checkpoint import CheckpointManager
from msrflute_tpu_torch.resilience.integrity import (RetryPolicy,
                                                     run_with_retry)
from test_torch_fused_carry import port_server, raw_config

#: the atomic-commit calls a durable write sequence ends with
DURABLE_OPS = ("replace", "rename", "link")
ROUNDS = 3


class CrashPoint(BaseException):
    """A simulated process death at a durable commit."""


class KillSwitch:
    """Wraps the durable-commit calls under one directory: counts them,
    and with ``kill_at=k`` raises :class:`CrashPoint` before the k-th."""

    def __init__(self):
        self._orig = {name: getattr(os, name) for name in DURABLE_OPS}
        self.scope = None
        self.kill_at = None
        self.log = []
        self._lock = threading.Lock()

    def install(self):
        for name in DURABLE_OPS:
            setattr(os, name, self._wrap(name))

    def uninstall(self):
        for name, orig in self._orig.items():
            setattr(os, name, orig)

    def arm(self, scope, kill_at=None):
        """Count (and with ``kill_at`` kill) under ``scope``; None
        disarms."""
        self.scope = None if scope is None else os.path.abspath(scope)
        self.kill_at, self.log = kill_at, []

    def _wrap(self, name):
        orig = self._orig[name]

        def wrapped(src, dst, *args, **kwargs):
            scope = self.scope
            if scope is None or not os.path.abspath(str(dst)).startswith(
                    scope):
                return orig(src, dst, *args, **kwargs)
            with self._lock:
                k = len(self.log)
                self.log.append((name, os.path.relpath(
                    os.path.abspath(str(dst)), scope)))
            if self.kill_at == k:
                raise CrashPoint(f"killed before durable op #{k}: "
                                 f"{name} -> {dst}")
            return orig(src, dst, *args, **kwargs)
        return wrapped


def _raw(depth, resume=False):
    raw = raw_config("fedavg", depth=depth, fused=False, rounds=ROUNDS,
                     val_freq=ROUNDS, resume_from_checkpoint=resume)
    raw["server_config"]["optimizer_config"] = {"type": "adam", "lr": 0.05}
    raw["server_config"]["checkpoint_retry"] = {
        "retries": 2, "backoff_base_s": 0.0, "jitter": 0.0}
    return raw


def _run(depth, model_dir, resume=False):
    server = port_server(_raw(depth, resume), model_dir, val=True)
    server.train()
    return server


def _evals(server):
    return {(h["split"], h["round"]): h for h in server.history}


@pytest.mark.parametrize("depth", [0, 1])
def test_every_kill_point_resumes_bitwise(depth, tmp_path):
    base = _run(depth, str(tmp_path / "base"))
    assert base.ckpt.async_latest == (depth == 1)
    switch = KillSwitch()
    switch.install()
    try:
        switch.arm(str(tmp_path / "census"))
        _run(depth, str(tmp_path / "census"))
        census = list(switch.log)
        switch.arm(None)
        ops = [op for op, _ in census]
        assert {"replace", "link"} <= set(ops) and len(census) > 15
        names = {rel for _, rel in census}
        for needle in ("latest_model.pt", "latest_model.pt.sum",
                       "latest_model.pt.prev.lnk", "status_log.json",
                       "best_val_loss_model.pt"):
            assert needle in names, (needle, census)
        for k in range(len(census)):
            run_dir = str(tmp_path / f"k{k:03d}")
            switch.arm(run_dir, kill_at=k)
            with pytest.raises(CrashPoint):
                _run(depth, run_dir)
            switch.arm(None)
            resumed = _run(depth, run_dir, resume=True)
            what = f"depth {depth}, kill before op {k} {census[k]}"
            assert resumed.state.round == ROUNDS, what
            assert torch.equal(resumed.state.params, base.state.params), \
                what
            for key, v in base.state.opt_state.items():
                assert torch.equal(resumed.state.opt_state[key], v), \
                    (what, key)
            want = _evals(base)
            for key, entry in _evals(resumed).items():
                assert entry == want[key], (what, key)
            assert {k: m.value for k, m in resumed.best_val.items()} == \
                {k: m.value for k, m in base.best_val.items()}, what
    finally:
        switch.uninstall()


def test_run_with_retry_never_catches_a_crash_point():
    assert issubclass(CrashPoint, BaseException)
    assert not issubclass(CrashPoint, Exception)
    calls = []

    def die():
        calls.append(1)
        raise CrashPoint("kill")

    with pytest.raises(CrashPoint):
        run_with_retry(die, RetryPolicy(retries=3, backoff_base_s=0.0,
                                        jitter=0.0))
    assert calls == [1]


@pytest.mark.parametrize("async_latest", [False, True])
def test_a_kill_in_a_save_ends_the_run(async_latest, tmp_path):
    """The write recipe's probe raising a kill: it is neither retried nor
    counted as a failed save, and it reaches the training thread (from the
    writer thread at the next wait)."""
    from test_torch_flatpack import _layout, _state
    calls = []

    def die():
        calls.append(1)
        raise CrashPoint("kill")

    mgr = CheckpointManager(str(tmp_path), _layout(),
                            async_latest=async_latest, io_fault=die)
    with pytest.raises(CrashPoint):
        mgr.save_latest(_state(1))
        mgr.wait()
    assert calls == [1] and mgr.escalator.total == 0
