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

The fleet paged carry's slice (``tests/test_crashpoint.py:24-80`` on
``tools/crashpoint.py:119-130``'s config: SCAFFOLD with a 16-slot pool and
a 2-row host cache, synchronous saves): the census holds the row spills
and the round marker, and a kill at each named point (before the first
commit, inside a row spill, at the marker, inside the ``latest`` rotation,
and after the last commit) resumes to the uninterrupted run's params and
``c``, bitwise, at depth 0 and 3.
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

    def arm(self, scope, kill_at=None, phase="pre"):
        """Count (and with ``kill_at`` kill, before the commit or with
        ``phase`` "post" after it) under ``scope``; None disarms."""
        self.scope = None if scope is None else os.path.abspath(scope)
        self.kill_at, self.log, self.phase = kill_at, [], phase

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
            if self.kill_at == k and self.phase == "pre":
                raise CrashPoint(f"killed before durable op #{k}: "
                                 f"{name} -> {dst}")
            out = orig(src, dst, *args, **kwargs)
            if self.kill_at == k and self.phase == "post":
                raise CrashPoint(f"killed after durable op #{k}: "
                                 f"{name} -> {dst}")
            return out
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


# ------------------------------------------------- the fleet paged carry
def _fleet_raw(depth, resume=False):
    raw = raw_config("scaffold", depth=depth, rounds=ROUNDS, val_freq=10_000,
                     checkpoint_async=False,
                     checkpoint_retry={"retries": 2, "backoff_base_s": 0.0,
                                       "jitter": 0.0},
                     fleet={"page_pool_slots": 16, "host_cache_rows": 2,
                            "spill_freq": 1},
                     resume_from_checkpoint=resume)
    raw["server_config"]["data_config"] = {}
    return raw


def _fleet_run(depth, model_dir, resume=False):
    server = port_server(_fleet_raw(depth, resume), model_dir)
    server.train()
    return server


def _named_points(census):
    """The kill points of the slice: (index, phase) by name."""
    last = len(census) - 1

    def first(pred):
        return next(i for i, (op, rel) in enumerate(census) if pred(op, rel))

    return {"first_commit": (0, "pre"),
            "row_spill": (first(lambda op, rel: "fleet_carry/row_" in rel),
                          "pre"),
            "marker": (first(lambda op, rel: rel.endswith("fleet_round.npy")),
                       "pre"),
            "latest_rotation": (first(lambda op, rel: rel.endswith(
                "latest_model.pt.prev.lnk")), "pre"),
            "last_commit_post": (last, "post")}


@pytest.mark.parametrize("depth", [0, 3])
def test_paged_carry_kill_points_resume_bitwise(depth, tmp_path):
    base = _fleet_run(depth, str(tmp_path / "base"))
    assert base.fleet_pager.describe()["spilled_rows"] > 0
    switch = KillSwitch()
    switch.install()
    try:
        switch.arm(str(tmp_path / "census"))
        _fleet_run(depth, str(tmp_path / "census"))
        census = list(switch.log)
        switch.arm(None)
        joined = "\n".join(f"{op}:{rel}" for op, rel in census)
        for needle in ("fleet_carry/row_", "fleet_carry/fleet_round.npy",
                       "latest_model.pt", "latest_model.pt.sum",
                       "link:latest_model.pt.prev.lnk", "status_log.json"):
            assert needle in joined, (needle, joined)
        for name, (k, phase) in _named_points(census).items():
            run_dir = str(tmp_path / name)
            switch.arm(run_dir, kill_at=k, phase=phase)
            with pytest.raises(CrashPoint):
                _fleet_run(depth, run_dir)
            switch.arm(None)
            resumed = _fleet_run(depth, run_dir, resume=True)
            what = f"depth {depth}, {name}: op {k} {census[k]} ({phase})"
            assert resumed.state.round == ROUNDS, what
            assert torch.equal(resumed.state.params, base.state.params), \
                what
            assert torch.equal(resumed.state.strategy_state["c"],
                               base.state.strategy_state["c"]), what
    finally:
        switch.uninstall()
