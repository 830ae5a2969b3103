"""Host-side watchdogs over the per-round telemetry stream — the port's
copy of ``msrflute_tpu/telemetry/watchdog.py``, pure host code.

Detectors (all pure host math over values the round loop ALREADY holds —
fetched train losses, wall-clock round times, the checkpoint
escalator's consecutive-failure count; never a device read):

- **nan_loss** — NaN/inf per-round training loss;
- **round_time** — a round slower than ``round_time_factor`` x the
  trailing-window median (the "where did my throughput go" tripwire);
- **ckpt_failures** — a consecutive checkpoint-save failure streak
  reaching ``ckpt_failure_streak`` (reads the
  :class:`~msrflute_tpu_torch.resilience.integrity.FailureEscalator` counter —
  this fires WARNINGS well before the escalator's own abort threshold
  would kill the run);
- **quarantine_rate** — the fluteshield-quarantined fraction of a
  round's live cohort exceeds ``quarantine_rate_threshold``.  A few
  quarantined clients is the defense working; most of the cohort
  quarantined means the GLOBAL model is what's diverging (every honest
  client returns garbage) — the distinction between "screen and carry
  on" and "stop the run".  Fed only when ``server_config.robust``
  screening is on (the fraction rides the packed round stats);
- **recompile_storm** — the device-truth layer's sentinel counter
  (:mod:`.xla` ``recompile`` events: a SECOND operand signature at an
  entry point that was already warm) reaches
  ``recompile_storm_threshold`` after
  ``recompile_storm_warmup_rounds``.  A steady-state round loop
  sees each entry point's signature once; every new one is shape churn
  (a new grid, a new bucket) that costs the caching allocator and
  cuDNN's algorithm search, so a storm of them is a "your shapes are churning" finding, not
  noise.  Recompiles that land during the warmup rounds (legitimate
  geometry discovery: step/length buckets, eval-boundary chunk sizes)
  set the baseline and never count toward the storm.

Longitudinal detectors (the days-long-run tier; the three
above see one round at a time, these see the TREND):

- **stall** — no round-completion heartbeat within
  ``max(stall_factor x trailing-median round time, stall_grace_secs)``.
  The round_time detector structurally cannot see this: it only runs
  when a round COMPLETES, and a hung device dispatch never completes.
  Detection therefore lives on a named monitor thread
  (``flutescope-stall-monitor``, spawned only when the action is not
  ``off``) polling a heartbeat the drain path updates.  ``abort`` from
  the monitor persists the flight record FIRST (the forensics must be
  durable before any unwind), then interrupts the main thread —
  best-effort by construction: a hang inside a C extension call only
  observes the interrupt when Python bytecode resumes, which is exactly
  why the flight record is written before it;
- **rss_leak** — the least-squares slope of host RSS over a trailing
  ``rss_leak_window``-round window exceeds ``rss_leak_mb_per_round``.
  A slow host-memory leak (an unbounded cache, a list that should have
  been a ring) is invisible per-round and fatal at day two; the window
  re-anchors after each firing so a sustained leak fires once per
  window, not once per round;
- **throughput_drift** — the trailing-window median secs-per-round
  exceeds ``throughput_drift_factor`` x the ANCHOR window's median (the
  first full window observed — compile warmup inflates the anchor, so
  the detector is conservative by construction).  Catches the slow
  degradations round_time's 3x-median spike rule never trips on:
  fragmentation, straggler accumulation, a datacenter neighbor.

Each detector has a configurable action (``server_config.telemetry.
watchdog``): ``off`` | ``log`` (event only) | ``mark`` (event + durable
``status_log.json`` marker via the server's mark callback) | ``abort``
(raise :class:`WatchdogAbort` out of the round loop).  Every firing is
emitted as a structured event whatever the action.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

ACTIONS = ("off", "log", "mark", "abort")

_DEFAULTS = {
    "nan_loss": "abort",
    "round_time_action": "log",
    "round_time_factor": 3.0,
    "round_time_window": 16,
    "ckpt_failure_action": "mark",
    "ckpt_failure_streak": 3,
    "quarantine_rate_action": "mark",
    "quarantine_rate_threshold": 0.5,
    "recompile_storm_action": "log",
    "recompile_storm_threshold": 3,
    "recompile_storm_warmup_rounds": 2,
    # longitudinal detectors.  stall defaults OFF because it
    # is the one detector that spawns a monitor thread — endurance
    # configs opt in; the trend detectors are pure observe_round math
    # and default to log like round_time.
    "stall_action": "off",
    "stall_factor": 10.0,
    "stall_poll_secs": 5.0,
    "stall_grace_secs": 30.0,
    "rss_leak_action": "log",
    "rss_leak_window": 32,
    "rss_leak_mb_per_round": 1.0,
    "throughput_drift_action": "log",
    "throughput_drift_window": 16,
    "throughput_drift_factor": 1.5,
}

#: detector keys holding an action value (shared with schema.py's
#: enum validation, ``config.py::ALLOWED_WATCHDOG_ACTIONS``)
ACTION_KEYS = (
    "nan_loss", "round_time_action", "ckpt_failure_action",
    "quarantine_rate_action", "recompile_storm_action", "stall_action",
    "rss_leak_action", "throughput_drift_action",
)


class WatchdogAbort(RuntimeError):
    """A watchdog with action ``abort`` fired — the run stops with the
    finding in the message instead of training on garbage."""


class Watchdog:
    """Per-run detector state.  ``on_event(kind, **fields)`` receives
    every finding (trace instant + metrics-stream event); ``on_mark``
    persists a finding to the status log for ``mark``/``abort``."""

    def __init__(self, raw: Optional[Dict[str, Any]] = None,
                 on_event: Optional[Callable[..., None]] = None,
                 on_mark: Optional[Callable[[str, Dict[str, Any]], None]]
                 = None):
        raw = dict(raw or {})
        cfg = dict(_DEFAULTS)
        cfg.update({k: raw[k] for k in _DEFAULTS if k in raw})
        for key in ACTION_KEYS:
            if cfg[key] not in ACTIONS:
                raise ValueError(
                    f"telemetry.watchdog.{key}: {cfg[key]!r} not in "
                    f"{ACTIONS}")
        self.cfg = cfg
        self.on_event = on_event or (lambda kind, **f: None)
        self.on_mark = on_mark or (lambda kind, fields: None)
        #: flight-record persist callback (the server wires the
        #: telemetry scope's recorder): the stall monitor calls it
        #: BEFORE interrupting the main thread on abort, so the
        #: forensic record is durable whatever happens to the unwind
        self.on_flight: Optional[Callable[[str], None]] = None
        window = max(int(cfg["round_time_window"]), 4)
        self._times: deque = deque(maxlen=window)
        self._last_ckpt_streak = 0
        # recompile sentinel state: recompiles observed during the
        # warmup rounds set the baseline; only growth past it counts
        self._recompile_baseline: Optional[int] = None
        self._last_storm_count = 0
        # rss_leak trailing window of (round_no, rss_bytes) samples
        self._rss: deque = deque(
            maxlen=max(int(cfg["rss_leak_window"]), 4))
        # throughput_drift: anchor window (the first full window) +
        # trailing window + a fired latch so a sustained drift is one
        # finding per excursion, not one per round
        drift_w = max(int(cfg["throughput_drift_window"]), 4)
        self._drift_anchor: list = []
        self._drift_trail: deque = deque(maxlen=drift_w)
        self._drift_active = False
        # stall heartbeat: a 3-slot list holder mutated by SLICE
        # assignment (atomic under the GIL; a fresh-list rebind would be
        # a cross-thread handoff of live state — the thread-escape
        # class).  [beat_monotonic, trailing_median_secs, round_no]
        self._beat: list = [None, 0.0, -1]
        self._stall_stop = threading.Event()
        self._stall_thread: Optional[threading.Thread] = None
        #: findings fired this run (observability + tests)
        self.findings: list = []

    # ------------------------------------------------------------------
    def observe_round(self, round_no: int,
                      train_loss: Optional[float] = None,
                      round_secs: Optional[float] = None,
                      ckpt_failures: int = 0,
                      quarantine_frac: Optional[float] = None,
                      recompiles: Optional[int] = None,
                      host_rss_bytes: Optional[int] = None) -> None:
        """Feed one completed round's host-side observations; applies
        every enabled detector and its configured action.

        ``recompiles`` is the CUMULATIVE recompile-event count from the
        device-truth layer (``RoundEngine.recompile_count`` /
        ``XlaIntrospector.recompiles``) — already "compiles beyond the
        first per entry point", so warm-up first compiles never feed the
        storm detector."""
        if train_loss is not None and self.cfg["nan_loss"] != "off" and \
                not math.isfinite(float(train_loss)):
            self._fire("nan_loss", self.cfg["nan_loss"],
                       round=round_no, train_loss=float(train_loss))
        if quarantine_frac is not None and \
                self.cfg["quarantine_rate_action"] != "off":
            thresh = float(self.cfg["quarantine_rate_threshold"])
            if float(quarantine_frac) > thresh:
                self._fire("quarantine_rate",
                           self.cfg["quarantine_rate_action"],
                           round=round_no,
                           quarantined_frac=round(float(quarantine_frac),
                                                  4),
                           threshold=thresh)
        if round_secs is not None and \
                self.cfg["round_time_action"] != "off":
            factor = float(self.cfg["round_time_factor"])
            if len(self._times) >= self._times.maxlen // 2:
                med = sorted(self._times)[len(self._times) // 2]
                if med > 0 and round_secs > factor * med:
                    self._fire("round_time_regression",
                               self.cfg["round_time_action"],
                               round=round_no,
                               round_secs=round(float(round_secs), 4),
                               trailing_median_secs=round(float(med), 4),
                               factor=factor)
            self._times.append(float(round_secs))
        if recompiles is not None and \
                self.cfg["recompile_storm_action"] != "off":
            warmup = int(self.cfg["recompile_storm_warmup_rounds"])
            if round_no < warmup or self._recompile_baseline is None:
                # warmup rounds (and the first post-warmup observation)
                # anchor the baseline: geometry discovery retraces are
                # expected and must not arm the storm
                self._recompile_baseline = int(recompiles)
            storm = int(recompiles) - self._recompile_baseline
            threshold = int(self.cfg["recompile_storm_threshold"])
            if round_no >= warmup and storm >= threshold and \
                    storm > self._last_storm_count:
                # fire on each NEW recompile past the threshold (the
                # ckpt-streak pattern), not once per round forever
                self._fire("recompile_storm",
                           self.cfg["recompile_storm_action"],
                           round=round_no, recompiles_after_warmup=storm,
                           threshold=threshold)
            self._last_storm_count = storm
        streak = int(self.cfg["ckpt_failure_streak"])
        if self.cfg["ckpt_failure_action"] != "off" and streak > 0 and \
                ckpt_failures >= streak and \
                ckpt_failures > self._last_ckpt_streak:
            # fire once per new failure in the streak, not once per round
            # forever after; a success resets the escalator counter and
            # therefore re-arms this detector
            self._fire("ckpt_failure_streak",
                       self.cfg["ckpt_failure_action"],
                       round=round_no, consecutive_failures=ckpt_failures)
        self._last_ckpt_streak = int(ckpt_failures)
        if host_rss_bytes is not None and \
                self.cfg["rss_leak_action"] != "off":
            self._observe_rss(round_no, int(host_rss_bytes))
        if round_secs is not None and \
                self.cfg["throughput_drift_action"] != "off":
            self._observe_drift(round_no, float(round_secs))
        # heartbeat for the stall monitor: one slice assignment of
        # (monotonic now, trailing median, round) — the monitor thread
        # only ever READS the holder, so there is no lock to contend on
        # and no live object handed across the thread boundary
        med = 0.0
        if self._times:
            med = sorted(self._times)[len(self._times) // 2]
        self._beat[0:3] = [time.monotonic(), float(med), int(round_no)]

    # ------------------------------------------------------------------
    # longitudinal detectors
    # ------------------------------------------------------------------
    def _observe_rss(self, round_no: int, rss: int) -> None:
        """Trailing-window least-squares slope of host RSS vs round.
        Pure python (n = rss_leak_window, tiny); fires when the slope
        exceeds ``rss_leak_mb_per_round`` over a FULL window, then
        re-anchors (clears the window) so a sustained leak is one
        finding per window."""
        self._rss.append((int(round_no), float(rss)))
        if len(self._rss) < self._rss.maxlen:
            return
        xs = [float(r) for r, _ in self._rss]
        ys = [v for _, v in self._rss]
        n = len(xs)
        mx = sum(xs) / n
        my = sum(ys) / n
        var = sum((x - mx) ** 2 for x in xs)
        if var <= 0:
            return
        slope = sum((x - mx) * (y - my)
                    for x, y in zip(xs, ys)) / var  # bytes per round
        thresh = float(self.cfg["rss_leak_mb_per_round"]) * 2 ** 20
        if thresh > 0 and slope > thresh:
            self._rss.clear()
            self._fire("rss_leak", self.cfg["rss_leak_action"],
                       round=round_no,
                       slope_mb_per_round=round(slope / 2 ** 20, 3),
                       threshold_mb_per_round=round(thresh / 2 ** 20, 3),
                       window_rounds=n,
                       rss_mb=round(ys[-1] / 2 ** 20, 1))

    def _observe_drift(self, round_no: int, secs: float) -> None:
        """Trailing-median secs-per-round vs the anchor window (the
        first full window observed).  A latch keeps a sustained drift
        to one finding per excursion; recovery below the factor
        re-arms."""
        if len(self._drift_anchor) < self._drift_trail.maxlen:
            self._drift_anchor.append(float(secs))
            return
        self._drift_trail.append(float(secs))
        if len(self._drift_trail) < self._drift_trail.maxlen:
            return
        anchor = sorted(self._drift_anchor)[len(self._drift_anchor) // 2]
        trail = sorted(self._drift_trail)[len(self._drift_trail) // 2]
        factor = float(self.cfg["throughput_drift_factor"])
        if anchor > 0 and trail > factor * anchor:
            if not self._drift_active:
                self._drift_active = True
                self._fire("throughput_drift",
                           self.cfg["throughput_drift_action"],
                           round=round_no,
                           trailing_median_secs=round(trail, 4),
                           anchor_median_secs=round(anchor, 4),
                           factor=factor)
        else:
            self._drift_active = False

    # ------------------------------------------------------------------
    # the stall monitor (named thread; spawned only when configured)
    # ------------------------------------------------------------------
    def start_stall_monitor(self) -> bool:
        """Spawn the monitor thread iff ``stall_action`` is not ``off``
        and none is running; returns whether a monitor is active.  The
        server calls this at train() entry and :meth:`stop_stall_monitor`
        on every exit path."""
        if self.cfg["stall_action"] == "off":
            return False
        if self._stall_thread is not None and \
                self._stall_thread.is_alive():
            return True
        self._stall_stop.clear()
        # the monitor ARMS at the first round-completion heartbeat: the
        # window between train() entry and round 0's drain is compile
        # warmup (tens of seconds on a cold cache — longer than any
        # sane grace), not a stall.  A hang BEFORE the first completed
        # round is therefore invisible to this detector by design;
        # the flight recorder + external job timeout own that window.
        self._beat[0:3] = [None, 0.0, -1]
        self._stall_thread = threading.Thread(
            target=self._stall_loop, name="flutescope-stall-monitor",
            daemon=True)
        self._stall_thread.start()
        return True

    def stop_stall_monitor(self) -> None:
        self._stall_stop.set()
        thread = self._stall_thread
        if thread is not None and thread.is_alive() and \
                thread is not threading.current_thread():
            thread.join(timeout=2.0)
        self._stall_thread = None

    def _stall_loop(self) -> None:
        poll = max(float(self.cfg["stall_poll_secs"]), 0.01)
        factor = float(self.cfg["stall_factor"])
        grace = float(self.cfg["stall_grace_secs"])
        action = self.cfg["stall_action"]
        fired_for: Optional[float] = None  # beat we already fired on
        while not self._stall_stop.wait(poll):
            beat, med, rnd = self._beat[0], self._beat[1], self._beat[2]
            if beat is None or beat == fired_for:
                continue
            limit = max(factor * float(med), grace)
            if limit <= 0:
                continue
            since = time.monotonic() - beat
            if since <= limit:
                continue
            fired_for = beat
            try:
                self._fire("stall", action, round=int(rnd) + 1,
                           secs_since_heartbeat=round(since, 3),
                           limit_secs=round(limit, 3),
                           trailing_median_secs=round(float(med), 4))
            except WatchdogAbort as exc:
                # the abort cannot unwind the MAIN thread from here.
                # Persist the flight record first (the durable forensic
                # copy is the whole point), then interrupt the main
                # thread.  With the server's graceful-preemption handler
                # installed (the normal train window) the interrupt
                # lands as a SIGINT preemption request — drain, durable
                # checkpoint, resumable exit, flight carrying the stall;
                # without it, KeyboardInterrupt unwinds through the
                # server's BaseException net.  A hang inside a C
                # extension call defers the interrupt until Python
                # resumes; the flight record is on disk regardless.
                if self.on_flight is not None:
                    try:
                        self.on_flight(f"watchdog_stall: {exc}")
                    except Exception:
                        pass
                import _thread
                _thread.interrupt_main()
                return

    # ------------------------------------------------------------------
    def _fire(self, kind: str, action: str, **fields: Any) -> None:
        self.findings.append({"kind": kind, "action": action, **fields})
        # name the observing thread in the event and the abort message:
        # a ckpt_failure_streak seen from the named writer thread and
        # one seen from the round loop are different debugging stories
        thread = threading.current_thread().name
        self.on_event(f"watchdog_{kind}", action=action, thread=thread,
                      **fields)
        if action in ("mark", "abort"):
            self.on_mark(kind, fields)
        if action == "abort":
            raise WatchdogAbort(
                f"watchdog {kind} fired on thread {thread} ({fields}); "
                "configured action is abort — set server_config."
                "telemetry.watchdog to 'mark' or 'log' to continue "
                "through this condition")
