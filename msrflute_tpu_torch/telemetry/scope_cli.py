"""Summarize, diff, watch and health-gate a run's telemetry — the port's
copy of ``msrflute_tpu/telemetry/scope_cli.py``, run as
``python -m msrflute_tpu_torch.telemetry.scope_cli``.

Four commands (the bare form is ``scope_cli <run_dir>``):

- ``scope_cli <run_dir>`` / ``scope_cli summarize <run_dir>`` —
  ONE JSON object summarizing a run's telemetry (below);
- ``scope_cli diff A B [--gate] [--pct N]`` — compare two runs'
  ``scorecard.json`` regression surfaces (A = baseline, B = candidate)
  with per-metric thresholds; ``--gate`` exits **3** when B regresses,
  naming the offending metric;
- ``scope_cli watch <run_dir> [--interval S] [--once]`` — live tail
  of the endurance rollup stream (``rollups.jsonl``), one compact line
  per flushed window: the babysitting view of a days-long run;
- ``scope_cli health <run_dir> [--gate]`` — the endurance health
  ORACLE: one verdict over the rollup stream, watchdog firings, the
  flight record and the scorecard.  ``--gate`` exits **3** when the
  run is unhealthy (naming every finding), **2** when the inputs are
  unreadable.

The JAX package's ``trend`` command reads its committed bench artifacts;
the port has no bench yet, so it has no ``trend``.

All readers walk size-capped rotation segments
(``metrics.jsonl.1``, ``events.jsonl.2``, ...) transparently, oldest
first, and tolerate a torn trailing line from a crash mid-write.

Summarize input: a model dir (or its ``telemetry/`` subdir) holding any
of ``telemetry/trace.json``, ``telemetry/events.jsonl``,
``metrics.jsonl``.  Output: ONE JSON object answering the questions a
round trace exists for —

- **phase-time breakdown**: total/count/p50 per span name (pack,
  dispatch, stats_fetch, host_tail, housekeeping, ckpt_submit,
  ckpt_async_write, eval, round_device, ...) — where the round time
  went;
- **overlap efficiency**: the fraction of host-tail time that ran while
  a device round was in flight (pipeline health: ~100% means the host
  tail is fully hidden; ~0% means the pipeline isn't pipelining), plus
  a per-depth breakdown (``by_depth``): how much of that overlapped
  tail ran while exactly 1, 2, ... N device rounds were in flight —
  the depth-N ring's (``server_config.pipeline_depth``) evidence that
  extra depth is (or is not) buying additional overlap;
- **fault/event table**: chaos faults, checkpoint recovery/IO faults,
  preemption, watchdog findings — counts per kind;
- **round span + counters/metrics inventory** so a reader knows what
  else the run recorded.

Pure stdlib; deterministic for a fixed input
(``tests/test_torch_scope_cli.py`` holds it to the JAX package's reader on
the same directory).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

#: span names that constitute the host tail for the overlap metric
_HOST_TAIL_SPANS = ("host_tail",)
#: span name of the device in-flight window
_DEVICE_SPAN = "round_device"


def _load_trace(path: str) -> List[Dict[str, Any]]:
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    try:
        parsed = json.loads(text)
    except json.JSONDecodeError:
        # a run killed mid-write can leave a truncated JSON array;
        # salvage the complete prefix rather than refusing the file
        cut = text.rfind("}")
        if cut < 0:
            return []
        salvage = text[: cut + 1] + "]}" if text.lstrip().startswith("{") \
            else text[: cut + 1] + "]"
        try:
            parsed = json.loads(salvage)
        except json.JSONDecodeError:
            return []
    if isinstance(parsed, dict):
        return list(parsed.get("traceEvents", []))
    return list(parsed) if isinstance(parsed, list) else []


def _segment_paths(path: str) -> List[str]:
    """Rotated segments of one jsonl stream, oldest first, primary
    last — the reader-side mirror of the writer's size-capped rotation
    (``telemetry.max_log_mb``; :func:`.metrics.rotate_jsonl`).  Kept as
    pure stdlib so the reader imports nothing of the package."""
    out = []
    seg = 1
    while os.path.exists(f"{path}.{seg}"):
        out.append(f"{path}.{seg}")
        seg += 1
    if os.path.exists(path):
        out.append(path)
    return out


def _jsonl(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for seg in _segment_paths(path) or ([path] if os.path.exists(path)
                                        else []):
        with open(seg, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn tail line of a killed run
    return out


def _p50(values: List[float]) -> float:
    return sorted(values)[len(values) // 2] if values else 0.0


def _interval_overlap(a: List[Tuple[float, float]],
                      b: List[Tuple[float, float]]) -> float:
    """Total length of ``a`` intervals covered by the union of ``b``."""
    events = sorted(b)
    merged: List[Tuple[float, float]] = []
    for lo, hi in events:
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    covered = 0.0
    for lo, hi in a:
        for mlo, mhi in merged:
            if mhi <= lo:
                continue
            if mlo >= hi:
                break
            covered += min(hi, mhi) - max(lo, mlo)
    return covered


def _depth_segments(ivs: List[Tuple[float, float]]
                    ) -> Dict[int, List[Tuple[float, float]]]:
    """Timeline regions keyed by how many ``ivs`` cover them (>= 1) —
    the rounds-in-flight depth profile of the device windows."""
    events: List[Tuple[float, int]] = []
    for lo, hi in ivs:
        events.append((lo, 1))
        events.append((hi, -1))
    events.sort()
    segs: Dict[int, List[Tuple[float, float]]] = {}
    depth = 0
    prev: Optional[float] = None
    for t, d in events:
        if prev is not None and depth > 0 and t > prev:
            segs.setdefault(depth, []).append((prev, t))
        depth += d
        prev = t
    return segs


def summarize(run_dir: str) -> Dict[str, Any]:
    """The scope summary for one run directory (see module docstring)."""
    tdir = run_dir
    if os.path.isdir(os.path.join(run_dir, "telemetry")):
        tdir = os.path.join(run_dir, "telemetry")
    trace_path = os.path.join(tdir, "trace.json")
    events_path = os.path.join(tdir, "events.jsonl")
    # metrics.jsonl lives at the run root (init_logging), but tolerate a
    # copy next to the trace (fixtures, relocated runs)
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.exists(metrics_path):
        metrics_path = os.path.join(tdir, "metrics.jsonl")

    out: Dict[str, Any] = {"run_dir": os.path.basename(
        os.path.abspath(run_dir))}

    # ---- spans + overlap from the trace --------------------------------
    spans: Dict[str, List[float]] = {}
    host_tail_iv: List[Tuple[float, float]] = []
    device_iv: List[Tuple[float, float]] = []
    rounds: List[int] = []
    counters: Dict[str, Dict[str, Any]] = {}
    trace_events: Dict[str, int] = {}
    if os.path.exists(trace_path):
        for ev in _load_trace(trace_path):
            ph = ev.get("ph")
            name = str(ev.get("name", ""))
            if ph == "X":
                dur_s = float(ev.get("dur", 0.0)) / 1e6
                spans.setdefault(name, []).append(dur_s)
                iv = (float(ev.get("ts", 0.0)),
                      float(ev.get("ts", 0.0)) + float(ev.get("dur", 0.0)))
                if name in _HOST_TAIL_SPANS:
                    host_tail_iv.append(iv)
                elif name == _DEVICE_SPAN:
                    device_iv.append(iv)
                    args = ev.get("args") or {}
                    if "round0" in args:
                        r0 = int(args["round0"])
                        rounds.extend(
                            range(r0, r0 + int(args.get("rounds", 1))))
            elif ph == "i":
                trace_events[name] = trace_events.get(name, 0) + 1
            elif ph == "C":
                args = ev.get("args") or {}
                c = counters.setdefault(name, {"samples": 0, "last": None})
                c["samples"] += 1
                c["last"] = args.get("value")
        out["phase_secs"] = {
            name: {"count": len(vals),
                   "total_s": round(sum(vals), 6),
                   "p50_s": round(_p50(vals), 6)}
            for name, vals in sorted(spans.items())}
        if rounds:
            out["rounds"] = {"count": len(set(rounds)),
                             "first": min(rounds), "last": max(rounds)}
        tail_total = sum(hi - lo for lo, hi in host_tail_iv) / 1e6
        overlapped = _interval_overlap(host_tail_iv, device_iv) / 1e6
        out["overlap"] = {
            "host_tail_s": round(tail_total, 6),
            "overlapped_s": round(overlapped, 6),
            "efficiency_pct": round(100.0 * overlapped / tail_total, 1)
            if tail_total > 0 else 0.0,
        }
        segs = _depth_segments(device_iv)
        if segs:
            # host-tail seconds that ran while exactly d device rounds
            # were in flight: the depth-N pipeline ring's per-depth
            # evidence (a depth-3 config whose by_depth has no "2"/"3"
            # mass is not actually going deeper than 1)
            out["overlap"]["by_depth"] = {
                str(d): round(_interval_overlap(host_tail_iv, iv) / 1e6, 6)
                for d, iv in sorted(segs.items())}
            out["overlap"]["max_rounds_in_flight"] = max(segs)
        if counters:
            out["counters"] = {k: dict(v) for k, v in sorted(
                counters.items())}
    else:
        out["trace"] = "absent"

    # ---- event table: one structured event is emitted to up to three
    # streams (trace instant, events.jsonl, metrics.jsonl record) — take
    # the per-name MAX across sources so nothing is double-counted and a
    # stream a killed run lost does not under-count ------------------
    sources: List[Dict[str, int]] = [trace_events]
    if os.path.exists(events_path):
        counts: Dict[str, int] = {}
        for rec in _jsonl(events_path):
            if rec.get("kind") == "event":
                name = str(rec.get("name", "?"))
                counts[name] = counts.get(name, 0) + 1
        sources.append(counts)
    if os.path.exists(metrics_path):
        counts = {}
        metric_names: Dict[str, int] = {}
        for rec in _jsonl(metrics_path):
            if "event" in rec:
                name = str(rec["event"])
                counts[name] = counts.get(name, 0) + 1
            elif "name" in rec:
                metric_names[str(rec["name"])] = \
                    metric_names.get(str(rec["name"]), 0) + 1
        sources.append(counts)
        if metric_names:
            out["metrics"] = {"lines": sum(metric_names.values()),
                              "names": sorted(metric_names)}
    events: Dict[str, int] = {}
    for counts in sources:
        for name, count in counts.items():
            events[name] = max(events.get(name, 0), count)
    if events:
        out["events"] = dict(sorted(events.items()))

    # ---- device-truth scorecard (telemetry/scorecard.json): surfaced
    # verbatim so one `scope_cli <dir>` answers the MFU/HBM/recompile
    # questions without a second command ------------------------------
    card_path = os.path.join(tdir, "scorecard.json")
    if os.path.exists(card_path):
        try:
            with open(card_path, "r", encoding="utf-8") as fh:
                out["scorecard"] = json.load(fh)
        except (OSError, json.JSONDecodeError):
            out["scorecard"] = "unreadable"
    return out


# ======================================================================
# scorecard diff — the cross-run regression gate
# ======================================================================
#: per-metric regression rules: (direction, default threshold).
#: ``higher_frac``: B worse when > A x (1 + frac); ``lower_frac``: B
#: worse when < A x (1 - frac); ``higher_abs`` / ``lower_abs``:
#: absolute-delta rules (counts, percentage points).  Thresholds scale
#: with ``--pct`` except the count rules (any increase in recompiles /
#: puts-per-dispatch is a real finding — those counters are flat in a
#: healthy steady state by construction).
DIFF_RULES: Dict[str, Tuple[str, float]] = {
    "round_secs_p50": ("higher_frac", 0.15),
    "host_tail_secs_p50": ("higher_frac", 0.30),
    "staged_bytes_per_round_p50": ("higher_frac", 0.10),
    "hbm_peak_bytes": ("higher_frac", 0.10),
    "mfu_p50": ("lower_frac", 0.15),
    # real samples / padded grid slots (cohort shape-bucketing's win):
    # a DROP means the grids grew back toward the monolithic worst case
    # — e.g. a bucket-boundary change silently re-padding small clients
    "padding_efficiency": ("lower_frac", 0.10),
    # tape-slot occupancy of the cross-client megabatch lanes: a DROP
    # means the lane planner stopped packing small clients densely
    # (lane geometry drift) or the dispatch gate fell back to the
    # per-client vmap arm on buckets it used to fuse
    "megabatch_utilization": ("lower_frac", 0.10),
    "overlap_efficiency_pct": ("lower_abs", 10.0),
    "recompiles": ("higher_abs", 0.0),
    "puts_per_dispatch": ("higher_abs", 0.0),
    # fleet transfer plane (mesh-sharded page pool): per-device paging
    # bytes are total/mesh_size by construction — a replicated pool
    # snaps them back to the total (xmesh_size), far past this margin
    "fleet_page_in_bytes_per_device": ("higher_frac", 0.5),
    "fleet_writeback_bytes_per_device": ("higher_frac", 0.5),
    # prefetch coverage collapsing means the page-in host IO moved back
    # onto the critical path
    "fleet_prefetch_hit_rate": ("lower_abs", 0.25),
}

#: metrics whose thresholds scale with --pct (the wall-clock-ish ones)
_PCT_SCALED = {"round_secs_p50", "host_tail_secs_p50",
               "staged_bytes_per_round_p50", "hbm_peak_bytes", "mfu_p50",
               "padding_efficiency", "megabatch_utilization"}


def load_scorecard(path: str) -> Dict[str, Any]:
    """A scorecard from a file path, a run dir, or its telemetry dir."""
    if os.path.isdir(path):
        for cand in (os.path.join(path, "telemetry", "scorecard.json"),
                     os.path.join(path, "scorecard.json")):
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"no scorecard.json under {path!r} — was the run's "
                "telemetry block enabled (server_config.telemetry)?")
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def diff_scorecards(a: Dict[str, Any], b: Dict[str, Any],
                    pct: Optional[float] = None) -> Dict[str, Any]:
    """Compare baseline ``a`` against candidate ``b``: per-metric deltas
    plus the thresholded ``regressions`` list (each naming the metric,
    both values and the limit it broke).  ``pct`` overrides the
    wall-clock-class thresholds (as a percentage, e.g. 15)."""
    metrics: Dict[str, Any] = {}
    regressions: List[Dict[str, Any]] = []
    for name, (direction, default_thresh) in DIFF_RULES.items():
        va, vb = a.get(name), b.get(name)
        row: Dict[str, Any] = {"a": va, "b": vb}
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            row["delta"] = round(float(vb) - float(va), 6)
            if va:
                row["delta_pct"] = round(100.0 * (vb - va) / abs(va), 2)
            thresh = default_thresh
            if pct is not None and name in _PCT_SCALED:
                thresh = float(pct) / 100.0
            regressed, limit = False, None
            if direction == "higher_frac" and va > 0:
                limit = va * (1.0 + thresh)
                regressed = vb > limit
            elif direction == "lower_frac" and va > 0:
                limit = va * (1.0 - thresh)
                regressed = vb < limit
            elif direction == "higher_abs":
                limit = va + thresh
                regressed = vb > limit
            elif direction == "lower_abs":
                limit = va - thresh
                regressed = vb < limit
            if regressed:
                regressions.append({
                    "metric": name, "a": va, "b": vb,
                    "limit": round(float(limit), 6),
                    "rule": direction, "threshold": thresh})
        metrics[name] = row
    return {"metrics": metrics, "regressions": regressions,
            "ok": not regressions}


def _diff_main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="scope diff",
        description="compare two runs' scorecard.json regression "
                    "surfaces (A = baseline, B = candidate)")
    ap.add_argument("a", help="baseline: scorecard.json or run dir")
    ap.add_argument("b", help="candidate: scorecard.json or run dir")
    ap.add_argument("--gate", action="store_true",
                    help="exit 3 when the candidate regresses")
    ap.add_argument("--pct", type=float, default=None,
                    help="override the wall-clock-class thresholds (%%)")
    ap.add_argument("--indent", type=int, default=None)
    args = ap.parse_args(argv)
    try:
        card_a, card_b = load_scorecard(args.a), load_scorecard(args.b)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"scope diff: {exc}", file=sys.stderr)
        return 2
    out = diff_scorecards(card_a, card_b, pct=args.pct)
    out["a"], out["b"] = args.a, args.b
    print(json.dumps(out, indent=args.indent, sort_keys=True))
    if out["regressions"]:
        names = ", ".join(r["metric"] for r in out["regressions"])
        print(f"scope diff: REGRESSION in {names}", file=sys.stderr)
        if args.gate:
            return 3
    return 0


# ======================================================================
# endurance: rollup watch + the health oracle
# ======================================================================
def _telemetry_dir(run_dir: str) -> str:
    if os.path.isdir(os.path.join(run_dir, "telemetry")):
        return os.path.join(run_dir, "telemetry")
    return run_dir


def _format_rollup(rec: Dict[str, Any]) -> str:
    """One compact human line per rollup window (the ``watch`` view)."""
    def num(key: str, fmt: str = "{:.3g}") -> str:
        value = rec.get(key)
        return fmt.format(value) if isinstance(value, (int, float)) \
            else "-"

    events = rec.get("events") or {}
    ev = " ".join(f"{k}:{v}" for k, v in sorted(events.items())) or "-"
    rss = rec.get("host_rss_bytes")
    rss_mb = f"{rss / 2**20:.0f}MB" if isinstance(rss, (int, float)) \
        else "-"
    return (f"w{rec.get('window', '?'):>3} "
            f"r[{rec.get('round_lo', '?')},{rec.get('round_hi', '?')}] "
            f"{num('secs_per_round_p50')}s/r "
            f"p95 {num('secs_per_round_p95')} "
            f"cl/s {num('clients_per_sec')} "
            f"mfu {num('mfu_p50', '{:.4f}')} "
            f"rss {rss_mb} "
            f"drop {rec.get('trace_events_dropped', 0)} "
            f"rc {rec.get('recompiles', 0)}"
            + (" PARTIAL" if rec.get("partial") else "")
            + f" | {ev}")


def _watch_main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="scope watch",
        description="live tail of a run's endurance rollup stream "
                    "(rollups.jsonl) — one line per flushed window")
    ap.add_argument("run_dir", help="model dir (or its telemetry/ subdir)")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="poll seconds between reads (default 5)")
    ap.add_argument("--once", action="store_true",
                    help="print what exists and exit (no follow)")
    args = ap.parse_args(argv)
    path = os.path.join(_telemetry_dir(args.run_dir), "rollups.jsonl")
    offset = 0
    printed_header = False
    import time as _time
    while True:
        if os.path.exists(path):
            size = os.path.getsize(path)
            if size < offset:
                offset = 0  # stream truncated/replaced: start over
            if size > offset:
                # binary read + byte offsets: text-mode seek is only
                # defined for cookies from tell(), and the tail we skip
                # may be a torn multi-byte write
                with open(path, "rb") as fh:
                    fh.seek(offset)
                    chunk = fh.read()
                # only consume complete lines; a torn tail stays
                # buffered for the next poll
                consumed = chunk.rfind(b"\n") + 1
                offset += consumed
                for raw in chunk[:consumed].splitlines():
                    line = raw.decode("utf-8", "replace").strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if not printed_header:
                        printed_header = True
                        print("# scope watch:", path, flush=True)
                    print(_format_rollup(rec), flush=True)
        if args.once:
            return 0
        try:
            _time.sleep(max(args.interval, 0.1))
        except KeyboardInterrupt:
            return 0


#: watchdog kinds whose firing makes a run UNHEALTHY for the gate.
#: round_time (a spiky chunk under chaos straggler inflation) and
#: quarantine_rate (the defense working) are informational; these six
#: mean the run is dying, leaking, drifting, or churning shapes.
CRITICAL_WATCHDOGS = ("stall", "nan_loss", "rss_leak",
                      "throughput_drift", "recompile_storm",
                      "ckpt_failure_streak")

#: last-vs-first rollup-window slowdown the static check tolerates
#: before calling the run unhealthy even without a watchdog firing
HEALTH_DRIFT_PCT = 75.0


def health(run_dir: str,
           pct: Optional[float] = None) -> Dict[str, Any]:
    """The endurance health verdict for one run directory.

    Sources (every one torn-line/rotation tolerant): the structured
    event streams (``metrics.jsonl`` + ``events.jsonl``), the rollup
    stream (``rollups.jsonl``), the flight record (``flight.json``) and
    the scorecard.  ``findings`` gate (exit 3); ``warnings`` inform.
    """
    tdir = _telemetry_dir(run_dir)
    findings: List[Dict[str, Any]] = []
    warnings: List[Dict[str, Any]] = []
    out: Dict[str, Any] = {"run_dir": os.path.basename(
        os.path.abspath(run_dir))}

    # ---- watchdog firings from the event streams + scorecard ---------
    fires: Dict[str, int] = {}
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    if not _segment_paths(metrics_path):
        metrics_path = os.path.join(tdir, "metrics.jsonl")
    # one firing reaches up to three streams; per-kind MAX across
    # sources (the summarize() convention) so nothing double-counts and
    # a stream a killed run lost does not under-count
    from_metrics: Dict[str, int] = {}
    for rec in _jsonl(metrics_path):
        if "event" in rec and str(rec["event"]).startswith("watchdog_"):
            kind = str(rec["event"])[len("watchdog_"):]
            from_metrics[kind] = from_metrics.get(kind, 0) + 1
    from_events: Dict[str, int] = {}
    for rec in _jsonl(os.path.join(tdir, "events.jsonl")):
        if rec.get("kind") == "event" and \
                str(rec.get("name", "")).startswith("watchdog_"):
            kind = str(rec["name"])[len("watchdog_"):]
            from_events[kind] = from_events.get(kind, 0) + 1
    for counts in (from_metrics, from_events):
        for kind, n in counts.items():
            fires[kind] = max(fires.get(kind, 0), n)
    card: Dict[str, Any] = {}
    card_path = os.path.join(tdir, "scorecard.json")
    if os.path.exists(card_path):
        try:
            with open(card_path, "r", encoding="utf-8") as fh:
                card = json.load(fh)
        except (OSError, json.JSONDecodeError):
            warnings.append({"check": "scorecard_unreadable"})
        for kind, n in (card.get("watchdog_fires") or {}).items():
            fires[kind] = max(fires.get(kind, 0), int(n))
    out["watchdog_fires"] = dict(sorted(fires.items()))
    for kind in CRITICAL_WATCHDOGS:
        if fires.get(kind):
            findings.append({"check": f"watchdog_{kind}",
                             "count": fires[kind]})

    # ---- flight record: a preemption flight is a drill/scheduler
    # artifact (the run resumed); any other reason means the run died
    # abnormally and the gate must say so --------------------------------
    flight_path = os.path.join(tdir, "flight.json")
    if os.path.exists(flight_path):
        try:
            with open(flight_path, "r", encoding="utf-8") as fh:
                flight = json.load(fh)
            reasons = [str(r.get("reason", "")) for r in
                       (flight.get("reasons") or [])]
            out["flight_reasons"] = reasons
            abnormal = [r for r in reasons
                        if not r.startswith("preemption")]
            if abnormal:
                findings.append({"check": "flight_abnormal",
                                 "reasons": abnormal})
            else:
                warnings.append({"check": "flight_preemption",
                                 "reasons": reasons})
        except (OSError, json.JSONDecodeError):
            warnings.append({"check": "flight_unreadable"})

    # ---- the rollup stream: presence + longitudinal statics ----------
    rollups = [r for r in _jsonl(os.path.join(tdir, "rollups.jsonl"))
               if r.get("kind") == "rollup" and r.get("rounds")]
    out["rollup_windows"] = len(rollups)
    if tdir != run_dir and not rollups:
        # a telemetry/ subdir exists, so telemetry RAN — a missing
        # rollup stream there means the endurance layer was disabled or
        # broken, which an endurance gate must refuse.  A run with no
        # telemetry dir at all simply has nothing to judge here
        # (telemetry-off runs are not unhealthy, just unobserved).
        findings.append({"check": "no_rollups",
                         "detail": "telemetry ran but no rollup window "
                                   "was ever flushed"})
    if len(rollups) >= 2:
        first, last = rollups[0], rollups[-1]
        a = first.get("secs_per_round_p50")
        b = last.get("secs_per_round_p50")
        thresh = (float(pct) if pct is not None else HEALTH_DRIFT_PCT) \
            / 100.0
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                and a > 0 and b > a * (1.0 + thresh):
            findings.append({
                "check": "rollup_throughput_drift",
                "first_p50": a, "last_p50": b,
                "limit": round(a * (1.0 + thresh), 6)})
        out["secs_per_round_p50"] = {"first": a, "last": b}
    if rollups:
        dropped = rollups[-1].get("trace_events_dropped")
        if dropped:
            warnings.append({"check": "trace_events_dropped",
                             "count": int(dropped)})
        out["last_window"] = {
            k: rollups[-1].get(k)
            for k in ("window", "round_hi", "secs_per_round_p50",
                      "clients_per_sec", "mfu_p50", "host_rss_bytes",
                      "recompiles")}

    if card:
        out["recompiles"] = card.get("recompiles")
        if card.get("trace_events_dropped"):
            warnings.append({"check": "scorecard_trace_events_dropped",
                             "count": card["trace_events_dropped"]})
    out["findings"] = findings
    out["warnings"] = warnings
    out["ok"] = not findings
    return out


def _health_main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="scope health",
        description="endurance health oracle over rollups + watchdog "
                    "firings + flight record + scorecard")
    ap.add_argument("run_dir", help="model dir (or its telemetry/ subdir)")
    ap.add_argument("--gate", action="store_true",
                    help="exit 3 when the run is unhealthy")
    ap.add_argument("--pct", type=float, default=None,
                    help="last-vs-first rollup slowdown tolerance "
                         "(%%, default 75)")
    ap.add_argument("--indent", type=int, default=None)
    args = ap.parse_args(argv)
    if not os.path.isdir(args.run_dir):
        print(f"scope health: {args.run_dir!r} is not a directory",
              file=sys.stderr)
        return 2
    try:
        out = health(args.run_dir, pct=args.pct)
    except OSError as exc:
        print(f"scope health: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(out, indent=args.indent, sort_keys=True))
    if out["findings"]:
        names = ", ".join(f["check"] for f in out["findings"])
        print(f"scope health: UNHEALTHY ({names})", file=sys.stderr)
        if args.gate:
            return 3
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "diff":
        return _diff_main(argv[1:])
    if argv and argv[0] == "watch":
        return _watch_main(argv[1:])
    if argv and argv[0] == "health":
        return _health_main(argv[1:])
    if argv and argv[0] == "summarize":
        argv = argv[1:]
    ap = argparse.ArgumentParser(
        description="summarize a run directory's telemetry")
    ap.add_argument("run_dir", help="model dir (or its telemetry/ subdir)")
    ap.add_argument("--indent", type=int, default=None,
                    help="pretty-print with this JSON indent")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.run_dir):
        print(f"scope: {args.run_dir!r} is not a directory",
              file=sys.stderr)
        return 2
    print(json.dumps(summarize(args.run_dir), indent=args.indent,
                     sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
