"""The device-truth layer — the CUDA twin of
``msrflute_tpu/telemetry/xla.py`` (the name is kept so that a reader finds
the counterpart; the config key stays ``telemetry.xla``).

The port has no compiled programs.  Its "compile" is the first dispatch
of a new operand signature at a named entry point of the round engine
(``round_step``, ``multi_round_r{R}``, ``staged_r{R}``,
``bucket_collect_s{S}``, ``megabatch_collect_s{S}``, ``bucket_finalize``,
``eval_step``, ``payload_step``, ``custom_agg``):

- **the signature sentinel** — :func:`structural_key` and
  :func:`operand_signature` read the shapes and dtypes of an operand
  tree's tensor leaves (and the types of its other leaves); a second
  signature at an entry point is a ``recompile`` event carrying the
  :func:`signature_diff`, the first an ``xla_compile`` event;
- **cost capture** — a new signature's first dispatch runs under one
  :class:`CostMode` (a ``TorchDispatchMode``) that counts FLOPs by
  ``torch.utils.flop_counter``'s formulas and bytes accessed as the
  operand and result bytes of each aten op that moves data (views move
  none).  The hand-written kernels are ``ctypes`` launches that no
  dispatch mode sees, so their wrappers report their own analytic counts
  (:func:`hand_kernel`, the formulas of ``PERF.md`` §6's bounds: B1 5
  values a parameter, B2 and B3 2 values an element, B4–B6 2 flops a
  multiply-add over the causal pairs), and run their plain version
  uncounted on the CPU, so a count is the same on either device.  The
  mode calls every op as it is: the dispatch computes the same bits and
  adds no sync.  ``hbm_bytes`` is the peak allocated over that dispatch
  (``torch.cuda.reset_peak_memory_stats`` and ``max_memory_allocated``,
  both host-side; the allocator's peak is process-wide, so another
  thread's allocations in the window count too); None on the CPU;
- :func:`mfu` — the JAX package's ``flops / (secs x peak)``; the peak
  comes from :func:`~..device.chip_peak_flops`, which knows no peak of an
  unknown card, and then MFU is None.

No device value is read here: signatures and counts are tensor metadata
and host arithmetic.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

__all__ = [
    "CostMode", "XlaIntrospector", "flash_work", "hand_kernel", "mfu",
    "operand_signature", "roofline_secs", "signature_diff",
    "structural_key",
]


# ----------------------------------------------------------------------
# operand signatures (the sentinel's identity)
# ----------------------------------------------------------------------
def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` of a tree of dicts (keys sorted, as
    ``jax.tree_util`` orders them), lists and tuples."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree, key=str):
            out += _flatten(tree[key], f"{path}[{key!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, leaf in enumerate(tree):
            out += _flatten(leaf, f"{path}[{i}]")
        return out
    return [(path, tree)]


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


def _leaf_desc(leaf: Any) -> List[Any]:
    """``[shape, dtype, weak_type]`` of one leaf (the JAX triple; the port
    has no weak types): a non-array leaf's type is its signature."""
    if isinstance(leaf, (torch.Tensor, np.ndarray)):
        return [list(leaf.shape), _dtype_name(leaf.dtype), False]
    return [[], type(leaf).__name__, False]


def structural_key(args: Any) -> Tuple[Any, ...]:
    """Hashable structure and per-leaf shape and dtype of an operand tree
    — the per-dispatch key; :func:`operand_signature` spells it out only
    when it is new."""
    return tuple((path, tuple(d[0]), d[1])
                 for path, d in ((p, _leaf_desc(leaf))
                                 for p, leaf in _flatten(args)))


def operand_signature(args: Any) -> Tuple[str, Dict[str, List[Any]]]:
    """``(hash, desc)``: ``desc`` maps each leaf's path to ``[shape,
    dtype, weak_type]``; the hash covers the paths, so a changed
    structure is a new signature even when the surviving leaves match."""
    desc = {path: _leaf_desc(leaf) for path, leaf in _flatten(args)}
    blob = json.dumps(desc, sort_keys=True)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16], desc


def signature_diff(old: Dict[str, List[Any]],
                   new: Dict[str, List[Any]]) -> Dict[str, Any]:
    """Leaf-level difference between two operand signatures — the
    payload of a ``recompile`` event: WHICH operand changed shape/dtype,
    from what, to what."""
    changed = {path: {"was": old[path], "now": new[path]}
               for path in sorted(set(old) & set(new))
               if old[path] != new[path]}
    added = {path: new[path] for path in sorted(set(new) - set(old))}
    removed = {path: old[path] for path in sorted(set(old) - set(new))}
    out: Dict[str, Any] = {}
    if changed:
        out["changed"] = changed
    if added:
        out["added"] = added
    if removed:
        out["removed"] = removed
    return out


# ----------------------------------------------------------------------
# cost capture
# ----------------------------------------------------------------------
def _tensor_bytes(tree: Any) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(t) for t in tree.values())
    return 0


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        groups, output_mask, out_shape, **kwargs) -> int:
    """``torch.utils.flop_counter``'s ``convolution_backward`` formula with
    the weight gradient divided by ``groups``: torch's counts every group's
    input against every group's output channels.  ``vmap`` over K clients
    turns each convolution into one of K groups, so the uncorrected
    formula counts K times each weight gradient."""
    from torch.utils.flop_counter import conv_flop_count, get_shape

    def t(shape):
        return [shape[1], shape[0]] + list(shape[2:])
    flops = 0
    if output_mask[0]:
        flops += conv_flop_count(grad_out_shape, w_shape,
                                 get_shape(out_shape[0]), not transposed)
    if output_mask[1]:
        gw = get_shape(out_shape[1])
        weight = (conv_flop_count(t(grad_out_shape), t(x_shape), t(gw))
                  if transposed else
                  conv_flop_count(t(x_shape), t(grad_out_shape), t(gw)))
        flops += weight // groups
    return flops


class CostMode(TorchDispatchMode):
    """Counts the FLOPs (``torch.utils.flop_counter``'s formulas, the
    grouped convolution's weight gradient corrected) and the bytes (each
    data-moving aten op's operands and results) of what runs under it, and
    calls every op unchanged.  :func:`hand_kernel` adds a hand-written
    kernel's own counts."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry, shape_wrapper
        self.registry = dict(flop_registry)
        self.registry[torch.ops.aten.convolution_backward] = \
            shape_wrapper(_conv_backward_flop)
        self.flops = 0.0
        self.bytes_accessed = 0.0
        #: hand-written kernel launches counted, by wrapper name
        self.kernels: Dict[str, int] = {}
        #: > 0 while a hand kernel's plain version runs uncounted
        self.muted = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.muted or getattr(func, "is_view", False):
            return out
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        self.bytes_accessed += float(_tensor_bytes(args) +
                                     _tensor_bytes(kwargs) +
                                     _tensor_bytes(out))
        return out


def _active_mode() -> Optional[CostMode]:
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, CostMode):
            return mode
    return None


@contextlib.contextmanager
def hand_kernel(name: str, work: Callable[[], Tuple[float, float]]):
    """One hand-written kernel's launch (or, on the CPU, its plain
    version) inside a counted dispatch: ``work()`` gives its analytic
    ``(flops, bytes)``, added once, and the ops inside the block are not
    counted.  Outside a counted dispatch it costs one look at the mode
    stack."""
    mode = _active_mode()
    if mode is None:
        yield
        return
    flops, nbytes = work()
    mode.flops += float(flops)
    mode.bytes_accessed += float(nbytes)
    mode.kernels[name] = mode.kernels.get(name, 0) + 1
    mode.muted += 1
    try:
        yield
    finally:
        mode.muted -= 1


def visible_pairs(B: int, Lq: int, Lk: int, H: int, causal: bool,
                  q_offset: int, k_offset: int) -> int:
    """Query-key pairs the mask lets through (``chip_smoke.py``'s
    ``_visible_pairs`` in closed form): row i sees
    ``clamp(q_offset + i - k_offset + 1, 0, Lk)`` keys."""
    if not causal:
        return B * H * Lq * Lk
    lo = q_offset - k_offset + 1          # keys of row 0, unclamped
    hi = lo + Lq - 1                      # keys of the last row
    total = 0
    # rows below 0 keys add nothing, rows past Lk add Lk each
    a, b = max(lo, 1), min(hi, Lk)
    if a <= b:
        total += (a + b) * (b - a + 1) // 2
    full_from = max(lo, Lk + 1)
    if full_from <= hi:
        total += Lk * (hi - full_from + 1)
    return B * H * total


def flash_work(which: str, B: int, Lq: int, Lk: int, H: int, D: int,
               causal: bool, q_offset: int, k_offset: int,
               elem: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of one B4 (``"fwd"``), B5 (``"dq"``) or B6
    (``"dkv"``) launch, ``PERF.md`` §6's bound: 2 flops a multiply-add of
    each product over the visible pairs (2, 3 and 4 products of width D a
    pair), each input read once and each output written once (``lse``,
    ``delta`` and the lse cotangent in float32)."""
    pairs = visible_pairs(B, Lq, Lk, H, causal, q_offset, k_offset)
    qb, kb, sb = elem * B * Lq * H * D, elem * B * Lk * H * D, 4 * B * H * Lq
    if which == "fwd":
        return 2 * 2 * D * pairs, qb + 2 * kb + qb + sb
    if which == "dq":
        return 3 * 2 * D * pairs, 2 * qb + 2 * kb + 3 * sb + qb
    return 4 * 2 * D * pairs, 2 * qb + 2 * kb + 3 * sb + 2 * kb


def mfu(flops: float, secs: float,
        peak_flops: Optional[float] = None) -> Optional[float]:
    """Model FLOPs utilization: ``flops / (secs x peak)`` (the JAX
    package's formula); None when any input is missing or not positive —
    an unknown card's peak among them."""
    if not flops or not secs or secs <= 0:
        return None
    if not peak_flops or peak_flops <= 0:
        return None
    return float(flops) / float(secs) / float(peak_flops)


def roofline_secs(cost: Optional[dict], peak_flops: Optional[float],
                  bytes_per_sec: Optional[float]) -> float:
    """``max(flops / peak, bytes / bandwidth)`` of one counted dispatch
    (``msrflute_tpu/ops/pallas_attention.py::_roofline_secs``); infinite
    when nothing was counted or the card's rates are unknown."""
    if not cost or not peak_flops or not bytes_per_sec:
        return float("inf")
    flops = float(cost.get("flops") or 0.0)
    nbytes = float(cost.get("bytes_accessed") or 0.0)
    if flops <= 0.0 and nbytes <= 0.0:
        return float("inf")
    return max(flops / peak_flops, nbytes / bytes_per_sec)


# ----------------------------------------------------------------------
# the per-run registry
# ----------------------------------------------------------------------
class XlaIntrospector:
    """One run's entry-point registry (constructed only when
    ``server_config.telemetry.xla`` is on; a run with telemetry off has
    none).  Events wait in :attr:`pending_events` for the server's host
    tail, which emits them: observing a dispatch writes no file."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        #: entry name -> record (signature, counts, compile count)
        self.entries: Dict[str, Dict[str, Any]] = {}
        self.pending_events: List[Dict[str, Any]] = []
        #: new signatures / new signatures beyond the first an entry
        self.compiles = 0
        self.recompiles = 0
        #: ``{"entry", "rounds", "flops", "bytes_accessed", "hbm_bytes"}``
        #: of the most recent dispatch (the server snapshots it a chunk)
        self.last_dispatch: Optional[Dict[str, Any]] = None
        self._sig_by_key: Dict[Tuple[str, Any], str] = {}

    def dispatch(self, name: str, key: Any, operands: Any,
                 fn: Callable[[], Any], rounds: int = 1,
                 fresh: bool = False) -> Any:
        """Run ``fn`` for entry ``name``: counted, and recorded as a
        compile, when its operand ``key`` is ``fresh`` (the engine's
        sentinel saw it first)."""
        if fresh:
            sig, desc = operand_signature(operands)
            out, analysis, secs = self.capture(fn)
            self._sig_by_key[(name, key)] = sig
            self.record_compile(name, sig, desc, analysis, rounds=rounds,
                                compile_seconds=secs)
        else:
            out = fn()
        self.note_dispatch(name, self._sig_by_key[(name, key)])
        return out

    def capture(self, fn: Callable[[], Any]
                ) -> Tuple[Any, Dict[str, Any], float]:
        """``fn()`` under a :class:`CostMode`: ``(result, {"flops",
        "bytes_accessed", "hbm_bytes"}, host seconds)``."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        mode = CostMode()
        tic = time.perf_counter()
        with mode:
            out = fn()
        secs = time.perf_counter() - tic
        analysis = {"flops": mode.flops,
                    "bytes_accessed": mode.bytes_accessed,
                    "hbm_bytes": (int(torch.cuda.max_memory_allocated(
                        self.device)) if cuda else None)}
        if mode.kernels:
            analysis["hand_kernels"] = dict(mode.kernels)
        return out, analysis, secs

    def record_compile(self, name: str, sig: str,
                       desc: Dict[str, List[Any]],
                       analysis: Dict[str, Any], rounds: int = 1,
                       compile_seconds: Optional[float] = None
                       ) -> Dict[str, Any]:
        """Register one new signature; the first of an entry is an
        ``xla_compile`` event, any later one a ``recompile`` event with
        the operand diff."""
        entry = self.entries.get(name)
        is_recompile = entry is not None
        event: Dict[str, Any] = {
            "kind": "recompile" if is_recompile else "xla_compile",
            "entry": name, "signature": sig, "rounds": int(rounds),
        }
        event.update(analysis)
        if compile_seconds is not None:
            event["compile_seconds"] = round(float(compile_seconds), 4)
        if is_recompile:
            self.recompiles += 1
            event["compile_index"] = entry["compiles"]
            event["diff"] = signature_diff(entry["desc"], desc)
            entry["compiles"] += 1
            entry["signature"] = sig
            entry["desc"] = desc
            entry.update(analysis)
            if compile_seconds is not None:
                entry["compile_seconds"] = round(
                    entry.get("compile_seconds", 0.0)
                    + float(compile_seconds), 4)
        else:
            entry = {"compiles": 1, "signature": sig, "desc": desc,
                     "rounds": int(rounds), "variants": {}}
            entry.update(analysis)
            if compile_seconds is not None:
                entry["compile_seconds"] = round(float(compile_seconds), 4)
            self.entries[name] = entry
        entry["variants"][sig] = analysis
        self.compiles += 1
        self.pending_events.append(event)
        return entry

    def note_dispatch(self, name: str, sig: Optional[str] = None) -> None:
        """Mark ``name`` as the most recent dispatch, with the counts of
        the signature that ran."""
        entry = self.entries.get(name)
        if entry is None:
            return
        analysis = entry["variants"].get(sig, entry)
        self.last_dispatch = {
            "entry": name,
            "rounds": int(entry.get("rounds", 1)),
            "flops": analysis.get("flops"),
            "bytes_accessed": analysis.get("bytes_accessed"),
            "hbm_bytes": analysis.get("hbm_bytes"),
        }

    def drain_events(self) -> List[Dict[str, Any]]:
        out, self.pending_events = self.pending_events, []
        return out

    def summary(self) -> Dict[str, Any]:
        """Per-entry-point table for the scorecard."""
        out: Dict[str, Any] = {}
        for name, entry in sorted(self.entries.items()):
            out[name] = {k: entry[k] for k in
                         ("compiles", "rounds", "flops", "bytes_accessed",
                          "hbm_bytes", "compile_seconds") if k in entry}
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The cumulative gauges a rollup window carries."""
        return {"compiles": int(self.compiles),
                "recompiles": int(self.recompiles),
                "hbm_peak_bytes": self.hbm_peak_bytes()}

    def hbm_peak_bytes(self) -> Optional[int]:
        """The largest peak allocation over any entry's counted
        dispatch; None on the CPU."""
        peaks = [entry["hbm_bytes"] for entry in self.entries.values()
                 if entry.get("hbm_bytes") is not None]
        return max(peaks) if peaks else None
