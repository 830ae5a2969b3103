"""Secure aggregation (Bonawitz et al., CCS'17) — the port's counterpart of
``msrflute_tpu/strategies/secure_agg.py``.

Each client clips its pseudo-gradient to ``+-clip``, weights it, encodes it
in fixed point (``frac_bits`` fractional bits, rounded half to even) as
int32, and adds pairwise one-time masks toward the round's sampled cohort:
for each pair (i, j) one mask derived from the public pair key (seed,
round, min id, max id), added by the lower id and subtracted by the higher.
All arithmetic is in the int32 group with two's-complement wraparound, so
the cohort's sum telescopes to the sum of the encodings and one submission
alone reveals nothing.  The sum is decoded once, in two 15-bit halves
(each exact in float32), over the survivors' weight sum.

Mid-round loss (chaos dropout, a quarantined submission): the lost
client's pairmates' masks toward it stay in the sum.  :meth:`cancel_masks`
re-derives every (survivor, lost) edge's mask and subtracts it, so the
decoded sum is bitwise the unmasked one over the same survivors.
``min_survivors > 0`` aborts a round with fewer survivors (the aggregate
is zero, a no-op server step).

``graph: full`` masks every pair (K(K-1) mask generations a round, each
client deriving its own); ``graph: log`` masks only toward the slots at
circulant offsets ``+-2^t mod K`` (Bell et al., CCS'20), a set closed under
negation, so every edge is still symmetric.

The masks are drawn from a ``torch.Generator`` on the round's device,
seeded from ``SeedSequence([seed, round, min_id, max_id, tag])``: they are
not the JAX package's threefry bits (only the decoded sum is observable,
and it is the same; ROADMAP.md §C).

Range contract: the int32 group must hold the worst round sum
``K x 100 x clip x 2^frac_bits`` (weights are capped at 100 by
``filter_weight``); the constructor refuses a config beyond it.  Dropout
and quarantine only remove addends.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .fedavg import FedAvg

#: ``server_config.secure_agg``'s options
SECURE_AGG_KEYS = ("frac_bits", "clip", "seed", "graph", "min_survivors")
#: the last entropy word of a pair mask's stream
MASK_TAG = 0x5EC466
_TWO32 = 1 << 32


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced mod 2^32 into int32 (two's complement)."""
    return (torch.remainder(x + (1 << 31), _TWO32) - (1 << 31)).to(
        torch.int32)


def check_options(sa, num_clients, dp_config, dump_norm_stats: bool
                  ) -> dict:
    """``server_config.secure_agg`` (a bool or an options dict) checked as
    the JAX constructor checks it (``secure_agg.py:114-199``), with the
    range contract at ``num_clients`` a round: the options with their
    defaults, or ``ValueError``."""
    if not isinstance(sa, (dict, bool)):
        raise ValueError(
            f"server_config.secure_agg must be a bool or an options "
            f"dict, got {type(sa).__name__}")
    sa = sa if isinstance(sa, dict) else {}
    unknown = set(sa) - set(SECURE_AGG_KEYS)
    if unknown:
        raise ValueError(
            f"server_config.secure_agg has unknown keys {sorted(unknown)}"
            f" (known: {', '.join(SECURE_AGG_KEYS)})")
    opts = {"frac_bits": int(sa.get("frac_bits", 12)),
            "clip": float(sa.get("clip", 4.0)),
            "seed": int(sa.get("seed", 0)),
            "graph": str(sa.get("graph", "full")).lower(),
            "min_survivors": int(sa.get("min_survivors", 0))}
    if opts["graph"] not in ("full", "log"):
        raise ValueError(f"secure_agg.graph must be 'full' or 'log', "
                         f"got {opts['graph']!r}")
    if not 1 <= opts["frac_bits"] <= 24:
        raise ValueError(f"secure_agg.frac_bits must be in [1, 24], "
                         f"got {opts['frac_bits']}")
    if not opts["clip"] > 0:
        raise ValueError(f"secure_agg.clip must be > 0, got {opts['clip']}")
    if opts["min_survivors"] < 0:
        raise ValueError(f"secure_agg.min_survivors must be >= 0, "
                         f"got {opts['min_survivors']}")
    # the worst round sum must fit int32 at the full sampled cohort;
    # weights are capped at 100, dropout only removes addends
    k = int(str(num_clients).split(":")[-1])
    unit = 100.0 * opts["clip"] * float(1 << opts["frac_bits"])
    if k * unit >= 2.0 ** 31:
        raise ValueError(
            f"secure_agg range contract violated: "
            f"num_clients_per_iteration={k} x MAX_WEIGHT=100 x "
            f"clip={opts['clip']} x 2^{opts['frac_bits']} = {k * unit:.3g} "
            f">= 2^31 — the int32 group must hold the worst-case round "
            f"sum.  Lower num_clients_per_iteration to <= "
            f"{int((2.0 ** 31 - 1) // unit)}, or lower clip / frac_bits")
    dp_config = dp_config or {}
    if dp_config.get("enable_local_dp", False) or \
            dp_config.get("enable_global_dp", False):
        raise ValueError(
            "strategy: secure_agg does not compose with dp_config DP "
            "modes yet — local DP noise breaks the fixed-point range "
            "contract and the RDP accounting assumes the unmasked "
            "pipeline; run one or the other")
    if dump_norm_stats:
        raise ValueError(
            "dump_norm_stats reads per-client payloads, which under "
            "secure_agg are masked int32 group elements — the dumped "
            "norms/cosines would be noise.  Disable one of the two")
    return opts


class SecureAgg(FedAvg):

    supports_rl = False
    wants_cohort = True
    unit_weight_parts = frozenset({"default"})

    def __init__(self, config):
        super().__init__(config)
        sc = config.server_config
        opts = check_options(
            sc.get("secure_agg", True), sc.get("num_clients_per_iteration",
                                               10), self.dp_config,
            bool(config.get("dump_norm_stats",
                            sc.get("dump_norm_stats", False))))
        self.frac_bits = opts["frac_bits"]
        self.clip = opts["clip"]
        self.seed = opts["seed"]
        self.graph = opts["graph"]
        self.min_survivors = opts["min_survivors"]
        #: recovery totals, accumulated by the server from the round stats
        self.counters: Dict[str, float] = {
            "recovered_dropout": 0.0,
            "recovered_quarantine": 0.0,
            "aborted_rounds": 0.0,
        }

    # ------------------------------------------------------------------
    @staticmethod
    def _log_offsets(k: int) -> List[int]:
        """Circulant offsets ``+-2^t mod K``, deduplicated, 0 removed: a
        set closed under negation mod K, so slot p lists slot q iff q
        lists p."""
        offs = set()
        t = 1
        while t < k:
            offs.add(t % k)
            offs.add((-t) % k)
            t *= 2
        offs.discard(0)
        return sorted(offs)

    def _partners(self, p: int, k: int) -> List[int]:
        """The slots slot ``p`` masks toward (itself excluded)."""
        if self.graph == "log" and k > 1:
            return [(p + off) % k for off in self._log_offsets(k)]
        return [q for q in range(k) if q != p]

    def pair_mask(self, round_idx: int, a: int, b: int, n: int,
                  device: torch.device) -> torch.Tensor:
        """The ``[n]`` int64 mask (int32 range) of the pair of client ids
        ``(a, b)`` in round ``round_idx``, from its public key."""
        lo, hi = min(a, b), max(a, b)
        seed = int(np.random.SeedSequence(
            [self.seed, int(round_idx), lo, hi, MASK_TAG]).generate_state(
                1, dtype=np.uint64)[0] >> np.uint64(1))
        gen = torch.Generator(device=device).manual_seed(seed)
        bits = torch.empty(n, dtype=torch.int32, device=device)
        bits.random_(-(1 << 31), 1 << 31, generator=gen)
        return bits.to(torch.int64)

    def encode(self, pg: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Clip, then weight, then round half to even: ``[K, P]`` int32.
        A NaN encodes as 0, as XLA converts it (an out-of-range value
        cannot arise within the range contract)."""
        scale = float(1 << self.frac_bits)
        x = torch.clamp(pg, -self.clip, self.clip) * w[:, None] * scale
        return torch.round(torch.nan_to_num(x, nan=0.0)).to(torch.int32)

    def mask_rows(self, enc: torch.Tensor, cohort_ids: np.ndarray,
                  sampled_mask: np.ndarray, live_mask: torch.Tensor,
                  round_idx: int, row0: int = 0) -> torch.Tensor:
        """Every client's int32 row ``enc [k, P]`` plus its signed pairwise
        masks toward the sampled cohort (``cohort_ids [K]``, ``sampled_mask
        [K]``, host arrays), in the int32 group; ``live_mask [k]`` zeroes
        an absent client's submission.  The rows are the cohort's
        ``row0 .. row0 + k`` (a chunk of the clients, or all K)."""
        masked = torch.zeros_like(enc)
        n = enc.shape[1]
        ids = [int(i) for i in np.asarray(cohort_ids)]
        k = len(ids)
        sampled = np.asarray(sampled_mask) > 0
        for row in range(enc.shape[0]):
            p = row0 + row
            if ids[p] < 0:
                continue   # padding never enters the protocol
            acc = enc[row].to(torch.int64)
            for q in self._partners(p, k):
                if not sampled[q] or ids[q] < 0 or ids[q] == ids[p]:
                    continue
                sign = 1 if ids[q] > ids[p] else -1
                acc = acc + sign * self.pair_mask(round_idx, ids[p], ids[q],
                                                  n, enc.device)
            masked[row] = wrap_int32(acc)
        return masked * (live_mask > 0).to(torch.int32)[:, None]

    def mask_parts(self, parts, cohort_ids: np.ndarray,
                   sampled_mask: np.ndarray, live_mask: torch.Tensor,
                   round_idx: int, row0: int = 0) -> Tuple[dict, torch.Tensor]:
        """Encode and pairwise-mask the default part of every client
        (:meth:`encode`, :meth:`mask_rows`): after the strategy's client
        step and the corruption, before the sums.  Returns the parts with
        the default part's rows masked int32 and ``sub_norm [k]``, the L2
        norm of each submitted (corrupted, unmasked) float payload, which
        the masked screening votes on.  ``row0``: the cohort row of the
        first client in ``parts`` (a chunk of the round's clients)."""
        pg, w = parts["default"]
        sub_norm = torch.sqrt(torch.sum(pg * pg, dim=1))
        masked = self.mask_rows(self.encode(pg, w), cohort_ids,
                                sampled_mask, live_mask, round_idx, row0)
        out = dict(parts)
        out["default"] = (masked, w)
        return out, sub_norm

    def cancel_masks(self, grad_sum: torch.Tensor, cohort_ids: np.ndarray,
                     sampled_mask: np.ndarray, survivor_mask: np.ndarray,
                     round_idx: int) -> torch.Tensor:
        """Subtract from the masked int32 sum ``grad_sum [P]`` the mask of
        every edge from a survivor to a sampled client that was lost, so
        the sum is the survivors' encodings alone.  With no client lost no
        mask is derived."""
        ids = [int(i) for i in np.asarray(cohort_ids)]
        surv = np.asarray(survivor_mask) > 0
        samp = np.asarray(sampled_mask) > 0
        k, n = len(ids), grad_sum.shape[0]
        acc: Optional[torch.Tensor] = None
        for p in range(k):
            if not surv[p] or ids[p] < 0:
                continue
            for q in self._partners(p, k):
                if not samp[q] or surv[q] or ids[q] < 0 or ids[q] == ids[p]:
                    continue
                sign = 1 if ids[q] > ids[p] else -1
                m = sign * self.pair_mask(round_idx, ids[p], ids[q], n,
                                          grad_sum.device)
                acc = m if acc is None else acc + m
        if acc is None:
            return grad_sum
        return wrap_int32(grad_sum.to(torch.int64) - acc)

    def decode(self, enc_sum: torch.Tensor,
               weight_sum: torch.Tensor) -> torch.Tensor:
        """The int32 sum over the weight sum, in float32: split into 15-bit
        halves, each exact in float32, so the one rounding left is at the
        aggregate's own magnitude."""
        denom = torch.clamp(weight_sum, min=1e-12)
        scale = torch.full((), float(1 << self.frac_bits),
                           dtype=torch.float32, device=enc_sum.device)
        hi = enc_sum >> 15                 # arithmetic: floor
        lo = enc_sum - (hi << 15)          # in [0, 2^15)
        k = 1.0 / scale / denom
        return (hi.to(torch.float32) * (32768.0 * k)
                + lo.to(torch.float32) * k)

    def combine_parts(self, part_sums, deferred, state, seed, num_clients,
                      global_params=None):
        default = part_sums["default"]
        return self.decode(default["grad_sum"], default["weight_sum"]), state
