"""Strategy contract — the port's counterpart of ``msrflute_tpu/strategies/base.py``.

A strategy contributes functions over the round's ``[K, ...]`` client
stacks (``msrflute_tpu/strategies/base.py:153-181, 300-330``):

- :meth:`client_step` — local work -> named, weighted payload parts
  (``"default"`` for a single-part strategy; FedLabels sends ``"sup"`` and
  ``"unsup"``); it gets the round's index and hands
  :meth:`transform_payload` the round's quantization threshold, the
  clients' random streams and the leaf bounds of the flat parameter
  vector;
- :meth:`client_weight`, :meth:`transform_payload` (local DP,
  quantization), and between them the privacy-attack metrics of
  ``privacy_metrics_config`` (:meth:`_apply_privacy_metrics`, the JAX
  package's ``strategies/base.py:153-231``): the metrics go into the
  clients' stats under ``privacy_*`` keys, and a dropped client is a zero
  weight;
- :meth:`broadcast_params` — the point the clients start from (the
  server's params; FedAC's coupled ``w_md``), and, for a strategy that
  ``owns_server_update``, :meth:`apply_server_update` in place of the
  server optimizer (FedAC's coupled sequences, FedBuff's SGD step and
  version roll), as ``msrflute_tpu/engine/round.py:1295, 1408-1411`` call
  them;
- :meth:`init_state` / :meth:`combine` — weighted sums -> aggregate
  pseudo-gradient, with cross-round state (DGA's staleness buffer) passed
  in and returned: ``combine(weighted_grad_sum, weight_sum, deferred,
  state, seed, num_clients) -> (agg, new_state)``;
  :meth:`combine_parts` takes every part's sums and the round's global
  params, and a multi-part strategy overrides it.

The round engine sets :attr:`BaseStrategy.task` (a strategy that runs the
model itself, as FedLabels' unsupervised pass does, reads it there).

Random streams: ``client_rngs(tag)`` gives one ``torch.Generator`` per
client (``SeedSequence([seed, round, client, tag])``, the analogue of the
JAX package's ``fold_in`` tags), and ``seed`` is the round's server-side
stream (global DP's kernel seed).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

MAX_WEIGHT = 100.0  # reference core/strategies/utils.py:11-19

ClientRngs = Callable[[int], List[torch.Generator]]
State = Dict[str, torch.Tensor]


def find_embedding_leaf(layout) -> Optional[Tuple[int, int, tuple]]:
    """``(offset, size, shape)`` of the first 2-D leaf, in the layout's
    (``ravel_pytree``) order, whose name holds ``embed`` — the JAX
    package's ``_find_embedding_leaf`` rule (on BERT that is
    ``position_embeddings``, not the word table)."""
    for name, off, size, shape in zip(layout.names, layout.offsets,
                                      layout.sizes, layout.shapes):
        if "embed" in name.lower() and len(shape) == 2:
            return off, size, shape
    return None


def filter_weight(weight: torch.Tensor) -> torch.Tensor:
    """NaN/Inf -> 0, cap at ``MAX_WEIGHT``."""
    weight = torch.nan_to_num(weight, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.clamp(weight, 0.0, MAX_WEIGHT)


class BaseStrategy:
    #: probability that a client's payload is deferred one round (DGA
    #: staleness); the engine draws the per-client coin and hands
    #: :meth:`combine` separate now and deferred sums
    stale_prob: float = 0.0
    #: class flags of ``msrflute_tpu/strategies/base.py:51-117``: whether
    #: the strategy composes with the RL weight hook, whether it replaces
    #: the server optimizer, and whether its combine keeps cross-round
    #: state (which fused RL refuses; ``supports_staleness`` has no reader
    #: here: the JAX package reads it for ``stale_prob``, which the port's
    #: config allows under DGA alone)
    supports_rl: bool = True
    #: whether ``client_step`` takes the arrival plane's traced staleness
    #: (``staleness``, ``[K]`` ints) in place of a drawn one: the round
    #: stages the operand only then (``strategies/fedbuff.py:85-89``)
    supports_traced_staleness: bool = False
    owns_server_update: bool = False
    stateful: bool = False
    #: the server runs the strategy's rounds host-side, one at a time
    #: (SCAFFOLD's controls, EF quantization's residuals)
    host_rounds: bool = False
    #: the flags the round keys off (``msrflute_tpu/strategies/base.py:
    #: 76-87``, ``strategies/robust.py:106``): whether the strategy
    #: implements ``dp_config.adaptive_clipping`` (else its constructor
    #: refuses it); the parts whose ``[K, P]`` rows enter the sum with the
    #: 0/1 live mask instead of the weight (secure aggregation's masked
    #: int32 rows, where every mask must enter with coefficient 1; the
    #: weight sum still normalizes); whether the round hands
    #: :meth:`mask_parts` the sampled cohort (secure aggregation); whether
    #: the round reduces the screened ``[K, P]`` stack with
    #: ``combine_stack`` instead of ``combine_parts`` (the robust
    #: aggregators)
    supports_adaptive_clipping: bool = False
    unit_weight_parts: frozenset = frozenset()
    wants_cohort: bool = False
    wants_client_stack: bool = False
    #: the round engine's task
    task = None
    #: device-resident carry (``server_config.fused_carry``,
    #: ``msrflute_tpu/strategies/base.py:88-130``): the strategy's
    #: per-client tables (SCAFFOLD's controls, EF's residuals,
    #: personalization's local models and alphas) live in
    #: ``strategy_state``, rows keyed by client id; the round calls
    #: :meth:`client_step_carry` (the rows gathered, the carry rows
    #: returned) and, after the combine, :meth:`apply_carry`
    device_carry: bool = False
    #: the client pool's size, the tables' row count; the server sets it
    #: from ``len(train_dataset)`` before ``init_state``
    carry_clients: int = 0
    #: the fleet paged carry (``server_config.fleet``,
    #: ``msrflute_tpu/strategies/base.py:100-111``): when non-zero, the
    #: tables hold this many page-pool slots instead of ``carry_clients``
    #: rows, the round indexes them by slot, and population-level math
    #: (SCAFFOLD's ``c``) keeps normalizing by ``carry_clients``
    carry_rows: int = 0
    #: the ``strategy_state`` keys that are per-client tables (what the
    #: pager pages); the others (SCAFFOLD's ``c``) stay resident
    carry_tables: tuple = ()
    #: ``client_update`` calls a client step makes (the personalization
    #: carry trains the global and the local model): kernel B1's launches
    #: a local step
    client_passes: int = 1
    #: cross-client megabatching (``server_config.megabatch``,
    #: ``msrflute_tpu/strategies/base.py:115-117``): every training the
    #: client step does goes through the ``client_update`` it is handed,
    #: so the engine can hand it the lane scan (FedLabels' unsupervised
    #: pass trains outside it and opts out).  The lane scan takes the
    #: start rows, the gradient offset and the generators each call hands
    #: it, so no strategy declares its passes ahead, as the JAX package's
    #: ``megabatch_passes`` does for its per-client vmap
    supports_megabatch: bool = True
    #: set by the round engine: the device-metric bus
    #: (:mod:`..telemetry.devbus`); a strategy publishes 0-d device tensors
    #: there while its round is enqueued, and they ride the round's packed
    #: stats (a bus that is off drops them)
    devbus: Any = None

    def __init__(self, config):
        self.config = config
        self.dp_config = getattr(config, "dp_config", None) or {}
        if self.dp_config.get("adaptive_clipping") and \
                not self.supports_adaptive_clipping:
            raise ValueError(
                f"{type(self).__name__} does not implement "
                "dp_config.adaptive_clipping — use strategy: fedavg")

    def client_step(self, client_update, global_flat, arrays, sample_mask,
                    client_lr, gens=None, quant_threshold=None,
                    client_rngs: Optional[ClientRngs] = None,
                    bounds: Optional[List[int]] = None,
                    round_idx: Optional[int] = None,
                    leakage_threshold: Optional[float] = None,
                    strategy_state: Optional[State] = None,
                    grad_offset: Optional[torch.Tensor] = None):
        """Run the K clients' local work; returns ``(parts, train_loss,
        num_samples, stats)`` with ``parts = {"default": (pg [K, P],
        w [K])}``.  ``bounds`` are the parameter leaves' offsets in the
        flat vector followed by its length (per-leaf work such as
        quantization reads them); ``round_idx`` is the round's index;
        ``leakage_threshold`` drops a client whose leakage exceeds it;
        ``strategy_state`` is the round's cross-round state (FedBuff reads
        its version history); ``grad_offset`` (``[K, P]``, SCAFFOLD's
        ``c - c_i``) goes to every local step's gradient."""
        pg, tl, ns, stats = client_update(global_flat, arrays, sample_mask,
                                          client_lr, gens,
                                          grad_offset=grad_offset)
        w = self.client_weight(num_samples=ns, train_loss=tl, stats=stats)
        w = self._apply_privacy_metrics(pg, w, stats, global_flat, arrays,
                                        sample_mask, leakage_threshold)
        pg, w = self.transform_payload(pg, w, quant_threshold=quant_threshold,
                                       client_rngs=client_rngs, bounds=bounds)
        return {"default": (pg, w)}, tl, ns, stats

    def _apply_privacy_metrics(self, pg, weight, stats, global_flat, arrays,
                               sample_mask, leakage_threshold):
        """Attack metrics and ``wt = 0`` client dropping (reference
        ``core/client.py:466-508``) for the K clients: ``privacy_overlap``,
        ``privacy_above_rank``, ``privacy_leakage`` and
        ``privacy_dropped`` land in ``stats`` as ``[K]`` vectors."""
        pm = getattr(self.config, "privacy_metrics_config", None)
        if pm is None or not pm.get("apply_metrics", False):
            return weight
        from ..privacy import attacks
        layout = self.task.layout()
        dropped = torch.zeros_like(weight)
        if pm.get("apply_indices_extraction", False) and "x" in arrays:
            leaf = find_embedding_leaf(layout)
            if leaf is not None:
                off, size, shape = leaf
                embed = pg[:, off:off + size].unflatten(-1, shape)
                x = arrays["x"]
                num_tokens = sample_mask.sum(dim=(1, 2)) * x.shape[-1]
                overlap, extracted = attacks.extract_indices_from_embeddings(
                    embed, x, num_tokens=num_tokens)
                stats["privacy_overlap"] = overlap
                rank = int(pm.get("allowed_word_rank", 9000))
                stats["privacy_above_rank"] = (
                    extracted[:, rank:].sum(-1)
                    / torch.clamp(extracted.sum(-1), min=1.0)
                    if rank < extracted.shape[1] else torch.zeros_like(overlap))
                max_overlap = pm.get("max_allowed_overlap")
                if max_overlap is not None:
                    dropped = torch.maximum(
                        dropped, (overlap > float(max_overlap)).to(
                            weight.dtype))
        if pm.get("apply_leakage_metric", False) and \
                getattr(self.task, "token_logprobs", None) is not None:
            leakage = attacks.practical_epsilon_leakage(
                layout.views(global_flat), global_flat, pg, self.task,
                layout, arrays, sample_mask,
                is_weighted=bool(pm.get("is_leakage_weighted", False)),
                max_ratio=math.exp(float(pm.get("max_leakage", 30.0))),
                attacker_optimizer_config=pm.attacker_optimizer_config)
            stats["privacy_leakage"] = leakage
            if leakage_threshold is not None:
                dropped = torch.maximum(
                    dropped, (leakage > leakage_threshold).to(weight.dtype))
        stats["privacy_dropped"] = dropped
        return weight * (1.0 - dropped)

    def carry_row_defaults(self) -> Dict[str, float]:
        """The fill of each carry table's row for a client never seen (the
        paged twin of ``init_state``'s fill): 0 unless a strategy says
        otherwise."""
        return {k: 0.0 for k in self.carry_tables}

    def _carry_table_rows(self) -> int:
        """The carry tables' row count: the page pool's slots under fleet
        paging, else the client pool."""
        if not self.carry_clients:
            raise ValueError(
                f"fused_carry {type(self).__name__} needs carry_clients (the "
                "client pool's size) set before init_state — the server sets "
                "it from len(train_dataset)")
        return int(self.carry_rows or self.carry_clients)

    def client_step_carry(self, client_update, global_flat, arrays,
                          sample_mask, client_lr, gens=None, *, client_ids,
                          live_mask, strategy_state, **kw):
        """The carry-mode client step: :meth:`client_step`'s ``(parts,
        train_loss, num_samples, stats)`` and a ``carry`` dict of ``[K,
        ...]`` rows with its ``keep`` gate, which :meth:`apply_carry`
        scatters.  ``client_ids`` (``[K]`` int64 on the device, -1 for
        padding) index the tables; ``live_mask`` is the clients' 0/1
        presence after chaos's dropout; ``kw`` are :meth:`client_step`'s
        keywords."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement device-carry mode")

    def apply_carry(self, state: State, client_ids: torch.Tensor,
                    src: torch.Tensor, carry: Dict[str, torch.Tensor]
                    ) -> State:
        """The round's carry rows scattered into new tables (see
        :func:`scatter_rows`); runs once a round after the combine."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement device-carry mode")

    def carry_stats(self, state: State) -> Dict[str, torch.Tensor]:
        """Scalars of the new carry state for the round's packed stats."""
        return {}

    def client_weight(self, *, num_samples: torch.Tensor,
                      train_loss: torch.Tensor,
                      stats: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def transform_payload(self, pseudo_grad: torch.Tensor,
                          weight: torch.Tensor, quant_threshold=None,
                          client_rngs: Optional[ClientRngs] = None,
                          bounds: Optional[List[int]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        return pseudo_grad, weight

    def init_state(self, params: torch.Tensor) -> State:
        return {}

    def broadcast_params(self, params: torch.Tensor,
                         state: State) -> torch.Tensor:
        """The ``[P]`` point the round's clients start from."""
        return params

    def apply_server_update(self, params: torch.Tensor, agg: torch.Tensor,
                            state: State, server_lr: float
                            ) -> Tuple[torch.Tensor, State]:
        """``(new params, new state)`` for a strategy that
        ``owns_server_update``: the engine calls it instead of the server
        optimizer, whose state passes through untouched."""
        raise NotImplementedError

    def combine(self, weighted_grad_sum: torch.Tensor,
                weight_sum: torch.Tensor, deferred: Optional[State],
                state: State, seed: int, num_clients: float
                ) -> Tuple[torch.Tensor, State]:
        """``(aggregate pseudo-gradient, new state)``.  ``deferred`` holds
        ``{"grad_sum", "weight_sum"}`` of the clients deferred to the next
        round when the engine runs with ``stale_prob > 0``."""
        return weighted_grad_sum / torch.clamp(weight_sum, min=1e-12), state

    def combine_parts(self, part_sums: Dict[str, Dict[str, torch.Tensor]],
                      deferred: Optional[State], state: State, seed: int,
                      num_clients: float,
                      global_params: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, State]:
        """Every part's ``{"grad_sum", "weight_sum"}`` -> ``(agg, new
        state)``; single-part strategies fall through to :meth:`combine`,
        a multi-part one overrides this."""
        if set(part_sums) != {"default"}:
            raise NotImplementedError(
                f"{type(self).__name__} must override combine_parts for "
                f"parts {sorted(part_sums)}")
        return self.combine(part_sums["default"]["grad_sum"],
                            part_sums["default"]["weight_sum"], deferred,
                            state, seed, num_clients)


def gather_rows(table: torch.Tensor, client_ids: torch.Tensor
                ) -> torch.Tensor:
    """``table``'s rows of ``client_ids`` (``[K]`` on the table's device),
    zero rows for padding ids (< 0)."""
    rows = table.index_select(0, torch.clamp(client_ids, min=0))
    valid = (client_ids >= 0).to(rows.dtype)
    return rows * valid.reshape((-1,) + (1,) * (rows.ndim - 1))


def scatter_rows(table: torch.Tensor, client_ids: torch.Tensor,
                 src: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A new table: ``table`` with row ``client_ids[src[k]]`` set to
    ``rows[src[k]]`` (the JAX package's ``.at[idx].set(mode="drop")``
    without a host read).  ``src`` maps each slot to itself, and a padding
    slot to a real one, so a padding slot writes a real client's row
    again, byte for byte: no id < 0 is written, and the duplicate writes
    agree.  A row whose ``keep`` gate is 0 carries the table's own row."""
    return table.index_copy(0, client_ids.index_select(0, src),
                            rows.index_select(0, src))
