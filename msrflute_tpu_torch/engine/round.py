"""One federated round on one device — the port's counterpart of the monolithic
path of ``msrflute_tpu/engine/round.py::RoundEngine._build_round_step``.

Per round: the K clients train at once (:mod:`.client_update`), the
strategy weighs and transforms each client's payload parts (FedAvg: its
sample count; DGA: softmax weight, local DP, quantization; FedLabels: a
supervised and an unsupervised part), the client mask zeroes padding
clients' weights, loss and sample counts, each part's weighted sums go
through ``strategy.combine_parts`` with the round's global params (with
the staleness split when the strategy defers clients,
``round.py:917-922, 988-1019``), and the server optimizer steps on the
aggregate pseudo-gradient — or, for a strategy that owns its server
update (FedAC, FedBuff), ``strategy.apply_server_update`` replaces that
step (``round.py:1408-1411``).  The clients start from
``strategy.broadcast_params`` (``round.py:1295``; FedAC's ``w_md``).

The host-orchestrated rounds (SCAFFOLD, EF quantization, DGA's RL hook)
use the pair :meth:`RoundEngine.client_payloads` (the clients' weighted
payloads, with a per-client gradient offset) and
:meth:`RoundEngine.apply_custom_weights` (a server step on the payloads
under weights the caller picks), ``round.py:1554-1660``.  The server
optimizers are functional, so two calls of ``apply_custom_weights`` from
one state (the RL hook's candidates) both start from that state.

Randomness, all from ``np.random.SeedSequence`` entropy, so a resumed run
needs only the round number and the numpy sampling state to replay every
stream:

- ``[seed, r, k]``: client k's dropout masks in round r (the analogue of
  ``fold_in(rng, client_id)`` at ``round.py:851``);
- ``[seed, r, k, 2]``: client k's local-DP noise (``fold_in(rng_c, 2)``);
- ``[seed, r, k, 3]``: client k's staleness coin (``fold_in(rng_c, 3)``);
- ``[seed, r, 2**32 - 1, 4]``: the round's server stream, global DP's
  kernel seed (no dataset index reaches client slot ``2**32 - 1``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.batching import RoundBatch
from ..models.base import BaseTask, Params
from ..optim import make_optimizer
from ..strategies.base import BaseStrategy
from .client_update import ClientHParams, build_client_update


#: stream tags (the fourth entropy word) and the server's client slot
DP_NOISE_TAG, STALE_COIN_TAG, SERVER_TAG = 2, 3, 4
PAD_CLIENT, SERVER_SLOT = 2**32, 2**32 - 1


def stream_seed(*entropy: int) -> int:
    """A 63-bit seed from ``SeedSequence(entropy)``."""
    return int(np.random.SeedSequence(list(entropy)).generate_state(
        1, dtype=np.uint64)[0] >> np.uint64(1))


@dataclass
class ServerState:
    """Global model (flat ``[P]``), server optimizer state, round, and the
    strategy's cross-round state (DGA's staleness sums)."""

    params: torch.Tensor
    opt_state: Dict[str, torch.Tensor]
    round: int = 0
    strategy_state: Dict[str, torch.Tensor] = field(default_factory=dict)


def pallas_apply_flag(server_config) -> bool:
    """``server_config.megakernel.pallas_apply`` as the JAX engine reads it:
    opt-in, and off under ``enable: false``.  (``fused_epochs`` changes
    only how the JAX package traces its loop; the port's loop is the same
    math either way.)"""
    raw = server_config.get("megakernel") or {}
    return bool(raw.get("enable", True)) and bool(raw.get("pallas_apply",
                                                          False))


def precision_policy(server_config) -> Dict[str, str]:
    """``server_config.precision`` -> ``{"params"|"compute"|"stats":
    dtype name}``: empty when absent or ``enable: false``."""
    raw = server_config.get("precision") or {}
    if not raw or not bool(raw.get("enable", True)):
        return {}
    return {k: str(raw[k]) for k in ("params", "compute", "stats")
            if raw.get(k) is not None}


class RoundEngine:
    def __init__(self, task: BaseTask, config, strategy: BaseStrategy,
                 device: torch.device, seed: int = 0):
        self.task = task
        self.strategy = strategy
        strategy.task = task
        self.device = device
        self.seed = int(seed)
        self.layout = task.layout()
        #: the leaves' offsets in the flat vector, then its length
        self.bounds = list(self.layout.offsets) + [self.layout.numel]
        cc, sc = config.client_config, config.server_config
        freeze = cc.get("freeze_layer") or []
        if isinstance(freeze, str):
            freeze = [freeze]
        #: the precision policy as the JAX engine normalizes it
        #: (``round.py:185-197``): off under ``enable: false``, else each
        #: dtype given
        self.precision = precision_policy(sc)
        self.hparams = ClientHParams(
            max_grad_norm=cc.get("max_grad_norm"),
            fedprox_mu=float(cc.get("fedprox_mu", 0.0) or 0.0),
            num_epochs=int(cc.get("num_epochs", 1) or 1),
            pallas_apply=pallas_apply_flag(sc),
            freeze_layers=tuple(freeze),
            param_dtype=self.precision.get("params"),
            compute_dtype=self.precision.get("compute"),
            stats_dtype=self.precision.get("stats"))
        self.client_update = build_client_update(
            task, cc.optimizer_config, self.hparams)
        self.server_opt = make_optimizer(sc.optimizer_config)
        self.server_max_grad_norm = sc.get("max_grad_norm")
        self.random = task.draws_random
        #: local steps run so far (num_epochs x S per round): the number of
        #: optimizer-tail passes, hence of kernel B1 launches with
        #: pallas_apply
        self.local_steps = 0

    def init_state(self, params: Params) -> ServerState:
        flat = self.layout.flatten(params).to(self.device, torch.float32)
        return ServerState(flat, self.server_opt.init(flat), 0,
                           self.strategy.init_state(flat))

    def params_dict(self, state: ServerState) -> Params:
        return self.layout.views(state.params)

    def client_generators(self, round_idx: int, client_ids,
                          tag: Optional[int] = None) -> List[torch.Generator]:
        """One generator per client on the engine's device: the dropout
        stream (no tag) or a tagged one."""
        gens = []
        for cid in np.asarray(client_ids).tolist():
            entropy = [self.seed, int(round_idx),
                       cid if cid >= 0 else PAD_CLIENT]
            if tag is not None:
                entropy.append(tag)
            gens.append(torch.Generator(device=self.device).manual_seed(
                stream_seed(*entropy)))
        return gens

    def stale_coins(self, round_idx: int, client_ids) -> np.ndarray:
        """Client k is deferred when its ``[seed, r, k, 3]`` uniform falls
        below ``stale_prob`` (``jax.random.bernoulli``'s rule)."""
        p = self.strategy.stale_prob
        return np.asarray([
            np.random.default_rng(stream_seed(
                self.seed, int(round_idx), cid if cid >= 0 else PAD_CLIENT,
                STALE_COIN_TAG)).random() < p
            for cid in np.asarray(client_ids).tolist()], np.float32)

    def server_seed(self, round_idx: int) -> int:
        return stream_seed(self.seed, int(round_idx), SERVER_SLOT,
                           SERVER_TAG)

    def _client_step(self, state: ServerState, batch: RoundBatch,
                     global_flat: torch.Tensor, client_lr: float,
                     quant_threshold: Optional[float],
                     leakage_threshold: Optional[float],
                     grad_offsets: Optional[torch.Tensor] = None):
        """The round's batch on the device and the strategy's client step
        -> ``(parts, train_loss, num_samples, stats, client_mask)``."""
        dev = self.device
        r = state.round
        arrays = {k: torch.from_numpy(v).to(dev)
                  for k, v in batch.arrays.items()}
        sample_mask = torch.from_numpy(batch.sample_mask).to(dev)
        cm = torch.from_numpy(batch.client_mask).to(dev)
        gens = (self.client_generators(r, batch.client_ids)
                if self.random else None)
        self.local_steps += self.hparams.num_epochs * sample_mask.shape[1]
        parts, tl, ns, stats = self.strategy.client_step(
            self.client_update, global_flat, arrays, sample_mask,
            client_lr, gens, quant_threshold=quant_threshold,
            client_rngs=lambda tag: self.client_generators(
                r, batch.client_ids, tag), bounds=self.bounds, round_idx=r,
            leakage_threshold=leakage_threshold,
            strategy_state=state.strategy_state, grad_offset=grad_offsets)
        return parts, tl, ns, stats, cm

    def _server_clip(self, agg: torch.Tensor) -> torch.Tensor:
        if self.server_max_grad_norm is None:
            return agg
        norm = torch.linalg.vector_norm(agg)
        return agg * torch.clamp(float(self.server_max_grad_norm)
                                 / torch.clamp(norm, min=1e-12), max=1.0)

    def client_payloads(self, state: ServerState, batch: RoundBatch,
                        client_lr: float,
                        grad_offsets: Optional[torch.Tensor] = None,
                        leakage_threshold: Optional[float] = None):
        """Per-client ``(pseudo_grad [K, P], weight [K], train_loss [K],
        stats)`` from the server's params, padding clients' weight and
        loss zeroed — the payload program of the host-orchestrated rounds
        (``msrflute_tpu/engine/round.py:1554-1632``).  ``grad_offsets``
        (``[K, P]`` on the engine's device, zero rows for padding clients)
        goes to every local step's gradient (SCAFFOLD's ``c - c_i``)."""
        parts, tl, _, stats, cm = self._client_step(
            state, batch, state.params, client_lr, None, leakage_threshold,
            grad_offsets)
        pg, w = parts["default"]
        return pg, w * cm, tl * cm, stats

    def apply_custom_weights(self, state: ServerState, pgs: torch.Tensor,
                             weights, server_lr: float) -> ServerState:
        """The server step on ``sum_k w_k pg_k / sum_k w_k`` (reference
        ``dga.py:317-332``; ``round.py:1634-1660``), round + 1, the
        strategy state passed through.  ``state`` is left as it was."""
        w = torch.as_tensor(weights, dtype=torch.float32, device=pgs.device)
        agg = (w @ pgs) / torch.clamp(w.sum(), min=1e-12)
        params, opt_state = self.server_opt.step(
            state.params, self._server_clip(agg), state.opt_state,
            server_lr, self.bounds)
        return ServerState(params, opt_state, state.round + 1,
                           state.strategy_state)

    def run_round(self, state: ServerState, batch: RoundBatch,
                  client_lr: float, server_lr: float,
                  quant_threshold: Optional[float] = None,
                  leakage_threshold: Optional[float] = None
                  ) -> Tuple[ServerState, Dict[str, float]]:
        """One round -> ``(new state, stats)``: the round's scalar sums,
        and with the privacy metrics on, ``stats["privacy"]``: each
        ``privacy_*`` key's ``[K]`` values and the client mask, on the
        host (the server logs them and adapts the leakage threshold)."""
        dev = self.device
        r = state.round
        bcast = self.strategy.broadcast_params(state.params,
                                               state.strategy_state)
        parts, tl, ns, stats, cm = self._client_step(
            state, batch, bcast, client_lr, quant_threshold,
            leakage_threshold)
        stale = None
        if self.strategy.stale_prob > 0.0:
            stale = torch.from_numpy(
                self.stale_coins(r, batch.client_ids)).to(dev) * cm
        part_sums = {}
        for name, (pg, w) in parts.items():
            w = w * cm
            if stale is None:
                part_sums[name] = {"grad_sum": w @ pg, "weight_sum": w.sum()}
                continue
            w_now, w_def = w * (1.0 - stale), w * stale
            part_sums[name] = {"grad_sum": w_now @ pg,
                               "weight_sum": w_now.sum(),
                               "grad_sum_def": w_def @ pg,
                               "weight_sum_def": w_def.sum()}
        deferred = None
        if stale is not None:
            deferred = {"grad_sum": part_sums["default"]["grad_sum_def"],
                        "weight_sum": part_sums["default"]["weight_sum_def"]}
        agg, strategy_state = self.strategy.combine_parts(
            part_sums, deferred, state.strategy_state, self.server_seed(r),
            float(batch.client_mask.sum()), global_params=bcast)
        agg = self._server_clip(agg)
        if self.strategy.owns_server_update:
            new_params, strategy_state = self.strategy.apply_server_update(
                state.params, agg, strategy_state, server_lr)
            opt_state = state.opt_state
        else:
            new_params, opt_state = self.server_opt.step(
                state.params, agg, state.opt_state, server_lr, self.bounds)
        count = cm.sum()
        denom = torch.clamp(count, min=1.0)
        # the JAX package's choice: the "default" part's weight sum, else
        # the first part's (FedLabels' "sup", its client count)
        first = part_sums.get("default", next(iter(part_sums.values())))
        round_stats = {
            "train_loss_sum": (tl * cm).sum(),
            "num_samples_sum": (ns * cm).sum(),
            "client_count": count,
            "weight_sum": first["weight_sum"],
            "grad_mean": (stats["mean"] * cm).sum() / denom,
            "grad_mag": (stats["mag"] * cm).sum() / denom,
            "grad_var": (stats["var_corrected"] * cm).sum() / denom,
            "grad_norm": (stats["norm"] * cm).sum() / denom,
            "agg_grad_norm": torch.linalg.vector_norm(agg),
        }
        privacy = [k for k in stats if k.startswith("privacy_")]
        if privacy:
            round_stats.update((k, stats[k]) for k in privacy)
            round_stats["client_mask"] = cm
        # one device->host transfer for the whole stats dict
        sizes = [v.numel() for v in round_stats.values()]
        host = torch.cat([v.reshape(-1).to(torch.float32)
                          for v in round_stats.values()]).cpu()
        out = dict(zip(round_stats, torch.split(host, sizes)))
        per_client = {k: out.pop(k).numpy() for k in privacy}
        if privacy:
            per_client["client_mask"] = out.pop("client_mask").numpy()
            out["privacy"] = per_client
        out.update((k, float(v[0])) for k, v in list(out.items())
                   if k != "privacy")
        return (ServerState(new_params, opt_state, r + 1, strategy_state),
                out)
