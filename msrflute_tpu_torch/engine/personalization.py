"""Personalization — per-user local models with convex interpolation, the
port's counterpart of the host path of
``msrflute_tpu/engine/personalization.py`` (reference
``experiments/cv/server.py``, ``core/client.py:387-443``,
``utils/utils.py:598-617``):

- every user owns a local model and a scalar ``alpha``
  (``client_config.convex_model_interp`` to start, 0.75);
- when sampled, a user trains both the global model and its local model
  on the same packed batch, through the round's own client update (kernel
  B1 under ``pallas_apply``), the K users' local models as one ``[K, P]``
  stack; then ``alpha`` takes one SGD step at the client learning rate:
  ``grad_alpha = sum((w_g - pg_g) - (w_p - pg_p)) . (alpha pg_g +
  (1 - alpha) pg_p) + 0.02 alpha``, clipped to ``[1e-4, 0.9999]``, a
  non-finite result reset to the starting alpha;
- the personal pass runs inside :meth:`PersonalizationServer._sample`,
  after the cohort draw and before the round packs its own batch, so the
  shuffles come from ``_np_rng`` in the JAX package's order;
- the personalized eval at every ``val_freq`` scores each val user by
  ``alpha * squash(local) + (1 - alpha) * squash(global)`` and logs
  ``Personalized val acc`` / ``Personalized val loss``
  (:func:`.evaluation.personalized_eval_sums`), users staged K at a time;
- a user's local model starts as the current global model
  (``personalization_init: global``, the default), the round-0 model
  (``initial``) or a fresh init from the port's own stream (``random``).

Per-user state lives on the host in :class:`PersonalizationStore` between
rounds, one file per user (``personalization/user<N>_model.pt`` with a
crc32 sidecar), written for the users a round updated; a resumed run
reloads it, so a run resumed after round N equals one that never stopped.

With ``server_config.fused_carry: true`` (``personalization.py:108-150,
415-450``) the server selects :class:`~..strategies.personalized.
PersonalizedFedAvg` instead: the local models, alphas and ``seen`` gate
ride ``strategy_state`` and the round's own client step, ``_sample`` is
the base sampler, no store is kept (durability rides the model
checkpoint), the round rides the dispatch ring, and the personalized eval
reads the tables at the eval boundary: the ``[N]`` ``seen`` gate first;
under the fleet paged carry it reads each user's row from the pager's host
store instead.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..data.batching import pack_round_batches, steps_for
from ..utils.logging import print_rank
from .checkpoint import read_verified, write_verified
from .evaluation import personalized_eval_sums
from .round import SERVER_SLOT, stream_seed
from .server import OptimizationServer

#: stream tags (see :mod:`.round`): the personal pass's global-model and
#: local-model dropout streams, and the ``random`` cold start
PERSONAL_GLOBAL_TAG, PERSONAL_LOCAL_TAG, PERSONAL_INIT_TAG = 5, 6, 7
ALPHA_MIN, ALPHA_MAX, ALPHA_DECAY = 1e-4, 0.9999, 0.02


class PersonalizationStore:
    """Host-side per-user ``(local params [P], alpha)``, saved one file per
    user and only for the users updated since the last save."""

    def __init__(self, init_alpha: float, store_dir: Optional[str] = None):
        self.init_alpha = float(init_alpha)
        self.store_dir = store_dir
        self.params: Dict[int, torch.Tensor] = {}
        self.alpha: Dict[int, float] = {}
        self._dirty: set = set()

    def get(self, user_idx: int) -> Tuple[Optional[torch.Tensor], float]:
        """``(local params or None, alpha)`` of a user."""
        return (self.params.get(user_idx),
                self.alpha.get(user_idx, self.init_alpha))

    def put(self, user_idx: int, params: torch.Tensor, alpha: float) -> None:
        self.params[user_idx] = params
        self.alpha[user_idx] = float(alpha)
        self._dirty.add(user_idx)

    def _user_path(self, uid: int) -> str:
        return os.path.join(self.store_dir, f"user{uid}_model.pt")

    def save(self) -> None:
        if self.store_dir is None:
            return
        os.makedirs(self.store_dir, exist_ok=True)
        for uid in sorted(self._dirty):
            write_verified(self._user_path(uid),
                           {"alpha": self.alpha[uid],
                            "params": self.params[uid]})
        self._dirty.clear()

    def load(self) -> bool:
        """Read every user file of the store directory (each checked
        against its crc sidecar); False when there is none."""
        if self.store_dir is None or not os.path.isdir(self.store_dir):
            return False
        found = False
        for name in sorted(os.listdir(self.store_dir)):
            if not (name.startswith("user") and name.endswith("_model.pt")):
                continue
            uid = int(name[len("user"):-len("_model.pt")])
            payload = read_verified(os.path.join(self.store_dir, name))
            self.params[uid] = payload["params"]
            self.alpha[uid] = float(payload["alpha"])
            found = True
        return found


def personal_step(client_update, global_flat: torch.Tensor,
                  local_flat: torch.Tensor, alpha: torch.Tensor,
                  arrays: Dict[str, torch.Tensor], sample_mask: torch.Tensor,
                  client_mask: torch.Tensor, lr: float, alpha0: float,
                  gens: Tuple = (None, None)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One personal pass over K users: the global model's and the local
    models' client updates on the same batch, then the alpha step.
    Returns the new local models ``[K, P]`` and alphas ``[K]``; rows of
    padding users (``client_mask`` 0) are returned unchanged."""
    pg_g = client_update(global_flat, arrays, sample_mask, lr, gens[0])[0]
    pg_p = client_update(local_flat, arrays, sample_mask, lr, gens[1])[0]
    new_local = local_flat - pg_p
    a = alpha[:, None]
    # the reference updates alpha after both trainings, so the difference
    # is of the trained models: (w_g - pg_g) - (w_p - pg_p)
    grad_alpha = torch.sum(((global_flat - pg_g) - new_local) *
                           (a * pg_g + (1.0 - a) * pg_p), dim=-1) \
        + ALPHA_DECAY * alpha
    new_alpha = torch.clamp(alpha - lr * grad_alpha, ALPHA_MIN, ALPHA_MAX)
    new_alpha = torch.where(torch.isfinite(new_alpha), new_alpha,
                            torch.full_like(new_alpha, alpha0))
    live = client_mask > 0
    return (torch.where(live[:, None], new_local, local_flat),
            torch.where(live, new_alpha, alpha))


def _max_clients(spec) -> int:
    """The most clients a round samples (``"lo:hi"`` -> hi)."""
    if isinstance(spec, str) and ":" in spec:
        return int(spec.split(":")[1])
    return int(spec)


class PersonalizationServer(OptimizationServer):
    """:class:`OptimizationServer` plus the personal pass in ``_sample``,
    the personalized eval at ``val_freq`` and the per-user store; under
    ``fused_carry`` the carry strategy in their place (see the module
    docstring)."""

    #: under fused_carry ``_sample`` is the base sampler (the personal pass
    #: runs in the round), so the ring may run
    fused_carry_sample = True

    def __init__(self, task, config, train_dataset, val_dataset=None,
                 test_dataset=None, model_dir: str = "./models",
                 device=None, seed: int = 0, init_params=None,
                 metrics=None, server_train_dataset=None):
        sc, cc = config.server_config, config.client_config
        fused = bool(sc.get("fused_carry", False))
        # the personal pass reads the current global model every round
        if not fused and int(sc.get("rounds_per_step", 1) or 1) > 1:
            print_rank("personalization forces rounds_per_step=1")
            sc["rounds_per_step"] = 1
        self.alpha0 = float(cc.get("convex_model_interp", 0.75))
        self.init_kind = str(sc.get("personalization_init", "global"))
        self.logspace = sc.get("personalization_interp", "probs") == \
            "logprobs"
        # before the base constructor, whose resume reloads the store
        self.store = None if fused else PersonalizationStore(
            self.alpha0, os.path.join(model_dir, "personalization"))
        if self.init_kind == "initial" and init_params is None:
            init_params = task.init_params(seed)
        super().__init__(task, config, train_dataset, val_dataset,
                         test_dataset, model_dir=model_dir, device=device,
                         seed=seed, init_params=init_params, metrics=metrics,
                         server_train_dataset=server_train_dataset)
        self._initial_params = (
            self.engine.layout.flatten(init_params).to(self.device)
            if self.init_kind == "initial" else None)
        #: users scored at once by the personalized eval: one round's K
        self.eval_chunk = max(_max_clients(
            sc.get("num_clients_per_iteration", 10)), 1)
        self._eval_chunks: Optional[List[tuple]] = None
        for key in ("secsPersonalPass", "secsPersonalStore",
                    "secsPersonalSave"):
            self.run_stats[key] = []

    def _select_strategy(self, config) -> type:
        if self._fused_carry:
            from ..strategies.personalized import PersonalizedFedAvg
            strategy = str(config.strategy or "fedavg").lower()
            if strategy not in ("fedavg", "fedprox"):
                raise ValueError(
                    "fused_carry personalization composes only with "
                    f"strategy: fedavg/fedprox (got {strategy!r}) — drop "
                    "fused_carry")
            return PersonalizedFedAvg
        return super()._select_strategy(config)

    def _resume(self) -> bool:
        if not super()._resume():
            return False
        if self.store is not None and self.store.load():
            print_rank(f"restored personalization state for "
                       f"{len(self.store.alpha)} users")
        return True

    # ------------------------------------------------------------------
    def _sample(self) -> list:
        sampled = super()._sample()
        if self.store is not None:
            self._run_personal_pass(sampled)
        return sampled

    def _default_local(self) -> torch.Tensor:
        """A new user's local model: ``[P]`` on the device."""
        if self.init_kind == "random":
            seed = stream_seed(self.engine.seed, self.state.round,
                               SERVER_SLOT, PERSONAL_INIT_TAG)
            return self.engine.layout.flatten(
                self.task.init_params(seed)).to(self.device)
        if self.init_kind == "initial":
            return self._initial_params
        return self.state.params

    def _stage_locals(self, user_ids, default: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The users' local models ``[K, P]`` and alphas ``[K]`` on the
        device, ``default`` for a user without local state."""
        local = torch.empty((len(user_ids), self.engine.layout.numel),
                            dtype=torch.float32, device=self.device)
        alphas = []
        for j, uid in enumerate(user_ids):
            lp, a = self.store.get(int(uid))
            local[j].copy_(default if lp is None else lp)
            alphas.append(a)
        return local, torch.tensor(alphas, dtype=torch.float32,
                                   device=self.device)

    def _run_personal_pass(self, sampled) -> None:
        """Train the sampled users' local models and alphas against the
        current global model, and put them in the store."""
        tic = time.time()
        batch = pack_round_batches(
            self.train_dataset, sampled, self.batch_size, self.max_steps,
            rng=self._np_rng, desired_max_samples=self.desired_max_samples)
        engine, dev, r = self.engine, self.device, self.state.round
        ids = batch.client_ids.tolist()
        local, alpha = self._stage_locals(ids, self._default_local())
        store_s = time.time() - tic
        arrays = {k: torch.from_numpy(v).to(dev)
                  for k, v in batch.arrays.items()}
        sample_mask = torch.from_numpy(batch.sample_mask).to(dev)
        client_mask = torch.from_numpy(batch.client_mask).to(dev)
        gens = ((engine.client_generators(r, ids, PERSONAL_GLOBAL_TAG),
                 engine.client_generators(r, ids, PERSONAL_LOCAL_TAG))
                if engine.random else (None, None))
        engine.local_steps += 2 * engine.hparams.num_epochs * \
            sample_mask.shape[1]
        new_local, new_alpha = personal_step(
            engine.client_update, self.state.params, local, alpha, arrays,
            sample_mask, client_mask, self.initial_lr_client * self.lr_weight,
            self.alpha0, gens)
        tac = time.time()
        new_alpha = new_alpha.cpu().tolist()
        for j, uid in enumerate(ids):
            if uid >= 0:
                self.store.put(uid, new_local[j].to("cpu", copy=True),
                               new_alpha[j])
        toc = time.time()
        self.run_stats["secsPersonalStore"].append(store_s + toc - tac)
        self.run_stats["secsPersonalPass"].append(toc - tic)

    # ------------------------------------------------------------------
    def _round_housekeeping(self, round_no: int, val_freq: int,
                            rec_freq: int, **kw) -> None:
        super()._round_housekeeping(round_no, val_freq, rec_freq, **kw)
        if round_no % val_freq == 0 and self.val_dataset is not None:
            self.personalized_eval(self.val_dataset)
        if self.store is not None:
            tic = time.time()
            self.store.save()
            self.run_stats["secsPersonalSave"].append(time.time() - tic)

    def train(self):
        # the host path's hooked ``_sample`` reads the live global model,
        # so its loop runs serial (``_pipeline_capable``); the carry's
        # rides the ring
        state = super().train()
        if self.store is not None:
            self.store.save()
        return state

    def _personal_eval_batches(self, dataset) -> List[tuple]:
        """The split's users in chunks of :attr:`eval_chunk`, each packed
        in order on one ``[S, B]`` grid and staged on the device once."""
        if self._eval_chunks is None:
            bs = int(self.config.server_config.data_config.val.get(
                "batch_size", self.batch_size))
            S = steps_for(int(max(dataset.num_samples)), bs,
                          self.desired_max_samples)
            self._eval_chunks = []
            for i in range(0, len(dataset), self.eval_chunk):
                users = list(range(i, min(i + self.eval_chunk,
                                          len(dataset))))
                batch = pack_round_batches(
                    dataset, users, bs, S, shuffle=False,
                    desired_max_samples=self.desired_max_samples)
                self._eval_chunks.append((users, {
                    k: torch.from_numpy(v).to(self.device)
                    for k, v in batch.arrays.items()},
                    torch.from_numpy(batch.sample_mask).to(self.device)))
        return self._eval_chunks

    def _carry_locals(self, seen: List[float]):
        """The carry tables' reader for the personalized eval: a chunk of
        users -> their local models ``[K, P]`` (the table row of a user
        seen, else the global model) and alphas ``[K]`` (``alpha0`` for a
        user not seen), gathered on the device; ``seen`` is the ``[N]``
        gate, read to the host."""
        ss, dev = self.state.strategy_state, self.device

        def stage(users):
            mine = [u for u in users if u < len(seen) and seen[u] > 0]
            local = self.state.params[None, :].repeat(len(users), 1)
            alpha = torch.full((len(users),), self.alpha0,
                               dtype=torch.float32, device=dev)
            if mine:
                slots = torch.tensor([users.index(u) for u in mine],
                                     device=dev)
                rows = torch.tensor(mine, device=dev)
                local.index_copy_(0, slots, ss["local"].index_select(0, rows))
                alpha.index_copy_(0, slots, ss["alpha"].index_select(0, rows))
            return local, alpha

        return stage

    def _paged_locals(self):
        """The paged carry's reader for the personalized eval
        (``personalization.py:390-425``): an eval boundary has drained the
        ring, so the pager's host store holds every user's current row;
        each user's row is read for its local model, then for its alpha,
        in the JAX eval's order, and staged on the device."""
        pager, dev = self.fleet_pager, self.device

        def stage(users):
            local = self.state.params[None, :].repeat(len(users), 1)
            alpha = torch.full((len(users),), self.alpha0,
                               dtype=torch.float32, device=dev)
            for j, u in enumerate(users):
                row = pager.user_row(u)
                if row is not None and float(row["seen"]) > 0:
                    local[j].copy_(torch.from_numpy(row["local"]))
                row = pager.user_row(u)
                if row is not None and float(row["seen"]) > 0:
                    alpha[j] = float(row["alpha"])
            return local, alpha

        return stage

    def personalized_eval(self, dataset) -> Optional[Tuple[float, float]]:
        """``(accuracy, loss)`` of the interpolated models over all of the
        split's users; a user without local state scores the global model
        in both slots.  None before any user has local state.  Under
        ``fused_carry`` the ``[N]`` ``seen`` gate is read first, and the
        tables' rows are gathered on the device."""
        if len(dataset) == 0:
            return None
        if self.store is None and self.fleet_pager is not None:
            if not self.fleet_pager.has_rows():
                return None
            stage = self._paged_locals()
        elif self.store is None:
            seen = self.state.strategy_state["seen"].cpu().tolist()
            if not any(v > 0 for v in seen):
                return None
            stage = self._carry_locals(seen)
        else:
            if not self.store.alpha:
                return None
            stage = functools.partial(self._stage_locals,
                                      default=self.state.params)
        sums = torch.zeros(3, dtype=torch.float64, device=self.device)
        for users, arrays, mask in self._personal_eval_batches(dataset):
            local, alpha = stage(users)
            sums += torch.stack(personalized_eval_sums(
                self.task, self.engine.layout, self.state.params, local,
                alpha, arrays, mask, self.logspace)).double()
        correct, total, loss = sums.cpu().tolist()
        if total == 0:
            return None
        acc, loss = correct / total, loss / total
        step = self.state.round
        self.metrics.log("Personalized val acc", acc, step=step)
        self.metrics.log("Personalized val loss", loss, step=step)
        self.history.append({"split": "personalized_val", "round": step,
                             "acc": acc, "loss": loss})
        return acc, loss
