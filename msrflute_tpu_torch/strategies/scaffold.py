"""SCAFFOLD, stochastic controlled averaging (arXiv:1910.06378), option II
— the port's counterpart of ``msrflute_tpu/strategies/scaffold.py``, on
its host path (``host_rounds``) and in its carry mode
(``server_config.fused_carry``, ``scaffold.py:363-520``).

Per sampled client:

    local step:   y <- y - lr * (grad f_i(y) + c - c_i)
    new control:  c_i+ = c_i - c + (x - y_T) / (K_i * lr)
    server:       x <- x - server_lr * weighted_avg(x - y_T)
    c <- c + sum_i (c_i+ - c_i) / N_total

The offset ``c - c_i`` is the client update's ``grad_offset`` (it enters
kernel B1 with the gradient); the server's host round
(``engine/server.py::_run_scaffold_round``) gathers the offsets, runs the
payload program, takes the server step and updates the controls.

Two stores hold the controls:

- :class:`ControlStore` (``scaffold.py:54-180``): ``c`` and the ``c_i``
  as numpy rows, written through to ``.npy`` files under
  ``model_dir/scaffold`` (tmp + rename), an LRU cache of
  ``CACHE_LIMIT`` rows in memory, and a round marker pairing the files
  with the model checkpoint;
- :class:`DeviceControlTable` (``scaffold.py:182-330``,
  ``server_config.scaffold_device_controls``): the whole ``[N, P]``
  float32 table on the device, offsets gathered and option II scattered
  there, dirty rows written through to the :class:`ControlStore` at
  checkpoint time (``scaffold_flush_freq``).

Padded client slots (id < 0) read a zero offset and write no row: the
JAX package scatters them out of range with ``mode="drop"``; in torch a
-1 would wrap to row N - 1, so the rows are masked before
``index_copy_``.

In carry mode ``c [P]`` and ``ci [N, P]`` ride ``strategy_state``: the
round gathers the cohort's rows, feeds ``c - c_i`` to every local step,
counts each client's real steps from its sample mask (a straggler's
truncated mask included) and returns ``c_i+`` gated on ``valid * live *
(w > 0)``; :meth:`Scaffold.apply_carry` adds the kept rows' change over
``carry_clients`` to ``c`` and scatters them into a new table
(:func:`.base.scatter_rows`), with no host read, so the round rides the
dispatch ring.  ``|c|`` crosses in the round's packed stats.  Durability
rides the model checkpoint: no store, no files.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .base import gather_rows, scatter_rows
from .fedavg import FedAvg


def _np_save(path: str, value: np.ndarray) -> None:
    tmp = path + ".tmp.npy"   # the .npy suffix stops np.save adding one
    np.save(tmp, value)
    os.replace(tmp, path)


def _persisted_ids(store_dir: Optional[str], prefix: str, cached) -> list:
    """Client ids with a ``<prefix><id>.npy`` file (the cache's keys
    without a store)."""
    if store_dir is None:
        return sorted(cached)
    ids = []
    for name in os.listdir(store_dir):
        if name.startswith(prefix) and name.endswith(".npy"):
            key = name[len(prefix):-len(".npy")]
            if key.lstrip("-").isdigit():
                ids.append(int(key))
    return sorted(ids)


class ControlStore:
    """Server ``c`` and per-client ``c_i``, flat float32 rows in the
    layout's order.  Unseen clients start at ``c_i = 0``.  With
    ``store_dir`` every write persists; a fresh run (``resume`` false)
    deletes a previous run's files."""

    #: with a disk store, at most this many ``c_i`` stay in memory (LRU)
    CACHE_LIMIT = 1024

    def __init__(self, n_params: int, store_dir: Optional[str] = None,
                 resume: bool = False):
        self.n_params = int(n_params)
        self.store_dir = store_dir
        self._ci: Dict[int, np.ndarray] = {}
        self.c = np.zeros((self.n_params,), np.float32)
        if store_dir is not None:
            os.makedirs(store_dir, exist_ok=True)
            if resume:
                if os.path.exists(self._path("server")):
                    self.c = np.load(self._path("server")).astype(np.float32)
            else:
                self._delete_files()

    def _path(self, key) -> str:
        return os.path.join(self.store_dir, f"control_{key}.npy")

    def _delete_files(self) -> None:
        for name in os.listdir(self.store_dir):
            if name.startswith("control_"):
                os.remove(os.path.join(self.store_dir, name))

    def _save(self, key, vec: np.ndarray) -> None:
        if self.store_dir is not None:
            _np_save(self._path(key), vec)

    def _cache(self, cid: int, vec: np.ndarray) -> None:
        self._ci.pop(cid, None)   # hot clients move to the tail
        self._ci[cid] = vec
        if self.store_dir is not None:
            while len(self._ci) > self.CACHE_LIMIT:
                self._ci.pop(next(iter(self._ci)))

    def ci(self, client_id: int) -> np.ndarray:
        cid = int(client_id)
        if cid in self._ci:
            vec = self._ci.pop(cid)
            self._ci[cid] = vec
            return vec
        if self.store_dir is not None and os.path.exists(self._path(cid)):
            vec = np.load(self._path(cid)).astype(np.float32)
            self._cache(cid, vec)
            return vec
        return np.zeros((self.n_params,), np.float32)

    def set_ci(self, client_id: int, vec: np.ndarray) -> None:
        cid = int(client_id)
        self._cache(cid, vec.astype(np.float32))
        self._save(cid, self._ci[cid])

    def set_c(self, vec: np.ndarray) -> None:
        self.c = vec.astype(np.float32)
        self._save("server", self.c)

    def reset(self) -> None:
        """Zero every control and delete the files (after a fall-back to
        the best model, or a round marker that disagrees with the
        checkpoint)."""
        self._ci.clear()
        self.c = np.zeros((self.n_params,), np.float32)
        if self.store_dir is not None:
            self._delete_files()

    def set_round(self, round_no: int) -> None:
        """The round the files belong to; -1 while they change."""
        self._save("round", np.asarray([round_no], np.int64))

    def round(self) -> Optional[int]:
        if self.store_dir is None or not os.path.exists(self._path("round")):
            return None
        return int(np.load(self._path("round"))[0])

    def offsets(self, client_ids) -> np.ndarray:
        """``[K, P]`` rows of ``c - c_i``, zero for padding (id < 0)."""
        out = np.zeros((len(client_ids), self.n_params), np.float32)
        for row, cid in enumerate(client_ids):
            if int(cid) >= 0:
                out[row] = self.c - self.ci(int(cid))
        return out

    def persisted_client_ids(self):
        return _persisted_ids(self.store_dir, "control_", self._ci)


def _valid_rows(client_ids, device, weights=None) -> torch.Tensor:
    """``[K]`` bools: real clients (id >= 0), and with ``weights``, those
    with a positive aggregation weight."""
    ids = torch.as_tensor(np.asarray(client_ids), dtype=torch.int64,
                          device=device)
    valid = ids >= 0
    if weights is not None:
        valid = valid & (weights > 0)
    return valid


def _gather(table: torch.Tensor, client_ids) -> torch.Tensor:
    """``table``'s rows of the host's ``client_ids``, zero rows for padding
    ids."""
    return gather_rows(table, torch.as_tensor(
        np.asarray(client_ids), dtype=torch.int64, device=table.device))


def _scatter(table: torch.Tensor, client_ids, rows: torch.Tensor,
             valid: torch.Tensor) -> None:
    """``table[id] = row`` for the ``valid`` rows only (a padded -1 would
    wrap to the last row; the JAX package drops it out of range)."""
    ids = torch.as_tensor(np.asarray(client_ids), dtype=torch.int64,
                          device=table.device)
    table.index_copy_(0, ids[valid], rows[valid])


class DeviceControlTable:
    """The ``[N, P]`` control table and ``c`` on the device; the wrapped
    :class:`ControlStore` stays the format of record (``flush``).  Costs
    ``4 N P`` bytes of device memory."""

    def __init__(self, store: ControlStore, n_clients: int,
                 device: torch.device):
        self.store = store
        self.n_clients = int(n_clients)
        self.table = torch.zeros((self.n_clients, store.n_params),
                                 dtype=torch.float32, device=device)
        warm = [cid for cid in store.persisted_client_ids()
                if 0 <= cid < self.n_clients]
        for lo in range(0, len(warm), 512):
            chunk = warm[lo:lo + 512]
            rows = torch.from_numpy(np.stack([store.ci(c) for c in chunk]))
            self.table[torch.as_tensor(chunk, device=device)] = \
                rows.to(device)
        self.c = torch.from_numpy(store.c.copy()).to(device)
        self._dirty = set()

    def offsets(self, client_ids) -> torch.Tensor:
        """``[K, P]`` ``c - c_i`` on the device, zero rows for padding."""
        valid = _valid_rows(client_ids, self.table.device)
        ci = _gather(self.table, client_ids)
        return (self.c[None, :] - ci) * valid.to(ci.dtype)[:, None]

    def update(self, client_ids, steps, pgs: torch.Tensor,
               ws: torch.Tensor, client_lr: float,
               total_clients: int) -> torch.Tensor:
        """Option II on the device for the participating clients (id >= 0
        and weight > 0); returns ``|c|`` as a device scalar."""
        dev = self.table.device
        valid = _valid_rows(client_ids, dev, ws)
        k_i = torch.clamp(torch.as_tensor(np.asarray(steps), dtype=torch.
                                          float32, device=dev), min=1.0)
        ci_old = _gather(self.table, client_ids)
        ci_new = ci_old - self.c[None, :] + pgs / (
            k_i * torch.tensor(client_lr, dtype=torch.float32))[:, None]
        delta = torch.where(valid[:, None], ci_new - ci_old, 0.0)
        inv_total = torch.tensor(1.0 / max(float(total_clients), 1.0),
                                 dtype=torch.float32)
        self.c = self.c + delta.sum(dim=0) * inv_total
        _scatter(self.table, client_ids, ci_new, valid)
        self._dirty.update(int(c) for c, v in zip(
            np.asarray(client_ids), valid.cpu().numpy()) if v)
        return torch.linalg.vector_norm(self.c)

    def flush(self) -> None:
        """Write the dirty rows and ``c`` through to the store."""
        if self._dirty:
            ids = sorted(self._dirty)
            rows = self.table[torch.as_tensor(ids, device=self.table.device)
                              ].cpu().numpy()
            for cid, row in zip(ids, rows):
                self.store.set_ci(cid, row)
            self._dirty.clear()
        self.store.set_c(self.c.cpu().numpy())

    def reset(self) -> None:
        self.table.zero_()
        self.c = torch.zeros_like(self.c)
        self._dirty.clear()
        self.store.reset()


class Scaffold(FedAvg):
    """FedAvg's sample-count weights; the server's scaffold round runs the
    controls.  The compositions that break the option-II identity (DP
    noise, momentum and other client optimizers, FedProx, clipping, layer
    freezing, quantization) are refused at config time
    (:func:`..config.check_strategy`)."""

    host_rounds = True
    supports_rl = False
    #: the paged table; ``c`` stays resident
    carry_tables = ("ci",)

    def __init__(self, config):
        super().__init__(config)
        sc, cc = config.server_config, config.client_config
        if sc.get("fused_carry", False):
            # instance flags shadow the class's: the engine sees a carry
            # strategy, the server no host rounds
            self.host_rounds = False
            self.device_carry = True
        self._epochs = int(cc.get("num_epochs", 1) or 1)

    # ---- carry mode (server_config.fused_carry) ----------------------
    def init_state(self, params):
        if not self.device_carry:
            return super().init_state(params)
        P = params.shape[-1]
        return {"c": torch.zeros(P, dtype=torch.float32,
                                 device=params.device),
                "ci": torch.zeros((self._carry_table_rows(), P),
                                  dtype=torch.float32, device=params.device)}

    def client_step_carry(self, client_update, global_flat, arrays,
                          sample_mask, client_lr, gens=None, *, client_ids,
                          live_mask, strategy_state, **kw):
        c = strategy_state["c"]
        valid = (client_ids >= 0).to(torch.float32)
        ci = gather_rows(strategy_state["ci"], client_ids)
        # c - c_i, zero rows for padding so their masked steps stay no-ops
        offset = (c[None, :] - ci) * valid[:, None]
        parts, tl, ns, stats = self.client_step(
            client_update, global_flat, arrays, sample_mask, client_lr, gens,
            grad_offset=offset, **kw)
        pg, w = parts["default"]
        # real local steps K_i: steps with a real sample, per epoch
        steps = torch.sum((torch.sum(sample_mask, dim=-1) > 0).to(
            torch.float32), dim=-1) * float(self._epochs)
        k_i = torch.clamp(steps, min=1.0)
        lr = torch.tensor(client_lr, dtype=torch.float32)
        ci_new = ci - c[None, :] + pg / (k_i * lr)[:, None]
        # privacy-dropped and chaos-dropped clients leave their row alone
        keep = valid * live_mask * (w > 0).to(torch.float32)
        row = torch.where(keep[:, None] > 0, ci_new, ci)
        return parts, tl, ns, stats, {"row": row, "old": ci, "keep": keep}

    def apply_carry(self, state, client_ids, src, carry):
        keep = carry["keep"] > 0
        delta = torch.where(keep[:, None], carry["row"] - carry["old"], 0.0)
        c = state["c"] + delta.sum(dim=0) / max(float(self.carry_clients),
                                                1.0)
        if self.devbus is not None:
            # |c| on the bus (``strategies/scaffold.py:530-534``)
            self.devbus.publish("scaffold_c_norm",
                                torch.linalg.vector_norm(c))
        return {"c": c, "ci": scatter_rows(state["ci"], client_ids, src,
                                           carry["row"])}

    def carry_stats(self, state):
        """``|c|``, published in the round's packed stats."""
        return {"scaffold_c_norm": torch.linalg.vector_norm(state["c"])}

    def update_controls(self, store: ControlStore, client_ids,
                        steps_per_client, pgs_flat: np.ndarray,
                        client_lr: float, total_clients: int,
                        weights=None) -> None:
        """Option II on the host store (``scaffold.py:537``): clients with
        id < 0 or a zero aggregation weight write nothing."""
        delta_sum = np.zeros_like(store.c)
        for row, cid in enumerate(client_ids):
            cid = int(cid)
            if cid < 0:
                continue
            if weights is not None and float(weights[row]) <= 0.0:
                continue
            k_i = max(float(steps_per_client[row]), 1.0)
            ci_old = store.ci(cid)
            ci_new = ci_old - store.c + pgs_flat[row] / (k_i * client_lr)
            delta_sum += ci_new - ci_old
            store.set_ci(cid, ci_new)
        store.set_c(store.c + delta_sum / max(float(total_clients), 1.0))
