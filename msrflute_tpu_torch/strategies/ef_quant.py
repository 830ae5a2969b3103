"""Error-feedback quantized aggregation (EF-SGD) — the port's counterpart
of ``msrflute_tpu/strategies/ef_quant.py``, on its host path and in its
carry mode (``server_config.fused_carry``, ``ef_quant.py:304-380``).

Each client keeps the residual of its last compression and folds it into
the next payload before compressing:

    corrected_k = pg_k + e_k
    q_k         = Q(corrected_k)          (sent; aggregated as usual)
    e_k'        = corrected_k - q_k       (kept for the client)

``Q`` is the quantization of :mod:`..ops.quantization` over the whole
flat row as one leaf (its min, max and ``quant_thresh`` quantile of
``|.|``), ``2 ** quant_bits`` levels: kernel B3 with offsets ``(0, P)``
and one ``lo`` / ``hi`` / threshold a client row.  The threshold anneals
by ``quant_anneal`` before each round's use.

Two residual stores, with SCAFFOLD's discipline
(:mod:`.scaffold`): :class:`ResidualStore` (``ef_quant.py:55-172``,
numpy rows written through to ``model_dir/ef_residuals``) and
:class:`DeviceResidualTable` (``ef_quant.py:174-288``,
``server_config.ef_device_residuals``: the ``[N, P]`` table on the device,
flushed to the store every ``ef_flush_freq`` checkpoints).

In carry mode ``res [N, P]`` rides ``strategy_state``: the round's client
step corrects each payload with its client's row, quantizes the ``[K,
P]`` stack (kernel B3, one leaf a row) at the round's annealed threshold
(the server's ``quant_threshold`` operand, as on DGA's path) and returns
``corrected - q`` gated on ``valid * live * (w > 0)``;
:meth:`EFQuant.apply_carry` scatters the rows into a new table.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.quantization import quantize_pytree
from .base import gather_rows, scatter_rows
from .fedavg import FedAvg
from .scaffold import _gather, _np_save, _persisted_ids, _scatter, _valid_rows


class ResidualStore:
    """Durable per-client residual rows (flat float32), unseen clients at
    zero, an LRU of ``_MAX_RESIDENT`` rows in memory.  Without a store a
    row evicted from memory is lost (that client quantizes without memory
    once; ``dropped_rows`` counts them)."""

    _MAX_RESIDENT = 4096

    def __init__(self, n_params: int, store_dir: Optional[str] = None,
                 resume: bool = False):
        self.n_params = int(n_params)
        self.store_dir = store_dir
        self._rows: Dict[int, np.ndarray] = {}
        self.dropped_rows = 0
        if store_dir is not None:
            os.makedirs(store_dir, exist_ok=True)
            if not resume:
                self._delete_files()

    def _path(self, key) -> str:
        return os.path.join(self.store_dir, f"residual_{key}.npy")

    def _delete_files(self) -> None:
        for name in os.listdir(self.store_dir):
            if name.startswith("residual_"):
                os.remove(os.path.join(self.store_dir, name))

    def _evict(self) -> None:
        while len(self._rows) > self._MAX_RESIDENT:
            self._rows.pop(next(iter(self._rows)))
            if self.store_dir is None:
                self.dropped_rows += 1

    def _touch(self, cid: int, row: np.ndarray) -> None:
        self._rows.pop(cid, None)
        self._rows[cid] = row

    def rows(self, ids) -> np.ndarray:
        """``[K, P]`` residuals; zeros for unseen and padding ids."""
        out = np.zeros((len(ids), self.n_params), np.float32)
        for i, cid in enumerate(np.asarray(ids)):
            cid = int(cid)
            if cid < 0:
                continue
            row = self._rows.get(cid)
            if row is None and self.store_dir is not None and \
                    os.path.exists(self._path(cid)):
                row = np.load(self._path(cid)).astype(np.float32)
            if row is not None:
                self._touch(cid, row)
                out[i] = row
        self._evict()
        return out

    def update(self, ids, new_rows: np.ndarray, keep_mask) -> None:
        for i, cid in enumerate(np.asarray(ids)):
            cid = int(cid)
            if cid < 0 or not keep_mask[i]:
                continue
            row = np.asarray(new_rows[i], np.float32)
            self._touch(cid, row)
            if self.store_dir is not None:
                _np_save(self._path(cid), row)
        self._evict()

    def set_round(self, round_no: int) -> None:
        """The round the files belong to; -1 while they change."""
        if self.store_dir is not None:
            _np_save(self._path("round"), np.asarray([round_no], np.int64))

    def round(self) -> Optional[int]:
        if self.store_dir is None or not os.path.exists(self._path("round")):
            return None
        return int(np.load(self._path("round"))[0])

    def reset(self) -> None:
        self._rows.clear()
        if self.store_dir is not None:
            self._delete_files()

    def persisted_client_ids(self):
        return _persisted_ids(self.store_dir, "residual_", self._rows)


class DeviceResidualTable:
    """The ``[N, P]`` residual table on the device; the wrapped
    :class:`ResidualStore` stays the format of record (``flush``)."""

    def __init__(self, store: ResidualStore, n_clients: int,
                 device: torch.device):
        self.store = store
        self.n_clients = int(n_clients)
        self.table = torch.zeros((self.n_clients, store.n_params),
                                 dtype=torch.float32, device=device)
        warm = [cid for cid in store.persisted_client_ids()
                if 0 <= cid < self.n_clients]
        for lo in range(0, len(warm), 512):
            chunk = warm[lo:lo + 512]
            rows = torch.from_numpy(store.rows(np.asarray(chunk, np.int64)))
            self.table[torch.as_tensor(chunk, device=device)] = \
                rows.to(device)
        self._dirty = set()

    def rows(self, client_ids) -> torch.Tensor:
        return _gather(self.table, client_ids)

    def update(self, client_ids, new_res: torch.Tensor,
               ws: torch.Tensor) -> None:
        """Scatter the participating clients' (id >= 0, weight > 0) new
        residuals."""
        valid = _valid_rows(client_ids, self.table.device, ws)
        _scatter(self.table, client_ids, new_res, valid)
        self._dirty.update(int(c) for c, v in zip(
            np.asarray(client_ids), valid.cpu().numpy()) if v)

    def flush(self) -> None:
        if self._dirty:
            ids = sorted(self._dirty)
            rows = self.table[torch.as_tensor(ids, device=self.table.device)
                              ].cpu().numpy()
            self.store.update(np.asarray(ids), rows, np.ones(len(ids), bool))
            self._dirty.clear()

    def reset(self) -> None:
        self.table.zero_()
        self._dirty.clear()
        self.store.reset()


class EFQuant(FedAvg):
    """FedAvg's weights; the server's EF round quantizes with the
    residuals.  ``quant_bits`` in [1, 16] and ``quant_thresh`` in [0, 1)
    are checked at config time."""

    host_rounds = True
    supports_rl = False
    carry_tables = ("res",)

    def __init__(self, config):
        super().__init__(config)
        if config.server_config.get("fused_carry", False):
            self.host_rounds = False
            self.device_carry = True
        cc = config.client_config
        self.quant_bits = int(cc.get("quant_bits", 4))
        self.quant_thresh = float(cc.get("quant_thresh", 0.0))
        self.quant_anneal = float(cc.get("quant_anneal", 1.0) or 1.0)
        self.quant_approx = bool(cc.get("quant_approx", False))
        self._one_leaf: Dict[tuple, torch.Tensor] = {}

    # ---- carry mode (server_config.fused_carry) ----------------------
    def init_state(self, params):
        if not self.device_carry:
            return super().init_state(params)
        return {"res": torch.zeros((self._carry_table_rows(),
                                    params.shape[-1]), dtype=torch.float32,
                                   device=params.device)}

    def client_step_carry(self, client_update, global_flat, arrays,
                          sample_mask, client_lr, gens=None, *, client_ids,
                          live_mask, strategy_state, quant_threshold=None,
                          **kw):
        # the payload after the client step's own transforms, which the
        # host EF round also compresses; no quantization there
        parts, tl, ns, stats = self.client_step(
            client_update, global_flat, arrays, sample_mask, client_lr, gens,
            quant_threshold=None, **kw)
        pg, w = parts["default"]
        res = gather_rows(strategy_state["res"], client_ids)
        q, new_res = self.ef_step(pg, res, quant_threshold)
        keep = ((client_ids >= 0).to(torch.float32) * live_mask
                * (w > 0).to(torch.float32))
        row = torch.where(keep[:, None] > 0, new_res, res)
        parts = dict(parts)
        parts["default"] = (q, w)
        return parts, tl, ns, stats, {"row": row, "keep": keep}

    def apply_carry(self, state, client_ids, src, carry):
        return {"res": scatter_rows(state["res"], client_ids, src,
                                    carry["row"])}

    def next_threshold(self) -> float:
        """The round's threshold: annealed before its use."""
        self.quant_thresh *= self.quant_anneal
        return self.quant_thresh

    def ef_step(self, pgs: torch.Tensor, residuals: torch.Tensor,
                thresh: Optional[float] = None):
        """``(q, corrected - q)`` for ``corrected = pgs + residuals``, each
        ``[K, P]`` row quantized as one leaf (one launch of kernel B3)."""
        thresh = self.quant_thresh if thresh is None else thresh
        corrected = pgs + residuals
        P = corrected.shape[1]
        key = (P, corrected.device)
        if key not in self._one_leaf:
            self._one_leaf[key] = torch.tensor([0, P], dtype=torch.int64,
                                               device=corrected.device)
        q = quantize_pytree(corrected, [0, P], float(thresh),
                            self.quant_bits, approx=self.quant_approx,
                            offsets_dev=self._one_leaf[key])
        return q, corrected - q
