"""q-FFL fair aggregation (arXiv:1905.10497) — the port's counterpart of
``msrflute_tpu/strategies/qffl.py:52-85``.

Client weight ``w_k = n_k * (mean_loss_k + 1e-10) ** q``
(``server_config.qffl_q``), where ``n_k`` goes through FedAvg's
:func:`filter_weight` cap and ``mean_loss_k`` is the client update's
``stats["mean_sample_loss"]``: the *sample-weighted* mean training loss
(each batch's masked mean loss times its real rows, over the client's rows
and epochs), which does not depend on how the samples fell into batches.
The ``loss ** q`` factor multiplies outside the cap (it is the strategy's
mechanism); NaN and Inf still zero a weight, and a guard rail at 1e9
keeps the weight sum finite.  ``q = 0`` is FedAvg weight for weight.  DP
is refused at config time (:func:`..config.check_strategy`), as the JAX
constructor refuses it.
"""

from __future__ import annotations

import torch

from .base import filter_weight
from .fedavg import FedAvg

#: guard rail far above any real capped ``n * loss ** q``, not a shaping cap
QFFL_MAX_WEIGHT = 1e9


class QFFL(FedAvg):

    def __init__(self, config):
        super().__init__(config)
        self.q = float(config.server_config.get("qffl_q", 1.0))

    def client_weight(self, *, num_samples, train_loss, stats):
        weight = filter_weight(num_samples) * torch.pow(
            stats["mean_sample_loss"] + 1e-10, self.q)
        weight = torch.nan_to_num(weight, nan=0.0, posinf=0.0, neginf=0.0)
        return torch.clamp(weight, 0.0, QFFL_MAX_WEIGHT)
