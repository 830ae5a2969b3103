"""FedAvg / FedProx aggregation — the port's counterpart of
``msrflute_tpu/strategies/fedavg.py``: each client weighs its
``num_samples`` (through :func:`filter_weight`), and the aggregate is the
weighted sum of pseudo-gradients over the weight sum.  FedProx shares it;
its proximal term lives in the client update.  DP adaptive clipping is not
ported yet."""

from __future__ import annotations

from .base import BaseStrategy, filter_weight


class FedAvg(BaseStrategy):
    def client_weight(self, *, num_samples, train_loss, stats):
        return filter_weight(num_samples)
