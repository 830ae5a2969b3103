from ..config import NOT_PORTED
from .base import BaseStrategy, filter_weight  # noqa: F401
from .dga import DGA
from .ef_quant import EFQuant
from .fedac import FedAC
from .fedavg import FedAvg
from .fedbuff import FedBuff
from .fedlabels import FedLabels
from .qffl import QFFL
from .scaffold import Scaffold
from .secure_agg import SecureAgg

#: the JAX package's names and aliases (``msrflute_tpu/strategies/
#: __init__.py:15-42``) of the ported strategies
STRATEGIES = {"dga": DGA, "fedavg": FedAvg, "fedprox": FedAvg,
              "fedlabels": FedLabels, "qffl": QFFL, "fedac": FedAC,
              "fedbuff": FedBuff, "scaffold": Scaffold,
              "ef_quant": EFQuant, "efquant": EFQuant,
              "secure_agg": SecureAgg, "secagg": SecureAgg,
              "secureagg": SecureAgg}


def select_strategy(name: str) -> type:
    key = str(name).lower()
    if key not in STRATEGIES:
        raise NotImplementedError(f"strategy {name!r} is {NOT_PORTED}")
    return STRATEGIES[key]
