from ..config import NOT_PORTED
from .base import BaseStrategy, filter_weight  # noqa: F401
from .dga import DGA
from .fedavg import FedAvg
from .fedlabels import FedLabels


def select_strategy(name: str) -> type:
    key = str(name).lower()
    if key == "dga":
        return DGA
    if key in ("fedavg", "fedprox"):
        return FedAvg
    if key == "fedlabels":
        return FedLabels
    raise NotImplementedError(f"strategy {name!r} is {NOT_PORTED}")
