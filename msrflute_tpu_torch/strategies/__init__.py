from ..config import NOT_PORTED
from .base import BaseStrategy, filter_weight  # noqa: F401
from .fedavg import FedAvg


def select_strategy(name: str) -> type:
    if str(name).lower() in ("fedavg", "fedprox"):
        return FedAvg
    raise NotImplementedError(f"strategy {name!r} is {NOT_PORTED}")
