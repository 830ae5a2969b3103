from .round import RoundEngine, ServerState  # noqa: F401
from .server import OptimizationServer  # noqa: F401
