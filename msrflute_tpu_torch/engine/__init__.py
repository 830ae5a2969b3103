from .round import RoundEngine, ServerState  # noqa: F401
from .server import OptimizationServer, select_server  # noqa: F401
