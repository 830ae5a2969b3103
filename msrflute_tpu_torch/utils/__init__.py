from .logging import MetricsLog, init_logging, print_rank  # noqa: F401
