from .rl import QNet, RLAggregator  # noqa: F401
