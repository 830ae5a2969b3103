from .base import BaseTask, Metric  # noqa: F401
from .registry import make_task  # noqa: F401
