"""Host-side utilities of the port (meters, serving metrics, log rows)."""

from .meters import AverageMeter, PercentileMeter  # noqa: F401
from .metrics import ServingMetrics  # noqa: F401
from .logger import Logger  # noqa: F401
