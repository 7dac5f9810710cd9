"""Host-side utilities of the port (meters, serving metrics)."""

from .meters import AverageMeter, PercentileMeter  # noqa: F401
from .metrics import ServingMetrics  # noqa: F401
