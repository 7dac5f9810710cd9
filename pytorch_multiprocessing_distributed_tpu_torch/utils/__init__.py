"""Utilities of the port: meters, metrics, log rows and plots."""

from .meters import AverageMeter, PercentileMeter, throughput  # noqa: F401
from .metrics import (ServingMetrics, accuracy,  # noqa: F401
                      correct_count, topk_accuracy)
from .plotting import draw_plot, draw_timeline  # noqa: F401
from .logger import Logger  # noqa: F401
