from .writers import MetricLogger

__all__ = ["MetricLogger"]
