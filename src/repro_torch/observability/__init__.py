"""Telemetry for the port: the process-wide metrics registry."""
from .metrics import METRICS, Counter, Gauge, Histogram, MetricsRegistry  # noqa: F401
