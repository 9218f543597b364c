"""Observability (port of ``repro.obs``): only ``metrics.Histogram``, the
quantile substrate of the engine's result, is ported so far."""

from .metrics import Histogram  # noqa: F401
