"""Observability helpers (utils/observe.py)."""

from pcseg_tpu_torch.utils.observe import (  # noqa: F401
    MetricsLogger,
    StepTimer,
    named_scope,
    profile_trace,
)
