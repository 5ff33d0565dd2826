"""Observability: profiler traces, named stages, step timing and the
metrics log (counterpart of pcseg_tpu/utils/observe.py).

- ``profile_trace``: context manager around ``torch.profiler`` with the
  CPU and, where there is a card, CUDA activities; writes a Chrome trace
  (``trace.json``, viewable in Perfetto or ``chrome://tracing``) into the
  directory. An empty directory is a no-op, and a profiler that cannot
  start warns instead of failing the run.
- ``named_scope``: ``torch.profiler.record_function``, labelling model
  stages (voxelize / core / head / devoxelize) inside traces.
- ``StepTimer``: wall-clock EMA per step, without device syncs.
- ``MetricsLogger``: one JSONL record per epoch or step, the JAX
  package's records; TensorBoard scalars where ``torch.utils.tensorboard``
  imports, a warning otherwise.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Any, Optional

import torch

named_scope = torch.profiler.record_function

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block into ``log_dir/trace.json`` (no-op for "")."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # a profiler already running, no CUPTI, ...
        warnings.warn(f"torch.profiler unavailable: {e}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))
            except Exception as e:
                warnings.warn(f"torch.profiler trace not written: {e}")


class StepTimer:
    """Exponential-moving-average step timer (host wall clock)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else (
                (1 - self.alpha) * self.ema + self.alpha * dt)
        self._last = now

    @property
    def ms(self) -> Optional[float]:
        return None if self.ema is None else self.ema * 1e3


class MetricsLogger:
    """Append-only JSONL metrics + optional TensorBoard scalars."""

    def __init__(self, path: Optional[str] = None, tensorboard_dir: str = ""):
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception as e:
                warnings.warn(f"tensorboard writer unavailable: {e}")

    def log(self, step: int, record: dict[str, Any]) -> None:
        rec = {"step": step, "time": time.time(), **record}
        if self._fh:
            self._fh.write(json.dumps(rec, default=float) + "\n")
        if self._tb:
            for k, v in record.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        if self._tb:
            self._tb.close()
