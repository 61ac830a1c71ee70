"""Perf tracing: slow-execution logging + torch profiler hook.

Reference: src/util/LogSlowExecution.{h,cpp} (warn when a scope exceeds a
threshold) and the Perf log partition.  Timing data itself lands in the
util.metrics registry (one timer surface); this module adds the
slow-threshold warning and the device profiler wrapper.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

from . import logging as slog
from .metrics import registry

log = slog.get("Perf")

DEFAULT_SLOW_THRESHOLD = 1.0  # seconds (reference: LogSlowExecution 1s)

# Per-name slow-threshold overrides: hot scopes (ledger close, ~ms) and
# slow-by-nature scopes (checkpoint download, tens of seconds) need
# different budgets than the 1s default.
_slow_thresholds: Dict[str, float] = {}

_USE_DEFAULT = object()  # sentinel: caller passed nothing (None = disabled)


def set_slow_threshold(name: str, threshold: Optional[float]) -> None:
    """Set (or with None, clear back to default) the slow budget for one
    scope name.  Applies to scoped_timer calls that don't pass an explicit
    threshold."""
    if threshold is None:
        _slow_thresholds.pop(name, None)
    else:
        _slow_thresholds[name] = threshold


def slow_threshold_for(name: str) -> float:
    return _slow_thresholds.get(name, DEFAULT_SLOW_THRESHOLD)


@contextlib.contextmanager
def scoped_timer(name: str, slow_threshold=_USE_DEFAULT):
    """Time a scope into the metrics registry's timer of the same name
    (ONE timer surface — util.metrics) and warn when the scope ran slow
    (reference: LogSlowExecution dtor + medida Timer::Update).

    slow_threshold: seconds; omit to use the per-name override (or the 1s
    default), pass None to disable the warning for this call."""
    if slow_threshold is _USE_DEFAULT:
        slow_threshold = slow_threshold_for(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        registry().timer(name).update(dt)
        if slow_threshold is not None and dt > slow_threshold:
            log.warning("'%s' took %.3fs (threshold %.3fs)",
                        name, dt, slow_threshold)


@contextlib.contextmanager
def torch_profile(log_dir: str):
    """Device-level profiler trace around a scope (the card's analog of
    the reference's perf instrumentation): a torch.profiler trace of the
    CPU and, where CUDA is available, the card, written to `log_dir` as a
    TensorBoard trace; no-op if the profiler is unavailable."""
    try:
        import torch
        from torch import profiler
    except ImportError:
        yield
        return
    activities = [profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(profiler.ProfilerActivity.CUDA)
    with profiler.profile(
            activities=activities,
            on_trace_ready=profiler.tensorboard_trace_handler(log_dir)):
        yield
