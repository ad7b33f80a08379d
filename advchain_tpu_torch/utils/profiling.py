"""Tracing / profiling / numeric-sanity helpers (port of
advchain_tpu/utils/profiling.py):

  * ``trace(name)`` — a ``torch.profiler.record_function`` region that
    shows up in traces captured with ``start_trace`` / ``stop_trace``
    (one ``torch.profiler.profile``, written as a Chrome trace under the
    log directory), or under any other torch profiler; with none
    recording, a shared no-op that costs one flag check.  The train step
    records its ``advchain.*`` spans through it;
  * ``COUNTS`` / ``TRACED_COUNTS`` / ``count`` / ``reset_counts`` — the
    program's counters (``host_syncs``: each place the step makes the host
    wait for a CUDA device), and ``to_device`` / ``host_value``, the
    helpers that count those waits (defined in ``advchain_tpu_torch._trace``,
    which every layer imports);
  * ``Timer`` / ``benchmark`` — wall timers that synchronise the CUDA
    devices of the tensors they are given;
  * ``checked`` — run a function under a dispatch mode that raises on the
    first op producing a NaN or an Inf (the JAX package's checkify
    ``float_checks``; the reference's only numeric sanitizer is a NaN guard
    on the adversarial loss, adv_compose_solver.py:345-346).  Every op then
    synchronises with the host: a debugging aid, not for timed paths.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from advchain_tpu_torch._trace import (COUNTS, TRACED_COUNTS, count,
                                      host_value, reset_counts, to_device,
                                      trace)

__all__ = ["trace", "COUNTS", "TRACED_COUNTS", "count", "reset_counts",
           "to_device", "host_value", "start_trace", "stop_trace", "Timer",
           "benchmark", "checked"]

_PROFILE = None  # (profiler, log_dir) while a trace runs


def start_trace(log_dir: str):
    """Start profiling the host and, where present, the CUDA devices."""
    global _PROFILE
    if _PROFILE is not None:
        raise RuntimeError("a trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _PROFILE = (prof, log_dir)


def stop_trace() -> str:
    """Stop the trace and write it under ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``); returns the file's path."""
    global _PROFILE
    if _PROFILE is None:
        raise RuntimeError("no trace is running")
    (prof, log_dir), _PROFILE = _PROFILE, None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def _leaves(values):
    if isinstance(values, dict):
        values = list(values.values())
    if isinstance(values, (list, tuple)):
        for v in values:
            yield from _leaves(v)
    else:
        yield values


def _sync(values):
    """Wait for the CUDA devices of every tensor in ``values``."""
    for dev in {v.device for v in _leaves(values)
                if isinstance(v, torch.Tensor) and v.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Wall timer that synchronizes device work.

    >>> with Timer() as t:
    ...     out = step(x)
    ...     t.sync(out)
    >>> t.ms
    """

    def __enter__(self):
        self._t0 = time.perf_counter()
        self.ms = None
        return self

    def sync(self, *values):
        _sync(values)

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self._t0) * 1000.0
        return False


def benchmark(fn: Callable, *args, warmup: int = 1, reps: int = 10,
              **kwargs) -> dict:
    """Time ``fn(*args, **kwargs)`` after ``warmup`` calls, each call
    synchronised on its outputs' devices; returns ms statistics."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return {"min_ms": times[0], "median_ms": times[len(times) // 2],
            "mean_ms": sum(times) / len(times), "reps": reps}


# ops whose outputs are uninitialised memory, not a computed value
_UNINITIALISED = frozenset({"empty", "empty_like", "empty_strided",
                            "empty_permuted", "new_empty",
                            "new_empty_strided", "resize_"})


class _FiniteCheck(TorchDispatchMode):
    """Raise on the first op whose floating output holds a NaN or Inf."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALISED:
            for t in _leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and t.numel() and not bool(torch.isfinite(t).all())):
                    raise FloatingPointError(
                        f"{func} produced a NaN or an Inf")
        return out


def checked(fn: Callable, jit: bool = True):
    """Wrap ``fn`` so that it RAISES ``FloatingPointError`` at the first op
    that produces a NaN or an Inf, instead of propagating them.  ``jit`` is
    accepted so the API matches the JAX package's, and ignored.

    >>> safe_step = checked(train_step)
    >>> out = safe_step(state, batch)   # raises FloatingPointError on NaN
    """
    del jit

    def wrapper(*args, **kwargs):
        with _FiniteCheck():
            return fn(*args, **kwargs)

    return wrapper
