"""The program's spans and counters, importable from every layer of the
package because it imports nothing of it; ``utils.profiling`` exports
them under the same names.

``trace(name)`` is a ``torch.profiler.record_function`` region while a
torch profiler records, and one shared no-op context manager otherwise:
with no profiler running a span costs one flag check.  The spans are
profiler events, so they lie on the clock of the device trace recorded
with them.  The train step's spans are named ``advchain.*``
(``parallel/train.py``, ``augmentor/compose.py``, ``models/wrapper.py``).

``COUNTS`` tallies named events (:func:`count`, :func:`reset_counts`, as
``ops.collectives.COUNTS``); ``TRACED_COUNTS`` tallies those of them made
while a torch profiler recorded, so a trace's reader can set them against
the trace.  ``host_syncs`` counts each place where the program makes the
host wait for a CUDA device: a device value read on the host
(:func:`host_value`) or a pageable host array copied onto the device,
which PyTorch makes blocking (:func:`to_device`).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["trace", "COUNTS", "TRACED_COUNTS", "count", "reset_counts",
           "to_device", "host_value"]

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled

COUNTS: dict = {}
TRACED_COUNTS: dict = {}


def trace(name: str):
    """Named region for profiler timelines; a shared no-op while no torch
    profiler records."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    COUNTS[name] = COUNTS.get(name, 0) + n
    if _recording():
        TRACED_COUNTS[name] = TRACED_COUNTS.get(name, 0) + n


def reset_counts() -> None:
    COUNTS.clear()
    TRACED_COUNTS.clear()


def to_device(array, dtype=None, device=None) -> torch.Tensor:
    """``torch.as_tensor(array, dtype=dtype, device=device)``, counted as a
    host sync when it copies a host array onto a CUDA device."""
    out = torch.as_tensor(array, dtype=dtype, device=device)
    if out.is_cuda and not (isinstance(array, torch.Tensor)
                            and array.is_cuda):
        count("host_syncs")
    return out


def host_value(t: torch.Tensor):
    """``t.tolist()``: a Python number for a 0-d tensor, nested lists
    otherwise; counted as a host sync when ``t`` is on a CUDA device."""
    if t.is_cuda:
        count("host_syncs")
    return t.tolist()
