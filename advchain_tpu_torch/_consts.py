"""Constants of a shape or a literal, kept on the device: importable from
every layer of the package, as ``_trace`` is.

A step's coordinate prep, grids, resize matrices and filters are the same
tensors on every call.  Copied anew from a pageable host array each time,
each one makes the host wait until the device has drained its queue
(``_trace.to_device``).  :func:`device_const` builds such a tensor once
per key, with the copy it makes today, and returns the same tensor on
every later call: no copy, no launch.  A miss counts
``device_consts.fill`` (``_trace.count``), so a warm step counts none.

A cached tensor is shared by every caller: nothing writes into it in
place (a view of it, such as a space group's slab, is taken after the
cache).  The cache holds at most ``MAX_ENTRIES`` entries, the oldest
dropped first.
"""

from __future__ import annotations

import functools

import torch

from advchain_tpu_torch._trace import count, to_device

__all__ = ["device_const", "scalar", "MAX_ENTRIES"]

MAX_ENTRIES = 1024

# (builder, args, kwargs) -> what the builder returned
_CACHE: dict = {}


def device_const(build):
    """Decorator: ``build(*args, **kwargs)`` made once per arguments (all
    hashable: sizes, literals, dtype, device) and shared after.  Built
    outside inference mode, so autograd may save it whatever mode its
    first caller ran in."""
    @functools.wraps(build)
    def cached(*args, **kwargs):
        key = (build, args, tuple(kwargs.items()))
        out = _CACHE.get(key)
        if out is None:
            count("device_consts.fill")
            with torch.inference_mode(False):
                out = build(*args, **kwargs)
            if len(_CACHE) >= MAX_ENTRIES:
                _CACHE.pop(next(iter(_CACHE)), None)
            _CACHE[key] = out
        return out
    return cached


@device_const
def scalar(value, dtype, device) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``dtype`` on ``device``."""
    return to_device(value, dtype, device)
