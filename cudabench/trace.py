"""The traced window: a fixed number of steady steps under
``torch.profiler``, reduced in memory to a timeline of device operations
and host operations, then to the device's busy time (the union of its
operations' intervals, not the sum of their durations), the idle gaps
named by what the host was doing, and the device time by kernel name.
Nothing is written to disk."""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field

WINDOW = "cudabench.window"
STEP = "cudabench.step"
# profiler activities that occupy the device
DEVICE_KINDS = ("kernel", "memcpy", "memset")


@dataclass
class Op:
    name: str
    start: float  # seconds
    end: float
    device: bool
    kind: str = ""


@dataclass
class Timeline:
    """Device and host operations of one traced window."""
    ops: list
    steps: int
    summary: dict = field(default_factory=dict)


def record(run_step, steps: int, sync):
    """Run ``run_step`` ``steps`` times under the profiler inside a
    ``WINDOW`` span that ends with ``sync()``; return the Timeline."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(steps):
                with record_function(STEP):
                    run_step()
            sync()
    events = list(prof.profiler.kineto_results.events())
    host_names = {e.name() for e in events if not _on_device(e)}
    ops = []
    for e in events:
        on_device = _on_device(e)
        kind = _kind(e, on_device)
        if on_device and (not kind or e.name() in host_names):
            continue  # the device-side copies of host annotations
        start = e.start_ns() * 1e-9
        ops.append(Op(e.name(), start, start + e.duration_ns() * 1e-9,
                      on_device, kind))
    return Timeline(ops, steps)


def _on_device(e):
    return str(e.device_type()).upper().endswith("CUDA")


def _kind(e, on_device):
    """'kernel', 'memcpy', 'memset' for a device operation ('' for an
    annotation), 'host' for the host's; from the profiler's activity type
    where this version of PyTorch gives it, else from the name."""
    if not on_device:
        return "host"
    activity = getattr(e, "activity_type", None)
    if activity is not None:
        kind = str(activity()).lower()
        return next((k for k in DEVICE_KINDS if k in kind), "")
    if getattr(e, "is_user_annotation", lambda: False)():
        return ""
    low = e.name().lower()
    return next((k for k in ("memcpy", "memset") if low.startswith(k)),
                "kernel")


def union(intervals):
    """Merged [(start, end)] of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def window_of(tl: Timeline):
    spans = [o for o in tl.ops if not o.device and o.name == WINDOW]
    if spans:
        return spans[0].start, spans[0].end
    ends = [o.end for o in tl.ops] or [0.0]
    starts = [o.start for o in tl.ops] or [0.0]
    return min(starts), max(ends)


def summarize(tl: Timeline, top: int = 10) -> dict:
    """Busy and window seconds, idle share, launches, device seconds by
    kernel name, the host spans of the steps (sorted), and the breakdown's
    two lists."""
    w0, w1 = window_of(tl)
    dev = [o for o in tl.ops if o.device]
    busy_iv = union((max(o.start, w0), min(o.end, w1)) for o in dev
                    if o.end > w0 and o.start < w1)
    busy = sum(e - s for s, e in busy_iv)
    window = w1 - w0
    by_name = {}
    for o in dev:
        t, n = by_name.get(o.name, (0.0, 0))
        by_name[o.name] = (t + (o.end - o.start), n + 1)
    launches = sum(1 for o in dev if o.kind == "kernel")
    gaps = []
    edges = [w0] + [x for iv in busy_iv for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((s, e))
    named = name_gaps(gaps, [o for o in tl.ops
                             if not o.device and o.name != WINDOW])
    spans = sorted(o.end - o.start for o in tl.ops
                   if not o.device and o.name == STEP)
    device_ops = sorted(((n, t) for n, (t, _) in by_name.items()),
                        key=lambda x: -x[1])[:top]
    idle = sorted(named.items(), key=lambda x: -x[1])[:top]
    return {"busy_s": busy, "window_s": window,
            "idle_share": 1.0 - busy / window if window > 0 else None,
            "launches": launches, "kernels": by_name, "step_spans": spans,
            "breakdown": {"device_ops": [[n[:160], t] for n, t in device_ops],
                          "idle_gaps": [[n[:160], t] for n, t in idle]}}


def name_gaps(gaps, host):
    """{host operation: idle seconds}: each gap is named by the shortest
    host operation that spans its midpoint (one sweep over both, sorted)."""
    ops = sorted(host, key=lambda o: o.start)
    named, active, i = {}, [], 0
    for mid, length in sorted((0.5 * (s + e), e - s) for s, e in gaps):
        while i < len(ops) and ops[i].start <= mid:
            heapq.heappush(active, (ops[i].end - ops[i].start, ops[i].end, i))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = (ops[active[0][2]].name if active
                else "host outside any recorded operation")
        named[name] = named.get(name, 0.0) + length
    return named


def identifier(pattern: str):
    """A regex matching ``pattern`` as a whole identifier inside a kernel
    name (``band_grid_fwd_kernel`` does not match
    ``zband_grid_fwd_kernel``)."""
    return re.compile(r"(?<![A-Za-z0-9_])" + re.escape(pattern)
                      + r"(?![A-Za-z0-9_])")


def matching(kernels: dict, pattern: str):
    """(seconds, launches) of the kernels whose name holds ``pattern``."""
    rx = identifier(pattern)
    t = n = 0
    for name, (sec, count) in kernels.items():
        if rx.search(name):
            t += sec
            n += count
    return t, n
