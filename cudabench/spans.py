"""Readings of the traced window over the program's own spans: the port's
``advchain.*`` profiler regions (``advchain_tpu_torch/_trace.py``), on the
clock of the device trace recorded with them.

A set of spans is reduced to the union of its intervals, clipped to the
window, so nested spans and the steps' repeats never count twice.  Inside
that union: the device's idle time (the window's time with no device
operation, clipped at the union's edges); the host's time inside it is the
union's own length.  The synchronising runtime calls are counted inside
``advchain.step``.  Backward kernels run on autograd's device thread while
the host waits inside ``advchain.solver.grad`` or
``advchain.step.backward``, so everything here is attributed by time
interval, not by thread.

The harness gives a metric's reader the traced window's summary
(``ctx.trace``); :func:`timeline` finds the Timeline it was made from."""

from __future__ import annotations

import sys

from cudabench.trace import Timeline, union, window_of

PREFIX = "advchain."
STEP = "advchain.step"
EPISODE = "advchain.solver.episode"
CHAIN = "advchain.chain."
# runtime calls that make the host wait for the device (a cudaMemcpy
# without "Async" is synchronous)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
# the port's module of counters, looked up among the loaded modules (the
# benchmark imports the port only in sut.py)
COUNTERS = "advchain_tpu_torch._trace"


def timeline(ctx):
    """The traced window's Timeline: ``ctx.timeline`` where the harness
    gives it, else the ``timeline`` of the harness's frame whose summary
    is ``ctx.trace``; None where there is none."""
    tl = getattr(ctx, "timeline", None)
    if tl is not None:
        return tl
    frame = sys._getframe(1)
    while frame is not None:
        tl = frame.f_locals.get("timeline")
        if isinstance(tl, Timeline) and tl.summary is ctx.trace:
            return tl
        frame = frame.f_back
    return None


def is_sync(name: str) -> bool:
    return name in SYNCS or (name.startswith("cudaMemcpy")
                             and "Async" not in name)


def spans(tl: Timeline, match):
    """The host's program spans whose name ``match(name)`` accepts."""
    return [o for o in tl.ops if not o.device and o.name.startswith(PREFIX)
            and match(o.name)]


def span_union(tl: Timeline, match):
    """Merged [(start, end)] of the matching spans, clipped to the
    window."""
    w0, w1 = window_of(tl)
    return union((max(o.start, w0), min(o.end, w1))
                 for o in spans(tl, match) if o.end > w0 and o.start < w1)


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def busy(tl: Timeline):
    """Merged intervals of the device's operations."""
    return union((o.start, o.end) for o in tl.ops if o.device)


def overlap(a, b) -> float:
    """Seconds that two lists of merged, sorted intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(tl: Timeline, intervals) -> float:
    """Seconds of ``intervals`` (merged) in which the device ran
    nothing."""
    return length(intervals) - overlap(intervals, busy(tl))


def sync_calls(tl: Timeline) -> int:
    """Synchronising runtime calls that start inside an ``advchain.step``
    span."""
    steps = span_union(tl, lambda n: n == STEP)
    calls = sorted(o.start for o in tl.ops if not o.device
                   and is_sync(o.name))
    n, i = 0, 0
    for s, e in steps:
        while i < len(calls) and calls[i] < s:
            i += 1
        while i < len(calls) and calls[i] <= e:
            n, i = n + 1, i + 1
    return n


def idle_by_span(tl: Timeline) -> dict:
    """{span name: idle seconds}: every idle instant of the window
    attributed to the innermost ``advchain.*`` span open then (the one
    that started last), or to ``outside advchain spans``."""
    w0, w1 = window_of(tl)
    marks = []  # (time, 0 for an end or 1 for a start, key, span)
    for k, o in enumerate(spans(tl, lambda n: True)):
        marks += [(o.start, 1, k, o), (o.end, 0, k, o)]
    marks.sort(key=lambda m: m[:3])
    out, active, j = {}, {}, 0
    for s, e in _complement(busy(tl), w0, w1):
        a = s
        while True:
            while j < len(marks) and marks[j][0] <= a:
                _, opening, k, o = marks[j]
                if opening:
                    active[k] = o
                else:
                    active.pop(k, None)
                j += 1
            b = min(e, marks[j][0]) if j < len(marks) else e
            name = (max(active.values(), key=lambda o: (o.start, -o.end))
                    .name if active else "outside advchain spans")
            out[name] = out.get(name, 0.0) + (b - a)
            if b >= e:
                break
            a = b
    return out


def _complement(merged, w0, w1):
    """The gaps of ``merged`` inside [w0, w1]."""
    out, at = [], w0
    for s, e in merged:
        if e <= w0 or s >= w1:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < w1:
        out.append((at, w1))
    return out


def log_idle_by_span(ctx, tl: Timeline) -> None:
    """One log line: idle ms a step by innermost ``advchain.*`` span."""
    per = sorted(idle_by_span(tl).items(), key=lambda x: -x[1])
    ctx.log("idle ms a step by innermost program span: " + ", ".join(
        f"{n} {1e3 * t / ctx.trace_steps!r}" for n, t in per))


def solver_idle_ms(ctx):
    """Device idle ms a step inside ``advchain.solver.episode``; logs the
    idle ms a step by innermost span.  None without program spans."""
    tl = timeline(ctx)
    if tl is None or not spans(tl, lambda n: n == STEP):
        return None
    log_idle_by_span(ctx, tl)
    episode = span_union(tl, lambda n: n == EPISODE)
    if not episode:
        return None
    return 1e3 * idle_in(tl, episode) / ctx.trace_steps


def transforms_host_ms(ctx):
    """Host ms a step inside the union of the ``advchain.chain.*`` spans:
    its length, the host's waits at the chain's syncs included.  None
    without them."""
    tl = timeline(ctx)
    chain = [] if tl is None else span_union(
        tl, lambda n: n.startswith(CHAIN))
    if not chain:
        return None
    return 1e3 * length(chain) / ctx.trace_steps


def host_syncs(ctx):
    """The port's ``host_syncs`` counter over the traced steps, a step,
    where it equals the trace's synchronising calls inside
    ``advchain.step``; else None, both logged."""
    counters = sys.modules.get(COUNTERS)
    tl = timeline(ctx)
    traced = getattr(counters, "TRACED_COUNTS", None)
    if traced is None or tl is None or not spans(tl, lambda n: n == STEP):
        return None
    program, trace_calls = traced.get("host_syncs", 0), sync_calls(tl)
    ctx.log(f"host syncs over {ctx.trace_steps} traced steps: program "
            f"{program}, trace {trace_calls}")
    if program != trace_calls:
        return None
    return program / ctx.trace_steps
