"""The readings over the program's spans (``cudabench/spans.py``) and the
five readers of ``metrics/`` on synthetic timelines: a set of spans counts
its union once, idle across a span's edge is clipped to the span, a sync
outside ``advchain.step`` is not counted, a counter that disagrees with the
trace gives None, and a trace without the program's spans (a program that
records none) gives None everywhere."""

import types

import pytest

from cudabench import spans
from cudabench import trace as tracing
from cudabench.tests.tiny import ROOT
from cudabench.harness import Manifest
from cudabench.trace import Op, Timeline

READERS = ("solver.idle_ms.2d", "solver.idle_ms.3d", "transforms.host_ms.3d",
           "step.host_syncs.2d", "step.host_syncs.3d")


def _host(name, s, e):
    return Op(name, s, e, False, "host")


def _dev(name, s, e):
    return Op(name, s, e, True, "kernel")


def _tl():
    """Two steps of 10 s in a window of 0-21: each step an episode (with a
    PGD step and a chain span inside it) and a backward; kernels leave
    idle gaps that cross the spans' edges; a sync in each step, one
    between the steps."""
    ops = [_host(tracing.WINDOW, 0.0, 21.0)]
    for k in range(2):
        t = 10.0 * k
        ops += [_host("advchain.step", t + 0.5, t + 10.0),
                _host("advchain.solver.episode", t + 1.0, t + 6.0),
                _host("advchain.solver.pgd_step", t + 1.5, t + 5.5),
                _host("advchain.chain.precompute", t + 2.0, t + 3.0),
                _host("advchain.chain.apply", t + 2.5, t + 3.5),
                _host("advchain.step.backward", t + 7.0, t + 9.0),
                _host("cudaStreamSynchronize", t + 2.2, t + 2.4),
                _host("aten::mul", t + 4.0, t + 4.1),
                _dev("k", t + 0.0, t + 2.0),     # idle 2-4 inside pgd_step
                _dev("k", t + 4.0, t + 5.0),     # idle 5-7 crosses the
                _dev("k", t + 7.0, t + 10.0)]    # episode's end at 6
    ops += [_host("cudaDeviceSynchronize", 20.2, 20.5)]
    return Timeline(ops, steps=2)


def _ctx(tl, **kw):
    tl.summary = tracing.summarize(tl)
    log = []
    ctx = types.SimpleNamespace(trace=tl.summary, trace_steps=tl.steps,
                                log=log.append, timeline=tl, **kw)
    return ctx, log


@pytest.fixture
def counters(monkeypatch):
    mod = types.SimpleNamespace(TRACED_COUNTS={})
    monkeypatch.setitem(spans.sys.modules, spans.COUNTERS, mod)
    return mod.TRACED_COUNTS


def test_nested_spans_count_once_and_idle_is_clipped():
    tl = _tl()
    episode = spans.span_union(tl, lambda n: n == spans.EPISODE)
    assert episode == [(1.0, 6.0), (11.0, 16.0)]
    # idle 2-4 and 5-6 of each episode (5-7 clipped at the episode's end)
    assert spans.idle_in(tl, episode) == pytest.approx(6.0)
    chain = spans.span_union(tl, lambda n: n.startswith(spans.CHAIN))
    assert chain == [(2.0, 3.5), (12.0, 13.5)]
    assert spans.length(chain) == pytest.approx(3.0)


def test_idle_goes_to_the_innermost_span():
    by = spans.idle_by_span(_tl())
    # a step's idle: 2-2.5 precompute, 2.5-3.5 apply (opened later),
    # 3.5-4 and 5-5.5 pgd_step, 5.5-6 episode, 6-7 step
    assert by["advchain.chain.precompute"] == pytest.approx(2 * 0.5)
    assert by["advchain.chain.apply"] == pytest.approx(2 * 1.0)
    assert by["advchain.solver.pgd_step"] == pytest.approx(2 * 1.0)
    assert by["advchain.solver.episode"] == pytest.approx(2 * 0.5)
    assert by["advchain.step"] == pytest.approx(2 * 1.0)
    assert by["outside advchain spans"] == pytest.approx(1.0)  # 20-21
    window = 21.0 - tracing.summarize(_tl())["busy_s"]
    assert sum(by.values()) == pytest.approx(window)


def test_syncs_are_counted_inside_the_step_only():
    assert spans.sync_calls(_tl()) == 2
    assert spans.is_sync("cudaMemcpy") and spans.is_sync("cudaMemcpy2D")
    assert not spans.is_sync("cudaMemcpyAsync")
    assert not spans.is_sync("cudaLaunchKernel")


def test_readers(counters):
    m = Manifest(ROOT)
    ctx, log = _ctx(_tl())
    counters["host_syncs"] = 2
    got = {name: m.metric_reader(name)(ctx) for name in READERS}
    assert got["solver.idle_ms.2d"] == got["solver.idle_ms.3d"] \
        == pytest.approx(1e3 * 6.0 / 2)
    assert got["transforms.host_ms.3d"] == pytest.approx(1e3 * 3.0 / 2)
    assert got["step.host_syncs.2d"] == got["step.host_syncs.3d"] == 1.0
    assert any(line.startswith("idle ms a step by innermost") for line in log)
    counters["host_syncs"] = 3  # disagrees with the trace's 2
    assert m.metric_reader("step.host_syncs.2d")(ctx) is None
    assert "program 3, trace 2" in log[-1]


def test_readers_find_nothing_without_program_spans(counters):
    ops = [o for o in _tl().ops if not o.name.startswith("advchain.")]
    ctx, _ = _ctx(Timeline(ops, steps=2))
    m = Manifest(ROOT)
    assert all(m.metric_reader(n)(ctx) is None for n in READERS)


def test_readers_without_the_program_counters(monkeypatch):
    monkeypatch.delitem(spans.sys.modules, spans.COUNTERS, raising=False)
    ctx, _ = _ctx(_tl())
    assert spans.host_syncs(ctx) is None


def test_timeline_found_in_the_callers_frame():
    timeline = _tl()
    ctx, _ = _ctx(timeline)
    del ctx.timeline
    assert spans.timeline(ctx) is timeline
    other = types.SimpleNamespace(trace={}, trace_steps=2)
    assert spans.timeline(other) is None


def test_a_traced_run_reports_the_program_readings():
    """A whole traced run of the tiny 2D adversarial cell on the CPU: the
    readers find the harness's timeline and the port's counters (no sync on
    the CPU)."""
    from cudabench import harness
    from cudabench.tests.tiny import TinyManifest
    logged = []
    result = harness.run_cell(TinyManifest(), "unet16_cardiac2d.adv_b128",
                              2 ** 40 + 7, 0.05, True, "cpu", 0.0,
                              log=logged.append)
    got = result["metrics"]
    assert got["solver.idle_ms.2d"]["value"] > 0
    assert got["step.host_syncs.2d"]["value"] == 0
    assert any(line.startswith("idle ms a step by innermost program span")
               for line in logged)
