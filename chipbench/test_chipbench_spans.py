"""The readers of the program's spans (``chipbench/spans.py`` and the
``tick.*``, ``tier.*`` and ``idle_in_program.*`` metrics): a traced tiny
run of each cell reports the span metrics that its ``cells/<cell>.py``
names; the interval arithmetic of the idle readers on made-up spans and
kernels; and, on a card, that the device trace and the spans share one
clock:

    python -m pytest -q -m chipbench_card chipbench/test_chipbench_spans.py
"""
from __future__ import annotations

import io
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench import cells, run, spans, tiny  # noqa: E402
from chipbench.trace import Kernel  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SPAN_METRICS = {c: data.SPAN_METRICS for c, data in cells.loaded(CELLS).items()
                if data.SPAN_METRICS}


@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_run_reports_the_span_metrics(cell, monkeypatch):
    # other test files run in this process may have loaded JAX
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    out = io.StringIO()
    rc = run.run(["--workload", cell, "--seed", str(2 ** 33 + 9), "--seconds", "0.3",
                  "--trace", "1"], device="cpu", overrides=tiny.OVERRIDES, out=out)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True
    for name in SPAN_METRICS[cell]:
        assert math.isfinite(line["metrics"][name]["value"]), name
        assert line["metrics"][name]["value"] >= 0, name


def _span(name, a, b, parent=None, **attrs):
    from repro_torch.utils.tracing import Span

    return Span(name, a, b, parent, attrs)


def test_idle_in_counts_open_spans_where_no_kernel_ran():
    """A 1,000 ns window from the first span: spans open over [0, 300) and
    [500, 900), a span past the window, and kernels over [100, 200) and
    [250, 600): idle while open is [0, 100) + [200, 250) + [600, 900)."""
    got = [_span("a.x", 0, 300), _span("a.y", 500, 900), _span("a.y", 1000, 1500),
           _span("b", 300, 500)]
    ctx = SimpleNamespace(window_s=1e-6,
                          kernels=[Kernel("k", 100, 100), Kernel("k", 250, 350)])
    assert spans.idle_in(ctx, got, lambda s: s.name.startswith("a.")) == pytest.approx(45.0)
    assert spans.idle_in(SimpleNamespace(window_s=1e-6, kernels=[]), got, bool) is None


def test_per_root_sums_the_chosen_children_of_each_root():
    got = [_span("tick", 0, 10_000_000), _span("tick.plan", 0, 2_000_000, 0),
           _span("tick.sync", 2_000_000, 9_000_000, 0), _span("tick.segment", 0, 1_000_000, 1),
           _span("tick", 10_000_000, 20_000_000), _span("tick.plan", 10_000_000, 14_000_000, 4)]
    assert spans.per_root(got, "tick", lambda s: s.name != "tick.sync") == pytest.approx(3.0)
    assert spans.per_root(got, "tick", lambda s: s.name == "tick.sync") == pytest.approx(3.5)
    assert spans.per_root(got, "tier", bool) is None
    assert spans.per_root(got, "tick", lambda s: s.name == "tick.segment") == 0.0
    assert spans.per_root(got, "tick", lambda s: s.name == "tick.segment",
                          direct=False) == pytest.approx(0.5)


def _reader(name):
    return run.load_module(HERE / "metrics" / f"{name}.py", "test_reader_" + name.replace(".", "_"))


def test_the_host_readers_leave_out_replays_and_copies(monkeypatch):
    """``tick.host_ms`` leaves out the graph replays' segments under
    ``tick.issue`` (not the eager ones); ``tier.host_ms_per_batch`` leaves
    out the collect's copy, and counts only spans begun in the window."""
    ms = 1_000_000
    tick = [_span("tick", 0, 100 * ms), _span("tick.issue", 0, 60 * ms, 0),
            _span("tick.segment", 0, 40 * ms, 1, graph=True),
            _span("tick.segment", 40 * ms, 50 * ms, 1, graph=False),
            _span("tick.sync", 60 * ms, 90 * ms, 0), _span("tick.post", 90 * ms, 100 * ms, 0)]
    monkeypatch.setattr(spans, "recorded", lambda: tick)
    assert _reader("tick.host_ms").read(None) == pytest.approx(30.0)
    tier = [_span("tier.assemble", 0, 2 * ms), _span("tier.launch", 2 * ms, 3 * ms),
            _span("tier.collect", 3 * ms, 9 * ms), _span("tier.copy", 3 * ms, 8 * ms, 2),
            _span("tier.assemble", 9 * ms, 10 * ms), _span("tier.assemble", 30 * ms, 31 * ms)]
    monkeypatch.setattr(spans, "recorded", lambda: tier)
    ctx = SimpleNamespace(window_s=0.02)
    assert _reader("tier.host_ms_per_batch").read(ctx) == pytest.approx(2.5)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.chipbench_card
def test_a_span_holds_its_kernel_on_the_device_trace(card):
    """A span around a kernel launch and ``torch.cuda.synchronize()``
    contains that kernel's interval in ``trace.kernels``: the device trace
    and the spans share one clock (each side of the launch is given a
    millisecond of host time, so only a clock off by more would fail)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chipbench import trace
    from repro_torch.utils import tracing

    x = torch.rand(1 << 24, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with tracing.span("launch"):
                time.sleep(1e-3)
                torch.mul(x, 2.0)
                torch.cuda.synchronize()
                time.sleep(1e-3)
    got = tracing.spans()
    ks = trace.kernels(prof)
    assert len(got) == 3 and len(ks) >= 3
    for s in got:
        inside = [k for k in ks if s.start_ns <= k.start_ns
                  and k.start_ns + k.dur_ns <= s.end_ns]
        assert len(inside) == 1, (s, ks)
