"""The port's spans and counters (``repro_torch/obs.py``), on the CPU."""
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core.prng import Distribution  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _annotations(prof) -> dict:
    """{name: (start, end)} of the recording's CPU user annotations."""
    return {e.name: (e.time_range.start, e.time_range.end) for e in prof.events()
            if getattr(e, "is_user_annotation", False)}


def test_span_is_a_shared_null_context_without_a_profiler():
    assert obs.span("test.a") is obs.span("test.b")
    with obs.span("test.a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("test.traced"):
            pass
    assert "test.traced" in _annotations(prof)


def test_port_spans_nest_inside_the_callers_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.outer"):
            with obs.span("test.inner"):
                torch.ones(4).sum()
    spans = _annotations(prof)
    (a0, a1), (b0, b1) = spans["test.outer"], spans["test.inner"]
    assert a0 <= b0 <= b1 <= a1


def test_the_tally_starts_from_zero_at_each_recording():
    total0 = obs.totals()["test.count"]
    with profile(activities=[ProfilerActivity.CPU]):
        obs.count("test.count", 3)
        assert obs.traced()["test.count"] == 3
    obs.count("test.count")                    # outside: the totals alone
    assert obs.traced()["test.count"] == 3     # the last recording's tally stays
    with profile(activities=[ProfilerActivity.CPU]):
        obs.count("test.count", 2)
    assert obs.traced()["test.count"] == 2
    assert obs.totals()["test.count"] == total0 + 6
    copy = obs.totals()
    copy["test.count"] += 100
    assert obs.totals()["test.count"] == total0 + 6


def test_decode_slots_count_the_rows_of_the_plain_route():
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(8, 16, generator=g), "b": torch.randn(5, generator=g)}
    rs = torch.randn(24, generator=g)
    seeds = torch.randint(0, 2 ** 31, (24,), generator=g)
    before = obs.totals()
    ops.server_update_kernel(params, rs, seeds, 1.0, Distribution.RADEMACHER)
    after = obs.totals()
    assert after["decode.slots"] - before["decode.slots"] == 24
    assert after["decode.launches"] == before["decode.launches"]   # no kernel on the CPU


def test_idle_goes_to_the_innermost_port_span_by_instant():
    spans = [("test.outer", 0.0, 10.0), ("test.inner", 2.0, 4.0), ("test.next", 6.0, 8.0)]
    got = obs.idle_by_span([(1.0, 3.0), (5.0, 7.0), (9.5, 12.0)], spans)
    assert got == pytest.approx({"test.outer": 1.0 + 1.0 + 0.5, "test.inner": 1.0,
                                 "test.next": 1.0, None: 2.0})


def test_device_time_on_a_cpu_trace():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("test.busy"):
            torch.ones(64).cumsum(0)
    t = obs.device_time(prof)
    assert t["busy_s"] == 0.0 and t["window_s"] > 0.0
    assert sum(t["idle_s"].values()) == pytest.approx(t["window_s"])
    assert t["idle_s"]["test.busy"] > 0.0
