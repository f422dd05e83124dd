"""The port's spans and counters (``repro_torch/obs.py``), on the CPU."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
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


APPLIED = [1, 5, 17, 33, 100]


def _small_tree(dtype, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"b": torch.randn(40, generator=g).to(dtype),
            "w": torch.randn(24, 40, generator=g).to(dtype)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("a", APPLIED)
def test_decode_kernel_route_decodes_the_applied_rows_alone(a, dtype, monkeypatch):
    """``EngineCore.apply_round`` on the decode-kernel route hands the
    decode the ``a`` applied uploads, not the bucket, and lands on the
    padded launch's bits; the digest replay runs the same launch.  The
    card's staging, laid onto the CPU's plain version of the kernel."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fed.runtime import engine
    from torch_parity import closed_round, server_core

    monkeypatch.setattr(engine, "_APPLIED_ROWS_DEVICES", ("cuda", "cpu"))
    params = _small_tree(dtype, a)
    core = server_core(params, "cpu", kernel_cohort_threshold=1,
                       downlink_mode="digest", verify_replay=True)
    aseeds, acoeffs, ars, st = closed_round(a, seed=a)
    slots0 = obs.totals()["decode.slots"]
    got, method, _ = core.apply_round(params, aseeds, acoeffs, ars, a, st)
    assert method is True
    assert obs.totals()["decode.slots"] - slots0 == a
    core.close_digest(0, aseeds, acoeffs, ars, st, np.arange(a), got, method)
    assert obs.totals()["decode.slots"] - slots0 == 2 * a    # the replay's own a rows
    rs, w, seeds = engine._dev_tensors(torch.device("cpu"),
                                       *engine._pad_bucket(ars, acoeffs, aseeds))
    want = core.proto.server_apply(params, rs, seeds, w, use_kernel=True)
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        assert x.dtype == dtype and torch.equal(x, y)


BUCKET_ROUTES = {
    "plain": ({}, False),
    "kernel_plain_version": (dict(kernel_cohort_threshold=1), True),
    "fused": (dict(projection_mode="fused_kernel"), "fused"),
    "mesh": (dict(mesh_shape=(1, 2)), True),
}


@pytest.mark.parametrize("route", list(BUCKET_ROUTES))
@pytest.mark.parametrize("a", APPLIED)
def test_other_routes_keep_the_bucket(a, route):
    """Every route but the decode kernel's on the card hands its apply the
    zero-padded bucket, as the reference does: the plain loop, the CPU's
    plain version of the kernel, the fused close and the mesh decode."""
    from repro_torch.fed.runtime.engine import _pad_pow2
    from torch_parity import closed_round, server_core

    cfg_kw, want_method = BUCKET_ROUTES[route]
    params = _small_tree(torch.float32, a)
    core = server_core(params, "cpu", **cfg_kw)
    rows = []
    apply = core.proto.server_apply

    def spy(params, payloads, *args, **kw):
        rows.append(payloads.shape[0])
        return apply(params, payloads, *args, **kw)

    core.proto.server_apply = spy
    aseeds, acoeffs, ars, st = closed_round(a, seed=a)
    _, method, _ = core.apply_round(params, aseeds, acoeffs, ars, a, st)
    assert method == want_method and rows == [_pad_pow2(a)]


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
