"""CPU tests of the readers of the port's own spans and counters: the idle
readers against a hand-made trace, and one traced run of the server cell at
a tiny size (the fixtures of ``test_fedbench_faults.py``)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from fedbench import harness, run  # noqa: E402
from fedbench.test_fedbench_faults import CELL, tiny_model, tiny_root  # noqa: E402,F401

BENCH = ROOT / "fedbench"


def _reader(name):
    return run._load_file(BENCH / "metrics" / f"{name}.py").read


def _trace(gaps, spans, window=(0.0, 10.0)):
    """A trace whose device is busy outside ``gaps``."""
    edges = [window[0], *[t for g in gaps for t in g], window[1]]
    ops = [("k", a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    return harness.Trace(window=window, device_ops=ops, spans=spans)


def test_a_gap_across_offer_and_close_is_split_between_them():
    tr = _trace([(1.0, 4.0)], [
        ("offer", 0.5, 2.0), ("server.offer", 0.6, 2.0),
        ("close_round", 2.0, 3.0), ("server.close", 2.1, 3.0),
        ("apply_round", 3.0, 6.0), ("server.stage", 3.0, 3.5),
        ("server.launch", 3.5, 3.8)])
    assert _reader("idle_offer_ms.server")(tr, {}) == pytest.approx(1e3 * 1.0)
    # close 0.9 + stage 0.5 + launch 0.3; 0.1 in close_round and 0.2 in
    # apply_round outside any port span go to neither reader
    assert _reader("idle_close_ms.server")(tr, {}) == pytest.approx(1e3 * 1.7)


def test_a_gap_is_charged_by_instant_not_to_the_span_it_began_in():
    tr = _trace([(2.0, 5.0)], [
        ("apply_round", 1.0, 3.0), ("server.launch", 1.2, 1.8),
        ("offer", 3.0, 4.0), ("server.offer", 3.0, 4.0),
        ("close_round", 4.0, 5.0), ("server.close", 4.5, 5.0),
        ("server.offer", 8.0, 8.5)])
    assert tr.breakdown()["idle_gaps"][0][0] == "apply_round"
    assert _reader("idle_offer_ms.server")(tr, {}) == pytest.approx(1e3 * 1.0 / 2)
    assert _reader("idle_close_ms.server")(tr, {}) == pytest.approx(1e3 * 0.5 / 2)


def test_idle_outside_port_spans_is_charged_to_neither_reader():
    tr = _trace([(0.0, 1.0), (6.0, 9.0)], [
        ("offer", 0.0, 1.0), ("server.offer", 2.0, 3.0), ("apply_round", 6.0, 9.0)])
    assert _reader("idle_offer_ms.server")(tr, {}) == 0.0
    assert _reader("idle_close_ms.server")(tr, {}) == 0.0


def test_a_traced_run_counts_each_port_span_once_a_round(tiny_root, tiny_model,
                                                         monkeypatch):
    from repro_torch.fed.runtime.engine import EngineCore, _pad_pow2

    traces, applied = [], []
    read_trace, apply_round = harness._read_trace, EngineCore.apply_round

    def keep_trace(prof):
        traces.append(read_trace(prof))
        return traces[-1]

    def counted(self, params, aseeds, *a, **k):
        if torch.autograd.profiler._is_profiler_enabled:
            applied.append(len(aseeds))
        return apply_round(self, params, aseeds, *a, **k)

    monkeypatch.setattr(harness, "_read_trace", keep_trace)
    monkeypatch.setattr(EngineCore, "apply_round", counted)
    res = run.run_cell(CELL, 2 ** 31 + 4099, 0.05, True, device="cpu", root=tiny_root)
    assert res["correct"], res["checks"]
    (tr,) = traces
    rounds = res["attempted"]
    assert rounds >= 1 and len(applied) == rounds
    for name in ("server.offer", "server.close", "server.stage", "server.launch"):
        assert tr.span_count(name) == rounds, name

    from repro_torch import obs
    slots = sum(_pad_pow2(a) for a in applied)
    assert obs.traced()["decode.slots"] == slots
    assert res["metrics"]["decode_pad_pct.server"]["value"] == pytest.approx(
        100.0 * (1.0 - sum(applied) / slots))
