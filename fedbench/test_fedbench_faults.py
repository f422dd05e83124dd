"""A whole run of the server cell on the CPU at a tiny size, past the look for a
card: sound, it comes out correct; with each fault planted under its timed path
(``control.FAULTS``), ``correct`` comes out false."""
from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from fedbench import control, run  # noqa: E402

CELL = "smollm-360m.server-close"


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout of the benchmark whose server traffic is 20 uploads a round."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "fedbench", root / "fedbench")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    tp_path = root / "fedbench" / "traffic" / "server-close.json"
    tp = json.loads(tp_path.read_text())
    tp.update(population=2000, check_elements=2048, check_floor=64, fastest_round_ms=100)
    tp_path.write_text(json.dumps(tp))
    return root


@pytest.fixture
def tiny_model(monkeypatch):
    """A one-layer bf16 decoder of SmolLM's family, its closes on the route the
    card takes for large cohorts (the per-client decode, here its plain
    version), which the CPU's runtime keeps for the card alone."""
    from repro_torch.configs import registry
    from repro_torch.fed.runtime.engine import EngineCore
    from repro_torch.models.api import Arch

    cfg = registry.get_config("smollm-360m").reduced(num_layers=1, d_model=32, d_ff=64,
                                                     vocab_size=64)
    monkeypatch.setattr(registry, "get_arch",
                        lambda name, reduced=False: Arch(dataclasses.replace(cfg, dtype="bfloat16")))
    init = EngineCore.__init__

    def decode_route(self, *a, **k):
        init(self, *a, **k)
        self.kern_thresh = 1

    monkeypatch.setattr(EngineCore, "__init__", decode_route)


def test_the_control_fails_the_cells_limits(tiny_root, tiny_model):
    """The reference's close summed in bfloat16, in the program's place,
    over a run's worth of rounds: outside the cell's own limits."""
    limits = json.loads((ROOT / "fedbench" / "limits" / f"{CELL}.json").read_text())["checks"]
    got = control.control_readings(CELL, 2 ** 31 + 99, 40, device="cpu", root=tiny_root)
    assert any(got[k] > limits[k] for k in got), got


@pytest.mark.parametrize("fault", [None, *control.FAULTS])
def test_faults_under_the_timed_path_are_not_correct(tiny_root, tiny_model, fault):
    with control.planted(fault) if fault else contextlib.nullcontext():
        res = run.run_cell(CELL, 2 ** 31 + 99, 0.3, False, device="cpu", root=tiny_root)
    assert res["attempted"] >= 1
    assert res["correct"] is (fault is None), res["checks"]


TRAIN = "minitron-8b.fedround"


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """A checkout holding the training driver's cell at a two-layer cut of
    Minitron-8B's family, 16-token sequences, and limits of its own."""
    from repro_torch.configs.registry import get_config

    c = get_config("minitron-8b").reduced(num_layers=2, d_model=32, d_ff=48, vocab_size=96)
    root = tmp_path_factory.mktemp("train")
    shutil.copytree(ROOT / "fedbench", root / "fedbench")
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "minitron-8b", "source": "https://arxiv.org/abs/2407.14679",
                         "file": "fedbench/configs/minitron-8b.json", "reduced": [],
                         "why": "test"})
    m["workloads"].append({"name": TRAIN, "config": "minitron-8b", "traffic": "fedround",
                           "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cfg_path = root / "fedbench" / "configs" / "minitron-8b.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.update(hidden_size=c.d_model, intermediate_size=c.d_ff, num_attention_heads=c.num_heads,
               num_key_value_heads=c.num_kv_heads, head_dim=c.resolved_head_dim,
               num_hidden_layers=c.num_layers, vocab_size=c.vocab_size)
    cfg_path.write_text(json.dumps(cfg))
    tp_path = root / "fedbench" / "traffic" / "fedround.json"
    tp = json.loads(tp_path.read_text())
    tp.update(seq_len=16, check_elements=1024, check_floor=16)
    tp_path.write_text(json.dumps(tp))
    (root / "fedbench" / "limits" / f"{TRAIN}.json").write_text(json.dumps(
        {"checks": {"loss_rel_gap": 0.01, "first_r_gap": 1.0, "close_mismatch_share": 0}}))
    return root, dataclasses.replace(c, dtype="bfloat16")


@pytest.mark.parametrize("fault", [None, *control.FAULTS])
def test_training_faults_are_not_correct(train_root, monkeypatch, fault):
    from repro_torch.configs import registry
    from repro_torch.models.api import Arch

    root, cfg = train_root
    monkeypatch.setattr(registry, "get_arch", lambda name, reduced=False: Arch(cfg))
    with control.planted(fault, "fedround") if fault else contextlib.nullcontext():
        res = run.run_cell(TRAIN, 2 ** 31 + 7, 0.05, False, device="cpu", root=root)
    assert res["correct"] is (fault is None), res["checks"]
