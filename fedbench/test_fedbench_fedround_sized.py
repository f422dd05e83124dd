"""The ``fedround_sized`` driver and its reference (``reference/dense.py``) on the
CPU at Minitron-8B's published ratios cut to a test's size: 2 layers, d 32,
6 query heads of 8 over 1 K/V head (a query width of 48 over d 32), rotary
over half of each head, relu², LayerNorm, untied, 16-token sequences.

The reference's leaves are the program's, its layer-at-a-time loss and
gradients are the program's autograd, its round is the program's float32
round; a whole run of the cell comes out correct, the control (the
reference one precision below) outside the limits, and each fault planted
under the timed path not correct, on float32 and on bfloat16 leaves."""
from __future__ import annotations

import contextlib
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

from fedbench import control, harness, run  # noqa: E402
from fedbench import control_fedround as cf  # noqa: E402
from fedbench.drivers import fedround_sized as drv  # noqa: E402
from fedbench.harness import leaf_paths, make_weights  # noqa: E402
from fedbench.reference import decoder, dense  # noqa: E402
from fedbench.reference import train as tref  # noqa: E402

CELL = "minitron-8b-base.fedround"
CONFIG = ROOT / "fedbench" / "configs" / "minitron-8b-base.json"
TINY = {"hidden_size": 32, "intermediate_size": 48, "num_attention_heads": 6,
        "num_key_value_heads": 1, "head_dim": 8, "num_hidden_layers": 2, "vocab_size": 96}
# Limits of the test's cell: float32 runs read r_gap 1e-5-2.3e-4 and the
# control 0.056-0.34 at this size; bfloat16 leaves round each step, so their
# uploads are held loosely and the close, which is exact, decides.
LIMITS = {"float32": {"loss_rel_gap": 1e-4, "r_gap": 1e-2, "close_mismatch_share": 0},
          "bfloat16": {"loss_rel_gap": 0.05, "r_gap": 10.0, "close_mismatch_share": 0}}


def _cfg(dtype: str = "float32") -> dict:
    return json.loads(CONFIG.read_text()) | TINY | {"torch_dtype": dtype}


def _program(cfg: dict):
    from repro_torch.models.api import Arch

    return Arch(drv.model_config(cfg))


def _tree(cfg, seed=3):
    params = make_weights(_program(cfg).param_shapes(), seed, torch.device("cpu"))
    # unit norm scales and zero biases do not test the norms' gradients
    g = torch.Generator().manual_seed(seed)
    for path, leaf in leaf_paths(params):
        if "norm" in path:
            leaf.add_(0.1 * torch.randn(leaf.shape, generator=g))
    return params, dict(leaf_paths(params))


def test_the_published_widths_build_the_registrys_model_at_them():
    full = json.loads(CONFIG.read_text())
    c = drv.model_config(full)
    assert (c.num_heads * c.resolved_head_dim, c.d_model, c.rotary_dim) == (6144, 4096, 64)
    like = _program(full).param_shapes()
    got = [(p, tuple(t.shape)) for p, t in leaf_paths(like)]
    assert got == decoder.protocol_leaves(full)
    assert sum(torch.Size(s).numel() for _, s in got) == full["parameters"]
    tiny = _cfg()
    assert [(p, tuple(t.shape)) for p, t in leaf_paths(_program(tiny).param_shapes())] == \
        decoder.protocol_leaves(tiny)


def test_layerwise_loss_and_gradients_are_the_programs_autograd():
    cfg = _cfg()
    m = dense.dims(cfg)
    assert m["rot"] == 4
    params, tree = _tree(cfg)
    tokens = torch.randint(0, m["vocab"], (16,), generator=torch.Generator().manual_seed(1))
    labels = torch.roll(tokens, -1)
    got = {}

    def take(path, layer, g):
        got.setdefault(path, {})[layer] = g

    lval = dense.grads(dense.Weights(tree, m), tokens, labels, take)
    leaves = [leaf.requires_grad_(True) for _, leaf in leaf_paths(params)]
    want = _program(cfg).loss(params, {"tokens": tokens[None], "labels": labels[None]})
    gs = torch.autograd.grad(want, leaves)
    # both float32, the same equations in other orders of summation: the
    # loss to a few ulps, each gradient to ~1e-6 of its leaf's largest
    # element (computing in bfloat16 moves them by ~1e-2)
    assert lval == pytest.approx(float(want.detach()), rel=1e-6)
    for (path, _), g in zip(leaf_paths(params), gs):
        mine = got[path]
        mine = mine[None] if None in mine else torch.stack([mine[i] for i in sorted(mine)])
        torch.testing.assert_close(mine, g, rtol=0, atol=1e-5 * float(g.abs().max()),
                                   msg=path)


def test_a_round_matches_the_programs_float32_round():
    from repro_torch.launch.train import FLRunConfig, make_train_step

    cfg = _cfg()
    m = dense.dims(cfg)
    params, tree = _tree(cfg)
    tags = {p: t for t, (p, _) in enumerate(leaf_paths(params))}
    ids = torch.randint(0, m["vocab"], (2, 17), generator=torch.Generator().manual_seed(2))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    fl = FLRunConfig(num_virtual_clients=2, local_steps=1, local_lr=0.5)
    new, met = make_train_step(_program(cfg), fl)(params, batch, 11)
    seeds = tref.round_seeds(11, 2)
    rs, losses = [], []
    for n in range(2):
        lv, r = dense.client_round(tree, tags, m, batch["tokens"][n], batch["labels"][n],
                                   0.5, seeds[n])
        rs.append(r)
        losses.append(lv)
    # the loss to float32's rounding; r sums ~10⁴ products of δ (float32,
    # each an ulp apart where the step's rounding flips) with ±1
    assert sum(losses) / 2 == pytest.approx(float(met["loss"]), rel=1e-6)
    torch.testing.assert_close(torch.tensor(rs, dtype=torch.float32), met["r"][:, 0],
                               rtol=1e-4, atol=1e-7)
    # the close from the program's own scalars: the same arithmetic to the bit
    mine = tref.close(tree, tags, met["r"][:, 0].tolist(), seeds, 1.0)
    for path, leaf in leaf_paths(new):
        torch.testing.assert_close(mine[path], leaf, rtol=0, atol=0)


@pytest.fixture(scope="module")
def tiny_roots(tmp_path_factory):
    """{dtype: a checkout whose cell runs the test's size on those leaves}."""
    roots = {}
    for dtype, limits in LIMITS.items():
        root = tmp_path_factory.mktemp(dtype)
        shutil.copytree(ROOT / "fedbench", root / "fedbench")
        shutil.copy(ROOT / "BENCHMARK.json", root)
        (root / "fedbench" / "configs" / CONFIG.name).write_text(json.dumps(_cfg(dtype)))
        tp_path = root / "fedbench" / "traffic" / "fedround-2x4096.json"
        tp = json.loads(tp_path.read_text())
        tp.update(seq_len=16, check_elements=1024, check_floor=16)
        tp_path.write_text(json.dumps(tp))
        (root / "fedbench" / "limits" / f"{CELL}.json").write_text(
            json.dumps({"checks": limits}))
        roots[dtype] = root
    return roots


def test_the_control_fails_the_cells_limits(tiny_roots):
    got = cf.control_readings(CELL, 2 ** 31 + 7, device="cpu", root=tiny_roots["float32"])
    assert got["r_gap"] > LIMITS["float32"]["r_gap"], got


@pytest.mark.parametrize("dtype", list(LIMITS))
@pytest.mark.parametrize("fault", [None, *control.FAULTS])
def test_training_faults_are_not_correct(tiny_roots, dtype, fault):
    with control.planted(fault, "fedround") if fault else contextlib.nullcontext():
        res = run.run_cell(CELL, 2 ** 31 + 7, 0.05, False, device="cpu", root=tiny_roots[dtype])
    assert set(res["checks"]) == set(LIMITS[dtype])
    assert set(res["metrics"]) == {"server_uploads_per_s", "peak_mem_gib", "setup_s"}
    assert res["correct"] is (fault is None), res["checks"]


def test_a_traced_run_reads_the_train_spans(tiny_roots, monkeypatch):
    from repro_torch import obs

    traces = []
    read_trace = harness._read_trace

    def keep_trace(prof):
        traces.append(read_trace(prof))
        return traces[-1]

    monkeypatch.setattr(harness, "_read_trace", keep_trace)
    res = run.run_cell(CELL, 2 ** 31 + 4099, 0.05, True, device="cpu",
                       root=tiny_roots["float32"])
    assert res["correct"], res["checks"]
    (tr,) = traces
    rounds = res["attempted"]
    assert tr.span_count("train_step") == rounds
    for name, per_round in (("train.forward", 2), ("train.backward", 2),
                            ("train.update", 4), ("train.encode", 2), ("train.close", 1)):
        assert tr.span_count(name) == per_round * rounds, name
    assert obs.traced()["train.tokens"] == 2 * 16 * rounds
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # the card's readers find no device operation on the CPU
    assert set(got) == {"mfu_dtype.train", "forward_ms.train", "backward_ms.train"}
    assert got["forward_ms.train"] == pytest.approx(
        1e3 * tr.span_seconds("train.forward") / (2 * rounds))


def test_the_readers_against_a_hand_made_trace():
    from fedbench.bounds import decode_bound_s

    def reader(name):
        return run._load_file(ROOT / "fedbench" / "metrics" / f"{name}.py").read

    tr = harness.Trace(window=(0.0, 10.0),
                       device_ops=[("void decode_tree_kernel<0>", 1.0, 1.5),
                                   ("void decode_tree_kernel<0>", 6.0, 6.5)],
                       spans=[("train_step", 0.0, 5.0), ("train_step", 5.0, 10.0),
                              ("train.forward", 0.0, 0.5), ("train.forward", 5.0, 5.75),
                              ("train.backward", 0.5, 2.5)])
    counters = {"decode_kernel": "decode_tree_kernel", "decode_shapes": [(64, 32)],
                "clients": 2, "elem_bytes": 4}
    assert reader("forward_ms.train")(tr, counters) == pytest.approx(625.0)
    assert reader("backward_ms.train")(tr, counters) == pytest.approx(2000.0)
    assert reader("close_roofline_pct.train")(tr, counters) == pytest.approx(
        100.0 * 2 * decode_bound_s([(64, 32)], 2, 1, 4) / 1.0)
