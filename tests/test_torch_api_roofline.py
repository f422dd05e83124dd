"""The port's Arch shape plumbing and H100 roofline against the reference.

Mirrors ``tests/test_api_roofline.py`` on ``repro_torch`` (the input
shapes, the train specs, the bounded long-decode caches, the roofline's
invariants, the tp layout's cut, the parameter counts), then holds
``repro_torch.launch.roofline`` to ``repro.launch.roofline`` term for
term: the parameter counts exactly for all ten configs, and for 10
configs × 4 shapes × both reference meshes × both layouts ``flops_total``,
``model_flops`` and every component within rel 1e-12, each time the
reference's times its rate ratio (989e12 / 197e12 FLOP/s, 3.35e12 /
819e9 B/s; the collectives of a 256- or 512-device mesh cross nodes, 50e9
B/s a GPU, the reference's ICI rate).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import repro.launch.roofline as j_roof  # noqa: E402
from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import roofline as t_roof  # noqa: E402
from repro_torch.models.api import INPUT_SHAPES, LONG_WINDOW  # noqa: E402
from repro_torch.sharding.rules import tree_paths  # noqa: E402

RATES = {"compute_s": j_roof.PEAK_FLOPS / t_roof.PEAK_FLOPS,
         "memory_s": j_roof.HBM_BW / t_roof.HBM_BW,
         "collective_s": j_roof.ICI_BW / t_roof.NDR_BW}


@pytest.fixture(scope="module")
def ref_counts():
    """The reference's counts, cached for the module (each call re-traces its
    init with ``jax.eval_shape``); the module attributes are restored after."""
    mp = pytest.MonkeyPatch()
    for name in ("param_count", "expert_param_count", "active_param_count"):
        mp.setattr(j_roof, name, functools.lru_cache(maxsize=None)(getattr(j_roof, name)))
    yield j_roof
    mp.undo()


def test_input_shapes_table():
    assert INPUT_SHAPES["train_4k"] == (4096, 256, "train")
    assert INPUT_SHAPES["prefill_32k"] == (32768, 32, "prefill")
    assert INPUT_SHAPES["decode_32k"] == (32768, 128, "decode")
    assert INPUT_SHAPES["long_500k"] == (524288, 1, "decode")


@pytest.mark.parametrize("name", ARCH_IDS)
def test_train_specs_match_assignment(name):
    arch = get_arch(name)
    specs = arch.input_specs("train_4k")
    tokens = specs["batch"]["tokens"]
    assert tokens.is_meta and tokens.shape[0] == 256
    total = tokens.shape[1] + (arch.cfg.num_frontend_tokens
                               if arch.cfg.frontend == "vision" else 0)
    assert total == 4096


@pytest.mark.parametrize("name", ARCH_IDS)
def test_long_decode_cache_is_bounded(name):
    """long_500k cache capacity: LONG_WINDOW for attention archs; SSM state
    is O(1) regardless."""
    arch = get_arch(name)
    specs = arch.input_specs("long_500k")
    biggest = max(leaf.numel() for _, leaf in tree_paths(specs["caches"]))
    if arch.cfg.num_heads:
        assert arch.decode_window(524288) == LONG_WINDOW
    assert biggest < 4e9, (name, biggest)


def test_roofline_terms_positive_and_consistent():
    for name in ("granite-8b", "qwen3-moe-30b-a3b", "falcon-mamba-7b"):
        n = t_roof.param_count(name)
        na = t_roof.active_param_count(name)
        assert 0 < na <= n
        for shape in INPUT_SHAPES:
            for mesh in t_roof.MESHES:
                t = t_roof.analytic_terms(name, shape, mesh)
                assert t["compute_s"] > 0 and t["memory_s"] > 0
                assert t["collective_s"] >= 0
                assert t["dominant"] in ("compute", "memory", "collective")
                assert 0 < t["roofline_fraction"] <= 1
            # one card: no link, no collective time
            assert t_roof.analytic_terms(name, shape, "one_card")["collective_s"] == 0
    assert t_roof.active_param_count("qwen3-moe-30b-a3b") < 0.25 * t_roof.param_count(
        "qwen3-moe-30b-a3b")


def test_tp_layout_strictly_cuts_decode_collective():
    base = t_roof.analytic_terms("qwen1.5-4b", "decode_32k", layout="zero3")
    tp = t_roof.analytic_terms("qwen1.5-4b", "decode_32k", layout="tp")
    assert tp["collective_s"] < 0.1 * base["collective_s"]
    assert tp["memory_s"] < base["memory_s"]


def test_param_counts_plausible():
    approx = {
        "smollm-360m": (0.3e9, 0.5e9),
        "granite-8b": (7e9, 9.5e9),
        "falcon-mamba-7b": (6e9, 8.5e9),
        "qwen3-moe-30b-a3b": (25e9, 36e9),
        "qwen3-moe-235b-a22b": (200e9, 260e9),
        "jamba-v0.1-52b": (45e9, 60e9),
        "whisper-tiny": (20e6, 60e6),
    }
    for name, (lo, hi) in approx.items():
        n = t_roof.param_count(name)
        assert lo <= n <= hi, (name, n)


@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_counts_equal_the_reference(ref_counts, name):
    assert t_roof.param_count(name) == ref_counts.param_count(name)
    assert t_roof.expert_param_count(name) == ref_counts.expert_param_count(name)
    assert t_roof.active_param_count(name) == ref_counts.active_param_count(name)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("name", ARCH_IDS)
def test_analytic_terms_equal_the_reference(ref_counts, name, shape):
    """Term for term, on both reference meshes and both layouts: FLOPs and
    bytes within rel 1e-12, each time the reference's times the rate ratio."""
    for mesh in ("pod16x16", "pod2x16x16"):
        for layout in ("zero3", "tp"):
            want = ref_counts.analytic_terms(name, shape, mesh, layout)
            got = t_roof.analytic_terms(name, shape, mesh, layout)
            for key in ("flops_total", "model_flops", "useful_flop_ratio"):
                assert got[key] == pytest.approx(want[key], rel=1e-12), key
            for key, value in want["components"].items():
                assert got["components"][key] == pytest.approx(value, rel=1e-12,
                                                               abs=1e-300), key
            for key, ratio in RATES.items():
                assert got[key] == pytest.approx(want[key] * ratio, rel=1e-12), key
            assert got["link_bw"] == t_roof.NDR_BW


def test_global_batch_cuts_the_shape():
    """``global_batch`` defaults to the shape's; a cut batch scales the
    token-proportional FLOPs with it (the card checks run train_4k at 8)."""
    full = t_roof.analytic_terms("smollm-360m", "train_4k", "one_card")
    same = t_roof.analytic_terms("smollm-360m", "train_4k", "one_card",
                                 global_batch=256)
    cut = t_roof.analytic_terms("smollm-360m", "train_4k", "one_card",
                                global_batch=8)
    assert full == same
    assert cut["flops_total"] == pytest.approx(full["flops_total"] / 32, rel=1e-12)
    assert cut["dominant"] == "compute"


def test_round_shape_sets_weight_uses_and_syncs():
    """A train round's clients × local steps set its weight reads, gradient
    syncs and uplink: the defaults are the reference's 4 × 2, and a round of
    2 × 1 (the card's Minitron-8B check) reads the weights a quarter as
    often, with the FLOPs unchanged."""
    ref = t_roof.analytic_terms("minitron-8b", "train_4k", "pod16x16", global_batch=2)
    same = t_roof.analytic_terms("minitron-8b", "train_4k", "pod16x16", global_batch=2,
                                 clients=4, local_steps=2)
    small = t_roof.analytic_terms("minitron-8b", "train_4k", "pod16x16", global_batch=2,
                                  clients=2, local_steps=1)
    assert ref == same
    rc, sc = ref["components"], small["components"]
    assert small["flops_total"] == ref["flops_total"]
    for key in ("weight_traffic_gb", "gather_ici_gb", "grad_sync_ici_gb"):
        assert sc[key] == pytest.approx(rc[key] / 4, rel=1e-12)
    assert sc["fedscalar_uplink_bytes"] == rc["fedscalar_uplink_bytes"] / 2
    assert sc["act_traffic_gb"] == rc["act_traffic_gb"]
