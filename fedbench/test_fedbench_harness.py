"""CPU tests of the benchmark's harness: manifest, discovery, arithmetic, traffic,
the reference, isolation, and a run with a fault planted under its timed path."""
from __future__ import annotations

import ast
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from fedbench import bounds, harness, run, traffic  # noqa: E402
from fedbench.reference import chain  # noqa: E402
from fedbench.reference import server as ref  # noqa: E402

BENCH = ROOT / "fedbench"


# --- manifest and discovery -------------------------------------------------

def test_manifest_names_files_that_exist():
    m = run.load_manifest()
    assert m["paths"] == ["fedbench"] and m["command"][1] == "fedbench/run.py"
    names = {w["name"] for w in m["workloads"]}
    for w in m["workloads"]:
        cell = run.resolve(m, w["name"])
        assert cell["driver"].exists()
        assert cell["workload"]["chips"] == 1
    for c in m["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("fedbench/")
    for metric in m["per_layer"]:
        assert (BENCH / "metrics" / f"{metric['name']}.py").exists()
        assert set(metric["workloads"]) <= names
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for w in names:
        assert run.cell_metrics(m, w, False) and run.cell_metrics(m, w, True)


def test_a_new_cell_is_found_from_files_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "fedbench")
    m = run.load_manifest()
    base = m["workloads"][0]
    (tmp_path / "fedbench" / "traffic" / "extra.json").write_text(
        (BENCH / "traffic" / f"{base['traffic']}.json").read_text())
    (tmp_path / "fedbench" / "limits" / "extra-cell.json").write_text(
        (BENCH / "limits" / f"{base['name']}.json").read_text())
    (tmp_path / "fedbench" / "metrics" / "extra_metric.py").write_text(
        "def read(trace, counters):\n    return 1.0\n")
    m["workloads"].append(dict(base, name="extra-cell", traffic="extra"))
    m["per_layer"].append({"name": "extra_metric", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "device",
                           "moves": m["end_to_end"][0]["name"], "workloads": ["extra-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = run.resolve(m, "extra-cell", tmp_path)
    assert cell["traffic"]["driver"] == json.loads(
        (BENCH / "traffic" / f"{base['traffic']}.json").read_text())["driver"]
    picked = [x["name"] for x in run.cell_metrics(m, "extra-cell", True)]
    assert picked == ["extra_metric"]
    mod = run._load_file(tmp_path / "fedbench" / "metrics" / "extra_metric.py")
    assert mod.read(None, {}) == 1.0


# --- metric arithmetic ------------------------------------------------------

def test_interval_union_and_gaps():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert harness.union_s(ivs, (0.0, 10.0)) == pytest.approx(4.0)
    assert harness.idle_gaps(ivs, (0.0, 10.0)) == [(2.0, 3.0), (4.0, 9.0)]
    tr = harness.Trace(window=(0.0, 10.0),
                       device_ops=[("k", a, b) for a, b in ivs],
                       spans=[("offer", 1.5, 3.5), ("apply_round", 3.5, 9.5)])
    bd = tr.breakdown()
    assert bd["device_ops"] == [["k", pytest.approx(6.5)]]
    assert bd["idle_gaps"] == [["apply_round", pytest.approx(5.0)],
                               ["offer", pytest.approx(1.0)]]


@pytest.mark.parametrize("shapes, n, elem, want_ms", [
    # chip_smoke.py's bounds at SmolLM-360M's embedding (PERF.md's kernel table)
    ([(49152, 960)], 1024, 4, 26.046),
    ([(49152, 960)], 256, 4, 6.511),
])
def test_decode_bound_matches_the_kernel_table(shapes, n, elem, want_ms):
    assert bounds.decode_bound_s(shapes, n, 1, elem) * 1e3 == pytest.approx(want_ms, rel=1e-3)


def test_encode_bound_is_bytes_bound_for_one_client():
    # one client over the 49152 × 960 leaf in bf16: 2 bytes an element
    d = 49152 * 960
    assert bounds.encode_bound_s([(49152, 960)], 1, 1, 2) == pytest.approx(
        max((2 * d + 4) / bounds.HBM_BYTES_PER_S, 9 * d / bounds.INT32_OPS_PER_S))


def test_train_flops_count():
    # Minitron-8B, one 4096-token sequence: 3 × (matmuls, head, attention)
    nonembed = 7_734_829_056 - 2 * 256000 * 4096
    f = bounds.train_flops(nonembed, 4096, 256000, 32, 32, 128, 4096, 4096)
    want = 3 * (2 * nonembed * 4096 + 2 * 4096 * 256000 * 4096
                + 4 * 32 * 4096 * 2048 * 32 * 128)
    assert f == pytest.approx(want)
    assert 1.7e14 < f < 1.8e14


def test_readers_leave_out_what_they_cannot_read():
    empty = harness.Trace(window=(0.0, 1.0), device_ops=[], spans=[])
    counters = {"decode_kernel": "decode_tree_kernel", "applied": [], "decode_shapes": [],
                "elem_bytes": 2, "encode_kernels": ["project_tree_kernel"],
                "encode_shapes": [], "encodes_per_round": 2, "flops_per_round": 1.0}
    for path in sorted((BENCH / "metrics").glob("*.py")):
        assert run._load_file(path).read(empty, counters) is None, path.name


# --- traffic ----------------------------------------------------------------

def _server_traffic(**kw):
    tp = json.loads((BENCH / "traffic" / "server-close.json").read_text())
    tp.update(kw)
    return tp


def test_uploads_are_drawn_from_the_seed():
    tp = _server_traffic(population=5000)
    seed = 2 ** 31 + 977
    a, b = traffic.Uploads(tp, seed).round(3), traffic.Uploads(tp, seed).round(3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    c = traffic.Uploads(tp, seed + 1).round(3)
    assert not np.array_equal(a["seeds"], c["seeds"])
    assert np.all(np.diff(a["ids"]) > 0)
    assert int(a["lost"].sum()) == round(0.05 * len(a["ids"]))


def test_every_seed_gets_the_same_straggler_shares():
    tp = _server_traffic(population=2000)
    levels = tp["straggler_levels"]
    for seed in (1, 2 ** 33 + 5):
        up = traffic.Uploads(tp, seed)
        shares = sorted(up.straggler_share(k) for k in range(levels, 2 * levels))
        np.testing.assert_allclose(shares, np.linspace(0.0, 0.25, levels))


def test_pps_probabilities_sum_to_the_cohort():
    p = np.random.default_rng(0).lognormal(0, 1, 1000)
    pi = traffic.pps_inclusion_probs(p / p.sum(), 100)
    assert pi.sum() == pytest.approx(100.0)
    assert np.all((pi > 0) & (pi <= 1))


def test_token_batches_are_drawn_from_the_seed():
    tp = {"rows_per_round": 2, "seq_len": 16}
    t1, l1 = traffic.token_batch(tp, 1000, 5, 0)
    t2, _ = traffic.token_batch(tp, 1000, 5, 0)
    t3, _ = traffic.token_batch(tp, 1000, 5, 1)
    np.testing.assert_array_equal(t1, t2)
    assert not np.array_equal(t1, t3)
    np.testing.assert_array_equal(t1[:, 1:], l1[:, :-1])


# --- the reference ----------------------------------------------------------

def _splitmix32_int(x: int) -> int:
    x = (x + 0x9E3779B9) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x21F0AAAD) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x735A2D97) & 0xFFFFFFFF
    return x ^ (x >> 15)


def test_chain_against_python_integers():
    words = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x9E3779B9, 123456789]
    got = chain.splitmix32(torch.tensor(words, dtype=torch.int64)).tolist()
    assert got == [_splitmix32_int(w) for w in words]
    s = _splitmix32_int(1234 ^ chain.PROJ_SALT)
    folded = _splitmix32_int(s ^ _splitmix32_int(3))
    h = _splitmix32_int(_splitmix32_int(_splitmix32_int(folded ^ chain.TAG_U1) ^ 5) ^ 7)
    assert chain.direction(1234, 3, 1, 8, row0=5)[0, 7] == (1.0 if (h >> 8) & 1 else -1.0)
    v = chain.direction(1234, 3, 64, 32)
    assert set(v.unique().tolist()) == {-1.0, 1.0}
    assert abs(float(v.mean())) < 0.1
    np.testing.assert_array_equal(v[10:20], chain.direction(1234, 3, 10, 32, row0=10))


def test_close_chain_follows_an_exact_update():
    # one upload, weight·r = 0.25: every element moves by ±0.25 exactly
    x0 = torch.zeros(8, dtype=torch.float64)
    tags = torch.zeros(8, dtype=torch.int64)
    rows, cols = torch.zeros(8, dtype=torch.int64), torch.arange(8)
    seeds = torch.tensor([77])
    x = ref.close_chain(x0, tags, rows, cols, [(seeds, torch.tensor([0.25], dtype=torch.float64))],
                        1.0, dtype=torch.float32)
    v = chain.direction(77, 0, 1, 8)[0]
    torch.testing.assert_close(x, 0.25 * v)
    lo = ref.close_chain(x0, tags, rows, cols, [(seeds, torch.tensor([0.25], dtype=torch.float64))],
                         1.0, acc="bfloat16", dtype=torch.float32)
    torch.testing.assert_close(lo, x)
    assert ref.compare(x, x, x0) == {"x_update_rel_err": 0.0, "x_mismatch_share": 0.0}


def test_applied_uploads_are_the_timely_ones():
    rnd = traffic.Uploads(_server_traffic(population=3000), 9).round(0)
    seeds, r, w = ref.applied(rnd, 1.0)
    n = len(rnd["ids"])
    assert len(seeds) == n - int(rnd["lost"].sum()) - int((rnd["latency_s"] > 1.0).sum())
    assert ref.sets_agree([(seeds, w, r[:, None])], [rnd], 1.0) == {
        "applied_set_mismatch": 0, "weight_max_abs_diff": 0.0, "scalar_mismatch": 0}


# --- isolation --------------------------------------------------------------

def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(run.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "torch", "numpy", "fedbench", "math"}, path


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    assert run.loaded_forbidden(["repro_torch", "repro_torch.kernels", "torch"]) == []
    assert run.loaded_forbidden(["repro.core", "jaxlib.xla", "numpy"]) == ["jaxlib", "repro"]


def test_a_process_running_the_drivers_loads_no_jax(tmp_path):
    """In a fresh process: the harness, both drivers, the references and the
    parts of the program they call leave JAX and the JAX package unloaded."""
    import subprocess

    code = (
        "import sys; sys.path[:0] = [sys.argv[1] + '/src', sys.argv[1]]\n"
        "from fedbench import run, control\n"
        "from fedbench.drivers import server_close, fedround\n"
        "from fedbench.reference import chain, decoder, server, train\n"
        "import repro_torch.fed.runtime.engine, repro_torch.launch.train\n"
        "import repro_torch.configs.registry\n"
        "print(run.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
