"""The fused close's autotuner (``repro_torch.kernels.tune``), on the CPU.

Ported from ``tests/test_tune_cache.py`` against the port's module:

* the cache key is a pure function of the workload (no clock, pid or
  host), and cohorts bucket to powers of two, floored at FUSED_CHUNK;
* a miss times every candidate once; a hit returns the stored winner
  without timing (the injected measure would raise);
* the first stored winner is sticky; a lookup with no entry is None; the
  store is an atomic rename; a second process reads the same winner;
* the candidates: every CUDA tile (``tree.CLOSE_TILES``) on a card's
  backend, the plain version's slabs up to the rows on the CPU (no
  compile budget prunes them: eager PyTorch compiles nothing).

Against the JAX reference (``jax_kernels``): ``cache_key`` and
``cohort_bucket`` equal ``repro.kernels.tune``'s; ``fused_tree_plain`` at
each of ``MIRROR_ROW_SLABS`` is bitwise the reference mirror at the same
``row_slab``.  The engine's fused route with a cached entry is bitwise
the route without one, and the plans of the close's tiles: one cached
plan per tile, each with the tile count of its shape.

No test here times a real sweep: ``measure`` is injected.  The tiles are
held bitwise against the default tile and the plain version on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.core.projection import ProjectionMode as TM  # noqa: E402
from repro_torch.fed.runtime import engine as tengine  # noqa: E402
from repro_torch.kernels import ops, tune  # noqa: E402
from repro_torch.kernels.reconstruct_apply import (  # noqa: E402
    fused_reconstruct_apply,
    fused_tree_plain,
)
from repro_torch.kernels.tree import (  # noqa: E402
    CLOSE_TILE_ROWS,
    CLOSE_TILE_THREADS,
    CLOSE_TILES,
    DEFAULT_CLOSE_TILE,
    TreeTable,
    close_tile,
    tree_plan,
)
from repro_torch.models import mlp_classifier as tmlp  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    digits_shards,
    jax_kernels,
    seeds_np,
)

SM90 = "cuda-sm_90a"


def _fake_measure(prefer_slab):
    """Deterministic fake timer: the preferred slab 'wins'."""
    calls = []

    def measure(cand):
        calls.append(dict(cand))
        return 0.001 if cand["row_slab"] == prefer_slab else 0.5

    measure.calls = calls
    return measure


def _raising_measure(cand):
    raise AssertionError(f"cache hit must not re-time, measured {cand}")


def test_cache_key_is_pure_and_bucketed():
    k1 = tune.cache_key("cpu", 512, 2048, 100, 3, "rademacher")
    assert k1 == "cpu|r512|c2048|n128|k3|rademacher|b32"
    assert k1 == tune.cache_key("cpu", 512, 2048, 100, 3, "rademacher")
    assert k1 == tune.cache_key("cpu", 512, 2048, 128, 3, "rademacher")
    assert k1 != tune.cache_key("cpu", 512, 2048, 129, 3, "rademacher")
    assert k1 != tune.cache_key(SM90, 512, 2048, 100, 3, "rademacher")
    assert k1 != tune.cache_key("cpu", 512, 2048, 100, 1, "rademacher")
    assert k1 != tune.cache_key("cpu", 512, 2048, 100, 3, "gaussian")
    assert k1 != tune.cache_key("cpu", 512, 2048, 100, 3, "rademacher",
                                dtype_bits=16)
    # the backend comes from the explicit device, not from the machine
    assert tune.backend_of("cpu") == tune.backend_of(torch.device("cpu")) == "cpu"


def test_cohort_bucket_floors_at_chunk():
    assert tune.cohort_bucket(1) == tune.cohort_bucket(16) == 16
    assert tune.cohort_bucket(17) == 32
    assert tune.cohort_bucket(1024) == 1024
    assert tune.cohort_bucket(1025) == 2048


def test_miss_sweeps_once_then_hit_never_retimes(tmp_path):
    path = str(tmp_path / "tune.json")
    m = _fake_measure(prefer_slab=64)
    won = tune.autotune_fused(512, 256, 100, 3, "rademacher",
                              backend="cpu", cache_path=path, measure=m)
    assert won == {"impl": "plain", "block": None, "row_slab": 64}
    assert m.calls == tune._candidates("cpu", 512, 256, 100)
    again = tune.autotune_fused(512, 256, 100, 3, "rademacher",
                                backend="cpu", cache_path=path,
                                measure=_raising_measure)
    assert again == won
    assert tune.autotune_fused(512, 256, 128, 3, "rademacher",
                               backend="cpu", cache_path=path,
                               measure=_raising_measure) == won
    assert tune.cached_fused_params(512, 256, 100, 3, "rademacher",
                                    backend="cpu", cache_path=path) == won
    # a card's key sweeps the tiles, and stores the winner apart
    tiles = tune.autotune_fused(
        512, 256, 100, 3, "rademacher", backend=SM90, cache_path=path,
        measure=lambda c: 0.001 if c["block"] == [16, 16, True] else 0.5)
    assert tiles == {"impl": "cuda", "block": [16, 16, True], "row_slab": None}
    assert tune.cached_fused_params(512, 256, 100, 3, "rademacher",
                                    backend="cpu", cache_path=path) == won


def test_first_cached_winner_is_sticky(tmp_path):
    path = str(tmp_path / "tune.json")
    first = tune.autotune_fused(512, 256, 100, 3, "rademacher",
                                backend="cpu", cache_path=path,
                                measure=_fake_measure(prefer_slab=16))
    assert first["row_slab"] == 16
    later = tune.autotune_fused(512, 256, 100, 3, "rademacher",
                                backend="cpu", cache_path=path,
                                measure=_fake_measure(prefer_slab=256))
    assert later == first
    raw = json.load(open(path))
    assert raw[tune.cache_key("cpu", 512, 256, 100, 3, "rademacher")] == first


def test_candidates_list_every_tile_and_slabs_up_to_the_rows():
    """A card's backend sweeps every tile of the kernel; the CPU sweeps the
    plain version's slabs, skipping those past the rows.  Nothing is pruned
    by a compile budget (the reference's mirror unrolls under XLA; eager
    PyTorch compiles nothing): slab 16 survives a 1024 cohort."""
    slabs = lambda rows, n: [c["row_slab"]
                             for c in tune._candidates("cpu", rows, 2048, n)]
    assert slabs(512, 256) == slabs(512, 1024) == [None, 16, 64, 256]
    assert slabs(100, 1 << 20) == [None, 16, 64]
    assert slabs(8, 16) == [None]
    cands = tune._candidates(SM90, 64, 24, 20)
    assert [tuple(c["block"]) for c in cands] == list(CLOSE_TILES)
    assert all(c["impl"] == "cuda" and c["row_slab"] is None for c in cands)
    assert tune.CUDA_TILES == CLOSE_TILES


def test_cached_lookup_without_entry_is_none(tmp_path):
    assert tune.cached_fused_params(
        512, 256, 100, 3, "rademacher", backend="cpu",
        cache_path=str(tmp_path / "missing.json")) is None


def test_store_is_atomic_rename(tmp_path):
    path = str(tmp_path / "tune.json")
    tune._store(path, {"a": 1})
    assert os.listdir(tmp_path) == ["tune.json"]
    assert tune._load(path) == {"a": 1}


_SUBPROC = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.kernels import tune

def raising(cand):
    raise AssertionError("subprocess must hit the cache, not re-time")

won = tune.autotune_fused(512, 256, 100, 3, "rademacher",
                          backend="cpu", cache_path={path!r},
                          measure=raising)
key = tune.cache_key("cpu", 512, 256, 100, 3, "rademacher")
print(json.dumps({{"won": won, "key": key}}))
"""


def test_cache_hit_deterministic_across_processes(tmp_path):
    path = str(tmp_path / "tune.json")
    won = tune.autotune_fused(512, 256, 100, 3, "rademacher",
                              backend="cpu", cache_path=path,
                              measure=_fake_measure(prefer_slab=64))
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run(
        [sys.executable, "-c", _SUBPROC.format(src=src, path=path)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["won"] == won
    assert got["key"] == tune.cache_key("cpu", 512, 256, 100, 3, "rademacher")


def test_default_cache_file_is_the_ports_own():
    assert tune.DEFAULT_CACHE_PATH.endswith("fused_tune_torch.json") or (
        "REPRO_TORCH_TUNE_CACHE" in os.environ)


def test_default_measure_times_the_plain_version_on_the_cpu():
    """The CPU measure runs the plain close once per candidate (a warm-up
    and 3 timed calls) and returns seconds; a tiny leaf, no sweep."""
    measure = tune._default_measure(4, 8, 16, 1, "rademacher", 32, "cpu")
    t = measure({"impl": "plain", "block": None, "row_slab": 2})
    assert isinstance(t, float) and t > 0
    with pytest.raises(ValueError, match="cannot time"):
        tune.autotune_fused(4, 8, 16, 1, backend=SM90, device="cpu",
                            cache_path=os.devnull)


# ---------------------------------------------------------------------------
# against the JAX reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ("cpu", 512, 2048, 100, 3, "rademacher", 32),
    ("cpu", 64, 24, 20, 1, "gaussian", 32),
    ("tpu", 49152, 960, 1025, 8, "sparse_rademacher", 16),
    (SM90, 960, 2560, 1, 1, "hadamard", 16),
])
def test_key_and_bucket_match_reference(jax_kernels, args):
    assert tune.cache_key(*args) == jax_kernels.tune.cache_key(*args)
    for n in (1, 16, 17, 100, 1000, 1024, 1025):
        assert tune.cohort_bucket(n) == jax_kernels.tune.cohort_bucket(n)
    assert tune.MIRROR_ROW_SLABS == jax_kernels.tune.MIRROR_ROW_SLABS


@pytest.mark.parametrize("slab", tune.MIRROR_ROW_SLABS)
@pytest.mark.parametrize("family,k", [("rademacher", 1), ("rademacher", 8)])
def test_plain_row_slabs_match_reference_mirror(jax_kernels, family, k, slab):
    """``fused_tree_plain`` at a slab ≡ the reference mirror at that
    ``row_slab`` (k = 8: BLOCK masking), bitwise, on a (260, 8) leaf."""
    rng = np.random.RandomState(7 + k)
    rows, cols, n = 260, 8, 16
    x = rng.randn(rows, cols).astype(np.float32)
    rs = rng.randn(n, k).astype(np.float32)
    seeds = seeds_np(rng, n)
    mode = TM.BLOCK if k > 1 else TM.FULL
    plan = tree_plan("close", [(rows, cols)], [torch.float32], k, mode, "cpu")
    got = fused_tree_plain([torch.from_numpy(x)],
                           torch.from_numpy(seeds.astype(np.int64)),
                           torch.from_numpy(rs), 0.25, plan, family,
                           row_slab=slab)[0]
    want = np.asarray(jax_kernels.reconstruct_apply.fused_reconstruct_apply(
        jnp.asarray(x), jnp.asarray(seeds), jnp.asarray(rs), 0, 0.25, family,
        lo=jnp.asarray(plan.lo[0].numpy()), hi=jnp.asarray(plan.hi[0].numpy()),
        masked=k > 1, use_pallas=False, row_slab=slab))
    np.testing.assert_array_equal(got.numpy(), want)
    # and every slab of the port is its default slab's bits
    assert torch.equal(got, fused_tree_plain(
        [torch.from_numpy(x)], torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(rs), 0.25, plan, family)[0])


def test_engine_fused_route_with_cached_entry_is_bitwise(tmp_path, monkeypatch):
    """``projection_mode="fused_kernel"``: the engine reads the dominant
    leaf's entry once and passes its knobs to every fused apply; the run
    is bitwise the run without an entry."""
    clients, xte, yte = digits_shards(8)
    p0 = tmlp.init_mlp(seed=3, device="cpu")
    cfg = tengine.RuntimeConfig(rounds=2, population=24, participation=0.5,
                                projection_mode="fused_kernel", client_chunk=16)
    seen = []
    real = ops.server_update_fused

    def spy(*args, **kwargs):
        seen.append((kwargs.get("block"), kwargs.get("row_slab")))
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "server_update_fused", spy)
    monkeypatch.setattr(tune, "DEFAULT_CACHE_PATH", str(tmp_path / "none.json"))
    plain = tengine.run_federation(cfg, p0, clients, xte, yte, device="cpu")
    assert seen and set(seen) == {(None, None)}
    path = str(tmp_path / "tune.json")
    entry = {"impl": "plain", "block": None, "row_slab": 16}
    # the MLP's dominant leaf is w2 (64, 24); the cohort of 12 buckets to 16
    tune._store(path, {tune.cache_key("cpu", 64, 24, 12, 1, "rademacher"): entry})
    monkeypatch.setattr(tune, "DEFAULT_CACHE_PATH", path)
    seen.clear()
    tuned = tengine.run_federation(cfg, p0, clients, xte, yte, device="cpu")
    assert seen and set(seen) == {(None, 16)}
    np.testing.assert_array_equal(tuned["loss"], plain["loss"])
    for key in p0:
        assert torch.equal(tuned["final_params"][key], plain["final_params"][key])


# ---------------------------------------------------------------------------
# the close's tiles in the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_close_tiles_get_their_own_plans_and_tile_counts(dtype):
    shapes = [(64, 24), (300, 1000), (1, 10), (5, 3, 7)]
    plans = []
    for tile in CLOSE_TILES:
        plan = tree_plan("close", shapes, [dtype] * 4, 1, TM.FULL, "cpu",
                         tile=list(tile))
        assert plan.tile == tile
        assert plan is tree_plan("close", shapes, [dtype] * 4, 1, TM.FULL,
                                 "cpu", tile=tile)
        plans.append(plan)
        rows_t, threads, vec = tile
        per_thread = (16 // dtype.itemsize) if vec else 1
        table = TreeTable.from_buffer_copy(plan.groups[0].template)
        tile0 = 0
        for i, ll in enumerate(plan.layout):
            ct = -(-ll.cols // (threads * per_thread))
            assert (table.leaf[i].col_tiles, table.leaf[i].tile0) == (ct, tile0)
            tile0 += -(-ll.rows // rows_t) * ct
        assert table.num_tiles == tile0 == plan.groups[0].num_tiles
    assert len({id(p) for p in plans}) == len(CLOSE_TILES)
    # no tile given is the default tile, which is the per-client decode's
    assert tree_plan("close", shapes, [dtype] * 4, 1, TM.FULL, "cpu") is plans[0]
    assert DEFAULT_CLOSE_TILE == (CLOSE_TILE_ROWS, CLOSE_TILE_THREADS, True)
    # the paper MLP's (64, 24) float32 leaf: 8 default tiles with 24 of
    # 128 columns live; the narrow tile's 8 tiles hold 24 of 32
    assert [p.groups[0].num_tiles > 0 for p in plans] == [True] * 5


def test_tiles_are_refused_where_they_do_not_belong():
    with pytest.raises(ValueError, match="not one of"):
        close_tile((8, 16, True))
    with pytest.raises(ValueError, match="only the fused close"):
        tree_plan("decode", [(4, 4)], [torch.float32], 1, TM.FULL, "cpu",
                  tile=DEFAULT_CLOSE_TILE)
    with pytest.raises(ValueError, match="not one of"):
        ops.server_update_fused({"w": torch.zeros(4, 4)}, torch.ones(2),
                                torch.arange(2), block=(3, 3, True))
    with pytest.raises(ValueError, match="positive"):
        fused_reconstruct_apply(torch.zeros(4, 4), torch.arange(2),
                                torch.ones(2), 0, 1.0, row_slab=0)
