"""Port parity of the federation runtime: sampling, server, wire, costs, engine.

* Sampling, the streaming server, the wire codecs (bf16 included) and
  the cost model are numpy on both sides: held **bitwise** (cohorts,
  weights, bytes, stats and every cost figure).  The port's bf16 wire
  rounding is a ``torch.bfloat16`` cast; it is held against
  ``ml_dtypes`` bit for bit, ties and subnormals included.
* ``fedavg_round`` / ``qsgd_round`` on identical numpy batches: new
  params within atol 1e-6 for fedavg (local SGD's float32 sums run in
  other orders).  For qsgd the deltas differ by float32 ulps and the
  norms by up to a few ulps, which can flip a stochastic level where the
  uniform sits within an ulp of the fraction; one flip moves one element
  of the mean by at most lr·max‖δ‖/L/N, and the test allows that per
  element, and at most 1 % of elements with any flip.  With the
  reference's norms injected, the quantizer's levels and round trip are
  bitwise (``test_quantizer_matches_reference_with_its_norms``).
* ``run_federation`` for all three protocols with the batch draw of
  both packages patched to one shared numpy index table (the reference
  draws with threefry, which the port does not reproduce): population
  48, participation 0.25, 3 rounds, a lossy channel or a finite deadline
  so the full-participation shortcut is not taken.  Cohorts (through
  the digest log's seeds), every stats and cost array and ``cum_bits``
  are equal; the loss within rtol 1e-5; params within atol 1e-6 for
  fedscalar (fori, the per-client decode route, the fused route, digest
  replay) and fedavg, and within the flip bound for qsgd.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import fedavg as jfa  # noqa: E402
from repro.core import qsgd as jq  # noqa: E402
from repro.fed import costmodel as jcm  # noqa: E402
from repro.fed.runtime import engine as jengine  # noqa: E402
from repro.fed.runtime import sampling as jsamp  # noqa: E402
from repro.fed.runtime import server as jserver  # noqa: E402
from repro.fed.runtime import transport as jtr  # noqa: E402
from repro.models import mlp_classifier as jmlp  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import fedavg as tfa  # noqa: E402
from repro_torch.core import qsgd as tq  # noqa: E402
from repro_torch.fed import costmodel as tcm  # noqa: E402
from repro_torch.fed.runtime import engine as tengine  # noqa: E402
from repro_torch.fed.runtime import sampling as tsamp  # noqa: E402
from repro_torch.fed.runtime import scheduler as tsched  # noqa: E402
from repro_torch.fed.runtime import server as tserver  # noqa: E402
from repro_torch.fed.runtime import transport as ttr  # noqa: E402
from repro_torch.models import mlp_classifier as tmlp  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    STAT_KEYS,
    digits_shards,
    jax_kernels,
    mlp_params_np,
    patch_shared_draws,
)

# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["uniform", "weighted", "poisson"])
@pytest.mark.parametrize("population,participation", [(50, 0.2), (997, 0.013)])
def test_cohorts_bitwise(kind, population, participation):
    w = None
    if kind == "weighted":
        w = 1.0 + (np.arange(population) % 7)
    a = tsamp.CohortSampler(tsamp.ClientPopulation(population, w),
                            participation, kind, seed=3)
    b = jsamp.CohortSampler(jsamp.ClientPopulation(population, w),
                            participation, kind, seed=3)
    for k in (0, 1, 7, 12345):
        ca, cb = a.sample(k), b.sample(k)
        np.testing.assert_array_equal(ca.client_ids, cb.client_ids)
        np.testing.assert_array_equal(ca.inclusion_probs, cb.inclusion_probs)
        np.testing.assert_array_equal(ca.agg_weights, cb.agg_weights)
        arrived = np.arange(ca.size) % 3 != 1
        np.testing.assert_array_equal(
            tsamp.realized_cohort_weights(ca, arrived),
            jsamp.realized_cohort_weights(cb, arrived))
    assert (tsamp.sampling_diagnostic(a, rounds=20)
            == jsamp.sampling_diagnostic(b, rounds=20))


# ---------------------------------------------------------------------------
# streaming server
# ---------------------------------------------------------------------------

def _uploads(pkg, rng, n, k_round, payload_dim):
    return [pkg.Upload(client_id=i, encoded_round=k_round,
                       seed=int(rng.randint(0, 2**32, dtype=np.uint64)),
                       r=rng.randn(payload_dim).astype(np.float32),
                       agg_weight=float(rng.rand()),
                       latency_s=float(rng.exponential(0.01)),
                       lost=bool(rng.rand() < 0.1))
            for i in range(n)]


@pytest.mark.parametrize("server_kw", [
    dict(deadline_s=0.008),
    dict(max_staleness=2, round_period_s=0.005, staleness_exponent=0.5),
    dict(min_cohort=50),
])
def test_streaming_server_bitwise(server_kw):
    a = tserver.StreamingAggregator(tserver.ServerConfig(**server_kw))
    b = jserver.StreamingAggregator(jserver.ServerConfig(**server_kw))
    for k in range(4):
        ua = _uploads(tserver, np.random.RandomState(k), 40, k, 3)
        ub = _uploads(jserver, np.random.RandomState(k), 40, k, 3)
        assert [a.offer(u) for u in ua] == [b.offer(u) for u in ub]
        ra, rb = a.close_round(k), b.close_round(k)
        for x, y in zip(ra[:3], rb[:3]):
            np.testing.assert_array_equal(x, y)
        assert dataclasses.asdict(ra[3]) == dataclasses.asdict(rb[3])
        assert a.state_bytes() == b.state_bytes()
    assert a.pending_rounds() == b.pending_rounds()


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _awkward_floats(n=4000, seed=0):
    """Random words plus bf16 ties, near-ties, subnormals and zeros."""
    rng = np.random.RandomState(seed)
    words = [rng.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32),
             (np.arange(1, 400, dtype=np.uint32) << 16) | 0x8000,   # ties
             (np.arange(1, 400, dtype=np.uint32) << 17) | 0x18000,  # odd ties
             (np.arange(1, 400, dtype=np.uint32) << 16) | 0x7FFF,
             np.arange(1, 2000, dtype=np.uint32),                   # subnormals
             np.arange(1, 2000, dtype=np.uint32) | 0x80000000,
             np.asarray([0, 0x80000000, 0x7F7FFFFF, 0x00800000], np.uint32)]
    f = np.concatenate(words).view(np.float32)
    return f[np.isfinite(f)]


def test_bf16_wire_rounding_matches_ml_dtypes_bitwise():
    f = _awkward_floats()
    want = f.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = ttr.to_wire(f, "bf16")
    np.testing.assert_array_equal(got, want)
    back = ttr.from_wire(got, "bf16")
    np.testing.assert_array_equal(
        back.view(np.uint32),
        f.astype(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))


@pytest.mark.parametrize("scalar", ["fp32", "fp16", "bf16"])
@pytest.mark.parametrize("k", [1, 4])
def test_scalar_frames_bitwise(scalar, k):
    f = _awkward_floats(seed=k)
    f = np.concatenate([f[:16 * k], f[4000:4000 + 16 * k], f[-32 * k:]])
    c = len(f) // k
    rs = f[: c * k].reshape(c, k)
    seeds = np.random.RandomState(1).randint(0, 2**32, size=c,
                                             dtype=np.uint64).astype(np.uint32)
    a, b = ttr.WireFormat(scalar, k), jtr.WireFormat(scalar, k)
    assert a.bits_per_upload == b.bits_per_upload
    assert a.bytes_per_upload == b.bytes_per_upload
    blob = a.encode_batch(rs, seeds)
    assert blob == b.encode_batch(rs, seeds)
    ra, sa = a.decode_batch(blob, c)
    rb, sb = b.decode_batch(blob, c)
    np.testing.assert_array_equal(ra.view(np.uint32), rb.view(np.uint32))
    np.testing.assert_array_equal(sa, sb)
    for i in (0, c - 1):
        one = ttr.encode_upload(rs[i], int(seeds[i]), a)
        assert one == jtr.encode_upload(rs[i], int(seeds[i]), b)
        r1, s1 = ttr.decode_upload(one, a)
        r2, s2 = jtr.decode_upload(one, b)
        np.testing.assert_array_equal(r1.view(np.uint32), r2.view(np.uint32))
        assert s1 == s2 and a.decode(one)[1] == s2


@pytest.mark.parametrize("scalar", ["fp32", "fp16", "bf16"])
def test_dense_frames_bitwise(scalar):
    d = 37
    f = _awkward_floats(seed=5)
    vals = np.concatenate([f[:2 * d], f[4000:4000 + d], f[-2 * d:]]).reshape(5, d)
    a, b = ttr.DenseFrameCodec(d, scalar), jtr.DenseFrameCodec(d, scalar)
    assert a.bits_per_upload == b.bits_per_upload
    blob = a.encode_batch(vals)
    assert blob == b.encode_batch(vals)
    np.testing.assert_array_equal(a.decode_batch(blob, 5)[0].view(np.uint32),
                                  b.decode_batch(blob, 5)[0].view(np.uint32))
    one = a.encode(vals[2])
    assert one == b.encode(vals[2])
    np.testing.assert_array_equal(a.decode(one)[0].view(np.uint32),
                                  b.decode(one)[0].view(np.uint32))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantized_frames_bitwise(bits):
    d, nn = 50, 3
    lim = (1 << (bits - 1)) - 1
    rng = np.random.RandomState(bits)
    lv = rng.randint(-lim, lim + 1, size=(6, d)).astype(np.float32)
    payloads = np.concatenate([lv, rng.rand(6, nn).astype(np.float32)], axis=1)
    a = ttr.QuantizedFrameCodec(d, nn, bits)
    b = jtr.QuantizedFrameCodec(d, nn, bits)
    assert (a.bits_per_upload, a.bytes_per_upload) == (b.bits_per_upload,
                                                       b.bytes_per_upload)
    blob = a.encode_batch(payloads)
    assert blob == b.encode_batch(payloads)
    np.testing.assert_array_equal(a.decode_batch(blob, 6)[0],
                                  b.decode_batch(blob, 6)[0])
    assert a.encode(payloads[1]) == b.encode(payloads[1])
    with pytest.raises(ValueError, match="integers"):
        a.encode_batch(payloads + 0.5)


@pytest.mark.parametrize("uniform", [False, True])
def test_digest_codec_round_log_and_downlink_bitwise(uniform):
    rng = np.random.RandomState(4)
    codec_a, codec_b = ttr.DigestCodec(2), jtr.DigestCodec(2)
    log_a, log_b = ttr.RoundLog(codec_a, 3), jtr.RoundLog(codec_b, 3)
    for k in range(6):
        a_n = int(rng.randint(0, 5))
        dg_kw = dict(round_idx=k,
                     seeds=rng.randint(0, 2**32, size=a_n,
                                       dtype=np.uint64).astype(np.uint32),
                     rs=rng.randn(a_n, 2).astype(np.float32),
                     coeffs=None if uniform else rng.rand(a_n).astype(np.float32))
        assert (log_a.append(ttr.RoundDigest(**dg_kw))
                == log_b.append(jtr.RoundDigest(**dg_kw)))
        assert codec_a.encode(ttr.RoundDigest(**dg_kw)) == codec_b.encode(
            jtr.RoundDigest(**dg_kw))
    for frm in range(-1, 8):
        assert log_a.suffix_bits(frm) == log_b.suffix_bits(frm)
    for x, y in zip(log_a.replay(4), log_b.replay(4)):
        np.testing.assert_array_equal(x.seeds, y.seeds)
        np.testing.assert_array_equal(x.rs, y.rs)
    ch = tcm.ChannelConfig(downlink_bandwidth_bps=2e5)
    da = ttr.DownlinkChannel(tcm.CostModel(ch, 6400), 200, mode="digest",
                             digest_codec=codec_a, log_window=2)
    db = jtr.DownlinkChannel(jcm.CostModel(jcm.ChannelConfig(
        downlink_bandwidth_bps=2e5), 6400), 200, mode="digest",
        digest_codec=codec_b, log_window=2)
    for k in range(5):
        dg = dict(round_idx=k, seeds=np.arange(3, dtype=np.uint32),
                  rs=np.ones((3, 2), np.float32),
                  coeffs=None if uniform else np.ones(3, np.float32))
        clients = np.asarray([0, k, max(k - 1, 0), max(k - 3, 0)])
        assert da.catch_up_batch(clients, k) == db.catch_up_batch(clients, k)
        assert da.catch_up(0, k) == db.catch_up(0, k)
        assert da.broadcast(ttr.RoundDigest(**dg)) == db.broadcast(
            jtr.RoundDigest(**dg))
        assert da.round_cost(1234.0) == db.round_cost(1234.0)
    assert (da.total_bits, da.catchup_bits, da.dense_resyncs) == (
        db.total_bits, db.catchup_bits, db.dense_resyncs)


def test_uplink_channel_bitwise():
    ch = dict(drop_prob=0.2, base_latency_s=0.001)
    fa = ttr.WireFormat("bf16", 2)
    fb = jtr.WireFormat("bf16", 2)
    a = ttr.UplinkChannel(tcm.CostModel(tcm.ChannelConfig(**ch), 6400, 7), fa)
    b = jtr.UplinkChannel(jcm.CostModel(jcm.ChannelConfig(**ch), 6400, 7), fb)
    rs = _awkward_floats(seed=9)[:40].reshape(20, 2)
    seeds = np.arange(20, dtype=np.uint32) * 977
    for _ in range(3):
        ta, tb = a.transmit(rs, seeds), b.transmit(rs, seeds)
        np.testing.assert_array_equal(ta.r_hat.view(np.uint32),
                                      tb.r_hat.view(np.uint32))
        for f in ("seeds", "latency_s", "lost"):
            np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
        assert ta.payload_bytes == tb.payload_bytes


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("access", ["concurrent", "tdma"])
@pytest.mark.parametrize("deadline", [math.inf, 0.004])
def test_cost_model_bitwise(access, deadline):
    kw = dict(access=access, num_clients=9, drop_prob=0.1, base_latency_s=2e-4,
              p_down_watts=3.0)
    a = tcm.CostModel(tcm.ChannelConfig(**kw), 63680, rng_seed=5)
    b = jcm.CostModel(jcm.ChannelConfig(**kw), 63680, rng_seed=5)
    for bits in (64, 288, 63680):
        assert a.round_cost(bits) == b.round_cost(bits)
        la = a.per_client_upload_seconds(bits, 9)
        lb = b.per_client_upload_seconds(bits, 9)
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(a.per_client_drops(9), b.per_client_drops(9))
        assert (a.cohort_round_cost(la, bits, deadline)
                == b.cohort_round_cost(lb, bits, deadline))
        assert a.downlink_cost(bits) == b.downlink_cost(bits)
    for fn in ("replay_round_costs",):
        ra = getattr(tcm, fn)(tcm.ChannelConfig(**kw), 288, 4, 9, 63680, 2)
        rb = getattr(jcm, fn)(jcm.ChannelConfig(**kw), 288, 4, 9, 63680, 2)
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x, y)


def test_cost_model_formulas_match():
    for args in [(1990, 8, 6), (1990, 4, 1), (10, 2, 3, 16)]:
        assert tcm.quantized_upload_bits(*args) == jcm.quantized_upload_bits(*args)
    for n, k, inc in [(0, 1, True), (12, 1, False), (1000, 8, True)]:
        assert (tcm.digest_downlink_bits(n, k, include_coeffs=inc)
                == jcm.digest_downlink_bits(n, k, include_coeffs=inc))
    assert tcm.dense_downlink_bits(1990) == jcm.dense_downlink_bits(1990)
    assert tcm.queue_entry_bytes(3) == jcm.queue_entry_bytes(3)
    assert tcm.bits_to_bytes(64) == jcm.bits_to_bytes(64) == 8
    assert tcm.bytes_to_bits(9) == jcm.bytes_to_bits(9)
    with pytest.raises(ValueError, match="byte-aligned"):
        tcm.bits_to_bytes(12)
    assert tcm.table1_upload_times() == jcm.table1_upload_times()
    assert (tcm.DIGEST_HEADER_BITS, tcm.BYTE_BITS, tcm.FLOAT64_BYTES,
            tcm.INT64_BYTES) == (jcm.DIGEST_HEADER_BITS, jcm.BYTE_BITS,
                                 jcm.FLOAT64_BYTES, jcm.INT64_BYTES)


# ---------------------------------------------------------------------------
# baseline rounds and the quantizer
# ---------------------------------------------------------------------------

def _batch(seed, lead=(), b=32):
    rng = np.random.RandomState(seed)
    x = (rng.rand(*lead, b, 64) * 16).astype(np.float32)
    y = rng.randint(0, 10, size=(*lead, b)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("shape", [(24,), (64, 24), (3, 4, 5), (300, 70)])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantizer_matches_reference_with_its_norms(shape, bits):
    """Levels, round trip and dequantize bitwise, given the reference's norms."""
    rng = np.random.RandomState(bits + len(shape))
    x = (rng.randn(*shape) * 0.01).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    levels = (1 << (bits - 1)) - 1
    seed, tag = 0xC0FFEE ^ bits, len(shape)
    jl, jn = jq.quantize_levels(jnp.asarray(x), jnp.uint32(seed), levels, tag)
    norm = torch.tensor(np.asarray(jn))
    tl, tn = tq.quantize_levels(torch.from_numpy(x), seed, levels, tag, norm=norm)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert float(tn) == float(jn)
    np.testing.assert_array_equal(
        tq.quantize_leaf(torch.from_numpy(x), seed, levels, tag, norm=norm).numpy(),
        np.asarray(jq.quantize_leaf(jnp.asarray(x), jnp.uint32(seed), levels, tag)))
    np.testing.assert_array_equal(
        tq.dequantize_levels(tl, tn, levels).numpy(),
        np.asarray(jq.dequantize_levels(jl, jn, levels)))
    assert float(tq.leaf_norm(torch.zeros(3))) == 1.0


def test_quant_seeds_bitwise():
    ids = np.asarray([0, 1, 5, 99, 2**31 + 7], np.int64)
    for k in (0, 3, 2**32 - 1):
        np.testing.assert_array_equal(
            tq.quant_seeds(k, torch.from_numpy(ids)).numpy().astype(np.uint32),
            np.asarray(jq.quant_seeds(jnp.uint32(k), jnp.asarray(ids, jnp.uint32))))


def test_fedavg_round_matches_reference():
    n, s = 6, 5
    p = mlp_params_np(3)
    x, y = _batch(4, lead=(n, s))
    got, _ = tfa.fedavg_round(params_from_jax(p, "cpu"),
                              (torch.from_numpy(x), torch.from_numpy(y)), 2,
                              tmlp.mlp_grad, tfa.FedAvgConfig())
    want, _ = jfa.fedavg_round({k: jnp.asarray(v) for k, v in p.items()},
                               (jnp.asarray(x), jnp.asarray(y)), 2,
                               jmlp.mlp_grad, jfa.FedAvgConfig())
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert tfa.upload_bits_per_client(params_from_jax(p, "cpu"),
                                      tfa.FedAvgConfig()) == \
        jfa.upload_bits_per_client(p, jfa.FedAvgConfig())


@pytest.mark.parametrize("bits", [8])
def test_qsgd_round_matches_reference_up_to_flipped_levels(bits):
    n, s = 6, 5
    p = mlp_params_np(4)
    x, y = _batch(5, lead=(n, s))
    ids = np.asarray([3, 8, 11, 20, 21, 40])
    tcfg, jcfg = tq.QSGDConfig(bits=bits), jq.QSGDConfig(bits=bits)
    got, _ = tq.qsgd_round(params_from_jax(p, "cpu"),
                           (torch.from_numpy(x), torch.from_numpy(y)), 9,
                           tmlp.mlp_grad, tcfg, torch.from_numpy(ids))
    want, _ = jq.qsgd_round({k: jnp.asarray(v) for k, v in p.items()},
                            (jnp.asarray(x), jnp.asarray(y)), jnp.uint32(9),
                            jmlp.mlp_grad, jcfg,
                            client_ids=jnp.asarray(ids, jnp.uint32))
    # one flipped level moves an element of the mean by ‖δₙ‖/L/N
    local = jfa.make_local_sgd(jmlp.mlp_grad, jcfg.local_lr, jcfg.local_steps)
    deltas = jax.vmap(local, in_axes=(None, 0))(
        {k: jnp.asarray(v) for k, v in p.items()}, (jnp.asarray(x), jnp.asarray(y)))
    flipped = total = 0
    for k in p:
        norms = np.linalg.norm(np.asarray(deltas[k]).reshape(n, -1), axis=1)
        one_flip = norms.max() / tcfg.levels / n
        diff = np.abs(got[k].numpy() - np.asarray(want[k]))
        assert (diff <= n * one_flip + 1e-6).all(), k
        flipped += int((diff > 1e-6).sum())
        total += diff.size
    assert flipped <= 0.01 * total, (flipped, total)
    assert tq.upload_bits_per_client(params_from_jax(p, "cpu"), tcfg) == \
        jq.upload_bits_per_client(p, jcfg)


@pytest.mark.parametrize("method", ["fedavg", "qsgd"])
def test_baseline_methods_run_on_cpu(method):
    """The fedavg/qsgd methods of run_simulation: the reference's cost
    figures bit for bit, and a falling loss."""
    from repro.fed import simulation as jsim
    from repro_torch.data import load_digits, make_client_datasets
    from repro_torch.data import train_test_split_arrays
    from repro_torch.fed import simulation as tsim

    xs, ys = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(xs, ys)
    clients = make_client_datasets(xtr, ytr, 8)
    h = tsim.run_simulation(
        tsim.SimulationConfig(method=method, rounds=12, num_clients=8),
        tmlp.init_mlp(device="cpu"), clients, xte, yte, device="cpu")
    assert np.isfinite(h["loss"]).all() and h["loss"][-1] < h["loss"][0]
    jbits = (jfa.upload_bits_per_client(jmlp.init_mlp(), jfa.FedAvgConfig())
             if method == "fedavg" else
             jq.upload_bits_per_client(jmlp.init_mlp(), jq.QSGDConfig()))
    assert h["bits_per_client_per_round"] == jbits
    cm = jcm.CostModel(dataclasses.replace(jsim.SimulationConfig().channel,
                                           num_clients=8),
                       fedavg_bits_per_client=jcm.dense_upload_bits(1990),
                       rng_seed=0)
    want = np.cumsum([cm.round_cost(jbits)[1] for _ in range(12)])
    np.testing.assert_array_equal(h["cum_wall_s"], want)


# ---------------------------------------------------------------------------
# the engine, on one shared batch draw
# ---------------------------------------------------------------------------

ROUNDS, POP, PART, SHARDS, S, B = 3, 48, 0.25, 8, 5, 32


@pytest.fixture(scope="module")
def digits8():
    return digits_shards(SHARDS)


@pytest.fixture
def shared_draws(digits8, monkeypatch):
    """Patch both packages' ``draw_cohort_batches`` with one index table."""
    patch_shared_draws(monkeypatch, digits8[0], 77, ROUNDS, POP, S, B)



LOSSY = dict(channel=dict(drop_prob=0.15))
DEADLINE = dict(server=dict(deadline_s=0.0007))
DENSE_DEADLINE = dict(server=dict(deadline_s=0.7))
ENGINE_CASES = {
    "fedscalar_fori": dict(**LOSSY),
    "fedscalar_rec_route": dict(kernel_cohort_threshold=1, **DEADLINE),
    "fedscalar_rec_route_block4": dict(kernel_cohort_threshold=1,
                                       num_projections=4,
                                       projection_mode="block", **LOSSY),
    "fedscalar_fused_route": dict(projection_mode="fused_kernel", **LOSSY),
    "fedscalar_digest_replay_rec": dict(kernel_cohort_threshold=1,
                                        downlink_mode="digest",
                                        verify_replay=True, **LOSSY),
    "fedavg": dict(protocol_name="fedavg", **DENSE_DEADLINE),
    "qsgd": dict(protocol_name="qsgd", **LOSSY),
}


def _configs(case):
    kw = dict(ENGINE_CASES[case])
    ch = kw.pop("channel", {})
    sv = kw.pop("server", {})
    base = dict(rounds=ROUNDS, population=POP, participation=PART,
                client_chunk=16, **kw)
    return (tengine.RuntimeConfig(channel=tcm.ChannelConfig(**ch),
                                  server=tserver.ServerConfig(**sv), **base),
            jengine.RuntimeConfig(channel=jcm.ChannelConfig(**ch),
                                  server=jserver.ServerConfig(**sv), **base))


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_run_federation_matches_reference(case, digits8, shared_draws,
                                          jax_kernels):
    clients, xte, yte = digits8
    p = mlp_params_np(5)
    tcfg, jcfg = _configs(case)
    ht = tengine.run_federation(tcfg, params_from_jax(p, "cpu"), clients, xte,
                                yte, device="cpu")
    hj = jengine.run_federation(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                                clients, xte, yte)
    assert not ht["fused_path"] and not hj["fused_path"]
    assert ht["protocol"] == hj["protocol"]
    assert ht["bits_per_client_per_round"] == hj["bits_per_client_per_round"]
    for key in STAT_KEYS:
        np.testing.assert_array_equal(ht[key], hj[key], err_msg=key)
    assert ht["total_downlink_bits"] == hj["total_downlink_bits"]
    assert ht["downlink_stats"] == hj["downlink_stats"]
    assert ht["sampling_diagnostic"] == hj["sampling_diagnostic"]
    assert (ht["applied"] < ht["cohort_size"]).any()   # the channel bit
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    atol = 1e-6
    if case == "qsgd":
        # flipped levels: ≤ one per client and element per round, each
        # worth coeff·‖δ‖/L ≤ (1/12)·0.1/127
        atol += ROUNDS * 0.1 / 127 / 12
    for k in p:
        np.testing.assert_allclose(ht["final_params"][k].numpy(),
                                   np.asarray(hj["final_params"][k]), rtol=0,
                                   atol=atol, err_msg=k)
    if tcfg.downlink_mode == "digest":
        for a, b in zip(ht["round_log"].replay(0), hj["round_log"].replay(0)):
            np.testing.assert_array_equal(a.seeds, b.seeds)   # the cohorts
            np.testing.assert_array_equal(a.coeffs, b.coeffs)
            np.testing.assert_allclose(a.rs, b.rs, rtol=1e-5, atol=1e-7)


def test_engine_apply_routes_and_launch_free_cpu(digits8, shared_draws):
    """On the CPU no kernel launches; the route follows the threshold."""
    from repro_torch import obs

    clients, xte, yte = digits8
    p = params_from_jax(mlp_params_np(5), "cpu")
    core_cfg = tengine.RuntimeConfig(rounds=1, population=POP,
                                     participation=PART)
    proto = core_cfg.build_protocol(p)
    core = tengine.EngineCore(core_cfg, p, clients, xte, yte, tmlp.mlp_grad,
                              (tmlp.mlp_loss, tmlp.mlp_accuracy), None, proto,
                              1990, torch.device("cpu"))
    assert core.kern_thresh is None          # the CPU never takes the kernel route
    before = (obs.totals()["decode.launches"], obs.totals()["qsgd.launches"])
    tengine.run_federation(dataclasses.replace(core_cfg, protocol_name="qsgd"),
                           p, clients, xte, yte, device="cpu")
    assert (obs.totals()["decode.launches"], obs.totals()["qsgd.launches"]) == before


def test_fused_shortcut_and_digest_replay_on_cpu(digits8):
    """Full participation → run_simulation; its digests replay to its bits."""
    from repro_torch.fed.simulation import SimulationConfig, run_simulation

    clients, xte, yte = digits8
    p0 = tmlp.init_mlp(device="cpu")
    h = tengine.run_federation(
        tengine.RuntimeConfig(rounds=3, population=SHARDS, participation=1.0,
                              downlink_mode="digest", verify_replay=True),
        p0, clients, xte, yte, device="cpu")
    sim = run_simulation(SimulationConfig(rounds=3, num_clients=SHARDS), p0,
                         clients, xte, yte, device="cpu")
    assert h["fused_path"]
    np.testing.assert_array_equal(h["loss"], sim["loss"])
    for k in p0:
        assert torch.equal(h["final_params"][k], sim["final_params"][k])
    assert h["cum_downlink_bits"][-1] == 3 * tcm.digest_downlink_bits(
        SHARDS, 1, include_coeffs=False)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(scheduler=tsched.SchedulerConfig(mode="async"),
          server=tserver.ServerConfig(max_staleness=1)), ValueError,
     "competing"),
    (dict(mesh_shape=(1, 1), protocol_name="fedavg"), ValueError, "mesh_shape"),
    (dict(mesh_shape=(1, 1), protocol_name="qsgd"), ValueError, "mesh_shape"),
    (dict(downlink_mode="digest", protocol_name="fedavg"), ValueError, "digest"),
    (dict(verify_replay=True), ValueError, "verify_replay"),
    (dict(downlink_mode="bogus"), ValueError, "downlink_mode"),
])
def test_run_federation_refuses_what_it_cannot_do(kw, exc, match, digits8):
    clients, xte, yte = digits8
    with pytest.raises(exc, match=match):
        tengine.run_federation(tengine.RuntimeConfig(rounds=1, population=16,
                                                     participation=0.5, **kw),
                               tmlp.init_mlp(device="cpu"), clients, xte, yte,
                               device="cpu")


def test_batch_draw_is_a_pure_function_of_round_and_client(digits8):
    from repro_torch.fed.simulation import _stack_clients

    cx, cy = (torch.from_numpy(np.asarray(a)) for a in
              _stack_clients(digits8[0]))
    ids = torch.tensor([3, 17, 40])
    bx, by = tengine.draw_cohort_batches(cx, cy, SHARDS, 0, 2, ids, S, B)
    bx2, by2 = tengine.draw_cohort_batches(cx, cy, SHARDS, 0, 2, ids[1:], S, B)
    assert bx.shape == (3, S, B, 64) and by.shape == (3, S, B)
    assert torch.equal(bx[1:], bx2) and torch.equal(by[1:], by2)
    bx3, _ = tengine.draw_cohort_batches(cx, cy, SHARDS, 0, 3, ids, S, B)
    assert not torch.equal(bx, bx3)
