"""Port parity of the protocols' Table-I bit counts and the baseline sweeps.

* Every protocol's ``bits_per_upload``, payload width, queue entry and
  dense downlink equal the reference's exactly (numpy cost formulas on
  both sides); FedScalar's frame stays 64 bits at every d while FedAvg
  and QSGD grow as Θ(d).
* One qsgd frame, through the wire, decodes to exactly the client's own
  round trip (``quantize_tree``), as in the reference.
* ``baseline_tradeoff`` / ``downlink_tradeoff`` at a tiny size (2 rounds,
  one narrow MLP): every cost column equals the reference's bit for bit,
  since the channel draws are the same numpy stream.  Accuracy columns
  follow each package's own batch draw (the reference draws with
  threefry), so they are only checked to be accuracies.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.fed import baselines as jbl  # noqa: E402
from repro.fed import protocols as jpr  # noqa: E402
from repro.models.mlp_classifier import init_mlp as j_init_mlp  # noqa: E402
from repro_torch.core import qsgd as tq  # noqa: E402
from repro_torch.fed import baselines as tbl  # noqa: E402
from repro_torch.fed import protocols as tpr  # noqa: E402
from repro_torch.fed.runtime import engine as tengine  # noqa: E402
from repro_torch.models.mlp_classifier import init_mlp  # noqa: E402

SIZES = [(64, 24, 12, 10), (64, 48, 24, 10), (64, 128, 10)]


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("name", ["fedscalar", "fedavg", "qsgd"])
def test_table1_bits_match_reference(sizes, name):
    from repro.fed.runtime import engine as jengine

    pt = init_mlp(sizes=sizes, device="cpu")
    pj = j_init_mlp(sizes=sizes)
    for kw in (dict(), dict(scalar_format="bf16", num_projections=4,
                            qsgd_bits=4)):
        a = tengine.RuntimeConfig(protocol_name=name, **kw).build_protocol(pt)
        b = jengine.RuntimeConfig(protocol_name=name, **kw).build_protocol(pj)
        assert type(a).__name__ == type(b).__name__
        assert a.upload_bits == b.upload_bits
        assert a.payload_dim == b.payload_dim
        assert a.queue_entry_bytes == b.queue_entry_bytes
        assert a.downlink_bits(1990) == b.downlink_bits(1990)
        assert a.downlink_modes == b.downlink_modes
        assert a.wire_codec.bytes_per_upload == b.wire_codec.bytes_per_upload
    d = sum(v.numel() for v in pt.values())
    bits = tpr.make_protocol(name, pt).upload_bits
    assert bits == {"fedscalar": 64, "fedavg": 32 * d,
                    "qsgd": 8 * d + 32 * len(pt)}[name]


def test_registry_and_digest_codecs():
    pt = init_mlp(device="cpu")
    assert sorted(tpr.PROTOCOLS) == sorted(jpr.PROTOCOLS)
    with pytest.raises(ValueError, match="unknown protocol"):
        tpr.make_protocol("signsgd", pt)
    fs = tpr.make_protocol("fedscalar", pt)
    assert fs.digest_codec() == tpr.DigestCodec(1)
    for name in ("fedavg", "qsgd"):
        with pytest.raises(ValueError, match="no digest downlink"):
            tpr.make_protocol(name, pt).digest_codec()
    # a mesh routes to the sharded decode: the decode kernel's bits
    from repro_torch.launch.mesh import make_fed_mesh
    rs, seeds = torch.ones(3, 1), torch.tensor([5, 6, 7])
    on_mesh = fs.server_apply(pt, rs, seeds, None,
                              mesh=make_fed_mesh((2, 4), device="cpu"))
    kernel = fs.server_apply(pt, rs, seeds, None, use_kernel=True)
    for k in pt:
        assert torch.equal(on_mesh[k], kernel[k])


def test_qsgd_frame_decodes_to_the_client_round_trip():
    pt = init_mlp(seed=3, device="cpu")
    delta = {k: torch.from_numpy(np.random.RandomState(v.numel()).randn(
        *v.shape).astype(np.float32) * 0.01) for k, v in pt.items()}
    proto = tpr.make_protocol("qsgd", pt)
    payload = proto.client_payload(delta, 0xBEEF)
    batched = proto.encode_cohort({k: v[None] for k, v in delta.items()}, None,
                                  0, torch.tensor([0]))
    # the batched encode keys its stream by (round, id): same as quant_seeds
    seed = int(tq.quant_seeds(0, torch.tensor([0]))[0])
    assert torch.equal(batched[0], proto.client_payload(delta, seed))
    buf = proto.wire_codec.encode(payload.numpy(), 0)
    decoded, _ = proto.wire_codec.decode(buf)
    np.testing.assert_array_equal(decoded, payload.numpy())
    new = proto.server_apply(pt, torch.from_numpy(decoded)[None, :], None, None)
    q_rt = tq.quantize_tree(delta, 0xBEEF, 8)
    for k in pt:
        assert torch.equal(new[k], pt[k] + 1.0 * q_rt[k]), k


def test_fedavg_frame_and_dense_applies():
    pt = init_mlp(seed=4, device="cpu")
    proto = tpr.make_protocol("fedavg", pt)
    rng = np.random.RandomState(0)
    deltas = {k: torch.from_numpy(rng.randn(3, *v.shape).astype(np.float32))
              for k, v in pt.items()}
    frames = proto.encode_cohort(deltas, None, 0, None)
    assert frames.shape == (3, proto.payload_dim)
    one = proto.client_payload({k: v[1] for k, v in deltas.items()}, 0)
    assert torch.equal(frames[1], one)
    mean = proto.server_apply(pt, frames, None, None)
    w = torch.tensor([0.5, 0.25, 0.25])
    weighted = proto.server_apply(pt, frames, None, w)
    for k in pt:
        assert torch.equal(mean[k], pt[k] + torch.mean(deltas[k], dim=0))
        torch.testing.assert_close(
            weighted[k], pt[k] + (deltas[k] * w.reshape(-1, *[1] * pt[k].dim())
                                  ).sum(0))


COST_COLUMNS = ("protocol", "access", "d", "bits_per_client_per_round",
                "rounds", "total_uplink_bits", "total_downlink_bits",
                "total_traffic_bits", "total_wall_s", "total_energy_j")
DL_COST_COLUMNS = ("protocol", "downlink", "d", "rounds",
                   "uplink_bits_per_client_per_round", "downlink_bits_per_round",
                   "round_traffic_bits", "total_uplink_bits",
                   "total_downlink_bits", "total_traffic_bits", "total_wall_s",
                   "total_energy_j")


def test_baseline_tradeoff_costs_match_reference(tmp_path):
    kw = dict(rounds=2, hidden_sizes=((6, 5),), num_clients=4)
    rows = tbl.baseline_tradeoff(device="cpu", **kw)
    want = jbl.baseline_tradeoff(**kw)
    assert len(rows) == len(want) == 6
    for a, b in zip(rows, want):
        assert {c: a[c] for c in COST_COLUMNS} == {c: b[c] for c in COST_COLUMNS}
        assert 0.0 <= a["final_accuracy"] <= 1.0
    path = tbl.write_tradeoff_csv(rows, str(tmp_path / "t.csv"))
    lines = open(path).read().splitlines()
    assert lines[0] == ",".join(tbl.TRADEOFF_COLUMNS) and len(lines) == 7
    assert tbl.TRADEOFF_COLUMNS == jbl.TRADEOFF_COLUMNS
    assert not tbl.TRADEOFF_CSV.startswith("experiments/")


def test_downlink_tradeoff_costs_match_reference(tmp_path):
    kw = dict(rounds=2, hidden_sizes=((6, 5),), num_clients=4)
    rows = tbl.downlink_tradeoff(device="cpu", **kw)
    want = jbl.downlink_tradeoff(**kw)
    assert len(rows) == len(want) == 4
    for a, b in zip(rows, want):
        assert ({c: a[c] for c in DL_COST_COLUMNS}
                == {c: b[c] for c in DL_COST_COLUMNS})
    digest = [r for r in rows if r["downlink"] == "digest"][0]
    dense = [r for r in rows if r["protocol"] == "fedscalar"
             and r["downlink"] == "dense"][0]
    assert digest["round_traffic_bits"] < dense["round_traffic_bits"]
    path = tbl.write_downlink_csv(rows, str(tmp_path / "dl.csv"))
    assert len(open(path).read().splitlines()) == 5
    assert tbl.DOWNLINK_COLUMNS == jbl.DOWNLINK_COLUMNS
    assert not tbl.DOWNLINK_CSV.startswith("experiments/")


def test_reference_bits_are_jnp_independent():
    """The Table-I formulas need no device: the reference's own numbers."""
    pj = {k: jnp.asarray(v) for k, v in j_init_mlp().items()}
    assert jpr.make_protocol("qsgd", pj).upload_bits == \
        tpr.make_protocol("qsgd", init_mlp(device="cpu")).upload_bits
