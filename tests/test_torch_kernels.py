"""Port parity of the two kernels' plain versions against the reference.

* Encode: ``project_blocks_plain`` against the reference's Pallas
  ``projection_blocks_kernel_call`` in interpret mode.  The sum order is
  open: |Δr| ≤ 1e-6·Σ|x|·max|v| (max|v| = 1, 2 for sparse, 6.7 for
  gaussian, the largest Box–Muller value from 32-bit uniforms).  The
  card's check, ``encode_tolerance`` against the plain version summed in
  float64, is shown to admit float32 rounding and to reject a lost row.
* Fused close: ``ops.server_update_fused`` (plain on the CPU) against
  ``repro.kernels.ref.server_update_fused_ref`` and the reference's jnp
  mirror.  Bitwise for the ±1/±2 families; gaussian within rtol 1e-5 /
  atol 1e-5, because ``log``/``cos`` ulps in v are scaled by the summed
  scalars.  The reference's interpret-mode Pallas kernel is not used as
  an oracle here: under jax 0.9 it differs from its own mirror and
  oracle by up to 1.2e-7.

* Per-client decode (``_rec``): the plain version against the reference's
  Pallas ``reconstruct_kernel_call`` in interpret mode.  The sum over
  blocks and clients is bitwise for the ±1/±2 families; the reference's
  final ``x + scale·acc`` is contracted into one fused multiply-add by
  XLA on the CPU, so the port (two roundings, as its CUDA kernel does)
  is held bitwise against that FMA, emulated in float64 from the port's
  own sum, and within 2⁻²³·(|y| + |scale·acc|) of the reference itself.  Gaussian within
  rtol/atol 1e-5.  ``ops.server_update_kernel`` against the reference's
  fori oracle ``ref.server_update_ref`` with ``allclose`` (rtol 1e-5,
  atol 1e-6: the oracle takes p + lr·(Σ/n)).
* QSGD: the plain version against ``repro.core.qsgd`` with the
  reference's norms injected, bitwise (levels and round trip), and the
  port's ``ops.qsgd_roundtrip_kernel`` against its longhand oracle
  ``ref.qsgd_roundtrip_ref``, bitwise.  The reference's interpret-mode
  QSGD kernel differs from its own core quantizer by an ulp of q and is
  held within 1 ulp.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.prng import Distribution as JD  # noqa: E402
from repro.core.prng import block_seed as j_block_seed  # noqa: E402
from repro.core.projection import ProjectionMode as JM  # noqa: E402
from repro.kernels.seeded_projection import projection_blocks_kernel_call  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.prng import Distribution as TD  # noqa: E402
from repro_torch.core.projection import ProjectionMode as TM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.qsgd_quant import qsgd_quantize, qsgd_quantize_plain  # noqa: E402
from repro_torch.kernels.reconstruct_apply import fused_reconstruct_apply  # noqa: E402
from repro_torch.kernels.seeded_reconstruct import (  # noqa: E402
    reconstruct_apply_clients,
    reconstruct_plain,
)
from repro_torch.kernels.seeded_projection import (  # noqa: E402
    encode_tolerance,
    project_blocks,
    project_blocks_plain,
)
from torch_parity import (  # noqa: E402,F401
    Elsewhere,
    jax_kernels,
    mlp_params_np,
    seeds_np,
)

FAMILIES = ["rademacher", "gaussian", "sparse_rademacher", "hadamard"]
VMAX = {"rademacher": 1.0, "hadamard": 1.0, "sparse_rademacher": 2.0,
        "gaussian": 6.7}
MLP_SHAPES = [(24,), (12,), (10,), (64, 24), (24, 12), (12, 10)]
MODES = [(1, "full"), (8, "full"), (8, "block")]


def _view2(shape):
    return (1, shape[0]) if len(shape) == 1 else shape


def _bounds(offset, size, total, k, mode):
    lo, hi = ops.leaf_block_bounds(offset, size, total, k, TM(mode))
    return np.asarray(lo, np.float32), np.asarray(hi, np.float32)


def _jax_encode(x2d, seed, tag, lo, hi, family, masked, row_offset=0,
                col_offset=0):
    rows, cols = x2d.shape
    br, bc = min(256, -(-rows // 8) * 8), min(512, -(-cols // 128) * 128)
    xp = np.zeros((-(-rows // br) * br, -(-cols // bc) * bc), np.float32)
    xp[:rows, :cols] = x2d
    seeds = jnp.stack([j_block_seed(seed, j) for j in range(len(lo))])
    return np.asarray(projection_blocks_kernel_call(
        jnp.asarray(xp), seeds, tag, jnp.asarray(lo), jnp.asarray(hi), family,
        (br, bc), row_offset, col_offset, orig_cols=cols, interpret=True,
        masked=masked))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", MODES)
def test_encode_plain_matches_reference_kernel(family, k, mode):
    rng = np.random.RandomState(k + len(family))
    total = sum(int(np.prod(s)) for s in MLP_SHAPES)
    masked = mode == "block" and k > 1
    offset = 0
    for tag, shape in enumerate(MLP_SHAPES):
        rows, cols = _view2(shape)
        x = rng.randn(1, rows, cols).astype(np.float32)
        seeds = seeds_np(rng, 1)
        lo, hi = _bounds(offset, rows * cols, total, k, mode)
        got = project_blocks_plain(
            torch.from_numpy(x), torch.from_numpy(seeds.astype(np.int64)), tag,
            torch.from_numpy(lo), torch.from_numpy(hi), family, masked).numpy()
        assert got.shape == (1, k) and got.dtype == np.float32
        want = _jax_encode(x[0], int(seeds[0]), tag, lo, hi, family, masked)
        tol = 1e-6 * np.abs(x).sum() * VMAX[family]
        assert np.abs(got[0] - want).max() <= tol, shape
        offset += rows * cols


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("masked", [False, True])
def test_encode_plain_row_col_offsets(family, masked):
    """Runtime row/col offsets shift the coordinates exactly as the reference's."""
    rng = np.random.RandomState(7)
    x = rng.randn(1, 9, 40).astype(np.float32)
    lo = np.asarray([0.0, 200.0, 5000.0], np.float32)
    hi = np.asarray([200.0, 5000.0, 9000.0], np.float32)
    got = project_blocks_plain(torch.from_numpy(x), torch.tensor([4242]), 3,
                               torch.from_numpy(lo), torch.from_numpy(hi),
                               family, masked, row_offset=100, col_offset=17,
                               orig_cols=57).numpy()
    xp = np.zeros((16, 128), np.float32)
    xp[:9, :40] = x[0]
    seeds = jnp.stack([j_block_seed(4242, j) for j in range(3)])
    want = np.asarray(projection_blocks_kernel_call(
        jnp.asarray(xp), seeds, 3, jnp.asarray(lo), jnp.asarray(hi), family,
        (16, 128), 100, 17, orig_cols=57, interpret=True, masked=masked))
    tol = 1e-6 * np.abs(x).sum() * VMAX[family]
    assert np.abs(got[0] - want).max() <= tol


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("shape", [(1, 24), (64, 24), (300, 700)])
def test_encode_tolerance_admits_rounding_but_not_a_dropped_row(family, shape):
    """The kernel check's tolerance: float32 rounding fits, one lost row does not."""
    rng = np.random.RandomState(len(family) + shape[0])
    rows, cols = shape
    x = torch.from_numpy(rng.randn(8, rows, cols).astype(np.float32))
    seeds = torch.from_numpy(seeds_np(rng, 8).astype(np.int64))
    lo, hi = torch.zeros(1), torch.tensor([float(rows * cols)])
    exact = project_blocks_plain(x, seeds, 2, lo, hi, family, dtype=torch.float64)
    assert exact.dtype == torch.float64
    tol = encode_tolerance(x, family)
    r32 = project_blocks_plain(x, seeds, 2, lo, hi, family)
    assert ((r32.double() - exact).abs() <= tol).all()
    dropped = x.clone()
    dropped[:, rows // 2] = 0.0
    r_drop = project_blocks_plain(dropped, seeds, 2, lo, hi, family)
    assert ((r_drop.double() - exact).abs() > tol).all()


def _fused_case(jk, family, n, k, mode, weights, block_weights, seed):
    rng = np.random.RandomState(seed)
    p = mlp_params_np(seed)
    rs = rng.randn(n, k).astype(np.float32)
    seeds = seeds_np(rng, n)
    w = rng.rand(n).astype(np.float32) if weights else None
    bw = np.linspace(0.4, 1.0, k).astype(np.float32) if block_weights else None
    pj = {key: jnp.asarray(v) for key, v in p.items()}
    jargs = dict(weights=None if w is None else jnp.asarray(w),
                 block_weights=None if bw is None else jnp.asarray(bw))
    oracle = jk.ref.server_update_fused_ref(
        pj, jnp.asarray(rs), jnp.asarray(seeds), 0.7, JD(family), k, JM(mode),
        **jargs)
    mirror = jk.ops.server_update_fused(
        pj, jnp.asarray(rs), jnp.asarray(seeds), 0.7, JD(family), mode=JM(mode),
        use_pallas=False, **jargs)
    got = ops.server_update_fused(
        params_from_jax(p, "cpu"), torch.from_numpy(rs),
        torch.from_numpy(seeds.astype(np.int64)), 0.7, TD(family),
        weights=None if w is None else torch.from_numpy(w), mode=TM(mode),
        block_weights=None if bw is None else torch.from_numpy(bw))
    return p, oracle, mirror, got


def _assert_fused(family, p, want, got):
    for key in p:
        a, b = np.asarray(want[key]), got[key].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if family == "gaussian":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)


# (n, k, mode, weights, block_weights): cohorts below, at and above one
# 16-client chunk, k ∈ {1, FULL 8, BLOCK 8}, with and without weights.
FUSED_CASES = [(5, 1, "full", False, False), (40, 1, "full", False, False),
               (16, 1, "full", True, False), (5, 8, "full", False, True),
               (16, 8, "block", True, True)]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n,k,mode,weights,block_weights", FUSED_CASES)
def test_fused_plain_matches_reference_oracle_and_mirror(
        jax_kernels, family, n, k, mode, weights, block_weights):
    p, oracle, mirror, got = _fused_case(jax_kernels, family, n, k, mode,
                                         weights, block_weights, seed=n + k)
    _assert_fused(family, p, oracle, got)
    _assert_fused(family, p, mirror, got)


@pytest.mark.parametrize("family", FAMILIES)
def test_fused_leaf_offsets_match_reference_mirror(jax_kernels, family):
    """Runtime row/col offsets and masks: leaf-level call against the mirror."""
    rng = np.random.RandomState(11)
    x = rng.randn(7, 33).astype(np.float32)
    rs = rng.randn(21, 3).astype(np.float32)
    seeds = seeds_np(rng, 21)
    lo = np.asarray([0.0, 900.0, 2000.0], np.float32)
    hi = np.asarray([900.0, 2000.0, 4000.0], np.float32)
    want = np.asarray(jax_kernels.reconstruct_apply.fused_reconstruct_apply(
        jnp.asarray(x), jnp.asarray(seeds), jnp.asarray(rs), 4, 0.25, family,
        row_offset=30, col_offset=5, lo=jnp.asarray(lo), hi=jnp.asarray(hi),
        orig_cols=61, masked=True, use_pallas=False))
    got = fused_reconstruct_apply(
        torch.from_numpy(x), torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(rs), 4, 0.25, family, lo=torch.from_numpy(lo),
        hi=torch.from_numpy(hi), masked=True, row_offset=30, col_offset=5,
        orig_cols=61).numpy()
    if family == "gaussian":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_port_oracle_matches_plain_fused(family):
    """The port's longhand oracle (core generator) ≡ its factored plain path."""
    rng = np.random.RandomState(3)
    p = params_from_jax(mlp_params_np(3), "cpu")
    for n, (k, mode) in zip((19, 5, 9), MODES):
        rs = torch.from_numpy(rng.randn(n, k).astype(np.float32))
        seeds = torch.from_numpy(seeds_np(rng, n).astype(np.int64))
        a = ref.server_update_fused_ref(p, rs, seeds, 1.3, TD(family), k,
                                        TM(mode))
        b = ops.server_update_fused(p, rs, seeds, 1.3, TD(family),
                                    mode=TM(mode))
        for key in p:
            torch.testing.assert_close(b[key], a[key], rtol=0, atol=0)


@pytest.mark.parametrize("k,mode", MODES)
def test_fold_upload_weights_bitwise(jax_kernels, k, mode):
    rng = np.random.RandomState(k)
    rs = rng.randn(13, k).astype(np.float32)
    w = rng.rand(13).astype(np.float32)
    bw = rng.rand(k).astype(np.float32)
    for weights, block_weights in ((None, None), (w, None), (None, bw), (w, bw)):
        jr, js = jax_kernels.ops.fold_upload_weights(
            jnp.asarray(rs), 0.9, None if weights is None else jnp.asarray(weights),
            JM(mode), None if block_weights is None else jnp.asarray(block_weights))
        tr, ts = ops.fold_upload_weights(
            torch.from_numpy(rs), 0.9,
            None if weights is None else torch.from_numpy(weights), TM(mode),
            None if block_weights is None else torch.from_numpy(block_weights))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        assert ts == js
    total = 1990
    for off, size in ((0, 24), (70, 1536), (1606, 288)):
        assert ops.leaf_block_bounds(off, size, total, k, TM(mode)) == \
            jax_kernels.ops.leaf_block_bounds(off, size, total, k, JM(mode))


def test_wrappers_reject_other_devices():
    """A device that is not a card, the CPU or ``meta`` (the dry run's, which
    the wrappers take) is refused."""
    with pytest.raises(ValueError, match="unsupported device"):
        project_blocks(Elsewhere((1, 2, 3)), torch.zeros(1, dtype=torch.int64), 0,
                       torch.zeros(1), torch.ones(1))
    meta = project_blocks(torch.zeros((1, 2, 3), device="meta"),
                          torch.zeros(1, dtype=torch.int64, device="meta"), 0,
                          torch.zeros(1, device="meta"), torch.ones(1, device="meta"))
    assert meta.is_meta and meta.shape == (1, 1)


# ---------------------------------------------------------------------------
# per-client decode (_rec_kernel) and QSGD (_qsgd_kernel)
# ---------------------------------------------------------------------------

# (rows, cols, n, k, mode, row_offset, col_offset): a ragged last client
# chunk (33 = 32 + 1), BLOCK masks, FULL k = 8, runtime offsets.
REC_CASES = [(64, 24, 33, 8, "block", 0, 0), (24, 12, 45, 8, "full", 0, 0),
             (7, 40, 20, 3, "block", 30, 5)]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("rows,cols,n,k,mode,ro,co", REC_CASES)
def test_rec_plain_matches_reference_kernel(jax_kernels, family, rows, cols, n,
                                            k, mode, ro, co):
    from repro.kernels.seeded_reconstruct import reconstruct_kernel_call

    rng = np.random.RandomState(rows + n)
    masked = mode == "block"
    x = rng.randn(rows, cols).astype(np.float32)
    seeds = seeds_np(rng, n)
    rs = rng.randn(n, k).astype(np.float32)
    orig_cols = cols + 3 if ro or co else cols
    lo, hi = _bounds(100, rows * orig_cols, 3 * rows * orig_cols, k, mode)
    scale = 0.05
    br, bc = -(-rows // 8) * 8, -(-cols // 128) * 128
    xp = np.zeros((br, bc), np.float32)
    xp[:rows, :cols] = x
    want = np.asarray(reconstruct_kernel_call(
        jnp.asarray(xp), jnp.asarray(seeds), jnp.asarray(rs), 6, scale, family,
        (br, bc), ro, co, interpret=True, lo=jnp.asarray(lo),
        hi=jnp.asarray(hi), orig_cols=orig_cols, masked=masked))[:rows, :cols]
    args = (torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(rs), 6)
    bounds = (torch.from_numpy(lo), torch.from_numpy(hi), family, masked, ro,
              co, orig_cols)
    got = reconstruct_plain(torch.from_numpy(x), *args, scale, *bounds).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if family == "gaussian":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    acc = reconstruct_plain(torch.zeros(rows, cols), *args, 1.0, *bounds)
    fma = (x.astype(np.float64) + float(np.float32(scale))
           * acc.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(fma, want)
    # two roundings against one: |Δ| ≤ ulp-scale of the result and the product
    bound = 2.0 ** -23 * (np.abs(want) + np.abs(np.float32(scale) * acc.numpy()))
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n,k,mode,weights", [(40, 1, "full", True),
                                              (33, 8, "block", True)])
def test_server_update_kernel_matches_fori_oracle(family, n, k, mode, weights):
    from repro.core import fedscalar as jfs

    rng = np.random.RandomState(n + k)
    p = mlp_params_np(n)
    rs = rng.randn(n, k).astype(np.float32)
    seeds = seeds_np(rng, n)
    w = rng.rand(n).astype(np.float32) if weights else None
    got = ops.server_update_kernel(
        params_from_jax(p, "cpu"), torch.from_numpy(rs),
        torch.from_numpy(seeds.astype(np.int64)), 0.7, TD(family),
        weights=None if w is None else torch.from_numpy(w), mode=TM(mode))
    cfg = jfs.FedScalarConfig(server_lr=0.7, distribution=JD(family),
                              num_projections=k, mode=JM(mode))
    want = jfs.server_aggregate({key: jnp.asarray(v) for key, v in p.items()},
                                jnp.asarray(rs), jnp.asarray(seeds), cfg,
                                weights=None if w is None else jnp.asarray(w))
    for key in p:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_port_fori_oracle_is_server_aggregate():
    """``ref.server_update_ref`` is the per-client fori loop; the decode
    kernel's plain path agrees with it as the reference's kernel does."""
    rng = np.random.RandomState(2)
    p = params_from_jax(mlp_params_np(2), "cpu")
    rs = torch.from_numpy(rng.randn(5, 1).astype(np.float32))
    seeds = torch.from_numpy(seeds_np(rng, 5).astype(np.int64))
    a = ref.server_update_ref(p, rs, seeds, 0.7)
    b = ops.server_update_kernel(p, rs, seeds, 0.7)
    from repro_torch.core.fedscalar import FedScalarConfig, server_aggregate

    c = server_aggregate(p, rs, seeds, FedScalarConfig(server_lr=0.7))
    for key in p:
        assert torch.equal(a[key], c[key])
        torch.testing.assert_close(b[key], a[key], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(1, 10), (64, 24), (300, 70)])
def test_qsgd_plain_matches_reference_quantizer(bits, shape):
    """Cohort call of the plain version ≡ the reference per client, given its norms."""
    from repro.core import qsgd as jq
    from repro.core.prng import fold_seed as j_fold_seed

    rng = np.random.RandomState(bits * 7 + shape[0])
    n, levels, tag = 5, (1 << (bits - 1)) - 1, 4
    x = (rng.randn(n, *shape) * 0.02).astype(np.float32)
    x[1] = 0.0                                   # a zero leaf: norm → 1
    seeds = seeds_np(rng, n)
    want_l, want_n = [], []
    for i in range(n):
        lv, nm = jq.quantize_levels(jnp.asarray(x[i]), jnp.uint32(seeds[i]),
                                    levels, tag)
        want_l.append(np.asarray(lv))
        want_n.append(float(nm))
    folded = np.asarray([int(j_fold_seed(jnp.uint32(s), tag)) for s in seeds])
    q, lv = qsgd_quantize(torch.from_numpy(x), torch.from_numpy(folded),
                          torch.tensor(want_n, dtype=torch.float32), levels,
                          True, True)
    assert torch.equal(lv, torch.from_numpy(np.stack(want_l)))
    for i in range(n):
        want_q = jq.quantize_leaf(jnp.asarray(x[i]), jnp.uint32(seeds[i]), levels,
                                  tag)
        np.testing.assert_array_equal(q[i].numpy(), np.asarray(want_q))
    assert float(lv[1].abs().sum()) == 0.0 and want_n[1] == 1.0
    q2, lv2 = qsgd_quantize_plain(torch.from_numpy(x), torch.from_numpy(folded),
                                  torch.tensor(want_n), levels, False, True)
    assert q2 is None and torch.equal(lv2, lv)


@pytest.mark.parametrize("bits", [4, 8])
def test_qsgd_roundtrip_kernel_matches_oracles(jax_kernels, bits):
    rng = np.random.RandomState(bits)
    tree = {"w": (rng.randn(64, 24) * 0.01).astype(np.float32),
            "b": (rng.randn(24) * 0.01).astype(np.float32)}
    tt = params_from_jax(tree, "cpu")
    got = ops.qsgd_roundtrip_kernel(tt, 11, bits)
    port_oracle = ref.qsgd_roundtrip_ref(tt, 11, bits)
    ref_core = jax_kernels.ref.qsgd_roundtrip_ref(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.uint32(11), bits)
    ref_kernel = jax_kernels.ops.qsgd_roundtrip_kernel(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.uint32(11), bits,
        interpret=True)
    for k in tree:
        assert torch.equal(got[k], port_oracle[k]), k
        a, b = got[k].numpy(), np.asarray(ref_kernel[k])
        assert (np.abs(a - b) <= np.spacing(np.abs(b))).all(), k
        # the norms may differ by ulps: levels may flip, each by ‖x‖/L
        bound = np.linalg.norm(tree[k]) / ((1 << (bits - 1)) - 1)
        assert (np.abs(a - np.asarray(ref_core[k])) <= bound + 1e-9).all(), k


def test_new_wrappers_reject_other_devices_and_bad_requests():
    with pytest.raises(ValueError, match="unsupported device"):
        reconstruct_apply_clients(Elsewhere((2, 3)), torch.zeros(1, dtype=torch.int64),
                                  torch.zeros(1, 1), 0, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        qsgd_quantize(Elsewhere((1, 2, 3)), torch.zeros(1, dtype=torch.int64),
                      torch.ones(1), 127)
    with pytest.raises(ValueError, match="ask for"):
        qsgd_quantize(torch.zeros((1, 2, 3)), torch.zeros(1, dtype=torch.int64),
                      torch.ones(1), 127, want_q=False, want_levels=False)
    with pytest.raises(ValueError, match="lo/hi"):
        reconstruct_apply_clients(torch.zeros(2, 3), torch.zeros(1, dtype=torch.int64),
                                  torch.zeros(1, 2), 0, 1.0, masked=True)


# ---------------------------------------------------------------------------
# bf16 leaves: the TPU kernels read x.astype(float32) and write o_ref.dtype,
# and so do the port's plain versions (the CUDA kernels' specs).  Held
# against the reference's kernels in interpret mode on bf16 inputs, with
# the float32 cases' rules: the encode within 1e-6·Σ|x|·max|v|; the fused
# close bitwise against the reference's oracle and mirror (gaussian within
# one bf16 ulp, 2⁻⁷·|y|, plus 1e-5); the decode bitwise against the
# reference kernel's FMA emulated from the port's own sum, then rounded to
# bf16 (gaussian within one bf16 ulp plus 1e-5); QSGD's q (bf16) and
# levels bitwise against ``repro.core.qsgd`` given its norms.
# ---------------------------------------------------------------------------

def _bf16(a):
    """numpy float32 → (bf16 torch tensor, its float32 values as numpy)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t, t.to(torch.float32).numpy()


def _bf16_ulp_close(got, want):
    got = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-5).all()


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", MODES)
def test_encode_plain_bf16_matches_reference_kernel(family, k, mode):
    rng = np.random.RandomState(k + len(family) + 50)
    total = sum(int(np.prod(s)) for s in MLP_SHAPES)
    masked = mode == "block" and k > 1
    offset = 0
    for tag, shape in enumerate(MLP_SHAPES):
        rows, cols = _view2(shape)
        xt, xv = _bf16(rng.randn(1, rows, cols))
        seeds = seeds_np(rng, 1)
        lo, hi = _bounds(offset, rows * cols, total, k, mode)
        got = project_blocks_plain(
            xt, torch.from_numpy(seeds.astype(np.int64)), tag,
            torch.from_numpy(lo), torch.from_numpy(hi), family, masked).numpy()
        assert got.dtype == np.float32
        br, bc = min(256, -(-rows // 8) * 8), min(512, -(-cols // 128) * 128)
        xp = np.zeros((-(-rows // br) * br, -(-cols // bc) * bc), np.float32)
        xp[:rows, :cols] = xv[0]
        jseeds = jnp.stack([j_block_seed(int(seeds[0]), j) for j in range(k)])
        want = np.asarray(projection_blocks_kernel_call(
            jnp.asarray(xp, jnp.bfloat16), jseeds, tag, jnp.asarray(lo),
            jnp.asarray(hi), family, (br, bc), orig_cols=cols, interpret=True,
            masked=masked))
        tol = 1e-6 * np.abs(xv).sum() * VMAX[family]
        assert np.abs(got[0] - want).max() <= tol, shape
        offset += rows * cols


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n,k,mode", [(40, 1, "full"), (16, 8, "block")])
def test_fused_plain_bf16_matches_reference_oracle_and_mirror(jax_kernels, family,
                                                             n, k, mode):
    rng = np.random.RandomState(n + k + 60)
    p = {key: jnp.asarray(v, jnp.bfloat16) for key, v in mlp_params_np(n).items()}
    rs = rng.randn(n, k).astype(np.float32)
    seeds = seeds_np(rng, n)
    args = (jnp.asarray(rs), jnp.asarray(seeds), 0.7, JD(family))
    oracle = jax_kernels.ref.server_update_fused_ref(p, *args, k, JM(mode))
    mirror = jax_kernels.ops.server_update_fused(p, *args, mode=JM(mode),
                                                 use_pallas=False)
    got = ops.server_update_fused(
        params_from_jax({key: np.asarray(v) for key, v in p.items()}, "cpu"),
        torch.from_numpy(rs), torch.from_numpy(seeds.astype(np.int64)), 0.7,
        TD(family), mode=TM(mode))
    for want in (oracle, mirror):
        for key in p:
            assert got[key].dtype == torch.bfloat16
            w = np.array(want[key])
            if family == "gaussian":
                _bf16_ulp_close(got[key], w.astype(np.float32))
            else:
                np.testing.assert_array_equal(got[key].view(torch.int16).numpy(),
                                              w.view(np.int16), err_msg=key)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("rows,cols,n,k,mode,ro,co", REC_CASES)
def test_rec_plain_bf16_matches_reference_kernel(jax_kernels, family, rows, cols,
                                                 n, k, mode, ro, co):
    from repro.kernels.seeded_reconstruct import reconstruct_kernel_call

    rng = np.random.RandomState(rows + n + 70)
    masked = mode == "block"
    xt, xv = _bf16(rng.randn(rows, cols))
    seeds = seeds_np(rng, n)
    rs = rng.randn(n, k).astype(np.float32)
    orig_cols = cols + 3 if ro or co else cols
    lo, hi = _bounds(100, rows * orig_cols, 3 * rows * orig_cols, k, mode)
    scale = 0.05
    br, bc = -(-rows // 8) * 8, -(-cols // 128) * 128
    xp = np.zeros((br, bc), np.float32)
    xp[:rows, :cols] = xv
    want = np.array(reconstruct_kernel_call(
        jnp.asarray(xp, jnp.bfloat16), jnp.asarray(seeds), jnp.asarray(rs), 6,
        scale, family, (br, bc), ro, co, interpret=True, lo=jnp.asarray(lo),
        hi=jnp.asarray(hi), orig_cols=orig_cols, masked=masked))[:rows, :cols]
    args = (torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(rs), 6)
    bounds = (torch.from_numpy(lo), torch.from_numpy(hi), family, masked, ro,
              co, orig_cols)
    got = reconstruct_plain(xt, *args, scale, *bounds)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    if family == "gaussian":
        _bf16_ulp_close(got, want.astype(np.float32))
        return
    acc = reconstruct_plain(torch.zeros(rows, cols), *args, 1.0, *bounds)
    fma = (xv.astype(np.float64) + float(np.float32(scale))
           * acc.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(
        torch.from_numpy(fma).to(torch.bfloat16).view(torch.int16).numpy(),
        want.view(np.int16))
    _bf16_ulp_close(got, want.astype(np.float32))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(64, 24), (300, 70)])
def test_qsgd_plain_bf16_matches_reference_quantizer(bits, shape):
    from repro.core import qsgd as jq
    from repro.core.prng import fold_seed as j_fold_seed

    rng = np.random.RandomState(bits * 11 + shape[0])
    n, levels, tag = 4, (1 << (bits - 1)) - 1, 5
    xt, xv = _bf16(rng.randn(n, *shape) * 0.02)
    xt[2] = 0.0
    seeds = seeds_np(rng, n)
    want_q, want_l, want_n = [], [], []
    for i in range(n):
        xj = jnp.asarray(xv[i] if i != 2 else np.zeros(shape, np.float32),
                         jnp.bfloat16)
        lv, nm = jq.quantize_levels(xj, jnp.uint32(seeds[i]), levels, tag)
        want_l.append(np.asarray(lv))
        want_n.append(float(nm))
        want_q.append(np.array(jq.quantize_leaf(xj, jnp.uint32(seeds[i]),
                                                levels, tag)).view(np.int16))
    folded = np.asarray([int(j_fold_seed(jnp.uint32(s), tag)) for s in seeds])
    q, lv = qsgd_quantize_plain(xt, torch.from_numpy(folded),
                                torch.tensor(want_n, dtype=torch.float32),
                                levels, True, True)
    assert q.dtype == torch.bfloat16 and lv.dtype == torch.float32
    assert torch.equal(lv, torch.from_numpy(np.stack(want_l)))
    np.testing.assert_array_equal(q.view(torch.int16).numpy(), np.stack(want_q))


@pytest.mark.parametrize("bits", [4, 8])
def test_qsgd_roundtrip_kernel_bf16_matches_oracles(jax_kernels, bits):
    """bf16 tree: the port's round trip (q rounded once to bf16) bitwise
    against its own longhand oracle, within one bf16 ulp of the reference's
    interpret-mode kernel (whose q is an f32 ulp off its core quantizer),
    and within ‖x‖/L per level flip of the reference's core round trip."""
    rng = np.random.RandomState(bits + 20)
    tree = {"w": (rng.randn(64, 24) * 0.01).astype(np.float32),
            "b": (rng.randn(24) * 0.01).astype(np.float32)}
    jtree = {k: jnp.asarray(v, jnp.bfloat16) for k, v in tree.items()}
    tt = params_from_jax({k: np.asarray(v) for k, v in jtree.items()}, "cpu")
    got = ops.qsgd_roundtrip_kernel(tt, 11, bits)
    port_oracle = ref.qsgd_roundtrip_ref(tt, 11, bits)
    ref_kernel = jax_kernels.ops.qsgd_roundtrip_kernel(jtree, jnp.uint32(11), bits,
                                                       interpret=True)
    ref_core = jax_kernels.ref.qsgd_roundtrip_ref(jtree, jnp.uint32(11), bits)
    for k in tree:
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k].view(torch.int16), port_oracle[k].view(torch.int16))
        a = got[k].to(torch.float32).numpy()
        _bf16_ulp_close(a, np.asarray(ref_kernel[k], np.float32))
        xf = np.asarray(jtree[k], np.float32)
        bound = np.linalg.norm(xf) / ((1 << (bits - 1)) - 1)
        assert (np.abs(a - np.asarray(ref_core[k], np.float32))
                <= bound * (1 + 2.0 ** -7) + 1e-9).all(), k
