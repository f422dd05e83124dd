"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false.  The file imports no jax, so it also runs on a machine that has
only PyTorch::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the fused close is bitwise equal to its plain version for
the ±1/±2 families, and within rtol/atol 1e-5 for gaussian (the
kernel's logf/cosf against torch's).  The encode's sum order differs
from the plain version's: it is held against the plain version summed
in float64, within ``encode_tolerance`` (4·2⁻²³·√h·‖x‖₂·max|v|, h the
depth of the kernel's float32 sum); and the kernel gives the same bits
on every run.  The per-client decode is bitwise equal to its plain
version for the ±1/±2 families (gaussian within rtol/atol 1e-5), and on
the applied rows alone bitwise its launch on the zero-padded bucket; the
QSGD kernel's levels and round trip are bitwise equal to its plain
version given the same norms.  A digest replayed through the decode
kernel lands on the server's bits.  Flash attention is held against its
plain version on rows with an allowed key by ``flash_agrees``: float32
within ``tests/test_flash_kernel.py``'s rtol 1e-3 / atol 2e-5, bfloat16
within 2^-7 of its row's largest |plain| (one bf16 ulp at most) with at
most 1% of the elements changed; each of its three kernels (the bf16
tensor-core prefill, the split-KV decode, the float32 kernel) is reached
through ``flash_route`` and its own launch counter.  The serving path on
the card runs against the same path on the CPU (float32) and against the
plain version on the card (bf16, logits within 5% of their largest: one
bf16 ulp in up to 1% of the attention outputs, carried through two
layers), with each kernel's launches counted.  The tree launches of the
encode and the fused close are held against their tree-level plain
versions (the encode within ``tree_encode_tolerance``, and bitwise equal
to the per-leaf launches summed in leaf order; the close as above), on
trees of 6 and 70 leaves (two launches).  Leaves past the old launch
grids (524 288 × 1, QSGD 262 144 × 2) are bitwise; the train step's
close (per-client rounding) is bitwise equal to ``server_aggregate``;
the plain blocked attention recurrence is held against the plain
``_sdpa`` (values within 1e-5, gradients within 1e-4 of their largest).
A bf16 leaf of 2³¹ + 2²⁰ elements goes through the encode (within
``encode_tolerance`` of its float64 plain sum), the fused close and the
per-client decode (bitwise their plain versions on its first and last
rows).  The mesh train step runs on meshes whose entries all name the
card: with one data group (deterministic algorithms on) its loss and
every δ are the unsharded round's bit for bit, each r within
``tree_encode_tolerance`` of its float64 encode, the close bitwise given
the same r; on (2, 2) it is held to the unsharded round within the float32
limits of ``tests/test_torch_mesh_train.py`` and, in bf16, r within
2⁻⁸·√S·‖x‖₂; placement and checkpoints across meshes are bitwise.
Serving from resident shards (both of the reference's serve layouts,
the flash kernels on a short prompt) is bitwise the unsharded serve on
(1, 4) and, group by group, the unsharded serve of the group's own rows
on (2, 2); the client-parallel step on (2, 2) gives each δ bitwise the
one-device step's on its row's clients, each r within
``tree_encode_tolerance``, and the close bitwise given the same r.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core.prng import Distribution  # noqa: E402
from repro_torch.core.projection import ProjectionMode  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.reconstruct_apply import (  # noqa: E402
    fused_apply_plain,
    fused_reconstruct_apply,
    pad_cohort,
)
from repro_torch.kernels.seeded_projection import (  # noqa: E402
    encode_tolerance,
    project_blocks,
    project_blocks_plain,
)
from repro_torch.kernels.qsgd_quant import (  # noqa: E402
    qsgd_quantize,
    qsgd_quantize_plain,
)
from repro_torch.kernels.seeded_reconstruct import (  # noqa: E402
    reconstruct_apply_clients,
    reconstruct_plain,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    allowed_mask,
    flash_agrees,
    flash_attention,
    flash_attention_plain,
    flash_compare,
    flash_route,
)
from repro_torch.models.mlp_classifier import init_mlp  # noqa: E402
from torch_parity import MoERoutes, cuda_device, seeds_np  # noqa: E402,F401

pytestmark = pytest.mark.cuda

FAMILIES = ["rademacher", "gaussian", "sparse_rademacher", "hadamard"]
MODES = [(1, "full"), (8, "full"), (8, "block")]


def _launches(names) -> list:
    """The port's launch counters ``names`` (``repro_torch.obs``) so far."""
    totals = obs.totals()
    return [totals[n] for n in names]


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.1 * torch.randn(v.shape, generator=g)
            for k, v in init_mlp(seed=seed, device="cpu").items()}


def _assert_fused(family, got, want):
    if family == "gaussian":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", MODES)
def test_cuda_encode_matches_plain(cuda_device, family, k, mode):
    rng = np.random.RandomState(k)
    masked = mode == "block" and k > 1
    p = _params()
    total = sum(v.numel() for v in p.values())
    offset = 0
    for tag, key in enumerate(sorted(p)):
        shape = tuple(p[key].shape)
        rows, cols = (1, shape[0]) if len(shape) == 1 else shape
        x = torch.from_numpy(rng.randn(20, rows, cols).astype(np.float32))
        seeds = torch.from_numpy(seeds_np(rng, 20).astype(np.int64))
        lo, hi = (torch.tensor(b, dtype=torch.float32) for b in
                  ops.leaf_block_bounds(offset, rows * cols, total, k,
                                        ProjectionMode(mode)))
        want = project_blocks_plain(x, seeds, tag, lo, hi, family, masked,
                                    dtype=torch.float64)
        dev = [t.to(cuda_device) for t in (x, seeds, lo, hi)]
        got = project_blocks(*dev[:2], tag, *dev[2:], family, masked)
        again = project_blocks(*dev[:2], tag, *dev[2:], family, masked)
        torch.testing.assert_close(got, again, rtol=0, atol=0)
        assert ((got.cpu().double() - want).abs()
                <= encode_tolerance(x, family)).all()
        offset += rows * cols


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", MODES)
@pytest.mark.parametrize("n", [20, 1000])
def test_cuda_fused_matches_plain(cuda_device, family, k, mode, n):
    rng = np.random.RandomState(n + k)
    p = _params(1)
    rs = torch.from_numpy(rng.randn(n, k).astype(np.float32))
    seeds = torch.from_numpy(seeds_np(rng, n).astype(np.int64))
    dist = Distribution(family)
    want = ops.server_update_fused(p, rs, seeds, 1.0, dist,
                                   mode=ProjectionMode(mode))
    got = ops.server_update_fused(
        {key: v.to(cuda_device) for key, v in p.items()}, rs.to(cuda_device),
        seeds.to(cuda_device), 1.0, dist, mode=ProjectionMode(mode))
    for key in p:
        _assert_fused(family, got[key].cpu(), want[key])


@pytest.mark.parametrize("family", FAMILIES)
def test_cuda_fused_offsets_match_plain(cuda_device, family):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(37, 300).astype(np.float32))
    rs = torch.from_numpy(rng.randn(21, 3).astype(np.float32))
    seeds = torch.from_numpy(seeds_np(rng, 21).astype(np.int64))
    lo = torch.tensor([0.0, 5000.0, 9000.0])
    hi = torch.tensor([5000.0, 9000.0, 20000.0])
    sp, rp = pad_cohort(seeds, rs * torch.tensor(0.5))
    want = fused_apply_plain(x, sp, rp, 2, lo, hi, family, True, 40, 9, 310)
    got = fused_reconstruct_apply(
        x.to(cuda_device), seeds.to(cuda_device), rs.to(cuda_device), 2, 0.5,
        family, lo=lo.to(cuda_device), hi=hi.to(cuda_device), masked=True,
        row_offset=40, col_offset=9, orig_cols=310)
    _assert_fused(family, got.cpu(), want)


def test_cuda_wrappers_check_inputs(cuda_device):
    x = torch.zeros((2, 4, 8), device=cuda_device)
    seeds = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    lo = torch.zeros(1, device=cuda_device)
    hi = torch.ones(1, device=cuda_device)
    with pytest.raises(TypeError):
        project_blocks(x.double(), seeds, 0, lo, hi)
    with pytest.raises(ValueError):
        project_blocks(x.transpose(1, 2), seeds, 0, lo, hi)
    with pytest.raises(ValueError):
        project_blocks(x, seeds[:1], 0, lo, hi)
    with pytest.raises(TypeError):
        fused_reconstruct_apply(x[0].double(), seeds, torch.ones(2, device=cuda_device),
                                0, 1.0)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", MODES)
@pytest.mark.parametrize("n", [20, 33, 1000])
def test_cuda_rec_matches_plain(cuda_device, family, k, mode, n):
    rng = np.random.RandomState(n + k)
    p = _params(n)
    rs = torch.from_numpy(rng.randn(n, k).astype(np.float32))
    seeds = torch.from_numpy(seeds_np(rng, n).astype(np.int64))
    w = torch.from_numpy(rng.rand(n).astype(np.float32))
    want = ops.server_update_kernel(p, rs, seeds, 0.9, Distribution(family),
                                    weights=w, mode=ProjectionMode(mode))
    before = obs.totals()["decode.launches"]
    got = ops.server_update_kernel(
        {key: v.to(cuda_device) for key, v in p.items()}, rs.to(cuda_device),
        seeds.to(cuda_device), 0.9, Distribution(family),
        weights=w.to(cuda_device), mode=ProjectionMode(mode))
    assert obs.totals()["decode.launches"] == before + 1    # one tree launch
    for key in p:
        _assert_fused(family, got[key].cpu(), want[key])


@pytest.mark.parametrize("family", FAMILIES)
def test_cuda_rec_offsets_match_plain(cuda_device, family):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(37, 300).astype(np.float32))
    rs = torch.from_numpy(rng.randn(45, 3).astype(np.float32))
    seeds = torch.from_numpy(seeds_np(rng, 45).astype(np.int64))
    lo = torch.tensor([0.0, 5000.0, 9000.0])
    hi = torch.tensor([5000.0, 9000.0, 20000.0])
    want = reconstruct_plain(x, seeds, rs, 2, 0.5, lo, hi, family, True, 40, 9,
                             310)
    got = reconstruct_apply_clients(
        x.to(cuda_device), seeds.to(cuda_device), rs.to(cuda_device), 2, 0.5,
        family, lo=lo.to(cuda_device), hi=hi.to(cuda_device), masked=True,
        row_offset=40, col_offset=9, orig_cols=310)
    _assert_fused(family, got.cpu(), want)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(16, 1, 24), (16, 64, 24), (3, 300, 700)])
def test_cuda_qsgd_matches_plain(cuda_device, bits, shape):
    rng = np.random.RandomState(bits)
    x = torch.from_numpy((rng.randn(*shape) * 0.01).astype(np.float32))
    x[0] = 0.0
    seeds = torch.from_numpy(seeds_np(rng, shape[0]).astype(np.int64))
    norms = torch.linalg.vector_norm(x.reshape(shape[0], -1), dim=1)
    norms = torch.where(norms == 0, torch.ones_like(norms), norms)
    levels = (1 << (bits - 1)) - 1
    qp, lp = qsgd_quantize_plain(x, seeds, norms, levels, True, True, 3, 5)
    q, lv = qsgd_quantize(x.to(cuda_device), seeds.to(cuda_device),
                          norms.to(cuda_device), levels, True, True, 3, 5)
    torch.cuda.synchronize()
    assert torch.equal(q.cpu(), qp) and torch.equal(lv.cpu(), lp)
    q_only, none = qsgd_quantize(x.to(cuda_device), seeds.to(cuda_device),
                                 norms.to(cuda_device), levels, row_offset=3,
                                 col_offset=5)
    assert none is None and torch.equal(q_only, q)


def test_cuda_new_wrappers_check_inputs(cuda_device):
    x = torch.zeros((2, 4, 8), device=cuda_device)
    seeds = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    norms = torch.ones(2, device=cuda_device)
    with pytest.raises(TypeError):
        qsgd_quantize(x.double(), seeds, norms, 127)
    with pytest.raises(ValueError):
        qsgd_quantize(x, seeds[:1], norms, 127)
    with pytest.raises(ValueError):
        qsgd_quantize(x.transpose(1, 2), seeds, norms, 127)
    with pytest.raises(ValueError):
        qsgd_quantize(x, seeds, norms, 300)
    rs = torch.ones(2, 1, device=cuda_device)
    with pytest.raises(TypeError):
        reconstruct_apply_clients(x[0].double(), seeds, rs, 0, 1.0)
    with pytest.raises(ValueError):
        reconstruct_apply_clients(x[0], seeds[:1], rs, 0, 1.0)
    with pytest.raises(ValueError):
        reconstruct_apply_clients(x[0], seeds, rs, 0, 1.0, "bogus")


def test_cuda_digest_replay_through_rec_is_bit_identical(cuda_device):
    from repro_torch.data import load_digits, make_client_datasets
    from repro_torch.data import train_test_split_arrays
    from repro_torch.fed.runtime import RuntimeConfig, run_federation

    x, y = load_digits(400)
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    before = obs.totals()["decode.launches"]
    h = run_federation(
        RuntimeConfig(rounds=3, population=64, participation=0.5,
                      kernel_cohort_threshold=8, downlink_mode="digest",
                      verify_replay=True),
        init_mlp(device="cuda"), make_client_datasets(xtr, ytr, 8), xte, yte)
    # server apply and shadow replay: one tree launch each, every round
    assert obs.totals()["decode.launches"] - before == 2 * 3
    assert np.isfinite(h["loss"]).all()


def _ring(capacity, last):
    """kpos of a ring of ``capacity`` slots after positions 0..last."""
    kpos = torch.full((capacity,), -1, dtype=torch.int32)
    p = torch.arange(max(0, last - capacity + 1), last + 1)
    kpos[p % capacity] = p.to(torch.int32)
    return kpos


def _check_flash(dev, b, s, t, h, kh, hd, dtype, window=0, qpos=None, kpos=None,
                 seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(dtype)
               for shape in ((b, s, h, hd), (b, t, kh, hd), (b, t, kh, hd)))
    qpos = torch.arange(t - s, t, dtype=torch.int32) if qpos is None else qpos
    kpos = torch.arange(t, dtype=torch.int32) if kpos is None else kpos
    args = [x.to(dev) for x in (q, k, v, qpos, kpos)]
    before = obs.totals()["flash.launches"]
    got = flash_attention(*args, causal=True, window=window)
    want = flash_attention_plain(*args, causal=True, window=window)
    torch.cuda.synchronize()
    assert obs.totals()["flash.launches"] == before + 1
    rows = allowed_mask(qpos, kpos, True, window).any(dim=1).to(dev)
    assert got.dtype == dtype and bool(rows.any())
    g, w = got[:, rows], want[:, rows]
    assert flash_agrees(g, w), flash_compare(g, w)
    assert bool((got[:, ~rows] == 0).all())


# (query heads, kv heads): G = 1, 3, 4 and 8 (Qwen3-MoE's 32 over 4)
FLASH_HEADS = [(4, 4), (6, 2), (4, 1), (32, 4)]
FLASH_HEAD_IDS = ["mha", "gqa3", "mqa", "gqa8"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("heads", FLASH_HEADS, ids=FLASH_HEAD_IDS)
@pytest.mark.parametrize("window", [0, 64])
def test_cuda_flash_matches_plain(cuda_device, dtype, hd, heads, window):
    h, kh = heads
    _check_flash(cuda_device, 2, 333, 333, h, kh, hd, dtype, window)
    _check_flash(cuda_device, 1, 1000, 1000, h, kh, hd, dtype, window, seed=1)
    # empty slots and a query tile with no allowed key at all
    kpos = torch.arange(333, dtype=torch.int32)
    kpos[::5] = -1
    qpos = torch.arange(333, dtype=torch.int32)
    qpos[:40] = -1
    _check_flash(cuda_device, 1, 333, 333, h, kh, hd, dtype, window, qpos, kpos, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_ring_and_decode(cuda_device, dtype):
    # decode (S = 1) against the serve phase's cache of 16 424 slots
    kpos = torch.where(torch.arange(16424) < 16400, torch.arange(16424), -1).int()
    _check_flash(cuda_device, 4, 1, 16424, 15, 5, 64, dtype,
                 qpos=torch.tensor([16399], dtype=torch.int32), kpos=kpos)
    # a wrapped ring: kpos unsorted, allowed keys in tiles "before" masked ones
    ring = _ring(1000, 1499)
    for window in (0, 64, 1000):
        _check_flash(cuda_device, 2, 1, 1000, 6, 2, 64, dtype, window,
                     torch.tensor([1499], dtype=torch.int32), ring, 3)
        _check_flash(cuda_device, 2, 300, 1000, 6, 2, 64, dtype, window,
                     torch.arange(1200, 1500, dtype=torch.int32), ring, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_smollm_prefill_shape(cuda_device, dtype):
    _check_flash(cuda_device, 1, 16384, 16384, 15, 5, 64, dtype)


_ROUTES = {"prefill": "flash_prefill", "decode": "flash_decode", "f32": "flash_f32"}


def _check_route(dev, route, b, s, t, h, kh, hd, dtype, *args, **kw):
    """_check_flash, and the call launched the kernel ``route`` names."""
    assert flash_route(s, h, kh, dtype) == route
    name = _ROUTES[route] + ".launches"
    before = obs.totals()[name]
    _check_flash(dev, b, s, t, h, kh, hd, dtype, *args, **kw)
    assert obs.totals()[name] == before + 1


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("heads", FLASH_HEADS, ids=FLASH_HEAD_IDS)
@pytest.mark.parametrize("window", [0, 64])
def test_cuda_flash_prefill_kernel(cuda_device, hd, heads, window):
    """The bf16 tensor-core kernel: S = 200 against T = 333 (neither a
    multiple of its 128-row or key tile), and kpos holes with padding
    queries."""
    h, kh = heads
    _check_route(cuda_device, "prefill", 2, 200, 333, h, kh, hd, torch.bfloat16,
                 window, seed=5)
    kpos = torch.arange(333, dtype=torch.int32)
    kpos[::7] = -1
    qpos = torch.arange(333, dtype=torch.int32)
    qpos[:50] = -1
    _check_route(cuda_device, "prefill", 1, 333, 333, h, kh, hd, torch.bfloat16,
                 window, qpos, kpos, 6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_kernel(cuda_device, dtype):
    """The split-KV decode: 16 424 slots (not a multiple of its 256-key
    partition) with 24 empty, a wrapped ring of 1000 under windows 0, 64
    and 1000, two query rows of GQA 3, and hd 32, 128 and 256 (PaliGemma's
    8 heads over 1)."""
    kpos = torch.where(torch.arange(16424) < 16400, torch.arange(16424), -1).int()
    _check_route(cuda_device, "decode", 4, 1, 16424, 15, 5, 64, dtype,
                 qpos=torch.tensor([16399], dtype=torch.int32), kpos=kpos)
    ring = _ring(1000, 1499)
    for window in (0, 64, 1000):
        _check_route(cuda_device, "decode", 2, 1, 1000, 6, 2, 64, dtype, window,
                     torch.tensor([1499], dtype=torch.int32), ring, 7)
    _check_route(cuda_device, "decode", 2, 2, 1000, 6, 2, 64, dtype, 0,
                 torch.tensor([1498, 1499], dtype=torch.int32), ring, 8)
    for hd in (32, 128, 256):
        _check_route(cuda_device, "decode", 2, 1, 1000, 8, 1, hd, dtype, 64,
                     torch.tensor([1499], dtype=torch.int32), ring, 9)


def test_cuda_flash_counters_on_serve(cuda_device, monkeypatch):
    """A short bf16 serve run (2 layers, prompt 200, 4 decode steps, the
    blocked threshold at 64) launches the prefill kernel once per layer
    and the decode kernel once per layer and step, and its logits stay
    within 5% of their largest from the same run through the plain
    version on the card."""
    import dataclasses

    import repro_torch.models.attention as t_attention
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import Arch

    monkeypatch.setattr(t_attention, "BLOCKED_SDPA_THRESHOLD", 64)
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2,
                              dtype="bfloat16")
    arch = Arch(cfg)
    params = arch.init(seed=0, device=cuda_device)
    tok = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size,
                                                            (2, 200))).to(cuda_device)

    def run():
        logits, caches = arch.prefill(params, {"tokens": tok}, capacity=212)
        steps = [logits]
        for i in range(4):
            nxt = torch.full((2, 1), 7 + i, device=cuda_device)
            logits, caches = arch.decode(params, nxt, caches, 200 + i)
            steps.append(logits)
        return torch.stack([x.float().cpu() for x in steps])

    counters = ["flash.launches", "flash_prefill.launches", "flash_decode.launches",
                "flash_f32.launches"]
    before = _launches(counters)
    got = run()
    assert [n - b for n, b in zip(_launches(counters), before)] == [10, 2, 8, 0]

    def plain(q, k, v, qpos, kpos, *, causal, window, prefix_len):
        return flash_attention_plain(q, k, v, qpos.int(), kpos.int(), causal=causal,
                                     window=window)
    monkeypatch.setattr(t_attention, "_sdpa_blocked", plain)
    want = run()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 0.05 * float(want.abs().max())


def test_cuda_flash_checks_inputs(cuda_device):
    q = torch.zeros((1, 8, 4, 64), device=cuda_device)
    k = torch.zeros((1, 8, 2, 64), device=cuda_device)
    pos = torch.arange(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), k.double(), pos, pos)
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), k.bfloat16(), pos, pos)
    with pytest.raises(ValueError):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        k[..., :48].contiguous(), pos, pos)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 8, 3, 64), device=cuda_device),
                        torch.zeros((1, 8, 3, 64), device=cuda_device), pos, pos)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k, k, pos, pos)
    with pytest.raises(TypeError):
        flash_attention(q, k, k, pos.long(), pos)
    with pytest.raises(ValueError):
        flash_attention(q, k, k, pos[:4], pos)
    with pytest.raises(ValueError):
        flash_attention(q, k, k, pos.cpu(), pos)


def test_cuda_serve_matches_cpu(cuda_device, monkeypatch):
    """Prefill + 4 decode steps of a 2-layer GQA model on the card against
    the CPU, with the blocked threshold at 64 so both phases launch the
    kernel: 2 launches for the prefill, 2 per decode step.  float32; the
    logits agree within atol 1e-3 (sum order on a 200-token prompt)."""
    import dataclasses

    import repro_torch.models.attention as t_attention
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models.api import Arch

    monkeypatch.setattr(t_attention, "BLOCKED_SDPA_THRESHOLD", 64)
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2,
                              dtype="float32")
    arch = Arch(cfg)
    params = arch.init(seed=0, device="cpu")
    dev_params = tree_map(lambda t: t.to(cuda_device), params)
    tok = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size,
                                                            (2, 200)))
    counters = ["flash.launches", "flash_f32.launches", "flash_decode.launches"]
    before = _launches(counters)
    out = {}
    for dev, p in (("cpu", params), ("cuda", dev_params)):
        logits, caches = arch.prefill(p, {"tokens": tok.to(dev)}, capacity=212)
        steps = [logits]
        for i in range(4):
            nxt = torch.full((2, 1), 7 + i, device=dev)
            logits, caches = arch.decode(p, nxt, caches, 200 + i)
            steps.append(logits)
        out[dev] = torch.stack([x.cpu() for x in steps])
    # float32: the prefill on the float32 kernel, each decode step split-KV
    assert [n - b for n, b in zip(_launches(counters), before)] == [2 + 2 * 4, 2, 8]
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name,over", [("qwen3-moe-30b-a3b", {"experts_per_token": 2}),
                                       ("falcon-mamba-7b", {})], ids=["moe-k2", "mamba"])
def test_cuda_moe_and_mamba_forward_match_cpu(cuda_device, monkeypatch, name, over):
    """``lm_forward`` of reduced Qwen3-MoE (two experts a token, so the
    capacity drops) and reduced Falcon-Mamba, float32, 2 × 200 tokens, on
    the card against the CPU, the blocked threshold at 64 (the MoE model's
    attention on the float32 kernel).  The card's routes are recorded
    through ``moe._route`` and replayed on the CPU (a near tie of the
    router's logits may flip a route between the two sums; any route that
    differs must differ at a near tie); logits within atol 1e-3 (sum
    order)."""
    import dataclasses

    import repro_torch.models.attention as t_attention
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models.api import Arch
    from repro_torch.models.lm import lm_forward

    monkeypatch.setattr(t_attention, "BLOCKED_SDPA_THRESHOLD", 64)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    params = Arch(cfg).init(seed=0, device="cpu")
    tok = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 200)))
    routes = MoERoutes()
    counters = ["flash.launches", "flash_f32.launches"]
    before = _launches(counters)
    with routes.use("record"):
        got = lm_forward(tree_map(lambda t: t.to(cuda_device), params), cfg,
                         tokens=tok.to(cuda_device))
    torch.cuda.synchronize()
    with routes.use("replay"):
        want = lm_forward(params, cfg, tokens=tok)
    n_attn = cfg.num_layers if cfg.num_heads else 0
    assert [n - b for n, b in zip(_launches(counters), before)] == [n_attn, n_attn]
    assert len(routes.recorded) == (cfg.num_layers if cfg.num_experts else 0)
    routes.check(cfg.name)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name,over", [
    ("paligemma-3b", {}),
    ("paligemma-3b", dict(d_model=512, num_heads=2, num_kv_heads=1, head_dim=256)),
    ("whisper-tiny", {})], ids=["vlm", "vlm-hd256", "encdec"])
def test_cuda_vlm_and_encdec_serve_match_cpu(cuda_device, monkeypatch, name, over):
    """Reduced PaliGemma (head_dim 64, and 256) and reduced Whisper, float32,
    prefill + 4 decode steps on the card against the CPU with the blocked
    threshold at 64: PaliGemma's 16 embeddings + 264 tokens run the plain
    prefix recurrence at prefill and the split-KV decode at each step past
    the prefix (256); Whisper's decoder (64 frames, 200 tokens) the float32
    kernel at prefill and the split-KV decode at each step.  Logits within
    atol 1e-3 (sum order)."""
    import dataclasses

    import repro_torch.models.attention as t_attention
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models.api import Arch

    monkeypatch.setattr(t_attention, "BLOCKED_SDPA_THRESHOLD", 64)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    arch = Arch(cfg)
    params = arch.init(seed=0, device="cpu")
    dev_params = tree_map(lambda t: t.to(cuda_device), params)
    rng = np.random.RandomState(0)
    vlm = cfg.frontend == "vision"
    n_emb = cfg.num_frontend_tokens if vlm else cfg.encoder_seq
    prompt = 264 if vlm else 200
    batch = {"tokens": torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, prompt))),
             "embeds": torch.from_numpy((rng.randn(2, n_emb, cfg.d_model) * 0.02)
                                        .astype(np.float32))}
    start = prompt + (n_emb if vlm else 0)
    counters = ("flash.launches", "flash_f32.launches", "flash_decode.launches")
    out = {}
    for dev, p in (("cpu", params), ("cuda", dev_params)):
        before = _launches(counters)
        logits, caches = arch.prefill(p, {k: x.to(dev) for k, x in batch.items()},
                                      capacity=start + 8)
        steps = [logits]
        for i in range(4):
            nxt = torch.full((2, 1), 7 + i, device=dev)
            logits, caches = arch.decode(p, nxt, caches, start + i)
            steps.append(logits)
        out[dev] = torch.stack([x.cpu() for x in steps])
    n = cfg.num_layers
    assert [n - b for n, b in zip(_launches(counters), before)] == (
        [4 * n, 0, 4 * n] if vlm else [5 * n, n, 4 * n])
    assert bool(torch.isfinite(out["cuda"]).all())
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# bf16 leaves (the training slice) and the training path
# ---------------------------------------------------------------------------

def _bf16_decode_close(family, got, want):
    """Bitwise for the ±1/±2 families; gaussian within rtol/atol 1e-5 plus one
    bf16 ulp, where the float32 values round apart."""
    assert got.dtype == want.dtype == torch.bfloat16
    if family == "gaussian":
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-5 + 2.0 ** -7,
                                   atol=1e-5)
    else:
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("shape", [(1, 960), (300, 700), (2560, 960)])
def test_cuda_bf16_kernels_match_plain(cuda_device, family, shape):
    """Encode, decode, fused close and QSGD on bf16 leaves against their
    plain versions (the train path's N = 1 encode and N = 4 close)."""
    rng = np.random.RandomState(shape[0] + len(family))
    rows, cols = shape
    x = torch.from_numpy(rng.randn(rows, cols).astype(np.float32) * 0.05
                         ).to(torch.bfloat16)
    delta = torch.from_numpy(rng.randn(1, rows, cols).astype(np.float32) * 1e-3
                             ).to(torch.bfloat16)
    seeds = torch.from_numpy(seeds_np(rng, 4).astype(np.int64))
    rs = torch.from_numpy(rng.randn(4, 1).astype(np.float32))
    lo, hi = torch.zeros(1), torch.full((1,), float(rows * cols))
    on = [t.to(cuda_device) for t in (x, delta, seeds, rs, lo, hi)]

    want = project_blocks_plain(delta, seeds[:1], 3, lo, hi, family,
                                dtype=torch.float64)
    got = project_blocks(on[1], on[2][:1], 3, on[4], on[5], family)
    assert ((got.cpu().double() - want).abs() <= encode_tolerance(delta, family)).all()

    want = reconstruct_plain(x, seeds, rs, 3, 0.25, lo, hi, family)
    got = reconstruct_apply_clients(on[0], on[2], on[3], 3, 0.25, family,
                                    lo=on[4], hi=on[5])
    _bf16_decode_close(family, got.cpu(), want)

    sp, rp = pad_cohort(seeds, rs * 0.25)
    want = fused_apply_plain(x, sp, rp, 3, lo, hi, family)
    got = fused_reconstruct_apply(on[0], on[2], on[3], 3, 0.25, family,
                                  lo=on[4], hi=on[5])
    _bf16_decode_close(family, got.cpu(), want)

    norms = torch.linalg.vector_norm(delta.reshape(1, -1).float(), dim=1)
    qp, lp = qsgd_quantize_plain(delta, seeds[:1], norms, 127, True, True)
    q, lv = qsgd_quantize(on[1], on[2][:1], norms.to(cuda_device), 127, True, True)
    assert q.dtype == torch.bfloat16 and lv.dtype == torch.float32
    assert torch.equal(q.cpu().view(torch.int16), qp.view(torch.int16))
    assert torch.equal(lv.cpu(), lp)


def test_cuda_bf16_tree_ops_launch_without_a_float32_copy(cuda_device):
    """``ops.project_tree_kernel`` and the closes take bf16 leaves as they are."""
    p = {k: v.to(torch.bfloat16) for k, v in _params(2).items()}
    rng = np.random.RandomState(5)
    deltas = {k: (0.01 * torch.from_numpy(rng.randn(3, *v.shape).astype(np.float32))
                  ).to(torch.bfloat16) for k, v in p.items()}
    seeds = torch.from_numpy(seeds_np(rng, 3).astype(np.int64))
    r_cpu = ops.project_tree_kernel(deltas, seeds)
    r_card = ops.project_tree_kernel(
        {k: v.to(cuda_device) for k, v in deltas.items()}, seeds.to(cuda_device))
    torch.testing.assert_close(r_card.cpu(), r_cpu, rtol=1e-5, atol=1e-6)
    p_card = {k: v.to(cuda_device) for k, v in p.items()}
    for close in (ops.server_update_kernel, ops.server_update_fused):
        want = close(p, r_cpu, seeds, 1.0)
        got = close(p_card, r_cpu.to(cuda_device), seeds.to(cuda_device), 1.0)
        for k in p:
            assert got[k].dtype == torch.bfloat16
            assert torch.equal(got[k].cpu().view(torch.int16),
                               want[k].view(torch.int16))


def test_cuda_sdpa_blocked_refuses_autograd(cuda_device):
    """The flash kernels have no backward: under autograd on the card
    _sdpa_blocked does not launch them (no tensor autograd cannot reach)
    but takes the reference's blocked recurrence in plain torch, whose
    gradients are the plain _sdpa's (float32, within 1e-4 of the largest
    |gradient|); without autograd it launches the kernel."""
    from repro_torch.models.attention import _sdpa, _sdpa_blocked

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 40, 3, 64, generator=g).to(cuda_device)
               for _ in range(3))
    pos = torch.arange(40, device=cuda_device)
    before = obs.totals()["flash.launches"]
    out = _sdpa_blocked(q, k, v, pos, pos, causal=True, window=0, prefix_len=0)
    assert out.shape == q.shape and not out.requires_grad
    assert obs.totals()["flash.launches"] == before + 1
    for leaf in (q, k, v):
        leaf.requires_grad_(True)
        got = _sdpa_blocked(q, k, v, pos, pos, causal=True, window=0, prefix_len=0)
        assert got.requires_grad
        leaf.requires_grad_(False)
    assert obs.totals()["flash.launches"] == before + 1
    with torch.no_grad():
        q.requires_grad_(True)
        _sdpa_blocked(q, k, v, pos, pos, causal=True, window=0, prefix_len=0)
    assert obs.totals()["flash.launches"] == before + 2


@pytest.mark.parametrize("window,prefix_len", [(0, 0), (24, 0), (0, 13)])
def test_cuda_blocked_plain_grads_match_sdpa(cuda_device, window, prefix_len):
    """C2/C3: the plain blocked recurrence (small chunks, GQA, ragged
    chunks) against the plain _sdpa on the card: values within 1e-5 and
    q/k/v gradients within 1e-4 of the largest |gradient| (float32)."""
    from repro_torch.models.attention import _sdpa, _sdpa_blocked_plain

    g = torch.Generator().manual_seed(window + prefix_len)
    q = torch.randn(2, 70, 6, 32, generator=g).to(cuda_device)
    k, v = (torch.randn(2, 70, 2, 32, generator=g).to(cuda_device)
            for _ in range(2))
    dy = torch.randn(2, 70, 6, 32, generator=g).to(cuda_device)
    pos = torch.arange(70, device=cuda_device)
    kw = dict(causal=True, window=window, prefix_len=prefix_len)
    res = []
    for fn in (lambda *a: _sdpa_blocked_plain(*a, q_chunk=16, kv_chunk=32, **kw),
               lambda *a: _sdpa(*a, **kw)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, pos, pos)
        grads = torch.autograd.grad(out, leaves, dy)
        res.append((out.detach(), grads))
    (a, ga), (b, gb) = res
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    for x, y in zip(ga, gb):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())


# ---------------------------------------------------------------------------
# the tree launches of the encode and the fused close
# ---------------------------------------------------------------------------

def _tree(n_leaves, seed, dtype, lead=()):
    """A tree of ``n_leaves`` small leaves of mixed widths (1-D, ragged and
    16-byte-multiple columns) → dict of CPU tensors."""
    rng = np.random.RandomState(seed)
    shapes = [(24,), (64, 24), (12, 10), (3, 2, 40), (7,), (33, 960)]
    return {f"l{i:03d}": torch.from_numpy(
        rng.randn(*lead, *shapes[i % len(shapes)]).astype(np.float32) * 0.1
        ).to(dtype) for i in range(n_leaves)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", [(1, "full"), (8, "block")])
@pytest.mark.parametrize("n_leaves", [6, 70])
def test_cuda_tree_encode_matches_plain(cuda_device, dtype, family, k, mode,
                                        n_leaves):
    """One tree launch (two groups at 70 leaves) against the tree's plain
    version summed in float64, within tree_encode_tolerance; bitwise equal
    to the per-leaf kernel launches summed in leaf order, and to itself."""
    from repro_torch.core.projection import leaf_layout
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.seeded_projection import (
        project_tree_plain,
        tree_encode_tolerance,
    )
    from repro_torch.kernels.tree import tree_plan

    dt = getattr(torch, dtype)
    d = _tree(n_leaves, n_leaves + k, dt, lead=(5,))
    seeds = torch.from_numpy(seeds_np(np.random.RandomState(k), 5).astype(np.int64))
    leaves = tree_leaves(d)
    plan = tree_plan("encode", [tuple(x.shape[1:]) for x in leaves],
                     [x.dtype for x in leaves], k, ProjectionMode(mode), "cpu")
    want = project_tree_plain(leaves, seeds, plan, family, dtype=torch.float64)
    on = {key: x.to(cuda_device) for key, x in d.items()}
    before = obs.totals()["encode.launches"]
    got = ops.project_tree_kernel(on, seeds.to(cuda_device), Distribution(family),
                                  k, ProjectionMode(mode))
    assert obs.totals()["encode.launches"] - before == 2 * len(plan.groups)
    again = ops.project_tree_kernel(on, seeds.to(cuda_device), Distribution(family),
                                    k, ProjectionMode(mode))
    assert torch.equal(got, again)
    views = [x.reshape(5, ll.rows, ll.cols)
             for ll, x in zip(leaf_layout({key: x[0] for key, x in d.items()}), leaves)]
    assert ((got.cpu().double() - want).abs()
            <= tree_encode_tolerance(views, family)).all()
    acc = None
    for i, (ll, x) in enumerate(zip(plan.layout, tree_leaves(on))):
        r = project_blocks(x.reshape(5, ll.rows, ll.cols), seeds.to(cuda_device),
                           ll.tag, plan.lo[i].to(cuda_device),
                           plan.hi[i].to(cuda_device), family, plan.masked)
        acc = r if acc is None else acc + r
    assert torch.equal(got, acc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", [(1, "full"), (8, "full"), (8, "block")])
@pytest.mark.parametrize("n_leaves", [6, 70])
def test_cuda_tree_close_matches_plain(cuda_device, dtype, family, k, mode,
                                       n_leaves):
    """One fused tree launch (two at 70 leaves) against the plain tree
    close: bitwise for the ±1/±2 families (gaussian within rtol/atol 1e-5,
    plus one bf16 ulp on bf16 leaves), for cohorts 4, 20 and 33."""
    dt = getattr(torch, dtype)
    p = _tree(n_leaves, n_leaves, dt)
    rng = np.random.RandomState(k + n_leaves)
    on = {key: x.to(cuda_device) for key, x in p.items()}
    for n in (4, 20, 33):
        rs = torch.from_numpy(rng.randn(n, k).astype(np.float32))
        seeds = torch.from_numpy(seeds_np(rng, n).astype(np.int64))
        want = ops.server_update_fused(p, rs, seeds, 0.7, Distribution(family),
                                       mode=ProjectionMode(mode))
        before = obs.totals()["close.launches"]
        got = ops.server_update_fused(on, rs.to(cuda_device), seeds.to(cuda_device),
                                      0.7, Distribution(family),
                                      mode=ProjectionMode(mode))
        assert obs.totals()["close.launches"] - before == -(-n_leaves // 64)
        for key in p:
            if dt == torch.bfloat16:
                _bf16_decode_close(family, got[key].cpu(), want[key])
            else:
                _assert_fused(family, got[key].cpu(), want[key])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_narrow_leaves_past_the_old_grid_limit(cuda_device, dtype):
    """C1: a 524 288 × 1 leaf through the fused close and the per-client
    decode, and a 262 144 × 2 leaf through QSGD, bitwise against their
    plain versions (the old grids held 524 280 and 262 140 rows)."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(524_288, 1).astype(np.float32)).to(dt)
    seeds = torch.from_numpy(seeds_np(rng, 20).astype(np.int64))
    rs = torch.from_numpy(rng.randn(20, 1).astype(np.float32))
    on = [t.to(cuda_device) for t in (x, seeds, rs)]
    sp, rp = pad_cohort(seeds, rs * torch.tensor(0.05))
    lo, hi = torch.zeros(1), torch.full((1,), float(x.numel()))
    want = fused_apply_plain(x, sp, rp, 3, lo, hi)
    got = fused_reconstruct_apply(on[0], on[1], on[2], 3, 0.05)
    assert torch.equal(got.cpu().view(torch.int16 if dtype == "bfloat16" else
                                      torch.int32),
                       want.view(torch.int16 if dtype == "bfloat16" else torch.int32))
    want = reconstruct_plain(x, seeds, rs, 3, 0.05, lo, hi)
    got = reconstruct_apply_clients(on[0], on[1], on[2], 3, 0.05)
    assert torch.equal(got.cpu().float(), want.float())
    q_in = torch.from_numpy(rng.randn(2, 262_144, 2).astype(np.float32) * 0.01
                            ).to(dt)
    qs = seeds[:2]
    norms = torch.linalg.vector_norm(q_in.reshape(2, -1).float(), dim=1)
    qp, lp = qsgd_quantize_plain(q_in, qs, norms, 127, True, True)
    q, lv = qsgd_quantize(q_in.to(cuda_device), qs.to(cuda_device),
                          norms.to(cuda_device), 127, True, True)
    assert torch.equal(q.cpu().float(), qp.float()) and torch.equal(lv.cpu(), lp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["rademacher", "sparse_rademacher", "hadamard"])
@pytest.mark.parametrize("k,mode,n", [(1, "full", 4), (1, "full", 7),
                                      (8, "full", 4), (8, "block", 4)])
def test_cuda_train_close_equals_server_aggregate(cuda_device, dtype, family, k,
                                                  mode, n):
    """C4: the per-client-rounding close bitwise equal to the port's plain
    server_aggregate on the card, float32 rs (not bf16-representable)."""
    from repro_torch.core.fedscalar import FedScalarConfig, server_aggregate

    dt = getattr(torch, dtype)
    p = {key: x.to(cuda_device) for key, x in _tree(6, 3, dt).items()}
    rng = np.random.RandomState(n + k)
    rs = torch.from_numpy(rng.randn(n, k).astype(np.float32)).to(cuda_device)
    seeds = torch.from_numpy(seeds_np(rng, n).astype(np.int64)).to(cuda_device)
    cfg = FedScalarConfig(server_lr=0.9, distribution=Distribution(family),
                          num_projections=k, mode=ProjectionMode(mode))
    want = server_aggregate(p, rs, seeds, cfg)
    got = ops.server_update_kernel(p, rs, seeds, 0.9, Distribution(family),
                                   mode=ProjectionMode(mode),
                                   per_client_rounding=True)
    for key in p:
        assert got[key].dtype == dt
        assert torch.equal(got[key].float(), want[key].float()), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_train_step_matches_cpu(cuda_device, dtype):
    """One train_step of a reduced GQA SmolLM on the card against the CPU:
    the encode and decode kernels launch (one tree launch and its reduction
    per client, one tree launch for the close), the loss agrees within 1e-4 (float32) / 2e-2
    (bf16: activations round at the card's own points), and the card's close
    (per-client rounding) equals its plain version on the card bitwise,
    given the card's params, rs and seeds."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.seeded_reconstruct import reconstruct_plain
    from repro_torch.launch.train import FLRunConfig, make_train_step
    from repro_torch.models.api import Arch

    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), d_model=384,
                              num_heads=6, num_kv_heads=2, head_dim=64, dtype=dtype)
    arch = Arch(cfg)
    params = arch.init(seed=0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size,
                                                             (8, 33)))
    step = make_train_step(arch, FLRunConfig(num_virtual_clients=4, local_steps=2,
                                             local_lr=0.05))
    out = {}
    enc0, rec0 = obs.totals()["encode.launches"], obs.totals()["decode.launches"]
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        out[dev] = (p, *step(p, {"tokens": toks[:, :-1].to(dev),
                                 "labels": toks[:, 1:].to(dev)}, 2))
    assert obs.totals()["encode.launches"] - enc0 == 2 * 4      # one tree launch per client
    assert obs.totals()["decode.launches"] - rec0 == 1   # the close: one tree launch
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert abs(float(out["cuda"][2]["loss"]) - float(out["cpu"][2]["loss"])) <= tol
    p, new, m = out["cuda"]
    assert torch.equal(m["seeds"].cpu(), out["cpu"][2]["seeds"])
    from repro_torch.core.projection import leaf_layout

    for ll, x, y in zip(leaf_layout(p), tree_leaves(p), tree_leaves(new)):
        want = reconstruct_plain(x.reshape(ll.rows, ll.cols), m["seeds"], m["r"],
                                 ll.tag, 1.0, None, None, per_client_rounding=True,
                                 div=4.0)
        assert y.dtype == x.dtype
        assert torch.equal(y.reshape(ll.rows, ll.cols), want)


# ---------------------------------------------------------------------------
# the per-client decode as one tree launch, and the float32 flash kernel
# ---------------------------------------------------------------------------

# (family, k, mode, per-client rounding): every family in the plain mode;
# the rounding modes (ROUND_ONE at k = 1, ROUND_ANY at k = 8) for the
# ±1/±2 families, whose bits the train close must keep (a gaussian
# value an ulp apart may round a client's bf16 sum the other way).
_DECODE_CASES = ([(f, 1, "full", False) for f in FAMILIES]
                 + [(f, 8, m, False) for f in FAMILIES for m in ("full", "block")]
                 + [(f, k, m, True) for f in FAMILIES if f != "gaussian"
                    for k, m in ((1, "full"), (8, "full"), (8, "block"))])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family,k,mode,rounding", _DECODE_CASES)
@pytest.mark.parametrize("n_leaves", [6, 70])
def test_cuda_tree_decode_matches_plain(cuda_device, dtype, family, k, mode, rounding,
                                        n_leaves):
    """``ops.server_update_kernel``: one decode tree launch (two at 70 leaves)
    against the plain tree decode, bitwise for the ±1/±2 families (gaussian
    within rtol/atol 1e-5, plus one bf16 ulp on bf16 leaves), in the plain
    mode and both rounding modes, for cohorts 4 and 33, with aggregation
    weights at 33."""
    dt = getattr(torch, dtype)
    p = _tree(n_leaves, n_leaves + 1, dt)
    rng = np.random.RandomState(k + n_leaves + rounding)
    on = {key: x.to(cuda_device) for key, x in p.items()}
    for n in (4, 33):
        rs = torch.from_numpy(rng.randn(n, k).astype(np.float32))
        seeds = torch.from_numpy(seeds_np(rng, n).astype(np.int64))
        w = torch.from_numpy(rng.rand(n).astype(np.float32)) if n == 33 else None
        kw = dict(mode=ProjectionMode(mode), per_client_rounding=rounding)
        want = ops.server_update_kernel(p, rs, seeds, 0.7, Distribution(family),
                                        weights=w, **kw)
        before = obs.totals()["decode.launches"]
        got = ops.server_update_kernel(
            on, rs.to(cuda_device), seeds.to(cuda_device), 0.7, Distribution(family),
            weights=None if w is None else w.to(cuda_device), **kw)
        assert obs.totals()["decode.launches"] - before == -(-n_leaves // 64)
        for key in p:
            if dt == torch.bfloat16:
                _bf16_decode_close(family, got[key].cpu(), want[key])
            else:
                _assert_fused(family, got[key].cpu(), want[key])


@pytest.mark.parametrize("family", FAMILIES)
def test_cuda_tree_decode_mlp_cohort_1024(cuda_device, family):
    """The runtime's decode route: the MLP tree at the 1024 bucket in one
    launch of one column a thread (the V rule's small end), bitwise."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.tree import tree_plan

    p = _params(4)
    rng = np.random.RandomState(11)
    rs = torch.from_numpy(rng.randn(1024, 1).astype(np.float32))
    seeds = torch.from_numpy(seeds_np(rng, 1024).astype(np.int64))
    leaves = tree_leaves(p)
    plan = tree_plan("decode", [tuple(x.shape) for x in leaves],
                     [x.dtype for x in leaves], 1, ProjectionMode.FULL, cuda_device)
    assert [g.vector for g in plan.groups] == [False]
    want = ops.server_update_kernel(p, rs, seeds, 1.0, Distribution(family))
    before = obs.totals()["decode.launches"]
    got = ops.server_update_kernel({key: v.to(cuda_device) for key, v in p.items()},
                                   rs.to(cuda_device), seeds.to(cuda_device), 1.0,
                                   Distribution(family))
    assert obs.totals()["decode.launches"] == before + 1
    for key in p:
        _assert_fused(family, got[key].cpu(), want[key])


def _smollm_tree(dev, seed: int) -> dict:
    """SmolLM-360M's parameter tree (11 leaves, 361.8M elements) in bf16,
    drawn on the card."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.tree import tree_map

    g = torch.Generator(device=dev).manual_seed(seed)
    return tree_map(lambda m: (0.02 * torch.randn(tuple(m.shape), generator=g, device=dev)
                               ).to(torch.bfloat16),
                    get_arch("smollm-360m").param_shapes())


@pytest.mark.parametrize("family", ["rademacher", "gaussian"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_decode_of_the_applied_rows_is_the_padded_launch(cuda_device, dtype,
                                                              family):
    """The engine's decode-kernel route on the card stages the applied rows
    alone: the decode of the first n rows is bitwise the decode of the same
    rows zero-padded to the bucket, for n across the kernel's 128-pair
    staging and the server cell's 700-950 applied, on SmolLM-360M's bf16
    leaves and on a float32 leaf of its MLP's stacked shape."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fed.runtime.engine import _dev_tensors, _pad_bucket, _stage_weighted
    from torch_parity import closed_round

    if dtype == "bfloat16":
        params = _smollm_tree(cuda_device, 5)
    else:
        g = torch.Generator(device=cuda_device).manual_seed(6)
        params = {"w": torch.randn((32, 960, 2560), generator=g, device=cuda_device)}
    for n in (1, 127, 128, 129, 700, 950, 1024):
        aseeds, acoeffs, ars, _ = closed_round(n, seed=n)
        slots0 = obs.totals()["decode.slots"]
        rs, w, seeds = _stage_weighted(cuda_device, ars, acoeffs, aseeds, True)
        got = ops.server_update_kernel(params, rs, seeds, 1.0, Distribution(family),
                                       weights=w)
        assert obs.totals()["decode.slots"] - slots0 == n
        rs, w, seeds = _dev_tensors(cuda_device, *_pad_bucket(ars, acoeffs, aseeds))
        want = ops.server_update_kernel(params, rs, seeds, 1.0, Distribution(family),
                                        weights=w)
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            assert x.dtype == getattr(torch, dtype) and torch.equal(x, y), n


def test_cuda_engine_round_decodes_the_applied_rows(cuda_device):
    """One ``EngineCore.apply_round`` on the card at 700 applied uploads
    (the decode kernel's route, threshold 512) on SmolLM-360M's bf16 tree:
    700 slots decoded, bitwise the bucket's launch, and the digest replay
    (``verify_replay``) lands on the server's bits through its own 700."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fed.runtime.engine import _dev_tensors, _pad_bucket
    from torch_parity import closed_round, server_core

    a = 700
    params = _smollm_tree(cuda_device, 7)
    core = server_core(params, cuda_device, downlink_mode="digest", verify_replay=True)
    assert core.kern_thresh == 512
    aseeds, acoeffs, ars, st = closed_round(a, seed=3)
    slots0 = obs.totals()["decode.slots"]
    got, method, _ = core.apply_round(params, aseeds, acoeffs, ars, a, st)
    assert method is True and obs.totals()["decode.slots"] - slots0 == a
    core.close_digest(0, aseeds, acoeffs, ars, st, np.arange(a), got, method)
    assert obs.totals()["decode.slots"] - slots0 == 2 * a
    rs, w, seeds = _dev_tensors(cuda_device, *_pad_bucket(ars, acoeffs, aseeds))
    want = core.proto.server_apply(params, rs, seeds, w, use_kernel=True)
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rounding", [False, True])
def test_cuda_decode_offsets_and_narrow_leaf(cuda_device, dtype, rounding):
    """The one-leaf decode with nonzero row/col offsets and BLOCK bounds,
    and the narrow 524 288 × 1 leaf (C1), in the plain and the rounding
    modes, bitwise against ``reconstruct_plain``."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(17 + rounding)
    x = torch.from_numpy(rng.randn(37, 300).astype(np.float32)).to(dt)
    rs = torch.from_numpy(rng.randn(45, 3).astype(np.float32))
    seeds = torch.from_numpy(seeds_np(rng, 45).astype(np.int64))
    lo = torch.tensor([0.0, 5000.0, 9000.0])
    hi = torch.tensor([5000.0, 9000.0, 20000.0])
    kw = dict(per_client_rounding=rounding, div=45.0)
    want = reconstruct_plain(x, seeds, rs, 2, 0.5, lo, hi, "rademacher", True, 40, 9,
                             310, **kw)
    got = reconstruct_apply_clients(
        x.to(cuda_device), seeds.to(cuda_device), rs.to(cuda_device), 2, 0.5,
        "rademacher", lo=lo.to(cuda_device), hi=hi.to(cuda_device), masked=True,
        row_offset=40, col_offset=9, orig_cols=310, **kw)
    assert torch.equal(got.cpu().float(), want.float())
    x = torch.from_numpy(rng.randn(524_288, 1).astype(np.float32)).to(dt)
    rs, seeds = rs[:20, :1], seeds[:20]
    kw = dict(per_client_rounding=rounding, div=20.0)
    want = reconstruct_plain(x, seeds, rs, 3, 0.05, None, None, **kw)
    got = reconstruct_apply_clients(x.to(cuda_device), seeds.to(cuda_device),
                                    rs.contiguous().to(cuda_device), 3, 0.05, **kw)
    assert torch.equal(got.cpu().float(), want.float())


def _check_f32(dev, b, s, t, h, kh, hd, *, causal=True, window=0, qpos=None,
               kpos=None, seed=0):
    """The float32 kernel (through ``flash_route``'s "f32") against the plain
    version on the rows with an allowed key, ``flash_agrees`` (rtol 1e-3,
    atol 2e-5); rows with none are zeros."""
    assert flash_route(s, h, kh, torch.float32) == "f32"
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g)
               for shape in ((b, s, h, hd), (b, t, kh, hd), (b, t, kh, hd)))
    qpos = torch.arange(t - s, t, dtype=torch.int32) if qpos is None else qpos
    kpos = torch.arange(t, dtype=torch.int32) if kpos is None else kpos
    args = [x.to(dev) for x in (q, k, v, qpos, kpos)]
    before = obs.totals()["flash_f32.launches"]
    got = flash_attention(*args, causal=causal, window=window)
    want = flash_attention_plain(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert obs.totals()["flash_f32.launches"] == before + 1
    rows = allowed_mask(qpos, kpos, causal, window).any(dim=1).to(dev)
    assert bool(rows.any())
    gr, wr = got[:, rows], want[:, rows]
    assert flash_agrees(gr, wr), flash_compare(gr, wr)
    assert bool((got[:, ~rows] == 0).all())


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("heads", [(4, 4), (6, 2), (4, 1)], ids=["mha", "gqa3", "mqa"])
def test_cuda_flash_f32_kernel(cuda_device, hd, heads):
    """The register-tiled float32 kernel at S·G and T that its tiles (128
    rows, 64 or 32 keys) do not divide: causal and not, a window, kpos -1
    holes with padding queries, and a wrapped ring (unsorted kpos)."""
    h, kh = heads
    for window in (0, 64):
        _check_f32(cuda_device, 2, 200, 333, h, kh, hd, window=window, seed=1)
        _check_f32(cuda_device, 1, 77, 77, h, kh, hd, causal=False, window=window,
                   seed=2)
    kpos = torch.arange(333, dtype=torch.int32)
    kpos[::7] = -1
    qpos = torch.arange(333, dtype=torch.int32)
    qpos[:50] = -1
    _check_f32(cuda_device, 1, 333, 333, h, kh, hd, window=64, qpos=qpos, kpos=kpos,
               seed=3)
    _check_f32(cuda_device, 1, 333, 333, h, kh, hd, causal=False, qpos=qpos, kpos=kpos,
               seed=4)
    ring = _ring(1000, 1499)
    for window in (0, 64, 1000):
        _check_f32(cuda_device, 2, 300, 1000, h, kh, hd, window=window,
                   qpos=torch.arange(1200, 1500, dtype=torch.int32), kpos=ring, seed=5)


# ---- QSGD tree launches (qsgd_tree: the norm pass and one quantize launch
# per group of 64 leaves) ----

_QSGD_MLP = [(24,), (12,), (10,), (64, 24), (24, 12), (12, 10)]


def _qsgd_leaves(case, dtype, n=None):
    """(leaves (N, *shape) on the CPU, N) of a named tree; client 1 of the
    MLP tree is all zeros (norm → 1, levels 0)."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(len(case) + len(dtype))
    if case == "mlp":
        n = n or 256
        shapes = _QSGD_MLP
    elif case == "70":
        n = n or 20
        shapes = [tuple(v.shape) for v in _tree(70, 0, torch.float32).values()]
    else:                                   # C1's narrow leaf
        n = n or 2
        shapes = [(262_144, 2)]
    leaves = [torch.from_numpy((rng.randn(n, *sh) * 0.01).astype(np.float32)).to(dt)
              for sh in shapes]
    if case == "mlp":
        for x in leaves:
            x[1] = 0.0
    return leaves, n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("case", ["mlp", "70", "narrow"])
def test_cuda_qsgd_tree_matches_plain(cuda_device, dtype, bits, case):
    """The tree kernel bitwise against ``qsgd_tree_plain`` given the kernel's
    own norms (q and the payload); its norms within ``norm_tolerance`` of
    the float64 norm, the same bits on a rerun, two launches per group."""
    from repro_torch.kernels.qsgd_quant import (
        norm_tolerance,
        qsgd_tree,
        qsgd_tree_plain,
    )
    from repro_torch.kernels.tree import MAX_TREE_LEAVES

    leaves, n = _qsgd_leaves(case, dtype)
    levels = (1 << (bits - 1)) - 1
    seeds = torch.from_numpy(seeds_np(np.random.RandomState(bits), n).astype(np.int64))
    on = [x.to(cuda_device) for x in leaves]
    before = obs.totals()["qsgd.launches"]
    q, payload, norms = qsgd_tree(on, seeds.to(cuda_device), levels, want_q=True,
                                  want_levels=True)
    groups = -(-len(leaves) // MAX_TREE_LEAVES)
    assert obs.totals()["qsgd.launches"] - before == 2 * groups
    q2, payload2, norms2 = qsgd_tree(on, seeds.to(cuda_device), levels,
                                     want_q=True, want_levels=True)
    torch.cuda.synchronize()
    assert torch.equal(payload, payload2) and torch.equal(norms, norms2)
    assert all(torch.equal(a, b) for a, b in zip(q, q2))
    qp, pp, _ = qsgd_tree_plain(leaves, seeds, levels, want_q=True, want_levels=True,
                                norms=norms.cpu().contiguous())
    assert torch.equal(payload.cpu(), pp)
    for a, b in zip(q, qp):
        assert a.dtype == b.dtype and torch.equal(a.cpu().float(), b.float())
    for i, x in enumerate(leaves):
        err = (norms[:, i].cpu().double()
               - torch.linalg.vector_norm(x.double().reshape(n, -1), dim=1)).abs()
        nonzero = x.reshape(n, -1).abs().sum(dim=1) > 0
        assert (err[nonzero] <= norm_tolerance(x)[nonzero]).all()
        assert (norms[:, i].cpu()[~nonzero] == 1).all()
    if case == "mlp":
        assert float(payload[1, :-len(leaves)].abs().sum()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_qsgd_tree_norms_do_not_depend_on_the_split(cuda_device, dtype):
    """The 70-leaf tree's two launch groups give each leaf the norm it gets
    as a tree of its own (a norm sums its own spans in a fixed order)."""
    from repro_torch.kernels.qsgd_quant import qsgd_tree

    leaves, n = _qsgd_leaves("70", dtype)
    seeds = torch.from_numpy(seeds_np(np.random.RandomState(3), n).astype(np.int64)
                             ).to(cuda_device)
    on = [x.to(cuda_device) for x in leaves]
    _, _, norms = qsgd_tree(on, seeds, 127, want_q=True)
    for i, x in enumerate(on):
        _, _, alone = qsgd_tree([x], seeds, 127, want_q=True)
        assert torch.equal(alone[:, 0], norms[:, i])


@pytest.mark.parametrize("shape", ["n", "nl"])
def test_cuda_qsgd_tree_given_norms(cuda_device, shape):
    """Norms given as (N,) or (N, L): one launch, bitwise the plain version."""
    from repro_torch.kernels.qsgd_quant import qsgd_tree, qsgd_tree_plain

    leaves, n = _qsgd_leaves("mlp", "float32", n=33)
    rng = np.random.RandomState(5)
    seeds = torch.from_numpy(seeds_np(rng, n).astype(np.int64))
    norms = torch.from_numpy(rng.rand(n, len(leaves)).astype(np.float32) + 0.01)
    if shape == "n":
        norms = norms[:, 0].contiguous()
    before = obs.totals()["qsgd.launches"]
    q, payload, got = qsgd_tree([x.to(cuda_device) for x in leaves],
                                seeds.to(cuda_device), 7, want_q=True, want_levels=True,
                                norms=norms.to(cuda_device))
    assert obs.totals()["qsgd.launches"] - before == 1
    qp, pp, want = qsgd_tree_plain(leaves, seeds, 7, want_q=True, want_levels=True,
                                   norms=norms)
    assert torch.equal(payload.cpu(), pp) and torch.equal(got.cpu(), want)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(q, qp))


def test_cuda_qsgd_protocol_encode_is_one_tree_call(cuda_device):
    """``QSGDProtocol.encode_cohort`` at a runtime chunk: two launches, the
    payload bitwise the plain version's given the kernel's norms."""
    from repro_torch.core import qsgd as tq
    from repro_torch.fed.protocols import make_protocol
    from repro_torch.kernels.qsgd_quant import qsgd_tree_plain

    p = init_mlp(device="cpu")
    proto = make_protocol("qsgd", p)
    rng = np.random.RandomState(9)
    deltas = {k: torch.from_numpy((rng.randn(256, *v.shape) * 0.01).astype(np.float32))
              for k, v in p.items()}
    ids = torch.arange(1000, 1256)
    before = obs.totals()["qsgd.launches"]
    got = proto.encode_cohort({k: v.to(cuda_device) for k, v in deltas.items()}, None,
                              4, ids.to(cuda_device))
    assert obs.totals()["qsgd.launches"] - before == 2
    leaves = [deltas[k] for k in sorted(deltas)]
    _, want, _ = qsgd_tree_plain(leaves, tq.quant_seeds(4, ids), 127, want_q=False,
                                 want_levels=True,
                                 norms=got[:, proto.d:].cpu().contiguous())
    assert torch.equal(got.cpu(), want)


def test_cuda_qsgd_tree_checks_inputs(cuda_device):
    from repro_torch.kernels.qsgd_quant import qsgd_tree

    x = torch.zeros((2, 4, 8), device=cuda_device)
    seeds = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        qsgd_tree([x.double()], seeds, 127)
    with pytest.raises(ValueError):
        qsgd_tree([x[:1]], seeds, 127)                      # not N clients
    with pytest.raises(ValueError):
        qsgd_tree([x.cpu()], seeds, 127)                    # another device
    with pytest.raises(ValueError):
        qsgd_tree([x.transpose(1, 2)], seeds, 127)          # not contiguous
    with pytest.raises(ValueError):
        qsgd_tree([x], seeds, 300)
    with pytest.raises(ValueError):
        qsgd_tree([x], seeds, 127, norms=torch.ones(3, device=cuda_device))
    with pytest.raises(ValueError):
        qsgd_tree([x], seeds, 127, want_q=False, want_levels=False)


# ---------------------------------------------------------------------------
# the mesh-sharded server over shard plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", MODES)
def test_cuda_sharded_paths_match_plain(cuda_device, shards, family, k, mode):
    """On a (1, S) mesh of the card: the sharded decode and fused close
    (one launch per 64 (shard, leaf) entries) against the CPU's plain
    versions over the same shard plan (gaussian within rtol/atol 1e-5) and
    bitwise the unsharded kernels; the sharded encode within
    ``tree_encode_tolerance`` of the shards' views of the float64 plain
    encode."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.seeded_projection import (
        project_tree_plain,
        tree_encode_tolerance,
    )
    from repro_torch.kernels.tree import tree_plan
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.sharding import fed_rules as fr

    p = _params(shards)
    on = {key: v.to(cuda_device) for key, v in p.items()}
    mesh, cpu_mesh = make_fed_mesh((1, shards)), make_fed_mesh((1, shards), "cpu")
    dist, pm = Distribution(family), ProjectionMode(mode)
    rng = np.random.RandomState(k + shards)
    rs = torch.from_numpy(rng.randn(37, k).astype(np.float32))
    seeds = torch.from_numpy(seeds_np(rng, 37).astype(np.int64))
    rs_d, seeds_d = rs.to(cuda_device), seeds.to(cuda_device)
    groups = -(-shards * len(p) // 64)
    for fused, counter in ((False, "decode.launches"), (True, "close.launches")):
        before = obs.totals()[counter]
        got = fr.sharded_server_update(mesh, on, rs_d, seeds_d, 0.7, dist, mode=pm,
                                       use_fused=fused)
        assert obs.totals()[counter] - before == groups
        want = fr.sharded_server_update(cpu_mesh, p, rs, seeds, 0.7, dist, mode=pm,
                                        use_fused=fused)
        flat = (ops.server_update_fused if fused else ops.server_update_kernel)(
            on, rs_d, seeds_d, 0.7, dist, mode=pm)
        for key in p:
            _assert_fused(family, got[key].cpu(), want[key])
            assert torch.equal(got[key], flat[key])
    delta = {key: v * 0.01 for key, v in on.items()}
    got = fr.sharded_project_tree(mesh, delta, 99, dist, k, pm)
    assert torch.equal(got, fr.sharded_project_tree(mesh, delta, 99, dist, k, pm))
    leaves = tree_leaves(delta)
    uplan = tree_plan("encode", [tuple(x.shape) for x in leaves],
                      [x.dtype for x in leaves], k, pm, cuda_device)
    exact = project_tree_plain([x[None] for x in leaves],
                               torch.tensor([99], device=cuda_device), uplan, family,
                               dtype=torch.float64)[0]
    plan = fr.plan_tree(delta, shards)
    views = [x[None] for ls, v in zip(plan.leaves, fr.to_sharded_2d(delta, plan))
             for x in fr._split(v, ls, mesh)]
    assert ((got.double() - exact).abs()
            <= tree_encode_tolerance(views, family)[0]).all()


def test_cuda_sharded_col_1d_block_encode(cuda_device):
    """A col-sharded 1-D leaf in BLOCK mode: the encode's tile skip spans
    whole rows of global coordinates, a superset of each shard's cols."""
    from repro_torch.kernels.seeded_projection import tree_encode_tolerance
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.sharding import fed_rules as fr

    x = torch.from_numpy(np.random.RandomState(2).randn(4800).astype(np.float32))
    for shards in (3, 8):
        for k in (2, 5):
            got = fr.sharded_project_tree(make_fed_mesh((1, shards)),
                                          {"w": x.to(cuda_device)}, 21,
                                          Distribution.RADEMACHER, k,
                                          ProjectionMode.BLOCK)
            want = fr.sharded_project_tree(make_fed_mesh((1, shards), "cpu"),
                                           {"w": x.double()}, 21,
                                           Distribution.RADEMACHER, k,
                                           ProjectionMode.BLOCK)
            tol = tree_encode_tolerance([x.reshape(1, 1, -1)], "rademacher")[0]
            assert ((got.cpu().double() - want).abs() <= 2 * tol).all()


def test_cuda_mesh_run_is_the_decode_route(cuda_device):
    """``run_federation`` under ``mesh_shape=(2, 4)`` on the card, digest
    downlink with the shadow replay: bitwise the decode-route run."""
    from repro_torch.data import load_digits, make_client_datasets
    from repro_torch.data import train_test_split_arrays
    from repro_torch.fed.runtime import RuntimeConfig, run_federation

    x, y = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    clients = make_client_datasets(xtr, ytr, 8)
    base = dict(rounds=3, population=64, participation=0.25, seed=1,
                downlink_mode="digest", verify_replay=True,
                kernel_cohort_threshold=1)
    h = {mesh: run_federation(RuntimeConfig(mesh_shape=mesh, **base),
                              init_mlp(seed=0, device=cuda_device), clients, xte,
                              yte, device=cuda_device)
         for mesh in ((2, 4), None)}
    assert h[(2, 4)]["sharding"]["devices"] == 8
    for key in h[None]["final_params"]:
        assert torch.equal(h[(2, 4)]["final_params"][key],
                           h[None]["final_params"][key])


# ---------------------------------------------------------------------------
# the FedScalar tree kernels on a leaf past 2³¹ elements
# ---------------------------------------------------------------------------

# 131 136 × 16 384 bf16: 2³¹ + 2²⁰ elements (4 GiB), past the int range
# that the table's fields once held.
_LARGE = (131136, 16384)


@pytest.mark.parametrize("kind", ["encode", "close", "decode"])
def test_cuda_tree_leaf_past_2_31_elements(cuda_device, kind):
    """One tree launch over a leaf of 2³¹ + 2²⁰ bf16 elements: the decode
    (N = 4, per-client rounding) and the fused close (N = 4) bitwise their
    plain versions on the leaf's first and last 64 rows (the plain
    versions at those rows' coordinates), the encode (N = 1) within
    ``encode_tolerance`` of its plain float64 sum over the whole leaf."""
    rows, cols = _LARGE
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(_LARGE, generator=gen, device=cuda_device).to(torch.bfloat16)
    seeds = torch.tensor([101, 202, 303, 404], dtype=torch.int64, device=cuda_device)
    rs = torch.tensor([[0.5], [-1.25], [2.0], [0.75]], device=cuda_device)
    if kind == "encode":
        before = obs.totals()["encode.launches"]
        r = ops.project_tree_kernel({"w": x[None]}, seeds[:1])
        assert obs.totals()["encode.launches"] - before == 2
        exact = project_blocks_plain(x[None], seeds[:1], 0, torch.zeros(1, device=cuda_device),
                                     torch.full((1,), 1e12, device=cuda_device),
                                     dtype=torch.float64)
        tol = encode_tolerance(x[None], "rademacher")
        assert ((r.double() - exact).abs() <= tol).all()
        return
    if kind == "close":
        before = obs.totals()["close.launches"]
        y = ops.server_update_fused({"w": x}, rs, seeds)["w"]
        assert obs.totals()["close.launches"] - before == 1
        seeds_p, rs_p = pad_cohort(seeds, rs * torch.tensor(0.25, device=cuda_device))
        lo, hi = torch.zeros(1, device=cuda_device), torch.zeros(1, device=cuda_device)
        for r0 in (0, rows - 64):
            want = fused_apply_plain(x[r0:r0 + 64], seeds_p, rs_p, 0, lo, hi,
                                     row_offset=r0, orig_cols=cols)
            assert torch.equal(y[r0:r0 + 64], want)
        return
    before = obs.totals()["decode.launches"]
    y = ops.server_update_kernel({"w": x}, rs, seeds, per_client_rounding=True)["w"]
    assert obs.totals()["decode.launches"] - before == 1
    for r0 in (0, rows - 64):
        want = reconstruct_plain(x[r0:r0 + 64], seeds, rs, 0, 1.0, None, None,
                                 row_offset=r0, orig_cols=cols,
                                 per_client_rounding=True, div=4.0)
        assert torch.equal(y[r0:r0 + 64], want)


# ---------------------------------------------------------------------------
# the fused close's tiles and its autotuner (kernels/tune.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", MODES)
def test_cuda_fused_tiles_give_the_default_bits(cuda_device, family, k, mode):
    """Every tile of ``tree.CLOSE_TILES`` bitwise the default tile, and
    against the plain version as the default is: the MLP tree (N = 20,
    float32) and a (960, 2560) bf16 leaf (N = 33); BLOCK k = 8 masks."""
    from repro_torch.kernels.tree import CLOSE_TILES

    rng = np.random.RandomState(k + 5)
    dist = Distribution(family)
    trees = [
        (_params(2), 20),
        ({"w": torch.from_numpy(rng.randn(960, 2560).astype(np.float32)).to(
            torch.bfloat16)}, 33),
    ]
    for p, n in trees:
        rs = torch.from_numpy(rng.randn(n, k).astype(np.float32))
        seeds = torch.from_numpy(seeds_np(rng, n).astype(np.int64))
        want = ops.server_update_fused(p, rs, seeds, 0.8, dist,
                                       mode=ProjectionMode(mode))
        dev = ({key: v.to(cuda_device) for key, v in p.items()},
               rs.to(cuda_device), seeds.to(cuda_device))
        default = ops.server_update_fused(*dev, 0.8, dist, mode=ProjectionMode(mode))
        for tile in CLOSE_TILES:
            before = obs.totals()["close.launches"]
            got = ops.server_update_fused(*dev, 0.8, dist, mode=ProjectionMode(mode),
                                          block=tile)
            assert obs.totals()["close.launches"] - before == 1
            for key in p:
                assert torch.equal(got[key], default[key]), (tile, key)
                g = got[key].cpu()
                if family == "gaussian":
                    torch.testing.assert_close(
                        g.float(), want[key].float(), rtol=1e-5 + (
                            2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0),
                        atol=1e-5)
                else:
                    assert torch.equal(g, want[key]), (tile, key)


def test_cuda_autotune_sweeps_the_tiles_once(cuda_device, tmp_path):
    """A real sweep at the paper MLP's dominant leaf: the winner is a tile
    of the kernel, stored under the card's key; a hit does not time."""
    from repro_torch.kernels import tune
    from repro_torch.kernels.tree import CLOSE_TILES

    path = str(tmp_path / "tune.json")
    assert tune.backend_of(cuda_device) == "cuda-sm_90a"
    won = tune.autotune_fused(64, 24, 20, 1, "rademacher", cache_path=path,
                              device=cuda_device)
    assert won["impl"] == "cuda" and tuple(won["block"]) in CLOSE_TILES

    def raising(cand):
        raise AssertionError("a hit must not time")

    assert tune.autotune_fused(64, 24, 32, 1, "rademacher", cache_path=path,
                               measure=raising, device=cuda_device) == won
    assert tune.cached_fused_params(64, 24, 20, 1, "rademacher", cache_path=path,
                                    device=cuda_device) == won


def test_cuda_qsgd_payload_past_2_31_columns(cuda_device):
    """A two-leaf tree whose second leaf starts at payload column 2³¹ (the
    first is 2³¹ bf16 elements, 4 GiB): q and the payload bitwise
    ``qsgd_tree_plain``'s given the kernel's norms, on the first leaf's
    first and last 256 rows and the whole second leaf; the norms within
    ``norm_tolerance``."""
    from repro_torch.kernels.common import fold_seed
    from repro_torch.kernels.qsgd_quant import norm_depth, qsgd_tree

    rows, cols = 65536, 32768
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    big = torch.randn((1, rows, cols), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    small = torch.randn((1, 8, 8), generator=gen, device=cuda_device)
    seeds = torch.tensor([12345], dtype=torch.int64, device=cuda_device)
    before = obs.totals()["qsgd.launches"]
    q, pay, norms = qsgd_tree([big, small], seeds, 127, want_q=True, want_levels=True)
    assert obs.totals()["qsgd.launches"] - before == 2
    d = rows * cols
    assert pay.shape == (1, d + 64 + 2)
    for tag, x in enumerate((big, small)):
        sq = sum(float(x[:, r0:r0 + 4096].double().pow(2).sum())
                 for r0 in range(0, x.shape[1], 4096))
        exact = sq ** 0.5
        assert abs(float(norms[0, tag]) - exact) <= norm_depth(x[0].numel()) * 2.0 ** -24 * exact
    folded = fold_seed(seeds, 0)
    for r0 in (0, rows - 256):
        qp, lp = qsgd_quantize_plain(big[:, r0:r0 + 256], folded, norms[:, 0], 127,
                                     True, True, row_offset=r0)
        assert torch.equal(q[0][:, r0:r0 + 256], qp)
        assert torch.equal(pay[:, r0 * cols:(r0 + 256) * cols], lp.reshape(1, -1))
    qp, lp = qsgd_quantize_plain(small, fold_seed(seeds, 1), norms[:, 1].contiguous(),
                                 127, True, True)
    assert torch.equal(q[1], qp)
    assert torch.equal(pay[:, d:d + 64], lp.reshape(1, -1))
    assert torch.equal(pay[:, d + 64:], norms)


# ---------------------------------------------------------------------------
# the train step on a device mesh (sharding/resident.py): meshes whose
# entries all name the one card
# ---------------------------------------------------------------------------

@pytest.fixture
def deterministic():
    """Deterministic algorithms (the embedding's backward sums in a fixed
    order), so that two rounds can be compared bit for bit."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _mesh_setup(dev, dtype, shape, name="smollm-360m"):
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.models.api import Arch

    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
    if name == "smollm-360m":       # the GQA variant
        cfg = dataclasses.replace(cfg, d_model=384, num_heads=6, num_kv_heads=2,
                                  head_dim=64)
    arch = Arch(cfg)
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size,
                                                             (8, 33))).to(dev)
    mesh = make_fed_mesh(shape, devices=[dev] * (shape[0] * shape[1]))
    return arch, arch.init(seed=0, device=dev), {"tokens": toks[:, :-1],
                                                 "labels": toks[:, 1:]}, mesh


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 4), (1, 3)], ids=["1x4", "1x3"])
def test_cuda_mesh_train_step_one_group_is_bitwise(cuda_device, deterministic, shape,
                                                    dtype, monkeypatch):
    """One data group on the card: the loss and every δ bitwise the unsharded
    round's, each r (the sharded encode kernel) within
    ``tree_encode_tolerance`` of the float64 encode of its δ, and, given the
    unsharded r, the close (the per-client decode kernel on every mesh
    entry) bitwise the unsharded close; two encode counts per entry and
    client, one close launch per entry."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.seeded_projection import (
        project_tree_plain,
        tree_encode_tolerance,
    )
    from repro_torch.kernels.tree import tree_plan
    from repro_torch.launch.train import FLRunConfig, make_train_step
    from repro_torch.sharding import fed_rules
    from repro_torch.sharding.resident import shard_resident

    arch, params, batch, mesh = _mesh_setup(cuda_device, dtype, shape)
    fl = FLRunConfig(num_virtual_clients=2, local_steps=2, local_lr=0.05)
    leaves = tree_leaves(params)
    u_deltas, u_rs = [], []
    project = ops.project_tree_kernel

    def spy_u(delta, seeds, *a):
        u_deltas.append([d[0].clone() for d in tree_leaves(delta)])
        r = project(delta, seeds, *a)
        u_rs.append(r[0])
        return r

    monkeypatch.setattr(ops, "project_tree_kernel", spy_u)
    u_new, u_m = make_train_step(arch, fl)(params, batch, 4)
    monkeypatch.undo()
    plan = tree_plan("encode", [tuple(w.shape) for w in leaves], [w.dtype for w in leaves],
                     1, ProjectionMode.FULL, cuda_device)
    sharded = fed_rules.sharded_project_tree
    seen = []

    def spy_m(mesh_, delta, seed, *a):
        i = len(seen)
        for j, w in enumerate(u_deltas[i]):
            assert torch.equal(delta.gather(j, cuda_device), w)
        r = sharded(mesh_, delta, seed, *a)
        exact = project_tree_plain([w[None] for w in u_deltas[i]], seed.reshape(1), plan,
                                   dtype=torch.float64)
        tol = tree_encode_tolerance([x[None] for x in delta.flat_shards()], "rademacher")
        assert abs(float(r[0]) - float(exact[0, 0])) <= float(tol[0, 0])
        seen.append(r)
        return u_rs[i]

    monkeypatch.setattr(fed_rules, "sharded_project_tree", spy_m)
    enc0, rec0 = obs.totals()["encode.launches"], obs.totals()["decode.launches"]
    new, m = make_train_step(arch, fl, mesh=mesh)(shard_resident(params, mesh), batch, 4)
    entries = len(mesh.device_groups())
    assert obs.totals()["encode.launches"] - enc0 == 2 * 2 * entries
    assert obs.totals()["decode.launches"] - rec0 == entries
    assert len(seen) == 2 and torch.equal(m["loss"], u_m["loss"])
    for j, w in enumerate(tree_leaves(u_new)):
        assert torch.equal(new.gather(j, cuda_device), w)


@pytest.mark.parametrize("name,dtype", [("smollm-360m", "float32"),
                                        ("smollm-360m", "bfloat16"),
                                        ("qwen3-moe-30b-a3b", "float32")])
def test_cuda_mesh_train_step_two_data_groups(cuda_device, name, dtype):
    """A (2, 2) mesh on the card against the unsharded round (the MoE
    layers dispatching each data group as the whole batch): float32
    within the CPU tests' limits (loss 1e-5, r 1e-5·(1 + |r|), params
    Σₙ|Δrₙ|/N + 1e-6); bf16 r within 2⁻⁸·√S·‖x‖₂ and the params within
    Σₙ(|Δrₙ| + 2⁻⁸(|rₙ| + |r'ₙ|))/N plus one bf16 ulp (each client's
    reconstruction is rounded to bf16)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.train import FLRunConfig, make_train_step
    from repro_torch.sharding.resident import shard_resident

    arch, params, batch, mesh = _mesh_setup(cuda_device, dtype, (2, 2), name)
    fl = FLRunConfig(num_virtual_clients=2, local_steps=2, local_lr=0.05)
    u_new, u_m = make_train_step(arch, fl)(params, batch, 6)
    new, m = make_train_step(arch, fl, mesh=mesh)(shard_resident(params, mesh), batch, 6)
    assert torch.equal(m["seeds"], u_m["seeds"])
    dr = (m["r"] - u_m["r"]).abs()
    if dtype == "float32":
        assert abs(float(m["loss"]) - float(u_m["loss"])) <= 1e-5
        assert bool((dr <= 1e-5 * (1 + u_m["r"].abs())).all())
        spread, ulp = float(dr.sum()) / 2 + 1e-6, 0.0
    else:
        assert abs(float(m["loss"]) - float(u_m["loss"])) <= 1e-2
        norm = float(sum((w.float() ** 2).sum() for w in tree_leaves(params))) ** 0.5
        assert float(dr.max()) <= 2.0 ** -8 * 2 ** 0.5 * norm
        spread = float((dr + 2.0 ** -8 * (m["r"].abs() + u_m["r"].abs())).sum()) / 2
        ulp = 2.0 ** -7
    for j, w in enumerate(tree_leaves(u_new)):
        a, b = new.gather(j, cuda_device).float(), w.float()
        assert bool(((a - b).abs() <= spread + ulp * torch.maximum(a.abs(), b.abs())).all())


def test_cuda_resident_placement(cuda_device, tmp_path):
    """Arch.init on a mesh of the card bitwise the unsharded init, every
    period's gather the stacked leaf's slice, and a checkpoint saved from a
    (2, 4) resident tree restored onto a (4, 2) one, bitwise."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.sharding.resident import ResidentTree

    arch, params, _, mesh = _mesh_setup(cuda_device, "bfloat16", (2, 4))
    rt = arch.init(seed=0, device=cuda_device, mesh=mesh)
    assert isinstance(rt, ResidentTree)
    stacked = rt.stacked_leaves(arch.stacked_keys)
    for j, w in enumerate(tree_leaves(params)):
        assert torch.equal(rt.gather(j, cuda_device), w)
        for i in range(w.shape[0] if stacked[j] else 0):
            assert torch.equal(rt.gather(j, cuda_device, i), w[i])
    save_checkpoint(str(tmp_path), rt, step=2)
    other = make_fed_mesh((4, 2), devices=[cuda_device] * 8)
    got, step, _ = restore_checkpoint(str(tmp_path), params, mesh=other)
    assert step == 2 and got.mesh is other
    for a, b in zip(tree_leaves(got.unshard(cuda_device)), tree_leaves(params)):
        assert a.device.type == "cuda" and torch.equal(a, b)


# ---------------------------------------------------------------------------
# serving from resident shards and the client-parallel step on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["zero3", "tp"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_cuda_mesh_serve_is_bitwise(cuda_device, shape, layout, monkeypatch):
    """Reduced GQA SmolLM in bf16 served from resident shards on the card
    (the blocked threshold at 16, so the flash kernels serve a 40-token
    prompt): on (1, 4) the logits and every cache tensor bitwise the
    unsharded serve's, on (2, 2) each data group's bitwise the unsharded
    serve of its own rows; one flash prefill launch per layer and group,
    one decode launch per layer, group and step."""
    import repro_torch.models.attention as t_attention
    from repro_torch.core.tree import tree_leaves
    from repro_torch.sharding.resident import place_rows, shard_resident

    monkeypatch.setattr(t_attention, "BLOCKED_SDPA_THRESHOLD", 16)
    arch, params, batch, mesh = _mesh_setup(cuda_device, "bfloat16", shape)
    tokens = torch.cat([batch["tokens"]] * 2, dim=1)[:4, :40]

    def serve(p, tok):
        with torch.no_grad():
            logits, caches = arch.prefill(p, {"tokens": tok}, capacity=48)
            out = [logits]
            for i in range(3):
                nxt = torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)
                logits, caches = arch.decode(p, nxt, caches, 40 + i)
                out.append(logits)
        groups = caches.groups if hasattr(caches, "groups") else (caches,)
        return out, [tree_leaves(tuple(c)) for c in groups]

    place = shard_resident if layout == "zero3" else place_rows
    counters = ["flash_prefill.launches", "flash_decode.launches", "flash_f32.launches"]
    before = _launches(counters)
    got, got_caches = serve(place(params, mesh), tokens)
    launched = [n - b for n, b in zip(_launches(counters), before)]
    d, layers = shape[0], arch.cfg.num_layers
    assert launched == [d * layers, d * layers * 3, 0]
    rows = tokens.shape[0] // d
    for g in range(d):
        want, want_caches = serve(params, tokens[g * rows:(g + 1) * rows])
        for a, b in zip(got, want):
            assert torch.equal(a[g * rows:(g + 1) * rows], b)
        assert all(torch.equal(a, b) for a, b in zip(got_caches[g], want_caches[0]))


def test_cuda_mesh_client_parallel_step(cuda_device, deterministic, monkeypatch):
    """The client-parallel step on a (2, 2) mesh of the card (reduced GQA
    SmolLM, bf16, N = 4, S = 2): each δ bitwise the one-device step run on
    its row's clients alone, each r (the sharded encode kernel over the
    row's entries) within ``tree_encode_tolerance`` of the float64 encode
    of its δ, and, given the one-device r, the close bitwise the one-device
    close; two encode counts per row entry and client, one close launch
    per mesh entry."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.seeded_projection import (
        project_tree_plain,
        tree_encode_tolerance,
    )
    from repro_torch.kernels.tree import tree_plan
    from repro_torch.launch.train import FLRunConfig, make_train_step_client_parallel
    from repro_torch.sharding import fed_rules
    from repro_torch.sharding.resident import shard_resident

    arch, params, batch, mesh = _mesh_setup(cuda_device, "bfloat16", (2, 2))
    fl = FLRunConfig(num_virtual_clients=4, local_steps=2, local_lr=0.05)
    u_new, u_m = make_train_step_client_parallel(arch, fl)(params, batch, 4)
    encode = ops.project_tree_kernel
    row_deltas = []

    def keep(d, seeds, *a):
        stacked = tree_leaves(d)
        row_deltas.extend([w[c].clone() for w in stacked] for c in range(stacked[0].shape[0]))
        return encode(d, seeds, *a)

    monkeypatch.setattr(ops, "project_tree_kernel", keep)
    row_fl = FLRunConfig(num_virtual_clients=2, local_steps=2, local_lr=0.05)
    for r in range(2):
        make_train_step_client_parallel(arch, row_fl)(
            params, {k: v[r * 4:(r + 1) * 4] for k, v in batch.items()}, 4)
    monkeypatch.undo()
    leaves = tree_leaves(params)
    plan = tree_plan("encode", [tuple(w.shape) for w in leaves], [w.dtype for w in leaves],
                     1, ProjectionMode.FULL, cuda_device)
    sharded = fed_rules.sharded_project_tree
    seen = []

    def check(row_mesh, delta, seed, *a):
        i = len(seen)
        for j, w in enumerate(row_deltas[i]):
            assert torch.equal(delta.gather(j, cuda_device), w)
        r = sharded(row_mesh, delta, seed, *a)
        exact = project_tree_plain([w[None] for w in row_deltas[i]], seed.reshape(1),
                                   plan, dtype=torch.float64)
        tol = tree_encode_tolerance([x[None] for x in delta.flat_shards()], "rademacher")
        assert abs(float(r[0]) - float(exact[0, 0])) <= float(tol[0, 0])
        seen.append(r)
        return u_m["r"][i]

    monkeypatch.setattr(fed_rules, "sharded_project_tree", check)
    enc0, rec0 = obs.totals()["encode.launches"], obs.totals()["decode.launches"]
    new, m = make_train_step_client_parallel(arch, fl, mesh=mesh)(
        shard_resident(params, mesh), batch, 4)
    row_entries = len(mesh.row_mesh(0).device_groups())
    assert obs.totals()["encode.launches"] - enc0 == 2 * row_entries * 4
    assert obs.totals()["decode.launches"] - rec0 == len(mesh.device_groups())
    assert len(seen) == 4 and torch.equal(m["seeds"], u_m["seeds"])
    for j, w in enumerate(tree_leaves(u_new)):
        assert torch.equal(new.gather(j, cuda_device), w)
