"""The port's flash attention (plain version, the CPU path) against the reference.

* Against the reference's Pallas ``flash_attention_call`` in interpret
  mode, at the shapes of ``tests/test_flash_kernel.py`` (which its block
  sizes divide), with a window, with empty ``kpos = -1`` slots, and
  decode-style with one real query.
* Against the reference's einsum ``repro.models.attention._sdpa`` at the
  shapes the Pallas wrapper refuses: ragged S and T, GQA with group 3,
  MQA, a window, ``kpos = -1`` holes and a wrapped (unsorted) ring.

Tolerances are ``test_flash_kernel.py``'s: float32 rtol 1e-3 / atol
2e-5 (sum order), bfloat16 atol 3e-2 (one output rounding, and ``_sdpa``
rounds p to bf16 before P·V where the kernel keeps it float32).  Only
rows with at least one allowed key are compared: the Pallas kernel
gives a row with none a uniform average of V, the port zeros, and no
caller keeps such rows.  The CUDA kernel is held against this plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

At the shipped ``BLOCKED_SDPA_THRESHOLD`` (8192), one layer of the GQA
variant of reduced SmolLM serves a prompt of 8200 tokens and one decode
step in both packages: both take the blocked path, and logits and
caches agree (float32, atol 5e-5 + rtol 1e-5: sum order only).

The card's kernels are emulated here in plain torch where their
arithmetic differs from the plain version: the prefill kernel's split
of p into two bf16 halves for P·V (``p_hi_lo_bf16``, which the card's
limit ``flash_agrees`` must admit), and the split-KV decode's partials
per key partition merged in partition order (held against the plain
version by ``flash_agrees`` and against the Pallas kernel in interpret
mode by the float32 tolerance above).  ``flash_route``, the dispatch
between the three kernels, is checked at the serve shapes.

The float32 kernel classes each (row block, key tile) as "skip",
"unmasked" or "masked" from position minima and maxima alone;
``flash_tile_class`` is that test written out.  ``hypothesis`` holds it
against ``allowed_mask`` on unsorted kpos with -1 holes, causal and not,
with and without a window: a skipped tile has no allowed pair and an
unmasked one no disallowed pair.  A tile-by-tile online softmax that
skips and leaves unmasked as the classes say matches the plain version.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.models.attention as j_attention  # noqa: E402
import repro_torch.models.attention as t_attention  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.kernels.flash_attention import flash_attention_call  # noqa: E402
from repro.models.api import Arch as JArch  # noqa: E402
from repro.models.attention import _sdpa as j_sdpa  # noqa: E402
from repro_torch.configs.registry import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    DECODE_MAX_ROWS,
    allowed_mask,
    decode_partition,
    flash_agrees,
    flash_attention,
    flash_attention_plain,
    flash_compare,
    flash_route,
    flash_tile_class,
)
from repro_torch.models.api import Arch as TArch  # noqa: E402
from torch_parity import Elsewhere  # noqa: E402

TOL = {"float32": dict(rtol=1e-3, atol=2e-5), "bfloat16": dict(rtol=1e-3, atol=3e-2)}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _qkv(seed, b, s, t, h, kh, hd):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, hd).astype(np.float32),
            rng.randn(b, t, kh, hd).astype(np.float32),
            rng.randn(b, t, kh, hd).astype(np.float32))


def _port(arrays, qpos, kpos, dtype, **kw):
    q, k, v = (torch.from_numpy(a).to(T_DT[dtype]) for a in arrays)
    out = flash_attention(q, k, v, torch.from_numpy(qpos), torch.from_numpy(kpos), **kw)
    assert out.dtype == T_DT[dtype] and out.shape == q.shape
    return out.to(torch.float32).numpy()


def _jax_inputs(arrays, dtype):
    return tuple(jnp.asarray(a, J_DT[dtype]) for a in arrays)


def _close(got, want, qpos, kpos, dtype, causal=True, window=0):
    rows = allowed_mask(torch.from_numpy(qpos), torch.from_numpy(kpos), causal,
                        window).any(dim=1).numpy()
    assert rows.any()
    np.testing.assert_allclose(got[:, rows], np.asarray(want, np.float32)[:, rows],
                               **TOL[dtype])
    return rows


@pytest.mark.parametrize("shape", [
    # (B, S, H, KH, hd, q_block, kv_block), as in test_flash_kernel.py
    (1, 256, 4, 2, 64, 128, 128),
    (2, 256, 4, 1, 128, 64, 128),     # MQA
    (1, 512, 6, 6, 32, 256, 256),     # MHA, odd head count
    (1, 128, 8, 1, 256, 64, 64),      # PaliGemma's heads: MQA, hd 256
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_causal(shape, dtype):
    b, s, h, kh, hd, qb, kvb = shape
    arrays = _qkv(0, b, s, s, h, kh, hd)
    pos = np.arange(s, dtype=np.int32)
    want = flash_attention_call(*_jax_inputs(arrays, dtype), jnp.asarray(pos),
                                jnp.asarray(pos), causal=True, q_block=qb,
                                kv_block=kvb)
    _close(_port(arrays, pos, pos, dtype), want, pos, pos, dtype)


@pytest.mark.parametrize("case", ["window", "empty_slots", "decode_row"])
def test_plain_matches_pallas_masks(case):
    if case == "window":
        arrays = _qkv(1, 1, 256, 256, 4, 2, 64)
        qpos = kpos = np.arange(256, dtype=np.int32)
        kw = dict(causal=True, window=64)
        blocks = dict(q_block=128, kv_block=128)
    elif case == "empty_slots":
        arrays = _qkv(2, 1, 128, 128, 2, 2, 64)
        qpos = np.arange(128, dtype=np.int32)
        kpos = qpos.copy()
        kpos[64:] = -1
        kw = dict(causal=True, window=0)
        blocks = dict(q_block=128, kv_block=64)
    else:   # one real query row at the end of a 512-key stream
        arrays = _qkv(3, 2, 128, 512, 4, 2, 64)
        qpos = np.full(128, -1, np.int32)
        qpos[0] = 511
        kpos = np.arange(512, dtype=np.int32)
        kw = dict(causal=True, window=0)
        blocks = dict(q_block=128, kv_block=128)
    want = flash_attention_call(*_jax_inputs(arrays, "float32"), jnp.asarray(qpos),
                                jnp.asarray(kpos), **kw, **blocks)
    got = _port(arrays, qpos, kpos, "float32", **kw)
    rows = _close(got, want, qpos, kpos, "float32", **kw)
    # a row with no allowed key (padding) comes out as zeros
    assert np.all(got[:, ~rows] == 0.0)


def _ring_kpos(capacity, first, last):
    """Slots of a ring of ``capacity`` after writing positions first..last."""
    kpos = np.full(capacity, -1, np.int32)
    for p in range(max(first, last - capacity + 1), last + 1):
        kpos[p % capacity] = p
    return kpos


@pytest.mark.parametrize("case", [
    # name, (B, S, T, H, KH, hd), window, qpos, kpos
    ("ragged_gqa3", (2, 333, 333, 6, 2, 64), 0, None, None),
    ("ragged_window", (1, 1000, 1000, 6, 2, 32), 64, None, None),
    ("cross_lengths_holes", (1, 100, 1000, 6, 2, 32), 64, np.arange(900, 1000),
     np.where(np.arange(1000) % 7 == 3, -1, np.arange(1000))),
    ("mqa_decode", (2, 1, 517, 4, 1, 128), 0, np.array([400]),
     np.where(np.arange(517) <= 400, np.arange(517), -1)),
    ("ring_decode_window", (2, 1, 100, 6, 2, 64), 64, np.array([149]),
     _ring_kpos(100, 0, 149)),
    ("ring_rows", (1, 40, 100, 6, 2, 64), 0, np.arange(110, 150),
     _ring_kpos(100, 0, 149)),
    ("ragged_hd256", (1, 77, 77, 8, 1, 256), 16, None, None),
    ("ring_decode_hd256", (2, 1, 100, 8, 1, 256), 0, np.array([149]),
     _ring_kpos(100, 0, 149)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_sdpa(case, dtype):
    name, (b, s, t, h, kh, hd), window, qpos, kpos = case
    arrays = _qkv(sum(map(ord, name)), b, s, t, h, kh, hd)
    qpos = np.arange(s, dtype=np.int32) if qpos is None else qpos.astype(np.int32)
    kpos = np.arange(t, dtype=np.int32) if kpos is None else kpos.astype(np.int32)
    q, k, v = _jax_inputs(arrays, dtype)
    want = j_sdpa(q, k, v, jnp.asarray(qpos), jnp.asarray(kpos), causal=True,
                  window=window, prefix_len=0)
    got = _port(arrays, qpos, kpos, dtype, causal=True, window=window)
    _close(got, want, qpos, kpos, dtype, window=window)


def test_plain_chunks_agree(monkeypatch):
    """The query-chunked plain version equals one unchunked pass (up to the
    BLAS's blocking, which may change with the chunk's shape)."""
    import repro_torch.kernels.flash_attention as fa

    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 2, 97, 97, 6, 2, 32))
    pos = torch.arange(97, dtype=torch.int32)
    whole = flash_attention_plain(q, k, v, pos, pos, window=16)
    monkeypatch.setattr(fa, "_PLAIN_SCORE_ELEMS", 2 * 6 * 97 * 10)   # 10 rows
    chunked = flash_attention_plain(q, k, v, pos, pos, window=16)
    torch.testing.assert_close(chunked, whole, rtol=1e-6, atol=1e-6)


def _attend(q, k, v, ok, p_dtype=None, p_split=False):
    """Masked attention summed in float64, p optionally rounded first, or
    split into bf16(p) + bf16(p - bf16(p)) from float32 as the prefill
    kernel feeds it to the tensor cores."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qg = q.double().reshape(b, s, kh, h // kh, hd)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k.double()) * hd ** -0.5
    p = torch.softmax(sc.masked_fill(~ok, float("-inf")), dim=-1)
    if p_dtype is not None:
        p = p.to(p_dtype).double()
    if p_split:
        p32 = p.float()
        hi = p32.to(torch.bfloat16)
        lo = (p32 - hi.float()).to(torch.bfloat16)
        p = hi.double() + lo.double()
    o = torch.einsum("bkgst,btkd->bskgd", p, v.double())
    return o.reshape(b, s, h, hd).to(q.dtype)


@pytest.mark.parametrize("variant", ["float64_sum", "p_in_bf16", "dropped_tile",
                                     "causal_edge", "window_edge", "p_hi_lo_bf16"])
@pytest.mark.parametrize("shape", [
    # (B, S, T, H, K, window of the window_edge variant)
    (2, 1024, 1024, 6, 2, 64),
    (4, 1, 16424, 15, 5, 1024),       # a decode step at the serve cache
], ids=["prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_limit_admits_rounding_but_not_a_wrong_kernel(variant, shape, dtype):
    """The limit the card holds the kernel to (``flash_agrees``) admits
    another float32-or-better sum of the same function, and the prefill
    kernel's p_hi + p_lo split, and refuses a kernel that rounds p to
    bf16, drops one key tile, or slips the causal or window edge by one
    key on the last query tile, also where a row sees 16 000 keys and its
    outputs are ~1e-2."""
    b, s, t, h, kh, win = shape
    q, k, v = (torch.from_numpy(a).to(T_DT[dtype])
               for a in _qkv(7, b, s, t, h, kh, 64))
    qpos = torch.arange(t - s - 1, t - 1, dtype=torch.int32)
    kpos = torch.arange(t, dtype=torch.int32)
    window = win if variant == "window_edge" else 0
    ok = allowed_mask(qpos, kpos, True, window)
    want = flash_attention_plain(q, k, v, qpos, kpos, window=window)
    late = qpos[:, None] >= qpos[-1] - 63
    qp, kp = qpos[:, None], kpos[None, :]
    if variant == "dropped_tile":
        ok = ok & ~(late & (kp >= 512) & (kp < 576))
    elif variant == "causal_edge":
        ok = ok | (late & (kp == qp + 1))
    elif variant == "window_edge":
        ok = ok | (late & (kp == qp - window))
    got = _attend(q, k, v, ok, torch.bfloat16 if variant == "p_in_bf16" else None,
                  p_split=variant == "p_hi_lo_bf16")
    rows = allowed_mask(qpos, kpos, True, window).any(dim=1)
    g, w = got[:, rows], want[:, rows]
    admitted = variant in ("float64_sum", "p_hi_lo_bf16")
    assert flash_agrees(g, w) == admitted, flash_compare(g, w)


def _split_kv(q, k, v, qpos, kpos, *, causal=True, window=0, part=None):
    """The split-KV decode's arithmetic in plain torch: float32 partials
    (m, l, acc) per partition of ``part`` keys (the kernel's by default),
    an empty partition's m at -inf, merged in partition order by a
    log-sum-exp rescale."""
    b, s, h, hd = q.shape
    part = part or decode_partition(hd, q.dtype)
    t, kh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, kh, h // kh, hd)
    kf, vf = k.float(), v.float()
    ok = allowed_mask(qpos, kpos, causal, window)
    parts = []
    for t0 in range(0, t, part):
        cut = slice(t0, min(t, t0 + part))
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kf[:, cut]) * hd ** -0.5
        sc = sc.masked_fill(~ok[:, cut], float("-inf"))
        m = sc.amax(dim=-1)
        p = torch.exp(sc - torch.where(m == float("-inf"), 0.0, m)[..., None])
        parts.append((m, p.sum(dim=-1), torch.einsum("bkgst,btkd->bkgsd", p, vf[:, cut])))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    shift = torch.where(top == float("-inf"), 0.0, top)
    total = torch.zeros_like(top)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.exp(m - shift)
        total = total + l * w
        acc = acc + a * w[..., None]
    o = torch.where(total[..., None] > 0, acc / total[..., None], 0.0)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


@pytest.mark.parametrize("case", [
    # name, (B, S, T, H, KH, hd), window, qpos, kpos, keys per partition
    ("masked_partitions", (2, 1, 1000, 6, 2, 64), 0, np.array([499]),
     np.where(np.arange(1000) < 500, np.arange(1000), -1), 64),
    ("ragged_T", (2, 1, 1000, 15, 5, 64), 0, np.array([999]), None, 96),
    ("ring_window_64", (2, 1, 1000, 6, 2, 64), 64, np.array([1499]),
     _ring_kpos(1000, 500, 1499), 96),
    ("ring_window_1000", (2, 1, 1000, 6, 2, 32), 1000, np.array([1499]),
     _ring_kpos(1000, 500, 1499), 96),
    ("two_rows_gqa4", (1, 2, 517, 8, 2, 128), 0, np.array([300, 301]),
     np.where(np.arange(517) % 9 == 4, -1, np.arange(517)), 128),
    ("serve_cache", (4, 1, 16424, 15, 5, 64), 0, np.array([16399]),
     np.where(np.arange(16424) < 16400, np.arange(16424), -1), None),
    ("paligemma_hd256", (1, 1, 700, 8, 1, 256), 0, np.array([650]),
     np.where(np.arange(700) % 11 == 5, -1, np.arange(700)), None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_kv_matches_plain(case, dtype):
    """The decode kernel's split-and-combine against the plain version,
    held by the card's limit: wholly masked partitions, T not a multiple
    of the partition, windows over a wrapped ring, two query rows."""
    name, (b, s, t, h, kh, hd), window, qpos, kpos, part = case
    arrays = _qkv(sum(map(ord, name)), b, s, t, h, kh, hd)
    q, k, v = (torch.from_numpy(a).to(T_DT[dtype]) for a in arrays)
    qpos = torch.from_numpy(qpos.astype(np.int32))
    kpos = torch.arange(t, dtype=torch.int32) if kpos is None else torch.from_numpy(
        kpos.astype(np.int32))
    got = _split_kv(q, k, v, qpos, kpos, window=window, part=part)
    want = flash_attention_plain(q, k, v, qpos, kpos, window=window)
    rows = allowed_mask(qpos, kpos, True, window).any(dim=1)
    assert bool(rows.all())
    assert flash_agrees(got, want), flash_compare(got, want)


def test_split_kv_row_without_keys_is_zero():
    """A row that no partition serves (a padding query before every key)
    comes out as zeros, with no NaN from the empty merges."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(11, 2, 2, 600, 6, 2, 64))
    qpos = torch.tensor([-1, 450], dtype=torch.int32)
    kpos = torch.from_numpy(_ring_kpos(600, 0, 899))     # positions 300..899
    got = _split_kv(q, k, v, qpos, kpos, part=128)
    want = flash_attention_plain(q, k, v, qpos, kpos)
    assert bool(torch.isfinite(got).all())
    assert bool((got[:, 0] == 0).all()) and bool((want[:, 0] == 0).all())
    torch.testing.assert_close(got[:, 1], want[:, 1], **TOL["float32"])


@pytest.mark.parametrize("window", [0, 64])
def test_split_kv_matches_pallas(window):
    """Against the Pallas kernel in interpret mode: one real query (the
    rest of the Pallas block padding) over 512 slots with holes, in
    partitions of 96 keys."""
    b, t, h, kh, hd = 2, 512, 4, 2, 64
    arrays = _qkv(12, b, 128, t, h, kh, hd)
    qpos = np.full(128, -1, np.int32)
    qpos[0] = 480
    kpos = np.where(np.arange(t) % 7 == 2, -1, np.arange(t)).astype(np.int32)
    want = flash_attention_call(*_jax_inputs(arrays, "float32"), jnp.asarray(qpos),
                                jnp.asarray(kpos), causal=True, window=window,
                                q_block=128, kv_block=128)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = _split_kv(q[:, :1], k, v, torch.from_numpy(qpos[:1]), torch.from_numpy(kpos),
                    window=window, part=96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :1], **TOL["float32"])


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-8b", "qwen1.5-4b",
                                  "minitron-8b", "paligemma-3b", "whisper-tiny"])
def test_route_at_serve_shapes(arch):
    """Decode (S = 1) of every served configuration goes to the split-KV
    kernel in both types; a bf16 prefill over the blocked threshold to
    the tensor-core kernel, a float32 one to the float32 kernel."""
    cfg = t_get_config(arch)
    h, kh = cfg.num_heads, cfg.num_kv_heads
    for dtype in (torch.bfloat16, torch.float32):
        assert flash_route(1, h, kh, dtype) == "decode"
    assert flash_route(16384, h, kh, torch.bfloat16) == "prefill"
    assert flash_route(8448, h, kh, torch.float32) == "f32"


def test_route_rule():
    """The rule is S·G ≤ DECODE_MAX_ROWS, whatever the type; a decode
    partition holds 32 KB of K."""
    assert DECODE_MAX_ROWS == 8
    assert [decode_partition(hd, torch.bfloat16)
            for hd in (32, 64, 128, 256)] == [512, 256, 128, 64]
    assert [decode_partition(hd, torch.float32)
            for hd in (32, 64, 128, 256)] == [256, 128, 64, 32]
    for s, h, kh, want in ((1, 15, 5, "decode"), (2, 12, 3, "decode"),
                           (3, 15, 5, "prefill"), (8, 4, 4, "decode"),
                           (9, 4, 4, "prefill"), (1, 48, 4, "prefill"),
                           (333, 6, 2, "prefill")):
        assert flash_route(s, h, kh, torch.bfloat16) == want
        assert flash_route(s, h, kh, torch.float32) == ("f32" if want == "prefill"
                                                         else want)


def test_cpu_call_counts_no_launch():
    """On CPU tensors the wrapper takes the plain version and no kernel
    counter moves."""
    from repro_torch import obs

    q, k, v = (torch.from_numpy(a) for a in _qkv(13, 1, 1, 40, 6, 2, 32))
    pos = torch.arange(40, dtype=torch.int32)
    names = ("flash.launches", "flash_prefill.launches", "flash_decode.launches",
             "flash_f32.launches")
    before = [obs.totals()[n] for n in names]
    flash_attention(q, k, v, pos[-1:], pos)
    assert before == [obs.totals()[n] for n in names]


def test_wrapper_refuses_other_devices():
    pos = torch.arange(4, dtype=torch.int32)
    k = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(Elsewhere((1, 4, 2, 32)), k, k, pos, pos)


def test_shipped_threshold_dispatch(monkeypatch):
    """At the real BLOCKED_SDPA_THRESHOLD (8192): a prompt of 8200 and a
    decode against a cache of 8203 take the blocked path in both packages."""
    assert t_attention.BLOCKED_SDPA_THRESHOLD == j_attention.BLOCKED_SDPA_THRESHOLD == 8192
    calls = {"jax": 0, "torch": 0}

    def spy(mod, key):
        inner = mod._sdpa_blocked

        def wrapped(*a, **kw):
            calls[key] += 1
            return inner(*a, **kw)
        monkeypatch.setattr(mod, "_sdpa_blocked", wrapped)

    spy(j_attention, "jax")
    spy(t_attention, "torch")
    over = dict(d_model=384, num_heads=6, num_kv_heads=2, head_dim=64, num_layers=1)
    jc = dataclasses.replace(j_get_config("smollm-360m").reduced(), **over)
    tc = dataclasses.replace(t_get_config("smollm-360m").reduced(), **over)
    ja, ta = JArch(jc), TArch(tc)
    jp = ja.init(jax.random.PRNGKey(9))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tol = dict(rtol=1e-5, atol=5e-5)
    s, cap = 8200, 8203
    tok = np.random.RandomState(10).randint(0, jc.vocab_size, (1, s)).astype(np.int32)
    jlog, jcache = ja.prefill(jp, {"tokens": jnp.asarray(tok)}, capacity=cap)
    tlog, tcache = ta.prefill(tp, {"tokens": torch.from_numpy(tok)}, capacity=cap)
    assert calls == {"jax": 1, "torch": 1}
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
    t = np.array([[5]], np.int32)
    jlog, jcache = ja.decode(jp, jnp.asarray(t), jcache, jnp.int32(s))
    tlog, tcache = ta.decode(tp, torch.from_numpy(t), tcache, s)
    assert calls == {"jax": 2, "torch": 2}
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
    (t_st,), (j_st,) = tcache.caches, jcache.caches
    np.testing.assert_allclose(t_st.k.numpy(), np.asarray(j_st.k), **tol)
    np.testing.assert_allclose(t_st.v.numpy(), np.asarray(j_st.v), **tol)
    np.testing.assert_array_equal(t_st.pos.numpy(), np.asarray(j_st.pos))


@pytest.mark.parametrize("causal", [True, False])
@settings(max_examples=400, deadline=None)
@given(qpos=st.lists(st.integers(-1, 80), min_size=1, max_size=12),
                  kpos=st.lists(st.integers(-1, 80), min_size=1, max_size=12),
                  window=st.one_of(st.just(0), st.integers(1, 50)))
def test_tile_class_never_skips_or_unmasks_wrongly(causal, qpos, kpos, window):
    cls = flash_tile_class(qpos, kpos, causal, window)
    ok = allowed_mask(torch.tensor(qpos), torch.tensor(kpos), causal, window)
    assert cls in ("skip", "unmasked", "masked")
    if cls == "skip":
        assert not bool(ok.any())
    if cls == "unmasked":
        assert bool(ok.all())


def _tiled(q, k, v, qpos, kpos, causal, window, bm, bn):
    """The kernel's tile walk in plain float32 torch: per (row block, key
    tile) the class decides skip / no mask / mask; online softmax over the
    tiles in order; a row without an allowed key gives zeros."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    rows = q.reshape(b, s, kh, g, hd).permute(0, 2, 1, 3, 4).reshape(b, kh, s * g, hd)
    rpos = qpos.repeat_interleave(g)
    out = torch.zeros_like(rows)
    for r0 in range(0, s * g, bm):
        qr, qp = rows[:, :, r0:r0 + bm], rpos[r0:r0 + bm]
        m = torch.full(qr.shape[:-1], float("-inf"))
        l = torch.zeros(qr.shape[:-1])
        o = torch.zeros_like(qr)
        for t0 in range(0, t, bn):
            kp = torch.full((bn,), -1, dtype=kpos.dtype)
            kp[:min(bn, t - t0)] = kpos[t0:t0 + bn]
            cls = flash_tile_class(qp.tolist(), kp.tolist(), causal, window)
            if cls == "skip":
                continue
            kt = torch.zeros((b, kh, bn, hd))
            vt = torch.zeros((b, kh, bn, hd))
            kt[:, :, :t - t0] = k[:, t0:t0 + bn].permute(0, 2, 1, 3)
            vt[:, :, :t - t0] = v[:, t0:t0 + bn].permute(0, 2, 1, 3)
            sc = torch.einsum("bkrd,bknd->bkrn", qr, kt) * hd ** -0.5
            if cls == "masked":
                sc = sc.masked_fill(~allowed_mask(qp, kp, causal, window), float("-inf"))
            m_new = torch.maximum(m, sc.amax(-1))
            m_use = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
            corr = torch.exp(m - m_use)
            p = torch.exp(sc - m_use[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum("bkrn,bknd->bkrd", p, vt)
            m = m_new
        out[:, :, r0:r0 + bm] = torch.where(l[..., None] > 0, o / l[..., None],
                                            torch.zeros_like(o))
    return out.reshape(b, kh, s, g, hd).permute(0, 2, 1, 3, 4).reshape(b, s, h, hd)


@pytest.mark.parametrize("case", ["causal", "window", "noncausal", "holes", "ring"])
def test_tile_walk_matches_plain(case):
    """The kernel's skip / unmasked / masked walk (row blocks of 16, key
    tiles of 8 here) against the plain version, float32 rtol 1e-3 / atol
    2e-5, on the rows with an allowed key (zeros elsewhere in both)."""
    s, t, causal, window = 45, 45, True, 0
    qpos = torch.arange(s, dtype=torch.int32)
    kpos = torch.arange(t, dtype=torch.int32)
    if case == "window":
        window = 7
    elif case == "noncausal":
        causal, window = False, 9
    elif case == "holes":
        kpos[::4] = -1
        qpos[:5] = -1
    elif case == "ring":
        t = 40
        kpos = torch.from_numpy(_ring_kpos(t, 30, 69)).to(torch.int32)
        qpos = torch.arange(25, 70, dtype=torch.int32)
        window = 20
    arrays = _qkv(9, 2, s, t, 6, 2, 32)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = _tiled(q, k, v, qpos, kpos, causal, window, bm=16, bn=8)
    want = flash_attention_plain(q, k, v, qpos, kpos, causal=causal, window=window)
    torch.testing.assert_close(got, want, **TOL["float32"])
