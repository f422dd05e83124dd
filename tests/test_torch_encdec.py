"""The port's enc-dec family (Whisper-tiny, ``models/encdec.py``) against the reference, on the CPU.

Same parameters on both sides: the reference initialises with
``jax.random`` and ``repro_torch.convert.params_from_jax`` carries the
tree across; frames and tokens come from numpy with a seed.  Config:
reduced Whisper-tiny (2 + 2 layers, d_model 256, 4 heads, encoder_seq 64,
learned positions over ``max_position`` 512), float32.

Tolerances, with their reasons:

* ``_sinusoid``: XLA's float32 ``exp`` and torch's differ by an ulp at
  19 of Whisper's 192 frequencies; the angle pos·inv carries that ulp
  up to 1500 rad, where a float32 ulp is 1.2e-4: atol 2e-4 on the table
  of 1500 × 384 (the reduced 64 frames see ≤ 1e-5).
* encoder states within atol 1e-4 (observed ≤ 4.2e-6): sum order and
  the table's ulps.
* ``encdec_loss`` within 1e-5 (observed ≤ 1e-6 on ≈ 6.7), each gradient
  within 1e-4 of its leaf's largest |gradient| (observed ≤ 2.5e-6): sum
  order.  The key biases' gradients are zero in exact arithmetic (the
  softmax cancels a shift of a row's scores): both sides within 1e-7 of
  it (observed ≤ 2.4e-9).
* prefill and decode logits within 1e-4, the reference's own tolerance
  in ``test_whisper_serve_consistency`` (observed ≤ 2.2e-6), at decode
  positions past ``max_position`` (the learned table taken mod 512), on
  the plain path and on the blocked path (threshold 8 in both
  packages: the port's flash attention, plain on the CPU).
* The train round: as ``tests/test_torch_train.py`` holds the dense
  family, with the audio frames split by client as the tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.attention as j_attention  # noqa: E402
import repro.models.encdec as j_ed  # noqa: E402
import repro_torch.models.attention as t_attention  # noqa: E402
import repro_torch.models.encdec as t_ed  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from test_torch_lm import _carry, _cfgs  # noqa: E402
from test_torch_train import _check_train_step  # noqa: E402

NAME = "whisper-tiny"


def _inputs(cfg, batch, seq, seed):
    rng = np.random.RandomState(seed)
    frames = (rng.randn(batch, cfg.encoder_seq, cfg.d_model) * 0.02).astype(np.float32)
    toks = rng.randint(0, cfg.vocab_size, (batch, seq + 1))
    return frames, toks


@pytest.fixture(scope="module")
def model():
    jc, tc = _cfgs(NAME, "float32")
    jp = j_ed.init_encdec(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, _carry(jp)


def test_sinusoid_matches_reference():
    want = np.asarray(j_ed._sinusoid(1500, 384))
    got = t_ed._sinusoid(1500, 384).numpy()
    assert got.dtype == np.float32 and got.shape == (1500, 384)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got[:64], want[:64], rtol=0, atol=1e-5)


def test_encode_matches_reference(model):
    jc, tc, jp, tp = model
    frames, _ = _inputs(jc, 2, 1, 0)
    want = j_ed.encode(jp, jc, jnp.asarray(frames))
    got = t_ed.encode(tp, tc, torch.from_numpy(frames))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_encdec_loss_and_grads_match_reference(model):
    jc, tc, jp, tp = model
    frames, toks = _inputs(jc, 2, 20, 1)
    jb = {"embeds": jnp.asarray(frames), "tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"embeds": torch.from_numpy(frames), "tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(toks[:, 1:])}
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: j_ed.encdec_loss(p, jc, jb)))(jp)
    p = tree_map(lambda w: w.detach().clone().requires_grad_(True), tp)
    loss = t_ed.encdec_loss(p, tc, tb)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    assert abs(float(loss) - float(j_loss)) <= 1e-5
    j_leaves = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    assert len(j_leaves) == len(grads)
    for (path, jg), tg in zip(j_leaves, grads):
        a, b = np.asarray(jg), tg.numpy()
        assert a.shape == b.shape
        if [getattr(e, "key", None) for e in path[-2:]] == ["wk", "b"]:
            # A key bias adds q·b to every score of a row, which the softmax
            # cancels: its gradient is zero, and both sides hold only noise.
            assert np.abs(a).max() <= 1e-7 and np.abs(b).max() <= 1e-7
            continue
        scale = np.abs(a).max()
        assert scale > 0
        assert np.abs(a - b).max() <= 1e-4 * scale


@pytest.mark.parametrize("blocked", [False, True], ids=["plain", "blocked"])
def test_prefill_and_decode_match_reference(model, monkeypatch, blocked):
    """A 12-token prompt into a ring of 24 slots, then decode steps at
    positions 12, 13, 511, 512 and 700 (past ``max_position``: the learned
    table is taken mod its length, and the ring wraps)."""
    jc, tc, jp, tp = model
    if blocked:
        monkeypatch.setattr(j_attention, "BLOCKED_SDPA_THRESHOLD", 8)
        monkeypatch.setattr(t_attention, "BLOCKED_SDPA_THRESHOLD", 8)
    frames, toks = _inputs(jc, 2, 20, 2)
    j_prefill = jax.jit(lambda p, f, t: j_ed.encdec_prefill(p, jc, f, t, capacity=24))
    j_decode = jax.jit(lambda p, t, c, pos: j_ed.encdec_decode(p, jc, t, c, pos))
    j_lg, j_c = j_prefill(jp, jnp.asarray(frames), jnp.asarray(toks[:, :12]))
    t_lg, t_c = t_ed.encdec_prefill(tp, tc, torch.from_numpy(frames),
                                    torch.from_numpy(toks[:, :12]), capacity=24)
    assert t_lg.shape == j_lg.shape == (2, 1, jc.vocab_size)
    np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), rtol=1e-4, atol=1e-4)
    for i, pos in enumerate((12, 13, 511, 512, 700)):
        tok = toks[:, 12 + i:13 + i]
        j_lg, j_c = j_decode(jp, jnp.asarray(tok), j_c, jnp.int32(pos))
        t_lg, t_c = t_ed.encdec_decode(tp, tc, torch.from_numpy(tok), t_c, pos)
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), rtol=1e-4, atol=1e-4)
    for field, t, j in zip(t_c.self_caches._fields, t_c.self_caches, j_c.self_caches):
        if field in ("pos", "idx"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(t_c.enc_states.numpy(), np.asarray(j_c.enc_states),
                               rtol=0, atol=1e-4)


def test_serve_consistency():
    """The port alone, as the reference's ``test_whisper_serve_consistency``:
    prefill and one decode step give the logits of the full decoder
    forward at positions S−1 and S (atol/rtol 1e-4)."""
    cfg = ModelConfig(name="w", arch_type="encdec", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
                      encoder_layers=2, encoder_seq=24, frontend="audio",
                      norm="layernorm", activation="gelu", use_rope=False,
                      max_position=256, qkv_bias=True, tie_embeddings=True,
                      dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = t_ed.init_encdec(cfg, gen)
    rng = np.random.RandomState(1)
    frames = torch.from_numpy(rng.randn(2, 24, 64).astype(np.float32))
    s = 20
    tokens = torch.from_numpy(rng.randint(0, 128, (2, s + 2)))

    enc = t_ed.encode(p, cfg, frames)
    pos = torch.arange(s + 2, dtype=torch.int32)
    x = t_ed._dec_embed(p, cfg, tokens, pos)
    for i in range(cfg.num_layers):
        x, _ = t_ed._dec_sublayer(t_ed.stack_slice(p["dec_layers"], i), x, cfg, enc, pos)
    x = t_ed.apply_norm(p["dec_norm"], x, cfg.norm)
    full = x @ p["embed"]["embedding"].T

    lp, caches = t_ed.encdec_prefill(p, cfg, frames, tokens[:, :s], capacity=s + 4)
    torch.testing.assert_close(lp[:, 0], full[:, s - 1], rtol=1e-4, atol=1e-4)
    lg, caches = t_ed.encdec_decode(p, cfg, tokens[:, s:s + 1], caches, s)
    torch.testing.assert_close(lg[:, 0], full[:, s], rtol=1e-4, atol=1e-4)
    assert int(caches.self_caches.idx[0]) == s + 1


def test_arch_entry_points_run():
    """``Arch`` of reduced Whisper: init, loss, prefill, decode and
    init_caches on the CPU (the reference's shapes; zero encoder states in
    the empty caches)."""
    arch = get_arch(NAME, reduced=True)
    cfg = arch.cfg
    assert arch.is_encdec
    params = arch.init(seed=0, device="cpu")
    frames, toks = _inputs(cfg, 2, 10, 3)
    batch = {"embeds": torch.from_numpy(frames), "tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    loss = arch.loss(params, batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    logits, caches = arch.prefill(params, batch, capacity=16)
    assert logits.shape == (2, 1, cfg.vocab_size)
    logits, caches = arch.decode(params, toks[:, -1:], caches, 10)
    assert logits.shape == (2, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    empty = arch.init_caches(3, 16, device="cpu")
    assert empty.enc_states.shape == (3, cfg.encoder_seq, cfg.d_model)
    assert not bool(empty.enc_states.any())
    assert empty.self_caches.k.shape == (cfg.num_layers, 3, 16, cfg.num_kv_heads,
                                         cfg.resolved_head_dim)
    assert bool((empty.self_caches.pos == -1).all())


def test_train_step_matches_reference(monkeypatch):
    """One FedScalar round through ``launch/train.py`` against the
    reference's ``make_train_step`` (float32, N = 4, S = 2, 8 × 16 tokens
    and 8 sets of 64 frames, split by client)."""
    _check_train_step((NAME, "float32", False), monkeypatch, 1e-5)
