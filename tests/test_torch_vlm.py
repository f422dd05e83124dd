"""The port's VLM (PaliGemma-3B) against the reference, on the CPU.

PaliGemma runs through the decoder-only stack (``models/lm.py``) with its
stubbed vision tower: 16 patch embeddings (``embeds``) before the text,
a prefix-bidirectional span of 256 positions (``reduced()`` keeps the
full config's 256 while it cuts the frontend to 16 tokens, as the
reference's does), MQA, GeGLU and tied embeddings.  Same parameters on
both sides (``convert.params_from_jax``); inputs from numpy with a seed.
Configs: reduced PaliGemma (4 heads over 1 kv head, head_dim 64) and its
head_dim-256 variant (d_model 512, 2 heads over 1, head_dim 256: the
full model's head shape), float32.

Tolerances, with their reasons (float32: sum order only):

* loss within 1e-5 (observed ≤ 1e-6 on ≈ 6.8);
* prefill and decode logits within atol 5e-5 + rtol 1e-5 and the KV
  caches likewise (``tests/test_torch_lm.py``'s float32 tolerance;
  observed ≤ 6.3e-6), decoding across the prefix's end (positions 248 to
  259), on the plain path and on the blocked path (threshold 64 in both
  packages);
* the routing at the shipped threshold (8192): a decode step past the
  prefix (qpos ≥ 256) over 8200 slots takes ``flash_attention`` (its
  plain version on the CPU) and a prefill of 8200 tokens with the prefix
  takes ``_sdpa_blocked_plain``; both against the reference's
  ``_sdpa_blocked`` within atol 2e-5 + rtol 1e-4 (the flash kernels'
  float32 limit is rtol 1e-3 / atol 2e-5; observed ≤ 3.9e-7);
* the train round: as ``tests/test_torch_train.py`` holds the dense
  family, with the patch embeddings split by client as the tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.attention as j_attention  # noqa: E402
import repro_torch.models.attention as t_attention  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models.api import Arch as JArch  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.api import Arch as TArch  # noqa: E402
from test_torch_lm import _assert_caches, _assert_close, _carry, _cfgs  # noqa: E402
from test_torch_train import _check_train_step  # noqa: E402

NAME = "paligemma-3b"
VARIANTS = [False, "hd256"]
IDS = ["reduced", "hd256"]
LOGIT_TOL = dict(rtol=1e-5, atol=5e-5)
PROMPT, STEPS = 232, 12           # 16 + 232 = 248 positions, then 248..259


def _inputs(cfg, batch, seq, seed):
    rng = np.random.RandomState(seed)
    embeds = (rng.randn(batch, cfg.num_frontend_tokens, cfg.d_model) * 0.02).astype(np.float32)
    toks = rng.randint(0, cfg.vocab_size, (batch, seq + 1))
    return embeds, toks


def _model(variant, seed=0):
    jc, tc = _cfgs(NAME, "float32", variant)
    jp = JArch(jc).init(jax.random.PRNGKey(seed))
    return jc, tc, jp, _carry(jp)


def test_configs_keep_the_prefix_and_head_shape():
    jc, tc = _cfgs(NAME, "float32")
    assert (tc.num_frontend_tokens, tc.prefix_bidirectional) == (16, 256)
    assert (tc.num_heads, tc.num_kv_heads, tc.resolved_head_dim) == (4, 1, 64)
    _, tc = _cfgs(NAME, "float32", "hd256")
    assert (tc.num_heads, tc.num_kv_heads, tc.resolved_head_dim) == (2, 1, 256)
    assert tc.resolved_head_dim in HEAD_DIMS


@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_loss_matches_reference(variant):
    jc, tc, jp, tp = _model(variant, 1)
    embeds, toks = _inputs(jc, 2, 24, 2)
    jb = {"embeds": jnp.asarray(embeds), "tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"embeds": torch.from_numpy(embeds), "tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(toks[:, 1:])}
    want = jax.jit(lambda p: j_lm.lm_loss(p, jc, jb))(jp)
    got = TArch(tc).loss(tp, tb)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-5


@pytest.mark.parametrize("blocked", [False, True], ids=["plain", "blocked"])
@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_prefill_and_decode_match_reference(variant, blocked, monkeypatch):
    """16 embeddings + 232 tokens, then 12 decode steps across the prefix's
    end (positions 248..259; the prefix is 256)."""
    if blocked:
        monkeypatch.setattr(j_attention, "BLOCKED_SDPA_THRESHOLD", 64)
        monkeypatch.setattr(t_attention, "BLOCKED_SDPA_THRESHOLD", 64)
    jc, tc, jp, tp = _model(variant)
    embeds, toks = _inputs(jc, 2, PROMPT + STEPS, 3)
    cap = jc.num_frontend_tokens + PROMPT + STEPS + 4
    j_arch, t_arch = JArch(jc), TArch(tc)
    j_prefill = jax.jit(lambda p, b: j_arch.prefill(p, b, capacity=cap))
    j_decode = jax.jit(lambda p, t, c, pos: j_arch.decode(p, t, c, pos))
    j_lg, j_c = j_prefill(jp, {"embeds": jnp.asarray(embeds),
                               "tokens": jnp.asarray(toks[:, :PROMPT])})
    t_lg, t_c = t_arch.prefill(tp, {"embeds": torch.from_numpy(embeds),
                                    "tokens": torch.from_numpy(toks[:, :PROMPT])},
                               capacity=cap)
    _assert_close(t_lg, j_lg, LOGIT_TOL)
    start = jc.num_frontend_tokens + PROMPT
    for i in range(STEPS):
        tok = toks[:, PROMPT + i:PROMPT + i + 1]
        j_lg, j_c = j_decode(jp, jnp.asarray(tok), j_c, jnp.int32(start + i))
        t_lg, t_c = t_arch.decode(tp, torch.from_numpy(tok), t_c, start + i)
        _assert_close(t_lg, j_lg, LOGIT_TOL)
    assert start + STEPS - 1 > tc.prefix_bidirectional > start
    _assert_caches(t_c, j_c, "float32")


def _qkv(rng, b, s, t, h, kh, hd):
    return (rng.randn(b, s, h, hd).astype(np.float32),
            rng.randn(b, t, kh, hd).astype(np.float32),
            rng.randn(b, t, kh, hd).astype(np.float32))


@pytest.fixture
def spies(monkeypatch):
    """Count the port's calls of the flash wrapper and of the plain blocked
    recurrence from ``_sdpa_blocked``."""
    calls = {"flash": 0, "plain": 0}
    for name, key in (("flash_attention", "flash"), ("_sdpa_blocked_plain", "plain")):
        fn = getattr(t_attention, name)

        def spy(*args, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(t_attention, name, spy)
    return calls


@pytest.mark.parametrize("step", ["decode", "prefill"])
def test_prefix_routing_above_the_threshold(step, spies):
    """At the shipped threshold (8192): a decode step whose query lies past
    the prefix (PaliGemma's heads: 8 over 1, hd 256) over 8200 slots takes
    the flash kernel's wrapper; a prefill of 8200 positions with the
    prefix (2 heads over 1, hd 32) takes the plain blocked recurrence.
    Both agree with the reference's ``_sdpa_blocked``."""
    rng = np.random.RandomState(4)
    t, prefix = 8200, 256
    if step == "decode":
        q, k, v = _qkv(rng, 1, 1, t, 8, 1, 256)
        qpos = np.array([8190], np.int32)
        kpos = np.where(np.arange(t) <= 8190, np.arange(t), -1).astype(np.int32)
    else:
        q, k, v = _qkv(rng, 1, t, t, 2, 1, 32)
        qpos = kpos = np.arange(t, dtype=np.int32)
    assert max(q.shape[1], t) > t_attention.BLOCKED_SDPA_THRESHOLD == 8192
    kw = dict(causal=True, window=0, prefix_len=prefix)
    want = j_attention._sdpa_blocked(*(jnp.asarray(x) for x in (q, k, v, qpos, kpos)), **kw)
    got = t_attention._sdpa_blocked(*(torch.from_numpy(x) for x in (q, k, v, qpos, kpos)),
                                    **kw)
    assert spies == ({"flash": 1, "plain": 0} if step == "decode"
                     else {"flash": 0, "plain": 1})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=2e-5)


def test_prefill_inside_the_prefix_stays_plain_on_the_blocked_path(spies, monkeypatch):
    """Through the model: with the blocked threshold at 64, a prefill with
    the prefix takes the plain recurrence in every layer and each decode
    step past the prefix the flash wrapper; a step inside it the plain
    recurrence."""
    monkeypatch.setattr(t_attention, "BLOCKED_SDPA_THRESHOLD", 64)
    _, tc = _cfgs(NAME, "float32")
    arch = TArch(tc)
    params = arch.init(seed=0, device="cpu")
    embeds, toks = _inputs(tc, 1, 240, 5)
    _, caches = arch.prefill(params, {"embeds": torch.from_numpy(embeds),
                                      "tokens": torch.from_numpy(toks[:, :238])},
                             capacity=300)
    assert spies == {"flash": 0, "plain": tc.num_layers}
    arch.decode(params, torch.from_numpy(toks[:, 238:239]), caches, 254)
    assert spies == {"flash": 0, "plain": 2 * tc.num_layers}
    arch.decode(params, torch.from_numpy(toks[:, 239:240]), caches, 256)
    assert spies == {"flash": tc.num_layers, "plain": 2 * tc.num_layers}


def test_lm_prefill_scores_only_the_text(monkeypatch):
    """The VLM's prefill logits are the last text position's; the loss
    scores only the trailing text (the 16 embeddings are not predicted)."""
    _, tc = _cfgs(NAME, "float32")
    arch = TArch(tc)
    params = arch.init(seed=1, device="cpu")
    embeds, toks = _inputs(tc, 2, 8, 6)
    batch = {"embeds": torch.from_numpy(embeds), "tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    logits = t_lm.lm_forward(params, tc, tokens=batch["tokens"], embeds=batch["embeds"])
    assert logits.shape == (2, 16 + 8, tc.vocab_size)
    last, _ = arch.prefill(params, batch, capacity=32)
    torch.testing.assert_close(last[:, 0], logits[:, -1], rtol=1e-5, atol=1e-5)
    logp = torch.log_softmax(logits[:, 16:], dim=-1)
    want = -torch.take_along_dim(logp, batch["labels"][..., None], dim=-1).mean()
    torch.testing.assert_close(arch.loss(params, batch), want)


def test_train_step_matches_reference(monkeypatch):
    """One FedScalar round through ``launch/train.py`` against the
    reference's ``make_train_step`` (float32, N = 4, S = 2, 8 × (16
    embeddings + 16 tokens), split by client)."""
    _check_train_step((NAME, "float32", False), monkeypatch, 1e-5)
