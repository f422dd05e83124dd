"""The plain blocked attention recurrence against the reference's ``_sdpa_blocked``.

``repro_torch.models.attention._sdpa_blocked_plain`` is the reference's
blocked online softmax (query chunks × KV chunks, running m, l, acc) in
plain torch.  It serves attention above ``BLOCKED_SDPA_THRESHOLD`` where
the flash kernels cannot: under autograd on the card in bf16 (they have
no bf16 backward) and with a prefix-bidirectional mask (they have none).  Held
here against ``repro.models.attention._sdpa_blocked`` on the same
numpy inputs with small chunks (ragged query and key chunks, padded keys
at position −1), GQA, causal, windowed and with a prefix: float32
values within 1e-5, and the gradients with respect to q, k and v
(``jax.vjp`` of the reference against torch autograd, the same
cotangent) within 1e-4 of each one's largest |reference gradient|: the
two frameworks sum the chunks' einsums in other orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as j_attention  # noqa: E402
from repro_torch.models import attention as t_attention  # noqa: E402

# (S, T, q_chunk, kv_chunk, window, prefix_len, qpos offset, key holes)
CASES = [
    (40, 40, 16, 8, 0, 0, 0, False),      # ragged query chunks
    (40, 40, 16, 12, 0, 0, 0, False),     # ragged key chunks (padded keys)
    (40, 40, 16, 8, 10, 0, 0, False),     # sliding window
    (40, 40, 16, 12, 0, 13, 0, False),    # prefix-bidirectional (C3)
    (40, 40, 16, 12, 10, 13, 0, False),   # prefix and window
    (6, 40, 4, 16, 0, 0, 34, True),       # late queries, empty key slots
]


def _inputs(s, t, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(2, s, 6, 16).astype(np.float32)
    k = rng.randn(2, t, 2, 16).astype(np.float32)
    v = rng.randn(2, t, 2, 16).astype(np.float32)
    dy = rng.randn(2, s, 6, 16).astype(np.float32)
    return q, k, v, dy


@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_blocked_plain_matches_reference_values_and_grads(case):
    s, t, qc, kc, window, prefix_len, q0, holes = case
    q, k, v, dy = _inputs(s, t, len(str(case)))
    qpos = np.arange(q0, q0 + s, dtype=np.int32)
    kpos = np.arange(t, dtype=np.int32)
    if holes:
        kpos[::7] = -1
    kw = dict(causal=True, window=window, prefix_len=prefix_len)

    def ref(q_, k_, v_):
        return j_attention._sdpa_blocked(q_, k_, v_, jnp.asarray(qpos),
                                         jnp.asarray(kpos), q_chunk=qc,
                                         kv_chunk=kc, **kw)

    want, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(dy))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = t_attention._sdpa_blocked_plain(
        *leaves, torch.from_numpy(qpos), torch.from_numpy(kpos), q_chunk=qc,
        kv_chunk=kc, **kw)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(dy))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    for g, w in zip(grads, want_grads):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_blocked_attention_takes_the_recurrence_with_a_prefix():
    """C3: a prefix above the threshold takes the plain blocked recurrence
    with the reference's chunk sizes (the flash kernels have no prefix
    mask), on the CPU as on the card; it equals the plain ``_sdpa``
    within float32 rounding."""
    q, k, v, _ = _inputs(2100, 2100, 5)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    pos = torch.arange(2100)
    kw = dict(causal=True, window=0, prefix_len=300)
    got = t_attention._sdpa_blocked(*args, pos, pos, **kw)
    want = t_attention._sdpa_blocked_plain(*args, pos, pos, **kw)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, t_attention._sdpa(*args, pos, pos, **kw),
                               rtol=0, atol=1e-5)
