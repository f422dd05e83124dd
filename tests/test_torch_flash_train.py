"""Float32 attention under autograd through the flash kernels, on the CPU.

``kernels.flash_attention.FlashAttentionF32`` trains attention without
the (S, T) score tensor: the float32 kernel forward with each row's
log-sum-exp (``flash_attention_fwd_lse``) and a hand-written backward
(``flash_attention_bwd``, P recomputed from lse).  On a CPU tensor both
take their plain versions, held here against the plain attention:
``lse`` against ``torch.logsumexp`` of the masked scores, the output
against ``models.attention._sdpa`` within 1e-5, and the q, k and v
gradients against autograd through ``_sdpa`` within 1e-4 of each one's
largest |gradient| (the sums run in other orders).  Then the Function
under ``torch.func.vmap`` (the client-parallel step) against a loop over
clients, the route predicate of ``_sdpa`` and ``_sdpa_blocked``, and a
``meta`` call, which allocates the outputs, keeps no score tensor and
launches nothing.  The card's kernels are held to the same plain
versions in ``test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention  # noqa: E402

# (B, S, H, K, hd, causal, window, key holes)
CASES = {
    "hd32-g6": (1, 40, 6, 1, 32, True, 0, False),
    "hd128-g1": (1, 24, 2, 2, 128, True, 0, False),
    "ragged70-g3": (2, 70, 6, 2, 32, True, 0, False),
    "window24": (2, 70, 6, 2, 32, True, 24, False),
    "holes": (1, 70, 6, 1, 32, True, 0, True),
    "noncausal-hd128-g6": (1, 33, 6, 1, 128, False, 0, False),
}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(name, seed=0, lead=()):
    b, s, h, kh, hd, causal, window, holes = CASES[name]
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(*lead, b, s, h, hd, generator=g)
    k = torch.randn(*lead, b, s, kh, hd, generator=g)
    v = torch.randn(*lead, b, s, kh, hd, generator=g)
    dy = torch.randn(*lead, b, s, h, hd, generator=g)
    qpos = torch.arange(s, dtype=torch.int32)
    kpos = qpos.clone()
    if holes:       # empty slots; every query keeps its own key or an earlier one
        kpos[3::7] = -1
    return q, k, v, dy, qpos, kpos, dict(causal=causal, window=window)


def _sdpa_grads(q, k, v, dy, qpos, kpos, kw):
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = attention._sdpa(*leaves, qpos, kpos, prefix_len=0, **kw)
    return out.detach(), torch.autograd.grad(out, leaves, dy)


def _close(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("name", list(CASES))
def test_fwd_lse_plain_matches_sdpa_and_logsumexp(name):
    q, k, v, _, qpos, kpos, kw = _case(name)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, qpos, kpos, **kw)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1]) and lse.dtype == torch.float32
    torch.testing.assert_close(out, attention._sdpa(q, k, v, qpos, kpos, prefix_len=0, **kw),
                               rtol=0, atol=1e-5)
    g = q.shape[2] // k.shape[2]
    sc = torch.einsum("bshd,bthd->bhst", q, k.repeat_interleave(g, dim=2))
    sc = sc * q.shape[-1] ** -0.5
    ok = fa.allowed_mask(qpos, kpos, kw["causal"], kw["window"])
    want = torch.logsumexp(sc.masked_fill(~ok, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_plain_matches_sdpa_autograd(name):
    q, k, v, dy, qpos, kpos, kw = _case(name)
    want_out, want = _sdpa_grads(q, k, v, dy, qpos, kpos, kw)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, qpos, kpos, **kw)
    _close(fa.flash_attention_bwd(q, k, v, out, dy, lse, qpos, kpos, **kw), want)
    # the same through the autograd Function
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = fa.flash_attention_train(*leaves, qpos, kpos, **kw)
    torch.testing.assert_close(got.detach(), want_out, rtol=0, atol=1e-5)
    _close(torch.autograd.grad(got, leaves, dy), want)


def test_row_without_a_key_gets_no_gradient():
    """A row with no allowed key: lse = -inf, output 0, gradients 0."""
    q, k, v, dy, qpos, kpos, kw = _case("holes")
    kpos[0] = -1                      # query 0 now sees no key
    out, lse = fa.flash_attention_fwd_lse(q, k, v, qpos, kpos, **kw)
    assert float(lse[:, :, 0].max()) == float("-inf")
    assert float(out[:, 0].abs().max()) == 0.0
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, dy, lse, qpos, kpos, **kw)
    assert float(dq[:, 0].abs().max()) == 0.0
    assert all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))


def test_vmap_folds_clients_into_the_batch():
    q, k, v, dy, qpos, kpos, kw = _case("ragged70-g3", seed=1, lead=(3,))
    res = []
    for run in (lambda *a: torch.func.vmap(
                    lambda x, y, z: fa.flash_attention_train(x, y, z, qpos, kpos, **kw))(*a),
                lambda *a: torch.stack([fa.flash_attention_train(
                    a[0][i], a[1][i], a[2][i], qpos, kpos, **kw) for i in range(3)])):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = run(*leaves)
        res.append((out.detach(), torch.autograd.grad(out, leaves, dy)))
    (a, ga), (b, gb) = res
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    # a shared k and v (in_dims None) is expanded over the clients
    out = torch.func.vmap(lambda x: fa.flash_attention_train(x, k[0], v[0], qpos, kpos, **kw))(q)
    torch.testing.assert_close(out[1], fa.flash_attention_train(q[1], k[0], v[0], qpos, kpos,
                                                                **kw))
    with pytest.raises(ValueError, match="shared"):
        torch.func.vmap(lambda x, p: fa.flash_attention_train(x, k[0], v[0], p, kpos, **kw))(
            q, qpos.expand(3, -1))


def _meta(*shape, grad=True, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype, requires_grad=grad)


def test_route_predicate():
    route = attention._flash_train_route
    pos = torch.arange(16, dtype=torch.int32)
    q, kv = _meta(1, 16, 4, 32), _meta(1, 16, 2, 32, grad=False)
    assert route(q, kv, kv, pos, 0)
    assert not route(_meta(1, 16, 4, 32, grad=False), kv, kv, pos, 0)   # nothing to train
    cpu = [torch.zeros(1, 16, 2, 32, requires_grad=True) for _ in range(3)]
    assert not route(*cpu, pos, 0)                                   # the CPU
    assert not route(*(_meta(1, 16, 2, 32, dtype=torch.bfloat16) for _ in range(3)),
                     pos, 0)                                         # bf16
    with torch.no_grad():
        assert not route(q, kv, kv, pos, 0)                          # no autograd
    assert not route(*(_meta(1, 16, 2, 48) for _ in range(3)), pos, 0)   # head_dim 48
    assert not route(q, kv, kv, pos, 8)                              # a prefix prefill
    q1 = _meta(1, 1, 4, 32)
    assert route(q1, kv, kv, pos[:1], 8)                             # a step past it
    # inside the client-parallel step's vmap the batched q does not say it
    # requires grad; its value does
    seen = []
    torch.func.vmap(lambda x: seen.append(route(x, kv[0], kv[0], pos, 0)) or x)(
        _meta(3, 1, 16, 4, 32))
    assert seen == [True]


@pytest.mark.parametrize("blocked", [False, True])
def test_meta_call_allocates_and_launches_nothing(blocked):
    """On meta (the dry run) a float32 call under autograd takes the flash
    route through ``_sdpa`` and ``_sdpa_blocked`` alike: its outputs and
    gradients come out on meta, no op makes a score-sized tensor, and no
    kernel launch is counted."""
    b, s, h, kh, hd = 1, 512, 4, 2, 64
    q, k, v = _meta(b, s, h, hd), _meta(b, s, kh, hd), _meta(b, s, kh, hd)
    pos = torch.arange(s, dtype=torch.int32, device="meta")
    sizes = []

    class Watch(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            sizes.extend(x.numel() for x in torch.utils._pytree.tree_leaves(out)
                         if isinstance(x, torch.Tensor))
            return out

    sdpa = attention._sdpa_blocked if blocked else attention._sdpa
    names = ("attn.grad_calls", "flash_train.calls", "flash_f32.launches",
             "flash_bwd.launches", "flash.launches")
    before = obs.totals()
    with Watch():
        out = sdpa(q, k, v, pos, pos, causal=True, window=0, prefix_len=0)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    moved = {n: obs.totals()[n] - before[n] for n in names}
    assert moved == {"attn.grad_calls": 1, "flash_train.calls": 1, "flash_f32.launches": 0,
                     "flash_bwd.launches": 0, "flash.launches": 0}
    assert out.is_meta and out.shape == q.shape
    assert [tuple(x.shape) for x in grads] == [tuple(x.shape) for x in (q, k, v)]
    assert all(x.is_meta for x in grads)
    assert max(sizes) < h * s * s


def test_bf16_and_no_grad_keep_their_routes():
    """bf16 under autograd and float32 without it: no flash training call,
    and ``attn.grad_calls`` counts only the call autograd records."""
    b, s, h, hd = 1, 64, 2, 32
    pos = torch.arange(s, dtype=torch.int32, device="meta")
    before = obs.totals()
    bf = [_meta(b, s, h, hd, dtype=torch.bfloat16) for _ in range(3)]
    attention._sdpa(*bf, pos, pos, causal=True, window=0, prefix_len=0)
    with torch.no_grad():
        f32 = [_meta(b, s, h, hd) for _ in range(3)]
        attention._sdpa(*f32, pos, pos, causal=True, window=0, prefix_len=0)
    after = obs.totals()
    assert after["attn.grad_calls"] - before["attn.grad_calls"] == 1
    assert after["flash_train.calls"] == before["flash_train.calls"]
