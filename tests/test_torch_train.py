"""The port's LLM training path against the reference, on the CPU.

Same parameters on both sides: the reference initialises with
``jax.random`` and ``repro_torch.convert.params_from_jax`` carries the
tree across (bf16 leaves bit for bit); inputs come from numpy with a
seed.  Configs: the four reduced dense configs and the GQA variant of
reduced SmolLM of ``tests/test_torch_lm.py`` (d_model 384, 6 heads, 2 kv
heads), in float32 and bfloat16.

Tolerances, with their reasons:

* ``lm_loss`` float32: loss within 1e-5 (observed ≤ 1.9e-6 on ≈ 6.6),
  each leaf's gradient within 2e-5 of the leaf's largest |gradient|
  (observed ≤ 2.0e-6): matmul and reduction sums in other orders.
* ``lm_loss`` bfloat16: loss within 1e-2 (observed ≤ 3.0e-3), each leaf's
  gradient within 0.06 of its largest |gradient| (observed ≤ 0.031, eight
  bf16 ulps) and with a cosine ≥ 0.999 to the reference's: the frameworks
  round activations, residuals and gradients to bf16 at other points.
* Remat on and off: bitwise, logits and every gradient (the recomputation
  repeats the same CPU ops), on one CPU thread (with several, the CPU
  embedding backward's sum order can change from call to call).
* ``train_step`` float32: loss within 1e-5; each client's r within
  1e-5·(1 + |r|) (r sums d products of δ, whose last bits follow the
  gradients' sum order); the new params within Σₙ|Δrₙ|/N + 1e-6 (the
  rademacher close moves each element by Σ rₙvₙ/N).
* ``train_step`` bfloat16: loss within 1e-2; r within 2⁻⁸·√S·‖x‖₂ (δ is
  a difference of two bf16 params, and each of the S local steps rounds
  every element to bf16 — one ulp, ≤ 2⁻⁸|w|, of random sign, summed over
  d elements in r); the new params within Σₙ|Δrₙ|/N plus one bf16 ulp.
  That bound is for the end-to-end comparison only: the encode itself is
  held on the reference's own final δ of each client (captured at its
  encode), each port r within ``tree_encode_tolerance`` of the
  reference's, in both dtypes.
* The close: the port's ``ops.server_update_kernel`` (plain on the CPU)
  equals the reference's ``server_aggregate`` bit for bit on float32
  leaves (N = 4, server_lr = 1, the ±1/±2 families).  On bf16 leaves
  the reference rounds each client's reconstruction rₙ·vₙ to bf16 before
  its float32 sum; with bf16-representable rₙ that rounding is exact and
  the two are bitwise equal, so it is the whole difference.  The train
  step's close (``per_client_rounding``) takes that rounding and equals
  ``server_aggregate`` bit for bit on both dtypes, k = 1, FULL 8 and
  BLOCK 8.  Against
  the reference's own kernel (``ops.server_update_kernel``, interpret
  mode, on bf16 leaves) the port is bitwise equal to that kernel's
  fused multiply-add emulated from the port's own sum (the reference's
  XLA contracts ``x + scale·acc`` into one FMA; ROADMAP C).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as j_train  # noqa: E402
from repro.core import fedscalar as j_fs  # noqa: E402
from repro.core import projection as j_projection  # noqa: E402
from repro.core.prng import Distribution as JD  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models.api import Arch as JArch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.prng import Distribution as TD  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.seeded_projection import tree_encode_tolerance  # noqa: E402
from repro_torch.launch.train import FLRunConfig, make_train_step  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.api import Arch as TArch  # noqa: E402
from test_torch_lm import CASES, _cfgs, _ids  # noqa: E402
from torch_parity import jax_kernels, seeds_np  # noqa: E402,F401

EXACT = ["rademacher", "sparse_rademacher", "hadamard"]
# The MoE and SSM families at 2 layers, as the dense configs above.
FAMILY_CASES = [("qwen3-moe-30b-a3b", "float32", False),
                ("qwen3-moe-30b-a3b", "bfloat16", False),
                ("qwen3-moe-30b-a3b", "float32", "k2"),
                ("qwen3-moe-30b-a3b", "bfloat16", "k2"),
                ("falcon-mamba-7b", "float32", False),
                ("falcon-mamba-7b", "bfloat16", False)]
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRAD_TOL = {"float32": 2e-5, "bfloat16": 0.06}


def _carry(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _tokens(vocab, batch, seq, seed):
    toks = np.random.RandomState(seed).randint(0, vocab, (batch, seq + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])})


def _with_frontend(cfg, jb, tb, seed):
    """Add a frontend's ``embeds`` from numpy to both batches: the VLM's
    patch embeddings or the enc-dec's audio frames (the reference's
    stubbed frontends, ``examples/serve_llm.py``)."""
    n = {"vision": cfg.num_frontend_tokens, "audio": cfg.encoder_seq}.get(cfg.frontend)
    if n:
        b = tb["tokens"].shape[0]
        e = (np.random.RandomState(seed).randn(b, n, cfg.d_model) * 0.02).astype(np.float32)
        jb["embeds"] = jnp.asarray(e, cfg.jnp_dtype)
        tb["embeds"] = torch.from_numpy(e).to(T_DT[cfg.dtype])
    return jb, tb


def _loss_and_grads(params, cfg, batch):
    p = tree_map(lambda w: w.detach().clone().requires_grad_(True), params)
    loss = t_lm.lm_loss(p, cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(p))


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------

def _check_loss_and_grads(case, grad_tol):
    name, dtype, gqa = case
    jc, tc = _cfgs(name, dtype, gqa)
    jp = j_lm.init_lm(jc, jax.random.PRNGKey(1))
    jb, tb = _tokens(jc.vocab_size, 2, 24, 2)
    j_loss, j_grads = jax.value_and_grad(lambda p: j_lm.lm_loss(p, jc, jb))(jp)
    t_loss, t_grads = _loss_and_grads(_carry(jp), tc, tb)
    assert t_loss.dtype == torch.float32
    assert abs(float(t_loss) - float(j_loss)) <= LOSS_TOL[dtype]
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(j_leaves) == len(t_grads)
    for jg, tg in zip(j_leaves, t_grads):
        # each leaf's own dtype: the MoE router and the Mamba a_log and
        # d_skip are float32 in a bf16 tree
        assert str(tg.dtype).removeprefix("torch.") == str(jg.dtype)
        assert tuple(tg.shape) == jg.shape
        a, b = _f32(jg), _f32(tg)
        scale = np.abs(a).max()
        assert scale > 0
        assert np.abs(a - b).max() <= grad_tol * scale
        if dtype == "bfloat16":
            cos = (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum())
            assert cos >= 0.999


@pytest.mark.parametrize("case", CASES + FAMILY_CASES, ids=_ids)
def test_lm_loss_and_grads_match_reference(case):
    _check_loss_and_grads(case, GRAD_TOL[case[1]])


def test_lm_loss_scores_only_the_trailing_text():
    """A frontend's prepended positions are not scored (the reference's slice)."""
    jc, tc = _cfgs("smollm-360m", "float32")
    jp = j_lm.init_lm(jc, jax.random.PRNGKey(3))
    rng = np.random.RandomState(4)
    emb = (rng.randn(2, 5, jc.d_model) * 0.1).astype(np.float32)
    jb, tb = _tokens(jc.vocab_size, 2, 11, 5)
    want = j_lm.lm_loss(jp, jc, {**jb, "embeds": jnp.asarray(emb)})
    got = t_lm.lm_loss(_carry(jp), tc, {**tb, "embeds": torch.from_numpy(emb)})
    assert abs(float(got) - float(want)) <= LOSS_TOL["float32"]


@pytest.fixture
def one_thread():
    """One CPU thread: with several, torch's CPU embedding backward sums in an
    order that can change from call to call (1.9e-9 apart at 1024 tokens)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_matches_no_remat(dtype, one_thread):
    _, tc = _cfgs("smollm-360m", dtype, gqa=True)
    params = TArch(tc).init(seed=3, device="cpu")
    _, tb = _tokens(tc.vocab_size, 4, 64, 6)

    def logits_and_grads(remat):
        p = tree_map(lambda w: w.detach().clone().requires_grad_(True), params)
        logits = t_lm.lm_forward(p, tc, tokens=tb["tokens"], remat=remat)
        # any scalar of the logits that reaches every leaf will do
        score = (logits * torch.cos(logits.detach())).mean()
        return logits.detach(), torch.autograd.grad(score, tree_leaves(p))

    l_on, g_on = logits_and_grads(True)
    l_off, g_off = logits_and_grads(False)
    assert torch.equal(l_on, l_off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)
        assert a.abs().max() > 0       # the stacked leaves get a gradient


def test_blocked_attention_stays_differentiable_on_the_cpu(monkeypatch):
    """Above the threshold the CPU takes the flash kernel's plain version,
    which autograd reaches (the card raises until a backward kernel exists,
    ``tests/test_torch_cuda.py``); remat on and off agree there too."""
    import repro_torch.models.attention as t_attention

    monkeypatch.setattr(t_attention, "BLOCKED_SDPA_THRESHOLD", 8)
    _, tc = _cfgs("smollm-360m", "float32", gqa=True)
    params = TArch(tc).init(seed=4, device="cpu")
    _, tb = _tokens(tc.vocab_size, 2, 16, 8)
    blocked = _loss_and_grads(params, tc, tb)
    monkeypatch.setattr(t_attention, "BLOCKED_SDPA_THRESHOLD", 8192)
    plain = _loss_and_grads(params, tc, tb)
    assert abs(float(blocked[0]) - float(plain[0])) <= 1e-5
    for a, b in zip(blocked[1], plain[1]):
        assert a.abs().max() > 0
        torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5 * float(b.abs().max()))


def test_arch_loss_is_lm_loss():
    _, tc = _cfgs("qwen1.5-4b", "float32")
    params = TArch(tc).init(seed=1, device="cpu")
    _, tb = _tokens(tc.vocab_size, 2, 8, 7)
    assert torch.equal(TArch(tc).loss(params, tb), t_lm.lm_loss(params, tc, tb))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _reference_step(monkeypatch, arch, params, batch, round_idx, fl):
    """Reference ``make_train_step`` (not jitted), its rs captured at the close
    and each client's final δ (with its seed) at the encode."""
    seen = {"deltas": []}
    aggregate = j_train.server_aggregate
    project = j_train.project_tree

    def spy(p, rs, seeds, pcfg):
        seen["rs"], seen["seeds"] = np.asarray(rs), np.asarray(seeds)
        return aggregate(p, rs, seeds, pcfg)

    def spy_project(delta, seed, *args):
        jax.debug.callback(lambda d, sd: seen["deltas"].append((d, int(sd))),
                           delta, seed, ordered=True)
        return project(delta, seed, *args)

    monkeypatch.setattr(j_train, "server_aggregate", spy)
    monkeypatch.setattr(j_train, "project_tree", spy_project)
    new, metrics = j_train.make_train_step(arch, fl)(params, batch,
                                                      jnp.int32(round_idx))
    return new, metrics, seen


@pytest.mark.parametrize("case", [("smollm-360m", "float32", False),
                                  ("smollm-360m", "bfloat16", False),
                                  ("smollm-360m", "float32", True),
                                  ("qwen3-moe-30b-a3b", "float32", "k2"),
                                  ("falcon-mamba-7b", "float32", False)], ids=_ids)
def test_train_step_matches_reference(case, monkeypatch):
    _check_train_step(case, monkeypatch, 1e-5)


def _check_train_step(case, monkeypatch, r_rtol):
    name, dtype, gqa = case
    jc, tc = _cfgs(name, dtype, gqa)
    n, s, lr = 4, 2, 0.05
    jp = JArch(jc).init(jax.random.PRNGKey(0))
    tp = _carry(jp)
    jb, tb = _with_frontend(jc, *_tokens(jc.vocab_size, 8, 16, 0), 5)
    j_new, j_m, seen = _reference_step(
        monkeypatch, JArch(jc), jp, jb, 3,
        j_train.FLRunConfig(num_virtual_clients=n, local_steps=s, local_lr=lr))
    before = tree_map(torch.clone, tp)
    t_new, t_m = make_train_step(
        TArch(tc), FLRunConfig(num_virtual_clients=n, local_steps=s,
                               local_lr=lr))(tp, tb, 3)
    for a, b in zip(tree_leaves(tp), tree_leaves(before)):
        assert torch.equal(a, b)                      # global params untouched
    assert t_m["uploaded_scalars"] == int(j_m["uploaded_scalars"]) == 2 * n
    np.testing.assert_array_equal(t_m["seeds"].numpy(),
                                  seen["seeds"].astype(np.int64))
    assert abs(float(t_m["loss"]) - float(j_m["loss"])) <= LOSS_TOL[dtype]
    j_rs, t_rs = seen["rs"].reshape(n, 1), t_m["r"].numpy()
    assert t_rs.shape == (n, 1) and t_m["r"].dtype == torch.float32
    if dtype == "float32":
        r_tol = r_rtol * (1 + np.abs(j_rs))
        slack = 1e-6
    else:
        norm = np.sqrt(sum(float((w.float() ** 2).sum()) for w in tree_leaves(tp)))
        r_tol = 2.0 ** -8 * np.sqrt(s) * norm
        slack = None
    assert (np.abs(t_rs - j_rs) <= r_tol).all()
    np.testing.assert_allclose(float(t_m["r_rms"]), float(j_m["r_rms"]),
                               atol=float(np.max(r_tol)))
    # The encode itself: each client's final δ as the reference materialises
    # it (captured at its encode) through both encodes, the port's r within
    # the encode's tolerance of the reference's (this sees a wrong r that
    # the end-to-end bound admits).  The reference's own encode runs
    # eagerly here: inside its train step XLA may keep δ = ψ_S − x in
    # float32 instead of rounding it to bf16 (excess precision), which
    # moves its r by up to ~1e-3 at this size.
    assert len(seen["deltas"]) == n
    for jd, sd in seen["deltas"]:
        want = float(j_projection.project_tree(jd, jnp.uint32(sd))[0])
        delta = tree_map(lambda w: w.unsqueeze(0), _carry(jd))
        got = float(ops.project_tree_kernel(delta, torch.tensor([sd]))[0, 0])
        views = [w.reshape(1, *_view2(w.shape[1:])) for w in tree_leaves(delta)]
        tol = float(tree_encode_tolerance(views, "rademacher")[0, 0])
        assert abs(got - want) <= tol
    dr = float(np.abs(t_rs - j_rs).sum()) / n
    for jw, tw in zip(jax.tree_util.tree_leaves(j_new), tree_leaves(t_new)):
        assert tw.dtype == tc.torch_dtype and tuple(tw.shape) == jw.shape
        a, b = _f32(jw), _f32(tw)
        bound = dr + (slack if slack is not None
                      else 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b)))
        assert (np.abs(a - b) <= bound).all()


def test_train_step_rejects_batches_that_do_not_split():
    _, tc = _cfgs("smollm-360m", "float32")
    step = make_train_step(TArch(tc), FLRunConfig(num_virtual_clients=4,
                                                  local_steps=2))
    params = TArch(tc).init(seed=0, device="cpu")
    for gb in (6, 12):     # 6 % 4 clients, 12 / 4 = 3 % 2 steps
        _, tb = _tokens(tc.vocab_size, gb, 4, 0)
        with pytest.raises(ValueError):
            step(params, tb, 0)


# ---------------------------------------------------------------------------
# the close
# ---------------------------------------------------------------------------

def _close_inputs(dtype, seed, n=4):
    jc, _ = _cfgs("smollm-360m", dtype, gqa=True)
    jp = JArch(jc).init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    rs = (rng.randn(n, 1) * 0.5).astype(np.float32)
    return jp, rs, seeds_np(rng, n)


def _ref_aggregate(jp, rs, seeds, family):
    cfg = j_fs.FedScalarConfig(server_lr=1.0, distribution=JD(family))
    return j_fs.server_aggregate(jp, jnp.asarray(rs), jnp.asarray(seeds), cfg)


def _port_close(jp, rs, seeds, family):
    return ops.server_update_kernel(
        _carry(jp), torch.from_numpy(rs),
        torch.from_numpy(seeds.astype(np.int64)), 1.0, TD(family))


@pytest.mark.parametrize("family", EXACT)
def test_close_is_server_aggregate_bitwise_float32(family):
    jp, rs, seeds = _close_inputs("float32", 0)
    want = _ref_aggregate(jp, rs, seeds, family)
    got = _port_close(jp, rs, seeds, family)
    for jw, tw in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def _view2(shape):
    rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    return (rows, int(shape[-1]) if shape else 1)


@pytest.mark.parametrize("family", EXACT)
def test_bf16_close_differs_from_server_aggregate_only_by_its_rounding(family):
    """The runtime's close (float32 to the end) differs from the reference's
    ``server_aggregate`` on bf16 leaves only by its per-client rounding; the
    train step's close, which takes that rounding, equals it bit for bit."""
    jp, rs, seeds = _close_inputs("bfloat16", 1)
    rs_bf16 = torch.from_numpy(rs).to(torch.bfloat16).to(torch.float32).numpy()
    assert not np.array_equal(rs_bf16, rs)
    # r·v exact in bf16: the reference's per-client rounding is a no-op
    want = _ref_aggregate(jp, rs_bf16, seeds, family)
    got = _port_close(jp, rs_bf16, seeds, family)
    for jw, tw in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert tw.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(tw), _f32(jw))
    # with float32 rs the reference rounds each rₙ·vₙ (≤ half a bf16 ulp
    # of |rₙ|·max|v|) before its sum: that, divided by N, and one bf16 ulp
    # of the result bound the difference, and it does show
    want = _ref_aggregate(jp, rs, seeds, family)
    got = _port_close(jp, rs, seeds, family)
    vmax = 2.0 if family == "sparse_rademacher" else 1.0
    per_client = float(np.sum(2.0 ** -9 * np.abs(rs) * vmax)) / len(rs)
    differs = False
    for jw, tw in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        a, b = _f32(jw), _f32(tw)
        assert (np.abs(a - b) <= per_client + 2.0 ** -7 * np.abs(a)).all()
        differs = differs or not np.array_equal(a, b)
    assert differs
    # the train step's close rounds each client as the reference does
    got = ops.server_update_kernel(
        _carry(jp), torch.from_numpy(rs),
        torch.from_numpy(seeds.astype(np.int64)), 1.0, TD(family),
        per_client_rounding=True)
    for jw, tw in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert tw.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(tw), _f32(jw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", EXACT)
@pytest.mark.parametrize("k,mode,n,lr", [(1, "full", 4, 1.0), (1, "full", 3, 0.7),
                                         (8, "full", 4, 1.0), (8, "block", 5, 0.9)])
def test_train_close_is_server_aggregate_bitwise(dtype, family, k, mode, n, lr):
    """The per-client-rounding close (the train step's) against the
    reference's ``server_aggregate``, float32 rs: bitwise, on float32 and
    bf16 leaves (a small tree; the train step's own leaves are held in
    ``test_bf16_close_differs_from_server_aggregate_only_by_its_rounding``),
    k = 1, FULL 8 and BLOCK 8, N = 3, 4, 5."""
    from repro.core.projection import ProjectionMode as JM
    from repro_torch.core.projection import ProjectionMode as TM

    rng = np.random.RandomState(n + k)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = {name: jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.1).astype(jdt)
          for name, shape in (("b", (24,)), ("w", (64, 24)), ("z", (7, 40)))}
    rs = (rng.randn(n, k) * 0.5).astype(np.float32)
    seeds = seeds_np(rng, n)
    cfg = j_fs.FedScalarConfig(server_lr=lr, distribution=JD(family),
                               num_projections=k, mode=JM(mode))
    want = j_fs.server_aggregate(jp, jnp.asarray(rs), jnp.asarray(seeds), cfg)
    got = ops.server_update_kernel(
        _carry(jp), torch.from_numpy(rs), torch.from_numpy(seeds.astype(np.int64)),
        lr, TD(family), mode=TM(mode), per_client_rounding=True)
    for jw, tw in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert tw.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        np.testing.assert_array_equal(_f32(tw), _f32(jw))


@pytest.mark.parametrize("family", EXACT)
def test_bf16_close_matches_reference_kernel(jax_kernels, family):
    """Port close on bf16 leaves against the reference's interpret-mode
    ``ops.server_update_kernel``: bitwise against its FMA emulated from the
    port's own float32 sum, within one bf16 ulp of the kernel itself."""
    jp, rs, seeds = _close_inputs("bfloat16", 2)
    want = jax_kernels.ops.server_update_kernel(
        jp, jnp.asarray(rs), jnp.asarray(seeds), 1.0, JD(family), interpret=True)
    tp = _carry(jp)
    got = _port_close(jp, rs, seeds, family)
    acc = ops.server_update_kernel(
        tree_map(lambda w: torch.zeros(w.shape), tp), torch.from_numpy(rs),
        torch.from_numpy(seeds.astype(np.int64)), len(rs), TD(family))
    scale = np.float32(1.0 / len(rs))
    for jw, tw, x, a in zip(jax.tree_util.tree_leaves(want), tree_leaves(got),
                            tree_leaves(tp), tree_leaves(acc)):
        # acc holds Σ rₙvₙ exactly as the port sums it (scale N·(1/N) = 1)
        fma = (_f32(x).astype(np.float64) + np.float64(scale)
               * _f32(a).astype(np.float64)).astype(np.float32)
        fma_bf16 = torch.from_numpy(fma).to(torch.bfloat16)
        assert torch.equal(fma_bf16.view(torch.int16),
                           torch.from_numpy(np.array(jw).view(np.int16)))
        ref = _f32(jw)
        assert (np.abs(_f32(tw) - ref) <= 2.0 ** -7 * np.abs(ref)).all()
