"""The meta-device dry run (``repro_torch.launch.dryrun``) on the CPU.

* ``Arch.param_shapes()`` and ``Arch.input_specs()`` give the reference's
  shapes and dtypes, path by path, for all ten configs and the four input
  shapes (int32 tokens and scalars on both sides: no dtype differs), and
  ``Arch.init(device="meta")`` makes nothing but ``meta`` tensors;
* every kernel wrapper's ``meta`` route gives its plain version's output
  shapes and dtypes and allocates exactly its outputs and scratch (the
  encode's partials, the split-KV decode's partial buffers), launching
  nothing; a plan the card refuses fails on ``meta`` too;
* the dry run of one config per family (dense, MoE, SSM, hybrid, VLM,
  enc-dec; reduced widths, the shapes' sequence lengths, cut batches)
  completes at each of the four shapes, and its prefill caches have the
  shapes and dtypes of the reference's ``jax.eval_shape``;
* ``measure_fit`` (two and three periods, one client's step) gives
  ``measure_step``'s FLOPs exactly and its peak within 2% (train) and 1%
  (prefill);
* the CLI writes one record per mesh;
* the reference's other variants: ``cf1`` (the MoE dispatch at capacity
  factor 1.0: the reference's capacity, fewer FLOPs; a dense config's
  figures unchanged), ``dp256`` (the FLOPs a device over pod·data·model)
  and ``client_parallel``'s cohort of pod × data clients with the ``tp``
  specs' argument bytes.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.launch.serve import make_prefill_step as j_prefill_step  # noqa: E402
from repro.models.api import Arch as JArch  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core.prng import Distribution  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.qsgd_quant import qsgd_tree  # noqa: E402
from repro_torch.kernels.tree import tree_plan  # noqa: E402
from repro_torch.core.projection import ProjectionMode  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.api import INPUT_SHAPES  # noqa: E402
from repro_torch.models.api import Arch as TArch  # noqa: E402
from repro_torch.sharding.rules import path_str, tree_paths  # noqa: E402

META = torch.device("meta")
FAMILIES = ["smollm-360m", "qwen3-moe-30b-a3b", "falcon-mamba-7b", "jamba-v0.1-52b",
            "paligemma-3b", "whisper-tiny"]
# cut batches of the family runs: train 8 (4 clients × 2 steps × 1), prefill
# 1, decode 2, long 1
CUT = {"train_4k": 8, "prefill_32k": 1, "decode_32k": 2, "long_500k": 1}


def _jax_rows(tree):
    from repro.sharding.rules import _path_str
    return [(_path_str(p), tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def _port_rows(tree):
    return [(path_str(p), tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in tree_paths(tree)]


@pytest.mark.parametrize("name", j_registry.ARCH_IDS)
def test_param_shapes_and_input_specs_equal_the_reference(name):
    j_arch, t_arch = j_registry.get_arch(name), t_registry.get_arch(name)
    tp = t_arch.param_shapes()
    assert all(x.is_meta for _, x in tree_paths(tp))
    assert _port_rows(tp) == _jax_rows(j_arch.param_shapes())
    for shape in INPUT_SHAPES:
        jin, tin = j_arch.input_specs(shape), t_arch.input_specs(shape)
        assert sorted(jin) == sorted(tin)
        for key in jin:
            assert _port_rows(tin[key]) == _jax_rows(jin[key]), (shape, key)
    assert t_arch.supports("train_4k") and not t_arch.supports("train_8k")


class _OnlyMeta(torch.utils._python_dispatch.TorchDispatchMode):
    """Fails on any op that makes a tensor off ``meta``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in torch.utils._pytree.tree_flatten(out)[0]:
            if isinstance(x, torch.Tensor):
                assert x.is_meta, func
        return out


def test_init_on_meta_allocates_nothing():
    with _OnlyMeta():
        for name in ("jamba-v0.1-52b", "whisper-tiny"):
            params = t_registry.get_arch(name).init(3, device="meta")
    assert all(x.is_meta for _, x in tree_paths(params))


# ---------------------------------------------------------------------------
# the kernels' meta routes
# ---------------------------------------------------------------------------

LAUNCHES = ("encode.launches", "close.launches", "decode.launches", "qsgd.launches",
            "flash.launches", "flash_prefill.launches", "flash_decode.launches",
            "flash_f32.launches")


def _counters():
    totals = obs.totals()
    return tuple(totals[n] for n in LAUNCHES)


def _run(fn, *args):
    """fn on meta inputs → (out, the bytes it allocated at its peak); a first
    call makes the cached plan (its block bounds live on the device)."""
    fn(*args)
    live = dryrun.LiveBytes()
    base = live.hold(args)
    with live:
        out = fn(*args)
    return out, live.peak - base


def _spec(t):
    return tuple(t.shape), t.dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_kernels_meta_routes(dtype):
    """Encode, fused close and decode: the plain versions' shapes and
    dtypes, exactly the outputs and the encode's partials allocated."""
    shapes = [(40, 24), (7,), (3, 5, 8)]
    gen = torch.Generator().manual_seed(0)
    cpu = {f"w{i}": torch.randn(s, generator=gen).to(dtype) for i, s in enumerate(shapes)}
    meta = {k: torch.empty_like(v, device=META) for k, v in cpu.items()}
    n, k = 3, 2
    seeds = torch.tensor([5, 6, 7])
    rs = torch.randn((n, k), generator=gen)
    before = _counters()
    for mode in (ProjectionMode.FULL, ProjectionMode.BLOCK):
        deltas = {key: v[None].expand((n,) + tuple(v.shape)).contiguous()
                  for key, v in cpu.items()}
        want = ops.project_tree_kernel(deltas, seeds, Distribution.RADEMACHER, k, mode)
        mdeltas = {key: torch.empty_like(v, device=META) for key, v in deltas.items()}
        got, used = _run(lambda d, s: ops.project_tree_kernel(
            d, s, Distribution.RADEMACHER, k, mode), mdeltas, seeds.to(META))
        plan = tree_plan("encode", shapes, [dtype] * 3, k, mode, META)
        tiles = plan.groups[0].num_tiles
        assert _spec(got) == _spec(want)
        assert used == 4 * n * k + 4 * n * k * tiles
        for fn in (ops.server_update_fused, ops.server_update_kernel):
            want = fn(cpu, rs, seeds, 0.5, Distribution.RADEMACHER, mode=mode)
            got, used = _run(lambda p, r, s: fn(p, r, s, 0.5, Distribution.RADEMACHER,
                                                 mode=mode), meta, rs.to(META),
                             seeds.to(META))
            assert {key: _spec(v) for key, v in got.items()} == {
                key: _spec(v) for key, v in want.items()}
            # the new leaves, and at most the folded rs (N, k) the wrapper makes
            outs = sum(v.numel() * v.element_size() for v in cpu.values())
            assert outs <= used <= outs + 4 * n * k
    assert _counters() == before


def test_qsgd_and_flash_meta_routes():
    """QSGD: q, the payload and the norm partials; flash: the output, and
    the split-KV decode's three partial buffers; no launch counted."""
    before = _counters()
    leaves = [torch.randn((3, 20, 16)), torch.randn((3, 9))]
    seeds = torch.tensor([1, 2, 3])
    want = qsgd_tree(leaves, seeds, 15, want_levels=True)
    got, used = _run(lambda ls, s: qsgd_tree(ls, s, 15, want_levels=True),
                     [torch.empty_like(x, device=META) for x in leaves], seeds.to(META))
    assert [_spec(q) for q in got[0]] == [_spec(q) for q in want[0]]
    assert _spec(got[1]) == _spec(want[1])
    plan = tree_plan("qsgd", [(20, 16), (9,)], [torch.float32] * 2, 1,
                     ProjectionMode.FULL, META)
    parts = plan.groups[0].num_parts
    assert used == (sum(x.numel() * 4 for x in leaves) + 4 * got[1].numel()
                    + 4 * 3 * parts)
    for s, t, h, kh, hd, dt in ((1, 4096, 8, 1, 64, torch.bfloat16),
                                (2048, 2048, 6, 2, 64, torch.bfloat16),
                                (300, 300, 4, 4, 32, torch.float32)):
        q = torch.empty((2, s, h, hd), dtype=dt, device=META)
        k = torch.empty((2, t, kh, hd), dtype=dt, device=META)
        qpos = torch.empty((s,), dtype=torch.int32, device=META)
        kpos = torch.empty((t,), dtype=torch.int32, device=META)
        out, used = _run(lambda *a: fa.flash_attention(*a), q, k, k, qpos, kpos)
        assert _spec(out) == _spec(q)
        expect = q.numel() * q.element_size()
        if fa.flash_route(s, h, kh, dt) == "decode":
            nparts = -(-t // fa.decode_partition(hd, dt))
            rows = 2 * kh * s * (h // kh) * nparts
            expect += 4 * rows * (2 + hd)
        assert used == expect
    assert _counters() == before


def test_meta_route_refuses_what_the_card_refuses():
    with pytest.raises(ValueError, match="passes"):
        ops.project_tree_kernel({"w": torch.empty((1, 2**31, 2), device=META)},
                                torch.zeros(1, dtype=torch.int64, device=META))
    q = torch.empty((1, 16, 2, 48), device=META)
    pos = torch.empty((16,), dtype=torch.int32, device=META)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, pos, pos)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def _family_arch(name):
    """The reduced config; the hybrid's period cut to (attention, Mamba)
    with its MoE every second layer, so one period runs one Mamba layer."""
    cfg = t_registry.get_config(name).reduced()
    jcfg = j_registry.get_config(name).reduced()
    if name in ("falcon-mamba-7b", "paligemma-3b"):
        # one layer: the Mamba scan's chunks and the prefix recurrence's
        # blocks are Python loops, slow on meta at 32 768 positions
        cfg, jcfg = (dataclasses.replace(c, num_layers=1) for c in (cfg, jcfg))
    if name == "jamba-v0.1-52b":
        over = dict(num_layers=2, attn_period=2, attn_offset=0, moe_period=2)
        cfg, jcfg = dataclasses.replace(cfg, **over), dataclasses.replace(jcfg, **over)
    return TArch(cfg), JArch(jcfg)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("name", FAMILIES)
def test_dry_run_of_each_family_completes(name, shape):
    arch, jarch = _family_arch(name)
    kinds = {arch.cfg.layer_kind(i) for i in range(arch.cfg.num_layers)}
    if name == "jamba-v0.1-52b":
        assert kinds == {"attn", "mamba"}
    m = dryrun.measure_fit(arch, shape, global_batch=CUT[shape])
    assert m["peak_bytes"] >= m["argument_bytes"] > 0
    if INPUT_SHAPES[shape][2] != "decode" or arch.cfg.num_heads:
        assert m["flops"] > 0
    if shape == "prefill_32k":
        seq = INPUT_SHAPES[shape][0]
        _, caches = m["out"]
        jspec = jarch.input_specs(shape)["batch"]
        jspec = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct((1,) + x.shape[1:], x.dtype), jspec)
        jparams = jarch.param_shapes()
        _, jcaches = jax.eval_shape(j_prefill_step(jarch, capacity=seq), jparams, jspec)
        assert _port_rows(caches) == _jax_rows(jcaches)


def test_client_parallel_dry_run_keeps_n_replicas():
    """The client-parallel step on meta: one encode over the N stacked δ; its
    peak holds the N replicas the sequential step does not."""
    arch = _family_arch("smollm-360m")[0]
    seq = dryrun.measure_step(arch, "train_4k", global_batch=8)
    par = dryrun.measure_step(arch, "train_4k", variant="client_parallel",
                              global_batch=8)
    assert par["flops"] == pytest.approx(seq["flops"], rel=1e-12)
    params = sum(x.numel() * x.element_size() for _, x in tree_paths(arch.param_shapes()))
    assert par["peak_bytes"] > seq["peak_bytes"] + 2 * params


@pytest.mark.parametrize("shape,tol", [("train_4k", 0.02), ("prefill_32k", 0.01)])
def test_fit_matches_the_full_run(shape, tol):
    """SmolLM-360M at 5 layers: the fit's FLOPs and argument bytes exact, its
    peak within 2% (train: one client's step against four clients' two) and
    1% (prefill)."""
    arch = TArch(dataclasses.replace(t_registry.get_config("smollm-360m"), num_layers=5))
    full = dryrun.measure_step(arch, shape, global_batch=CUT[shape])
    fit = dryrun.measure_fit(arch, shape, global_batch=CUT[shape])
    assert fit["flops"] == full["flops"]
    assert fit["argument_bytes"] == full["argument_bytes"]
    assert abs(fit["peak_bytes"] - full["peak_bytes"]) <= tol * full["peak_bytes"]


def test_live_bytes_counts_storages_once_and_frees_them():
    live = dryrun.LiveBytes()
    x = torch.empty((256,), device=META)
    live.hold(x)
    with live:
        y = x * 2                      # 1 KiB
        v = y.view(16, 16)             # a view: nothing new
        y.add_(1)                      # in place: nothing new
        del y
        z = v + 1                      # 1 KiB more while v lives
        del v, z
        w = torch.empty((512,), device=META)   # 2 KiB
    # x, y and z at once (y's storage lives on in v), then x and w
    assert live.peak == 3 * 1024
    assert live.live == 1024 + 2048
    del w


def test_cli_writes_one_record_per_mesh(tmp_path):
    dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k", "--outdir",
                 str(tmp_path)])
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert sorted(recs) == [f"smollm-360m__long_500k__{m}.json"
                            for m in ("one_card", "pod16x16", "pod2x16x16")]
    one = recs["smollm-360m__long_500k__one_card.json"]["per_device"]
    pod = recs["smollm-360m__long_500k__pod16x16.json"]["per_device"]
    assert one["fits"] and one["peak_bytes_est"] >= one["argument_bytes"]
    assert pod["peak_bytes_est"] is None and pod["argument_bytes"] < one["argument_bytes"]
    assert recs["smollm-360m__long_500k__pod16x16.json"]["roofline"]["link_bw"] == 50e9


def test_train_step_hands_softmax_contiguous_operands():
    """The card's softmax kernels copy a strided operand below the
    dispatcher, where the meta estimate cannot see it: the plain
    attention's P·V keeps P's order, so no train step hands the softmax
    (or its backward) a strided tensor."""
    from repro_torch.launch.train import FLRunConfig, make_train_step

    strided = []

    class Watch(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "softmax" in str(func):
                strided.extend(str(func) for a in args
                               if isinstance(a, torch.Tensor) and not a.is_contiguous())
            return func(*args, **(kwargs or {}))

    arch = _family_arch("smollm-360m")[0]
    with Watch():
        make_train_step(arch, FLRunConfig(2, 1))(
            arch.param_shapes(), arch.input_specs("train_4k", 2)["batch"], 0)
    assert strided == []


# ---------------------------------------------------------------------------
# the reference's dp256 and cf1 variants, and client_parallel's cohort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_cf1_shrinks_the_moe_dispatch(shape, monkeypatch):
    """Reduced Qwen3-MoE at two experts a token (which drops): cf1's
    capacity is the reference's C = min(T, max(1, round(T·k/E·1.0))), its
    FLOPs are below the baseline's, and so is its peak where the (E, C, d)
    dispatch holds the peak (the prefill).  The train step's peak lies in
    the attention scores of a 4096-token sequence, which cf1 leaves as it
    is."""
    arch = TArch(dataclasses.replace(t_registry.get_config("qwen3-moe-30b-a3b").reduced(),
                                     experts_per_token=2))
    seen = []
    einsum = torch.einsum

    def spy(eq, *ops_):
        if eq == "ecd,edf->ecf":
            seen.append(ops_[0].shape[1])
        return einsum(eq, *ops_)

    monkeypatch.setattr(torch, "einsum", spy)
    figures = {v: dryrun.measure_fit(arch, shape, variant=v, global_batch=CUT[shape])
               for v in ("baseline", "cf1")}
    monkeypatch.undo()
    cfg = arch.cfg
    tokens = INPUT_SHAPES[shape][0]      # one sequence a step (the cut batch)
    want = int(min(tokens, max(1, round(tokens * cfg.experts_per_token
                                        / cfg.num_experts * 1.0))))
    cf125 = int(min(tokens, max(1, round(tokens * cfg.experts_per_token
                                         / cfg.num_experts * cfg.capacity_factor))))
    assert sorted(set(seen)) == sorted({want, cf125})
    base, cf1 = figures["baseline"], figures["cf1"]
    assert cf1["flops"] < base["flops"] and cf1["peak_bytes"] <= base["peak_bytes"]
    if shape == "prefill_32k":
        assert cf1["peak_bytes"] < base["peak_bytes"]
    assert cf1["argument_bytes"] == base["argument_bytes"]


def test_cf1_on_a_dense_config_is_the_baseline():
    arch = _family_arch("smollm-360m")[0]
    base = dryrun.measure_fit(arch, "train_4k", global_batch=CUT["train_4k"])
    cf1 = dryrun.measure_fit(arch, "train_4k", variant="cf1", global_batch=CUT["train_4k"])
    for key in ("argument_bytes", "output_bytes", "alias_bytes", "peak_bytes", "flops"):
        assert cf1[key] == base[key], key


def test_cli_writes_dp256_and_cf1_records(tmp_path):
    for variant, shape in (("dp256", "train_4k"), ("cf1", "decode_32k")):
        dryrun.main(["--arch", "smollm-360m", "--shape", shape, "--variant", variant,
                     "--fit", "--outdir", str(tmp_path)])
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert sorted(recs) == sorted(
        [f"smollm-360m__train_4k__{m}__dp256.json" for m in dryrun.PRODUCTION_MESHES]
        + [f"smollm-360m__decode_32k__{m}__cf1.json" for m in dryrun.PRODUCTION_MESHES])
    for mesh in ("pod16x16", "pod2x16x16"):
        rec = recs[f"smollm-360m__train_4k__{mesh}__dp256.json"]
        sizes = dryrun.MESHES[mesh]
        devices = sizes["pod"] * sizes["data"] * sizes["model"]
        pd = rec["per_device"]
        # the global batch of 256 over every device it reaches
        assert pd["flops"] == pd["flops_step"] / min(devices, rec["global_batch"])
        assert rec["layout"] == "zero3" and "dp256" in rec["layout_note"]
        assert rec["roofline"]["layout"] == "zero3"
    one = recs["smollm-360m__decode_32k__one_card__cf1.json"]
    assert one["variant"] == "cf1" and one["layout"] == "zero3"
    assert one["per_device"]["peak_bytes_est"] >= one["per_device"]["argument_bytes"]


def test_client_parallel_takes_a_client_a_data_row():
    """N = pod × data, as the reference's dry run; the replicas' argument
    bytes from the tp specs."""
    assert [dryrun.cohort(m, "client_parallel") for m in
            ("one_card", "pod16x16", "pod2x16x16")] == [1, 16, 32]
    assert dryrun.cohort("pod16x16", "baseline") == dryrun.FL_CLIENTS
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.rules import input_specs_sharding, param_specs, per_device_bytes

    arch = t_registry.get_arch("smollm-360m")
    m = dict(argument_bytes=0, output_bytes=0, alias_bytes=0, peak_bytes=0, flops=1.0,
             global_batch=256, seconds=0.0)
    rec = dryrun._record(arch, "smollm-360m", "train_4k", "pod16x16", "client_parallel",
                         m, dryrun.H100_BYTES, 16, 2)
    mesh = make_production_mesh()
    shapes = arch.param_shapes()
    batch = arch.input_specs("train_4k")
    want = (per_device_bytes(shapes, param_specs(shapes, mesh, layout="tp"), mesh)
            + per_device_bytes(batch["batch"], input_specs_sharding(batch["batch"], mesh,
                                                                     256), mesh)
            + batch["round_idx"].element_size())
    assert rec["per_device"]["argument_bytes"] == want
    assert rec["layout"] == "tp" and rec["clients"] == 16
