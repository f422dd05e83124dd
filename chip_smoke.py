#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check its kernels.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and the final line is not printed):

1. device: the card's name, count, and ``nvidia-smi`` name and power limit;
2. build: both CUDA sources with nvcc (in parallel), with ptxas's
   registers and spills per kernel;
3. kernels against their plain PyTorch versions, on the card, at the MLP
   leaves, a SmolLM-360M-sized tied embedding (49152, 960) for k = 1 and
   FULL k = 8, and a (960, 2560) leaf for BLOCK k = 8; all four direction
   families, nonzero row/col offsets, cohorts 20 and 1000.  The fused
   close must equal its plain version bitwise for the ±1/±2 families
   (gaussian within rtol/atol 1e-5); the encode within
   ``encode_tolerance`` (4·2⁻²³·√h·‖x‖₂·max|v|, h the depth of its float32
   sum) of its plain version summed in float64, and bitwise equal to
   itself across runs;
4. main path: ``run_simulation`` on the card for fedscalar_rademacher,
   fedscalar_gaussian, fedscalar_block8 and fedscalar_ef (N = 20, S = 5,
   B = 32);
   both kernels' launch counters must move and the loss must fall; one
   round on the card must match the same round on the CPU (atol 1e-6);
5. times from CUDA events: each kernel, its plain version and its bound,
   at the main path's shapes and at the large leaf (cohorts 256, 1024).

The line before the last is a JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM: HBM3 rate from the data sheet.  Instruction rates are
# results per clock per SM from the CUDA C++ Programming Guide's
# arithmetic-instruction throughput table (compute capability 9.0: 128
# for float32 add or multiply, 64 for 32-bit integer add, logic, shift,
# compare and multiply), times 132 SMs at 1.98 GHz; the data sheet's
# 67 TFLOP/s float32 is the same 128 lanes with an FMA counted as two.
# Issue is 4 warp instructions per clock per SM, 128 lanes in all.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 132 * 128 * 1.98e9        # 33.5e12 non-FMA float32 ops/s
INT32_OPS_PER_S = 132 * 64 * 1.98e9        # 16.7e12 int32 ops/s, each class
ISSUE_PER_S = 132 * 128 * 1.98e9           # all instructions together

FAMILIES = ("rademacher", "gaussian", "sparse_rademacher", "hadamard")
EXACT = ("rademacher", "sparse_rademacher", "hadamard")
# Least ops per (element, client, block) of the rademacher chain after the
# hoisted rounds, by class (the times are timed with rademacher):
# integer add/logic/shift/select: the input xor, the round's add, three
# shifts, two xors, the last xor merged with the bit-8 test into one
# 3-input logic op, the ±1 select (9); integer multiplies (2); float32
# multiply and add (2).  Both kernels do the same per element.
ELEM_OPS = {"int": 9, "imul": 2, "fp": 2}
# Per (row, client, block): two SplitMix32 rounds and two xors.
ROW_OPS = {"int": 16, "imul": 4, "fp": 0}
MAIN_METHODS = ("fedscalar_rademacher", "fedscalar_gaussian", "fedscalar_block8",
                "fedscalar_ef")
MAIN_ROUNDS = 40
LARGE = (49152, 960)             # SmolLM-360M tied embedding (vocab, d_model)
LARGE_BLOCK = (960, 2560)        # SmolLM-360M MLP width, under 2**24 elements


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device=self.dev).manual_seed(0)
        self.errs = {"encode": 0.0, "fused": 0.0}
        self.enc_ratio = 0.0     # largest encode error / its tolerance
        self.checks = 0
        self.group = ""
        self.stats = {}     # (group, kernel, family) -> [checks, max err, bitwise]

    # ---- inputs ----

    def randn(self, *shape):
        return self.torch.randn(shape, generator=self.gen, device=self.dev)

    def seeds(self, n):
        return self.torch.randint(0, 1 << 32, (n,), generator=self.gen,
                                  device=self.dev, dtype=self.torch.int64)

    # ---- checks ----

    def check_encode(self, x, seeds, tag, lo, hi, family, masked, ro=0, co=0,
                     orig_cols=None, what=""):
        from repro_torch.kernels.seeded_projection import (
            encode_tolerance,
            project_blocks,
            project_blocks_plain,
        )
        torch = self.torch
        got = project_blocks(x, seeds, tag, lo, hi, family, masked, ro, co,
                             orig_cols)
        again = project_blocks(x, seeds, tag, lo, hi, family, masked, ro, co,
                               orig_cols)
        want = project_blocks_plain(x, seeds, tag, lo, hi, family, masked, ro,
                                    co, orig_cols, dtype=torch.float64)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"encode not deterministic: {what}")
        err = (got.double() - want).abs()
        ratio = float((err / encode_tolerance(x, family)).max())
        if not ratio <= 1.0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"encode disagrees: {what} max err "
                                 f"{float(err.max())}, {ratio} of its tolerance")
        self.enc_ratio = max(self.enc_ratio, ratio)
        self._record("encode", family, float(err.max()), False)

    def check_fused(self, x2d, seeds, rs, tag, scale, family, lo, hi, masked,
                    ro=0, co=0, orig_cols=None, what=""):
        from repro_torch.kernels.reconstruct_apply import (
            fused_apply_plain,
            fused_reconstruct_apply,
            pad_cohort,
        )
        torch = self.torch
        got = fused_reconstruct_apply(x2d, seeds, rs, tag, scale, family, lo=lo,
                                      hi=hi, masked=masked, row_offset=ro,
                                      col_offset=co, orig_cols=orig_cols)
        sp, rp = pad_cohort(seeds, rs * torch.tensor(scale, dtype=torch.float32,
                                                     device=self.dev))
        want = fused_apply_plain(x2d, sp, rp, tag, lo, hi, family, masked, ro,
                                 co, orig_cols)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if family in EXACT:
            ok = torch.equal(got, want)
        else:
            ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
        if not ok or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"fused disagrees: {what} max err {err}")
        self._record("fused", family, err, bool(torch.equal(got, want)))

    def _record(self, kernel, family, err, bitwise):
        self.errs[kernel] = max(self.errs[kernel], err)
        self.checks += 1
        st = self.stats.setdefault((self.group, kernel, family), [0, 0.0, True])
        st[0] += 1
        st[1] = max(st[1], err)
        st[2] = st[2] and bitwise

    def report(self):
        """One line per (kernel, family) of the current group."""
        for (group, kernel, family), (n, err, bitwise) in self.stats.items():
            if group == self.group:
                if kernel == "encode":
                    what = ("max |kernel - float64 plain| "
                            f"{err!r}, same bits on every rerun")
                else:
                    what = (f"max |kernel - plain| {err!r}, bitwise equal to "
                            f"plain: {bitwise}")
                print(f"kernels: {group}: {kernel} {family}: {n} checks, {what}")
        sys.stdout.flush()

    # ---- timing ----

    def time_ms(self, fn, reps=20, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps


def _bound_ms(nbytes, shapes, n, k):
    """Least time: bytes over HBM, or each op class over its own rate."""
    d = sum(r * c for r, c in shapes)
    rows = sum(r for r, _ in shapes)
    ops = {c: n * k * (ELEM_OPS[c] * d + ROW_OPS[c] * rows) for c in ELEM_OPS}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 1e3 * max(ops["int"] / INT32_OPS_PER_S, ops["imul"] / INT32_OPS_PER_S,
                      ops["fp"] / FP32_OPS_PER_S, sum(ops.values()) / ISSUE_PER_S)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _encode_bound(shapes, n, k):
    d = sum(r * c for r, c in shapes)
    return _bound_ms(4 * n * d + 4 * n * k * len(shapes), shapes, n, k)


def _fused_bound(shapes, n, k):
    d = sum(r * c for r, c in shapes)
    return _bound_ms(8 * d + len(shapes) * n * (4 + 4 * k), shapes, n, k)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    print(f"device: {name} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(smi_line, flush=True)
    return name, count, smi_line


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    results = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s wall for "
          f"{len(results)} sources, in parallel")
    for name, res in results.items():
        print(f"build: {name}: {res.seconds:.3f} s -> {res.path.name}")
        fn = None
        for line in res.log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spills = m.groups() if m else None
            if spills and fn:
                print(f"ptxas: {fn}: spill stores {spills[0]} B, loads {spills[1]} B")
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                print(f"ptxas: {fn}: {m.group(1)} registers")
    sys.stdout.flush()


def phase_kernels(s: Smoke):
    """Kernel against plain version at the main path's and the large shapes."""
    import torch

    from repro_torch.core.projection import ProjectionMode
    from repro_torch.kernels.ops import leaf_block_bounds

    t0 = time.perf_counter()
    mlp = [(1, 24), (1, 12), (1, 10), (64, 24), (24, 12), (12, 10)]
    total = sum(r * c for r, c in mlp)

    def bounds(offset, size, tot, k, mode):
        lo, hi = leaf_block_bounds(offset, size, tot, k, ProjectionMode(mode))
        return (torch.tensor(lo, dtype=torch.float32, device=s.dev),
                torch.tensor(hi, dtype=torch.float32, device=s.dev))

    # MLP leaves: every family, k ∈ {1, FULL 8, BLOCK 8}, cohorts 20 and 1000.
    s.group = "MLP leaves (k=1, FULL 8, BLOCK 8; N=20, 1000)"
    for family in FAMILIES:
        for k, mode in ((1, "full"), (8, "full"), (8, "block")):
            masked = mode == "block"
            for n in (20, 1000):
                offset = 0
                seeds = s.seeds(n)
                rs = s.randn(n, k)
                for tag, (rows, cols) in enumerate(mlp):
                    lo, hi = bounds(offset, rows * cols, total, k, mode)
                    what = f"mlp {family} k={k} {mode} n={n} leaf={rows}x{cols}"
                    s.check_encode(s.randn(n, rows, cols), seeds, tag, lo, hi,
                                   family, masked, what=what)
                    s.check_fused(s.randn(rows, cols), seeds, rs, tag, 1.0 / n,
                                  family, lo, hi, masked, what=what)
                    offset += rows * cols
    s.report()

    # Nonzero runtime row/col offsets (a shard of a wider leaf).
    s.group = "row/col offsets (300x700 of a 1000-col leaf, BLOCK 3)"
    for family in FAMILIES:
        lo = torch.tensor([0.0, 4e5, 9e5], device=s.dev)
        hi = torch.tensor([4e5, 9e5, 4e6], device=s.dev)
        s.check_encode(s.randn(20, 300, 700), s.seeds(20), 4, lo, hi, family,
                       True, 960, 33, 1000, what=f"offsets {family}")
        s.check_fused(s.randn(300, 700), s.seeds(1000), s.randn(1000, 3), 4,
                      0.001, family, lo, hi, True, 960, 33, 1000,
                      what=f"offsets {family}")
    s.report()

    # SmolLM-360M-sized leaves.
    s.group = f"large leaf {LARGE} (k=1, FULL 8; N=2 encode, 20/1000 close)"
    rows, cols = LARGE
    x = s.randn(2, rows, cols)
    for family in FAMILIES:
        for k in (1, 8):
            lo, hi = bounds(0, rows * cols, rows * cols, k, "full")
            what = f"large {family} k={k} full"
            s.check_encode(x, s.seeds(2), 9, lo, hi, family, False, what=what)
            s.check_fused(x[0], s.seeds(20), s.randn(20, k), 9, 0.05, family,
                          lo, hi, False, what=what + " n=20")
    lo, hi = bounds(0, rows * cols, rows * cols, 1, "full")
    s.check_fused(x[0], s.seeds(1000), s.randn(1000, 1), 9, 0.001, "rademacher",
                  lo, hi, False, what="large rademacher k=1 n=1000")
    del x
    s.report()
    s.group = f"block leaf {LARGE_BLOCK} (BLOCK 8; N=4 encode, 20/1000 close)"
    rows, cols = LARGE_BLOCK
    lo, hi = bounds(123_456, rows * cols, 3 * rows * cols, 8, "block")
    for family in FAMILIES:
        what = f"block-leaf {family} k=8 block"
        s.check_encode(s.randn(4, rows, cols), s.seeds(4), 5, lo, hi, family,
                       True, what=what)
        for n in (20, 1000):
            s.check_fused(s.randn(rows, cols), s.seeds(n), s.randn(n, 8), 5,
                          1.0 / n, family, lo, hi, True, what=f"{what} n={n}")
    s.report()
    torch.cuda.empty_cache()
    print(f"kernels: all {s.checks} checks ok in "
          f"{time.perf_counter() - t0:.1f} s; max |err| encode "
          f"{s.errs['encode']!r} (at most {s.enc_ratio!r} of its tolerance), "
          f"fused {s.errs['fused']!r}", flush=True)


def phase_main_path(s: Smoke):
    """run_simulation on the card; the kernels must carry it."""
    import numpy as np
    import torch

    from repro_torch.core import fedscalar as fs
    from repro_torch.data import load_digits, make_client_datasets
    from repro_torch.data import train_test_split_arrays
    from repro_torch.fed.simulation import (
        SimulationConfig,
        protocol_config,
        run_simulation,
    )
    from repro_torch.kernels.reconstruct_apply import fused_reconstruct_apply
    from repro_torch.kernels.seeded_projection import project_blocks
    from repro_torch.models.mlp_classifier import init_mlp, mlp_grad

    x, y = load_digits()
    xtr, ytr, xte, yte = train_test_split_arrays(x, y)
    clients = make_client_datasets(xtr, ytr, 20)
    launches = {"encode": 0, "fused": 0}
    for method in MAIN_METHODS:
        cfg = SimulationConfig(method=method, rounds=MAIN_ROUNDS, num_clients=20,
                               local_steps=5, batch_size=32, seed=0)
        params = init_mlp(seed=0, device="cuda")
        project_blocks.launches = 0
        fused_reconstruct_apply.launches = 0
        h = run_simulation(cfg, params, clients, xte, yte, device="cuda")
        enc, fus = project_blocks.launches, fused_reconstruct_apply.launches
        launches["encode"] += enc
        launches["fused"] += fus
        loss = h["loss"]
        if enc == 0 or fus == 0:
            raise AssertionError(f"{method}: kernels not launched ({enc}, {fus})")
        if not np.isfinite(loss).all() or not loss[-1] < loss[0]:
            raise AssertionError(f"{method}: loss did not fall: {loss[0]} -> {loss[-1]}")
        if not all(p.is_cuda for p in h["final_params"].values()):
            raise AssertionError(f"{method}: params left the card")
        steady = (MAIN_ROUNDS - 1) / h["sim_compute_seconds"]
        total_s = h["sim_compile_seconds"] + h["sim_compute_seconds"]
        print(f"main: {method}: {MAIN_ROUNDS} rounds, loss {float(loss[0])!r} -> "
              f"{float(loss[-1])!r}, final accuracy {float(h['accuracy'][-1])!r}, "
              f"{MAIN_ROUNDS / total_s!r} rounds/s overall, {steady!r} rounds/s "
              f"after round 1 (first round {h['sim_compile_seconds']!r} s), "
              f"launches encode={enc} fused={fus}", flush=True)

    # One round on the card against the same round on the CPU (plain path).
    g = torch.Generator().manual_seed(1)
    bx = (torch.rand((20, 5, 32, 64), generator=g) * 16).float()
    by = torch.randint(0, 10, (20, 5, 32), generator=g)
    for method in MAIN_METHODS:
        pc = protocol_config(SimulationConfig(method=method))
        p0 = init_mlp(seed=2, device="cpu")
        ef = None
        if pc.error_feedback:
            ef = {k: 1e-3 * torch.randn((20,) + tuple(v.shape), generator=g)
                  for k, v in p0.items()}
        cpu, (_, ef_c) = fs.fedscalar_round(p0, (bx, by), 3, mlp_grad, pc, ef)
        gpu, (_, ef_g) = fs.fedscalar_round(
            {k: v.cuda() for k, v in p0.items()}, (bx.cuda(), by.cuda()), 3,
            mlp_grad, pc, None if ef is None else {k: v.cuda() for k, v in ef.items()})
        err = max(float((gpu[k].cpu() - cpu[k]).abs().max()) for k in cpu)
        if ef is not None:
            err = max([err] + [float((ef_g[k].cpu() - ef_c[k]).abs().max())
                               for k in ef_c])
        if not err <= 1e-6:
            raise AssertionError(f"{method}: card round differs from CPU by {err}")
        print(f"main: {method}: one round, card vs CPU max |dparams|"
              f"{', |def|' if ef is not None else ''} {err!r}")
    return launches


def phase_times(s: Smoke):
    """CUDA-event times of each kernel, its plain version, and its bound."""
    import torch

    from repro_torch.kernels.reconstruct_apply import (
        fused_apply_plain,
        fused_reconstruct_apply,
        pad_cohort,
    )
    from repro_torch.kernels.seeded_projection import (
        project_blocks,
        project_blocks_plain,
    )

    mlp = [(1, 24), (1, 12), (1, 10), (64, 24), (24, 12), (12, 10)]
    n, k = 20, 1
    one = torch.ones(1, device=s.dev)
    zero = torch.zeros(1, device=s.dev)
    enc_args = [(s.randn(n, r, c), s.seeds(n), tag, zero, one * (r * c))
                for tag, (r, c) in enumerate(mlp)]
    seeds = s.seeds(n)
    rs = s.randn(n, k) * (1.0 / n)
    sp, rp = pad_cohort(seeds, rs)
    fus_args = [(s.randn(r, c), tag, one * 0, one * (r * c))
                for tag, (r, c) in enumerate(mlp)]

    def enc_kernel():
        for a in enc_args:
            project_blocks(*a)

    def enc_plain():
        for a in enc_args:
            project_blocks_plain(*a)

    def fus_kernel():
        for x2d, tag, lo, hi in fus_args:
            fused_reconstruct_apply(x2d, seeds, rs, tag, 1.0, lo=lo, hi=hi)

    def fus_plain():
        for x2d, tag, lo, hi in fus_args:
            fused_apply_plain(x2d, sp, rp, tag, lo, hi)

    # plain, kernel, kernel, plain: two turns each, on one card.
    t = {}
    for name, fn in (("enc_plain", enc_plain), ("enc_kernel", enc_kernel),
                     ("enc_kernel2", enc_kernel), ("enc_plain2", enc_plain),
                     ("fus_plain", fus_plain), ("fus_kernel", fus_kernel),
                     ("fus_kernel2", fus_kernel), ("fus_plain2", fus_plain)):
        t[name] = s.time_ms(fn, reps=50)
    enc_b, enc_by = _encode_bound(mlp, n, k)
    fus_b, fus_by = _fused_bound(mlp, n, k)
    print("times (main path, one round: 6 MLP leaves, N=20, k=1, rademacher): "
          + json.dumps(t), flush=True)

    rows = []
    r, c = LARGE
    x = s.randn(16, r, c)
    lo, hi = zero, one * (r * c)
    sd = s.seeds(16)
    ke = s.time_ms(lambda: project_blocks(x, sd, 9, lo, hi), reps=5, warmup=1)
    pe = s.time_ms(lambda: project_blocks_plain(x, sd, 9, lo, hi), reps=1,
                   warmup=0)
    b, by = _encode_bound([LARGE], 16, 1)
    rows.append(dict(kernel="encode", shape=list(LARGE), cohort=16, k=1,
                     ms=ke, plain_ms=pe, bound_ms=b, bound_by=by))
    x2d = x[0].contiguous()
    del x
    torch.cuda.empty_cache()
    for cohort in (256, 1024):
        sd = s.seeds(cohort)
        rsl = s.randn(cohort, 1) * (1.0 / cohort)
        spl, rpl = pad_cohort(sd, rsl)
        kf = s.time_ms(lambda: fused_reconstruct_apply(x2d, sd, rsl, 9, 1.0,
                                                       lo=lo, hi=hi),
                       reps=3, warmup=1)
        pf = s.time_ms(lambda: fused_apply_plain(x2d, spl, rpl, 9, lo, hi),
                       reps=1, warmup=0)
        b, by = _fused_bound([LARGE], cohort, 1)
        rows.append(dict(kernel="fused", shape=list(LARGE), cohort=cohort, k=1,
                         ms=kf, plain_ms=pf, bound_ms=b, bound_by=by))
    print("times (large leaf, rademacher): " + json.dumps({"rows": rows}),
          flush=True)
    return {
        "encode": dict(ms=(t["enc_kernel"] + t["enc_kernel2"]) / 2,
                       plain_ms=(t["enc_plain"] + t["enc_plain2"]) / 2,
                       bound_ms=enc_b, bound_by=enc_by),
        "fused": dict(ms=(t["fus_kernel"] + t["fus_kernel2"]) / 2,
                      plain_ms=(t["fus_plain"] + t["fus_plain2"]) / 2,
                      bound_ms=fus_b, bound_by=fus_by),
    }


def main() -> int:
    src = REPO / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing; run from a checkout of "
              "the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name, count, smi_line = phase_device(torch)
    phase_build()
    s = Smoke(torch)
    phase_kernels(s)
    launches = phase_main_path(s)
    times = phase_times(s)
    kernels = [
        dict(name="seeded_projection", route="cuda",
             source="src/repro_torch/kernels/csrc/seeded_projection.cu",
             replaces="src/repro/kernels/seeded_projection.py:57",
             launches=launches["encode"], max_abs_err=s.errs["encode"],
             library_ms=None, **times["encode"]),
        dict(name="reconstruct_apply", route="cuda",
             source="src/repro_torch/kernels/csrc/reconstruct_apply.cu",
             replaces="src/repro/kernels/reconstruct_apply.py:134",
             launches=launches["fused"], max_abs_err=s.errs["fused"],
             library_ms=None, **times["fused"]),
    ]
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
