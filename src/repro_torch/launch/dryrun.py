"""Dry run on the ``meta`` device: every (arch × shape × mesh), nothing allocated.

Port of ``repro/launch/dryrun.py``, whose TPU dry run lowers and compiles
each step for a 256- or 512-chip mesh.  Here each step runs as it runs on
the card, eagerly, on ``meta`` tensors (shapes and dtypes, no storage):

  1. ``Arch.param_shapes()`` and ``Arch.input_specs(shape)`` build the
     params and inputs on ``meta``;
  2. the real step runs on them: ``launch/train.py``'s ``make_train_step``
     (N = 4 clients, S = 2 local steps, as the reference's dry run) or
     ``make_train_step_client_parallel`` (``--variant client_parallel``,
     N = pod × data, a client a data row, as the reference's),
     ``make_prefill_step`` or ``make_decode_step``.  The reference's other
     variants: ``dp256`` (``make_train_step(dp_axes=("pod", "data",
     "model"))`` under ``batch_mode("dp256")``; its FLOPs divided over every
     device the global batch reaches), ``tp`` (weights over ``model``
     alone in the per-device bytes and the roofline) and ``cf1`` (the
     config at MoE capacity factor 1.0, in every mode).  Every kernel wrapper
     on the path takes its ``meta`` route: the launch plan is built as on
     the card (a plan that the card would refuse fails the dry run) and
     exactly the kernel's outputs and scratch are allocated;
  3. a ``TorchDispatchMode`` (:class:`LiveBytes`) follows the storages of
     the live tensors the step makes, and
     ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of the
     matrix products and attention (Python loops run every layer);
  4. per mesh, the argument bytes each device holds under the sharding
     rules (``sharding/rules.py``) and the roofline's three terms
     (``launch/roofline.py``) are recorded into
     ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

The peak is measured for the one-card mesh (``one_card``, (1, 1)): what a
single H100 holds, which ``chip_smoke.py`` checks against
``torch.cuda.max_memory_allocated``.  For the reference's meshes
(``pod16x16``, ``pod2x16x16``) one process cannot run a device's share,
so those records hold the per-device argument and output bytes from the
specs and the roofline; their collectives are modelled only, by the
roofline, as one-card records say too.  A decode step's cache bytes there
are ``input_specs_sharding``'s estimate, as the reference's, which also
shards each cache's ``head_dim`` over ``model``; the port's serve on a
mesh (``models/api.py``) keeps each data row's caches whole on the row's
device, so on a real mesh it holds more cache a device than the estimate.

``--fit`` takes the same figures from cheaper runs (:func:`measure_fit`:
two and three periods of depth, extended linearly; one client's one
local step of the sequential train step), for a sweep that must end sooner
than the Python loops over every layer, client and Mamba chunk on
``meta`` allow (Falcon-Mamba-7B's ``train_4k`` takes tens of minutes).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every combo
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod2x16x16
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.launch.mesh import PRODUCTION_MESHES, make_production_mesh
from repro_torch.launch.roofline import FL_CLIENTS, FL_STEPS, MESHES, analytic_terms
from repro_torch.launch.serve import make_decode_step, make_prefill_step
from repro_torch.launch.train import (
    FLRunConfig,
    make_train_step,
    make_train_step_client_parallel,
)
from repro_torch.models.api import INPUT_SHAPES, Arch
from repro_torch.models.lm import period_structure
from repro_torch.sharding.activations import batch_mode
from repro_torch.sharding.rules import (
    input_specs_sharding,
    param_specs,
    per_device_bytes,
    tree_paths,
)

__all__ = ["OUTDIR", "H100_BYTES", "LiveBytes", "measure_step", "measure_fit",
           "run_combo", "main"]

OUTDIR = "experiments/dryrun_torch"
# An H100 80GB HBM3's memory as the card reports it
# (torch.cuda.get_device_properties(0).total_memory, 79.18 GiB), the
# capacity "fits" is judged against; chip_smoke.py passes the card's own.
H100_BYTES = 85_017_493_504
# measure_fit's two depths, in periods
FIT_PERIODS = (2, 3)
# The reference's five variants (repro/launch/dryrun.py): the baseline;
# dp256, the train batch over every mesh axis; client_parallel, a client a
# data row; tp, weights over the model axis alone; cf1, MoE capacity 1.0.
VARIANTS = ("baseline", "dp256", "client_parallel", "tp", "cf1")
DP256_AXES = ("pod", "data", "model")


def _storages(tree) -> dict:
    """{storage key: bytes} of the tensors of ``tree``."""
    out = {}
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            st = leaf.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive while the mode is on, and their peak.

    What is alive before (the step's arguments) is registered by
    :meth:`hold`; every storage an op returns that is not yet known adds
    its bytes, and gives them back when the last tensor on it is freed.
    Views and in-place results share a storage and add nothing.  What a
    kernel allocates below the dispatcher (a workspace, a copy it makes
    itself) is not seen.
    """

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._known: set = set()

    def hold(self, tree) -> int:
        """Count ``tree``'s storages as alive (the caller keeps them)."""
        added = 0
        for key, nbytes in _storages(tree).items():
            if key not in self._known:
                self._known.add(key)
                added += nbytes
        self.live += added
        self.peak = max(self.peak, self.live)
        return added

    def _free(self, key, nbytes):
        self._known.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for leaf in tree_flatten(out)[0]:
            if isinstance(leaf, torch.Tensor):
                st = leaf.untyped_storage()
                key = st._cdata
                if key not in self._known:
                    self._known.add(key)
                    nbytes = st.nbytes()
                    self.live += nbytes
                    weakref.finalize(st, self._free, key, nbytes)
        self.peak = max(self.peak, self.live)
        return out


def _cut(arch: Arch, periods: int | None) -> Arch:
    """``arch`` at ``periods`` periods of its depth (None: as it is)."""
    if periods is None:
        return arch
    plen, _, _ = period_structure(arch.cfg)
    return Arch(dataclasses.replace(arch.cfg, num_layers=plen * periods))


def _build(arch: Arch, shape_name: str, variant: str, global_batch: int | None,
           clients: int, local_steps: int):
    """→ (step, args, global batch) for one combination, on ``meta``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: want one of {VARIANTS}")
    if variant == "cf1":
        # the reference's MoE iteration: capacity factor 1.25 → 1.0
        arch = Arch(dataclasses.replace(arch.cfg, capacity_factor=1.0))
    seq, gb, mode = INPUT_SHAPES[shape_name]
    gb = gb if global_batch is None else global_batch
    specs = arch.input_specs(shape_name, gb)
    params = arch.param_shapes()
    if mode == "train":
        fl = FLRunConfig(num_virtual_clients=clients, local_steps=local_steps)
        if variant == "client_parallel":
            step = make_train_step_client_parallel(arch, fl)
        else:
            step = make_train_step(arch, fl, dp_axes=DP256_AXES if variant == "dp256"
                                   else ("data",))
        return step, (params, specs["batch"], 0), gb
    if mode == "prefill":
        return make_prefill_step(arch, capacity=seq), (params, specs["batch"]), gb
    step = make_decode_step(arch, window=arch.serve_window(shape_name))
    return step, (params, specs["token"], specs["caches"], seq - 1), gb


def measure_step(arch: Arch, shape_name: str, variant: str = "baseline",
                 global_batch: int | None = None, clients: int = FL_CLIENTS,
                 local_steps: int = FL_STEPS) -> dict:
    """Run one step on ``meta`` → {argument, output, alias and peak bytes,
    FLOPs, seconds, the step's outputs}; everything for the whole step on
    one device."""
    t0 = time.perf_counter()
    step, args, gb = _build(arch, shape_name, variant, global_batch, clients,
                            local_steps)
    mode = INPUT_SHAPES[shape_name][2]
    live = LiveBytes()
    argument = live.hold(args)
    flops = FlopCounterMode(display=False)
    # the reference's run_one lowers dp256 under batch_mode("dp256")
    mode_ctx = batch_mode("dp256") if variant == "dp256" else contextlib.nullcontext()
    with flops, live, mode_ctx:
        if mode == "train":
            out = step(*args)
        else:
            with torch.no_grad():
                out = step(*args)
    inputs = _storages(args)
    outs = _storages(out)
    alias = sum(b for k, b in outs.items() if k in inputs)
    return {"argument_bytes": argument,
            "output_bytes": sum(b for k, b in outs.items() if k not in inputs),
            "alias_bytes": alias, "peak_bytes": live.peak,
            "flops": float(flops.get_total_flops()),
            "global_batch": gb, "seconds": time.perf_counter() - t0, "out": out}


def measure_fit(arch: Arch, shape_name: str, variant: str = "baseline",
                global_batch: int | None = None, clients: int = FL_CLIENTS,
                local_steps: int = FL_STEPS) -> dict:
    """:func:`measure_step`'s figures from cheaper runs (``--fit``).

    Depth: the step at two and at three periods of the config's depth,
    every width kept, extended linearly to its periods (each period after
    the first adds the same parameters, caches, activations and products;
    the first can differ: Falcon-Mamba-7B's prefill peaks 25 GiB higher at
    two periods than at one, and 0.2 GiB higher at three than at two; the
    enc-dec runs whole).
    Clients: the sequential train step (every variant but
    ``client_parallel``) runs its clients' local steps one after another
    and keeps one client's state at a time, so its peak is one local
    step's; it runs one client's one step (N = S = 1 at the same per-step
    batch) and its FLOPs count N·S times.
    """
    seq, gb, mode = INPUT_SHAPES[shape_name]
    gb = gb if global_batch is None else global_batch
    steps = 1
    kw = dict(variant=variant, global_batch=gb, clients=clients,
              local_steps=local_steps)
    if mode == "train" and variant != "client_parallel":
        steps = clients * local_steps
        kw.update(global_batch=gb // steps, clients=1, local_steps=1)
    _, nper, _ = period_structure(arch.cfg)
    if arch.cfg.encoder_layers or nper <= FIT_PERIODS[1]:
        m = measure_step(arch, shape_name, **kw)
    else:
        p0, p1 = FIT_PERIODS
        a = measure_step(_cut(arch, p0), shape_name, **kw)
        b = measure_step(_cut(arch, p1), shape_name, **kw)
        m = dict(a)
        for key in ("argument_bytes", "output_bytes", "alias_bytes", "peak_bytes",
                    "flops"):
            m[key] = a[key] + (nper - p0) * (b[key] - a[key]) // (p1 - p0)
        m["seconds"] = a["seconds"] + b["seconds"]
    if steps > 1:
        # the whole batch is an argument; one step's share was measured
        extra = sum(x.numel() * x.element_size() for _, x in
                    tree_paths(arch.input_specs(shape_name, gb)["batch"]))
        extra -= extra // steps
        for key in ("argument_bytes", "peak_bytes"):
            m[key] += extra
    m["flops"] *= steps
    m["global_batch"] = gb
    m["fit"] = True
    return m


def run_combo(arch_name: str, shape_name: str, meshes=("one_card",),
              variant: str = "baseline", global_batch: int | None = None,
              clients: int = FL_CLIENTS, local_steps: int = FL_STEPS,
              fit: bool = False, capacity: int = H100_BYTES,
              save: bool = True, outdir: str = OUTDIR) -> list:
    """The meta step of one (arch, shape) once, recorded for each mesh;
    ``client_parallel`` once for each cohort its meshes give (N = pod ×
    data, as the reference's)."""
    arch = get_arch(arch_name)
    measured = {}
    records = []
    for mesh_name in meshes:
        n = cohort(mesh_name, variant, clients)
        if n not in measured:
            measured[n] = (measure_fit if fit else measure_step)(
                arch, shape_name, variant=variant, global_batch=global_batch,
                clients=n, local_steps=local_steps)
        records.append(_record(arch, arch_name, shape_name, mesh_name, variant,
                               measured[n], capacity, n, local_steps))
        if save:
            os.makedirs(outdir, exist_ok=True)
            tag = f"{arch_name}__{shape_name}__{mesh_name}"
            if variant != "baseline":
                tag += f"__{variant}"
            with open(os.path.join(outdir, tag + ".json"), "w") as f:
                json.dump(records[-1], f, indent=1)
    return records


def cohort(mesh_name: str, variant: str, clients: int = FL_CLIENTS) -> int:
    """The round's N on ``mesh_name``: ``clients``, or for
    ``client_parallel`` a client a data row, pod × data (the reference's
    ``dryrun.py``)."""
    if variant != "client_parallel":
        return clients
    return MESHES[mesh_name]["pod"] * MESHES[mesh_name]["data"]


def _record(arch: Arch, arch_name: str, shape_name: str, mesh_name: str,
            variant: str, m: dict, capacity: int, clients: int,
            local_steps: int) -> dict:
    one = mesh_name == "one_card"
    gb = m["global_batch"]
    # the parameters' layout: the client-parallel replicas lie in the tp
    # layout, a replica a data row
    layout = "tp" if variant in ("tp", "client_parallel") else "zero3"
    if one:
        argument, output = m["argument_bytes"], m["output_bytes"]
    else:
        mesh = make_production_mesh(multi_pod=mesh_name == "pod2x16x16")
        specs = arch.input_specs(shape_name, gb)
        pshapes = arch.param_shapes()
        pspec = param_specs(pshapes, mesh, num_experts=arch.cfg.num_experts,
                            layout=layout)
        argument = per_device_bytes(pshapes, pspec, mesh)
        for key, tree in specs.items():
            if isinstance(tree, torch.Tensor) and tree.dim() == 0:
                argument += tree.element_size()
                continue
            argument += per_device_bytes(tree, input_specs_sharding(tree, mesh, gb),
                                         mesh)
        output = None
    roof = analytic_terms(arch_name, shape_name, mesh_name,
                          "tp" if variant == "tp" else "zero3", global_batch=gb,
                          clients=clients, local_steps=local_steps)
    sizes = MESHES[mesh_name]
    n_dev = sizes["pod"] * sizes["data"] * sizes["model"]
    # the roofline's compute shards: the batch over (pod, data), the model
    # axis too under tp, and the batch over all three under dp256 (the
    # reference's "removes the model-axis compute replication"); never
    # more shards than the global batch has rows
    if variant == "dp256":
        shards = max(1, min(n_dev, gb))
    else:
        shards = max(1, min(sizes["pod"] * sizes["data"], gb)) * (
            sizes["model"] if variant == "tp" else 1)
    peak = m["peak_bytes"] if one else None
    extra = {}
    if variant == "dp256":
        extra["layout_note"] = ("the reference's roofline has no dp256 layout: "
                                "its zero3 terms")
    return {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_name,
        "variant": variant, "layout": layout, **extra,
        "clients": clients, "num_devices": n_dev, "ok": True,
        "global_batch": gb, "meta_s": m["seconds"],
        "fit": bool(m.get("fit")),
        "per_device": {
            "argument_bytes": argument,
            "output_bytes": output,
            "alias_bytes": m["alias_bytes"] if one else None,
            "peak_bytes_est": peak,
            "flops": m["flops"] / shards,
            "flops_step": m["flops"],
            "fits": None if peak is None else peak <= capacity,
            "capacity_bytes": capacity,
        },
        "roofline": roof,
        "collectives": "modelled only (launch/roofline.py); one process runs "
                       "no collective",
    }


def _worker_init():
    torch.set_num_threads(1)       # meta ops compute nothing; leave the cores


def _sweep_one(job):
    """One (arch, shape) of a sweep: → (job, records, None) or (job, None,
    the error)."""
    a, s, kw = job
    try:
        return job, run_combo(a, s, **kw), None
    except Exception as e:  # record the failure; keep sweeping
        return job, None, str(e)[:300]


def _print(recs):
    for r in recs:
        pd = r["per_device"]
        peak = ("" if pd["peak_bytes_est"] is None else
                f" peak={pd['peak_bytes_est'] / 2**30:.2f}GiB"
                f" fits={pd['fits']}")
        print(f"[ok] {r['arch']}__{r['shape']}__{r['mesh']}: meta={r['meta_s']:.1f}s "
              f"args/dev={pd['argument_bytes'] / 2**30:.3f}GiB{peak} "
              f"bound={r['roofline']['bound_s']:.3g}s "
              f"({r['roofline']['dominant']})", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=None, choices=list(PRODUCTION_MESHES),
                    help="one mesh (default: all three)")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--fit", action="store_true",
                    help="measure_fit: two and three periods, one client step")
    ap.add_argument("--capacity-bytes", type=int, default=H100_BYTES,
                    help="the card's memory, for 'fits' (default: an H100's)")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes over the (arch, shape) pairs")
    ap.add_argument("--outdir", default=OUTDIR)
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("pass --all or --arch/--shape")
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [args.mesh] if args.mesh else list(PRODUCTION_MESHES)
    kw = dict(meshes=meshes, variant=args.variant, fit=args.fit,
              capacity=args.capacity_bytes, outdir=args.outdir)
    jobs = [(a, s, kw) for a in archs for s in shapes]
    failures = []
    if args.workers > 1:
        import concurrent.futures
        import multiprocessing

        with concurrent.futures.ProcessPoolExecutor(
                args.workers, mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init) as pool:
            results = pool.map(_sweep_one, jobs)
            for (a, s, _), recs, err in results:
                if err is None:
                    _print(recs)
                else:
                    failures.append((a, s))
                    print(f"[FAIL] {a}__{s}: {err}", flush=True)
    else:
        for job in jobs:
            (a, s, _), recs, err = _sweep_one(job)
            if err is None:
                _print(recs)
            else:
                failures.append((a, s))
                print(f"[FAIL] {a}__{s}: {err}", flush=True)
    if failures:
        print(f"\n{len(failures)} failures: {failures}")
        raise SystemExit(1)
    print("\nall combinations ran on meta")


if __name__ == "__main__":
    main()
