#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last line.

    python3 fedbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file (``fedbench/configs/<config>.json``), its traffic
file (``fedbench/traffic/<traffic>.json``, which names its driver,
``fedbench/drivers/<driver>.py``), its correctness limits
(``fedbench/limits/<cell>.json``) and, with ``--trace 1``, a reader per
per-layer metric (``fedbench/metrics/<metric>.py``).  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics from a ``torch.profiler`` trace of the window.

The run needs as many CUDA cards as the cell asks for and exits 2
without a result when they are missing; it exits 3 without a result if
the JAX package or JAX itself was loaded.  The last lines on standard
error, and the last key of the result, give each number the run
compared beside its limit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".fedbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules=None) -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(manifest: dict, name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic and limits files read."""
    wl = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in manifest["configs"] if c["name"] == wl["config"])
    bench = root / "fedbench"
    traffic = json.loads((bench / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{name}.json").read_text())
    return {"workload": wl, "config": json.loads((root / cfg["file"]).read_text()),
            "traffic": traffic, "limits": limits,
            "driver": bench / "drivers" / f"{traffic['driver']}.py"}


def cell_metrics(manifest: dict, name: str, trace: bool) -> list:
    """The metric entries this cell reports in a run with or without ``--trace``."""
    def listed(m):
        return "workloads" not in m or name in m["workloads"]
    e2e = [m for m in manifest["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (listed(m) if "workloads" in m else m["moves"] in moved)]


def _load_file(path: Path):
    spec = importlib.util.spec_from_file_location(
        "fedbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             root: Path = ROOT, t_start: float = T_START) -> dict:
    """One run of cell ``name`` → the result object (without printing it)."""
    import torch

    from fedbench.harness import Run

    manifest = load_manifest(root)
    cell = resolve(manifest, name, root)
    dev = torch.device(device or "cuda")
    run = Run(config=cell["config"], traffic=cell["traffic"], seed=seed, seconds=seconds,
              trace=trace, device=dev, t_start=t_start)
    out = _load_file(cell["driver"]).run(run)
    print(f"set-up stages: {run.stages()}", file=sys.stderr)

    metrics = {}
    for m in cell_metrics(manifest, name, trace):
        if trace:
            value = _load_file(root / "fedbench" / "metrics" / f"{m['name']}.py").read(
                run.traced, out["counters"])
        else:
            value = out["e2e"][m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    limits = cell["limits"]["checks"]
    checks = {k: {"value": float(v), "limit": limits.get(k)} for k, v in out["checks"].items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell["workload"]["chips"]),
                   "memory_peak_bytes": int(run.peak_bytes or 0)}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = run.traced.busy_s()
        device_info["window_s"] = run.traced.window_s
        result["breakdown"] = run.traced.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Build and kernel caches at fixed paths inside the checkout.
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    manifest = load_manifest()
    chips = next((w["chips"] for w in manifest["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))

    found = loaded_forbidden()
    if found:
        print(f"loaded after the window: {', '.join(found)} (the benchmark runs "
              "the PyTorch port alone)", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
