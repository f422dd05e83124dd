"""The port stands alone: importing it, chip_smoke.py and the port's examples loads no jax, no ``repro``, and neither ``msgpack`` nor ``ml_dtypes`` (the card's machine has neither).

Checked in a fresh subprocess, so this test process's own jax import
cannot mask a leak.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent

_CODE = r"""
import glob, importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
for path in ["chip_smoke.py", *sorted(glob.glob("examples/*_torch.py"))]:
    spec = importlib.util.spec_from_file_location(path.replace("/", "_")[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                or m.startswith("jaxlib.") or m == "repro"
                or m.startswith("repro.") or m.split(".")[0] in ("msgpack", "ml_dtypes"))
print(json.dumps({"modules": names, "leaked": leaked,
                  "scripts": sorted(glob.glob("examples/*_torch.py"))}))
"""


def test_port_imports_neither_jax_nor_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _CODE], cwd=REPO, capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["leaked"] == []
    assert {"examples/federated_llm_torch.py",
            "examples/centralized_baseline_torch.py",
            "examples/quickstart_torch.py", "examples/baseline_tradeoff_torch.py",
            "examples/downlink_tradeoff_torch.py"} <= set(out["scripts"])
    for mod in ("repro_torch.core.prng", "repro_torch.kernels.ops",
                "repro_torch.kernels.seeded_projection",
                "repro_torch.kernels.reconstruct_apply",
                "repro_torch.kernels.seeded_reconstruct",
                "repro_torch.kernels.qsgd_quant",
                "repro_torch.core.fedavg", "repro_torch.core.qsgd",
                "repro_torch.fed.protocols", "repro_torch.fed.baselines",
                "repro_torch.fed.runtime.engine",
                "repro_torch.fed.runtime.scheduler",
                "repro_torch.configs.paper_mlp",
                "repro_torch.fed.runtime.sampling",
                "repro_torch.fed.runtime.server",
                "repro_torch.fed.runtime.transport",
                "repro_torch.fed.simulation", "repro_torch.convert",
                "repro_torch.models.config", "repro_torch.models.layers",
                "repro_torch.models.mlp", "repro_torch.models.attention",
                "repro_torch.models.lm", "repro_torch.models.api",
                "repro_torch.kernels.flash_attention",
                "repro_torch.launch.serve", "repro_torch.configs.registry",
                "repro_torch.launch.train", "repro_torch.optim",
                "repro_torch.optim.adam", "repro_torch.optim.sgd",
                "repro_torch.optim.schedule", "repro_torch.checkpoint",
                "repro_torch.checkpoint.msgpack_ckpt",
                "repro_torch.checkpoint.msgpack_codec",
                "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
                "repro_torch.launch.mesh", "repro_torch.sharding.rules",
                "repro_torch.sharding.activations"):
        assert mod in out["modules"]
