"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use by its own ``nvcc``
process (all sources at once, in parallel) into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -Xptxas -v -shared -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

``-fmad=false`` is part of the numeric spec of the fused close, the
per-client decode and the QSGD round trip: no mul+add pair may be
contracted into an FMA.  Flash attention (four sources: the float32
kernel and its backward, the bf16 tensor-core prefill and the split-KV
decode) needs only a tolerance; it writes its FMAs as ``fmaf``, which
the flag leaves alone.  The prefill looks up libcuda's ``cuTensorMapEncodeTiled`` at
run time through the CUDA runtime, so no source links ``-lcuda``.  Division and
``expf`` stay IEEE (never ``--use_fast_math``).
The library name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale one is never loaded.  Libraries land in
``kernels/build/`` beside this file (git-ignored), written under a
temporary name and renamed into place so concurrent builders never load
a half-written file.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "NVCC_FLAGS", "BuildResult",
           "build_all", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("seeded_projection", "reconstruct_apply", "seeded_reconstruct",
           "qsgd_quant", "flash_attention", "flash_attention_bwd", "flash_prefill",
           "flash_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float      # 0.0 when an up-to-date library was already on disk
    log: str            # nvcc's output, including ptxas's register report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh") and (src.suffix == ".cuh"
                                              or src.stem == name):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, BuildResult]:
    """Compile every source that is not built yet, in parallel; → results."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        results: dict[str, BuildResult] = {}
        procs = {}
        t0 = time.perf_counter()
        for name in SOURCES:
            target = _target(name)
            if target.exists():
                results[name] = BuildResult(name, target, 0.0, "")
                continue
            tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (target, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (target, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, target)
            results[name] = BuildResult(name, target,
                                        time.perf_counter() - t0, log)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return results


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all()[name].path
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib
