"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false.  The file imports no jax, so it also runs on a machine that has
only PyTorch::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the fused close is bitwise equal to its plain version for
the ±1/±2 families, and within rtol/atol 1e-5 for gaussian (the
kernel's logf/cosf against torch's).  The encode's sum order differs
from the plain version's: it is held against the plain version summed
in float64, within ``encode_tolerance`` (4·2⁻²³·√h·‖x‖₂·max|v|, h the
depth of the kernel's float32 sum); and the kernel gives the same bits
on every run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.prng import Distribution  # noqa: E402
from repro_torch.core.projection import ProjectionMode  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.reconstruct_apply import (  # noqa: E402
    fused_apply_plain,
    fused_reconstruct_apply,
    pad_cohort,
)
from repro_torch.kernels.seeded_projection import (  # noqa: E402
    encode_tolerance,
    project_blocks,
    project_blocks_plain,
)
from repro_torch.models.mlp_classifier import init_mlp  # noqa: E402
from torch_parity import cuda_device, seeds_np  # noqa: E402,F401

pytestmark = pytest.mark.cuda

FAMILIES = ["rademacher", "gaussian", "sparse_rademacher", "hadamard"]
MODES = [(1, "full"), (8, "full"), (8, "block")]


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.1 * torch.randn(v.shape, generator=g)
            for k, v in init_mlp(seed=seed, device="cpu").items()}


def _assert_fused(family, got, want):
    if family == "gaussian":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", MODES)
def test_cuda_encode_matches_plain(cuda_device, family, k, mode):
    rng = np.random.RandomState(k)
    masked = mode == "block" and k > 1
    p = _params()
    total = sum(v.numel() for v in p.values())
    offset = 0
    for tag, key in enumerate(sorted(p)):
        shape = tuple(p[key].shape)
        rows, cols = (1, shape[0]) if len(shape) == 1 else shape
        x = torch.from_numpy(rng.randn(20, rows, cols).astype(np.float32))
        seeds = torch.from_numpy(seeds_np(rng, 20).astype(np.int64))
        lo, hi = (torch.tensor(b, dtype=torch.float32) for b in
                  ops.leaf_block_bounds(offset, rows * cols, total, k,
                                        ProjectionMode(mode)))
        want = project_blocks_plain(x, seeds, tag, lo, hi, family, masked,
                                    dtype=torch.float64)
        dev = [t.to(cuda_device) for t in (x, seeds, lo, hi)]
        got = project_blocks(*dev[:2], tag, *dev[2:], family, masked)
        again = project_blocks(*dev[:2], tag, *dev[2:], family, masked)
        torch.testing.assert_close(got, again, rtol=0, atol=0)
        assert ((got.cpu().double() - want).abs()
                <= encode_tolerance(x, family)).all()
        offset += rows * cols


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("k,mode", MODES)
@pytest.mark.parametrize("n", [20, 1000])
def test_cuda_fused_matches_plain(cuda_device, family, k, mode, n):
    rng = np.random.RandomState(n + k)
    p = _params(1)
    rs = torch.from_numpy(rng.randn(n, k).astype(np.float32))
    seeds = torch.from_numpy(seeds_np(rng, n).astype(np.int64))
    dist = Distribution(family)
    want = ops.server_update_fused(p, rs, seeds, 1.0, dist,
                                   mode=ProjectionMode(mode))
    got = ops.server_update_fused(
        {key: v.to(cuda_device) for key, v in p.items()}, rs.to(cuda_device),
        seeds.to(cuda_device), 1.0, dist, mode=ProjectionMode(mode))
    for key in p:
        _assert_fused(family, got[key].cpu(), want[key])


@pytest.mark.parametrize("family", FAMILIES)
def test_cuda_fused_offsets_match_plain(cuda_device, family):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(37, 300).astype(np.float32))
    rs = torch.from_numpy(rng.randn(21, 3).astype(np.float32))
    seeds = torch.from_numpy(seeds_np(rng, 21).astype(np.int64))
    lo = torch.tensor([0.0, 5000.0, 9000.0])
    hi = torch.tensor([5000.0, 9000.0, 20000.0])
    sp, rp = pad_cohort(seeds, rs * torch.tensor(0.5))
    want = fused_apply_plain(x, sp, rp, 2, lo, hi, family, True, 40, 9, 310)
    got = fused_reconstruct_apply(
        x.to(cuda_device), seeds.to(cuda_device), rs.to(cuda_device), 2, 0.5,
        family, lo=lo.to(cuda_device), hi=hi.to(cuda_device), masked=True,
        row_offset=40, col_offset=9, orig_cols=310)
    _assert_fused(family, got.cpu(), want)


def test_cuda_wrappers_check_inputs(cuda_device):
    x = torch.zeros((2, 4, 8), device=cuda_device)
    seeds = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    lo = torch.zeros(1, device=cuda_device)
    hi = torch.ones(1, device=cuda_device)
    with pytest.raises(TypeError):
        project_blocks(x.double(), seeds, 0, lo, hi)
    with pytest.raises(ValueError):
        project_blocks(x.transpose(1, 2), seeds, 0, lo, hi)
    with pytest.raises(ValueError):
        project_blocks(x, seeds[:1], 0, lo, hi)
    with pytest.raises(TypeError):
        fused_reconstruct_apply(x[0].double(), seeds, torch.ones(2, device=cuda_device),
                                0, 1.0)
