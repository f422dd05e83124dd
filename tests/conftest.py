import os
import sys

# Pin the host-platform device count BEFORE jax initializes, so the
# mesh-sharding tests see a mesh-capable backend even on single-device
# CI runners / bare `pytest` invocations (test.sh exports the same
# flag; an explicit user-provided count wins).  Without this the
# sharded-path tests would silently skip exactly where they matter.
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=8 "
        + os.environ.get("XLA_FLAGS", "")).strip()

# Dtype-bits hygiene: the kernel-conformance suites assert *bitwise*
# equality of float32 streams, which an ambient x64 default (or a
# user's JAX_DEFAULT_DTYPE_BITS) would silently change — weak-typed
# Python scalars would promote to f64 in the oracles but not inside
# the Pallas kernels.  Pin both before jax initializes; an explicit
# user-exported value wins (setdefault), matching the XLA_FLAGS pin
# above and test.sh.
os.environ.setdefault("JAX_ENABLE_X64", "0")
os.environ.setdefault("JAX_DEFAULT_DTYPE_BITS", "32")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running end-to-end tests (subprocess / many rounds)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (PyTorch/CUDA port); skips without one")


@pytest.fixture(scope="session")
def fed_mesh():
    """Session-scoped 8-device (data=2, model=4) mesh for sharding tests."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices — XLA_FLAGS device-count pin was overridden")
    from repro.launch.mesh import make_fed_mesh
    return make_fed_mesh((2, 4))


@pytest.fixture(scope="session")
def fed_mesh_single():
    """Session-scoped (1, 1) mesh — the bit-identity anchor layout."""
    from repro.launch.mesh import make_fed_mesh
    return make_fed_mesh((1, 1))
