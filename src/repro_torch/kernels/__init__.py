"""Hand-written Hopper kernels for the FedScalar round, with their plain versions.

* :mod:`seeded_projection` — client encode ``r = ⟨δ, v(ξ)⟩`` for a whole
  cohort per leaf (``csrc/seeded_projection.cu``).
* :mod:`reconstruct_apply` — fused server close ``y = x + Σ r·v``
  (``csrc/reconstruct_apply.cu``).
* :mod:`common` — the direction chain in plain torch (``csrc/chain.cuh``
  is its CUDA twin) and the wrappers' checks.
* :mod:`ops` — parameter trees → per-leaf kernel calls.
* :mod:`ref` — plain-torch oracles.
* :mod:`_build` — nvcc build and ctypes load, on first use.

Import nothing CUDA-specific at module import: a kernel is built and
loaded only when a CUDA tensor first reaches its wrapper.
"""
