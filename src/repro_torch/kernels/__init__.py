"""Hand-written Hopper kernels of the port, with their plain versions.

* :mod:`seeded_projection` — client encode ``r = ⟨δ, v(ξ)⟩`` for a whole
  cohort, one launch per tree (``csrc/seeded_projection.cu``).
* :mod:`reconstruct_apply` — fused server close ``y = x + Σ r·v``, one
  launch per tree (``csrc/reconstruct_apply.cu``).
* :mod:`seeded_reconstruct` — per-client server decode, the federation
  runtime's large-cohort apply and digest replay
  (``csrc/seeded_reconstruct.cu``).
* :mod:`qsgd_quant` — QSGD quantize→dequantize for a cohort, one leaf
  per call (``csrc/qsgd_quant.cu``).
* :mod:`flash_attention` — causal flash attention, forward, for the LLM
  serving path's long prefills and decodes: bf16 prefill on the tensor
  cores (``csrc/flash_prefill.cu``), split-KV decode
  (``csrc/flash_decode.cu``), float32 on the CUDA cores
  (``csrc/flash_attention.cu``).
* :mod:`common` — the direction chain in plain torch (``csrc/chain.cuh``
  is its CUDA twin) and the wrappers' checks.
* :mod:`tree` — the leaf table a tree launch carries (``csrc/tree.cuh``)
  and the cached per-layout launch plans.
* :mod:`ops` — parameter trees → tree launches (the per-client decode
  and QSGD: per-leaf launches).
* :mod:`ref` — plain-torch oracles.
* :mod:`_build` — nvcc build and ctypes load, on first use.

Import nothing CUDA-specific at module import: a kernel is built and
loaded only when a CUDA tensor first reaches its wrapper.
"""
