"""PyTorch/CUDA port of the FedScalar system (``repro`` is the reference).

The layout mirrors :mod:`repro`: ``repro_torch/core/prng.py`` is the
counterpart of ``repro/core/prng.py`` and so on.  The package imports
``torch`` and numpy only, never ``jax`` and nothing of ``repro``.

Entry points (:func:`repro_torch.models.mlp_classifier.init_mlp`,
:func:`repro_torch.fed.simulation.run_simulation`,
:func:`repro_torch.fed.runtime.run_federation`,
:meth:`repro_torch.models.api.Arch.init` and ``init_caches``,
:func:`repro_torch.convert.params_from_jax`,
:func:`repro_torch.checkpoint.restore_checkpoint`,
:func:`repro_torch.launch.mesh.make_fed_mesh`) run on the CUDA card unless
the caller passes ``device="cpu"``; without a card they raise instead of
falling back.  Everything else computes on the device of the tensors it
is given.  ``Arch.init(..., mesh=)``, ``restore_checkpoint(..., mesh=)``
and :func:`repro_torch.launch.train.make_train_step` ``(..., mesh=)`` hold
the parameters resident in shards across a mesh's devices
(:mod:`repro_torch.sharding.resident`).  The five hand-written Hopper kernels (encode, fused close,
per-client decode, QSGD, flash attention) live in
:mod:`repro_torch.kernels` (sources under ``kernels/csrc``).
"""
