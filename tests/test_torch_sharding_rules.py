"""The port's sharding rules against the reference's, on the CPU.

* ``repro_torch.sharding.rules.param_specs`` (zero3 and tp) and
  ``input_specs_sharding`` equal ``repro.sharding.rules``', path by path
  (the reference's ``_path_str``), for all ten configs and the four input
  shapes on both reference meshes (the reference takes a mesh stand-in
  with the axis names and shape, as ``tests/test_sharding_e2e.py``);
* each device's shard (``shard_shape``) equals ``NamedSharding(
  AbstractMesh(...), spec).shard_shape``, and ``per_device_bytes`` is
  their sum;
* the activation spec resolution (``activations.resolve``) equals what the
  reference's ``constrain`` pins in modes dp, dp256 and off: its ambient
  axes and ``jax.lax.with_sharding_constraint`` are patched in the test.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.sharding.activations as j_act  # noqa: E402
from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_arch as j_get_arch  # noqa: E402
from repro.models.api import INPUT_SHAPES  # noqa: E402
from repro.sharding import rules as j_rules  # noqa: E402
from repro_torch.configs.registry import get_arch as t_get_arch  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.sharding import activations as t_act  # noqa: E402
from repro_torch.sharding import rules as t_rules  # noqa: E402

MESHES = {False: ("data", "model"), True: ("pod", "data", "model")}


class _FakeMesh:
    """The reference's mesh stand-in: axis names and the devices' shape."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = type("devices", (), {"shape": shape})


def _meshes(multi_pod):
    t = make_production_mesh(multi_pod=multi_pod)
    return t, _FakeMesh(t.axis_names, t.shape), AbstractMesh(t.shape, t.axis_names)


def _ref_paths(tree, specs):
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return [(j_rules._path_str(p), leaf.shape, tuple(s))
            for (p, leaf), s in zip(leaves, spec_leaves)]


def _port_paths(tree, specs):
    leaves = t_rules.tree_paths(tree)
    spec_leaves = t_rules._spec_paths(specs)
    assert len(leaves) == len(spec_leaves)
    return [(t_rules.path_str(p), tuple(leaf.shape), s)
            for (p, leaf), (_, s) in zip(leaves, spec_leaves)]


def _check_shards(rows, t_mesh, a_mesh, tree, specs):
    for _, shape, spec in rows:
        got = t_rules.shard_shape(shape, spec, t_mesh)
        assert got == NamedSharding(a_mesh, P(*spec)).shard_shape(shape)
    total = sum(math.prod(t_rules.shard_shape(tuple(x.shape), s, t_mesh)) * x.element_size()
                for (_, x), (_, s) in zip(t_rules.tree_paths(tree),
                                          t_rules._spec_paths(specs)))
    assert t_rules.per_device_bytes(tree, specs, t_mesh) == total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", ARCH_IDS)
def test_param_specs_equal_the_reference(name, multi_pod):
    t_mesh, f_mesh, a_mesh = _meshes(multi_pod)
    j_arch, t_arch = j_get_arch(name), t_get_arch(name)
    jp, tp = j_arch.param_shapes(), t_arch.param_shapes()
    for layout in ("zero3", "tp"):
        want = _ref_paths(jp, j_rules.param_specs(jp, f_mesh, j_arch.cfg.num_experts,
                                                  layout))
        specs = t_rules.param_specs(tp, t_mesh, t_arch.cfg.num_experts, layout)
        got = _port_paths(tp, specs)
        assert got == want
        _check_shards(got, t_mesh, a_mesh, tp, specs)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", ARCH_IDS)
def test_input_specs_sharding_equals_the_reference(name, multi_pod):
    t_mesh, f_mesh, a_mesh = _meshes(multi_pod)
    j_arch, t_arch = j_get_arch(name), t_get_arch(name)
    for shape in INPUT_SHAPES:
        gb = INPUT_SHAPES[shape][1]
        jin, tin = j_arch.input_specs(shape), t_arch.input_specs(shape)
        assert sorted(jin) == sorted(tin)
        for key in jin:
            want = _ref_paths(jin[key], j_rules.input_specs_sharding(jin[key], f_mesh,
                                                                     gb))
            specs = t_rules.input_specs_sharding(tin[key], t_mesh, gb)
            got = _port_paths(tin[key], specs)
            assert got == want, (shape, key)
            _check_shards(got, t_mesh, a_mesh, tin[key], specs)
        assert t_rules.batch_spec(t_mesh, gb) == (
            None if j_rules.batch_spec(f_mesh, gb) is None
            else tuple(j_rules.batch_spec(f_mesh, gb)))


_ACT_CASES = [((256, 4096, 960), (t_act.BATCH, None, t_act.MODEL)),
              ((1, 8, 64), (t_act.BATCH, None, t_act.MODEL)),
              ((32, 7, 16), (t_act.BATCH, t_act.MODEL, None)),
              ((48, 1, 4096), (t_act.BATCH, None, t_act.MODEL)),
              ((512, 8), (t_act.BATCH, t_act.MODEL))]


@pytest.mark.parametrize("mode", ["dp", "dp256", "off"])
def test_activation_resolution_equals_the_reference_constrain(monkeypatch, mode):
    pinned = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: pinned.append(tuple(spec)) or x)
    for names, shape in ((("data", "model"), (16, 16)),
                         (("pod", "data", "model"), (2, 16, 16)),
                         (("data", "model"), (1, 1)), (("data", "model"), (4, 2))):
        axes = dict(zip(names, shape))
        monkeypatch.setattr(j_act, "_ambient_axes", lambda axes=axes: axes)
        for dims, logical in _ACT_CASES:
            jlog = tuple({t_act.BATCH: j_act.BATCH, t_act.MODEL: j_act.MODEL}.get(lg)
                         for lg in logical)
            with j_act.batch_mode(mode):
                j_act.constrain(jax.ShapeDtypeStruct(dims, "float32"), *jlog)
            assert t_act.resolve(dims, logical, axes, mode) == pinned[-1]
            # constrain resolves on the ambient mesh and leaves x as it is
            x = torch.empty(dims, device="meta")
            mesh = type("M", (), {"axis_names": names, "shape": shape})
            with t_act.use_mesh(mesh), t_act.batch_mode(mode):
                assert t_act.constrain(x, *logical) is x
    monkeypatch.setattr(j_act, "_ambient_axes", lambda: None)
    assert t_act.ambient_axes() is None
    x = torch.zeros(4)
    assert t_act.constrain(x, t_act.BATCH) is x
