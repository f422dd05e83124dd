"""The port's checkpoint against the reference's, on the CPU.

Both write ``manifest.msgpack`` + ``arrays.npz`` with ``||``-joined leaf
paths.  Checked: the port's save restores through the reference and the
reference's save through the port (float32 trees: the LM tree of reduced
SmolLM with its ``period`` list, and a tree with int leaves), bit for bit;
a bf16 tree saved by the reference (``V2`` words, ``"bfloat16"`` in the
manifest) restores in the port bit for bit, as does the port's own; the
manifest's bytes equal ``msgpack.packb`` of the same manifest, and the
port's codec reads what ``msgpack`` writes (skipped where ``msgpack`` is
missing); shape and missing-leaf errors.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.models.api import Arch as JArch  # noqa: E402
from repro_torch.checkpoint import msgpack_codec  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402


def _reference_ckpt():
    from repro.checkpoint import msgpack_ckpt

    return msgpack_ckpt


def _lm_params(dtype):
    cfg = dataclasses.replace(j_registry.get_config("smollm-360m").reduced(),
                              dtype=dtype)
    return JArch(cfg).init(jax.random.PRNGKey(0))


def _mixed_tree():
    rng = np.random.RandomState(0)
    return {"a": {"w": jnp.asarray(rng.randn(3, 4).astype(np.float32)),
                  "count": jnp.asarray(rng.randint(0, 9, (5,)), jnp.int32)},
            "b": [jnp.asarray(rng.randn(2).astype(np.float32)),
                  jnp.asarray(rng.randn(1, 2, 3).astype(np.float32))]}


def _carry(jtree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")


def _assert_bitwise(t_tree, j_tree):
    j_leaves = jax.tree_util.tree_leaves(j_tree)
    t_leaves = tree_leaves(t_tree)
    assert len(j_leaves) == len(t_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        assert tuple(t.shape) == j.shape
        if t.dtype == torch.bfloat16:
            assert torch.equal(t.view(torch.int16),
                               torch.from_numpy(np.array(j).view(np.int16)))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("which", ["lm", "mixed"])
def test_port_save_reference_restore(tmp_path, which):
    jtree = _lm_params("float32") if which == "lm" else _mixed_tree()
    save_checkpoint(str(tmp_path), _carry(jtree), step=7,
                    metadata={"arch": "smollm-360m", "lr": 0.05})
    like = jax.tree_util.tree_map(lambda w: jax.ShapeDtypeStruct(w.shape, w.dtype),
                                  jtree)
    got, step, meta = _reference_ckpt().restore_checkpoint(str(tmp_path), like)
    assert step == 7 and meta == {"arch": "smollm-360m", "lr": 0.05}
    _assert_bitwise(_carry(got), jtree)


@pytest.mark.parametrize("which", ["lm", "mixed"])
def test_reference_save_port_restore(tmp_path, which):
    jtree = _lm_params("float32") if which == "lm" else _mixed_tree()
    _reference_ckpt().save_checkpoint(str(tmp_path), jtree, step=3,
                                      metadata={"round": 3, "ok": True})
    like = tree_map(lambda w: torch.empty(w.shape, dtype=w.dtype, device="meta"),
                    _carry(jtree))
    got, step, meta = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert step == 3 and meta == {"round": 3, "ok": True}
    _assert_bitwise(got, jtree)


def test_port_restores_reference_bf16_checkpoint(tmp_path):
    jtree = _lm_params("bfloat16")
    assert {str(w.dtype) for w in jax.tree_util.tree_leaves(jtree)} == {"bfloat16"}
    _reference_ckpt().save_checkpoint(str(tmp_path), jtree, step=1)
    data = np.load(tmp_path / "arrays.npz")
    assert {data[k].dtype.str for k in data.files} == {"|V2"}
    got, step, _ = restore_checkpoint(str(tmp_path), _carry(jtree), device="cpu")
    assert step == 1
    _assert_bitwise(got, jtree)


def test_port_bf16_round_trip(tmp_path):
    jtree = _lm_params("bfloat16")
    tree = _carry(jtree)
    save_checkpoint(str(tmp_path), tree, step=2, metadata={"dtype": "bfloat16"})
    with open(tmp_path / "manifest.msgpack", "rb") as f:
        manifest = msgpack_codec.unpackb(f.read())
    assert {v["dtype"] for v in manifest["leaves"].values()} == {"bfloat16"}
    got, step, meta = restore_checkpoint(str(tmp_path), tree, device="cpu")
    assert step == 2 and meta == {"dtype": "bfloat16"}
    _assert_bitwise(got, jtree)
    # the words land where the reference's converter reads them
    _assert_bitwise(params_from_jax(params_to_numpy(got), device="cpu"), jtree)


def test_manifest_bytes_are_msgpack(tmp_path):
    msgpack = pytest.importorskip("msgpack")
    jtree = _lm_params("float32")
    meta = {"arch": "smollm-360m", "lr": 0.05, "rounds": 300, "neg": -70000,
            "none": None, "flags": [True, False], "big": 2 ** 40, "text": "é" * 40}
    _reference_ckpt().save_checkpoint(str(tmp_path / "ref"), jtree, step=70000,
                                      metadata=meta)
    save_checkpoint(str(tmp_path / "port"), _carry(jtree), step=70000,
                    metadata=meta)
    ref_bytes = (tmp_path / "ref" / "manifest.msgpack").read_bytes()
    assert (tmp_path / "port" / "manifest.msgpack").read_bytes() == ref_bytes
    assert msgpack_codec.unpackb(ref_bytes) == msgpack.unpackb(ref_bytes)


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 0.05, -0.0, math.inf, "", "a" * 31, "a" * 32, "a" * 256, "a" * 70000,
    [], list(range(15)), list(range(16)), list(range(70000)), (1, "x"),
    {}, {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {str(i): i for i in range(70000)}], ids=lambda o: repr(o)[:24])
def test_codec_matches_msgpack(obj):
    msgpack = pytest.importorskip("msgpack")
    data = msgpack.packb(obj)
    assert msgpack_codec.packb(obj) == data
    assert msgpack_codec.unpackb(data) == msgpack.unpackb(data)


def test_codec_refuses_what_it_does_not_carry():
    with pytest.raises(TypeError):
        msgpack_codec.packb({"x": b"bytes"})
    with pytest.raises(TypeError):
        msgpack_codec.packb({"x": np.float32(1.0)})
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(b"\xc4\x01x")              # bin 8
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(b"\x92\x01")               # truncated array
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(b"\x01\x02")               # trailing data


def test_restore_checks_shapes_and_leaves(tmp_path):
    tree = {"a": torch.zeros(3, 4), "b": torch.ones(2)}
    save_checkpoint(str(tmp_path), tree)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(4, 3),
                                           "b": torch.ones(2)}, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        restore_checkpoint(str(tmp_path), {**tree, "c": torch.zeros(1)},
                           device="cpu")
    got, _, _ = restore_checkpoint(str(tmp_path), {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
                                                   "b": torch.ones(2)}, device="cpu")
    assert got["a"].dtype == torch.bfloat16    # cast to the like leaf, as the reference
