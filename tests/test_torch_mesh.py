"""The port's meshes and partition table against the JAX package's, on
the CPU.

Mesh shapes and the training mesh's factorization equal the JAX meshes'
over the conftest's 8 virtual devices; ``make_pool_mesh_for`` refuses what
the JAX one refuses; ``match_partition_rules`` splits every operand of
``_OPERANDS`` on the axis JAX's ``PARTITION_RULES`` splits it on, and the
result specs agree; a mesh hashes by value (families cached on it hit);
``make_pool_mesh(None)`` raises without CUDA (no CPU fallback); and the
``ShardedRows`` layout round-trips."""

import jax
import numpy as np
import pytest
import torch

from consensus_entropy_tpu.parallel import mesh as jax_mesh
from consensus_entropy_tpu.parallel import pool_mesh as jax_pool_mesh
from consensus_entropy_tpu_torch.parallel import pool_mesh
from consensus_entropy_tpu_torch.parallel.mesh import (
    ShardedRows,
    make_pool_mesh,
    make_seq_mesh,
    make_training_mesh,
)

torch.set_num_threads(1)


def test_pool_and_seq_mesh_shapes_are_jax():
    assert make_pool_mesh(["cpu"] * 8).shape \
        == dict(jax_mesh.make_pool_mesh().shape) == {"pool": 8}
    assert make_seq_mesh(["cpu"] * 8).shape \
        == dict(jax_mesh.make_seq_mesh().shape) == {"seq": 8}


@pytest.mark.parametrize("n", range(1, 9))
def test_training_mesh_factorization_is_jax(n):
    ours = make_training_mesh(devices=["cpu"] * n)
    theirs = jax_mesh.make_training_mesh(devices=jax.devices()[:n])
    assert ours.shape == dict(theirs.shape)
    assert ours.devices.shape == theirs.devices.shape


def test_training_mesh_explicit_axes_and_refusal():
    assert make_training_mesh(dp=8, member=1, devices=["cpu"] * 8).shape \
        == {"dp": 8, "member": 1}
    assert make_training_mesh(member=2, devices=["cpu"] * 8).shape \
        == {"dp": 4, "member": 2}
    for kw in ({"dp": 3, "member": 3},):
        with pytest.raises(ValueError):
            jax_mesh.make_training_mesh(**kw)
        with pytest.raises(ValueError, match="dp\\*member"):
            make_training_mesh(devices=["cpu"] * 8, **kw)


def test_make_pool_mesh_for_errors():
    with pytest.raises(ValueError, match="at least 1 device"):
        jax_pool_mesh.make_pool_mesh_for(0)
    with pytest.raises(ValueError, match="at least 1 device"):
        pool_mesh.make_pool_mesh_for(0)
    with pytest.raises(ValueError, match="at least 1 device"):
        pool_mesh.make_pool_mesh_for(0, "cpu")
    with pytest.raises(ValueError, match="this process has"):
        jax_pool_mesh.make_pool_mesh_for(64)
    # no card here: any CUDA width is past the count
    with pytest.raises(ValueError, match="wants 2 device\\(s\\) but this "
                                         "process has 0"):
        pool_mesh.make_pool_mesh_for(2)
    mesh = pool_mesh.make_pool_mesh_for(2, "cpu")
    assert mesh.size == 2 and mesh.shape == {"pool": 2}
    assert pool_mesh.make_pool_mesh_for(2, "cpu") is mesh  # cached


def test_partition_rules_split_every_operand_as_jax():
    assert pool_mesh._OPERANDS == jax_pool_mesh._OPERANDS
    assert pool_mesh._MIX_KEYS == jax_pool_mesh._MIX_KEYS
    for key, names in pool_mesh._OPERANDS.items():
        ours = pool_mesh.match_partition_rules(names)
        theirs = jax_pool_mesh.match_partition_rules(names)
        assert ours == tuple(tuple(p) for p in theirs), key
        for spec, name in zip(ours, names):
            ndim = {"probs": 3, "hc_freq": 2}.get(name, 1)
            jax_axis = (list(tuple(theirs[names.index(name)])).index("pool")
                        if "pool" in tuple(theirs[names.index(name)])
                        else None)
            axis = pool_mesh._split_axis(spec, ndim)
            assert axis == jax_axis, (key, name)
            # a fleet's leading user axis shifts the split by one
            assert pool_mesh._split_axis(spec, ndim + 1) == (
                None if axis is None else axis + 1)
        spec_o, spec_t = pool_mesh._out_specs(key), \
            jax_pool_mesh._out_specs(key)
        assert type(spec_o).__name__ == type(spec_t).__name__
        for o, t in zip(spec_o, spec_t):
            assert o == (None if t is None else tuple(t)), key
    for mod in (pool_mesh, jax_pool_mesh):
        with pytest.raises(ValueError, match="no partition rule"):
            mod.match_partition_rules(("probs", "bogus_operand"))


def test_make_pool_mesh_needs_cuda_or_devices():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pool_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pool_mesh(["cuda:0"])
    with pytest.raises(ValueError, match="at least one device"):
        make_pool_mesh([])


def test_mesh_hashes_by_value_and_families_hit():
    a, b = make_pool_mesh(["cpu"] * 4), make_pool_mesh(["cpu"] * 4)
    assert a == b and hash(a) == hash(b) and a is not b
    assert a != make_pool_mesh(["cpu"] * 2)
    assert pool_mesh.make_sharded_step_fns(a, k=3) \
        is pool_mesh.make_sharded_step_fns(b, k=3)
    t = make_training_mesh(dp=2, member=2, devices=["cpu"] * 4)
    assert t.devices.shape == (2, 2)
    assert t.axis_devices("member") == [torch.device("cpu")] * 2


def test_sharded_rows_layout_round_trips():
    x = torch.arange(2 * 12 * 3, dtype=torch.float32).reshape(2, 12, 3)
    s = ShardedRows.split(x, [torch.device("cpu")] * 4, -2)
    assert s.axis == 1 and s.offsets == (0, 3, 6, 9) and s.n == 12
    assert s.shape == (2, 12, 3) and torch.equal(s.full(), x)
    # blocks are copies: changing one leaves the source alone
    s.blocks[0].zero_()
    assert x[0, 0, 1] == 1.0
    row = ShardedRows.split(x, [torch.device("cpu")] * 2, 1)[1]
    assert row.axis == 0 and torch.equal(row.full(), x[1])
    st = ShardedRows.stack([row, row])
    assert st.axis == 1 and torch.equal(st.full(),
                                        torch.stack([x[1], x[1]]))
    with pytest.raises(ValueError, match="do not divide"):
        ShardedRows.split(x, [torch.device("cpu")] * 5, 1)
    np.testing.assert_array_equal(
        s.map(lambda b: b * 2).full().numpy()[:, 3:], x.numpy()[:, 3:] * 2)
