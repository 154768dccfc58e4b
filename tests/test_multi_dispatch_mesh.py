"""Multi-step dispatch over a device mesh: the scanned G-batch train
step sharded data-parallel must match the unsharded single-device
result exactly (the SPMD partitioner's all-reduce composes with the
step scan)."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from ast_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from ast_tpu.train.trainer import NN, _group_stream
from tests.conftest import make_tiny_experiment


def _pin_parallel(exp, data_axis):
    import json
    import os
    path = os.path.join(exp, "train_cfg.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["parallel"] = {"data_axis": data_axis, "model_axis": 1}
    with open(path, "w") as f:
        json.dump(cfg, f)


@pytest.mark.slow
def test_mesh_multi_step_matches_single_device(tmp_path):
    G = 2
    # two identical experiments (same seed string => same init), one
    # pinned to a single device, one to a 4-way data mesh
    exp1 = make_tiny_experiment(
        str(tmp_path / "single"), n_train=16, n_dev=4, batch_size=4,
        extras={"steps_per_dispatch": G})
    exp2 = make_tiny_experiment(
        str(tmp_path / "mesh"), n_train=16, n_dev=4, batch_size=4,
        extras={"steps_per_dispatch": G})
    _pin_parallel(exp1, 1)
    _pin_parallel(exp2, 4)

    nn1 = NN(exp1)
    assert nn1.mesh is None
    nn2 = NN(exp2)
    assert nn2.mesh is not None and nn2.mesh.shape["data"] == 4

    gen = nn1.data_loader.get_batch(4, "tiny_train", train=True,
                                    labels=True, epoch=0, group_runs=G)
    group = next(g for g in _group_stream(gen, G) if len(g) == G)

    kind1, pay1 = nn1._device_group(group)
    kind2, pay2 = nn2._device_group(group)
    assert kind1 == kind2 == "multi"

    epoch_key = jax.random.PRNGKey(11)

    def copy(t):
        return jax.tree.map(jnp.array, t)

    p1, s1, o1, l1 = nn1._train_multi_step(
        copy(nn1.params), copy(nn1.state), copy(nn1.opt_state),
        pay1["X"], pay1["y"], pay1["n_real"], epoch_key, 0)
    p2, s2, o2, l2 = nn2._train_multi_step(
        replicate(copy(nn1.params), nn2.mesh),
        replicate(copy(nn1.state), nn2.mesh),
        replicate(copy(nn1.opt_state), nn2.mesh),
        pay2["X"], pay2["y"], pay2["n_real"], epoch_key, 0)

    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2),
                               rtol=1e-5, atol=1e-6)
    for (pa, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(p1),
            jax.tree_util.tree_leaves_with_path(p2)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6,
            err_msg=f"mesh-vs-single param mismatch at {pa}")


def test_tail_shrink_keeps_local_rows_fused_aligned(tmp_path):
    """tail_shrink must be 8 x data shards (not lcm): each device's
    LOCAL rows of a shrunken tail batch stay 8-aligned, which fixes the
    set of tail batch shapes a config compiles."""
    exp = make_tiny_experiment(str(tmp_path / "m"), n_train=16, n_dev=4,
                               batch_size=4)
    _pin_parallel(exp, 4)
    nn = NN(exp)
    assert nn.mesh is not None and nn.mesh.shape["data"] == 4
    assert nn.tail_shrink == 32  # 8 rows/device * 4 devices
