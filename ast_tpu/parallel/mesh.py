"""Device mesh + sharding layout.

The reference is strictly single-GPU (reference: nn.py:50-53 picks a gpuid;
no distributed backend exists — SURVEY §2.5), so this subsystem is a new
capability, not a port: a ``jax.sharding.Mesh`` with a ``data`` axis for
batch parallelism and an optional ``model`` axis that shards the
vocab-dimension matrices (decoder embedding, output projection)
tensor-parallel style.  The mesh takes devices in ``jax.devices()``
order and assumes no topology: GPUs of one host are joined all to all
by NVLink, and XLA hands the gradient all-reduce to NCCL.

Layout rules:
- batches: leading (batch) axis over 'data'
- params: replicated, except vocab-dim matrices over 'model' when
  ``model_axis > 1``
- XLA inserts the psum/all-gather collectives from these annotations.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(parallel_cfg=None, devices=None, batch_size=None):
    """Build a (data, model) mesh.  Returns None when it would be 1x1
    (single device) — callers then use plain jit.

    With ``data_axis: 0`` (auto) the data axis is the largest device count
    that divides ``batch_size`` (sharded batches need equal per-device
    slices); explicit config values are honored as-is."""
    parallel_cfg = parallel_cfg or {}
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    model_axis = int(parallel_cfg.get("model_axis", 1) or 1)
    data_axis = int(parallel_cfg.get("data_axis", 0) or 0)
    if data_axis <= 0:
        data_axis = max(1, n // model_axis)
        if batch_size is not None:
            while data_axis > 1 and batch_size % data_axis != 0:
                data_axis -= 1
    if data_axis * model_axis == 1:
        return None
    if data_axis * model_axis > n:
        raise ValueError(
            f"mesh {data_axis}x{model_axis} needs more than {n} devices")
    dev_array = np.asarray(devices[: data_axis * model_axis]).reshape(
        data_axis, model_axis)
    return Mesh(dev_array, ("data", "model"))


def batch_spec(mesh, x, axis=0):
    """Shard array axis ``axis`` over 'data'; replicate scalars and
    arrays too small to carry that axis (e.g. the per-step scalars of a
    stacked multi-step batch)."""
    nd = np.ndim(x)
    if nd <= axis:
        return NamedSharding(mesh, P())
    spec = [None] * nd
    spec[axis] = "data"
    return NamedSharding(mesh, P(*spec))


def shard_batch(batch, mesh, axis=0):
    """device_put a host batch (pytree) with data-parallel sharding on
    every array leaf's ``axis`` (0 for a plain batch; 1 for a stacked
    (G, B, ...) multi-step batch whose leading axis is the scan axis)."""
    return jax.tree.map(
        lambda v: jax.device_put(v, batch_spec(mesh, v, axis)), batch)


def _param_pspec(path_str, leaf, model_parallel):
    """PartitionSpec for one parameter leaf (path as 'a/b/c')."""
    if model_parallel:
        if path_str.endswith("dec/out_w"):
            return P(None, "model")
        if path_str.endswith("dec/out_b"):
            return P("model")
        if path_str.endswith("dec/embed"):
            return P("model", None)
    return P()


def _path_str(path):
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
    return "/".join(parts)


def param_spec(params, mesh):
    """Pytree (same structure) of NamedShardings for a params-like tree."""
    model_parallel = mesh.shape.get("model", 1) > 1

    def spec(path, leaf):
        return NamedSharding(
            mesh, _param_pspec(_path_str(path), leaf, model_parallel))

    return jax.tree_util.tree_map_with_path(spec, params)


def replicate(tree, mesh):
    """Place a pytree on the mesh (params layout rules)."""
    specs = param_spec(tree, mesh)
    return jax.tree.map(jax.device_put, tree, specs)
