"""Data-parallel (+ tensor-parallel) step compilation.

A new capability vs. the single-GPU reference (SURVEY §2.5): the train step
is jitted over the mesh with batches sharded on 'data' and params laid out
by :mod:`ast_tpu.parallel.mesh`; XLA's SPMD partitioner inserts the
gradient all-reduce (NCCL on GPUs) and any vocab-axis collectives from
the sharding annotations alone — no hand-written communication.

Multi-process (DCN) model: every host runs the same program over the same
global batch values; ``shard_batch`` extracts each host's local rows, the
train step's outputs stay in the input layout (params replicated, donated
in place), and the eval step's outputs are constrained to REPLICATED so
every host materializes the full prediction array (this is the all-gather
that makes multi-host dev BLEU work — eval/bleu.py indexes every utt).
"""

import jax
from jax.sharding import NamedSharding, PartitionSpec as P


def shard_train_step(step, mesh, donate_argnums=()):
    """jit a train step ``(params, state, opt_state, *batch_args) ->
    (params, state, opt_state, loss)`` over the mesh.

    Inputs arrive already placed (params replicated / vocab-sharded by
    :func:`ast_tpu.parallel.mesh.replicate`, batches data-sharded by
    :func:`shard_batch`); jit propagates those shardings, the SPMD
    partitioner inserts the gradient all-reduce, and the loss output is
    constrained replicated so every process can read it.
    """
    def wrapped(params, state, opt_state, *batch_args):
        params, state, opt_state, loss = step(
            params, state, opt_state, *batch_args)
        loss = jax.lax.with_sharding_constraint(
            loss, NamedSharding(mesh, P()))
        return params, state, opt_state, loss

    return jax.jit(wrapped, donate_argnums=donate_argnums)


def shard_eval_step(step, mesh):
    """jit ``step(params, state, X)`` with REPLICATED outputs: XLA
    all-gathers the per-device prediction rows, so ``np.asarray`` on the
    result is valid on every process."""
    return jax.jit(step, out_shardings=NamedSharding(mesh, P()))
