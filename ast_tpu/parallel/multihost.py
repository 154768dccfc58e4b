"""Multi-host (DCN) coordination.

New capability vs. the single-process reference (SURVEY §2.5).  Model:
every host runs the SAME SPMD program over a global device mesh
(``jax.distributed`` + :mod:`ast_tpu.parallel.mesh`).  The data pipeline
is NOT striped per host — each host builds the identical deterministic
batch stream (the dataloader derives its shuffle/augmentation RNGs from
(seed, set_key, epoch), and seeds are sha256-stable across processes) and
``shard_batch`` extracts the host's local rows of each global batch.
Gradient all-reduce runs over NVLink within a host and the network
across hosts, inserted by XLA from the mesh shardings; eval outputs are replicated so
every host holds the full predictions (see :mod:`ast_tpu.parallel.dp`).
Log/checkpoint writes belong to process 0 (trainer + CLI guards).

Validated end-to-end by a real 2-process CPU test
(tests/test_multihost_mp.py): one train epoch + greedy predict, with
identical param digests and full-split predictions on both hosts.
"""

import jax


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize jax.distributed when running multi-process; no-op (and
    safe) for single-process runs."""
    if num_processes is None or num_processes <= 1:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def host_info():
    """(process_index, process_count) of this host."""
    return jax.process_index(), jax.process_count()


def is_primary():
    """True on the process that owns log/checkpoint writes."""
    return jax.process_index() == 0
