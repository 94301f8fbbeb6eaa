"""Multi-host initialization and host-level sharding helpers.

The reference is strictly single-process (SURVEY.md §2.4).  Across hosts
the recipe is: initialize the jax distributed runtime on every host, build
ONE global 1-D "data" mesh over all devices, and create the global env
batch with `jax.make_array_from_process_local_data` so each host only
materializes its local shard.  The training step itself is unchanged —
`parallel.make_sharded_update` works on the global mesh, and XLA inserts
the gradient all-reduce across it.

(Multi-host paths are exercised by the multi-process CPU tests.)
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> int:
    """jax.distributed.initialize wrapper; returns this process's index.

    num_processes=1 needs no runtime.  Otherwise the arguments go to
    jax.distributed.initialize (with none, it reads a cluster environment
    it knows), and its errors propagate: a bad coordinator must fail the
    run, not train silently as one process.  Call once per process before
    any jax computation.
    """
    if num_processes != 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    return jax.process_index()


def global_env_batch(mesh: Mesh, local_leaves, axis_name: str = "data",
                     env_axis: int = 0):
    """Assemble a globally-sharded pytree from per-host local env shards.

    local_leaves: pytree of host-local arrays whose `env_axis` dimension is
    local_num_envs; the result is the global array of
    (num_hosts * local_num_envs) envs, sharded over the mesh without any
    cross-host data movement.  env_axis=0 covers EnvState pytrees and
    actions (env-major); the fused rollout's packed carry keeps envs in the
    trailing LANE axis (ops/pallas_fused.py), so pass env_axis=1 for it.
    """
    spec = P(*([None] * env_axis + [axis_name]))
    sharding = NamedSharding(mesh, spec)

    def assemble(x):
        global_shape = list(x.shape)
        global_shape[env_axis] *= jax.process_count()
        return jax.make_array_from_process_local_data(
            sharding, np.asarray(x), tuple(global_shape))

    return jax.tree.map(assemble, local_leaves)
