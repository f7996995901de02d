"""Multi-host scale-out (SURVEY §2.8: batches larger than one host).

The reference has no distributed story at all (single-process IPOPT). The
JAX-native recipe for spanning hosts:

1. every host process calls :func:`initialize` (jax.distributed) so
   `jax.devices()` exposes the global device set;
2. build one global mesh over all devices and shard the batch axis of
   the vmapped solve across it — each host feeds its local shard via
   `jax.make_array_from_process_local_data`, XLA runs the same program
   everywhere, and lanes never communicate (the batch axis is
   embarrassingly parallel, so the only collective is the implicit
   result gather if the caller fetches remote shards).

On a single process this degrades to the local-device mesh, which is how
the tests run it on a virtual 8-device CPU mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               **kwargs):
    """Bring up the JAX distributed runtime (multi-host). No-op when
    called with no arguments inside a single-process run that already
    sees all its devices (e.g. the CI dry-run), so the same launch script
    works on one host and on a multi-host slice.

    On several hosts, pass the explicit coordinator/process triple (or
    nothing where ``jax.distributed`` autodetects the cluster).
    """
    if coordinator_address is None and num_processes is None and \
            jax.process_count() == 1 and jax.local_device_count() == \
            len(jax.devices()):
        already_global = True
    else:
        already_global = False
    if not already_global or coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id, **kwargs)
    return jax.process_index(), jax.process_count()


def global_batch_mesh(axis="batch"):
    """One mesh over every device of every host."""
    return Mesh(np.array(jax.devices()), (axis,))


def solve_batch_multihost(solve, Z0_local, mesh=None, axis="batch"):
    """Run a vmapped solve with the batch axis sharded over all hosts.

    ``solve``: a per-lane solve fn (make_solver output). ``Z0_local``:
    THIS host's share of the guesses, shape (B_local, n); every host must
    pass the same B_local. Returns this host's local shard of the result
    (addressable rows of the global IPMResult arrays).
    """
    mesh = mesh or global_batch_mesh(axis)
    sh = NamedSharding(mesh, P(axis))
    B_local = Z0_local.shape[0]
    B_global = B_local * jax.process_count()
    if jax.process_count() > 1:
        Z0 = jax.make_array_from_process_local_data(
            sh, np.asarray(Z0_local), (B_global,) + Z0_local.shape[1:])
    else:
        Z0 = jax.device_put(jnp.asarray(Z0_local), sh)
    res = jax.jit(jax.vmap(solve), out_shardings=sh)(Z0)
    return res
