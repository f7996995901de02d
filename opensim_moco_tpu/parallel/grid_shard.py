"""Grid-axis sharding of one large transcription (SP/CP analogue).

The time grid of a direct-collocation problem is the "sequence" axis
(SURVEY.md section 5): per-point dynamics are embarrassingly parallel,
defect constraints couple nearest neighbors only
(reference CasOCHermiteSimpson.cpp:62-86), and quadrature/endpoint terms
are global reductions. That is structurally identical to context
parallelism with ring halos. Here one large problem's grid axis is
sharded over a device mesh the XLA-native way: the decision vector is
reshaped to per-grid-point rows, annotated with a NamedSharding over the
grid axis, and the constraint/objective evaluation is jitted over it —
XLA partitions the vmapped dynamics across chips and inserts the one-row
halo exchanges for the defect stencils and psum-style reductions for the
quadrature automatically (the "pick a mesh, annotate shardings, let XLA
insert collectives" recipe).

This module shards the evaluation only. The interior-point KKT solves of
one problem shard separately: ``make_solver(grid_mesh=...)`` runs the
partitioned block-tridiagonal solve of solver/kkt.py under ``shard_map``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

if TYPE_CHECKING:  # importing it here first would close an import
    # cycle: transcription -> ocp -> study -> transcription
    from ..transcribe.transcription import Transcription


def grid_sharded_eval(tr: Transcription, mesh: Mesh, axis: str = "grid"):
    """Returns jitted ``(objective, constraints)`` functions whose per-grid
    state/control arrays are sharded over ``axis`` of ``mesh``.

    The flat decision vector stays replicated (it is small); the expensive
    intermediate (G, ...) arrays — states, controls, and the vmapped
    dynamics outputs — carry sharding constraints so XLA partitions the
    physics across devices. G must not be smaller than the axis size.
    """
    n_dev = mesh.shape[axis]
    if tr.G < n_dev:
        raise ValueError(f"grid size {tr.G} < devices {n_dev}")
    pad = (-tr.G) % n_dev  # G rows padded to a multiple of the axis size
    sh = NamedSharding(mesh, P(axis))
    obj = tr.objective_fn()
    con = tr.constraints_fn()

    def shard_grid_rows(z):
        """Re-pack z so its (G, k) groups are sharded row-wise: a no-op
        value-wise, but the sharding constraint makes XLA place each
        device's rows locally for everything downstream."""
        o = tr.offsets
        parts = [z[:o["states"][0]]]
        for kind, per in (("states", tr.ny), ("controls", tr.nx),
                          ("multipliers", tr.nlam), ("derivs", tr.nderiv)):
            lo, hi = o[kind]
            if hi == lo:
                continue
            rows = z[lo:hi].reshape(tr.G, per)
            rows = jnp.concatenate(
                [rows, jnp.zeros((pad, per), dtype=z.dtype)]) if pad else rows
            rows = jax.lax.with_sharding_constraint(rows, sh)
            rows = rows[:tr.G] if pad else rows
            parts.append(rows.reshape(-1))
        parts.append(z[o["gamma"][0]:])
        return jnp.concatenate(parts)

    @jax.jit
    def objective(z):
        return obj(shard_grid_rows(z))

    @jax.jit
    def constraints(z):
        return con(shard_grid_rows(z))

    return objective, constraints
