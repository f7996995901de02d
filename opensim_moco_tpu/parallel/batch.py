"""Batched + sharded solves over device meshes.

This is the scaling story the reference lacks (SURVEY.md section 2.8: its
only parallelism is a thread pool over grid points backed by a mutex'd
model-replica jar, MocoUtilities.h:680-716). Here:

* **batch axis** (DP analogue): `vmap` the whole interior-point solve over
  thousands of problems (initial guesses, tracking targets, parameter
  sweeps), sharded across chips with `NamedSharding` so each chip owns a
  slice of the batch; XLA inserts any cross-chip reductions.
* **grid axis** (SP/CP analogue): planned — shard mesh intervals of one
  large problem with halo exchange (defects couple nearest neighbors only,
  CasOCHermiteSimpson.cpp:62-86), reducing the block-banded KKT across
  chips.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solver.ipm import IPMOptions, make_solver

if TYPE_CHECKING:  # importing it here first would close an import
    # cycle: transcription -> ocp -> study -> transcription
    from ..transcribe.transcription import Transcription


def make_batched_solver(transcription: Transcription,
                        ipm_options: IPMOptions = IPMOptions(),
                        mesh: Mesh | None = None,
                        batch_axis: str = "batch"):
    """Returns ``solve(Z0) -> IPMResult`` where Z0 is (B, n).

    With a mesh, inputs/outputs are sharded over ``batch_axis``; the batch
    size must divide the number of devices' shards evenly (pad externally).
    """
    nlp = transcription.make_nlp()
    single = make_solver(nlp, ipm_options)
    batched = jax.vmap(single)
    if mesh is None:
        return jax.jit(batched)
    sharding = NamedSharding(mesh, P(batch_axis))

    @jax.jit
    def solve(Z0):
        Z0 = jax.lax.with_sharding_constraint(Z0, sharding)
        return batched(Z0)

    return solve


def default_mesh(axis_name: str = "batch") -> Mesh:
    """1-D mesh over all local devices."""
    devs = np.array(jax.devices())
    return Mesh(devs, (axis_name,))


def batch_guesses(transcription: Transcription, batch: int, scale=0.0,
                  seed=0):
    """Stack B bounds-midpoint guesses, optionally jittered for multistart
    (the reference's "random" guess mode, CasOCTranscription.cpp:1151-1178)."""
    g = np.asarray(transcription.initial_guess())
    Z0 = np.tile(g, (batch, 1))
    if scale:
        rng = np.random.default_rng(seed)
        lb, ub = [np.asarray(a) for a in transcription.bounds()]
        width = np.where(np.isfinite(ub - lb), ub - lb, 1.0)
        jitter = rng.uniform(-scale, scale, Z0.shape) * width
        free = ~((lb == ub) & np.isfinite(lb))
        Z0 = Z0 + jitter * free
        Z0 = np.clip(Z0, lb, ub)
    return jnp.asarray(Z0)
