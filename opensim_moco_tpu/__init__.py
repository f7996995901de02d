"""A direct-collocation trajectory-optimization framework with the
capabilities of OpenSim Moco (reference: adamkewley/opensim-moco),
re-designed for JAX/XLA.

Architecture (vs. reference layer map, SURVEY.md section 1):

* L0 physics  -> :mod:`opensim_moco_tpu.models` (pure-JAX multibody + muscle)
* L2/L3/L4    -> :mod:`opensim_moco_tpu.transcribe` (one fused XLA graph)
* L1 solve    -> :mod:`opensim_moco_tpu.solver` (batched interior point)
* L5/L6 API   -> :mod:`opensim_moco_tpu.ocp` / :mod:`opensim_moco_tpu.tools`
* scaling     -> :mod:`opensim_moco_tpu.parallel` (vmap/shard_map over meshes)
"""

from . import config

__version__ = "0.1.0"
