"""Benchmark: batched hanging-muscle solve throughput on one GPU.

Two lanes, both end-to-end interior-point solves in float32 of upstream
testMocoActuators.cpp "Hanging muscle minimum time" (Hermite-Simpson, 25
mesh intervals), B=32 jittered guesses vmapped through one jitted solve:

1. full muscle dynamics: activation + implicit tendon compliance,
   mirroring testMocoActuators.cpp:1088 (headline:
   ``hanging_full_converged_solves_per_s``);
2. the simplified variant: rigid tendon, no activation dynamics.

Prints ONE JSON line with the card's name and power limit beside the
numbers. Needs a GPU; a lane that raises exits non-zero.
"""

import json
import subprocess
import time

import numpy as np

HANGING_MESH = 25
HANGING_BATCH = 32


def hanging_transcription(full_dynamics, mesh=HANGING_MESH):
    from opensim_moco_tpu.examples import hanging_muscle_study

    return hanging_muscle_study(
        mesh,
        ignore_tendon_compliance=not full_dynamics,
        ignore_activation_dynamics=not full_dynamics,
        tendon_dynamics_implicit=full_dynamics).transcription()


def hanging_options(full_dynamics):
    from opensim_moco_tpu.solver.ipm import IPMOptions

    return IPMOptions(tol=3e-3, max_iter=200 if full_dynamics else 150,
                      bound_relax=1e-6, mu_init=1e-2, kappa_eps=100.0,
                      acceptable_tol_factor=30.0, acceptable_iter=10,
                      max_rescues=100)


def lane_hanging(full_dynamics):
    import jax
    import jax.numpy as jnp

    from opensim_moco_tpu.parallel import batch_guesses
    from opensim_moco_tpu.solver.ipm import make_solver

    tr = hanging_transcription(full_dynamics)
    opts = hanging_options(full_dynamics)
    z0 = tr.initial_guess(dtype=np.float32)
    solve = make_solver(tr.make_nlp(), opts, scale_z0=z0)
    batched = jax.jit(jax.vmap(solve))
    B = HANGING_BATCH
    Z0 = batch_guesses(tr, B, scale=0.05, seed=0).astype(jnp.float32)
    batched(Z0).z.block_until_ready()  # compile + warm-up
    t0 = time.perf_counter()
    res = batched(Z0)
    res.z.block_until_ready()
    dt = time.perf_counter() - t0
    conv, strict, mit = jax.device_get(
        (jnp.sum(res.converged),
         # strict-tolerance exits vs acceptable-level exits (IPOPT's
         # "Solved To Acceptable Level"), reported separately
         jnp.sum(res.converged & (res.kkt_error <= opts.tol)),
         jnp.mean(res.iterations.astype(jnp.float32))))
    return {"batch": B, "converged": int(conv), "strict": int(strict),
            "mean_iterations": float(mit),
            "wall_s_per_batch": dt,
            "solves_per_s": B / dt,
            "converged_solves_per_s": int(conv) / dt}


def card():
    """nvidia-smi's name and power limit of each card, "; "-separated."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def main():
    from opensim_moco_tpu.config import require_gpu, use_compilation_cache

    devices = require_gpu()
    use_compilation_cache()
    hf = lane_hanging(full_dynamics=True)
    hs = lane_hanging(full_dynamics=False)
    print(json.dumps({
        "metric": "hanging_full_converged_solves_per_s",
        "value": hf["converged_solves_per_s"],
        "unit": "converged solves/s/GPU",
        "card": card(),
        "hanging_full": hf,
        "hanging_simplified": hs,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "count": len(devices)},
    }))


if __name__ == "__main__":
    main()
