"""Smoke run of the main solve path on one NVIDIA GPU.

Drives Study -> Transcription -> NLP -> batched interior-point solve
through the public API, in float32, and checks each result against a
plain reference:

(a) main path, batched: upstream testMocoActuators.cpp "Hanging muscle
    minimum time" with activation and implicit tendon dynamics
    (Hermite-Simpson, 25 mesh intervals). B=32 jittered guesses are solved
    by ``jax.jit(jax.vmap(make_solver(...)))`` with the bench's IPM
    options. In a child process on the CPU that never opens the card, the
    same transcription is solved once in float64, and every converged
    lane's final time and state trajectory is evaluated in float64: its
    constraint violation and objective must match what the device
    reported, and the lanes' median final time must lie near the float64
    optimum's.
(b) ``Study.solve()``, single solves: sliding-mass minimum time against
    its analytic bang-bang optimum, and the double-pendulum swing-up with
    its elbow path constraint.

``--four`` runs only the multi-device paths, on four cards, each against
the single-device result of the same problem: the batch-sharded solve
(``make_batched_solver(..., mesh=default_mesh())``), the grid-sharded
evaluation, the partitioned block-tridiagonal KKT solve and the
grid-sharded IPM (``make_solver(grid_mesh=...)``).

Usage: ``python chip_smoke.py [--four]``. Every number goes to an earlier
line; the last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``. A host without a GPU, a phase that
raises or a result outside its stated tolerance exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

import bench

# Phase (a) limits, set from the same float32 batch (B=32, mesh 25) run on
# the CPU, which converged 25 lanes, 22 of them to the strict tolerance;
# margin 3 lanes each. Run with TF32 matmuls on the H100 the batch
# converged 25 lanes but only 14 strictly.
MIN_CONVERGED = 22
MIN_STRICT = 19
# Each converged lane, evaluated in float64 on the CPU: its scaled
# constraint violation (height, speed, activation and tendon-force
# defects, path and endpoint rows) must lie within the KKT error the device
# reported for it. The float64 violation exceeded the reported error by at
# most 6e-11 on the CPU float32 batch and 7e-11 on the H100; with TF32
# matmuls on the H100, by up to 4.9e-4. The objective must match its
# float64 value.
VIOLATION_SLACK = 1e-5
OBJECTIVE_RTOL = 1e-5
# The converged lanes' median distance from the float64 optimum's final
# time: 0.00053 s on the CPU float32 batch; twice that. Single lanes are
# not held to the optimum: the bench tolerance (3e-3) admits KKT points
# whose final times span 0.050-0.110 s, in float64 as in float32 (the same
# 32 guesses solved in float64 on the CPU: 27 converged, tf 0.0501-0.1095
# s), and a lane's path from its guess differs between float32 and
# float64 after a few iterations.
TF_MEDIAN_TOL = 0.0011
# Phase (b) limits: the analytic sliding-mass optimum (test_examples.py),
# the double pendulum's pinned endpoints and its elbow path bound.
SLIDING_TF, SLIDING_TF_TOL = 0.4, 2e-3
ENDPOINT_TOL = 1e-6
ELBOW_LIMIT = 2.0
PATH_SLACK = 1e-4  # the bound holds to the IPM's tolerance
# tests/test_examples.py solves the pendulum to tol 1e-6 in float64, and
# in float64 the H100 reaches it (77 iterations). Float32 cannot: the
# primal part of its scaled KKT error floors at the rounding of the defect
# rows, 2^-19 = 1.9e-6 (per-iteration traces on the CPU and the H100).
# On the H100 the solve's scatter-adds also run with atomics, so float32
# runs differ from one to the next; at tol 1e-5 or 1e-6 five of eight
# stalled with a best KKT error of 1.5e-4 to 5.1e-4 once the barrier
# fell below 2e-6. At tol 1e-4 the barrier stops at 9.1e-6, and the runs
# converged strictly. TF32 is not the cause: every gemm in the optimized
# HLO runs at HIGHEST, and NVIDIA_TF32_OVERRIDE=0 changed nothing.
PENDULUM_IPM = dict(tol=1e-4, max_iter=300)


def card_line(devices) -> str:
    """One line: JAX's view of the device and nvidia-smi's name and power
    limit of every card."""
    d = devices[0]
    return (f"device: platform={d.platform} kind={d.device_kind} "
            f"count={len(devices)} | nvidia-smi: {bench.card()}")


# ------------------------------------------------------- float64 reference
def f64_optimum(tr) -> dict:
    """The phase (a) transcription solved once from its bounds-midpoint
    guess, in float64 on the current (CPU) backend. Needs x64 enabled.

    From that guess the bench's options exit at a KKT point far from the
    optimum (final time 0.132 s against 0.051 s), so the reference uses
    IPOPT's barrier gate (kappa_eps=10) and a tight tolerance, and returns
    the best iterate of its iteration budget. It is accepted when its
    scaled KKT error is within the bench's strict tolerance (8e-4 against
    3e-3 at mesh 25)."""
    import jax
    import jax.numpy as jnp

    from opensim_moco_tpu.solver.ipm import make_solver

    bench_opts = bench.hanging_options(full_dynamics=True)
    opts = dataclasses.replace(bench_opts, tol=1e-6, kappa_eps=10.0,
                               max_iter=900)
    z0 = tr.initial_guess(dtype=np.float64)
    res = jax.jit(make_solver(tr.make_nlp(), opts, scale_z0=z0))(
        jnp.asarray(z0))
    z, kkt = jax.device_get((res.z, res.kkt_error))
    if not kkt <= bench_opts.tol:
        raise RuntimeError(f"float64 reference KKT error {kkt} > "
                           f"{bench_opts.tol}")
    return {"tf": float(z[1]), "kkt": float(kkt), "z": z}


def f64_lane_check(tr, Z) -> dict:
    """Each lane's iterate ``Z`` (B, n) evaluated in float64 on the
    current (CPU) backend: the inf-norm of its constraints under the
    solver's gradient scaling (taken at the float32 scaling point), and
    its objective."""
    import jax
    import jax.numpy as jnp

    from opensim_moco_tpu.solver.ipm import gradient_scaling
    from opensim_moco_tpu.solver.kkt import CompiledStructure

    nlp = tr.make_nlp()
    s = nlp.structure
    cs = CompiledStructure(s.var_blocks, s.con_blocks, s.border_vars,
                           s.border_cons, nlp.n, nlp.m)
    z0 = tr.initial_guess(dtype=np.float32).astype(np.float64)
    _, c_scale = gradient_scaling(nlp, cs, z0)
    c_scale = jnp.asarray(c_scale)

    def lane(z):
        return (jnp.max(jnp.abs(c_scale * nlp.constraints(z))),
                nlp.objective(z))

    violation, objective = jax.device_get(
        jax.jit(jax.vmap(lane))(jnp.asarray(Z, jnp.float64)))
    return {"violation": violation.tolist(), "objective": objective.tolist()}


def reference_main(mesh: int) -> None:
    """The CPU child of phase (a): solve the float64 optimum, then read the
    device's lane iterates from standard input (a JSON list of lists),
    check them in float64 and print one JSON line."""
    import jax

    if not jax.config.jax_enable_x64:
        raise RuntimeError("the float64 reference needs JAX_ENABLE_X64=1")
    tr = bench.hanging_transcription(full_dynamics=True, mesh=mesh)
    opt = f64_optimum(tr)
    ref = {"tf": opt["tf"], "kkt": opt["kkt"]}
    ref.update(f64_lane_check(tr, np.asarray(json.loads(sys.stdin.read()))))
    print(json.dumps(ref))


def reference_child(mesh: int) -> subprocess.Popen:
    """Start :func:`reference_main` in a CPU-only child process."""
    # the card is hidden too; JAX's CUDA plugin then logs a failed
    # cuInit on stderr, which is shown only if the child fails
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--f64-reference",
         str(mesh)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=os.path.dirname(os.path.abspath(__file__)))


def collect_reference(child: subprocess.Popen, Z, timeout: float) -> dict:
    """Send the lane iterates ``Z`` to the child; return its JSON line."""
    out, err = child.communicate(json.dumps(np.asarray(Z).tolist()),
                                 timeout=timeout)
    if child.returncode != 0:
        raise RuntimeError(f"float64 reference child exited "
                           f"{child.returncode}:\n{err[-4000:]}")
    ref = json.loads(out.strip().splitlines()[-1])
    for k in ("violation", "objective"):
        ref[k] = np.asarray(ref[k])
    return ref


# ------------------------------------------------------------- phase (a)
def phase_main(mesh: int = bench.HANGING_MESH,
               batch: int = bench.HANGING_BATCH) -> dict:
    """Batched float32 solve of the hanging muscle with full dynamics.

    The float64 optimum is solved in a CPU child process while the device
    compiles and runs; the child then checks every lane's iterate in
    float64. Returns the measured numbers; :func:`check_main` judges them.
    """
    import jax
    import jax.numpy as jnp

    from opensim_moco_tpu.parallel import batch_guesses
    from opensim_moco_tpu.solver.ipm import make_solver

    child = reference_child(mesh)
    t_start = time.perf_counter()
    tr = bench.hanging_transcription(full_dynamics=True, mesh=mesh)
    nlp = tr.make_nlp()
    opts = bench.hanging_options(full_dynamics=True)
    z0 = tr.initial_guess(dtype=np.float32)
    Z0 = batch_guesses(tr, batch, scale=0.05, seed=0).astype(jnp.float32)
    build_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    solve = make_solver(nlp, opts, scale_z0=z0)
    scaling_s = time.perf_counter() - t0
    print(f"scaling pass (compile + run, once per make_solver): "
          f"{scaling_s:.3f} s", flush=True)

    t0 = time.perf_counter()
    compiled = jax.jit(jax.vmap(solve)).lower(Z0).compile()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    jax.block_until_ready(compiled(Z0))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(compiled(Z0))
    warm_s = time.perf_counter() - t0

    z, f, conv, kkt, its = jax.device_get(
        (res.z, res.f, res.converged, res.kkt_error, res.iterations))
    conv = np.asarray(conv, bool)
    ref = collect_reference(child, z, timeout=900)
    dtf = np.abs(z[:, 1] - ref["tf"])
    out = {
        "mesh": mesh, "batch": batch, "n": nlp.n, "m": nlp.m,
        "build_s": build_s, "scaling_pass_s": scaling_s,
        "compile_s": compile_s, "first_run_s": first_s,
        "warm_wall_s_per_batch": warm_s,
        "converged": int(conv.sum()),
        "strict": int((conv & (kkt <= opts.tol)).sum()),
        "iterations_mean": float(np.mean(its)),
        "iterations_max": int(np.max(its)),
        "ref_tf": ref["tf"],
        "median_dtf_converged": (float(np.median(dtf[conv])) if conv.any()
                                 else None),
        "lane_converged": conv, "lane_kkt": kkt, "lane_dtf": dtf,
        "lane_f64_violation": ref["violation"],
        "lane_objective_rel_err": (np.abs(f - ref["objective"])
                                   / np.maximum(np.abs(ref["objective"]),
                                                1.0)),
    }
    stats = jax.devices()[0].memory_stats()
    if stats:
        out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    return out


def check_main(out) -> list:
    """The phase (a) checks that fail."""
    conv = out["lane_converged"]
    failed = []
    if out["converged"] < MIN_CONVERGED:
        failed.append(f"converged {out['converged']} < {MIN_CONVERGED}")
    if out["strict"] < MIN_STRICT:
        failed.append(f"strict {out['strict']} < {MIN_STRICT}")
    excess = (out["lane_f64_violation"] - out["lane_kkt"])[conv]
    if np.any(excess > VIOLATION_SLACK):
        failed.append(f"float64 constraint violation above the reported "
                      f"KKT error by {excess.max()} > {VIOLATION_SLACK}")
    obj_err = out["lane_objective_rel_err"][conv]
    if np.any(obj_err > OBJECTIVE_RTOL):
        failed.append(f"objective off its float64 value by {obj_err.max()}"
                      f" > {OBJECTIVE_RTOL}")
    if not (out["median_dtf_converged"] is not None
            and out["median_dtf_converged"] <= TF_MEDIAN_TOL):
        failed.append(f"median final time off the float64 optimum by "
                      f"{out['median_dtf_converged']} > {TF_MEDIAN_TOL}")
    return failed


def run_main() -> dict:
    out = phase_main()
    out["failed"] = check_main(out)
    return out


# ------------------------------------------------------------- phase (b)
def phase_study() -> dict:
    """Single float32 solves through ``Study.solve()``."""
    from opensim_moco_tpu.examples import (double_pendulum_swingup_study,
                                           sliding_mass_study)

    failed = []
    sol = sliding_mass_study(50, "trapezoidal").solve(profile=True)
    err = abs(sol.final_time - SLIDING_TF)
    sliding = dict(success=sol.success, status=sol.status,
                   iterations=sol.num_iterations,
                   final_time=sol.final_time, abs_err=err, **sol.profile)
    if not (sol.success and err < SLIDING_TF_TOL):
        failed.append(f"sliding mass: {sol.status}, tf {sol.final_time}")

    study = double_pendulum_swingup_study(25, with_path_constraint=True)
    study.set_ipm_options(**PENDULUM_IPM)
    sol = study.solve(profile=True)
    sol_read = sol if sol.success else sol.unseal()
    q0 = sol_read.state("/jointset/j0/q0/value")
    # path constraints hold at mesh points (Hermite-Simpson midpoints free)
    mesh_points = study.transcription().mesh_idx
    elbow = np.max(np.abs(
        sol_read.state("/jointset/j1/q1/value")[mesh_points]))
    pendulum = dict(success=sol.success, status=sol.status,
                    iterations=sol.num_iterations, kkt_error=sol.kkt_error,
                    q0_start=float(q0[0]), q0_end_err=float(q0[-1] - np.pi),
                    elbow_max_abs=float(elbow), **sol.profile)
    # converged to the tolerance itself, not at the acceptable level
    if not (sol.success and sol.kkt_error <= PENDULUM_IPM["tol"]
            and abs(q0[0]) < ENDPOINT_TOL
            and abs(q0[-1] - np.pi) < ENDPOINT_TOL
            and elbow <= ELBOW_LIMIT + PATH_SLACK):
        failed.append(f"double pendulum: {pendulum}")
    return {"sliding_mass": sliding, "double_pendulum": pendulum,
            "failed": failed}


# ------------------------------------------------------------ --four
FOUR_SLIDING_MESH = 50
FOUR_LANES_PER_DEVICE = 8
FOUR_KIRK_MESH = 24
# float32 agreement of a sharded result with the single-device one: the
# lanes' final times (= objective) within the solve tolerance, the sharded
# evaluation and the partitioned KKT solve within float32 rounding of
# their sums taken in another order.
FOUR_F_TOL = 1e-4
FOUR_EVAL_RTOL = 1e-5
FOUR_KKT_TOL = 1e-4
# the batch-axis problem is solved unscaled (make_batched_solver takes no
# scaling point); 27/32 lanes converge in float32 on the CPU, and the
# floor leaves 3 lanes for rounding that differs on the GPU
FOUR_MIN_CONVERGED_FRACTION = 0.75


def phase_four(devices, sliding_mesh=FOUR_SLIDING_MESH,
               lanes_per_device=FOUR_LANES_PER_DEVICE,
               kirk_mesh=FOUR_KIRK_MESH) -> dict:
    """Every multi-device path against its single-device result."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from opensim_moco_tpu.examples import (double_pendulum_swingup_study,
                                           kirk_min_effort_study,
                                           sliding_mass_study)
    from opensim_moco_tpu.parallel import (batch_guesses, default_mesh,
                                           grid_sharded_eval,
                                           make_batched_solver)
    from opensim_moco_tpu.solver.ipm import IPMOptions, make_solver
    from opensim_moco_tpu.solver.kkt import (block_tridiag_solve,
                                             block_tridiag_solve_partitioned)

    n_dev = len(devices)
    out, failed = {}, []

    # batch axis: make_batched_solver over a flat mesh of every card
    tr = sliding_mass_study(sliding_mesh, "trapezoidal").transcription()
    opts = IPMOptions(tol=1e-4, max_iter=120, mu_init=1e-2)
    B = lanes_per_device * n_dev
    Z0 = batch_guesses(tr, B, scale=0.03, seed=0).astype(jnp.float32)
    t0 = time.perf_counter()
    single = jax.block_until_ready(make_batched_solver(tr, opts)(Z0))
    t1 = time.perf_counter()
    sharded = jax.block_until_ready(
        make_batched_solver(tr, opts, mesh=default_mesh())(Z0))
    t2 = time.perf_counter()
    c1, cs = np.asarray(single.converged), np.asarray(sharded.converged)
    both = c1 & cs
    df = np.abs(np.asarray(sharded.f) - np.asarray(single.f))[both]
    out["batch_axis"] = dict(
        batch=B, devices=len(sharded.z.sharding.device_set),
        converged_single=int(c1.sum()), converged_sharded=int(cs.sum()),
        iterations_mean=float(np.mean(sharded.iterations)),
        max_abs_df=float(df.max()) if df.size else None,
        single_s=t1 - t0, sharded_s=t2 - t1)
    if (len(sharded.z.sharding.device_set) != n_dev
            or cs.sum() < FOUR_MIN_CONVERGED_FRACTION * B
            or not df.size or df.max() > FOUR_F_TOL):
        failed.append(f"batch axis: {out['batch_axis']}")

    # grid axis (a): sharded objective/constraint evaluation
    grid = Mesh(np.array(devices), ("grid",))
    tr_g = double_pendulum_swingup_study(4 * n_dev).transcription()
    nlp_g = tr_g.make_nlp()
    zg = jnp.asarray(tr_g.initial_guess(dtype=np.float32))
    obj_s, con_s = grid_sharded_eval(tr_g, grid, "grid")
    f_s, c_s = jax.device_get((obj_s(zg), con_s(zg)))
    f_r, c_r = jax.device_get((jax.jit(nlp_g.objective)(zg),
                               jax.jit(nlp_g.constraints)(zg)))
    ev = max(abs(f_s - f_r) / max(abs(f_r), 1.0),
             float(np.max(np.abs(c_s - c_r)) / max(np.max(np.abs(c_r)), 1.0)))
    out["grid_eval"] = dict(grid_points=tr_g.G, rel_err=ev)
    if ev > FOUR_EVAL_RTOL:
        failed.append(f"grid-sharded evaluation: {out['grid_eval']}")

    # grid axis (b): partitioned block-tridiagonal solve vs the scan
    nb, N = 6, 4 * n_dev
    rng = np.random.default_rng(0)
    D = rng.normal(size=(N, nb, nb)).astype(np.float32)
    D = 0.5 * (D + D.transpose(0, 2, 1)) + 8.0 * np.eye(nb, dtype=np.float32)
    L = 0.3 * rng.normal(size=(N, nb, nb)).astype(np.float32)
    rhs = rng.normal(size=(N, nb)).astype(np.float32)
    x_seq = block_tridiag_solve(jnp.asarray(D), jnp.asarray(L[:-1]),
                                jnp.asarray(rhs))
    par = shard_map(
        lambda d, l, r: block_tridiag_solve_partitioned(d, l, r, "grid"),
        mesh=grid, in_specs=(P("grid"), P("grid"), P("grid")),
        out_specs=P("grid"))
    x_par = jax.jit(par)(jnp.asarray(D), jnp.asarray(L), jnp.asarray(rhs))
    kkt_err = float(jnp.max(jnp.abs(x_par - x_seq)))
    out["partitioned_kkt"] = dict(blocks=N, max_abs_err=kkt_err)
    if kkt_err > FOUR_KKT_TOL:
        failed.append(f"partitioned KKT solve: {out['partitioned_kkt']}")

    # grid axis (c): one IPM solve with every KKT solve sharded
    tr_k = kirk_min_effort_study(kirk_mesh,
                                 scheme="trapezoidal").transcription()
    nlp_k = tr_k.make_nlp()
    zk = jnp.asarray(tr_k.initial_guess(dtype=np.float32))
    opts_k = IPMOptions(tol=1e-4, max_iter=150)
    t0 = time.perf_counter()
    res_r = jax.block_until_ready(
        jax.jit(make_solver(nlp_k, opts_k, scale_z0=zk))(zk))
    t1 = time.perf_counter()
    res_g = jax.block_until_ready(jax.jit(make_solver(
        nlp_k, opts_k, scale_z0=zk, grid_mesh=grid))(zk))
    t2 = time.perf_counter()
    gdrift = abs(float(res_g.f) - float(res_r.f)) / max(abs(float(res_r.f)),
                                                        1.0)
    out["grid_ipm"] = dict(
        mesh=kirk_mesh, converged_single=bool(res_r.converged),
        converged_sharded=bool(res_g.converged),
        iterations_single=int(res_r.iterations),
        iterations_sharded=int(res_g.iterations), rel_df=gdrift,
        single_s=t1 - t0, sharded_s=t2 - t1)
    if not (res_g.converged and res_r.converged and gdrift < FOUR_F_TOL):
        failed.append(f"grid-sharded IPM: {out['grid_ipm']}")
    out["failed"] = failed
    return out


def _print_phase(name, result):
    shown = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in result.items()}
    print(f"phase {name}: {json.dumps(shown, default=float)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths (four cards)")
    ap.add_argument("--f64-reference", type=int, metavar="MESH",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.f64_reference:
        # child of phase (a): CPU only, never opens the card
        reference_main(args.f64_reference)
        return

    from opensim_moco_tpu.config import require_gpu, use_compilation_cache

    devices = require_gpu()
    print(card_line(devices), flush=True)
    print(f"compilation cache: {use_compilation_cache()}", flush=True)
    if args.four:
        phases = [("four", lambda: phase_four(devices))]
    else:
        phases = [("a_main_batched", run_main),
                  ("b_study_solve", phase_study)]
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        result = run()
        result["phase_s"] = time.perf_counter() - t0
        _print_phase(name, result)
        failed += [f"{name}: {f}" for f in result["failed"]]
    if failed:
        sys.exit("chip_smoke FAILED:\n" + "\n".join(failed))
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
