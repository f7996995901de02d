"""Study: problem + solver facade (MocoStudy analogue,
reference Moco/Moco/MocoStudy.h:71-182 / MocoStudy.cpp:79 solve()).

``Study.solve()`` transcribes the problem, builds/jits the interior-point
solver, runs it, and expands the flat solution into a named
:class:`~opensim_moco_tpu.utils.trajectory.Solution` — the analogue of the
reference call stack MocoStudy::solve -> MocoCasADiSolver::solveImpl ->
CasOC::Transcription::solve (SURVEY.md section 3.1), collapsed into one
jitted computation.
"""

from __future__ import annotations

import dataclasses
import time as _time

import jax
import jax.numpy as jnp
import numpy as np

from ..solver.ipm import IPMOptions, make_solver
from ..transcribe.transcription import SolverOptions, Transcription
from ..utils.trajectory import Solution
from .problem import Problem


class Study:
    def __init__(self, problem: Problem | None = None):
        self.problem = problem if problem is not None else Problem()
        self.solver_options = SolverOptions()
        self.ipm_options = IPMOptions(tol=1e-6, max_iter=1000)

    def update_problem(self) -> Problem:
        return self.problem

    def set_solver_options(self, **kwargs):
        self.solver_options = dataclasses.replace(self.solver_options,
                                                  **kwargs)

    def set_ipm_options(self, **kwargs):
        self.ipm_options = dataclasses.replace(self.ipm_options, **kwargs)

    def transcription(self) -> Transcription:
        rep = self.problem.create_rep()
        return Transcription(rep, self.solver_options)

    def _solution_iterate(self, tr, solution):
        z = getattr(solution, "raw_iterate", None)
        return z if z is not None else tr.guess_from_trajectory(solution)

    def objective_breakdown(self, solution):
        """Per-goal cost terms of a solution (reference
        printObjectiveBreakdown)."""
        tr = self.transcription()
        return tr.objective_breakdown(self._solution_iterate(tr, solution))

    def print_constraint_values(self, solution):
        """Max |violation| per constraint group (reference
        printConstraintValues diagnostics)."""
        tr = self.transcription()
        rep_vals = tr.constraint_report(self._solution_iterate(tr, solution))
        for name, v in rep_vals.items():
            print(f"  {name:<28s} max |violation| = {v:.3e}")
        return rep_vals

    def visualize(self, solution, out_path, **kwargs):
        """Render the solution as a stick-figure animation (GIF) or
        filmstrip PNG — the headless analogue of MocoStudy::visualize /
        MocoUtilities visualize (reference MocoUtilities.h:258, which
        opens the simbody-visualizer GUI)."""
        from ..utils.visualize import visualize as _vis
        return _vis(self.problem.model, solution, out_path, **kwargs)

    def analyze(self, solution, outputs):
        """Evaluate named output closures along a solution (reference
        MocoStudy::analyze<T>, MocoStudy.h:140 / OpenSim analyze,
        MocoUtilities.h:277).

        ``outputs``: {column_name: fn(rep, t, y, x, lam, p) -> scalar or
        (k,) vector} — the same signature as OutputGoal.output_fn. Returns
        an StoTable (time x outputs) ready for write_sto / plotting.
        """
        from ..utils.tables import StoTable

        tr = self.transcription()
        rep = tr.rep
        z = jnp.asarray(self._solution_iterate(tr, solution))
        t0, tf, Y, X, L, D, Gm, pcs, ecs, theta = tr.unpack(z)
        p = rep.apply_parameters(theta)
        ts = tr._grid_times(t0, tf)
        names, cols = [], []
        for name, fn in outputs.items():
            vals = jax.vmap(lambda t, y, x, lam: fn(rep, t, y, x, lam, p))(
                ts, Y, X, L)
            vals = np.asarray(jax.device_get(vals))
            if vals.ndim == 1:
                names.append(name)
                cols.append(vals)
            else:
                for k in range(vals.shape[1]):
                    names.append(f"{name}_{k}")
                    cols.append(vals[:, k])
        return StoTable(np.asarray(jax.device_get(ts)), names,
                        np.stack(cols, axis=1), {"inDegrees": "no"})

    def create_guess(self, kind="bounds", seed=0, substeps=10):
        """Flat initial iterate (reference createGuess with
        "bounds"/"random"/"time-stepping", MocoCasADiSolver.cpp:51-73);
        also accepts a Trajectory via :meth:`create_guess_from_trajectory`.

        "time-stepping": forward RK4 rollout (lax.scan) of the model under
        the bounds-midpoint controls from the bounds-midpoint initial
        state, mirroring createGuessTimeStepping (MocoSolver.cpp:26,
        simulateTrajectoryWithTimeStepping MocoUtilities.cpp:431-480).
        "random": bounds guess plus uniform perturbations within 10% of
        each variable's range (CasOCTranscription.cpp:1151-1178)."""
        import numpy as _np

        tr = self.transcription()
        z = _np.array(tr.initial_guess())
        if kind == "bounds":
            return z
        if kind == "random":
            lb, ub = tr.bounds()
            rng = _np.random.default_rng(seed)
            span = _np.where(_np.isfinite(ub - lb), ub - lb, 1.0)
            z = _np.clip(z + 0.1 * span * rng.uniform(-1, 1, z.shape),
                         _np.where(_np.isfinite(lb), lb, -_np.inf),
                         _np.where(_np.isfinite(ub), ub, _np.inf))
            return z
        if kind == "time-stepping":
            from ..utils.rollout import rollout

            rep = tr.rep
            model = rep.model
            if model.prescribed:
                # no multibody states to integrate: bounds guess
                return z
            t0, tf = z[0], z[1]
            ts = t0 + (tf - t0) * _np.asarray(tr.taus)
            o = tr.offsets
            X = z[o["controls"][0]:o["controls"][1]].reshape(tr.G, tr.nx)
            Y = z[o["states"][0]:o["states"][1]].reshape(tr.G, tr.ny)
            y0 = Y[0]
            p = rep.apply_parameters(
                z[o["params"][0]:o["params"][1]])
            traj = _np.asarray(rollout(model, p, ts, X, y0,
                                       substeps=substeps))
            # clip integrated states into the variable bounds so the
            # barrier initializer stays interior
            lb, ub = tr.bounds()
            Yl = lb[o["states"][0]:o["states"][1]].reshape(tr.G, tr.ny)
            Yu = ub[o["states"][0]:o["states"][1]].reshape(tr.G, tr.ny)
            z[o["states"][0]:o["states"][1]] = _np.clip(
                traj, Yl, Yu).ravel()
            return z
        raise NotImplementedError(kind)

    def create_guess_from_file(self, path):
        """Warm start from any written solution/trajectory .sto (reference
        guess_file, MocoDirectCollocationSolver.h:164)."""
        from ..utils.tables import sto_to_trajectory
        tr = self.transcription()
        return tr.guess_from_trajectory(sto_to_trajectory(path).unseal())

    def solve(self, guess=None, checkpoint_interval=None,
              checkpoint_path=None, interrupt_file=None,
              profile=False, profile_trace_dir=None) -> Solution:
        """Solve the study.

        ``checkpoint_interval``: dump the current iterate to
        ``checkpoint_path`` (.sto) every K interior-point iterations
        (reference output_interval, MocoCasADiSolver.h:138).
        ``interrupt_file``: abort cleanly as soon as this file disappears
        (reference FileDeletionThrower, MocoUtilities.h:717-756).
        ``profile``: time build/compile/solve stages, print the report,
        and attach it as ``solution.profile``. ``profile_trace_dir``:
        additionally capture a JAX device trace (TensorBoard/Perfetto)
        of the solve (SURVEY §5 profiling hook)."""
        import contextlib
        import os

        from ..solver.ipm import make_chunked_solver
        from ..utils.profiling import StageTimer, trace as profiler_trace

        timer = StageTimer()
        with timer.stage("transcription_build"):
            tr = self.transcription()
            rep = tr.rep
            nlp = tr.make_nlp()
            if guess is None:
                z0 = tr.initial_guess()
            elif hasattr(guess, "state_names"):
                # a Trajectory/Solution: resample onto this grid (reference
                # MocoCasADiSolver::setGuess accepts a MocoTrajectory and
                # resamples, MocoCasADiSolver.h:105-128)
                z0 = tr.guess_from_trajectory(guess)
            else:
                z0 = guess
        start = _time.perf_counter()
        device_trace = (profiler_trace(profile_trace_dir)
                        if profile_trace_dir else contextlib.nullcontext())
        if checkpoint_interval or interrupt_file:
            init_fn, run_chunk, finalize_fn = make_chunked_solver(
                nlp, self.ipm_options, scale_z0=z0)
            carry = init_fn(jnp.asarray(z0))
            chunk = int(checkpoint_interval or 25)
            limit = chunk
            while True:
                carry = run_chunk(carry, limit)
                res = finalize_fn(carry)
                it_h, conv_h = jax.device_get((res.iterations,
                                               res.converged))
                if checkpoint_path:
                    snap = self._expand(tr, rep, res, start)
                    from ..utils.tables import trajectory_to_sto
                    trajectory_to_sto(snap.unseal(), checkpoint_path)
                if bool(conv_h) or int(it_h) >= self.ipm_options.max_iter:
                    break
                if interrupt_file and not os.path.exists(interrupt_file):
                    break
                limit = int(it_h) + chunk
        else:
            with timer.stage("compile"):
                solve_fn = jax.jit(make_solver(nlp, self.ipm_options,
                                               scale_z0=z0))
                compiled = solve_fn.lower(jnp.asarray(z0)).compile() \
                    if profile else None
            with timer.stage("solve"), device_trace:
                res = (compiled if compiled is not None
                       else solve_fn)(jnp.asarray(z0))
                jax.block_until_ready(res.z)
        with timer.stage("post"):
            sol = self._expand(tr, rep, res, start)
        if profile:
            sol.profile = timer.as_dict()
            print(timer.report())
        return sol

    def _expand(self, tr, rep, res, start) -> Solution:
        # ONE device-to-host copy for everything: each transfer waits for
        # the device
        z_h, nu_h, f_h, kkt_h, it_h, conv_h = jax.device_get(
            (res.z, res.nu, res.f, res.kkt_error, res.iterations,
             res.converged))
        duration = _time.perf_counter() - start

        t0, tf, Y, X, L, D, Gm, pcs, ecs, theta = tr.unpack(z_h)
        ts = t0 + (tf - t0) * np.asarray(tr.taus)
        converged = bool(conv_h)

        deriv_names = []
        if tr.implicit_mb:
            deriv_names += [c + "/accel" for c in rep.model.coordinate_paths()]
        # reference naming (CasOCProblem.h:352-390 createIterate), so
        # solutions round-trip through guess_from_trajectory and compare
        # against golden files column-for-column
        deriv_names += [
            f"/forceset/{m}/implicitderiv_normalized_tendon_force"
            for m in rep.model._implicit_aux]

        sol = Solution(
            time=ts,
            state_names=list(rep.state_names),
            states=np.asarray(Y),
            control_names=list(rep.control_names),
            controls=np.asarray(X),
            multiplier_names=rep.model.multiplier_names(),
            multipliers=np.asarray(L),
            derivative_names=deriv_names,
            derivatives=np.asarray(D),
            parameter_names=[p.name for p in rep.parameters],
            parameters=np.asarray(theta),
            success=converged,
            status=("converged" if converged
                    else f"max iterations or stall (kkt={float(kkt_h):.2e})"),
            objective=float(f_h),
            num_iterations=int(it_h),
            solver_duration=duration,
            kkt_error=float(kkt_h),
            raw_iterate=np.asarray(z_h),
        )
        self._check_constraint_jacobian_rank(tr, rep, Y)
        if not converged:
            sol.seal()
        return sol

    def _check_constraint_jacobian_rank(self, tr, rep, Y):
        """Post-solve kinematic-constraint Jacobian rank diagnostics
        (reference MocoCasADiSolver.cpp:352-398): with kinematic
        constraints enforced without derivative enforcement or multiplier
        minimization, a rank-deficient G(q) makes the multipliers
        indeterminate — warn with the same actionable guidance."""
        import logging

        model = rep.model
        opt = tr.opt
        if (model.prescribed or not getattr(model, "nphi", 0) or
                opt.enforce_constraint_derivatives or
                opt.minimize_lagrange_multipliers):
            return
        import jax.numpy as _jnp

        p = rep.apply_parameters(np.zeros(rep.np))
        Gfun = jax.jit(lambda q: model.constraint_jacobian(p, q))
        nq = model.mech.nq
        for g in range(0, tr.G, max(1, tr.G // 8)):
            G = np.asarray(Gfun(_jnp.asarray(Y[g, :nq])))
            rank = int(np.linalg.matrix_rank(G))
            if rank < G.shape[0]:
                dashes = "-" * 52
                log = logging.getLogger("opensim_moco_tpu")
                for line in (
                        dashes,
                        "Rank-deficient constraint Jacobian detected.",
                        dashes,
                        f"The model constraint Jacobian has {G.shape[0]} "
                        f"row(s) but is only rank {rank}.",
                        "Try removing redundant constraints from the model "
                        "or enable",
                        "minimization of Lagrange multipliers by utilizing "
                        "the solver",
                        "properties 'minimize_lagrange_multipliers' and",
                        "'lagrange_multiplier_weight'.",
                        dashes):
                    log.warning(line)
                return
