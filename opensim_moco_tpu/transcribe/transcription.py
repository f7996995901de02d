"""Direct-collocation transcription: OCP -> NLP as one fused XLA graph.

Re-implements the math of the reference's transcription engines
(reference Moco/Moco/MocoCasADiSolver/CasOCTranscription.cpp:122-446,
CasOCTrapezoidal.cpp:26-60, CasOCHermiteSimpson.cpp:26-106, and the
NLP statements in Moco/doc/MocoTheoryGuide.dox:156-330) with an
accelerator-first structure:

* the per-grid-point DAE is ``vmap``-ed over the whole grid — one batched
  evaluation instead of the reference's per-point casadi callbacks behind a
  ``map("thread", N)`` pool (CasOCTranscription.cpp:1179-1225);
* all defects/quadrature are dense vector algebra on (G, ny) arrays —
  XLA fuses them with the dynamics;
* derivatives of the entire NLP come from JAX autodiff of this one graph
  (replacing CasADi finite differences + sparsity detection,
  CasOCFunction.cpp:25-105).

Variable layout in the flat decision vector z (cf. the reference's
time-grouped layout, CasOCTranscription.h:219-387)::

    [t0, tf,
     states (G, ny) row-major,
     controls (G, nx),
     multipliers (G, nlam),
     derivatives (G, nderiv),          # implicit modes
     slacks gamma (n_intervals, nphi), # HS velocity correction
     path-constraint slacks,
     endpoint-constraint slacks,
     parameters (np,)]
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..ocp.problem import ProblemRep
from ..solver.nlp import NLP


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Union of MocoDirectCollocationSolver + MocoCasADiSolver settings that
    affect transcription (reference MocoDirectCollocationSolver.h:86-174)."""
    transcription_scheme: str = "hermite-simpson"  # | "trapezoidal"
    num_mesh_intervals: int = 25
    mesh: tuple | None = None  # custom normalized mesh (n+1 taus in [0, 1])
    multibody_dynamics_mode: str = "explicit"  # | "implicit"
    enforce_constraint_derivatives: bool = True
    interpolate_control_midpoints: bool = True
    minimize_lagrange_multipliers: bool = False
    lagrange_multiplier_weight: float = 1.0
    velocity_correction_bounds: tuple = (-0.1, 0.1)
    implicit_multibody_acceleration_bounds: tuple = (-1000.0, 1000.0)
    implicit_auxiliary_derivative_bounds: tuple = (-1000.0, 1000.0)
    minimize_implicit_multibody_accelerations: bool = False
    implicit_multibody_accelerations_weight: float = 1.0
    minimize_implicit_auxiliary_derivatives: bool = False
    implicit_auxiliary_derivatives_weight: float = 1.0


class Transcription:
    """Builds the NLP for one ProblemRep + options; provides pack/unpack."""

    def __init__(self, rep: ProblemRep, options: SolverOptions):
        self.rep = rep
        self.opt = options
        model = rep.model
        self.ny = rep.ny
        self.nx = rep.nx
        self.nq = model.nq
        self.nlam = rep.nlam
        self.hermite_simpson = options.transcription_scheme == "hermite-simpson"
        if options.transcription_scheme not in ("hermite-simpson",
                                                "trapezoidal"):
            raise ValueError(options.transcription_scheme)
        self.prescribed = model.prescribed
        # prescribed kinematics + fixed time window + no free parameters:
        # every kinematic quantity in the DAE is a per-grid-point constant
        # (see Model.prescribed_point_constants) — fold it at build time
        self.fold_prescribed = bool(
            model.prescribed and not rep.parameters and
            rep.t0_bounds[0] == rep.t0_bounds[1] and
            rep.tf_bounds[0] == rep.tf_bounds[1])
        self._presc_cache = None
        # with prescribed kinematics there are no multibody states and no
        # acceleration variables; the force balance is always "implicit"
        self.implicit_mb = (options.multibody_dynamics_mode == "implicit"
                            and not self.prescribed)
        self.n_zeta = model.n_implicit_aux
        self.nderiv = (self.nq if self.implicit_mb else 0) + self.n_zeta

        # normalized mesh
        if options.mesh is not None:
            mesh = np.asarray(options.mesh, dtype=np.float64)
        else:
            mesh = np.linspace(0.0, 1.0, options.num_mesh_intervals + 1)
        self.mesh = mesh
        self.n_int = len(mesh) - 1
        if self.hermite_simpson:
            taus = np.empty(2 * self.n_int + 1)
            taus[0::2] = mesh
            taus[1::2] = 0.5 * (mesh[:-1] + mesh[1:])
            self.mesh_idx = np.arange(0, len(taus), 2)
            self.mid_idx = np.arange(1, len(taus), 2)
        else:
            taus = mesh
            self.mesh_idx = np.arange(len(taus))
            self.mid_idx = np.arange(0)
        self.taus = taus
        self.G = len(taus)

        # velocity-correction slacks only exist for HS + constraint derivs
        self.n_gamma = (self.nlam if (self.hermite_simpson and self.nlam and
                                      options.enforce_constraint_derivatives
                                      and not self.prescribed)
                        else 0)

        # quadrature weights over normalized time (multiply by duration)
        w = np.zeros(self.G)
        dtau = np.diff(mesh)
        if self.hermite_simpson:
            for i, h in enumerate(dtau):
                w[2 * i] += h / 6.0
                w[2 * i + 1] += 4.0 * h / 6.0
                w[2 * i + 2] += h / 6.0
        else:
            for i, h in enumerate(dtau):
                w[i] += h / 2.0
                w[i + 1] += h / 2.0
        self.quad_w = w

        # path-constraint slack bookkeeping: a slack per two-sided component
        self.n_pc_points = len(self.mesh_idx)
        self.pc_slack_specs = []  # (pc_index, comp_index)
        for pi, pc in enumerate(rep.path_constraints):
            for k in range(len(pc.lower)):
                if pc.lower[k] != pc.upper[k]:
                    self.pc_slack_specs.append((pi, k))
        self.n_pc_slack = len(self.pc_slack_specs) * self.n_pc_points

        # endpoint-constraint goals
        for g in rep.goals:
            if hasattr(g, "auto_outputs"):
                g.num_outputs = g.auto_outputs(rep)
        self.ec_goals = [g for g in rep.goals
                         if g.mode == "endpoint_constraint"]
        self.cost_goals = [g for g in rep.goals if g.mode == "cost"]
        self.ec_slack_specs = []
        for gi, g in enumerate(self.ec_goals):
            lo, hi = g.constraint_bounds
            if lo != hi:
                self.ec_slack_specs.append(gi)
        self.n_ec_slack = sum(self.ec_goals[gi].num_outputs
                              for gi in self.ec_slack_specs)

        self.npar = rep.np

        # ---- flat layout offsets
        sizes = {
            "t": 2,
            "states": self.G * self.ny,
            "controls": self.G * self.nx,
            "multipliers": self.G * self.nlam,
            "derivs": self.G * self.nderiv,
            "gamma": self.n_int * self.n_gamma,
            "pc_slack": self.n_pc_slack,
            "ec_slack": self.n_ec_slack,
            "params": self.npar,
        }
        self.offsets = {}
        off = 0
        for k, s in sizes.items():
            self.offsets[k] = (off, off + s)
            off += s
        self.n = off

    # ------------------------------------------------------------- packing
    def unpack(self, z):
        o = self.offsets
        t0 = z[0]
        tf = z[1]
        Y = z[o["states"][0]:o["states"][1]].reshape(self.G, self.ny)
        X = z[o["controls"][0]:o["controls"][1]].reshape(self.G, self.nx)
        L = z[o["multipliers"][0]:o["multipliers"][1]].reshape(self.G,
                                                              self.nlam)
        D = z[o["derivs"][0]:o["derivs"][1]].reshape(self.G, self.nderiv)
        Gm = z[o["gamma"][0]:o["gamma"][1]].reshape(self.n_int, self.n_gamma)
        pcs = z[o["pc_slack"][0]:o["pc_slack"][1]]
        ecs = z[o["ec_slack"][0]:o["ec_slack"][1]]
        theta = z[o["params"][0]:o["params"][1]]
        return t0, tf, Y, X, L, D, Gm, pcs, ecs, theta

    def pack(self, t0, tf, Y, X, L=None, D=None, Gm=None, pcs=None, ecs=None,
             theta=None):
        def flat(a, size):
            return (jnp.zeros(size) if a is None else jnp.ravel(a))

        o = self.offsets
        return jnp.concatenate([
            jnp.stack([jnp.asarray(t0, float), jnp.asarray(tf, float)]),
            jnp.ravel(Y), jnp.ravel(X),
            flat(L, o["multipliers"][1] - o["multipliers"][0]),
            flat(D, o["derivs"][1] - o["derivs"][0]),
            flat(Gm, o["gamma"][1] - o["gamma"][0]),
            flat(pcs, o["pc_slack"][1] - o["pc_slack"][0]),
            flat(ecs, o["ec_slack"][1] - o["ec_slack"][0]),
            flat(theta, o["params"][1] - o["params"][0]),
        ])

    # ------------------------------------------------------------- bounds
    def bounds(self):
        rep = self.rep
        lb = np.full(self.n, -np.inf)
        ub = np.full(self.n, np.inf)
        lb[0], ub[0] = rep.t0_bounds
        lb[1], ub[1] = rep.tf_bounds

        Ylo = np.tile(rep.y_lo, (self.G, 1))
        Yhi = np.tile(rep.y_hi, (self.G, 1))
        Ylo[0], Yhi[0] = rep.y0_lo, rep.y0_hi
        Ylo[-1], Yhi[-1] = rep.yf_lo, rep.yf_hi
        o = self.offsets
        lb[o["states"][0]:o["states"][1]] = Ylo.ravel()
        ub[o["states"][0]:o["states"][1]] = Yhi.ravel()

        Xlo = np.tile(rep.x_lo, (self.G, 1))
        Xhi = np.tile(rep.x_hi, (self.G, 1))
        if self.G > 0:
            Xlo[0], Xhi[0] = rep.x0_lo, rep.x0_hi
            Xlo[-1], Xhi[-1] = rep.xf_lo, rep.xf_hi
        lb[o["controls"][0]:o["controls"][1]] = Xlo.ravel()
        ub[o["controls"][0]:o["controls"][1]] = Xhi.ravel()

        if self.nlam:
            lb[o["multipliers"][0]:o["multipliers"][1]] = rep.lam_bounds[0]
            ub[o["multipliers"][0]:o["multipliers"][1]] = rep.lam_bounds[1]
        if self.nderiv:
            dlo = []
            dhi = []
            if self.implicit_mb:
                dlo += [self.opt.implicit_multibody_acceleration_bounds[0]] * \
                    self.nq
                dhi += [self.opt.implicit_multibody_acceleration_bounds[1]] * \
                    self.nq
            dlo += [self.opt.implicit_auxiliary_derivative_bounds[0]] * \
                self.n_zeta
            dhi += [self.opt.implicit_auxiliary_derivative_bounds[1]] * \
                self.n_zeta
            lb[o["derivs"][0]:o["derivs"][1]] = np.tile(dlo, self.G)
            ub[o["derivs"][0]:o["derivs"][1]] = np.tile(dhi, self.G)
        if self.n_gamma:
            lb[o["gamma"][0]:o["gamma"][1]] = \
                self.opt.velocity_correction_bounds[0]
            ub[o["gamma"][0]:o["gamma"][1]] = \
                self.opt.velocity_correction_bounds[1]
        # path-constraint slacks: bounds are the constraint's bounds
        k = 0
        for (pi, comp) in self.pc_slack_specs:
            pc = rep.path_constraints[pi]
            for _ in range(self.n_pc_points):
                lb[o["pc_slack"][0] + k] = pc.lower[comp]
                ub[o["pc_slack"][0] + k] = pc.upper[comp]
                k += 1
        k = 0
        for gi in self.ec_slack_specs:
            g = self.ec_goals[gi]
            for _ in range(g.num_outputs):
                lb[o["ec_slack"][0] + k] = g.constraint_bounds[0]
                ub[o["ec_slack"][0] + k] = g.constraint_bounds[1]
                k += 1
        if self.npar:
            lb[o["params"][0]:o["params"][1]] = rep.param_lo
            ub[o["params"][0]:o["params"][1]] = rep.param_hi
        # numpy on purpose: the solver embeds these as constants when it
        # traces, so building them needs no device round-trip
        return lb, ub

    # ----------------------------------------------------------- dynamics
    def _grid_times(self, t0, tf):
        taus = jnp.asarray(self.taus, dtype=t0.dtype)
        return t0 + (tf - t0) * taus

    def _pointwise(self, p, t, y, x, lam, d):
        """DAE at one grid point.

        Returns (ydot (ny,), alg (n_alg,)) where alg stacks the implicit
        multibody residual and implicit auxiliary residuals.
        """
        m = self.rep.model
        if m.prescribed:
            # prescribed kinematics (MocoInverse path): multibody states
            # are known functions of time; dynamics reduce to a net
            # force balance at every grid point
            # (MocoTheoryGuide.dox "Prescribed kinematics")
            q, u, udot_hat = m.position_motion(p, t)
            zz = y
            zeta = d[:self.n_zeta] if self.n_zeta else None
            res = m.multibody_implicit_residual(p, t, q, u, zz, x, lam,
                                                udot_hat)
            alg = [res]
            if self.n_zeta:
                alg.append(m.implicit_aux_residuals(p, t, q, u, zz, x, zeta))
            zdot = m.aux_dynamics(p, t, q, u, zz, x, zeta)
            return zdot, jnp.concatenate(alg), udot_hat
        q, u, zz = m.split_state(y)
        zeta = d[self.nq:] if self.implicit_mb else d[:self.n_zeta] \
            if self.n_zeta else None
        alg = []
        if self.implicit_mb:
            udot = d[:self.nq]
            res = m.multibody_implicit_residual(p, t, q, u, zz, x, lam, udot)
            alg.append(res)
        else:
            udot = m.multibody_explicit(p, t, q, u, zz, x, lam)
        if self.n_zeta:
            alg.append(m.implicit_aux_residuals(p, t, q, u, zz, x, zeta))
        zdot = m.aux_dynamics(p, t, q, u, zz, x, zeta)
        ydot = jnp.concatenate([u, udot, zdot])
        algv = (jnp.concatenate(alg) if alg
                else jnp.zeros(0, dtype=y.dtype))
        return ydot, algv, udot

    def _kc_errors(self, p, q, u, udot):
        """phi, phidot = G u, phiddot = d/dt(G u) at one mesh point
        (reference MocoCasOCProblem.h:668-736)."""
        m = self.rep.model
        phi = m.phi(p, q)
        if not self.opt.enforce_constraint_derivatives:
            return phi, jnp.zeros(0, dtype=q.dtype), jnp.zeros(0,
                                                               dtype=q.dtype)
        phidot_fn = lambda qq, uu: jax.jvp(lambda qv: m.phi(p, qv), (qq,),
                                           (uu,))[1]
        phidot = phidot_fn(q, u)
        _, phiddot = jax.jvp(lambda qq, uu: phidot_fn(qq, uu), (q, u),
                             (u, udot))
        return phi, phidot, phiddot

    def _prescribed_constants(self):
        """Per-grid-point constants for the folded prescribed-kinematics
        path (numpy pytree of (G, ...) arrays), computed once per
        transcription. See Model.prescribed_point_constants."""
        if self._presc_cache is None:
            rep = self.rep
            m = rep.model
            p = rep.apply_parameters(jnp.zeros(0))
            t0 = float(rep.t0_bounds[0])
            tf = float(rep.tf_bounds[0])
            ts = jnp.asarray(t0 + (tf - t0) * self.taus)
            # eager on purpose: jit-compiling the full FK/RNEA/moment-arm
            # graph takes minutes on compile-bound hosts; this runs once
            consts = jax.vmap(
                lambda t: m.prescribed_point_constants(p, t))(ts)
            self._presc_cache = jax.tree.map(np.asarray,
                                             jax.device_get(consts))
        return self._presc_cache

    # ---------------------------------------------------------- constraints
    def constraints_fn(self):
        rep = self.rep
        m = rep.model
        Cnp = self._prescribed_constants() if self.fold_prescribed else None

        def constraints(z):
            t0, tf, Y, X, L, D, Gm, pcs, ecs, theta = self.unpack(z)
            p = rep.apply_parameters(theta)
            ts = self._grid_times(t0, tf)
            h = (tf - t0) * jnp.asarray(np.diff(self.mesh), dtype=z.dtype)

            if Cnp is not None:
                C = jax.tree.map(lambda a: jnp.asarray(a, dtype=z.dtype),
                                 Cnp)

                def point_c(c, y, x, lam, d):
                    zeta = d[:self.n_zeta] if self.n_zeta else None
                    pk = (c["lMT"], c["vMT"])
                    alg = [m.prescribed_residual_cached(p, c, y, x, lam)]
                    if self.n_zeta:
                        alg.append(m.implicit_aux_residuals(
                            p, c["t"], c["q"], c["u"], y, x, zeta,
                            path_kin=pk))
                    zdot = m.aux_dynamics(p, c["t"], c["q"], c["u"], y, x,
                                          zeta, path_kin=pk)
                    return zdot, jnp.concatenate(alg), c["udot"]

                F, ALG, UDOT = jax.vmap(point_c)(C, Y, X, L, D)
            else:
                point = lambda t, y, x, lam, d: self._pointwise(
                    p, t, y, x, lam, d)
                F, ALG, UDOT = jax.vmap(point)(ts, Y, X, L, D)

            out = []
            # --- defect constraints
            if self.hermite_simpson:
                i0 = self.mesh_idx[:-1]
                i1 = self.mesh_idx[1:]
                im = self.mid_idx
                y0, y1, ym = Y[i0], Y[i1], Y[im]
                f0, f1, fm = F[i0], F[i1], F[im]
                hcol = h[:, None]
                hermite = ym - 0.5 * (y0 + y1) - hcol / 8.0 * (f0 - f1)
                if self.n_gamma:
                    # Posa velocity correction on the q rows:
                    # qbar = hermite(q) + G(qbar)^T gamma
                    # (MocoTheoryGuide.dox:322-330). The gamma freedom is
                    # pinned by requiring the corrected midpoint to lie on
                    # the constraint manifold, phi(qbar) = 0 — otherwise the
                    # optimizer can rail gamma and evaluate midpoint
                    # dynamics off-manifold.
                    qmid = ym[:, :self.nq]
                    Gt_gamma = jax.vmap(
                        lambda qq, gg: m.constraint_jacobian(p, qq).T @ gg)(
                            qmid, Gm)
                    hermite = hermite.at[:, :self.nq].add(-Gt_gamma)
                    phi_mid = jax.vmap(lambda qq: m.phi(p, qq))(qmid)
                    out.append(phi_mid.ravel())
                simpson = y1 - y0 - hcol / 6.0 * (f0 + 4.0 * fm + f1)
                out.append(hermite.ravel())
                out.append(simpson.ravel())
                if self.nx and self.opt.interpolate_control_midpoints:
                    out.append((X[im] - 0.5 * (X[i0] + X[i1])).ravel())
            else:
                y0, y1 = Y[:-1], Y[1:]
                f0, f1 = F[:-1], F[1:]
                out.append((y1 - y0 - 0.5 * h[:, None] * (f0 + f1)).ravel())

            # --- algebraic residuals (implicit modes) at every grid point
            if ALG.shape[-1]:
                out.append(ALG.ravel())

            # --- kinematic constraint errors at mesh points (prescribed
            # kinematics: phi(q_hat) is data, not a function of decision
            # variables; multipliers enter through the force balance only)
            if self.nlam and not self.prescribed:
                Q = Y[:, :self.nq]
                U = Y[:, self.nq:2 * self.nq]
                idx = self.mesh_idx
                kc = jax.vmap(lambda q, u, ud: self._kc_errors(p, q, u, ud))(
                    Q[idx], U[idx], UDOT[idx])
                out.append(jnp.concatenate([kc[0].ravel(), kc[1].ravel(),
                                            kc[2].ravel()]))

            # --- path constraints at mesh points, minus slack if two-sided
            if rep.path_constraints:
                idx = self.mesh_idx
                spos = 0
                for pi, pc in enumerate(rep.path_constraints):
                    vals = jax.vmap(
                        lambda t, y, x, lam: pc.fn(rep, t, y, x, lam, p))(
                            ts[idx], Y[idx], X[idx], L[idx])
                    vals = vals.reshape(len(idx), -1)
                    for k in range(len(pc.lower)):
                        col = vals[:, k]
                        if pc.lower[k] == pc.upper[k]:
                            out.append(col - pc.lower[k])
                        else:
                            sl = pcs[spos * self.n_pc_points:
                                     (spos + 1) * self.n_pc_points]
                            out.append(col - sl)
                            spos += 1

            # --- endpoint-constraint goals (tuples: t, y, x, lam, deriv)
            if self.ec_goals:
                initial = (ts[0], Y[0], X[0],
                           L[0] if self.nlam else jnp.zeros(0, z.dtype),
                           D[0])
                final = (ts[-1], Y[-1], X[-1],
                         L[-1] if self.nlam else jnp.zeros(0, z.dtype),
                         D[-1])
                spos = 0
                for gi, g in enumerate(self.ec_goals):
                    vals = g.values(rep, initial, final, p)
                    if gi in self.ec_slack_specs:
                        k = vals.shape[0]
                        out.append(vals - ecs[spos:spos + k])
                        spos += k
                    else:
                        lo = g.constraint_bounds[0]
                        out.append(vals - lo)

            return (jnp.concatenate(out) if out
                    else jnp.zeros(0, dtype=z.dtype))

        return constraints

    # ------------------------------------------------------------ objective
    def objective_fn(self):
        rep = self.rep

        def objective(z):
            t0, tf, Y, X, L, D, Gm, pcs, ecs, theta = self.unpack(z)
            p = rep.apply_parameters(theta)
            ts = self._grid_times(t0, tf)
            w = (tf - t0) * jnp.asarray(self.quad_w, dtype=z.dtype)
            total = jnp.zeros((), dtype=z.dtype)
            initial = (ts[0], Y[0], X[0],
                       L[0] if self.nlam else jnp.zeros(0, z.dtype), D[0])
            final = (ts[-1], Y[-1], X[-1],
                     L[-1] if self.nlam else jnp.zeros(0, z.dtype), D[-1])
            for g in self.cost_goals:
                integrand = jax.vmap(
                    lambda t, y, x, lam: g.integrand(rep, t, y, x, lam, p))(
                        ts, Y, X, L)
                S = jnp.sum(w * integrand)
                total = total + g.weight * g.value(rep, initial, final, S, p)
            if self.opt.minimize_lagrange_multipliers and self.nlam:
                lam2 = jnp.sum(L * L, axis=1)
                total = total + self.opt.lagrange_multiplier_weight * \
                    jnp.sum(w * lam2)
            if (self.opt.minimize_implicit_multibody_accelerations and
                    self.implicit_mb):
                a2 = jnp.sum(D[:, :self.nq] ** 2, axis=1)
                total = total + \
                    self.opt.implicit_multibody_accelerations_weight * \
                    jnp.sum(w * a2)
            if (self.opt.minimize_implicit_auxiliary_derivatives and
                    self.n_zeta):
                zoff = self.nq if self.implicit_mb else 0
                d2 = jnp.sum(D[:, zoff:] ** 2, axis=1)
                total = total + \
                    self.opt.implicit_auxiliary_derivatives_weight * \
                    jnp.sum(w * d2)
            return total

        return objective

    # ------------------------------------------------------------ diagnostics
    def constraint_group_info(self):
        """(name, size) per constraint block, in assembly order (must stay
        in sync with constraints_fn). Powers the printConstraintValues-style
        diagnostics (reference CasOCTranscription.cpp:723-1102)."""
        rep = self.rep
        groups = []
        ny, nq = self.ny, self.nq
        if self.hermite_simpson:
            if self.n_gamma:
                groups.append(("midpoint_manifold_phi",
                               self.n_int * self.rep.nlam))
            groups.append(("hermite_defect", self.n_int * ny))
            groups.append(("simpson_defect", self.n_int * ny))
            if self.nx and self.opt.interpolate_control_midpoints:
                groups.append(("control_midpoint", self.n_int * self.nx))
        else:
            groups.append(("trapezoidal_defect", self.n_int * ny))
        n_alg = ((nq if self.implicit_mb else 0) + self.n_zeta +
                 (nq if self.prescribed else 0))
        if n_alg:
            groups.append(("dae_residual", self.G * n_alg))
        if self.nlam and not self.prescribed:
            nkc = len(self.mesh_idx)
            k = self.rep.nlam
            mult = 3 if self.opt.enforce_constraint_derivatives else 1
            groups.append(("kinematic_constraint", nkc * k * mult))
        for pc in rep.path_constraints:
            groups.append((f"path:{pc.name}",
                           self.n_pc_points * len(pc.lower)))
        for g in self.ec_goals:
            groups.append((f"endpoint:{g.name}", g.num_outputs))
        return groups

    def objective_breakdown(self, z):
        """Per-goal cost terms at an iterate (reference
        printObjectiveBreakdown, CasOCTranscription.cpp:700-706)."""
        import jax

        rep = self.rep
        z = jnp.asarray(z)
        t0, tf, Y, X, L, D, Gm, pcs, ecs, theta = self.unpack(z)
        p = rep.apply_parameters(theta)
        ts = self._grid_times(t0, tf)
        w = (tf - t0) * jnp.asarray(self.quad_w, dtype=z.dtype)
        initial = (ts[0], Y[0], X[0],
                   L[0] if self.nlam else jnp.zeros(0, z.dtype), D[0])
        final = (ts[-1], Y[-1], X[-1],
                 L[-1] if self.nlam else jnp.zeros(0, z.dtype), D[-1])
        out = {}
        for g in self.cost_goals:
            integrand = jax.vmap(
                lambda t, y, x, lam: g.integrand(rep, t, y, x, lam, p))(
                    ts, Y, X, L)
            S = jnp.sum(w * integrand)
            out[g.name] = float(g.weight *
                                g.value(rep, initial, final, S, p))
        return out

    def constraint_report(self, z):
        """Max |violation| per constraint group at an iterate."""
        c = np.asarray(self.constraints_fn()(jnp.asarray(z)))
        report = {}
        off = 0
        for name, size in self.constraint_group_info():
            seg = c[off:off + size]
            report[name] = float(np.max(np.abs(seg))) if size else 0.0
            off += size
        assert off == len(c), (off, len(c), "constraint group info out of "
                               "sync with constraints_fn")
        return report

    # ------------------------------------------------------- KKT structure
    def kkt_structure(self):
        """Time-grouped block structure of the NLP (see
        solver.nlp.KKTStructure): variables/constraints of mesh interval i
        form block i; times, parameters, endpoint constraints and their
        slacks form the border. Enables the bordered block-tridiagonal KKT
        factorization (O(N nb^3), the same sparsity the reference documents
        at CasOCTranscription.h:219-387 and hands to MUMPS inside IPOPT).

        Validity requires that no cost-mode goal contributes cross-block
        curvature (endpoint-constraint goals are fine — their rows live in
        the border); each goal declares this via Goal.hessian_block_local()
        (conservative default: any overridden ``value`` is unsafe), so e.g.
        PeriodicityGoal/AverageSpeedGoal in cost mode or a CustomGoal with
        a value_fn return None here and the solver falls back to the dense
        path.
        """
        from ..solver.nlp import KKTStructure

        N = self.n_int
        if N < 2:
            return None
        for g in self.cost_goals:
            if not g.hessian_block_local():
                return None
        o = self.offsets

        def var_ids(kind, g, per):
            start = o[kind][0] + g * per
            return list(range(start, start + per))

        def blk_of_grid(g):
            return min(g // 2 if self.hermite_simpson else g, N - 1)

        blocks_v = [[] for _ in range(N)]
        border_v = [0, 1]
        for g in range(self.G):
            b = blocks_v[blk_of_grid(g)]
            b += var_ids("states", g, self.ny)
            b += var_ids("controls", g, self.nx)
            b += var_ids("multipliers", g, self.nlam)
            b += var_ids("derivs", g, self.nderiv)
        for i in range(N):
            blocks_v[i] += var_ids("gamma", i, self.n_gamma)
        npts = self.n_pc_points
        for spos in range(len(self.pc_slack_specs)):
            for j in range(npts):
                blocks_v[min(j, N - 1)].append(
                    o["pc_slack"][0] + spos * npts + j)
        border_v += list(range(o["ec_slack"][0], o["ec_slack"][1]))
        border_v += list(range(o["params"][0], o["params"][1]))

        # constraint rows, mirroring constraints_fn assembly order exactly
        blocks_c = [[] for _ in range(N)]
        border_c = []
        off = 0

        def rows_interval_major(per):
            nonlocal off
            for i in range(N):
                blocks_c[i] += list(range(off, off + per))
                off += per

        def rows_grid_major(per):
            nonlocal off
            for g in range(self.G):
                blocks_c[blk_of_grid(g)] += list(range(off, off + per))
                off += per

        def rows_mesh_major(per):
            nonlocal off
            for j in range(len(self.mesh_idx)):
                blocks_c[min(j, N - 1)] += list(range(off, off + per))
                off += per

        rep = self.rep
        ny, nq = self.ny, self.nq
        if self.hermite_simpson:
            if self.n_gamma:
                rows_interval_major(rep.nlam)  # midpoint manifold phi
            rows_interval_major(ny)  # hermite
            rows_interval_major(ny)  # simpson
            if self.nx and self.opt.interpolate_control_midpoints:
                rows_interval_major(self.nx)
        else:
            rows_interval_major(ny)  # trapezoidal defect
        n_alg = ((nq if self.implicit_mb else 0) + self.n_zeta +
                 (nq if self.prescribed else 0))
        if n_alg:
            rows_grid_major(n_alg)
        if self.nlam and not self.prescribed:
            mult = 3 if self.opt.enforce_constraint_derivatives else 1
            for _ in range(mult):  # phi, phidot, phiddot sub-arrays
                rows_mesh_major(rep.nlam)
        for pc in rep.path_constraints:
            for _ in range(len(pc.lower)):
                rows_mesh_major(1)
        for g in self.ec_goals:
            border_c += list(range(off, off + g.num_outputs))
            off += g.num_outputs

        return KKTStructure(var_blocks=blocks_v, con_blocks=blocks_c,
                            border_vars=np.asarray(border_v, np.int64),
                            border_cons=np.asarray(border_c, np.int64))

    # ---------------------------------------------------------------- NLP
    def make_nlp(self) -> NLP:
        lb, ub = self.bounds()
        cfn = self.constraints_fn()
        # constraint count via eval on zeros (abstract eval, no FLOPs)
        m_count = jax.eval_shape(cfn, jax.ShapeDtypeStruct((self.n,),
                                                           jnp.float64
                                                           if jax.config.jax_enable_x64
                                                           else jnp.float32)
                                 ).shape[0]
        return NLP(n=self.n, m=int(m_count), objective=self.objective_fn(),
                   constraints=cfn, lb=lb, ub=ub,
                   structure=self.kkt_structure())

    # --------------------------------------------------------------- guess
    def guess_from_trajectory(self, traj, dtype=None):
        """Flat iterate from a Trajectory/Solution (the reference's
        guess_file warm start, MocoDirectCollocationSolver.h:164; resampled
        onto this transcription's grid like Iterate::resample)."""
        z = np.array(self.initial_guess(dtype=dtype))
        t0 = traj.initial_time
        tf = traj.final_time
        z[0], z[1] = t0, tf
        ts = t0 + (tf - t0) * np.asarray(self.taus)
        res = traj.resample(ts)
        o = self.offsets
        Y = z[o["states"][0]:o["states"][1]].reshape(self.G, self.ny)
        for i, n in enumerate(self.rep.state_names):
            if n in res.state_names:
                Y[:, i] = res.state(n)
        z[o["states"][0]:o["states"][1]] = Y.ravel()
        X = z[o["controls"][0]:o["controls"][1]].reshape(self.G, self.nx)
        for i, n in enumerate(self.rep.control_names):
            if n in res.control_names:
                X[:, i] = res.control(n)
        z[o["controls"][0]:o["controls"][1]] = X.ravel()
        if self.nlam and res.multipliers is not None and \
                res.multipliers.shape[1] == self.nlam:
            z[o["multipliers"][0]:o["multipliers"][1]] = \
                res.multipliers.ravel()
        # implicit-auxiliary derivative variables (implicitderiv_* columns
        # in reference solutions)
        if self.nderiv and res.derivatives is not None:
            D = z[o["derivs"][0]:o["derivs"][1]].reshape(
                self.G, self.nderiv)
            # layout: nq accel columns first (implicit multibody), then
            # implicit-aux (tendon-force) derivative columns
            n_accel = self.nq if self.implicit_mb else 0
            accel_names = [f"{c}/accel"
                           for c in self.rep.model.coordinate_paths()]
            aux_names = [
                f"/forceset/{mn}/implicitderiv_normalized_tendon_force"
                for mn in self.rep.model._implicit_aux]
            for i, n in enumerate(accel_names[:n_accel] + aux_names):
                if n in res.derivative_names:
                    D[:, i] = res.derivatives[
                        :, list(res.derivative_names).index(n)]
            z[o["derivs"][0]:o["derivs"][1]] = D.ravel()
        return z

    def initial_guess(self, dtype=None):
        """Bounds-midpoint guess (reference default,
        CasOCTranscription.cpp:1123-1150): midpoint where both bounds are
        finite, else the finite bound, else zero."""
        lb, ub = self.bounds()
        with np.errstate(invalid="ignore"):  # inf + -inf on unbounded vars
            mid = np.where(np.isfinite(lb) & np.isfinite(ub),
                           0.5 * (lb + ub),
                           np.where(np.isfinite(lb), lb,
                                    np.where(np.isfinite(ub), ub, 0.0)))
        if dtype is None:
            dtype = (np.float64 if jax.config.jax_enable_x64
                     else np.float32)
        return mid.astype(dtype)  # numpy: no device round-trip at build
