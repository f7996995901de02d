"""Batched primal-dual interior-point NLP solver in pure JAX.

This replaces the reference's L1 layer (IPOPT + MUMPS behind CasADi /
tropter bridges, reference CasOCTranscription.cpp:677-692 and
tropter/optimization/IPOPTSolver.cpp:32-89) with a jit-able, vmap-able,
shard_map-able re-implementation of the Waechter-Biegler algorithm:

* exact gradients / constraint Jacobians / Lagrangian Hessians via JAX
  autodiff on the fused transcription graph — this deletes the reference's
  entire finite-difference + sparsity-detection + ADOL-C/ColPack machinery;
* the IPOPT algorithmic skeleton — monotone Fiacco-McCormick barrier
  schedule, fraction-to-boundary rule, primal-dual bound duals with
  kappa-Sigma safeguarding, **filter line search** with second-order
  correction and a feasibility fallback, inertia-free regularization
  (directional-curvature test of Chiang & Zavala 2016 instead of LBL^T
  inertia counts, which have no batched factorization in XLA) — expressed as a
  single `lax.while_loop`, so an entire solve is ONE XLA computation;
* variables with equal bounds (pinned times/initial states) are eliminated
  (IPOPT fixed_variable_treatment=make_parameter);
* dense KKT factorization by default (right for Moco-scale problems
  batched across lanes); structured block-banded kernels plug in behind the
  same interface.

The whole solver runs under `vmap`: thousands of trajectory optimizations
solve simultaneously per chip, each lane with its own convergence flag.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .nlp import NLP

FILTER_SIZE = 64


@dataclasses.dataclass(frozen=True)
class IPMOptions:
    tol: float = 1e-6
    max_iter: int = 500
    mu_init: float = 1e-1
    mu_min_factor: float = 1.0 / 11.0  # mu_min = tol * factor
    # barrier-subproblem exit: decrease mu when err(mu) <= kappa_eps * mu
    # (IPOPT default 10). A static looser gate is NOT safe: 100 fixes the
    # barrier-pressure orbits (linear tangent) but strands free-final-time
    # bang-bang solves whose mu must not outrun the switching structure
    # (minT mesh-50, sliding-mass tol-1e-8, r5 measurements). The
    # mu_force_iter watchdog below supplies the loosening adaptively.
    kappa_eps: float = 10.0
    # barrier watchdog: after this many consecutive STAGNANT accepted
    # steps (step accepted but the KKT error did not drop by >10%) without
    # a mu decrease, force one. Error floors caused by barrier pressure
    # itself (full steps accepted forever while err(mu) > kappa_eps*mu —
    # the linear-tangent orbit) break within one window; rejection storms
    # never force (rejected steps don't count) and healthy slow phases
    # never force (improving error resets the counter), which protects
    # the bang-bang and muscle families from a runaway schedule.
    mu_force_iter: int = 10
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    tau_min: float = 0.99
    kappa_sigma: float = 1e10
    bound_relax: float = 1e-8
    bound_push: float = 1e-2
    delta_w_init: float = 1e-8
    delta_w_max: float = 1e10
    max_ls: int = 12  # candidate-parallel line-search trial count
    max_reg: int = 12  # regularization retries
    # "solved to acceptable level" exit (IPOPT acceptable_tol /
    # acceptable_iter): stop after this many consecutive iterations within
    # factor * tol of the KKT conditions; the best iterate seen is returned
    acceptable_tol_factor: float = 100.0  # IPOPT: acceptable_tol/tol = 100
    acceptable_iter: int = 15
    # non-monotone mu rescues per solve (see body_fn): unlimited rescues
    # let hard lanes limit-cycle between mu pump-up and decrease, pinning
    # their KKT error near mu_init forever
    max_rescues: int = 4
    # "exact": Lagrangian Hessian via forward-over-reverse autodiff.
    # "objective-only": drop constraint curvature (Gauss-Newton-flavored;
    # the reference runs IPOPT with limited-memory BFGS by default,
    # MocoDirectCollocationSolver.h:121, so it never sees exact curvature
    # either) — much cheaper to compile/evaluate on large models.
    hessian_approximation: str = "exact"
    # filter parameters (IPOPT defaults, Waechter-Biegler 2006 Table 1)
    gamma_theta: float = 1e-5
    gamma_phi: float = 1e-5
    s_theta: float = 1.1
    s_phi: float = 2.3
    delta_switch: float = 1.0
    eta_phi: float = 1e-8
    # KKT derivative/linear-solver mode:
    # * "dense": full opt-out from structure — exact jacfwd/hess_L autodiff
    #   and one dense factorization of the KKT (no compressed block
    #   derivatives), the escape hatch for problems violating the
    #   block-sparsity contract;
    # * "structured": compressed block derivatives + bordered block-
    #   tridiagonal factorization over the time axis, O(N nb^3); requires
    #   the NLP to carry a KKTStructure — transcription NLPs do;
    # * "auto": compressed block derivatives whenever a structure is
    #   available; block-tridiagonal factorization when the KKT dimension
    #   is large enough for it to win, dense factorization otherwise.
    kkt: str = "auto"
    # not yet re-measured on the GPU (ROADMAP S5)
    kkt_structured_min_dim: int = 1200
    # dense-path factorization:
    # * "lu": one pivoted LU of the full (n+m) KKT;
    # * "chol-schur": Cholesky of Hd = H + Sigma + delta I and of the Schur
    #   complement J Hd^-1 J^T + delta_c I — pivot-free, and the heavy ops
    #   (triangular solve with m right-hand sides, Y^T Y) are matmul-shaped,
    #   unlike LU's sequential pivoted panels. Requires Hd positive
    #   definite: an indefinite trial produces NaNs, which the inertia-free
    #   regularization loop already treats as "escalate delta" — the same
    #   effect as IPOPT's inertia correction.
    # The default is not yet re-measured on the GPU (ROADMAP S5).
    dense_factorization: str = "lu"
    # equality-multiplier initialization. "least-squares" solves
    # [[I, J^T],[J, -dc I]][r; nu0] = [-(grad f - wL0 + wU0); 0] at the
    # start point (IPOPT's least_square_init_multipliers) and keeps nu0
    # when ||nu0||_inf <= 1e3. Essential for warm starts: with z near the
    # optimum but nu = 0 the scaled dual error starts huge (measured ~140
    # on the gait2d tracked-states start) and the line search closes it at
    # tiny steps over hundreds of iterations. "zero" starts nu at 0.
    init_multipliers: str = "least-squares"
    # iterative refinement passes on every KKT solve: recompute the KKT
    # residual in operator form (H matvec + constraint jvp/vjp) and solve
    # for a correction with the SAME factorization. Recovers most of the
    # accuracy a higher-precision factorization would give — the
    # fp32-factor + refinement scheme of SURVEY §7 for float32 solves.
    kkt_refine_iters: int = 0


class IPMResult(NamedTuple):
    z: jnp.ndarray
    nu: jnp.ndarray
    f: jnp.ndarray
    kkt_error: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray


class Carry(NamedTuple):
    z: jnp.ndarray
    nu: jnp.ndarray
    wL: jnp.ndarray
    wU: jnp.ndarray
    mu: jnp.ndarray
    it: jnp.ndarray
    converged: jnp.ndarray
    kkt: jnp.ndarray
    alpha_last: jnp.ndarray
    delta_last: jnp.ndarray
    filter_theta: jnp.ndarray  # (FILTER_SIZE,)
    filter_phi: jnp.ndarray  # (FILTER_SIZE,)
    filter_count: jnp.ndarray
    theta_scale: jnp.ndarray  # max(1, theta(z0)) for theta_min/theta_max
    best_z: jnp.ndarray  # best-KKT iterate seen so far
    best_nu: jnp.ndarray
    best_kkt: jnp.ndarray
    acceptable_count: jnp.ndarray
    rescue_count: jnp.ndarray
    stall_count: jnp.ndarray  # consecutive fully-rejected iterations
    mu_wait: jnp.ndarray  # accepted steps since the last mu decrease


def _inf_norm(x):
    return jnp.max(jnp.abs(x)) if x.size else jnp.zeros(())


def _highest_precision(fn):
    """Trace ``fn`` with every float32 matmul at full precision.

    By default a GPU runs float32 dots in TF32, which keeps about three
    decimal digits and poisons the Jacobians and Newton systems of the
    interior-point iteration.
    """
    @functools.wraps(fn)
    def wrapped(*args):
        with jax.default_matmul_precision("highest"):
            return fn(*args)

    return wrapped


def gradient_scaling(nlp: NLP, cs_full, scale_z0, gmax: float = 100.0):
    """IPOPT gradient-based NLP scaling at ``scale_z0``: returns
    ``(f_scale, c_scale)`` so that the objective gradient and each
    constraint row's gradient have inf-norm at most ``gmax`` there.

    Evaluated once, jitted on the default device at full matmul precision.
    With a KKT structure (``cs_full``), Jacobian row norms come from the
    compressed 2-coloring pass (O(nv) tangents) instead of a dense jacfwd
    (O(n) tangents).
    """
    with jax.default_matmul_precision("highest"):
        z0 = jnp.asarray(np.asarray(scale_z0))
        g0 = jax.device_get(jax.jit(jax.grad(nlp.objective))(z0))
        if not nlp.m:
            row_norms = np.ones(0)
        elif cs_full is not None:
            from .structured import BlockDerivatives
            row_norms = BlockDerivatives(
                cs_full, nlp.constraints, nlp.objective).jac_row_inf_norms(z0)
        else:
            J0 = jax.device_get(jax.jit(jax.jacfwd(nlp.constraints))(z0))
            row_norms = np.max(np.abs(J0), axis=1)
    f_scale = float(min(1.0, gmax / max(np.max(np.abs(g0)), 1e-8)))
    c_scale = np.minimum(1.0, gmax / np.maximum(row_norms, 1e-8))
    return f_scale, c_scale


def make_kernel(nlp: NLP, options: IPMOptions = IPMOptions(),
                scale_z0=None, grid_mesh=None, grid_axis="grid"):
    """Build (init_fn, body_fn, cond_fn, finalize_fn) for the IP iteration.

    Exposed separately from :func:`make_solver` for observability: a driver
    can jit ``body_fn`` once and print per-iteration diagnostics (the
    analogue of the IPOPT iteration log the reference relies on).

    ``scale_z0``: reference point for IPOPT-style gradient-based NLP
    scaling (nlp_scaling_method=gradient-based): objective and each
    constraint row are scaled so their gradient inf-norm at this point is
    at most 100. Essential for multibody problems mixing N, m, s units.

    ``grid_mesh``/``grid_axis``: a `jax.sharding.Mesh` to shard the KKT
    factorization of ONE large problem over its mesh-interval axis
    (SURVEY §2.8; sparsity anchor CasOCTranscription.h:219-387). Every
    KKT solve runs the parallel-in-time partition/SPIKE kernel
    (kkt.bordered_block_tridiag_solve_partitioned) under `shard_map`,
    with the border Schur complement reduced by `psum` across devices.
    Requires a structured NLP (a transcription KKTStructure).
    """
    opt = options
    if opt.kkt not in ("auto", "dense", "structured"):
        raise ValueError(f"kkt must be auto|dense|structured, got "
                         f"{opt.kkt!r}")
    if opt.dense_factorization not in ("lu", "chol-schur"):
        raise ValueError(f"dense_factorization must be lu|chol-schur, got "
                         f"{opt.dense_factorization!r}")
    structure_full = nlp.structure
    cs_full = None
    if nlp.m and structure_full is not None:
        from .kkt import CompiledStructure
        cs_full = CompiledStructure(
            structure_full.var_blocks, structure_full.con_blocks,
            structure_full.border_vars, structure_full.border_cons,
            nlp.n, nlp.m)

    f_unscale = 1.0
    if scale_z0 is not None:
        f_scale, c_scale = gradient_scaling(nlp, cs_full, scale_z0)
        f_unscale = 1.0 / f_scale
        c_scale_j = jnp.asarray(c_scale)
        base_obj, base_con = nlp.objective, nlp.constraints
        nlp = NLP(n=nlp.n, m=nlp.m,
                  objective=lambda z: f_scale * base_obj(z),
                  constraints=lambda z: c_scale_j.astype(z.dtype) *
                  base_con(z),
                  lb=nlp.lb, ub=nlp.ub)

    lb_np = np.asarray(nlp.lb, dtype=np.float64)
    ub_np = np.asarray(nlp.ub, dtype=np.float64)
    fixed_mask = np.isfinite(lb_np) & (lb_np == ub_np)
    free_idx = np.nonzero(~fixed_mask)[0]
    has_fixed = bool(fixed_mask.any())
    if has_fixed:
        fixed_template = np.where(fixed_mask, lb_np, 0.0)
        free_idx_j = free_idx  # numpy; converted inside traces only

        def to_full(zr):
            base = jnp.asarray(fixed_template, dtype=zr.dtype)
            return base.at[jnp.asarray(free_idx_j)].set(zr)

        full_obj = nlp.objective
        full_con = nlp.constraints
        nlp = NLP(n=len(free_idx), m=nlp.m,
                  objective=lambda zr: full_obj(to_full(zr)),
                  constraints=lambda zr: full_con(to_full(zr)),
                  lb=lb_np[free_idx], ub=ub_np[free_idx])
    else:
        to_full = lambda zr: zr

    f_fn = nlp.objective
    c_fn = nlp.constraints
    grad_f = jax.grad(f_fn)
    jac_c = jax.jacfwd(c_fn)

    def lagrangian(z, nu):
        return f_fn(z) + (c_fn(z) @ nu if nlp.m else 0.0)

    if opt.hessian_approximation == "objective-only":
        # Gauss-Newton-flavored: drop constraint curvature (the reference
        # runs IPOPT with limited-memory BFGS by default,
        # MocoDirectCollocationSolver.h:121, so it never sees exact
        # curvature either)
        lag_grad = lambda z, nu: grad_f(z)
    else:
        lag_grad = jax.grad(lagrangian, argnums=0)
    hess_L = jax.jacfwd(lag_grad, argnums=0)

    n, m = nlp.n, nlp.m

    # ---- structured path. Two independent levers:
    # * compressed block DERIVATIVES (2-coloring Jacobian, 1-color Hessian):
    #   used whenever a KKT structure exists AND kkt != "dense" — usually a
    #   win (O(nv) tangents instead of O(n));
    # * block-tridiagonal FACTORIZATION: a `lax.scan` of small dense LUs,
    #   O(N nb^3) — wins over one dense O((n+m)^3) LU only when the problem
    #   is large enough to beat the scan's serialization (threshold
    #   kkt_structured_min_dim, override with kkt="structured"/"dense").
    # kkt="dense" is a FULL opt-out: exact jacfwd/hess_L autodiff, no
    # structure assumptions anywhere — the escape hatch for problems that
    # violate the block-sparsity contract (see Transcription.kkt_structure).
    cs = None
    bd = None
    if cs_full is not None and opt.kkt != "dense":
        from .structured import BlockDerivatives
        cs = cs_full.remap_free(free_idx) if has_fixed else cs_full
        bd = BlockDerivatives(cs, c_fn, f_fn)
    use_btb = cs is not None and (
        opt.kkt == "structured" or
        (opt.kkt == "auto" and (n + m) >= opt.kkt_structured_min_dim))
    if grid_mesh is not None and cs is None:
        raise ValueError("grid_mesh requires a structured NLP (KKTStructure)")

    lb = np.asarray(nlp.lb, dtype=np.float64)
    ub = np.asarray(nlp.ub, dtype=np.float64)
    has_l_np = np.isfinite(lb)
    has_u_np = np.isfinite(ub)
    # IPOPT-style bound relaxation keeps a nonempty strict interior.
    lb = np.where(has_l_np, lb - opt.bound_relax * np.maximum(1.0,
                                                              np.abs(lb)), lb)
    ub = np.where(has_u_np, ub + opt.bound_relax * np.maximum(1.0,
                                                              np.abs(ub)), ub)

    def _dl_du(z, dtype):
        l = jnp.asarray(lb, dtype)
        u = jnp.asarray(ub, dtype)
        dl = jnp.where(jnp.asarray(has_l_np), z - l, 1.0)
        du = jnp.where(jnp.asarray(has_u_np), u - z, 1.0)
        return dl, du

    def _theta(z):
        """Constraint violation ||c||_1 (inf for non-finite)."""
        c = c_fn(z)
        v = jnp.sum(jnp.abs(c))
        return jnp.where(jnp.isfinite(v), v, jnp.inf)

    def _phi(z, mu):
        """Barrier objective (inf outside the interior)."""
        dtype = z.dtype
        dl, du = _dl_du(z, dtype)
        interior = jnp.all(dl > 0) & jnp.all(du > 0)
        logs = (jnp.sum(jnp.where(jnp.asarray(has_l_np),
                                  jnp.log(jnp.where(dl > 0, dl, 1.0)), 0.0)) +
                jnp.sum(jnp.where(jnp.asarray(has_u_np),
                                  jnp.log(jnp.where(du > 0, du, 1.0)), 0.0)))
        val = f_fn(z) - mu * logs
        bad = ~interior | ~jnp.isfinite(val)
        return jnp.where(bad, jnp.asarray(jnp.inf, dtype), val)

    def _fresh_filter(theta_scale, dtype):
        """Filter holding only the theta_max cap (reset on each mu change)."""
        ftheta = jnp.full((FILTER_SIZE,), jnp.inf, dtype)
        fphi = jnp.full((FILTER_SIZE,), jnp.inf, dtype)
        ftheta = ftheta.at[0].set(1e4 * theta_scale)
        fphi = fphi.at[0].set(-jnp.inf)
        return ftheta, fphi, jnp.ones((), jnp.int32)

    def init_fn(z0_full):
        z0 = z0_full[free_idx_j] if has_fixed else z0_full
        dtype = z0.dtype
        l = jnp.asarray(lb, dtype)
        u = jnp.asarray(ub, dtype)
        has_l = jnp.asarray(has_l_np)
        has_u = jnp.asarray(has_u_np)
        both = has_l & has_u
        width = jnp.where(both, u - l, jnp.inf)
        pl = jnp.minimum(opt.bound_push * jnp.maximum(1.0, jnp.abs(l)),
                         0.25 * width)
        pu = jnp.minimum(opt.bound_push * jnp.maximum(1.0, jnp.abs(u)),
                         0.25 * width)
        z = jnp.clip(z0, jnp.where(has_l, l + pl, -jnp.inf),
                     jnp.where(has_u, u - pu, jnp.inf))
        mu0 = jnp.asarray(opt.mu_init, dtype)
        dl, du = _dl_du(z, dtype)
        wL = jnp.where(has_l, mu0 / dl, 0.0)
        wU = jnp.where(has_u, mu0 / du, 0.0)
        theta_scale = jnp.maximum(1.0, _theta(z))
        ftheta, fphi, fcount = _fresh_filter(theta_scale, dtype)
        nu0 = jnp.zeros((m,), dtype)
        if m and opt.init_multipliers == "least-squares":
            g0 = grad_f(z)
            r1 = -(g0 - jnp.where(has_l, wL, 0.0) +
                   jnp.where(has_u, wU, 0.0))
            if cs is not None:
                from .structured import (assemble_kkt_blocks, btb_factor,
                                         btb_solve, pack_rhs, unpack_sol)
                jb0 = bd.jac_blocks(z)
                eye_v = jnp.eye(cs.nv, dtype=dtype)
                mv0 = jnp.asarray(cs.Vm).astype(dtype)
                kv0 = len(cs.bv)
                hb0 = dict(
                    Hvv=eye_v[None] * (mv0[:, :, None] * mv0[:, None, :]),
                    Hv1v0=jnp.zeros((cs.N - 1, cs.nv, cs.nv), dtype),
                    Hvb=jnp.zeros((cs.N, cs.nv, kv0), dtype),
                    Hbb=jnp.eye(kv0, dtype=dtype))
                D0, L0, B0, C0 = assemble_kkt_blocks(
                    hb0, jb0, jnp.zeros((n,), dtype),
                    jnp.zeros((), dtype), 1e-8, cs)
                fac0 = btb_factor(D0, L0, B0, C0)
                rhs_T0, rhs_C0 = pack_rhs(r1, jnp.zeros((m,), dtype),
                                          None, cs)
                x0s, wb0 = btb_solve(fac0, rhs_T0, rhs_C0)
                _, nu0 = unpack_sol(x0s, wb0, cs, dtype)
            else:
                J0 = jac_c(z)
                K0 = jnp.block([[jnp.eye(n, dtype=dtype), J0.T],
                                [J0, -1e-8 * jnp.eye(m, dtype=dtype)]])
                sol0 = jnp.linalg.solve(K0, jnp.concatenate(
                    [r1, jnp.zeros((m,), dtype)]))
                nu0 = sol0[n:]
            # degenerate-Jacobian guard (IPOPT least_square_init_
            # multipliers): discard a huge LS dual outright. Measured r5:
            # rescaling it into a 1e3 trust region instead stalls the
            # free-final-time sliding-mass family at kkt ~0.9 (the
            # clipped direction is garbage when the LS system is
            # degenerate at a bounds-midpoint cold start); zero is the
            # safe fallback.
            nu0 = jnp.where(jnp.isfinite(nu0), nu0, 0.0)
            nu0 = jnp.where(_inf_norm(nu0) <= 1e3, nu0,
                            jnp.zeros_like(nu0))
        return Carry(z=z, nu=nu0, wL=wL, wU=wU, mu=mu0,
                     it=jnp.zeros((), jnp.int32), converged=jnp.array(False),
                     kkt=jnp.asarray(jnp.inf, dtype),
                     alpha_last=jnp.ones((), dtype),
                     delta_last=jnp.zeros((), dtype),
                     filter_theta=ftheta, filter_phi=fphi,
                     filter_count=fcount, theta_scale=theta_scale,
                     best_z=z, best_nu=nu0,
                     best_kkt=jnp.asarray(jnp.inf, dtype),
                     acceptable_count=jnp.zeros((), jnp.int32),
                     rescue_count=jnp.zeros((), jnp.int32),
                     stall_count=jnp.zeros((), jnp.int32),
                     mu_wait=jnp.zeros((), jnp.int32))

    def body_fn(carry: Carry) -> Carry:
        z, nu, wL, wU, mu = carry.z, carry.nu, carry.wL, carry.wU, carry.mu
        dtype = z.dtype
        has_l = jnp.asarray(has_l_np)
        has_u = jnp.asarray(has_u_np)
        mu_min = jnp.asarray(opt.tol * opt.mu_min_factor, dtype)

        g = grad_f(z)
        cz = c_fn(z)
        dl, du = _dl_du(z, dtype)
        # f32 rounding can land an iterate exactly on a relaxed bound;
        # clamp the slacks used in divisions so duals stay finite
        dls = jnp.maximum(dl, 1e-20)
        dus = jnp.maximum(du, 1e-20)
        SigL = jnp.where(has_l, wL / dls, 0.0)
        SigU = jnp.where(has_u, wU / dus, 0.0)
        Sig = SigL + SigU

        if cs is not None:
            from .structured import (assemble_kkt_blocks, block_H_diag,
                                     block_H_matvec, btb_factor, btb_solve,
                                     dense_H_from_blocks, dense_J_from_blocks,
                                     pack_rhs, unpack_sol)
            jb = bd.jac_blocks(z)
            hb = bd.hess_blocks(lag_grad, z, nu)
            _, c_vjp = jax.vjp(c_fn, z)
            Jt_nu = c_vjp(nu)[0]
            h_diag = block_H_diag(hb, cs, dtype)
            if not use_btb and grid_mesh is None:
                J = dense_J_from_blocks(jb, cs)
                W = dense_H_from_blocks(hb, cs)
        else:
            J = jac_c(z)
            W = hess_L(z, nu)
            Jt_nu = J.T @ nu if m else jnp.zeros((n,), dtype)
            h_diag = jnp.diagonal(W)
        rd = g + Jt_nu - jnp.where(has_l, wL, 0.0) + jnp.where(has_u, wU, 0.0)
        smax = 100.0
        ssum = jnp.sum(jnp.abs(nu)) + jnp.sum(jnp.abs(wL)) + jnp.sum(
            jnp.abs(wU))
        sd = jnp.maximum(smax, ssum / (m + 2 * n)) / smax
        sc = jnp.maximum(smax, (jnp.sum(jnp.abs(wL)) + jnp.sum(jnp.abs(wU))) /
                         jnp.maximum(1, 2 * n)) / smax

        def err_parts(mu_val):
            compL = jnp.where(has_l, dl * wL - mu_val, 0.0)
            compU = jnp.where(has_u, du * wU - mu_val, 0.0)
            dual = _inf_norm(rd) / sd
            primal = _inf_norm(cz)
            comp = jnp.maximum(_inf_norm(compL), _inf_norm(compU)) / sc
            return dual, primal, comp

        def err(mu_val):
            dual, primal, comp = err_parts(mu_val)
            return jnp.maximum(dual, jnp.maximum(primal, comp))

        e0 = err(jnp.zeros((), dtype))
        # best-iterate + acceptable-level bookkeeping
        is_best = e0 < carry.best_kkt
        best_z = jnp.where(is_best, z, carry.best_z)
        best_nu = jnp.where(is_best, nu, carry.best_nu)
        best_kkt = jnp.where(is_best, e0, carry.best_kkt)
        acc_tol = opt.acceptable_tol_factor * opt.tol
        acceptable_count = jnp.where(e0 <= acc_tol,
                                     carry.acceptable_count + 1,
                                     jnp.zeros((), jnp.int32))
        converged = (e0 <= opt.tol) | \
            ((acceptable_count >= opt.acceptable_iter) &
             (best_kkt <= acc_tol))
        e_mu = err(mu)
        # Fiacco-McCormick decrease, gated on the last step having been
        # accepted (racing mu down through a rejection storm strands
        # free-final-time bang-bang solves), plus the mu_force_iter
        # watchdog: many consecutive accepted steps without mu progress
        # means the error floor IS the barrier pressure — force the
        # decrease (breaks the linear-tangent orbit that a kappa_eps=10
        # gate never clears).
        # stagnation: step accepted yet the error did not meaningfully
        # improve vs the previous iteration (carry.kkt) — the orbit
        # signature; computed here, consumed by the mu_wait update below
        force_mu = carry.mu_wait >= opt.mu_force_iter
        mu_new = jnp.where(
            ((e_mu <= opt.kappa_eps * mu) & (carry.alpha_last > 0)) |
            force_mu,
            jnp.maximum(mu_min, jnp.minimum(opt.kappa_mu * mu,
                                            mu ** opt.theta_mu)),
            mu)
        mu_changed = mu_new != mu
        # reset the filter whenever the barrier parameter changes (IPOPT)
        ft0, fp0, fc0 = _fresh_filter(carry.theta_scale, dtype)
        ftheta = jnp.where(mu_changed, ft0, carry.filter_theta)
        fphi = jnp.where(mu_changed, fp0, carry.filter_phi)
        fcount = jnp.where(mu_changed, fc0, carry.filter_count)

        rhs1 = -(g + Jt_nu) + jnp.where(has_l, mu_new / dls, 0.0) - \
            jnp.where(has_u, mu_new / dus, 0.0)
        rhs2 = -cz
        gphi = g - jnp.where(has_l, mu_new / dls, 0.0) + \
            jnp.where(has_u, mu_new / dus, 0.0)

        wscale = jnp.maximum(1.0, _inf_norm(h_diag + Sig))

        # factor once per regularization trial; the factorization (a pytree)
        # rides the carry so the Newton step, the second-order correction,
        # and the feasibility fallback share it as cheap extra solves
        if grid_mesh is not None:
            # parallel-in-time KKT: assemble blocks, shard the mesh-interval
            # axis over the device mesh, solve with the partition/SPIKE
            # kernel. No factorization is cached across the Newton/SOC/
            # feasibility solves (each re-condenses its local chunk) — the
            # price of time-axis parallelism; the reduced boundary system
            # and border Schur ride collectives (psum/all_gather).
            from functools import partial

            from jax import shard_map
            from jax.sharding import PartitionSpec as PS

            from .kkt import bordered_block_tridiag_solve_partitioned

            n_dev = grid_mesh.shape[grid_axis]
            pad = (-cs.N) % n_dev  # static: identity blocks appended so
            pspec = PS(grid_axis)  # the shard axis divides evenly
            rspec = PS()

            def kkt_factor(delta_w):
                delta_c = 1e-8 * wscale
                D, L, Bb, Cb = assemble_kkt_blocks(hb, jb, Sig, delta_w,
                                                   delta_c, cs)
                N, nb, _ = D.shape
                kb = 0 if Bb is None else Bb.shape[-1]
                if Bb is None:
                    Bb = jnp.zeros((N, nb, 0), dtype)
                    Cb = jnp.zeros((0, 0), dtype)
                if pad:
                    eye = jnp.broadcast_to(jnp.eye(nb, dtype=dtype),
                                           (pad, nb, nb))
                    D = jnp.concatenate([D, eye])
                    Bb = jnp.concatenate(
                        [Bb, jnp.zeros((pad, nb, kb), dtype)])
                # L rows: (N-1) couplings -> (N+pad,) with zero tail
                Lp = jnp.concatenate(
                    [L, jnp.zeros((pad + 1, nb, nb), dtype)])
                return (D, Lp, Bb, Cb)

            def kkt_solve(fac, r1, r2):
                D, Lp, Bb, Cb = fac
                rhs_T, rhs_C = pack_rhs(r1, r2, None, cs)
                if pad:
                    rhs_T = jnp.concatenate(
                        [rhs_T, jnp.zeros((pad, rhs_T.shape[1]), dtype)])
                fn = shard_map(
                    partial(bordered_block_tridiag_solve_partitioned,
                            axis_name=grid_axis),
                    mesh=grid_mesh,
                    in_specs=(pspec, pspec, pspec, rspec, pspec, rspec),
                    out_specs=(pspec, rspec))
                x, wb = fn(D, Lp, Bb, Cb, rhs_T, rhs_C)
                if pad:
                    x = x[:cs.N]
                return unpack_sol(x, wb, cs, dtype)

            def H_mv(v):
                return block_H_matvec(hb, cs, v) + Sig * v
        elif use_btb:
            def kkt_factor(delta_w):
                delta_c = 1e-8 * wscale
                D, L, Bb, Cb = assemble_kkt_blocks(hb, jb, Sig, delta_w,
                                                   delta_c, cs)
                return btb_factor(D, L, Bb, Cb)

            def kkt_solve(fac, r1, r2):
                rhs_T, rhs_C = pack_rhs(r1, r2, None, cs)
                x, wb = btb_solve(fac, rhs_T, rhs_C)
                return unpack_sol(x, wb, cs, dtype)

            def H_mv(v):
                return block_H_matvec(hb, cs, v) + Sig * v
        elif opt.dense_factorization == "chol-schur":
            # pivot-free quasi-definite factorization: Lh = chol(Hd),
            # Y = Lh^-1 J^T (a triangular solve with m right-hand sides —
            # a matmul-shaped op), S = Y^T Y + delta_c I,
            # Ls = chol(S). Indefinite Hd -> NaN -> the reg loop escalates
            # delta, exactly like an IPOPT inertia correction.
            tri = jax.lax.linalg.triangular_solve
            H = W + jnp.diag(Sig)

            def kkt_factor(delta_w):
                delta_c = 1e-8 * wscale
                Hd = H + delta_w * jnp.eye(n, dtype=dtype)
                Lh = jnp.linalg.cholesky(Hd)
                if m:
                    Y = tri(Lh, J.T, left_side=True, lower=True)
                    S = Y.T @ Y + delta_c * jnp.eye(m, dtype=dtype)
                    Ls = jnp.linalg.cholesky(S)
                else:
                    Y = jnp.zeros((n, 0), dtype)
                    Ls = jnp.zeros((0, 0), dtype)
                return (Lh, Y, Ls)

            def kkt_solve(fac, r1, r2):
                Lh, Y, Ls = fac
                w = tri(Lh, r1[:, None], left_side=True, lower=True)
                if m:
                    # (J Hd^-1 J^T + dc I) dnu = Y^T w - r2
                    rhs = (Y.T @ w)[:, 0] - r2
                    t = tri(Ls, rhs[:, None], left_side=True, lower=True)
                    dnu = tri(Ls, t, left_side=True, lower=True,
                              transpose_a=True)[:, 0]
                    dz = tri(Lh, w - Y @ dnu[:, None], left_side=True,
                             lower=True, transpose_a=True)[:, 0]
                else:
                    dnu = jnp.zeros((0,), dtype)
                    dz = tri(Lh, w, left_side=True, lower=True,
                             transpose_a=True)[:, 0]
                return dz, dnu

            def H_mv(v):
                return H @ v
        else:
            # one dense pivoted LU of the full KKT per regularization trial
            from jax.scipy.linalg import lu_factor, lu_solve
            H = W + jnp.diag(Sig)

            def kkt_factor(delta_w):
                delta_c = 1e-8 * wscale
                if m:
                    K = jnp.block([
                        [H + delta_w * jnp.eye(n, dtype=dtype), J.T],
                        [J, -delta_c * jnp.eye(m, dtype=dtype)],
                    ])
                else:
                    K = H + delta_w * jnp.eye(n, dtype=dtype)
                return lu_factor(K)

            def kkt_solve(fac, r1, r2):
                sol = lu_solve(fac, jnp.concatenate([r1, r2]) if m else r1)
                return sol[:n], sol[n:]

            def H_mv(v):
                return H @ v

        def kkt_solve_refined(fac, delta, r1, r2):
            """kkt_solve + operator-form iterative refinement (the
            fp32-factor/refined-residual scheme; kkt_refine_iters=0 is a
            plain solve)."""
            dz, dnu = kkt_solve(fac, r1, r2)
            delta_c = 1e-8 * wscale
            for _ in range(opt.kkt_refine_iters):
                Jt_dnu = (jax.vjp(c_fn, z)[1](dnu)[0] if m
                          else jnp.zeros_like(dz))
                Jdz = (jax.jvp(c_fn, (z,), (dz,))[1] if m
                       else jnp.zeros((0,), dtype))
                e1 = r1 - (H_mv(dz) + delta * dz + Jt_dnu)
                e2 = r2 - (Jdz - delta_c * dnu)
                ddz, ddnu = kkt_solve(fac, e1, e2)
                dz = dz + ddz
                dnu = dnu + ddnu
            return dz, dnu

        # ---- inertia-free regularization loop with delta warm-starting
        # (IPOPT: first trial delta = max(delta_min, delta_last / 3); a
        # line-search failure last iteration escalates the starting delta)
        def try_delta(delta, tries):
            fac = kkt_factor(delta)
            dz, dnu = kkt_solve_refined(fac, delta, rhs1, rhs2)
            curv = dz @ H_mv(dz) + delta * (dz @ dz)
            curv_ok = curv >= 1e-9 * (dz @ dz)
            size_ok = _inf_norm(dz) <= 1e6 * jnp.maximum(1.0, _inf_norm(z))
            ok = jnp.all(jnp.isfinite(dz)) & curv_ok & size_ok
            return (delta, dz, dnu, ok, tries, fac)

        def reg_cond(state):
            ok, tries = state[3], state[4]
            return (~ok) & (tries < opt.max_reg)

        def reg_body(state):
            delta, _, _, _, tries, _ = state
            new_delta = jnp.minimum(
                jnp.asarray(opt.delta_w_max, dtype),
                jnp.maximum(opt.delta_w_init * wscale, delta * 100.0))
            out = try_delta(new_delta, tries + 1)
            return out

        delta_first = jnp.where(carry.delta_last > 0,
                                jnp.maximum(opt.delta_w_init * wscale,
                                            carry.delta_last / 3.0),
                                jnp.zeros((), dtype))
        init_state = try_delta(delta_first, jnp.array(0))
        delta, dz, dnu, ok, _, fac = jax.lax.while_loop(reg_cond, reg_body,
                                                        init_state)

        dwL = jnp.where(has_l, mu_new / dls - wL - SigL * dz, 0.0)
        dwU = jnp.where(has_u, mu_new / dus - wU + SigU * dz, 0.0)

        tau = jnp.maximum(opt.tau_min, 1.0 - mu_new)

        def max_step(val, dval, active):
            safe = jnp.where(active & (dval < 0),
                             -tau * val / jnp.where(dval < 0, dval, -1.0),
                             jnp.inf)
            return jnp.minimum(1.0, jnp.min(safe) if safe.size else 1.0)

        alpha_pr_max = jnp.minimum(max_step(dl, dz, has_l),
                                   max_step(du, -dz, has_u))
        alpha_du = jnp.minimum(max_step(wL, dwL, has_l),
                               max_step(wU, dwU, has_u))

        # ---- filter line search (Waechter-Biegler 2006, Algorithm A)
        theta0 = _theta(z)
        phi0 = _phi(z, mu_new)
        gphiTd = gphi @ dz
        theta_min = 1e-4 * carry.theta_scale

        def flt_ok(theta_t, phi_t):
            active = jnp.arange(FILTER_SIZE) < fcount
            dominated = jnp.any(active & (theta_t >= ftheta) &
                                (phi_t >= fphi))
            return (~dominated) & jnp.isfinite(theta_t)

        def test_alpha(alpha, z_t):
            theta_t = _theta(z_t)
            phi_t = _phi(z_t, mu_new)
            switching = (gphiTd < 0) & \
                (alpha * jnp.abs(gphiTd) ** opt.s_phi >
                 opt.delta_switch * theta0 ** opt.s_theta)
            armijo = phi_t <= phi0 + opt.eta_phi * alpha * gphiTd
            suff = ((theta_t <= (1 - opt.gamma_theta) * theta0) |
                    (phi_t <= phi0 - opt.gamma_phi * theta0))
            use_armijo = switching & (theta0 <= theta_min)
            accept = flt_ok(theta_t, phi_t) & jnp.where(use_armijo, armijo,
                                                        suff)
            by_fdecrease = use_armijo & armijo
            return accept, by_fdecrease

        # full step, then one second-order correction, then CANDIDATE-
        # PARALLEL backtracking: all trial alphas are evaluated in one
        # batched pass instead of a sequential halving loop — sequential
        # inner loops serialize to worst-case across vmap lanes.
        z_full = z + alpha_pr_max * dz
        acc_full, armi_full = test_alpha(alpha_pr_max, z_full)

        c_soc = alpha_pr_max * cz + c_fn(z_full)
        dz_soc, _ = kkt_solve_refined(fac, delta, rhs1, -c_soc)
        alpha_soc = jnp.minimum(max_step(dl, dz_soc, has_l),
                                max_step(du, -dz_soc, has_u))
        z_soc = z + alpha_soc * dz_soc
        acc_soc_t, armi_soc = test_alpha(alpha_soc, z_soc)
        acc_soc = (~acc_full) & jnp.all(jnp.isfinite(dz_soc)) & acc_soc_t

        cand_alphas = alpha_pr_max * 0.5 ** jnp.arange(
            1, opt.max_ls + 1, dtype=dtype)

        def run_backtracking(_):
            return jax.vmap(lambda a: test_alpha(a, z + a * dz))(cand_alphas)

        def skip_backtracking(_):
            k = opt.max_ls
            return (jnp.zeros((k,), bool), jnp.zeros((k,), bool))

        acc_c, armi_c = jax.lax.cond(acc_full | acc_soc, skip_backtracking,
                                     run_backtracking, None)
        any_bt = jnp.any(acc_c)
        first = jnp.argmax(acc_c)  # first accepted candidate
        alpha_bt = cand_alphas[first]
        acc_bt = any_bt
        armi_bt = armi_c[first]

        any_acc = acc_full | acc_soc | acc_bt
        alpha = jnp.where(acc_full, alpha_pr_max,
                          jnp.where(acc_soc, alpha_soc,
                                    jnp.where(acc_bt, alpha_bt, 0.0)))
        z_acc = jnp.where(acc_full, z_full,
                          jnp.where(acc_soc, z_soc, z + alpha_bt * dz))
        by_armijo = jnp.where(acc_full, armi_full,
                              jnp.where(acc_soc, armi_soc, armi_bt))

        # feasibility fallback when the filter rejects everything (cheap
        # stand-in for IPOPT's restoration phase): a pure-feasibility Newton
        # step from the SAME KKT factorization — rhs (0, -c) minimizes
        # 1/2 dz^T (H + Sigma + delta I) dz s.t. J dz ~ -c, so the barrier
        # curvature keeps the step off active bounds, and the extra solve
        # costs O(N nb^2) instead of a fresh factorization.
        if m:
            dz_feas, _ = kkt_solve(fac, jnp.zeros((n,), dtype), -cz)
        else:
            dz_feas = jnp.zeros((n,), dtype)
        alpha_feas0 = jnp.minimum(max_step(dl, dz_feas, has_l),
                                  max_step(du, -dz_feas, has_u))
        fb_alphas = alpha_feas0 * 0.5 ** jnp.arange(1, opt.max_ls + 1,
                                                    dtype=dtype)

        def fb_try(a):
            trial = z + a * dz_feas
            th = _theta(trial)
            return jnp.isfinite(th) & (th < theta0) & \
                jnp.all(jnp.isfinite(trial))

        fb_ok = jax.lax.cond(
            any_acc, lambda _: jnp.zeros((opt.max_ls,), bool),
            lambda _: jax.vmap(fb_try)(fb_alphas), None)
        feas_ok = jnp.any(fb_ok)
        alpha_feas = fb_alphas[jnp.argmax(fb_ok)]
        z_feas = z + alpha_feas * dz_feas
        z_new = jnp.where(any_acc, z_acc,
                          jnp.where(feas_ok, z_feas, z))

        # filter augmentation: whenever the step was not a pure
        # objective-decrease (Armijo) step, block this (theta, phi) region
        add_entry = any_acc & (~by_armijo)
        slot = jnp.minimum(fcount, FILTER_SIZE - 1)
        ftheta_new = jnp.where(
            add_entry,
            ftheta.at[slot].set((1 - opt.gamma_theta) * theta0), ftheta)
        fphi_new = jnp.where(
            add_entry, fphi.at[slot].set(phi0 - opt.gamma_phi * theta0), fphi)
        # also augment on fallback so we don't cycle
        add_fb = (~any_acc)
        ftheta_new = jnp.where(
            add_fb, ftheta_new.at[slot].set((1 - opt.gamma_theta) * theta0),
            ftheta_new)
        fphi_new = jnp.where(
            add_fb, fphi_new.at[slot].set(phi0 - opt.gamma_phi * theta0),
            fphi_new)
        fcount_new = jnp.minimum(fcount + (add_entry | add_fb),
                                 FILTER_SIZE - 1)

        nu_new = nu + alpha * dnu
        dl_n, du_n = _dl_du(z_new, dtype)
        dl_ns = jnp.maximum(dl_n, 1e-20)
        du_ns = jnp.maximum(du_n, 1e-20)
        # Newton step taken: usual dual update. Fallback step taken: the
        # primal moved without its duals, so re-center bound duals on the
        # central path (IPOPT does the same when leaving restoration);
        # no step: freeze duals (drifting them to the kappa-Sigma cap
        # explodes the dual residual).
        mu_fb = jnp.minimum(jnp.asarray(opt.mu_init, dtype), mu_new * 10.0)
        wL_new = jnp.where(any_acc, wL + alpha_du * dwL,
                           jnp.where(feas_ok, mu_fb / dl_ns, wL))
        wU_new = jnp.where(any_acc, wU + alpha_du * dwU,
                           jnp.where(feas_ok, mu_fb / du_ns, wU))
        ks = opt.kappa_sigma
        wL_new = jnp.where(has_l, jnp.clip(wL_new, mu_new / (ks * dl_ns),
                                           ks * mu_new / dl_ns), 0.0)
        wU_new = jnp.where(has_u, jnp.clip(wU_new, mu_new / (ks * du_ns),
                                           ks * mu_new / du_ns), 0.0)

        # ---- divergence recovery: if the iterate or its duals went
        # non-finite (dual blow-up near a bound, NaN physics off the
        # feasible manifold), restart from the best iterate seen with
        # mu-centered duals instead of burning the remaining iterations on
        # a poisoned lane (a cheap stand-in for IPOPT's restoration phase
        # that the filter fallback cannot reach once z itself is NaN).
        finite_ok = (jnp.all(jnp.isfinite(z_new)) &
                     jnp.all(jnp.isfinite(nu_new)) &
                     jnp.all(jnp.isfinite(wL_new)) &
                     jnp.all(jnp.isfinite(wU_new)))
        stagnant = any_acc & (e0 > 0.9 * carry.kkt)
        # stall escape: K consecutive iterations where the filter rejected
        # every trial AND the feasibility fallback failed means the solver
        # is wedged (typically after regularization ran away); restart from
        # the best iterate like the non-finite path instead of burning the
        # remaining budget on zero steps (IPOPT aborts with "restoration
        # failed" here; we recover)
        stalled = ~any_acc
        stall_count = jnp.where(stalled, carry.stall_count + 1,
                                jnp.zeros((), jnp.int32))
        stall_reset = stall_count >= 8
        finite_ok = finite_ok & (~stall_reset)
        stall_count = jnp.where(stall_reset, 0, stall_count)
        have_best = jnp.isfinite(carry.best_kkt)
        z_rec = jnp.where(have_best, carry.best_z, z)
        z_new = jnp.where(finite_ok, z_new, z_rec)
        nu_new = jnp.where(finite_ok, nu_new,
                           jnp.where(have_best, carry.best_nu, nu))
        dl_r, du_r = _dl_du(z_new, dtype)
        mu_ctr = jnp.minimum(jnp.asarray(opt.mu_init, dtype), mu_new * 10.0)
        wL_new = jnp.where(finite_ok, wL_new,
                           jnp.where(has_l, mu_ctr /
                                     jnp.maximum(dl_r, 1e-20), 0.0))
        wU_new = jnp.where(finite_ok, wU_new,
                           jnp.where(has_u, mu_ctr /
                                     jnp.maximum(du_r, 1e-20), 0.0))
        ftheta_new = jnp.where(finite_ok, ftheta_new, ft0)
        fphi_new = jnp.where(finite_ok, fphi_new, fp0)
        fcount_new = jnp.where(finite_ok, fcount_new, fc0)

        # mu rescue (non-monotone barrier): a rejected Newton step usually
        # means the iterate slammed into bounds after mu raced ahead;
        # re-centering with a larger mu pulls it back off (cf. adaptive-mu
        # strategies, Nocedal/Waechter/Waltz). Near the solution (already
        # at acceptable KKT level) rescuing only causes limit cycles, so
        # hold mu there and let the acceptable-level exit fire; a per-solve
        # rescue budget (max_rescues) stops hard lanes from cycling between
        # pump-up and decrease forever.
        near_solution = e0 <= acc_tol
        dual0, primal0, comp0 = err_parts(jnp.zeros((), dtype))
        dual_dominates = dual0 > 10.0 * jnp.maximum(primal0, comp0)
        allow_rescue = (carry.rescue_count < opt.max_rescues) & \
            (~dual_dominates)
        mu_rescued = jnp.where((any_acc | near_solution | ~allow_rescue) &
                               finite_ok, mu_new,
                               jnp.minimum(jnp.asarray(opt.mu_init, dtype),
                                           mu_new * 10.0))
        rescue = mu_rescued != mu_new
        # non-finite restarts pump mu too, but only deliberate rejected-step
        # rescues consume the budget — otherwise a few NaN recoveries
        # disable legitimate mu rescues for the rest of the solve
        rescue_count = carry.rescue_count + jnp.where(rescue & finite_ok,
                                                      1, 0)
        ftheta_new = jnp.where(rescue, ft0, ftheta_new)
        fphi_new = jnp.where(rescue, fp0, fphi_new)
        fcount_new = jnp.where(rescue, fc0, fcount_new)

        keep = converged
        return Carry(
            z=jnp.where(keep, z, z_new),
            nu=jnp.where(keep, nu, nu_new),
            wL=jnp.where(keep, wL, wL_new),
            wU=jnp.where(keep, wU, wU_new),
            mu=jnp.where(keep, mu, mu_rescued),
            it=carry.it + jnp.where(keep, 0, 1),
            converged=converged,
            kkt=e0,
            alpha_last=alpha,
            # step-quality feedback: rejected or crawling steps escalate the
            # next iteration's starting regularization; good steps let the
            # /3 warm start decay it back toward zero
            delta_last=jnp.where(
                ~finite_ok, jnp.zeros((), dtype),
                jnp.where(any_acc, delta,
                          jnp.minimum(jnp.asarray(opt.delta_w_max, dtype),
                                      jnp.maximum(delta * 10.0,
                                                  opt.delta_w_init *
                                                  wscale)))),
            filter_theta=jnp.where(keep, carry.filter_theta, ftheta_new),
            filter_phi=jnp.where(keep, carry.filter_phi, fphi_new),
            filter_count=jnp.where(keep, carry.filter_count, fcount_new),
            theta_scale=carry.theta_scale,
            best_z=best_z, best_nu=best_nu, best_kkt=best_kkt,
            acceptable_count=acceptable_count,
            rescue_count=jnp.where(keep, carry.rescue_count, rescue_count),
            stall_count=jnp.where(keep, carry.stall_count, stall_count),
            mu_wait=jnp.where(
                keep, carry.mu_wait,
                jnp.where(
                    (mu_rescued != mu) | ~stagnant,
                    jnp.zeros((), jnp.int32),
                    carry.mu_wait + 1)))

    def cond_fn(carry: Carry):
        return (~carry.converged) & (carry.it < opt.max_iter)

    def finalize_fn(carry: Carry) -> IPMResult:
        # report the best iterate seen (matters when the tail oscillates
        # around the solution before the acceptable-level exit fires)
        use_best = carry.best_kkt < carry.kkt
        z_out = jnp.where(use_best, carry.best_z, carry.z)
        nu_out = jnp.where(use_best, carry.best_nu, carry.nu)
        kkt_out = jnp.minimum(carry.best_kkt, carry.kkt)
        return IPMResult(z=to_full(z_out), nu=nu_out,
                         f=f_unscale * f_fn(z_out),
                         kkt_error=kkt_out, iterations=carry.it,
                         converged=carry.converged)

    def debug_fn(carry: Carry):
        """Error decomposition at the carry (iteration-log tooling, the
        analogue of IPOPT's inf_pr/inf_du/lg(mu)/alpha columns)."""
        z, nu, wL, wU = carry.z, carry.nu, carry.wL, carry.wU
        dtype = z.dtype
        has_l = jnp.asarray(has_l_np)
        has_u = jnp.asarray(has_u_np)
        g = grad_f(z)
        cz = c_fn(z)
        _, c_vjp = jax.vjp(c_fn, z)
        Jt_nu = c_vjp(nu)[0] if m else jnp.zeros_like(z)
        dl, du = _dl_du(z, dtype)
        rd = g + Jt_nu - jnp.where(has_l, wL, 0.0) + jnp.where(has_u, wU,
                                                               0.0)
        smax = 100.0
        ssum = jnp.sum(jnp.abs(nu)) + jnp.sum(jnp.abs(wL)) + \
            jnp.sum(jnp.abs(wU))
        sd = jnp.maximum(smax, ssum / (m + 2 * n)) / smax
        sc = jnp.maximum(smax, (jnp.sum(jnp.abs(wL)) +
                                jnp.sum(jnp.abs(wU))) /
                         jnp.maximum(1, 2 * n)) / smax
        compL = jnp.where(has_l, dl * wL, 0.0)
        compU = jnp.where(has_u, du * wU, 0.0)
        return {"dual": _inf_norm(rd) / sd, "primal": _inf_norm(cz),
                "comp": jnp.maximum(_inf_norm(compL),
                                    _inf_norm(compU)) / sc,
                "dual_raw": _inf_norm(rd), "sd": sd, "sc": sc,
                "nu_inf": _inf_norm(nu), "wL_inf": _inf_norm(wL),
                "wU_inf": _inf_norm(wU),
                "rd_argmax": jnp.argmax(jnp.abs(rd)),
                "min_dl": jnp.min(jnp.where(has_l, dl, jnp.inf)),
                "min_du": jnp.min(jnp.where(has_u, du, jnp.inf))}

    return init_fn, body_fn, cond_fn, finalize_fn, debug_fn


def make_chunked_solver(nlp: NLP, options: IPMOptions = IPMOptions(),
                        scale_z0=None):
    """Like :func:`make_solver` but returns (init, run_chunk, finalize)
    where ``run_chunk(carry, iter_limit)`` advances the solve until
    convergence or ``carry.it >= iter_limit``.

    This powers periodic iterate dumps and graceful interruption — the
    reference's ``output_interval`` trajectory snapshots
    (MocoCasADiSolver.h:138) and FileDeletionThrower abort hook
    (MocoUtilities.h:717-756) — without host callbacks inside the XLA
    program. All three are jitted at full matmul precision."""
    init_fn, body_fn, cond_fn, finalize_fn, _ = make_kernel(
        nlp, options, scale_z0=scale_z0)

    @jax.jit
    @_highest_precision
    def run_chunk(carry, iter_limit):
        def cond(c):
            return (~c.converged) & (c.it < iter_limit)

        return jax.lax.while_loop(cond, body_fn, carry)

    return (jax.jit(_highest_precision(init_fn)), run_chunk,
            jax.jit(_highest_precision(finalize_fn)))


def make_solver(nlp: NLP, options: IPMOptions = IPMOptions(),
                scale_z0=None, grid_mesh=None, grid_axis="grid") -> Callable:
    """Build a pure solve function ``z0 -> IPMResult`` for a fixed NLP.

    The returned function contains no Python-level control flow, so it can
    be jitted, vmapped (batch of initial guesses / parameterized problems
    via closure), and pjit-sharded. ``grid_mesh``: shard the KKT solves of
    one large problem over the mesh-interval axis (see make_kernel).
    """
    init_fn, body_fn, cond_fn, finalize_fn, _ = make_kernel(
        nlp, options, scale_z0=scale_z0, grid_mesh=grid_mesh,
        grid_axis=grid_axis)

    @_highest_precision
    def solve(z0_full):
        out = jax.lax.while_loop(cond_fn, body_fn, init_fn(z0_full))
        return finalize_fn(out)

    return solve
