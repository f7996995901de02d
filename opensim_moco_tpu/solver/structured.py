"""Structured derivative assembly + factor/solve-split KKT.

Direct-collocation NLPs have a bordered block-(bi/tri)diagonal sparsity in
the time axis (the reference documents the same time-grouped layout at
CasOCTranscription.h:219-387 and recovers it by finite-difference sparsity
detection + graph coloring, CasOCFunction.cpp:25-105 and
tropter/internal/GraphColoring.h:56-217). Because our transcription KNOWS
its structure (solver.nlp.KKTStructure), no detection is needed — the
coloring is analytic:

* constraint rows of interval block ``i`` touch variable blocks ``i`` and
  ``i+1`` only (the transcription assembles rows in that order), so the
  Jacobian is upper block-bidiagonal + border and is recovered from
  ``2·nv + kv`` forward tangents (2-coloring over interval parity, plus one
  exact tangent per border variable) instead of ``n`` — an ``N/2``-fold
  reduction in derivative work;
* every constraint and cost integrand is a per-grid-point function combined
  *linearly* across points, so the Lagrangian Hessian has NO cross-point
  (hence no cross-block) coupling: block-diagonal + border, recovered from
  ``nv + kv`` forward-over-reverse tangents (single color). The
  tests in tests/test_structured_derivs.py pin both claims against dense
  autodiff for every example problem family;
* border constraint rows (endpoint/periodicity goals) are computed exactly
  with ``kc`` reverse-mode passes — they may couple distant blocks, which
  would alias under compression.

The recovered blocks feed :class:`BTBFactor`, a bordered block-tridiagonal
LDL-ish factorization built on ``lax.scan`` with dense per-block ops:
factor once per regularization trial, then solve the Newton
step, the second-order correction, and the feasibility fallback as cheap
extra right-hand sides. O(N nb^3) factor, O(N nb^2) per solve.

Validity contract (enforced by Transcription.kkt_structure): no cost-mode
goal couples initial and final grid points nonlinearly, and no goal's value
is nonlinear in its integral — otherwise rank-one dense Hessian terms appear
that the compressed recovery would alias into wrong blocks. Such problems
return ``structure=None`` and take the dense path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import lu_factor, lu_solve

from .kkt import CompiledStructure


def _seeded_jvp(fn, z, seeds, n_blocks):
    """vmap of jvp over coloring seeds, chunked for large grids.

    On big transcriptions (N >= 32 blocks, e.g. the 50-mesh-interval gait
    problems) a plain vmap over ~2nv+kv tangents batches the whole
    evaluation tape by the seed count, and under the solver's own vmap
    over lanes that peak multiplies by the batch size. lax.map with a
    batch size trades that peak device memory for a short scan.
    """
    if n_blocks < 32:
        return jax.vmap(lambda s: jax.jvp(fn, (z,), (s,))[1])(seeds)
    return jax.lax.map(lambda s: jax.jvp(fn, (z,), (s,))[1], seeds,
                       batch_size=16)


class BlockDerivatives:
    """Compressed-seed derivative extraction for a CompiledStructure.

    All index bookkeeping is numpy at build time; the jitted extraction is
    pure gathers + a vmapped jvp over the (small) seed set.
    """

    def __init__(self, cs: CompiledStructure, c_fn, f_fn):
        self.cs = cs
        self.c_fn = c_fn
        self.f_fn = f_fn
        N, nv, nc = cs.N, cs.nv, cs.nc
        n, m = cs.n, cs.m
        kv, kc = len(cs.bv), len(cs.bc)
        self.kv, self.kc = kv, kc

        # ---- seed construction (vectorized scatter; the masked (block,
        # local-var) pairs index directly into the seed matrices)
        bidx, jidx = np.nonzero(cs.Vm)  # masked (N, nv) entries
        cols = cs.V[bidx, jidx]

        # Jacobian seeds: 2-coloring over interval parity + border
        SJ = np.zeros((2 * nv + kv, n), np.float64)
        SJ[(bidx % 2) * nv + jidx, cols] = 1.0
        SJ[2 * nv + np.arange(kv), cs.bv] = 1.0
        self.SJ = SJ

        # Hessian seeds: single color (H is block-diagonal + border)
        SH = np.zeros((nv + kv, n), np.float64)
        SH[jidx, cols] = 1.0
        SH[nv + np.arange(kv), cs.bv] = 1.0
        self.SH = SH
        self._seed_cache = {}  # dtype -> (SJ, SH) device arrays

        # gather column maps (per block, per local var) into compressed cols
        i_arange = np.arange(N)
        self.jcols_same = ((i_arange % 2)[:, None] * nv +
                           np.arange(nv)[None, :])  # (N, nv)
        self.jcols_next = (((i_arange + 1) % 2)[:, None] * nv +
                           np.arange(nv)[None, :])

    def _seeds(self, dtype):
        # cache the HOST dtype cast only; the jnp conversion must happen
        # fresh per call — caching a device constant created inside one jit
        # trace and reusing it in another is a tracer leak
        key = jnp.dtype(dtype).name
        if key not in self._seed_cache:
            npdt = np.dtype(key)
            self._seed_cache[key] = (self.SJ.astype(npdt),
                                     self.SH.astype(npdt))
        SJ, SH = self._seed_cache[key]
        return jnp.asarray(SJ), jnp.asarray(SH)

    # ------------------------------------------------------------ Jacobian
    def jac_blocks(self, z):
        """Returns dict of Jacobian blocks (masked, zero-padded):

        Jcv    (N, nc, nv)   J[C_i, V_i]
        Jc0v1  (N-1, nc, nv) J[C_i, V_{i+1}]
        Jc1v0  (N-1, nc, nv) J[C_{i+1}, V_i] — structurally zero
        Jcb    (N, nc, kv)   J[C_i, bv]
        Jbc    (kc, n)       exact border rows
        """
        cs = self.cs
        dtype = z.dtype
        SJ, _ = self._seeds(dtype)
        Jc = _seeded_jvp(self.c_fn, z, SJ, cs.N).T
        # exact border rows via reverse mode
        if self.kc:
            _, vjp = jax.vjp(self.c_fn, z)
            eye = jnp.zeros((self.kc, cs.m), dtype).at[
                jnp.arange(self.kc), jnp.asarray(cs.bc)].set(1.0)
            Jbc = jax.vmap(lambda ct: vjp(ct)[0])(eye)  # (kc, n)
        else:
            Jbc = jnp.zeros((0, cs.n), dtype)

        C = jnp.asarray(cs.C)
        mc = jnp.asarray(cs.Cm).astype(dtype)
        mv = jnp.asarray(cs.Vm).astype(dtype)
        mv_mask = mv[:, None, :]
        mc_mask = mc[:, :, None]
        jj_same = jnp.asarray(self.jcols_same)
        jj_next = jnp.asarray(self.jcols_next)

        def rows(block_rows):  # (B, nc) row indices -> (B, nc, 2nv+kv)
            return Jc[block_rows]

        JC = rows(C)  # (N, nc, ncols)
        Jcv = jnp.take_along_axis(
            JC, jnp.broadcast_to(jj_same[:, None, :],
                                 (cs.N, cs.nc, cs.nv)), axis=2) \
            * mc_mask * mv_mask
        Jc0v1 = jnp.take_along_axis(
            JC[:-1], jnp.broadcast_to(jj_next[:-1, None, :],
                                      (cs.N - 1, cs.nc, cs.nv)), axis=2) \
            * mc_mask[:-1] * mv[1:, None, :]
        # rows of con block i never touch var block i-1 (transcription
        # assembly order) — J is upper block-bidiagonal
        Jc1v0 = jnp.zeros((cs.N - 1, cs.nc, cs.nv), dtype)
        Jcb = JC[:, :, 2 * cs.nv:] * mc_mask  # (N, nc, kv)
        return dict(Jcv=Jcv, Jc0v1=Jc0v1, Jc1v0=Jc1v0, Jcb=Jcb, Jbc=Jbc)

    # ------------------------------------------------------------- Hessian
    def hess_blocks(self, lag_grad_fn, z, nu):
        """Blocks of H = d(lag_grad)/dz (Hessian of the Lagrangian):

        Hvv   (N, nv, nv)   H[V_i, V_i]
        Hv1v0 (N-1, nv, nv) H[V_{i+1}, V_i] — structurally zero
        Hvb   (N, nv, kv)   H[V_i, bv]
        Hbb   (kv, kv)      H[bv, bv]
        """
        cs = self.cs
        dtype = z.dtype
        _, SH = self._seeds(dtype)
        g_of = lambda zz: lag_grad_fn(zz, nu)
        Hc = _seeded_jvp(g_of, z, SH, cs.N).T  # (n, ncols)
        V = jnp.asarray(cs.V)
        mv = jnp.asarray(cs.Vm).astype(dtype)
        HV = Hc[V]  # (N, nv, ncols)
        Hvv = HV[:, :, :cs.nv] * mv[:, :, None] * mv[:, None, :]
        # symmetrize (fp only; structure is exact)
        Hvv = 0.5 * (Hvv + jnp.swapaxes(Hvv, 1, 2))
        # H has no cross-point coupling (all constraints/integrands are
        # linear combinations of per-grid-point functions)
        Hv1v0 = jnp.zeros((cs.N - 1, cs.nv, cs.nv), dtype)
        Hvb = HV[:, :, cs.nv:] * mv[:, :, None]  # (N, nv, kv)
        Hbb = Hc[jnp.asarray(cs.bv)][:, cs.nv:] if self.kv else \
            jnp.zeros((0, 0), dtype)
        if self.kv:
            Hbb = 0.5 * (Hbb + Hbb.T)
        return dict(Hvv=Hvv, Hv1v0=Hv1v0, Hvb=Hvb, Hbb=Hbb)

    # ------------------------------------------- scaling (gradient-based)
    def jac_row_inf_norms(self, z):
        """max_j |J[r, j]| per row, from one compressed pass (for IPOPT-style
        gradient-based NLP scaling). Valid because compressed columns of
        non-border rows never alias; border rows are exact."""
        jb = jax.device_get(jax.jit(self.jac_blocks)(z))
        cs = self.cs
        out = np.zeros(cs.m)
        JC_max = np.max(np.abs(jb["Jcv"]), axis=2)
        if self.kv:
            JC_max = np.maximum(JC_max, np.max(np.abs(jb["Jcb"]), axis=2))
        nxt = np.max(np.abs(jb["Jc0v1"]), axis=2)
        JC_max[:-1] = np.maximum(JC_max[:-1], nxt)
        for i in range(cs.N):
            idx = cs.C[i][cs.Cm[i]]
            out[idx] = JC_max[i][cs.Cm[i]]
        if self.kc:
            out[cs.bc] = np.max(np.abs(jb["Jbc"]), axis=1)
        return out


def assemble_kkt_blocks(hb, jb, sigma, delta_w, delta_c, cs:
                        CompiledStructure):
    """Build (D, L, B, C) of the permuted KKT matrix

        [[H + Sigma + delta_w I,  J^T     ],
         [J,                      -delta_c I]]

    ordered [v_0 c_0 | v_1 c_1 | ... | border], from Hessian/Jacobian blocks
    (see BlockDerivatives) and the diagonal barrier term ``sigma`` (n,).
    Padded rows/cols become identity rows with zero rhs.
    """
    N, nv, nc = cs.N, cs.nv, cs.nc
    kv, kc = len(cs.bv), len(cs.bc)
    Hvv, Hv1v0, Hvb, Hbb = hb["Hvv"], hb["Hv1v0"], hb["Hvb"], hb["Hbb"]
    dtype = Hvv.dtype
    V = jnp.asarray(cs.V)
    mv = jnp.asarray(cs.Vm).astype(dtype)
    mc = jnp.asarray(cs.Cm).astype(dtype)
    eye_v = jnp.eye(nv, dtype=dtype)

    sig_pad = jnp.concatenate([sigma, jnp.zeros(1, dtype)])
    Vs = jnp.where(jnp.asarray(cs.Vm), V, cs.n)
    sigV = sig_pad[Vs] * mv  # (N, nv)
    Dvv = Hvv + (sigV + delta_w * mv)[:, :, None] * eye_v + \
        eye_v * (1.0 - mv)[:, :, None]
    if nc:
        Jcv = jb["Jcv"]
        eye_c = jnp.eye(nc, dtype=dtype)
        Dcc = -delta_c * eye_c * mc[:, :, None] - \
            eye_c * (1.0 - mc)[:, :, None]
        D = jnp.concatenate([
            jnp.concatenate([Dvv, jnp.swapaxes(Jcv, 1, 2)], axis=2),
            jnp.concatenate([Jcv, Dcc], axis=2)], axis=1)
        Zcc = jnp.zeros((N - 1, nc, nc), dtype)
        L = jnp.concatenate([
            jnp.concatenate([Hv1v0, jnp.swapaxes(jb["Jc0v1"], 1, 2)],
                            axis=2),
            jnp.concatenate([jb["Jc1v0"], Zcc], axis=2)], axis=1)
    else:
        D = Dvv
        L = Hv1v0

    k = kv + kc
    if k == 0:
        return D, L, None, None
    if kc:
        Jbc = jb["Jbc"]
        Jbc_pad = jnp.concatenate([Jbc, jnp.zeros((kc, 1), dtype)], axis=1)
        Jbcv = jnp.transpose(Jbc_pad[:, Vs], (1, 2, 0)) * mv[:, :, None]
        Jbb = Jbc[:, jnp.asarray(cs.bv)] if kv else jnp.zeros((kc, 0),
                                                              dtype)
    else:
        Jbcv = jnp.zeros((N, nv, 0), dtype)
        Jbb = jnp.zeros((0, kv), dtype)
    Bv = jnp.concatenate([Hvb, Jbcv], axis=2)  # (N, nv, k)
    if nc:
        Jcb = jb["Jcb"] if kv else jnp.zeros((N, nc, 0), dtype)
        Bc = jnp.concatenate([Jcb, jnp.zeros((N, nc, kc), dtype)], axis=2)
        B = jnp.concatenate([Bv, Bc], axis=1)
    else:
        B = Bv
    if kv:
        sig_b = sig_pad[jnp.asarray(cs.bv)]
        Hbb_r = Hbb + jnp.diag(sig_b) + delta_w * jnp.eye(kv, dtype=dtype)
    else:
        Hbb_r = jnp.zeros((0, 0), dtype)
    C = jnp.block([[Hbb_r, Jbb.T],
                   [Jbb, -delta_c * jnp.eye(kc, dtype=dtype)]])
    return D, L, B, C


class BTBFac(NamedTuple):
    """Factorization of the bordered block-tridiagonal KKT matrix (pytree —
    carried through `lax.while_loop` so one factorization serves the Newton
    step, the second-order correction, and the feasibility fallback).

    Factor: O(N nb^3) scan of dense-block LUs. Solve: O(N nb^2) per rhs.
    """
    S_lu: jnp.ndarray  # (N, nb, nb) LU of Schur blocks
    S_piv: jnp.ndarray  # (N, nb)
    L: jnp.ndarray  # (N-1, nb, nb) subdiagonal blocks
    B: jnp.ndarray  # (N, nb, k) border blocks
    Tinv_B: jnp.ndarray  # (N, nb, k)
    Sb_lu: jnp.ndarray  # (k, k) LU of border Schur complement
    Sb_piv: jnp.ndarray  # (k,)


def _t_solve(S_lu, S_piv, L, rhs):
    """Solve T x = rhs with stored block factors. rhs (N, nb[, m])."""
    single = rhs.ndim == 2
    if single:
        rhs = rhs[..., None]

    def fwd(y_prev, inp):
        lu_i, piv_i, Li, ri = inp
        # y_i = r_i - L_{i-1} S_{i-1}^{-1} y_{i-1}
        yi = ri - Li @ lu_solve((lu_i, piv_i), y_prev)
        return yi, yi

    y0 = rhs[0]
    _, ys = jax.lax.scan(fwd, y0, (S_lu[:-1], S_piv[:-1], L, rhs[1:]))
    y = jnp.concatenate([y0[None], ys], axis=0)

    xN = lu_solve((S_lu[-1], S_piv[-1]), y[-1])

    def bwd(x_next, inp):
        lu_i, piv_i, Li, yi = inp
        xi = lu_solve((lu_i, piv_i), yi - Li.T @ x_next)
        return xi, xi

    _, xs = jax.lax.scan(bwd, xN, (S_lu[:-1], S_piv[:-1], L, y[:-1]),
                         reverse=True)
    x = jnp.concatenate([xs, xN[None]], axis=0)
    return x[..., 0] if single else x


def btb_factor(D, L, B=None, C=None) -> BTBFac:
    """Factor [[T, B],[B^T, C]]; T block-tridiagonal from (D, L)."""
    N, nb, _ = D.shape
    dtype = D.dtype
    S0_lu, S0_piv = lu_factor(D[0])

    def step(carry, inp):
        S_fac = carry
        Di, Li = inp
        W = lu_solve(S_fac, Li.T)
        Si_fac = lu_factor(Di - Li @ W)
        return Si_fac, Si_fac

    _, S_facs = jax.lax.scan(step, (S0_lu, S0_piv), (D[1:], L))
    S_lu = jnp.concatenate([S0_lu[None], S_facs[0]], axis=0)
    S_piv = jnp.concatenate([S0_piv[None], S_facs[1]], axis=0)

    if B is None or B.shape[-1] == 0:
        k = 0
        B = jnp.zeros((N, nb, 0), dtype)
        Tinv_B = B
        Sb_lu = jnp.zeros((0, 0), dtype)
        Sb_piv = jnp.zeros((0,), jnp.int32)
    else:
        Tinv_B = _t_solve(S_lu, S_piv, L, B)
        Sb = C - jnp.einsum("nik,nij->kj", B, Tinv_B)
        Sb_lu, Sb_piv = lu_factor(Sb)
    return BTBFac(S_lu, S_piv, L, B, Tinv_B, Sb_lu, Sb_piv)


def btb_solve(fac: BTBFac, rhs_T, rhs_C=None):
    """Solve [[T, B],[B^T, C]] [x; w] = [rhs_T; rhs_C] from a BTBFac."""
    if fac.B.shape[-1] == 0:
        return (_t_solve(fac.S_lu, fac.S_piv, fac.L, rhs_T),
                jnp.zeros((0,), rhs_T.dtype))
    Tinv_r = _t_solve(fac.S_lu, fac.S_piv, fac.L, rhs_T)
    w = lu_solve((fac.Sb_lu, fac.Sb_piv),
                 rhs_C - jnp.einsum("nik,ni->k", fac.B, Tinv_r))
    x = Tinv_r - jnp.einsum("nik,k->ni", fac.Tinv_B, w)
    return x, w


def block_H_diag(hb, cs: CompiledStructure, dtype):
    """diag(H) (n,) from Hessian blocks."""
    n = cs.n
    V = jnp.asarray(cs.V)
    Vs = jnp.where(jnp.asarray(cs.Vm), V, n)
    d = jnp.zeros(n + 1, dtype)
    dvv = jnp.diagonal(hb["Hvv"], axis1=1, axis2=2)  # (N, nv)
    d = d.at[Vs.ravel()].set(dvv.ravel())
    if len(cs.bv):
        d = d.at[jnp.asarray(cs.bv)].set(jnp.diagonal(hb["Hbb"]))
    return d[:n]


def block_H_matvec(hb, cs: CompiledStructure, v):
    """H @ v from Hessian blocks (block-diagonal + border)."""
    n = cs.n
    dtype = v.dtype
    V = jnp.asarray(cs.V)
    mv = jnp.asarray(cs.Vm).astype(dtype)
    Vs = jnp.where(jnp.asarray(cs.Vm), V, n)
    v_pad = jnp.concatenate([v, jnp.zeros(1, dtype)])
    vV = v_pad[Vs] * mv  # (N, nv)
    yV = jnp.einsum("nij,nj->ni", hb["Hvv"], vV)
    out = jnp.zeros(n + 1, dtype)
    if len(cs.bv):
        bv = jnp.asarray(cs.bv)
        vb = v[bv]
        yV = yV + jnp.einsum("nik,k->ni", hb["Hvb"], vb)
        yb = (jnp.einsum("nik,ni->k", hb["Hvb"], vV) + hb["Hbb"] @ vb)
        out = out.at[bv].set(yb)
    out = out.at[Vs.ravel()].add((yV * mv).ravel())
    return out[:n]


def pack_rhs(r1, r2, sigma_unused, cs: CompiledStructure):
    """Permute (r1 (n,), r2 (m,)) into (rhs_T (N, nb), rhs_C (k,))."""
    dtype = r1.dtype
    V = jnp.asarray(cs.V)
    C = jnp.asarray(cs.C)
    mv = jnp.asarray(cs.Vm).astype(dtype)
    mc = jnp.asarray(cs.Cm).astype(dtype)
    rT_v = r1[V] * mv
    rT_c = (r2[C] * mc) if cs.nc else jnp.zeros((cs.N, 0), dtype)
    rhs_T = jnp.concatenate([rT_v, rT_c], axis=1)
    rhs_C = jnp.concatenate([r1[jnp.asarray(cs.bv)]
                             if len(cs.bv) else jnp.zeros(0, dtype),
                             r2[jnp.asarray(cs.bc)]
                             if len(cs.bc) else jnp.zeros(0, dtype)])
    return rhs_T, rhs_C


def unpack_sol(x, w, cs: CompiledStructure, dtype):
    """Scatter permuted solution back to (dz (n,), dnu (m,))."""
    n, m, nv, nc = cs.n, cs.m, cs.nv, cs.nc
    kv = len(cs.bv)
    V = jnp.asarray(cs.V)
    C = jnp.asarray(cs.C)
    dz = jnp.zeros(n + 1, dtype)
    Vs = jnp.where(jnp.asarray(cs.Vm), V, n)
    dz = dz.at[Vs.ravel()].set(x[:, :nv].ravel())
    if kv:
        dz = dz.at[jnp.asarray(cs.bv)].set(w[:kv])
    dz = dz[:n]
    dnu = jnp.zeros(m + 1, dtype)
    if nc:
        Cs = jnp.where(jnp.asarray(cs.Cm), C, m)
        dnu = dnu.at[Cs.ravel()].set(x[:, nv:].ravel())
    if len(cs.bc):
        dnu = dnu.at[jnp.asarray(cs.bc)].set(w[kv:])
    dnu = dnu[:m]
    return dz, dnu


def dense_J_from_blocks(jb, cs: CompiledStructure):
    """Scatter Jacobian blocks into a dense (m, n) array (jit-safe).

    For problems small enough that one dense LU beats the block-tridiagonal
    scan, this still captures the compressed-derivative win: J costs
    2·nv + kv forward tangents instead of n.
    """
    dtype = jb["Jcv"].dtype
    m, n = cs.m, cs.n
    V = jnp.asarray(cs.V)
    C = jnp.asarray(cs.C)
    Vs = jnp.where(jnp.asarray(cs.Vm), V, n)
    Cs = jnp.where(jnp.asarray(cs.Cm), C, m)
    J = jnp.zeros((m + 1, n + 1), dtype)
    J = J.at[Cs[:, :, None], Vs[:, None, :]].set(jb["Jcv"])
    J = J.at[Cs[:-1, :, None], Vs[1:, None, :]].add(jb["Jc0v1"])
    if len(cs.bv):
        J = J.at[Cs[:, :, None], jnp.asarray(cs.bv)[None, None, :]].set(
            jb["Jcb"])
    if len(cs.bc):
        J = J.at[jnp.asarray(cs.bc), :n].set(jb["Jbc"])
    return J[:m, :n]


def dense_H_from_blocks(hb, cs: CompiledStructure):
    """Scatter Hessian blocks into a dense (n, n) array (jit-safe)."""
    dtype = hb["Hvv"].dtype
    n = cs.n
    V = jnp.asarray(cs.V)
    Vs = jnp.where(jnp.asarray(cs.Vm), V, n)
    H = jnp.zeros((n + 1, n + 1), dtype)
    H = H.at[Vs[:, :, None], Vs[:, None, :]].set(hb["Hvv"])
    if len(cs.bv):
        bv = jnp.asarray(cs.bv)
        H = H.at[Vs[:, :, None], bv[None, None, :]].set(hb["Hvb"])
        H = H.at[bv[None, None, :], Vs[:, :, None]].set(hb["Hvb"])
        H = H.at[bv[:, None], bv[None, :]].set(hb["Hbb"])
    return H[:n, :n]


# ------------------------------------------------------- testing utilities
def blocks_to_dense_J(jb, cs: CompiledStructure):
    """Assemble dense (m, n) Jacobian from blocks (testing only)."""
    J = np.zeros((cs.m, cs.n))
    Jcv = np.asarray(jb["Jcv"])
    Jc0v1 = np.asarray(jb["Jc0v1"])
    Jc1v0 = np.asarray(jb["Jc1v0"])
    Jcb = np.asarray(jb["Jcb"])
    for i in range(cs.N):
        ci = cs.C[i][cs.Cm[i]]
        vi = cs.V[i][cs.Vm[i]]
        J[np.ix_(ci, vi)] = Jcv[i][np.ix_(cs.Cm[i], cs.Vm[i])]
        if len(cs.bv):
            J[np.ix_(ci, cs.bv)] = Jcb[i][cs.Cm[i]]
        if i + 1 < cs.N:
            vnext = cs.V[i + 1][cs.Vm[i + 1]]
            J[np.ix_(ci, vnext)] = Jc0v1[i][np.ix_(cs.Cm[i], cs.Vm[i + 1])]
            cnext = cs.C[i + 1][cs.Cm[i + 1]]
            J[np.ix_(cnext, vi)] = Jc1v0[i][np.ix_(cs.Cm[i + 1], cs.Vm[i])]
    if len(cs.bc):
        J[cs.bc] = np.asarray(jb["Jbc"])
    return J


def blocks_to_dense_H(hb, cs: CompiledStructure):
    """Assemble dense (n, n) Hessian from blocks (testing only)."""
    H = np.zeros((cs.n, cs.n))
    Hvv = np.asarray(hb["Hvv"])
    Hv1v0 = np.asarray(hb["Hv1v0"])
    Hvb = np.asarray(hb["Hvb"])
    for i in range(cs.N):
        vi = cs.V[i][cs.Vm[i]]
        H[np.ix_(vi, vi)] = Hvv[i][np.ix_(cs.Vm[i], cs.Vm[i])]
        if len(cs.bv):
            H[np.ix_(vi, cs.bv)] = Hvb[i][cs.Vm[i]]
            H[np.ix_(cs.bv, vi)] = Hvb[i][cs.Vm[i]].T
        if i + 1 < cs.N:
            vn = cs.V[i + 1][cs.Vm[i + 1]]
            blk = Hv1v0[i][np.ix_(cs.Vm[i + 1], cs.Vm[i])]
            H[np.ix_(vn, vi)] = blk
            H[np.ix_(vi, vn)] = blk.T
    if len(cs.bv):
        H[np.ix_(cs.bv, cs.bv)] = np.asarray(hb["Hbb"])
    return H
