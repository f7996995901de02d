"""Structured KKT solvers.

Direct-collocation KKT systems are block-banded in the time axis: defect
constraints couple only adjacent grid points (the reference documents the
same time-grouped sparsity for its Jacobians at CasOCTranscription.h:219-387),
while a thin "border" (initial/final time, parameters, endpoint/periodicity
constraints) couples everything. Ordered by mesh interval, the KKT matrix is

    K = [[T,   B ],       T: block-tridiagonal (N blocks of size nb)
         [B^T, C ]]       B: (N*nb, k) border, C: (k, k), k small

This module provides a bordered block-tridiagonal factor/solve built on
`lax.scan` (sequential over intervals, dense per-block ops that batch
across lanes) — O(N nb^3) instead of O((N nb)^3) for the dense path — and
its partitioned (parallel-in-time) variant for a mesh of devices. The IPM
consumes both through the same ``kkt_solve`` interface as the dense path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def block_tridiag_solve(D, L, rhs):
    """Solve T x = rhs for block-tridiagonal symmetric-indefinite T.

    D: (N, nb, nb) diagonal blocks; L: (N-1, nb, nb) sub-diagonal blocks
    (T[i+1, i] = L[i]; T[i, i+1] = L[i]^T); rhs: (N, nb) or (N, nb, m).

    Block LU without pivoting across blocks (each block solve uses dense
    LU with partial pivoting internally) — adequate for regularized IPM
    KKT systems which are quasi-definite.
    """
    single = rhs.ndim == 2
    if single:
        rhs = rhs[..., None]
    N, nb, _ = D.shape

    # forward elimination: S_0 = D_0; S_i = D_i - L_{i-1} S_{i-1}^{-1} L_{i-1}^T
    def fwd(carry, inp):
        S_prev, y_prev = carry
        Di, Li, ri = inp  # Li = L[i-1]
        W = jnp.linalg.solve(S_prev, Li.T)  # S_prev^{-1} L^T
        Si = Di - Li @ W
        yi = ri - Li @ jnp.linalg.solve(S_prev, y_prev)
        return (Si, yi), (Si, yi, W)

    S0 = D[0]
    y0 = rhs[0]
    (SN, yN), (S_all, y_all, W_all) = jax.lax.scan(
        fwd, (S0, y0), (D[1:], L, rhs[1:]))
    S_full = jnp.concatenate([S0[None], S_all], axis=0)
    y_full = jnp.concatenate([y0[None], y_all], axis=0)

    # back substitution: x_N = S_N^{-1} y_N; x_i = S_i^{-1}(y_i - L_i^T x_{i+1})
    xN = jnp.linalg.solve(S_full[-1], y_full[-1])

    def bwd(x_next, inp):
        Si, yi, Li = inp
        xi = jnp.linalg.solve(Si, yi - Li.T @ x_next)
        return xi, xi

    _, xs = jax.lax.scan(bwd, xN, (S_full[:-1], y_full[:-1], L),
                         reverse=True)
    x = jnp.concatenate([xs, xN[None]], axis=0)
    return x[..., 0] if single else x


def block_tridiag_solve_partitioned(D, L, rhs, axis_name):
    """Parallel-in-time block-tridiagonal solve for use inside shard_map.

    The grid axis is sharded over ``axis_name`` (SURVEY §2.8's CP
    analogue: the KKT system of a direct collocation problem is
    block-banded in the time axis — time-grouped sparsity documented at
    reference CasOCTranscription.h:219-387). Partition/SPIKE scheme:

    1. each device condenses its local chunk, expressing the local
       unknowns affinely in the two neighbor boundary blocks:
       ``x_loc = G - U x_left - V x_right`` (one multi-RHS local scan);
    2. the 2P boundary unknowns (first/last block of every chunk) form a
       small reduced system, assembled from an all_gather of the per-chunk
       (U, V, G) boundary rows and solved replicated on every device;
    3. local back-substitution.

    Per-device inputs: D (Nl, nb, nb); L (Nl, nb, nb) where L[i] couples
    local row i to row i+1 (the last row of the last shard is ignored);
    rhs (Nl, nb). Returns the local (Nl, nb) solution shard.
    """
    single = rhs.ndim == 2
    if single:
        rhs = rhs[..., None]
    idx = jax.lax.axis_index(axis_name)
    P_ = jax.lax.psum(1, axis_name)
    Nl, nb, _ = D.shape
    nrhs = rhs.shape[-1]
    dtype = D.dtype

    # neighbor coupling blocks: L_left = last L of the previous shard
    L_left = jax.lax.ppermute(L[-1], axis_name,
                              [(i, (i + 1) % P_) for i in range(P_)])
    is_first = idx == 0
    is_last = idx == P_ - 1
    L_left = jnp.where(is_first, jnp.zeros_like(L_left), L_left)
    L_right = jnp.where(is_last, jnp.zeros_like(L[-1]), L[-1])

    # local condensation: T_loc [G U V] = [rhs, E_f L_left, E_l L_right^T]
    RHS = jnp.zeros((Nl, nb, nrhs + 2 * nb), dtype=dtype)
    RHS = RHS.at[:, :, :nrhs].set(rhs)
    RHS = RHS.at[0, :, nrhs:nrhs + nb].set(L_left)
    RHS = RHS.at[Nl - 1, :, nrhs + nb:].set(L_right.T)
    sol = block_tridiag_solve(D, L[:-1], RHS)
    G = sol[..., :nrhs]               # (Nl, nb, nrhs)
    U = sol[..., nrhs:nrhs + nb]      # (Nl, nb, nb): coefficient of x_left
    V = sol[..., nrhs + nb:]          # (Nl, nb, nb): coefficient of x_right

    # reduced system over boundary unknowns y = [x_first^p, x_last^p]_p:
    # x_first^p = G_f - U_f x_last^{p-1} - V_f x_first^{p+1}
    # x_last^p  = G_l - U_l x_last^{p-1} - V_l x_first^{p+1}
    bnd = jnp.stack([G[0], G[-1]])                    # (2, nb, nrhs)
    Us = jnp.stack([U[0], U[-1]])                     # (2, nb, nb)
    Vs = jnp.stack([V[0], V[-1]])
    bnd_all = jax.lax.all_gather(bnd, axis_name)      # (P, 2, nb, nrhs)
    U_all = jax.lax.all_gather(Us, axis_name)         # (P, 2, nb, nb)
    V_all = jax.lax.all_gather(Vs, axis_name)
    m = 2 * P_ * nb
    A = jnp.eye(m, dtype=dtype)
    r = bnd_all.reshape(m, nrhs)

    def row(p, which):  # index of boundary unknown block
        return (2 * p + which) * nb

    for p in range(P_):
        for which in (0, 1):
            i0 = row(p, which)
            if p > 0:  # depends on x_last of p-1
                j0 = row(p - 1, 1)
                A = jax.lax.dynamic_update_slice(
                    A, U_all[p, which], (i0, j0))
            if p < P_ - 1:  # depends on x_first of p+1
                j0 = row(p + 1, 0)
                A = jax.lax.dynamic_update_slice(
                    A, V_all[p, which], (i0, j0))
    y = jnp.linalg.solve(A, r)                        # replicated small solve
    y = y.reshape(P_, 2, nb, nrhs)
    x_left = jnp.where(is_first, jnp.zeros((nb, nrhs), dtype),
                       y[jnp.maximum(idx - 1, 0), 1])
    x_right = jnp.where(is_last, jnp.zeros((nb, nrhs), dtype),
                        y[jnp.minimum(idx + 1, P_ - 1), 0])
    x = G - jnp.einsum("nij,jm->nim", U, x_left) - \
        jnp.einsum("nij,jm->nim", V, x_right)
    return x[..., 0] if single else x


def bordered_block_tridiag_solve_partitioned(D, L, B, C, rhs_T, rhs_C,
                                             axis_name):
    """Parallel-in-time bordered solve for use inside shard_map: the
    [[T, B], [B^T, C]] system of :func:`bordered_block_tridiag_solve`
    with the block-tridiagonal T partitioned over ``axis_name``.

    Per-device shards: D (Nl, nb, nb); L (Nl, nb, nb) with L[i] coupling
    local row i to i+1 (last row of the last shard ignored); B (Nl, nb, k);
    rhs_T (Nl, nb). Replicated: C (k, k), rhs_C (k,). Returns the local
    solution shard x (Nl, nb) and the replicated border solution w (k,).

    The border Schur complement S = C - B^T T^{-1} B is reduced with a
    psum over device shards — the collective that replaces the
    sequential full-grid scan of the replicated path (SURVEY §2.8).
    """
    k = B.shape[-1]
    if k == 0:
        x = block_tridiag_solve_partitioned(D, L, rhs_T, axis_name)
        return x, jnp.zeros((0,), D.dtype)
    RHS = jnp.concatenate([rhs_T[..., None], B], axis=-1)  # (Nl, nb, 1+k)
    sol = block_tridiag_solve_partitioned(D, L, RHS, axis_name)
    Tinv_r = sol[..., 0]
    Tinv_B = sol[..., 1:]
    BtTinvB = jax.lax.psum(jnp.einsum("nik,nij->kj", B, Tinv_B), axis_name)
    BtTinvr = jax.lax.psum(jnp.einsum("nik,ni->k", B, Tinv_r), axis_name)
    S = C - BtTinvB
    w = jnp.linalg.solve(S, rhs_C - BtTinvr)
    x = Tinv_r - jnp.einsum("nik,k->ni", Tinv_B, w)
    return x, w


def bordered_block_tridiag_solve(D, L, B, C, rhs_T, rhs_C):
    """Solve [[T, B], [B^T, C]] [x; w] = [rhs_T; rhs_C].

    D/L define block-tridiagonal T as in :func:`block_tridiag_solve`;
    B: (N, nb, k) border blocks; C: (k, k); rhs_T: (N, nb); rhs_C: (k,).

    Schur complement on the border: (C - B^T T^{-1} B) w = rhs_C - B^T T^{-1} rhs_T.
    """
    N, nb, k = B.shape
    # solve T [rhs_T, B] in one multi-rhs pass
    RHS = jnp.concatenate([rhs_T[..., None], B], axis=-1)  # (N, nb, 1+k)
    sol = block_tridiag_solve(D, L, RHS)
    Tinv_r = sol[..., 0]  # (N, nb)
    Tinv_B = sol[..., 1:]  # (N, nb, k)
    BtTinvB = jnp.einsum("nik,nij->kj", B, Tinv_B)
    BtTinvr = jnp.einsum("nik,ni->k", B, Tinv_r)
    S = C - BtTinvB
    w = jnp.linalg.solve(S, rhs_C - BtTinvr)
    x = Tinv_r - jnp.einsum("nik,k->ni", Tinv_B, w)
    return x, w


class CompiledStructure:
    """KKTStructure lowered to padded index arrays in a given index space.

    Blocks have unequal sizes (the last interval carries the final mesh
    point); they are padded to the maximum and masked. Padded rows/columns
    become identity rows with zero right-hand side, so the factorization
    shapes stay static for XLA.
    """

    def __init__(self, var_blocks, con_blocks, border_vars, border_cons,
                 n, m):
        N = len(var_blocks)
        assert N == len(con_blocks) and N >= 2
        self.N = N
        nv = max(len(b) for b in var_blocks)
        nc = max((len(b) for b in con_blocks), default=0)
        self.nv, self.nc = nv, nc
        V = np.zeros((N, nv), np.int32)
        Vm = np.zeros((N, nv), bool)
        C = np.zeros((N, nc), np.int32)
        Cm = np.zeros((N, nc), bool)
        for i, b in enumerate(var_blocks):
            V[i, :len(b)] = b
            Vm[i, :len(b)] = True
        for i, b in enumerate(con_blocks):
            C[i, :len(b)] = b
            Cm[i, :len(b)] = True
        self.V, self.Vm, self.C, self.Cm = V, Vm, C, Cm
        self.bv = np.asarray(border_vars, np.int32)
        self.bc = np.asarray(border_cons, np.int32)
        self.n, self.m = n, m
        # coverage check: every index appears exactly once
        all_v = np.concatenate([V[Vm].ravel(), self.bv])
        all_c = np.concatenate([C[Cm].ravel(), self.bc])
        assert len(all_v) == n and len(np.unique(all_v)) == n, \
            (len(all_v), n)
        assert len(all_c) == m and len(np.unique(all_c)) == m, \
            (len(all_c), m)

    def remap_free(self, free_idx):
        """Project onto the free-variable subspace (fixed variables
        eliminated by the solver): drops fixed variable indices and
        renumbers the rest."""
        n_full = self.n
        old_to_new = np.full(n_full, -1, np.int64)
        old_to_new[free_idx] = np.arange(len(free_idx))

        def remap_blocks(blocks_idx, blocks_mask):
            out = []
            for i in range(self.N):
                idx = blocks_idx[i][blocks_mask[i]]
                new = old_to_new[idx]
                out.append(new[new >= 0].tolist())
            return out

        vb = remap_blocks(self.V, self.Vm)
        bv = old_to_new[self.bv]
        bv = bv[bv >= 0]
        cb = [self.C[i][self.Cm[i]].tolist() for i in range(self.N)]
        return CompiledStructure(vb, cb, bv, self.bc, len(free_idx), self.m)


def structured_kkt_solve(H, J, delta_w, delta_c, cs: CompiledStructure,
                         r1, r2):
    """Solve [[H + delta_w I, J^T], [J, -delta_c I]] [dz; dnu] = [r1; r2]
    using the bordered block-tridiagonal structure.

    H: (n, n) Hessian of the Lagrangian (+ barrier Sigma on the diagonal),
    J: (m, n). Same semantics as the dense path in ipm.kkt_solve_rhs but
    O(N nb^3).
    """
    dtype = H.dtype
    N, nv, nc = cs.N, cs.nv, cs.nc
    V = jnp.asarray(cs.V)
    C = jnp.asarray(cs.C)
    mv = jnp.asarray(cs.Vm).astype(dtype)
    mc = jnp.asarray(cs.Cm).astype(dtype)
    bv = jnp.asarray(cs.bv)
    bc = jnp.asarray(cs.bc)
    kv, kc = len(cs.bv), len(cs.bc)
    h_diag = H.ndim == 1  # H given as a diagonal (feasibility fallback)

    # ---- diagonal blocks
    eye_v = jnp.eye(nv, dtype=dtype)
    if h_diag:
        Hvv = eye_v * (H[V] * mv)[:, :, None]
    else:
        Hvv = H[V[:, :, None], V[:, None, :]] * mv[:, :, None] * \
            mv[:, None, :]
    Dvv = Hvv + delta_w * eye_v * mv[:, :, None] + \
        eye_v * (1.0 - mv)[:, :, None]
    if nc:
        Jcv = J[C[:, :, None], V[:, None, :]] * mc[:, :, None] * \
            mv[:, None, :]
        eye_c = jnp.eye(nc, dtype=dtype)
        Dcc = -delta_c * eye_c * mc[:, :, None] - \
            eye_c * (1.0 - mc)[:, :, None]
        D = jnp.concatenate([
            jnp.concatenate([Dvv, jnp.swapaxes(Jcv, 1, 2)], axis=2),
            jnp.concatenate([Jcv, Dcc], axis=2)], axis=1)
    else:
        D = Dvv

    # ---- sub-diagonal blocks: rows of block i+1, cols of block i
    if h_diag:
        Hv1v0 = jnp.zeros((N - 1, nv, nv), dtype=dtype)
    else:
        Hv1v0 = H[V[1:, :, None], V[:-1, None, :]] * mv[1:, :, None] * \
            mv[:-1, None, :]
    if nc:
        Jc0v1T = jnp.swapaxes(
            J[C[:-1, :, None], V[1:, None, :]] * mc[:-1, :, None] *
            mv[1:, None, :], 1, 2)
        Jc1v0 = J[C[1:, :, None], V[:-1, None, :]] * mc[1:, :, None] * \
            mv[:-1, None, :]
        Zcc = jnp.zeros((N - 1, nc, nc), dtype=dtype)
        L = jnp.concatenate([
            jnp.concatenate([Hv1v0, Jc0v1T], axis=2),
            jnp.concatenate([Jc1v0, Zcc], axis=2)], axis=1)
    else:
        L = Hv1v0

    rT_v = r1[V] * mv
    rT_c = (r2[C] * mc) if nc else jnp.zeros((N, 0), dtype=dtype)
    rhs_T = jnp.concatenate([rT_v, rT_c], axis=1)

    k = kv + kc
    if k == 0:
        x = block_tridiag_solve(D, L, rhs_T)
        w = jnp.zeros(0, dtype=dtype)
    else:
        # border blocks
        if kv:
            Hvb = (jnp.zeros((N, nv, kv), dtype=dtype) if h_diag
                   else H[V][:, :, bv] * mv[:, :, None])
        else:
            Hvb = jnp.zeros((N, nv, 0), dtype=dtype)
        # J[bc] is (kc, n); J[bc][:, V] -> (kc, N, nv); move to (N, nv, kc)
        Jbcv = (jnp.transpose(J[bc][:, V], (1, 2, 0)) * mv[:, :, None]
                if kc else jnp.zeros((N, nv, 0), dtype=dtype))
        Bv = jnp.concatenate([Hvb, Jbcv], axis=2)  # (N, nv, k)
        if nc:
            Jcbv = (J[C][:, :, bv] * mc[:, :, None] if kv
                    else jnp.zeros((N, nc, 0), dtype=dtype))
            Zck = jnp.zeros((N, nc, kc), dtype=dtype)
            Bc = jnp.concatenate([Jcbv, Zck], axis=2)
            B = jnp.concatenate([Bv, Bc], axis=1)  # (N, nb, k)
        else:
            B = Bv
        # border diagonal
        if kv:
            Hbb = (jnp.diag(H[bv]) if h_diag else H[bv][:, bv]) + \
                delta_w * jnp.eye(kv, dtype=dtype)
        else:
            Hbb = jnp.zeros((0, 0), dtype=dtype)
        Jbb = J[bc][:, bv] if (kc and kv) else jnp.zeros((kc, kv),
                                                         dtype=dtype)
        Cb = jnp.block([
            [Hbb, Jbb.T],
            [Jbb, -delta_c * jnp.eye(kc, dtype=dtype)]]) \
            if (kv or kc) else jnp.zeros((0, 0), dtype=dtype)
        rhs_C = jnp.concatenate([r1[bv], r2[bc]])
        x, w = bordered_block_tridiag_solve(D, L, B, Cb, rhs_T, rhs_C)

    # ---- scatter back (padded lanes write to a scratch slot)
    n, m = cs.n, cs.m
    dz = jnp.zeros(n + 1, dtype=dtype)
    Vs = jnp.where(jnp.asarray(cs.Vm), V, n)
    dz = dz.at[Vs.ravel()].set(x[:, :nv].ravel())
    if kv:
        dz = dz.at[bv].set(w[:kv])
    dz = dz[:n]
    dnu = jnp.zeros(m + 1, dtype=dtype)
    if nc:
        Cs = jnp.where(jnp.asarray(cs.Cm), C, m)
        dnu = dnu.at[Cs.ravel()].set(x[:, nv:].ravel())
    if kc:
        dnu = dnu.at[bc].set(w[kv:])
    dnu = dnu[:m]
    return dz, dnu


def structured_feasibility_step(A, delta, cs: CompiledStructure, c):
    """x solving (A A^T + delta I) x = c via the structured KKT solver.

    Used by the IPM feasibility fallback (Gauss-Newton on ||c||^2): the
    augmented symmetric system [[-I, A^T], [A, delta I]] [y; x] = [0; c]
    eliminates to (A A^T + delta I) x = c with y = A^T x, and it has exactly
    the bordered block-tridiagonal shape structured_kkt_solve factors.
    Returns (y, x) = (A^T x, x); the fallback step is dz = -Dw * y.
    """
    dtype = A.dtype
    minus_one = -jnp.ones(cs.n, dtype=dtype)
    y, x = structured_kkt_solve(minus_one, A, jnp.zeros((), dtype),
                                -delta, cs, jnp.zeros(cs.n, dtype=dtype), c)
    return y, x


def dense_from_blocks(D, L, B=None, C=None):
    """Assemble the dense matrix (testing utility)."""
    N, nb, _ = D.shape
    n = N * nb
    k = 0 if C is None else C.shape[0]
    K = jnp.zeros((n + k, n + k), dtype=D.dtype)
    for i in range(N):
        K = K.at[i * nb:(i + 1) * nb, i * nb:(i + 1) * nb].set(D[i])
        if i < N - 1:
            K = K.at[(i + 1) * nb:(i + 2) * nb, i * nb:(i + 1) * nb].set(
                L[i])
            K = K.at[i * nb:(i + 1) * nb, (i + 1) * nb:(i + 2) * nb].set(
                L[i].T)
        if k:
            K = K.at[i * nb:(i + 1) * nb, n:].set(B[i])
            K = K.at[n:, i * nb:(i + 1) * nb].set(B[i].T)
    if k:
        K = K.at[n:, n:].set(C)
    return K
