"""Interior-point solver vs problems with known optima.

HS071 is the same benchmark the reference's tropter stack validates against
(reference tropter/tests/test_eigen_adolc_reverse_mode.cpp:770 and the
IPOPT documentation)."""

import jax
import jax.numpy as jnp
import numpy as np

from opensim_moco_tpu.solver import NLP, IPMOptions, make_solver


def test_unconstrained_rosenbrock():
    def f(z):
        return 100.0 * (z[1] - z[0] ** 2) ** 2 + (1 - z[0]) ** 2

    nlp = NLP(n=2, m=0, objective=f,
              constraints=lambda z: jnp.zeros((0,), z.dtype),
              lb=jnp.full(2, -jnp.inf), ub=jnp.full(2, jnp.inf))
    solve = jax.jit(make_solver(nlp, IPMOptions(tol=1e-8)))
    res = solve(jnp.array([-1.2, 1.0]))
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.z), [1.0, 1.0], atol=1e-6)


def test_equality_constrained_qp():
    # min 0.5 z'z  s.t.  z0 + z1 = 1  -> z = (0.5, 0.5)
    def f(z):
        return 0.5 * z @ z

    def c(z):
        return jnp.array([z[0] + z[1] - 1.0])

    nlp = NLP(n=2, m=1, objective=f, constraints=c,
              lb=jnp.full(2, -jnp.inf), ub=jnp.full(2, jnp.inf))
    solve = jax.jit(make_solver(nlp, IPMOptions(tol=1e-9)))
    res = solve(jnp.array([3.0, -1.0]))
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.z), [0.5, 0.5], atol=1e-7)
    np.testing.assert_allclose(float(res.nu[0]), -0.5, atol=1e-6)


def test_bounded_qp_active_bound():
    # min (z-2)^2 with z <= 1 -> z = 1
    def f(z):
        return (z[0] - 2.0) ** 2

    nlp = NLP(n=1, m=0, objective=f,
              constraints=lambda z: jnp.zeros((0,), z.dtype),
              lb=jnp.array([-5.0]), ub=jnp.array([1.0]))
    solve = jax.jit(make_solver(nlp, IPMOptions(tol=1e-8)))
    res = solve(jnp.array([0.0]))
    assert bool(res.converged)
    np.testing.assert_allclose(float(res.z[0]), 1.0, atol=1e-6)


def test_hs071():
    """Hock-Schittkowski 71: min x1 x4 (x1+x2+x3) + x3
    s.t. x1 x2 x3 x4 >= 25 (as equality with bounded slack),
         x1^2+x2^2+x3^2+x4^2 = 40, 1 <= x <= 5."""

    def f(z):
        x = z[:4]
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    def c(z):
        x, s = z[:4], z[4]
        return jnp.array([
            x[0] * x[1] * x[2] * x[3] - s,
            x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2 - 40.0,
        ])

    lb = jnp.array([1.0, 1.0, 1.0, 1.0, 25.0])
    ub = jnp.array([5.0, 5.0, 5.0, 5.0, jnp.inf])
    nlp = NLP(n=5, m=2, objective=f, constraints=c, lb=lb, ub=ub)
    solve = jax.jit(make_solver(nlp, IPMOptions(tol=1e-8, max_iter=200)))
    res = solve(jnp.array([1.0, 5.0, 5.0, 1.0, 25.0]))
    assert bool(res.converged)
    np.testing.assert_allclose(
        np.asarray(res.z[:4]),
        [1.00000000, 4.74299963, 3.82114998, 1.37940829], atol=1e-5)
    np.testing.assert_allclose(float(res.f), 17.0140173, atol=1e-5)


def test_vmapped_batch_of_starts():
    """Batch solves from different starting points all converge (the DP
    analogue: thousands of independent solves per chip)."""

    def f(z):
        return 0.5 * z @ z

    def c(z):
        return jnp.array([z[0] + 2.0 * z[1] - 2.0])

    nlp = NLP(n=2, m=1, objective=f, constraints=c,
              lb=jnp.full(2, -jnp.inf), ub=jnp.full(2, jnp.inf))
    solve = jax.jit(jax.vmap(make_solver(nlp, IPMOptions(tol=1e-9))))
    z0s = jnp.stack([jnp.array([0.0, 0.0]), jnp.array([10.0, -3.0]),
                     jnp.array([-4.0, 4.0])])
    res = solve(z0s)
    assert bool(jnp.all(res.converged))
    expected = np.array([0.4, 0.8])
    for i in range(3):
        np.testing.assert_allclose(np.asarray(res.z[i]), expected, atol=1e-7)


def test_kkt_iterative_refinement_f32():
    """fp32 factorization + operator-form iterative refinement (SURVEY §7
    scheme for float32 solves): refinement must reach a
    tighter tolerance in f32 than the plain f32 solve on an
    ill-conditioned problem."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from opensim_moco_tpu.solver.ipm import IPMOptions, make_solver
    from opensim_moco_tpu.solver.nlp import NLP

    # ill-conditioned QP: min 0.5 x^T Q x - b^T x  s.t. A x = c, x >= lb
    rng = np.random.default_rng(0)
    n, m = 40, 12
    U = np.linalg.qr(rng.standard_normal((n, n)))[0]
    Q = (U * np.logspace(0, 6, n)) @ U.T
    b = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    c = A @ rng.standard_normal(n) * 0.1

    def obj(z):
        return 0.5 * z @ jnp.asarray(Q, jnp.float32) @ z - \
            jnp.asarray(b, jnp.float32) @ z

    def cons(z):
        return jnp.asarray(A, jnp.float32) @ z - jnp.asarray(c, jnp.float32)

    lb = np.full(n, -10.0)
    ub = np.full(n, 10.0)
    nlp = NLP(n=n, m=m, objective=obj, constraints=cons, lb=lb, ub=ub)
    z0 = jnp.zeros(n, jnp.float32)

    kkts = {}
    for refine in (0, 2):
        opts = IPMOptions(tol=1e-7, max_iter=80, mu_init=1e-2,
                          dense_factorization="chol-schur",
                          kkt_refine_iters=refine)
        res = jax.jit(make_solver(nlp, opts))(z0)
        kkts[refine] = float(res.kkt_error)
    # refinement should not be worse, and usually much better
    assert kkts[2] <= kkts[0] * 2.0, kkts
    assert np.isfinite(kkts[2])
