"""Linear tangent steering analytic regression.

Mirrors the reference's second analytic family (testMocoAnalytic.cpp:100-195,
Bryson & Ho 1975 sec. 2.4): a planar point mass steered by a thrust-DIRECTION
control (constant acceleration a at angle u), maximize final horizontal
speed subject to reaching height h at rest in vertical velocity at t=T.
The optimal control obeys tan(u(t)) = tan(u0) - c t (linear tangent law).
Model built like MocoStudyFactory::createLinearTangentSteeringStudy
(MocoStudyFactory.cpp:26-90)."""

import jax.numpy as jnp
import numpy as np
import pytest

A = 5.0
T = 1.0
H = 1.0


def analytic():
    from scipy.optimize import brentq

    def residual(angle):
        secx = 1.0 / np.cos(angle)
        tanx = np.tan(angle)
        return (1.0 / np.sin(angle) -
                np.log((secx + tanx) / (secx - tanx)) / (2 * tanx * tanx) -
                4 * H / (A * T * T))

    u0 = brentq(residual, 0.01, 0.99 * 0.5 * np.pi, xtol=1e-12)
    c = 2 * np.tan(u0) / T
    seci = 1.0 / np.cos(u0)
    tani = np.tan(u0)

    def state_of_angle(angle):
        secx = 1.0 / np.cos(angle)
        tanx = np.tan(angle)
        logterm = np.log((tani + seci) / (tanx + secx))
        tx = A / (c * c) * (seci - secx - tanx * logterm)
        ty = A / (2 * c * c) * ((tani - tanx) * seci -
                                (seci - secx) * tanx - logterm)
        vx = A / c * logterm
        vy = A / c * (seci - secx)
        return tx, ty, vx, vy

    return u0, c, state_of_angle


def build_study(num_mesh_intervals=50):
    from opensim_moco_tpu.models.factory import create_planar_point_mass
    from opensim_moco_tpu.ocp import CustomGoal, Problem, Study

    model = create_planar_point_mass(mass=1.0, gravity=(0.0, 0.0, 0.0))
    model._finalized = False
    model.actuators = []  # clearAndDestroy (MocoStudyFactory.cpp:66)

    def thrust(p, t, q, u, angle):
        return A * jnp.stack([jnp.cos(angle), jnp.sin(angle)])

    model.add_custom_control_force("actuator", thrust,
                                   min_control=-0.5 * np.pi,
                                   max_control=0.5 * np.pi)
    model.finalize()

    prob = Problem(model)
    prob.set_time_bounds(0, T)
    prob.set_state_info("/jointset/tx/tx/value", (0, 10), 0)
    prob.set_state_info("/jointset/ty/ty/value", (0, H), 0, H)
    prob.set_state_info("/jointset/tx/tx/speed", (0, 10), 0)
    prob.set_state_info("/jointset/ty/ty/speed", (0, 10), 0, 0)
    prob.set_control_info("/forceset/actuator", (-0.5 * np.pi, 0.5 * np.pi))
    # maximize final horizontal speed (LinearTangentFinalSpeed goal,
    # MocoStudyFactory.cpp:52-62); y layout: [q(2), u(2)] so u_x = y[2]
    prob.add_goal(CustomGoal(
        name="final_speed",
        value_fn=lambda rep, initial, final, integral, p: -final[1][2]))
    study = Study(prob)
    study.set_solver_options(transcription_scheme="hermite-simpson",
                             num_mesh_intervals=num_mesh_intervals)
    # this problem family needs the aggressive barrier schedule: with the
    # conservative default gate (kappa_eps=10) the iterate orbits at a
    # barrier-pressure error floor ~1e-3 that only clears once mu races
    # down (PERF.md, Findings); kappa_eps=100 + mu_init 1e-2 converges in
    # ~7 iterations at mesh 50
    study.set_ipm_options(tol=1e-6, max_iter=500, mu_init=1e-2,
                          kappa_eps=100.0)
    return study


def test_linear_tangent_steering():
    study = build_study(50)
    sol = study.solve()
    assert sol.success, sol.status

    u0, c, state_of_angle = analytic()
    t = sol.time
    expected_angle = np.arctan(np.tan(u0) - c * t)
    tx, ty, vx, vy = state_of_angle(expected_angle)

    # reference acceptance: abs tol 1e-3 on control and all four states
    # (testMocoAnalytic.cpp:185-195)
    np.testing.assert_allclose(sol.control("/forceset/actuator"),
                               expected_angle, atol=1e-3)
    np.testing.assert_allclose(sol.state("/jointset/tx/tx/value"), tx,
                               atol=1e-3)
    np.testing.assert_allclose(sol.state("/jointset/ty/ty/value"), ty,
                               atol=1e-3)
    np.testing.assert_allclose(sol.state("/jointset/tx/tx/speed"), vx,
                               atol=1e-3)
    np.testing.assert_allclose(sol.state("/jointset/ty/ty/speed"), vy,
                               atol=1e-3)
