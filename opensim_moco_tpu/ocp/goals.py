"""Goal library.

JAX-native re-design of the reference goal system
(reference Moco/Moco/MocoGoal/MocoGoal.h:77-452): every goal defines an
``integrand`` evaluated on the whole time grid (one fused vmap pass) and a
``value`` combining endpoint information with the integral. A goal is used
either as a cost term (weighted into the objective) or as an endpoint
constraint (``MocoGoal.h:97-116`` cost vs endpoint-constraint modes).

Inputs mirror the reference's IntegrandInput/GoalInput
(MocoGoal.h:156-215): time, full state y, controls x, multipliers lam,
parameters p, and the model for computed quantities.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Sequence

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class Goal:
    name: str = "goal"
    weight: float = 1.0
    mode: str = "cost"  # "cost" | "endpoint_constraint"
    # bounds for endpoint-constraint mode (per output element)
    constraint_bounds: tuple = (0.0, 0.0)
    divide_by_duration: bool = False

    # number of outputs in endpoint-constraint mode
    num_outputs: int = 1

    def hessian_block_local(self) -> bool:
        """True iff this goal's cost-mode ``value`` contributes no
        cross-time-block curvature to the Lagrangian Hessian, i.e. it is
        affine in the integral (whose integrand is per-grid-point) plus an
        arbitrary function of border variables (t0, tf, parameters) and of
        grid points within a SINGLE time block (e.g. only the initial or
        only the final point). The structured KKT path
        (solver/structured.py) compresses the Hessian assuming
        block-diagonal + border sparsity; a goal that couples initial and
        final points nonlinearly (PeriodicityGoal, AverageSpeedGoal in
        cost mode) or applies a nonlinear function of the integral would
        alias curvature into wrong blocks, so Transcription.kkt_structure
        returns None (dense path) unless every cost goal reports True.

        The base implementation is conservative: goals that do not
        override :meth:`value` are affine in the integral (safe); any
        override is assumed unsafe unless the subclass also overrides this
        method (or sets ``_VALUE_BLOCK_LOCAL = True`` when its value reads
        a single endpoint only).
        """
        if type(self).value is Goal.value:
            return True
        return bool(getattr(type(self), "_VALUE_BLOCK_LOCAL", False))

    def integrand(self, rep, t, y, x, lam, p):
        return jnp.zeros((), dtype=t.dtype)

    def value(self, rep, initial, final, integral, p):
        """initial/final are (t, y, x, lam) tuples; integral is the
        quadrature of :meth:`integrand`. Default: the integral itself."""
        t0 = initial[0]
        tf = final[0]
        val = integral
        if self.divide_by_duration:
            val = val / (tf - t0)
        return val


@dataclasses.dataclass
class ControlGoal(Goal):
    """Sum_i w_i |x_i|^p integrated over time
    (reference MocoControlGoal.cpp:30-80). Weights by control name or regex
    pattern; exponent >= 2 keeps smoothness (reference allows >=1 with
    abs smoothing; p=2 default... reference default exponent is 2)."""
    name: str = "control_effort"
    exponent: int = 2
    control_weights: dict = dataclasses.field(default_factory=dict)
    pattern_weights: dict = dataclasses.field(default_factory=dict)
    # MocoControlGoal::setDivideByDisplacement: normalize the integral by
    # the system COM displacement norm (MocoGoal.cpp:49-57) — "effort over
    # distance" in predictive gait problems (example2DWalking.cpp:278-280).
    divide_by_displacement: bool = False

    def value(self, rep, initial, final, integral, p):
        val = Goal.value(self, rep, initial, final, integral, p)
        if self.divide_by_displacement:
            m = rep.model
            q0 = initial[1][:m.mech.nq]
            qf = final[1][:m.mech.nq]
            mech_p = p["mech"] if isinstance(p, dict) and "mech" in p else p
            diff = (m.mech.mass_center(mech_p, qf) -
                    m.mech.mass_center(mech_p, q0))
            # smoothed norm: jnp.linalg.norm has a NaN gradient at zero
            # displacement (the cold bounds-midpoint guess), which poisons
            # the whole objective gradient via 0*nan
            d = jnp.sqrt(jnp.sum(diff ** 2) + 1e-16)
            val = val / d
        return val

    def hessian_block_local(self) -> bool:
        # dividing the integral by a nonlinear function of the endpoint
        # states couples every time block's curvature with the first/last
        # blocks -> must fall back to the dense KKT path
        return not self.divide_by_displacement

    def _weights(self, control_names):
        w = np.ones(len(control_names))
        for pat, pw in self.pattern_weights.items():
            for i, cn in enumerate(control_names):
                if re.fullmatch(pat, cn):
                    w[i] = pw
        for cn, cw in self.control_weights.items():
            w[control_names.index(cn)] = cw
        return w

    def integrand(self, rep, t, y, x, lam, p):
        w = jnp.asarray(self._weights(rep.control_names), dtype=x.dtype)
        if self.exponent == 2:
            return jnp.sum(w * x * x)
        return jnp.sum(w * jnp.abs(x) ** self.exponent)


@dataclasses.dataclass
class FinalTimeGoal(Goal):
    """Minimize final time (reference MocoFinalTimeGoal, MocoGoal.h)."""
    name: str = "final_time"
    _VALUE_BLOCK_LOCAL = True  # value reads border vars (tf) only

    def value(self, rep, initial, final, integral, p):
        return final[0]


@dataclasses.dataclass
class StateTrackingGoal(Goal):
    """Weighted squared tracking of reference state trajectories
    (reference MocoStateTrackingGoal.h). ``reference`` maps state name ->
    (times (K,), values (K,)); linear interpolation inside the graph."""
    name: str = "state_tracking"
    reference: dict = dataclasses.field(default_factory=dict)
    state_weights: dict = dataclasses.field(default_factory=dict)
    scale_by_range: bool = False

    def integrand(self, rep, t, y, x, lam, p):
        total = jnp.zeros((), dtype=t.dtype)
        for name, (times, values) in self.reference.items():
            i = rep.state_names.index(name)
            w = self.state_weights.get(name, 1.0)
            if self.scale_by_range:
                rng = float(np.max(values) - np.min(values))
                if rng > 1e-12:
                    w = w / rng ** 2
            ref = jnp.interp(t, jnp.asarray(times, dtype=t.dtype),
                             jnp.asarray(values, dtype=t.dtype))
            total = total + w * (y[i] - ref) ** 2
        return total


@dataclasses.dataclass
class SumSquaredStateGoal(Goal):
    """Sum of squared state values, with optional name regex
    (reference MocoSumSquaredStateGoal.h)."""
    name: str = "sum_squared_state"
    pattern: str = ".*"
    state_weights: dict = dataclasses.field(default_factory=dict)

    def integrand(self, rep, t, y, x, lam, p):
        total = jnp.zeros((), dtype=t.dtype)
        for i, sn in enumerate(rep.state_names):
            if re.fullmatch(self.pattern, sn):
                w = self.state_weights.get(sn, 1.0)
                total = total + w * y[i] ** 2
        return total


@dataclasses.dataclass
class MarkerFinalGoal(Goal):
    """Distance of a model station to a fixed point at final time
    (reference MocoMarkerFinalGoal)."""
    name: str = "marker_final"
    _VALUE_BLOCK_LOCAL = True  # value reads the final grid point only
    body: int = 0
    location: tuple = (0.0, 0.0, 0.0)
    target: tuple = (0.0, 0.0, 0.0)
    squared: bool = True

    def value(self, rep, initial, final, integral, p):
        tf, yf = final[0], final[1]
        q = yf[:rep.model.nq]
        pos = rep.model.mech.station_position(
            p["mech"], q, self.body, jnp.asarray(self.location,
                                                 dtype=yf.dtype))
        d2 = jnp.sum((pos - jnp.asarray(self.target, dtype=yf.dtype)) ** 2)
        return d2 if self.squared else jnp.sqrt(d2 + 1e-16)


@dataclasses.dataclass
class PeriodicityGoal(Goal):
    """Equate initial and final values of states/controls (optionally
    negated), endpoint-constraint capable
    (reference MocoPeriodicityGoal.h:1-147)."""
    name: str = "periodicity"
    mode: str = "endpoint_constraint"
    state_pairs: tuple = ()  # (name, negate) or (name_initial, name_final, negate)
    control_pairs: tuple = ()

    def __post_init__(self):
        self.num_outputs = len(self.state_pairs) + len(self.control_pairs)

    def _pair(self, names, pair):
        if len(pair) == 2 and isinstance(pair[1], bool):
            a = b = pair[0]
            negate = pair[1]
        elif isinstance(pair, str):
            a = b = pair
            negate = False
        else:
            a, b, negate = pair
        return names.index(a), names.index(b), negate

    def values(self, rep, initial, final, p):
        out = []
        y0, x0 = initial[1], initial[2]
        yf, xf = final[1], final[2]
        for pair in self.state_pairs:
            i, j, negate = self._pair(rep.state_names, pair)
            out.append(yf[j] + y0[i] if negate else yf[j] - y0[i])
        for pair in self.control_pairs:
            i, j, negate = self._pair(rep.control_names, pair)
            out.append(xf[j] + x0[i] if negate else xf[j] - x0[i])
        return jnp.stack(out) if out else jnp.zeros(0, dtype=y0.dtype)

    def value(self, rep, initial, final, integral, p):
        # cost mode: sum of squares of the pair errors
        v = self.values(rep, initial, final, p)
        return jnp.sum(v * v)


@dataclasses.dataclass
class InitialActivationGoal(Goal):
    """Penalize the gap between initial excitation and initial activation,
    preventing "free" initial activation (reference
    MocoInitialActivationGoal.cpp:41-57: cost = sum_i
    (excitation_i(t0) - activation_i(t0))^2)."""
    name: str = "initial_activation"
    _VALUE_BLOCK_LOCAL = True  # value reads the initial grid point only

    def value(self, rep, initial, final, integral, p):
        y0 = initial[1]
        x0 = initial[2]
        total = jnp.zeros((), dtype=y0.dtype)
        m = rep.model
        aux0 = 0 if m.prescribed else 2 * m.nq
        mus_idx = {ms.name: mi for mi, ms in enumerate(m.muscles)}
        for k, (mname, kind) in enumerate(m._aux_index):
            if kind == "activation":
                exc = x0[len(m.actuators) + mus_idx[mname]]
                total = total + (exc - y0[aux0 + k]) ** 2
        return total


@dataclasses.dataclass
class AverageSpeedGoal(Goal):
    """(final_pos - initial_pos)/duration - desired = 0 on one coordinate
    (reference MocoAverageSpeedGoal, used by example2DWalking.cpp:275)."""
    name: str = "average_speed"
    mode: str = "endpoint_constraint"
    coord: int = 0
    desired_speed: float = 0.0
    # reference semantics: speed = |COM displacement| / duration
    # (MocoGoal.h:437-439); coord mode keeps a cheaper single-coordinate
    # variant for planar problems
    use_com: bool = False

    def values(self, rep, initial, final, p):
        t0, y0 = initial[0], initial[1]
        tf, yf = final[0], final[1]
        if self.use_com:
            m = rep.model
            mech_p = p["mech"] if isinstance(p, dict) and "mech" in p else p
            diff = (m.mech.mass_center(mech_p, yf[:m.mech.nq]) -
                    m.mech.mass_center(mech_p, y0[:m.mech.nq]))
            # smoothed norm: finite gradient at zero displacement (cold
            # initial guess has q0 == qf)
            d = jnp.sqrt(jnp.sum(diff ** 2) + 1e-16)
            avg = d / (tf - t0)
        else:
            avg = (yf[self.coord] - y0[self.coord]) / (tf - t0)
        return jnp.stack([avg - self.desired_speed])

    def value(self, rep, initial, final, integral, p):
        return self.values(rep, initial, final, p)[0] ** 2


@dataclasses.dataclass
class CustomGoal(Goal):
    """Escape hatch: arbitrary integrand/endpoint closures (the reference's
    MocoOutputGoal / scripting-custom-goal role)."""
    name: str = "custom"
    integrand_fn: Callable | None = None
    value_fn: Callable | None = None

    def hessian_block_local(self):
        # a user value_fn may couple initial/final points or be nonlinear
        # in the integral — force the dense KKT path in that case
        return self.value_fn is None

    def integrand(self, rep, t, y, x, lam, p):
        if self.integrand_fn is None:
            return jnp.zeros((), dtype=t.dtype)
        return self.integrand_fn(rep, t, y, x, lam, p)

    def value(self, rep, initial, final, integral, p):
        if self.value_fn is None:
            val = integral
            if self.divide_by_duration:
                val = val / (final[0] - initial[0])
            return val
        return self.value_fn(rep, initial, final, integral, p)


@dataclasses.dataclass
class MarkerTrackingGoal(Goal):
    """Squared error of model station positions vs reference marker
    trajectories (reference MocoMarkerTrackingGoal). ``markers`` maps
    marker name -> (body, location); ``reference`` maps marker name ->
    (times (K,), positions (K, 3)); weights per marker."""
    name: str = "marker_tracking"
    markers: dict = dataclasses.field(default_factory=dict)
    reference: dict = dataclasses.field(default_factory=dict)
    marker_weights: dict = dataclasses.field(default_factory=dict)

    def integrand(self, rep, t, y, x, lam, p):
        m = rep.model
        q = y[:m.nq]
        total = jnp.zeros((), dtype=t.dtype)
        for name, (body, loc) in self.markers.items():
            times, pos = self.reference[name]
            w = self.marker_weights.get(name, 1.0)
            model_pos = m.mech.station_position(
                p["mech"], q, body, jnp.asarray(loc, dtype=t.dtype))
            times = jnp.asarray(times, dtype=t.dtype)
            ref = jnp.stack([jnp.interp(t, times,
                                        jnp.asarray(pos[:, k], dtype=t.dtype))
                             for k in range(3)])
            total = total + w * jnp.sum((model_pos - ref) ** 2)
        return total


@dataclasses.dataclass
class ControlTrackingGoal(Goal):
    """Track control signals vs reference (reference
    MocoControlTrackingGoal.h:1-251). ``reference`` maps control name ->
    (times, values)."""
    name: str = "control_tracking"
    reference: dict = dataclasses.field(default_factory=dict)
    control_weights: dict = dataclasses.field(default_factory=dict)

    def integrand(self, rep, t, y, x, lam, p):
        total = jnp.zeros((), dtype=t.dtype)
        for name, (times, values) in self.reference.items():
            i = rep.control_names.index(name)
            w = self.control_weights.get(name, 1.0)
            ref = jnp.interp(t, jnp.asarray(times, dtype=t.dtype),
                             jnp.asarray(values, dtype=t.dtype))
            total = total + w * (x[i] - ref) ** 2
        return total


@dataclasses.dataclass
class TranslationTrackingGoal(Goal):
    """Track body-origin world positions (reference
    MocoTranslationTrackingGoal). ``reference``: body index ->
    (times, positions (K, 3))."""
    name: str = "translation_tracking"
    reference: dict = dataclasses.field(default_factory=dict)

    def integrand(self, rep, t, y, x, lam, p):
        m = rep.model
        q = y[:m.nq]
        frames = m.mech.frames(p["mech"], q)
        total = jnp.zeros((), dtype=t.dtype)
        for body, (times, pos) in self.reference.items():
            A, o = frames[body]
            times = jnp.asarray(times, dtype=t.dtype)
            ref = jnp.stack([jnp.interp(t, times,
                                        jnp.asarray(pos[:, k], dtype=t.dtype))
                             for k in range(3)])
            total = total + jnp.sum((o - ref) ** 2)
        return total


@dataclasses.dataclass
class OrientationTrackingGoal(Goal):
    """Track body orientations as rotation-matrix Frobenius error
    (reference MocoOrientationTrackingGoal uses quaternion distance; the
    Frobenius form is an equivalent smooth metric). ``reference``: body ->
    (times, rotmats (K, 3, 3) world->body)."""
    name: str = "orientation_tracking"
    reference: dict = dataclasses.field(default_factory=dict)

    def integrand(self, rep, t, y, x, lam, p):
        m = rep.model
        q = y[:m.nq]
        frames = m.mech.frames(p["mech"], q)
        total = jnp.zeros((), dtype=t.dtype)
        for body, (times, mats) in self.reference.items():
            A, o = frames[body]
            times = jnp.asarray(times, dtype=t.dtype)
            ref = jnp.stack([
                jnp.stack([jnp.interp(t, times,
                                      jnp.asarray(mats[:, r, c],
                                                  dtype=t.dtype))
                           for c in range(3)])
                for r in range(3)])
            total = total + jnp.sum((A - ref) ** 2)
        return total


@dataclasses.dataclass
class AngularVelocityTrackingGoal(Goal):
    """Track body angular velocities in world (reference
    MocoAngularVelocityTrackingGoal). ``reference``: body ->
    (times, omegas (K, 3))."""
    name: str = "angular_velocity_tracking"
    reference: dict = dataclasses.field(default_factory=dict)

    def integrand(self, rep, t, y, x, lam, p):
        import jax

        m = rep.model
        q = y[:m.nq]
        u = y[m.nq:2 * m.nq]
        total = jnp.zeros((), dtype=t.dtype)
        for body, (times, omegas) in self.reference.items():
            # world angular velocity from dA/dt = -skew(omega_body) A ...
            # use jvp of the rotation: Adot = dA/dq * u; omega_world skew =
            # A^T Adot gives body-frame; map to world with A^T
            def rot(qq, b=body):
                return m.mech.frames(p["mech"], qq)[b][0]

            A, Adot = jax.jvp(rot, (q,), (u,))
            W = Adot @ A.T  # = -skew(omega in frame coords)
            omega_frame = jnp.stack([W[2, 1], W[0, 2], W[1, 0]])
            omega_world = A.T @ (-omega_frame)
            times = jnp.asarray(times, dtype=t.dtype)
            ref = jnp.stack([jnp.interp(t, times,
                                        jnp.asarray(omegas[:, k],
                                                    dtype=t.dtype))
                             for k in range(3)])
            total = total + jnp.sum((omega_world - ref) ** 2)
        return total


@dataclasses.dataclass
class OutputGoal(Goal):
    """Minimize an arbitrary model output by closure (reference
    MocoOutputGoal.h: minimize any model output by path)."""
    name: str = "output"
    output_fn: Callable | None = None  # (rep, t, y, x, lam, p) -> scalar
    exponent: int = 1

    def integrand(self, rep, t, y, x, lam, p):
        v = self.output_fn(rep, t, y, x, lam, p)
        return v ** self.exponent if self.exponent != 1 else v


@dataclasses.dataclass
class ContactTrackingGoal(Goal):
    """Track external-load GRFs with groups of contact-force components
    (reference MocoContactTrackingGoal.cpp:240-304). ``groups`` is a tuple
    of (contact_names, ref_key); ``reference`` maps ref_key ->
    (times (K,), forces (K, 3)) in ground. The squared error is normalized
    by total model weight (m * |g|) like the reference
    (MocoContactTrackingGoal.cpp:76-82) and optionally projected onto a
    vector or a plane (``projection``: none|vector|plane)."""
    name: str = "contact_tracking"
    groups: tuple = ()
    reference: dict = dataclasses.field(default_factory=dict)
    projection: str = "none"
    projection_vector: tuple = (0.0, 1.0, 0.0)

    def integrand(self, rep, t, y, x, lam, p):
        m = rep.model
        q = y[:m.nq]
        u = y[m.nq:2 * m.nq]
        forces = m.contact_forces(p, t, q, u)
        denom = jnp.sum(p["mech"]["mass"]) * \
            jnp.linalg.norm(p["mech"]["gravity"])
        total = jnp.zeros((), dtype=t.dtype)
        for names, ref_key in self.groups:
            f_model = jnp.zeros(3, dtype=t.dtype)
            for n in names:
                f_model = f_model + forces[n]
            times, vals = self.reference[ref_key]
            times = jnp.asarray(times, dtype=t.dtype)
            f_ref = jnp.stack([
                jnp.interp(t, times, jnp.asarray(vals[:, k], dtype=t.dtype))
                for k in range(3)])
            err = f_model - f_ref
            if self.projection == "vector":
                v = jnp.asarray(self.projection_vector, dtype=t.dtype)
                v = v / jnp.linalg.norm(v)
                err = jnp.dot(err, v) * v
            elif self.projection == "plane":
                v = jnp.asarray(self.projection_vector, dtype=t.dtype)
                v = v / jnp.linalg.norm(v)
                err = err - jnp.dot(err, v) * v
            total = total + jnp.sum(err * err)
        return total / denom


@dataclasses.dataclass
class AccelerationTrackingGoal(Goal):
    """Track body-origin linear accelerations in ground (reference
    MocoAccelerationTrackingGoal). ``reference``: body index ->
    (times, accels (K, 3)). ``gravity_offset`` adds -g to the model
    acceleration to mimic IMU accelerometer signals. Accelerations are
    computed from explicit forward dynamics at each grid point (consistent
    with the implicit-mode acceleration variables at convergence)."""
    name: str = "acceleration_tracking"
    reference: dict = dataclasses.field(default_factory=dict)
    gravity_offset: bool = False

    def integrand(self, rep, t, y, x, lam, p):
        import jax

        m = rep.model
        q = y[:m.nq]
        u = y[m.nq:2 * m.nq]
        z = y[2 * m.nq:]
        udot = m.multibody_explicit(p, t, q, u, z, x, lam)
        total = jnp.zeros((), dtype=t.dtype)
        for body, (times, accs) in self.reference.items():
            def vel(qq, uu, b=body):
                pos = lambda q_: m.mech.frames(p["mech"], q_)[b][1]
                return jax.jvp(pos, (qq,), (uu,))[1]

            _, acc = jax.jvp(vel, (q, u), (u, udot))
            if self.gravity_offset:
                acc = acc - p["mech"]["gravity"].astype(t.dtype)
            times = jnp.asarray(times, dtype=t.dtype)
            ref = jnp.stack([
                jnp.interp(t, times, jnp.asarray(accs[:, k], dtype=t.dtype))
                for k in range(3)])
            total = total + jnp.sum((acc - ref) ** 2)
        return total


@dataclasses.dataclass
class JointReactionGoal(Goal):
    """Minimize joint reaction loads (reference
    MocoJointReactionGoal.cpp:117-154): integrand = sum_i w_i r_i^2 over
    the selected reaction measures of one joint, expressed in ground.
    ``joint`` is the child body index; ``measures`` selects components from
    ("moment-x","moment-y","moment-z","force-x","force-y","force-z")."""
    name: str = "joint_reaction"
    joint: int = 0
    measures: tuple = ("moment-x", "moment-y", "moment-z",
                       "force-x", "force-y", "force-z")
    measure_weights: dict = dataclasses.field(default_factory=dict)

    _IDX = {"moment-x": 0, "moment-y": 1, "moment-z": 2,
            "force-x": 3, "force-y": 4, "force-z": 5}

    def integrand(self, rep, t, y, x, lam, p):
        m = rep.model
        q = y[:m.nq]
        u = y[m.nq:2 * m.nq]
        z = y[2 * m.nq:]
        reac = m.joint_reaction(p, t, q, u, z, x, lam)[self.joint]
        total = jnp.zeros((), dtype=t.dtype)
        for meas in self.measures:
            w = self.measure_weights.get(meas, 1.0)
            total = total + w * reac[self._IDX[meas]] ** 2
        return total


@dataclasses.dataclass
class InitialVelocityEquilibriumDGFGoal(Goal):
    """Velocity-level DGF muscle-tendon equilibrium at the initial time
    (reference MocoInitialVelocityEquilibriumDGFGoal.cpp:23-55): per
    compliant-tendon muscle, the derivative of the linearized equilibrium
    residual, as an endpoint constraint (or sum of squares in cost mode).
    Requires implicit tendon dynamics (reads the initial tendon-force
    derivative variables from the iterate)."""
    name: str = "initial_velocity_equilibrium"
    _VALUE_BLOCK_LOCAL = True  # value reads the initial grid point only
    mode: str = "endpoint_constraint"

    def auto_outputs(self, rep):
        return sum(1 for m in rep.model.muscles
                   if not m.ignore_tendon_compliance)

    def _residuals(self, rep, initial, p):
        from ..models import muscle as dgf

        m = rep.model
        t0, y0, x0 = initial[0], initial[1], initial[2]
        d0 = initial[4] if len(initial) > 4 else None
        q, u, z = m.split_state(y0)
        lMT, vMT = m.muscle_path_kinematics(p, q, u)
        res = []
        for mi, mspec in enumerate(m.muscles):
            if mspec.ignore_tendon_compliance:
                continue
            mp = {k: v[mi] for k, v in p["muscles"].items()}
            act, ft = m.muscle_state(z, x0, mi)
            dft = jnp.zeros((), dtype=y0.dtype)
            if mspec.tendon_dynamics_implicit and d0 is not None \
                    and d0.shape[0]:
                # derivative block layout: [udot (implicit mb) | zeta];
                # zeta always occupies the tail
                didx = int(m._mv["imp_didx"][mi])
                zeta0 = d0[d0.shape[0] - m.n_implicit_aux:]
                dft = zeta0[didx]
            r = dgf.linearized_equilibrium_residual_derivative(
                mp, act, ft, dft, lMT[mi], vMT[mi],
                mspec.ignore_passive_fiber_force)
            res.append(r / mp["max_isometric_force"])
        return jnp.stack(res) if res else jnp.zeros(0, dtype=y0.dtype)

    def values(self, rep, initial, final, p):
        return self._residuals(rep, initial, p)

    def value(self, rep, initial, final, integral, p):
        r = self._residuals(rep, initial, p)
        return jnp.sum(r * r)


@dataclasses.dataclass
class InitialForceEquilibriumGoal(Goal):
    """Muscle-tendon force equilibrium at the initial time for
    compliant-tendon muscles (reference MocoInitialForceEquilibriumGoal),
    usable in cost or endpoint-constraint mode."""
    name: str = "initial_force_equilibrium"
    _VALUE_BLOCK_LOCAL = True  # value reads the initial grid point only

    def auto_outputs(self, rep):
        return sum(1 for m in rep.model.muscles
                   if not m.ignore_tendon_compliance)

    def _residuals(self, rep, initial, p):
        from ..models import muscle as dgf

        m = rep.model
        t0, y0, x0 = initial[0], initial[1], initial[2]
        q, u, z = m.split_state(y0)
        lMT, vMT = m.muscle_path_kinematics(p, q, u)
        res = []
        for mi, mspec in enumerate(m.muscles):
            if mspec.ignore_tendon_compliance:
                continue
            mp = {k: v[mi] for k, v in p["muscles"].items()}
            act, ft = m.muscle_state(z, x0, mi)
            r = dgf.implicit_tendon_residual(mp, act, ft, 0.0, lMT[mi],
                                             vMT[mi],
                                             mspec.ignore_passive_fiber_force)
            res.append(r / mp["max_isometric_force"])
        return jnp.stack(res) if res else jnp.zeros(0, dtype=y0.dtype)

    def values(self, rep, initial, final, p):
        return self._residuals(rep, initial, p)

    def value(self, rep, initial, final, integral, p):
        r = self._residuals(rep, initial, p)
        return jnp.sum(r * r)
