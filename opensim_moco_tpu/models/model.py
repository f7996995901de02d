"""Model composition: mechanics + actuators + muscles + forces.

JAX-native analogue of an OpenSim ``Model`` as consumed by Moco
(reference MocoProblemRep.cpp:36-531 instantiates/link models; the
two-model "disabled constraints + DiscreteForces + AccelerationMotion"
dance of MocoProblemRep.cpp:105-141 disappears here because dynamics are
explicit pure functions of ``(t, q, u, z, x, lam, p)``).

State layout (system order, matching
``createStateVariableNamesInSystemOrder``, MocoProblemRep.cpp:540):
``y = [q (nq), u (nq), z (naux)]`` with auxiliary states ordered per muscle
as [activation?, normalized_tendon_force?].

Control layout: one control per coordinate actuator, then one excitation
per muscle (order of addition).

Generalized forces from path actuators and point forces are obtained with
``jax.vjp`` (Jacobian-transpose of station/path kinematics) instead of the
reference's Simbody force-application machinery.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import muscle as dgf
from .mech import GROUND, MechModel


@dataclasses.dataclass(frozen=True)
class CoordinateActuatorSpec:
    """Applies tau = optimal_force * control at one coordinate
    (OpenSim CoordinateActuator; used by every reference example)."""
    name: str
    coord: int
    optimal_force: float = 1.0
    min_control: float = -jnp.inf
    max_control: float = jnp.inf


@dataclasses.dataclass(frozen=True)
class SpringGeneralizedForceSpec:
    """F = -stiffness (q - rest_length) - viscosity u  on one coordinate
    (OpenSim SpringGeneralizedForce, used by reference testMocoAnalytic.cpp
    for the Kirk 1998 problem)."""
    name: str
    coord: int
    stiffness: float = 0.0
    rest_length: float = 0.0
    viscosity: float = 0.0


@dataclasses.dataclass(frozen=True)
class MuscleSpec:
    """DeGrooteFregly2016 muscle acting along a straight-segment via-point
    path (GeometryPath analogue). Path points are tuples:

    * ``("fixed", body, (x, y, z))``
    * ``("conditional", body, (x, y, z), coord_idx, lo, hi)`` — active only
      while the coordinate is in [lo, hi] (OpenSim ConditionalPathPoint)
    * ``("moving", body, ((fx, cx), (fy, cy), (fz, cz)))`` — per-axis
      location functions of coordinates (OpenSim MovingPathPoint)

    ``wraps``: PathWrap entries ((WrapCylinderSpec, candidate_segments),
    ...) in PathWrapSet order. ``candidate_segments`` are 0-based indices
    into the path's straight segments; at evaluation the engaged segment
    is the one with the largest wrap detour (OpenSim applyWrapObjects
    tries each segment in the PathWrap range and keeps the wrap that
    deflects the path). Wraps listing the same single candidate segment
    are applied sequentially (chained) on it.
    """
    name: str
    path: tuple
    ignore_activation_dynamics: bool = False
    ignore_tendon_compliance: bool = False
    tendon_dynamics_implicit: bool = False
    ignore_passive_fiber_force: bool = False
    wraps: tuple = ()
    # excitation control bounds; replaceMuscles copies the source muscle's
    # minControl (= minimum_activation for Millard/Thelen, typically 0.01)
    # onto the DGF muscle (DeGrooteFregly2016Muscle.cpp:995-996)
    min_control: float = 0.0
    max_control: float = 1.0


@dataclasses.dataclass(frozen=True)
class SphereContactSpec:
    """SmoothSphereHalfSpaceForce vs the ground plane y=0 (the component
    the reference gait models use; it lives in opensim-core since
    2020-03-29, reference CHANGELOG.md:37-41 — formula re-derived from
    Serrancoli et al. 2019 / Falisse et al. 2019 smooth contact)."""
    name: str
    body: int
    location: tuple  # sphere center in body frame
    radius: float
    stiffness: float = 1e6  # plane-strain modulus (N/m^2-ish)
    dissipation: float = 2.0
    static_friction: float = 0.8
    dynamic_friction: float = 0.8
    viscous_friction: float = 0.5
    transition_velocity: float = 0.2
    constant_contact_force: float = 1e-5
    hertz_smoothing: float = 300.0
    hunt_crossley_smoothing: float = 50.0
    derivative_smoothing: float = 1e-5


def smooth_sphere_halfspace_force(cp_pos, cp_vel, spec: SphereContactSpec):
    """World force on the body at the sphere's lowest point vs plane y=0.

    Smooth Hertz + Hunt-Crossley dissipation + tanh friction
    (Serrancoli et al. 2019; parameter names match the reference XML:
    2D_gait.osim SmoothSphereHalfSpaceForce entries)."""
    cd = spec.derivative_smoothing
    indentation = -cp_pos[1]
    indentation_vel = -cp_vel[1]
    delta_s = jnp.sqrt(indentation ** 2 + cd)
    fH = (4.0 / 3.0) * spec.stiffness * jnp.sqrt(spec.radius) * \
        delta_s ** 1.5
    fH = fH * 0.5 * (1.0 + jnp.tanh(spec.hertz_smoothing * indentation))
    damp = 1.0 + 1.5 * spec.dissipation * indentation_vel
    fHC = fH * damp
    fn = fHC * 0.5 * (1.0 + jnp.tanh(spec.hunt_crossley_smoothing * damp)) \
        + spec.constant_contact_force
    # friction in the plane
    vt = jnp.sqrt(cp_vel[0] ** 2 + cp_vel[2] ** 2 + cd)
    vrel = vt / spec.transition_velocity
    mu = spec.dynamic_friction * jnp.tanh(vrel) + \
        spec.viscous_friction * vt
    ft = -mu * fn / vt
    return jnp.stack([ft * cp_vel[0], fn, ft * cp_vel[2]])


@dataclasses.dataclass(frozen=True)
class StationContactSpec:
    """Smooth station-vs-ground-plane contact
    (reference Components/StationPlaneContactForce.h:77-313).
    ``model`` selects the force law: "ackermann"
    (AckermannVanDenBogert2010Force, h:77-131, cubic spring; default),
    "meyer" (MeyerFregly2016Force, h:145-219, log-cosh spring; uses
    ``tscale``), or "esposito" (EspositoMiller2018Force, h:221-305,
    smoothed quadratic; uses ``depth_offset``)."""
    name: str
    body: int
    location: tuple
    stiffness: float = 5e7
    dissipation: float = 1.0
    friction_coefficient: float = 1.0
    tangent_velocity_scaling: float = 0.05
    model: str = "ackermann"
    tscale: float = 1.0
    depth_offset: float = 0.001


def avdb_contact_force(pos, vel, stiffness, dissipation, friction_coefficient,
                       tangent_velocity_scaling):
    """AckermannVanDenBogert2010 smooth contact, world force at the station.

    Mirrors StationPlaneContactForce.h:98-131: cubic normal force with
    dissipation, a small "void stiffness", and tanh friction transition.
    """
    y = pos[1]
    depth = -y
    depth_rate = -vel[1]
    fy = jnp.maximum(0.0, stiffness * depth ** 3 * (1 + dissipation *
                                                    depth_rate))
    fy = jnp.where(depth > 0, fy, 0.0)
    void_stiffness = 1.0
    fy = fy + void_stiffness * depth
    transition = jnp.tanh(vel[0] / tangent_velocity_scaling / 2.0)
    fx = -transition * friction_coefficient * fy
    return jnp.stack([fx, fy, jnp.zeros_like(fx)])


def meyer_fregly_contact_force(pos, vel, stiffness, dissipation, tscale):
    """MeyerFregly2016 smooth contact (StationPlaneContactForce.h:145-219):
    log-cosh spring blending a tiny out-of-contact stiffness ``klow`` into
    the in-contact stiffness, times a Hunt-Crossley dissipation factor;
    tanh friction with mu_d = 1, latch velocity 0.05 m/s."""
    y = pos[1]
    depth_rate = -vel[1]
    klow = 1e-1 / (tscale * tscale)
    h = 1e-3
    c = 5e-4
    ymax = 1e-2
    vp = (stiffness + klow) / (stiffness - klow)
    sp = (stiffness - klow) / 2.0
    # log(cosh(x)) overflows float for |x| >~ 350; use |x| - log 2 tail
    xo = (y + h) / c
    log_cosh = jnp.where(jnp.abs(xo) > 30.0, jnp.abs(xo) - np.log(2.0),
                         jnp.log(jnp.cosh(jnp.clip(xo, -30.0, 30.0))))
    constant = -sp * (vp * ymax - c * np.log(np.cosh((ymax + h) / c)))
    f_spring = -sp * (vp * y - c * log_cosh) - constant
    fy = f_spring * (1.0 + dissipation * depth_rate)
    mu = jnp.tanh(vel[0] / 0.05 / 2.0)
    fx = -fy * mu
    return jnp.stack([fx, fy, jnp.zeros_like(fx)])


def esposito_miller_contact_force(pos, vel, stiffness, dissipation,
                                  friction_coefficient,
                                  tangent_velocity_scaling, depth_offset):
    """EspositoMiller2018 smooth contact (StationPlaneContactForce.h:221-305):
    dy = (sqrt(depth^2 + offset^2) + depth)/2 smoothly gates the quadratic
    spring; Hunt-Crossley dissipation; tanh friction."""
    depth = -pos[1]
    depth_rate = -vel[1]
    dy = 0.5 * (jnp.sqrt(depth ** 2 + depth_offset ** 2) + depth)
    void_stiffness = 1.0
    fy = stiffness * dy ** 2 * (1.0 + dissipation * depth_rate) + \
        void_stiffness * depth
    transition = jnp.tanh(vel[0] / tangent_velocity_scaling)
    fx = -transition * friction_coefficient * fy
    return jnp.stack([fx, fy, jnp.zeros_like(fx)])


def station_contact_force(pos, vel, spec: StationContactSpec, stiffness,
                          dissipation, friction_coefficient):
    """Dispatch on the (static) contact model of a StationContactSpec."""
    if spec.model == "meyer":
        return meyer_fregly_contact_force(pos, vel, stiffness, dissipation,
                                          spec.tscale)
    if spec.model == "esposito":
        return esposito_miller_contact_force(
            pos, vel, stiffness, dissipation, friction_coefficient,
            spec.tangent_velocity_scaling, spec.depth_offset)
    return avdb_contact_force(pos, vel, stiffness, dissipation,
                              friction_coefficient,
                              spec.tangent_velocity_scaling)


class Model:
    """Mutable builder; call :meth:`finalize` before use in a Problem."""

    def __init__(self, mech: MechModel):
        self.mech = mech
        self.actuators: list[CoordinateActuatorSpec] = []
        self.springs: list[SpringGeneralizedForceSpec] = []
        self.muscles: list[MuscleSpec] = []
        self._muscle_params: list[dict] = []
        self.contacts: list[StationContactSpec] = []
        self.sphere_contacts: list[SphereContactSpec] = []
        # measured external loads (OpenSim ExternalForce/ExternalLoads):
        # dicts with body, force_fn(t), point_fn(t), torque_fn(t)|None
        self.external_forces: list[dict] = []
        self.kinematic_constraints: list[tuple[str, Callable]] = []
        # MarkerSet analogue: marker name -> (body index, location in body
        # frame), populated by parse_osim for marker tracking
        # (reference MocoTrack.cpp:235)
        self.markers: dict[str, tuple] = {}
        # nonlinear scalar-controlled forces: (name, fn, min, max) with
        # fn(p, t, q, u, control) -> (nq,) generalized forces
        self.custom_control_forces: list[tuple] = []
        # CoordinateCouplerConstraint metadata (dep_idx, ind_idx, fn) so
        # tools can project dependent coordinates onto the constraint
        # manifold, like the reference's assembled StatesTrajectory
        # (MocoInverse.cpp:63-66)
        self.couplers: list[tuple] = []
        # PositionMotion analogue (reference Components/PositionMotion.h):
        # (params, t) -> (q, u, udot); removes multibody states entirely
        self.position_motion: Callable | None = None
        self._finalized = False

    # ------------------------------------------------------------- builders
    def coord_index(self, coord_name: str) -> int:
        return self.mech.coord_names.index(coord_name)

    def add_coordinate_actuator(self, name, coord, optimal_force=1.0,
                                min_control=-np.inf, max_control=np.inf):
        ci = self.coord_index(coord) if isinstance(coord, str) else coord
        self.actuators.append(CoordinateActuatorSpec(
            name, ci, float(optimal_force), float(min_control),
            float(max_control)))

    def add_spring_generalized_force(self, name, coord, stiffness=0.0,
                                     rest_length=0.0, viscosity=0.0):
        ci = self.coord_index(coord) if isinstance(coord, str) else coord
        self.springs.append(SpringGeneralizedForceSpec(
            name, ci, float(stiffness), float(rest_length), float(viscosity)))

    def add_muscle(self, name, path, params=None,
                   ignore_activation_dynamics=False,
                   ignore_tendon_compliance=False,
                   tendon_dynamics_implicit=False,
                   ignore_passive_fiber_force=False,
                   wraps=(), min_control=0.0, max_control=1.0):
        if params is None:
            params = dgf.default_muscle_params()
        norm_path = []
        norm_wraps = list(wraps)
        for pt in path:
            if isinstance(pt[0], str):
                if pt[0] == "wrap":
                    # legacy inline marker: wrap pinned to the segment it
                    # was inserted into
                    norm_wraps.append((pt[1], (len(norm_path) - 1,)))
                    continue
                norm_path.append(tuple(pt))
            else:  # legacy (body, loc) pairs
                norm_path.append(("fixed", pt[0], tuple(pt[1])))
        # conditional points must have plain neighbors (true for the
        # reference gait models); the path-length switch assumes it
        has_cond = False
        for i, pt in enumerate(norm_path):
            if pt[0] == "conditional":
                has_cond = True
                assert 0 < i < len(norm_path) - 1, \
                    "conditional path point cannot be an endpoint"
                assert norm_path[i - 1][0] != "conditional" and \
                    norm_path[i + 1][0] != "conditional", \
                    "adjacent conditional path points unsupported"
        assert not (has_cond and norm_wraps), \
            "wraps on paths with conditional points unsupported"
        nseg = len(norm_path) - 1
        norm_wraps = tuple(
            (spec, tuple(k for k in cands if 0 <= k < nseg))
            for spec, cands in norm_wraps)
        self.muscles.append(MuscleSpec(
            name, tuple(norm_path),
            ignore_activation_dynamics, ignore_tendon_compliance,
            tendon_dynamics_implicit, ignore_passive_fiber_force,
            wraps=norm_wraps, min_control=float(min_control),
            max_control=float(max_control)))
        self._muscle_params.append(params)

    def add_station_contact(self, name, body, location, **kwargs):
        self.contacts.append(StationContactSpec(name, body, tuple(location),
                                                **kwargs))

    def add_sphere_contact(self, name, body, location, radius, **kwargs):
        self.sphere_contacts.append(SphereContactSpec(
            name, body, tuple(location), float(radius), **kwargs))

    def add_external_force(self, name, body, force_fn, point_fn,
                           torque_fn=None):
        """Measured external load (OpenSim ExternalForce): world-frame
        force/torque applied at a world point, all functions of time
        (ModOpAddExternalLoads analogue, reference ModelOperators.h:326)."""
        self.external_forces.append({
            "name": name, "body": body, "force_fn": force_fn,
            "point_fn": point_fn, "torque_fn": torque_fn})

    def add_custom_control_force(self, name, fn, min_control=-np.inf,
                                 max_control=np.inf):
        """Scalar-controlled generalized force with arbitrary (nonlinear)
        control dependence: ``fn(p, t, q, u, control) -> (nq,)`` generalized
        forces. The analogue of subclassing ScalarActuator with a custom
        computeForce, e.g. the thrust-direction actuator of the linear
        tangent steering study (reference MocoStudyFactory.cpp:29-50).
        Appends one control named /forceset/<name>."""
        self.custom_control_forces.append(
            (name, fn, float(min_control), float(max_control)))

    def add_kinematic_constraint(self, name, fn):
        """fn(mech_params, q) -> (k,) position-level constraint residual."""
        self.kinematic_constraints.append((name, fn))

    # --- Simbody constraint type zoo (reference testConstraints.cpp
    # exercises Weld/Point/PointOnLine/ConstantDistance/locked-coordinate
    # constraints, :225-367; each is a phi(q) builder here — the
    # transcription machinery treats them all uniformly)
    def _body_point_world(self, frames, body, loc, dtype):
        if body == GROUND:
            return jnp.asarray(loc, dtype=dtype)
        A, o = frames[body]
        return o + A.T @ jnp.asarray(loc, dtype=dtype)

    def add_point_constraint(self, name, body1, loc1, body2, loc2):
        """Ball/point constraint: the two body-fixed stations coincide
        (Simbody Constraint::Ball; testConstraints.cpp:258-276).
        3 equations."""

        def phi(mp, q):
            fr = self.mech.frames(mp, q)
            p1 = self._body_point_world(fr, body1, loc1, q.dtype)
            p2 = self._body_point_world(fr, body2, loc2, q.dtype)
            return p1 - p2

        self.add_kinematic_constraint(name, phi)

    def add_weld_constraint(self, name, body1, body2, loc1=(0, 0, 0),
                            loc2=(0, 0, 0)):
        """Weld: coincident stations + zero relative orientation (Simbody
        Constraint::Weld; testConstraints.cpp:225-257). 6 equations (3
        point + 3 from the skew part of the relative rotation)."""

        def phi(mp, q):
            fr = self.mech.frames(mp, q)
            p1 = self._body_point_world(fr, body1, loc1, q.dtype)
            p2 = self._body_point_world(fr, body2, loc2, q.dtype)
            A1 = (jnp.eye(3, dtype=q.dtype) if body1 == GROUND
                  else fr[body1][0])
            A2 = (jnp.eye(3, dtype=q.dtype) if body2 == GROUND
                  else fr[body2][0])
            Rrel = A1 @ A2.T
            rot = jnp.stack([Rrel[2, 1] - Rrel[1, 2],
                             Rrel[0, 2] - Rrel[2, 0],
                             Rrel[1, 0] - Rrel[0, 1]]) * 0.5
            return jnp.concatenate([p1 - p2, rot])

        self.add_kinematic_constraint(name, phi)

    def add_point_on_line_constraint(self, name, line_body, line_origin,
                                     line_direction, follower_body,
                                     follower_point):
        """The follower station lies on a line fixed in line_body (Simbody
        Constraint::PointOnLine; testConstraints.cpp:277-299).
        2 equations (components of the offset orthogonal to the line)."""
        d = np.asarray(line_direction, dtype=np.float64)
        d = d / np.linalg.norm(d)
        # orthonormal complement of the line direction (static)
        a = np.array([1.0, 0.0, 0.0])
        if abs(d @ a) > 0.9:
            a = np.array([0.0, 1.0, 0.0])
        e1 = np.cross(d, a)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(d, e1)

        def phi(mp, q):
            fr = self.mech.frames(mp, q)
            pf = self._body_point_world(fr, follower_body, follower_point,
                                        q.dtype)
            if line_body == GROUND:
                off = pf - jnp.asarray(line_origin, dtype=q.dtype)
                e1w, e2w = jnp.asarray(e1, q.dtype), jnp.asarray(e2, q.dtype)
            else:
                A, o = fr[line_body]
                off = pf - (o + A.T @ jnp.asarray(line_origin,
                                                  dtype=q.dtype))
                e1w = A.T @ jnp.asarray(e1, q.dtype)
                e2w = A.T @ jnp.asarray(e2, q.dtype)
            return jnp.stack([off @ e1w, off @ e2w])

        self.add_kinematic_constraint(name, phi)

    def add_constant_distance_constraint(self, name, body1, loc1, body2,
                                         loc2, distance):
        """Fixed distance between two stations (Simbody
        Constraint::ConstantDistance; testConstraints.cpp:300-324).
        1 equation, written on squared distance for smoothness."""

        def phi(mp, q):
            fr = self.mech.frames(mp, q)
            p1 = self._body_point_world(fr, body1, loc1, q.dtype)
            p2 = self._body_point_world(fr, body2, loc2, q.dtype)
            diff = p1 - p2
            return jnp.atleast_1d(
                0.5 * (diff @ diff - distance * distance) / distance)

        self.add_kinematic_constraint(name, phi)

    def add_locked_coordinate_constraint(self, name, coord, value):
        """Lock a coordinate at a value (Coordinate::set_locked analogue;
        testConstraints.cpp:325-345). 1 equation."""
        ci = self.coord_index(coord) if isinstance(coord, str) else coord

        def phi(mp, q):
            return jnp.atleast_1d(q[ci] - value)

        self.add_kinematic_constraint(name, phi)

    def add_coordinate_coupler_constraint(self, name, dependent,
                                          independent, fn):
        """q_dep = fn(q_ind) (CoordinateCouplerConstraint;
        testConstraints.cpp:346-367)."""
        di = self.coord_index(dependent) if isinstance(dependent, str) \
            else dependent
        ii = self.coord_index(independent) if isinstance(independent, str) \
            else independent
        self.couplers.append((di, ii, fn))

        def phi(mp, q):
            return jnp.atleast_1d(q[di] - fn(q[ii]))

        self.add_kinematic_constraint(name, phi)

    def set_position_motion(self, fn):
        """Prescribe all coordinates: fn(params, t) -> (q, u, udot).

        The multibody states disappear from the OCP and the multibody
        dynamics reduce to a force balance (inverse dynamics), the basis
        of MocoInverse (reference Components/PositionMotion.h:93,
        MocoTheoryGuide.dox "Prescribed kinematics")."""
        self.position_motion = fn

    def set_position_motion_from_table(self, times, coord_values):
        """Build the PositionMotion from sampled coordinate trajectories
        via quintic splines (PositionMotion::createFromTable analogue —
        the reference uses GCVSpline of degree 5).
        ``coord_values``: (K, nq) array in our coordinate order."""
        from ..utils.splines import QuinticSpline

        spline = QuinticSpline(times, coord_values)

        def fn(p, t):
            return spline(t), spline.derivative(t), spline.second_derivative(t)

        self.position_motion = fn

    # ------------------------------------------------------------- layouts
    def finalize(self):
        mech = self.mech
        self.nq = mech.nq
        # auxiliary state layout
        self._aux_index: list[tuple[str, str]] = []  # (muscle, kind)
        for mspec in self.muscles:
            if not mspec.ignore_activation_dynamics:
                self._aux_index.append((mspec.name, "activation"))
            if not mspec.ignore_tendon_compliance:
                self._aux_index.append((mspec.name, "normalized_tendon_force"))
        self.naux = len(self._aux_index)
        self.prescribed = self.position_motion is not None
        self.ny = self.naux if self.prescribed else 2 * self.nq + self.naux
        self.nx = len(self.actuators) + len(self.muscles)
        # implicit-auxiliary derivative variables (per implicit-tendon muscle)
        self._implicit_aux: list[str] = [
            m.name for m in self.muscles
            if (not m.ignore_tendon_compliance) and m.tendon_dynamics_implicit]
        self.n_implicit_aux = len(self._implicit_aux)
        # ---- static index arrays for vectorized muscle evaluation
        nm = len(self.muscles)
        aux_pos = {(mn, kind): k for k, (mn, kind) in
                   enumerate(self._aux_index)}
        self._mv = {
            "act_from_z": np.zeros(nm, bool),
            "act_zidx": np.zeros(nm, np.int32),
            "exc_xidx": np.asarray(
                [len(self.actuators) + i for i in range(nm)], np.int32),
            "ft_zidx": np.zeros(nm, np.int32),
            "rigid": np.zeros(nm, bool),
            "implicit": np.zeros(nm, bool),
            "nopass": np.zeros(nm, bool),
            "imp_didx": np.zeros(nm, np.int32),
        }
        for i, ms in enumerate(self.muscles):
            if not ms.ignore_activation_dynamics:
                self._mv["act_from_z"][i] = True
                self._mv["act_zidx"][i] = aux_pos[(ms.name, "activation")]
            if ms.ignore_tendon_compliance:
                self._mv["rigid"][i] = True
            else:
                self._mv["ft_zidx"][i] = aux_pos[
                    (ms.name, "normalized_tendon_force")]
                if ms.tendon_dynamics_implicit:
                    self._mv["implicit"][i] = True
                    self._mv["imp_didx"][i] = \
                        self._implicit_aux.index(ms.name)
            self._mv["nopass"][i] = ms.ignore_passive_fiber_force
        # kinematic constraint count + per-constraint equation counts for
        # multiplier naming (reference MocoProblemRep.cpp:208-228:
        # "lambda_cid{cid}_p{i}" per holonomic equation)
        p0 = self.default_params()
        q0 = jnp.zeros(self.nq)
        self._constraint_eqs = [
            (name, int(np.asarray(fn(p0["mech"], q0)).size))
            for name, fn in self.kinematic_constraints]
        self.nphi = sum(k for _, k in self._constraint_eqs)
        self._finalized = True
        return self

    # names --------------------------------------------------------------
    def multiplier_names(self):
        """Lagrange-multiplier column names, one per holonomic constraint
        equation, in row order of :meth:`phi` — the reference's
        "lambda_cid{cid}_p{i}" convention (MocoProblemRep.cpp:208-214),
        with the constraint's position in the kinematic-constraint list as
        cid. All our kinematic constraints are position-level (holonomic),
        so only the _p family appears."""
        names = []
        for cid, (_, k) in enumerate(self._constraint_eqs):
            names += [f"lambda_cid{cid}_p{i}" for i in range(k)]
        return names

    def coordinate_paths(self):
        """Moco-style absolute paths per coordinate, in mech coordinate
        order (multi-coordinate CustomJoints contribute one path per
        coordinate)."""
        paths = []
        for j in self.mech.joints:
            if j.kind == "weld":
                continue
            base = f"/jointset/{j.label or j.name}"
            if j.kind == "custom" and j.coord_names:
                paths.extend(f"{base}/{cn}" for cn in j.coord_names)
            else:
                paths.append(f"{base}/{j.coord_name}")
        return paths

    def state_names(self):
        aux = [f"/forceset/{m}/{kind}" for m, kind in self._aux_index]
        if self.prescribed:
            return aux
        cpaths = self.coordinate_paths()
        names = [f"{c}/value" for c in cpaths]
        names += [f"{c}/speed" for c in cpaths]
        return names + aux

    def control_names(self):
        return ([f"/forceset/{a.name}" for a in self.actuators] +
                [f"/forceset/{m.name}" for m in self.muscles] +
                [f"/forceset/{c[0]}" for c in self.custom_control_forces])

    def default_control_bounds(self):
        lo, hi = [], []
        for a in self.actuators:
            lo.append(a.min_control)
            hi.append(a.max_control)
        for m in self.muscles:
            lo.append(m.min_control)
            hi.append(m.max_control)
        for _, _, cl, cu in self.custom_control_forces:
            lo.append(cl)
            hi.append(cu)
        return np.array(lo), np.array(hi)

    def default_state_bounds(self):
        """(lo, hi) per state; coordinates get wide defaults (the reference
        uses the coordinate's range, MocoProblemRep.cpp:277-361)."""
        lo = np.full(self.ny, -np.inf)
        hi = np.full(self.ny, np.inf)
        off = 0 if self.prescribed else 2 * self.nq
        if not self.prescribed:
            # speeds default [-50, 50] like MocoTool defaults
            lo[self.nq:2 * self.nq] = -50.0
            hi[self.nq:2 * self.nq] = 50.0
        mus_by_name = {ms.name: ms for ms in self.muscles}
        for i, (m, kind) in enumerate(self._aux_index):
            if kind == "activation":
                # bound_activation_from_excitation (default true): the
                # activation state inherits the excitation control bounds
                # (MocoProblemRep.cpp:417-427)
                ms = mus_by_name[m]
                lo[off + i], hi[off + i] = ms.min_control, ms.max_control
            else:
                lo[off + i] = dgf.MIN_NORM_TENDON_FORCE
                hi[off + i] = dgf.MAX_NORM_TENDON_FORCE
        return lo, hi

    # ------------------------------------------------------------- params
    def default_params(self):
        p = {"mech": self.mech.default_params()}
        if self.muscles:
            p["muscles"] = dgf.stack_muscle_params(self._muscle_params)
        if self.actuators:
            p["actuator_optimal_force"] = jnp.asarray(
                [a.optimal_force for a in self.actuators])
        if self.springs:
            p["spring"] = {
                "stiffness": jnp.asarray([s.stiffness for s in self.springs]),
                "rest_length": jnp.asarray(
                    [s.rest_length for s in self.springs]),
                "viscosity": jnp.asarray([s.viscosity for s in self.springs]),
            }
        if self.contacts:
            p["contact"] = {
                "stiffness": jnp.asarray([c.stiffness for c in self.contacts]),
                "dissipation": jnp.asarray(
                    [c.dissipation for c in self.contacts]),
                "friction_coefficient": jnp.asarray(
                    [c.friction_coefficient for c in self.contacts]),
            }
        return p

    # ------------------------------------------------------------ splitting
    def split_state(self, y):
        q = y[..., :self.nq]
        u = y[..., self.nq:2 * self.nq]
        z = y[..., 2 * self.nq:]
        return q, u, z

    def muscle_state(self, z, x, mi: int):
        """(activation, norm_tendon_force_or_None) for muscle mi."""
        mspec = self.muscles[mi]
        act = None
        ft = None
        for k, (mname, kind) in enumerate(self._aux_index):
            if mname != mspec.name:
                continue
            if kind == "activation":
                act = z[k]
            else:
                ft = z[k]
        if act is None:  # activation dynamics ignored: excitation = activation
            act = x[len(self.actuators) + mi]
        return act, ft

    # ------------------------------------------------------------- forces
    def _path_point_world(self, frames, p, q, pt):
        """World position of one path point (any kind)."""
        kind = pt[0]
        body = pt[1]
        if kind == "moving":
            comps = []
            for (fn, ci) in pt[2]:
                if fn is None:
                    comps.append(jnp.zeros((), dtype=q.dtype))
                else:
                    comps.append(jnp.asarray(fn(q[ci]), dtype=q.dtype))
            locv = jnp.stack(comps)
        else:
            locv = jnp.asarray(pt[2], dtype=q.dtype)
        if body == GROUND:
            return locv
        A, o = frames[body]
        return o + A.T @ locv

    def path_lengths(self, p, q):
        """(n_muscles,) path lengths. Conditional path points switch between
        a-p-b and the direct a-b segment (OpenSim removes the point when its
        coordinate leaves the range)."""
        frames = self.mech.frames(p["mech"], q)
        return self._path_lengths_from_frames(frames, p, q)

    def _cyl_frame_maps(self, frames, spec, dtype):
        """(to_cyl, from_cyl) world<->cylinder coordinate maps."""
        A, o = frames[spec.body]
        Ec = jnp.asarray(spec.rotation(), dtype=dtype)
        tc = jnp.asarray(spec.translation, dtype=dtype)

        def to_cyl(x):
            return Ec @ (A @ (x - o) - tc)

        def from_cyl(c):
            return o + A.T @ (Ec.T @ c + tc)

        return to_cyl, from_cyl

    def _wrap_detours(self, frames, q, mspec, pts):
        """Total extra length added by the muscle's wrap cylinders.

        Single wraps contribute ``max_k(L_wrap(seg k) - |seg k|)`` over
        their candidate segments — the wrap engages where it deflects the
        path the most (at most one segment physically intersects a
        cylinder at a time in the reference models). Wraps sharing one
        candidate segment are chained sequentially (med_gas's two
        cylinders)."""
        from .wrap import chained_wrap_length, cylinder_wrap_length

        dtype = q.dtype
        detour = jnp.zeros((), dtype=dtype)
        # group wraps by identical single-candidate segment
        groups = {}
        singles = []
        for spec, cands in mspec.wraps:
            if len(cands) == 1:
                groups.setdefault(cands[0], []).append(spec)
            else:
                singles.append((spec, cands))
        for seg, specs in groups.items():
            a, b = pts[seg], pts[seg + 1]
            straight = jnp.linalg.norm(b - a + 1e-30)
            if len(specs) == 1:
                to_c, _ = self._cyl_frame_maps(frames, specs[0], dtype)
                L = cylinder_wrap_length(to_c(a), to_c(b), specs[0].radius,
                                         specs[0].quadrant)
            else:
                # order proximal-first along the path: the kinematic tree
                # is topologically ordered, so a lower body index is
                # closer to the path origin (femur before tibia for the
                # gastroc pair). Static ordering keeps the chain
                # structure fixed under jit.
                specs = sorted(specs, key=lambda s: s.body)
                cyls = [self._cyl_frame_maps(frames, s, dtype) +
                        (s.radius, s.quadrant) for s in specs]
                L = chained_wrap_length(a, b, cyls)
            detour = detour + jnp.maximum(L - straight, 0.0)
        for spec, cands in singles:
            to_c, _ = self._cyl_frame_maps(frames, spec, dtype)
            best = jnp.zeros((), dtype=dtype)
            for k in cands:
                a, b = pts[k], pts[k + 1]
                straight = jnp.linalg.norm(b - a + 1e-30)
                L = cylinder_wrap_length(to_c(a), to_c(b), spec.radius,
                                         spec.quadrant)
                best = jnp.maximum(best, L - straight)
            detour = detour + best
        return detour

    def _path_lengths_from_frames(self, frames, p, q):
        """path_lengths body given precomputed frames."""
        out = []
        for mspec in self.muscles:
            pts = [self._path_point_world(frames, p, q, pt)
                   for pt in mspec.path]
            L = jnp.zeros((), dtype=q.dtype)
            i = 0
            n = len(pts)
            while i < n - 1:
                nxt = mspec.path[i + 1]
                if nxt[0] == "conditional":
                    a, pnt, b = pts[i], pts[i + 1], pts[i + 2]
                    ci, lo, hi = nxt[3], nxt[4], nxt[5]
                    active = (q[ci] >= lo) & (q[ci] <= hi)
                    with_pt = jnp.linalg.norm(pnt - a + 1e-30) + \
                        jnp.linalg.norm(b - pnt + 1e-30)
                    without = jnp.linalg.norm(b - a + 1e-30)
                    L = L + jnp.where(active, with_pt, without)
                    i += 2
                else:
                    L = L + jnp.linalg.norm(pts[i + 1] - pts[i] + 1e-30)
                    i += 1
            if mspec.wraps:
                L = L + self._wrap_detours(frames, q, mspec, pts)
            out.append(L)
        return jnp.stack(out)

    def muscle_path_kinematics(self, p, q, u):
        """lMT (nm,), vMT (nm,) via jvp through the FK graph."""
        lMT, vMT = jax.jvp(lambda qq: self.path_lengths(p, qq), (q,), (u,))
        return lMT, vMT

    def _muscle_vec_state(self, z, x):
        """(excitation, activation, norm_tendon_force) arrays (nm,)."""
        mv = self._mv
        exc = x[jnp.asarray(mv["exc_xidx"])]
        if self.naux:
            act_z = z[jnp.asarray(mv["act_zidx"])]
            ft = z[jnp.asarray(mv["ft_zidx"])]
        else:
            act_z = exc
            ft = exc * 0.0
        act = jnp.where(jnp.asarray(mv["act_from_z"]), act_z, exc)
        return exc, act, ft

    def _muscle_forces_vec(self, p, act, ft, lMT, vMT):
        """Vectorized path tensions (nm,): rigid-tendon closed form or
        tendon-force state, selected by static per-muscle mask."""
        mp = p["muscles"]
        nopass = jnp.asarray(self._mv["nopass"])
        f_r = dgf.rigid_tendon_force(mp, act, lMT, vMT, nopass)
        f_c = dgf.tendon_force_from_state(mp, ft)
        return jnp.where(jnp.asarray(self._mv["rigid"]), f_r, f_c)

    def muscle_tendon_forces(self, p, t, q, u, z, x):
        """Per-muscle path tension (N)."""
        if not self.muscles:
            return jnp.zeros(0, dtype=q.dtype)
        lMT, vMT = self.muscle_path_kinematics(p, q, u)
        exc, act, ft = self._muscle_vec_state(z, x)
        return self._muscle_forces_vec(p, act, ft, lMT, vMT)

    def tau_controls(self, p, x):
        """Generalized forces from coordinate actuators only (linear in the
        controls)."""
        tau = jnp.zeros(self.nq, dtype=x.dtype)
        if self.actuators:
            coords = jnp.asarray(np.asarray(
                [a.coord for a in self.actuators], np.int32))
            gains = p["actuator_optimal_force"]
            tau = tau.at[coords].add(gains * x[:len(self.actuators)])
        return tau

    def applied_generalized_forces(self, p, t, q, u, z, x,
                                   include_muscles=True,
                                   include_controls=True):
        """Total applied generalized force vector f_app(t, y, x, p).

        One kinematics "bundle" (muscle path lengths + all contact points)
        is pushed through jvp/vjp once, instead of per-component FK passes
        — this keeps the traced graph small enough for fast XLA compiles on
        muscle-rich models. ``include_muscles=False`` /
        ``include_controls=False`` drop those contributions (used to fold
        the time-only part into per-grid-point constants on
        prescribed-kinematics problems).
        """
        dtype = q.dtype
        tau = jnp.zeros(self.nq, dtype=dtype)
        # coordinate actuators (vectorized scatter-add)
        if include_controls:
            tau = tau + self.tau_controls(p, x).astype(dtype)
            # nonlinear scalar-controlled forces (reference ScalarActuator
            # subclasses with custom computeForce, MocoStudyFactory.cpp:29)
            off = len(self.actuators) + len(self.muscles)
            for j, (_, fn, _, _) in enumerate(self.custom_control_forces):
                tau = tau + jnp.asarray(fn(p, t, q, u, x[off + j]),
                                        dtype=dtype)
        # springs / dampers
        if self.springs:
            sp = p["spring"]
            scoords = jnp.asarray(np.asarray(
                [s.coord for s in self.springs], np.int32))
            f = (-sp["stiffness"] * (q[scoords] - sp["rest_length"]) -
                 sp["viscosity"] * u[scoords])
            tau = tau.at[scoords].add(f)

        nm = len(self.muscles) if include_muscles else 0
        nsp = len(self.sphere_contacts)
        nsc = len(self.contacts)
        nef = len(self.external_forces)
        if not (nm or nsp or nsc or nef):
            return tau

        # frozen body-local contact points (material points coincident with
        # each sphere's lowest point at the current configuration)
        frames0 = self.mech.frames(p["mech"], q)
        sphere_locs = []
        for spec in self.sphere_contacts:
            A, o = frames0[spec.body]
            center_w = o + A.T @ jnp.asarray(spec.location, dtype=dtype)
            cp_w = center_w - jnp.asarray([0.0, spec.radius, 0.0],
                                          dtype=dtype)
            sphere_locs.append(jax.lax.stop_gradient(A @ (cp_w - o)))

        # external loads: freeze the body-local point coincident with the
        # measured center of pressure at time t
        ext_locs = []
        for ef in self.external_forces:
            A, o = frames0[ef["body"]]
            pw = jnp.asarray(ef["point_fn"](t), dtype=dtype)
            ext_locs.append(jax.lax.stop_gradient(A @ (pw - o)))

        def bundle(qq):
            fr = self.mech.frames(p["mech"], qq)
            L = (self._path_lengths_from_frames(fr, p, qq) if nm
                 else jnp.zeros(0, dtype=dtype))
            pts = []
            for spec, loc in zip(self.sphere_contacts, sphere_locs):
                A, o = fr[spec.body]
                pts.append(o + A.T @ loc)
            for c in self.contacts:
                A, o = fr[c.body]
                pts.append(o + A.T @ jnp.asarray(c.location, dtype=dtype))
            for ef, loc in zip(self.external_forces, ext_locs):
                A, o = fr[ef["body"]]
                pts.append(o + A.T @ loc)
            P = (jnp.stack(pts) if pts else jnp.zeros((0, 3), dtype=dtype))
            return L, P

        (L, P), (Ldot, Pdot) = jax.jvp(bundle, (q,), (u,))
        _, pullback = jax.vjp(bundle, q)

        L_cot = jnp.zeros(nm, dtype=dtype)
        if nm:
            exc, act, ft = self._muscle_vec_state(z, x)
            F_m = self._muscle_forces_vec(p, act, ft, L, Ldot)
            # tension shortens the path; cast back in case f64 params
            # promoted the force under an x64-enabled host (f32 solves)
            L_cot = (-F_m).astype(L.dtype)
        P_cot = jnp.zeros((nsp + nsc + nef, 3), dtype=dtype)
        for k, spec in enumerate(self.sphere_contacts):
            P_cot = P_cot.at[k].set(
                smooth_sphere_halfspace_force(P[k], Pdot[k], spec))
        if nsc:
            cp = p["contact"]
            for j, c in enumerate(self.contacts):
                k = nsp + j
                P_cot = P_cot.at[k].set(station_contact_force(
                    P[k], Pdot[k], c, cp["stiffness"][j],
                    cp["dissipation"][j], cp["friction_coefficient"][j]))
        for j, ef in enumerate(self.external_forces):
            P_cot = P_cot.at[nsp + nsc + j].set(
                jnp.asarray(ef["force_fn"](t), dtype=dtype))
        tau = tau + pullback((L_cot, P_cot))[0]
        # external torques: tau += (d omega_world / du)^T T
        for ef in self.external_forces:
            if ef["torque_fn"] is None:
                continue
            T = jnp.asarray(ef["torque_fn"](t), dtype=dtype)

            def omega_dot_T(uu, b=ef["body"], T=T):
                def rot(qq):
                    return self.mech.frames(p["mech"], qq)[b][0]
                A, Adot = jax.jvp(rot, (q,), (uu,))
                W = Adot @ A.T
                om_frame = jnp.stack([W[2, 1], W[0, 2], W[1, 0]])
                return -(A.T @ om_frame) @ T

            tau = tau + jax.grad(omega_dot_T)(u)
        return tau

    # ------------------------------------------------------ contact/reaction
    def contact_forces(self, p, t, q, u):
        """World-frame force (3,) applied to the body by each contact
        component, keyed by contact name (the per-component force record the
        reference exposes through Force::getRecordValues and consumes in
        MocoContactTrackingGoal.cpp:250-259)."""
        dtype = q.dtype
        frames = self.mech.frames(p["mech"], q)
        out = {}

        def point_vel(body, loc_local):
            pos = lambda qq: (lambda fr: fr[body][1] + fr[body][0].T @
                              loc_local)(self.mech.frames(p["mech"], qq))
            return jax.jvp(pos, (q,), (u,))

        for spec in self.sphere_contacts:
            A, o = frames[spec.body]
            center_w = o + A.T @ jnp.asarray(spec.location, dtype=dtype)
            cp_w = center_w - jnp.asarray([0.0, spec.radius, 0.0],
                                          dtype=dtype)
            loc = jax.lax.stop_gradient(A @ (cp_w - o))
            pos, vel = point_vel(spec.body, loc)
            out[spec.name] = smooth_sphere_halfspace_force(pos, vel, spec)
        cp = p.get("contact")
        for j, c in enumerate(self.contacts):
            pos, vel = point_vel(c.body, jnp.asarray(c.location, dtype=dtype))
            out[c.name] = station_contact_force(
                pos, vel, c, cp["stiffness"][j], cp["dissipation"][j],
                cp["friction_coefficient"][j])
        return out

    def applied_body_wrenches(self, p, t, q, u, z, x):
        """(nb, 6) world wrenches [moment; force] at body origins.

        Includes contact forces, external loads (force at moving point +
        torque), and muscle path tensions applied at the path points of each
        straight segment (conditional points weighted by their activity).
        Wrap-cylinder reaction forces are not included (the straight chord
        between the points bracketing a wrap carries the tension).
        Coordinate actuators and generalized springs are mobility forces and
        do not produce body wrenches; they are transmitted through joints
        and therefore appear in joint reactions automatically.
        """
        dtype = q.dtype
        frames = self.mech.frames(p["mech"], q)
        W = jnp.zeros((self.mech.nb, 6), dtype=dtype)

        def add_point_force(W, body, pt_w, f_w):
            if body == GROUND:
                return W
            A, o = frames[body]
            return W.at[body, :3].add(jnp.cross(pt_w - o, f_w)) \
                    .at[body, 3:].add(f_w)

        # contacts
        cf = self.contact_forces(p, t, q, u)
        for spec in self.sphere_contacts:
            A, o = frames[spec.body]
            center_w = o + A.T @ jnp.asarray(spec.location, dtype=dtype)
            cp_w = center_w - jnp.asarray([0.0, spec.radius, 0.0],
                                          dtype=dtype)
            W = add_point_force(W, spec.body, cp_w, cf[spec.name])
        for c in self.contacts:
            A, o = frames[c.body]
            pt_w = o + A.T @ jnp.asarray(c.location, dtype=dtype)
            W = add_point_force(W, c.body, pt_w, cf[c.name])
        # external loads
        for ef in self.external_forces:
            pt_w = jnp.asarray(ef["point_fn"](t), dtype=dtype)
            f_w = jnp.asarray(ef["force_fn"](t), dtype=dtype)
            W = add_point_force(W, ef["body"], pt_w, f_w)
            if ef["torque_fn"] is not None:
                W = W.at[ef["body"], :3].add(
                    jnp.asarray(ef["torque_fn"](t), dtype=dtype))
        # muscle path forces
        if self.muscles:
            lMT, vMT = self.muscle_path_kinematics(p, q, u)
            exc, act, ft = self._muscle_vec_state(z, x)
            F = self._muscle_forces_vec(p, act, ft, lMT, vMT)
            for mi, mspec in enumerate(self.muscles):
                pts = []  # (body, world point, activity weight)
                for pt in mspec.path:
                    if pt[0] == "wrap":
                        continue
                    w_act = None
                    if pt[0] == "conditional":
                        ci, lo, hi = pt[3], pt[4], pt[5]
                        w_act = jnp.where((q[ci] >= lo) & (q[ci] <= hi),
                                          1.0, 0.0).astype(dtype)
                    pts.append((pt[1],
                                self._path_point_world(frames, p, q, pt),
                                w_act))
                for k, (body, pw, w_act) in enumerate(pts):
                    f_w = jnp.zeros(3, dtype=dtype)
                    if k > 0:
                        prev = pts[k - 1][1]
                        d = prev - pw
                        f_w = f_w + F[mi] * d / jnp.linalg.norm(d + 1e-30)
                    if k < len(pts) - 1:
                        nxt = pts[k + 1][1]
                        d = nxt - pw
                        f_w = f_w + F[mi] * d / jnp.linalg.norm(d + 1e-30)
                    if w_act is not None:
                        f_w = f_w * w_act
                    W = add_point_force(W, body, pw, f_w)
        return W

    def joint_reaction(self, p, t, q, u, z, x, lam, udot=None):
        """(nb, 6) reaction wrench of every joint on its child body,
        expressed in ground about the joint's child-frame origin
        (MocoJointReactionGoal semantics). ``udot`` defaults to explicit
        forward dynamics at this point."""
        if udot is None:
            udot = self.multibody_explicit(p, t, q, u, z, x, lam)
        W = self.applied_body_wrenches(p, t, q, u, z, x)
        # Constraint forces -G^T lam enter as generalized (mobility) forces.
        # For coordinate couplers -- the constraint type in the shipped gait
        # models -- that is exact; loop-closure constraints whose physical
        # forces act at body stations would need explicit wrench terms.
        return self.mech.joint_reaction_wrenches(p["mech"], q, u, udot, W)

    # ------------------------------------------------------ kinematic cons
    def phi(self, p, q):
        """Stacked position-level constraint residuals (nphi,)."""
        if not self.kinematic_constraints:
            return jnp.zeros(0, dtype=q.dtype)
        return jnp.concatenate([
            jnp.atleast_1d(fn(p["mech"], q))
            for _, fn in self.kinematic_constraints])

    def constraint_jacobian(self, p, q):
        return jax.jacfwd(lambda qq: self.phi(p, qq))(q)

    # -------------------------------------------------------------- dynamics
    def multibody_explicit(self, p, t, q, u, z, x, lam):
        """udot = M^{-1} (f_app - bias - G^T lam)."""
        tau = self.applied_generalized_forces(p, t, q, u, z, x)
        if self.nphi:
            G = self.constraint_jacobian(p, q)
            tau = tau - G.T @ lam
        M = self.mech.mass_matrix(p["mech"], q)
        b = self.mech.bias_forces(p["mech"], q, u)
        return jnp.linalg.solve(M, tau - b)

    def multibody_implicit_residual(self, p, t, q, u, z, x, lam, udot):
        """M udot + G^T lam - (f_app - bias); scaled by nothing (N m)."""
        tau = self.applied_generalized_forces(p, t, q, u, z, x)
        if self.nphi:
            G = self.constraint_jacobian(p, q)
            tau = tau - G.T @ lam
        M = self.mech.mass_matrix(p["mech"], q)
        b = self.mech.bias_forces(p["mech"], q, u)
        return M @ udot - (tau - b)

    # ------------------------------------------ prescribed-kinematics cache
    def prescribed_point_constants(self, p, t):
        """Time-only constants of the force balance at one grid time of a
        prescribed-kinematics problem (the MocoInverse structure,
        reference MocoInverse.cpp:46-96 + MocoTheoryGuide.dox "Prescribed
        kinematics").

        With q(t), u(t), u̇(t) prescribed and no free parameters, every
        kinematic quantity in the DAE residual is a constant of the NLP:
        the decision variables (activations, tendon forces, controls) only
        enter through muscle/actuator forces. Returns a dict with

        - ``t, q, u, udot``
        - ``tau_net`` = RNEA(q,u,u̇) − f_passive (springs/contacts/external)
        - ``R`` (nm, nq) moment-arm matrix ∂lMT/∂q
        - ``lMT, vMT`` muscle-tendon lengths/velocities
        - ``Gc`` (nphi, nq) kinematic-constraint Jacobian (if any)

        so the per-point residual collapses to
        ``tau_net + Rᵀ F_m − τ_ctrl(x) − Gcᵀ λ`` — DGF curve math plus two
        small matvecs. This deletes FK/RNEA/wrapping from the NLP graph
        entirely (an order-of-magnitude XLA compile/runtime win on
        muscle-rich gait models)."""
        q, u, udot = self.position_motion(p, t)
        dtype = q.dtype
        nm = len(self.muscles)
        if nm:
            lMT, vMT = self.muscle_path_kinematics(p, q, u)
            R = jax.jacfwd(lambda qq: self.path_lengths(p, qq))(q)
        else:
            lMT = vMT = jnp.zeros(0, dtype=dtype)
            R = jnp.zeros((0, self.nq), dtype=dtype)
        x0 = jnp.zeros(len(self.control_names()), dtype=dtype)
        z0 = jnp.zeros(self.naux, dtype=dtype)
        tau_passive = self.applied_generalized_forces(
            p, t, q, u, z0, x0, include_muscles=False,
            include_controls=False)
        tau_net = self.mech.rnea(p["mech"], q, u, udot) - tau_passive
        out = {"t": t, "q": q, "u": u, "udot": udot, "tau_net": tau_net,
               "R": R, "lMT": lMT, "vMT": vMT}
        if self.nphi:
            out["Gc"] = self.constraint_jacobian(p, q)
        return out

    def prescribed_residual_cached(self, p, c, z, x, lam):
        """Force-balance residual at one grid point from precomputed
        constants ``c`` (see :meth:`prescribed_point_constants`)."""
        res = c["tau_net"] - self.tau_controls(p, x)
        if self.muscles:
            exc, act, ft = self._muscle_vec_state(z, x)
            F_m = self._muscle_forces_vec(p, act, ft, c["lMT"], c["vMT"])
            res = res + c["R"].T @ F_m
        if self.nphi:
            res = res + c["Gc"].T @ lam
        return res

    def aux_dynamics(self, p, t, q, u, z, x, implicit_aux_derivs=None,
                     path_kin=None):
        """zdot (naux,), fully vectorized over muscles. Implicit-tendon
        muscles take their derivative from ``implicit_aux_derivs`` (the
        zeta variables of the transcription). ``path_kin=(lMT, vMT)`` skips
        the path-kinematics recompute when the caller already has it."""
        if self.naux == 0:
            return jnp.zeros(0, dtype=q.dtype)
        mv = self._mv
        mp = p["muscles"]
        exc, act, ft = self._muscle_vec_state(z, x)
        zdot = jnp.zeros(self.naux, dtype=q.dtype)
        # activation dynamics entries
        act_m = np.nonzero(mv["act_from_z"])[0]
        if act_m.size:
            dadt = dgf.activation_dynamics(
                exc, act, mp["activation_time_constant"],
                mp["deactivation_time_constant"])
            zdot = zdot.at[jnp.asarray(mv["act_zidx"][act_m])].set(
                dadt[jnp.asarray(act_m)])
        # tendon-force dynamics entries
        comp_m = np.nonzero(~mv["rigid"])[0]
        if comp_m.size:
            sub = jnp.asarray(comp_m)
            has_explicit = bool((~mv["implicit"][comp_m]).any())
            if has_explicit:
                mps = {k: v[sub] for k, v in mp.items()}
                lMT, vMT = (path_kin if path_kin is not None
                            else self.muscle_path_kinematics(p, q, u))
                dft_exp = dgf.explicit_tendon_dynamics(
                    mps, act[sub], ft[sub], lMT[sub], vMT[sub],
                    jnp.asarray(mv["nopass"][comp_m]))
            else:
                dft_exp = jnp.zeros(len(comp_m), dtype=q.dtype)
            if implicit_aux_derivs is not None and \
                    bool(mv["implicit"][comp_m].any()):
                zeta = implicit_aux_derivs[
                    jnp.asarray(mv["imp_didx"][comp_m])]
            else:
                zeta = dft_exp * 0.0
            dft = jnp.where(jnp.asarray(mv["implicit"][comp_m]), zeta,
                            dft_exp)
            zdot = zdot.at[jnp.asarray(mv["ft_zidx"][comp_m])].set(dft)
        return zdot

    def implicit_aux_residuals(self, p, t, q, u, z, x, implicit_aux_derivs,
                               path_kin=None):
        """Equilibrium residuals for implicit-tendon muscles (normalized by
        max isometric force for conditioning), vectorized."""
        if not self._implicit_aux:
            return jnp.zeros(0, dtype=q.dtype)
        mv = self._mv
        imp_m = np.nonzero(mv["implicit"])[0]
        sub = jnp.asarray(imp_m)
        mp = p["muscles"]
        mps = {k: v[sub] for k, v in mp.items()}
        exc, act, ft = self._muscle_vec_state(z, x)
        lMT, vMT = (path_kin if path_kin is not None
                    else self.muscle_path_kinematics(p, q, u))
        zeta = implicit_aux_derivs[jnp.asarray(mv["imp_didx"][imp_m])]
        r = dgf.implicit_tendon_residual(
            mps, act[sub], ft[sub], zeta, lMT[sub], vMT[sub],
            jnp.asarray(mv["nopass"][imp_m]))
        return r / mps["max_isometric_force"]

    def state_derivatives(self, p, t, q, u, z, x, lam,
                          implicit_aux_derivs=None, udot=None):
        """Full explicit ydot; pass udot to skip the M solve (implicit)."""
        if udot is None:
            udot = self.multibody_explicit(p, t, q, u, z, x, lam)
        zdot = self.aux_dynamics(p, t, q, u, z, x, implicit_aux_derivs)
        return jnp.concatenate([u, udot, zdot])
