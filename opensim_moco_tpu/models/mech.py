"""Minimal-coordinate multibody mechanics in pure JAX.

This is the JAX-native replacement for the role Simbody's
SimbodyMatterSubsystem plays in the reference (SURVEY.md L0; the reference
calls ``realizeAcceleration`` per grid point through a callback bridge,
``MocoCasOCProblem.h:203-330``). Here the whole tree is a pure function of
``(params, q, u)`` built from Featherstone's RNEA/CRBA, so XLA can fuse it
into the transcription graph, JAX autodiff replaces the reference's finite
differences/ADOL-C taping, and ``vmap`` replaces the ThreadsafeJar model
replica pool (``MocoUtilities.h:680-716``).

Design notes
------------
* Topology (parents, joint kinds, axes) is **static** Python/numpy, so the
  per-body loops unroll at trace time into a fixed XLA graph (body counts are
  tiny: <= ~20 for Moco-class gait models).
* Everything numeric that a user might optimize (masses, COMs, inertias,
  joint frame offsets, gravity) lives in a parameter pytree produced by
  :meth:`MechModel.default_params`, making MocoParameter-style model-parameter
  optimization a trivial functional update + autodiff.
* Point/station kinematics are exposed as positions only; velocities come
  from ``jax.jvp`` and generalized forces from ``jax.vjp`` (Jacobian-transpose
  mapping), which is both simpler and faster than hand-written projection.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .spatial import crf, crm, rodrigues, skew, spatial_inertia

GROUND = -1

_VALID_KINDS = ("revolute", "prismatic", "weld", "custom")


@dataclasses.dataclass(frozen=True)
class JointSpec:
    """Static description of a joint connecting parent body -> child body.

    ``kind == "custom"`` models OpenSim CustomJoint: a spatial transform of
    three body-fixed rotations followed by a translation, each axis driven
    by a function of one of the joint's coordinates (``custom_axes``:
    six (axis, fn, local_coord_index) tuples, rotations first; fn None
    means the axis is unused/constant-zero). The motion subspace S(q) is
    derived by autodiff, so spline-coupled axes (walking-model knees) work
    exactly."""

    name: str
    kind: str
    axis: tuple  # unit axis, static (simple joints)
    coord_name: str | None  # None for weld; first coord for custom
    label: str | None = None  # display name for paths (multi-dof chains)
    coord_names: tuple = ()  # all coords (custom joints)
    custom_axes: tuple = ()  # ((axis3, fn, local_ci) x 6)


@dataclasses.dataclass(frozen=True)
class BodySpec:
    name: str
    mass: float
    com: tuple
    inertia: tuple  # 3x3 nested tuple


@dataclasses.dataclass(frozen=True)
class StationSpec:
    """A point fixed in a body (marker / muscle via point / contact point)."""

    name: str
    body: int  # body index, or GROUND
    location: tuple  # in body frame


class MechModel:
    """Immutable kinematic tree; construct via :class:`MechModelBuilder`."""

    def __init__(self, bodies: Sequence[BodySpec], joints: Sequence[JointSpec],
                 parents: Sequence[int], tree_E: np.ndarray, tree_r: np.ndarray,
                 gravity: np.ndarray, child_E: np.ndarray | None = None,
                 child_r: np.ndarray | None = None):
        self.bodies = tuple(bodies)
        self.joints = tuple(joints)
        self.parents = tuple(parents)
        self._tree_E = np.asarray(tree_E, dtype=np.float64)
        self._tree_r = np.asarray(tree_r, dtype=np.float64)
        # pose of the joint frame in the CHILD body frame (OpenSim joints
        # attach via offset frames on both sides); identity if absent
        nb = len(self.bodies)
        self._child_E = (np.tile(np.eye(3), (nb, 1, 1)) if child_E is None
                         else np.asarray(child_E, dtype=np.float64))
        self._child_r = (np.zeros((nb, 3)) if child_r is None
                         else np.asarray(child_r, dtype=np.float64))
        self._gravity = np.asarray(gravity, dtype=np.float64)
        # coordinate indices per body (empty tuple if weld)
        coords = []
        self.coord_names = []
        k = 0
        for j in self.joints:
            if j.kind == "weld":
                coords.append(())
            elif j.kind == "custom":
                idxs = tuple(range(k, k + len(j.coord_names)))
                coords.append(idxs)
                self.coord_names.extend(j.coord_names)
                k += len(j.coord_names)
            else:
                coords.append((k,))
                self.coord_names.append(j.coord_name)
                k += 1
        self._coords_of_body = tuple(coords)
        # legacy single-index view used by simple-joint fast paths
        self._coord_of_body = tuple(c[0] if c else -1 for c in coords)
        self.nq = k
        self.nb = len(self.bodies)

    # ---------------------------------------------------------------- params
    def default_params(self):
        """Parameter pytree: every numeric quantity of the model."""
        return {
            "mass": jnp.asarray([b.mass for b in self.bodies]),
            "com": jnp.asarray([b.com for b in self.bodies]),
            "inertia": jnp.asarray([b.inertia for b in self.bodies]),
            "tree_E": jnp.asarray(self._tree_E),
            "tree_r": jnp.asarray(self._tree_r),
            "child_E": jnp.asarray(self._child_E),
            "child_r": jnp.asarray(self._child_r),
            "gravity": jnp.asarray(self._gravity),
        }

    # ------------------------------------------------------------ kinematics
    def _joint_EjrjS(self, i, p, q):
        """Joint transform (E_j, r_j) and motion subspace S for body i."""
        spec = self.joints[i]
        dtype = q.dtype
        ci = self._coord_of_body[i]
        axis = jnp.asarray(spec.axis, dtype=dtype)
        if spec.kind == "weld":
            E = jnp.eye(3, dtype=dtype)
            r = jnp.zeros(3, dtype=dtype)
            S = None
        elif spec.kind == "revolute":
            E = rodrigues(axis, q[ci]).T
            r = jnp.zeros(3, dtype=dtype)
            S = jnp.concatenate([axis, jnp.zeros(3, dtype=dtype)])
        elif spec.kind == "prismatic":
            E = jnp.eye(3, dtype=dtype)
            r = axis * q[ci]
            S = jnp.concatenate([jnp.zeros(3, dtype=dtype), axis])
        else:  # pragma: no cover
            raise ValueError(spec.kind)
        return E, r, S

    @staticmethod
    def _compose(E1, r1, E2, r2):
        """Compose coordinate maps x -> E1(x - r1) then -> E2(. - r2)."""
        return E2 @ E1, r1 + E1.T @ r2

    def _custom_rel_pose(self, spec, qj):
        """(E, r) for a custom joint from its local coordinate vector.

        Body-fixed rotation sequence about the listed axes (OpenSim
        CustomJoint/SpatialTransform rotation1..3) followed by a translation
        along the listed axes expressed in the joint-base (parent) frame
        (translation1..3), each driven by fn(coordinate)."""
        dtype = qj.dtype
        R = jnp.eye(3, dtype=dtype)
        for (axis, fn, ci) in spec.custom_axes[:3]:
            if fn is None:
                continue
            R = R @ rodrigues(jnp.asarray(axis, dtype), fn(qj[ci]))
        t = jnp.zeros(3, dtype=dtype)
        for (axis, fn, ci) in spec.custom_axes[3:]:
            if fn is None:
                continue
            t = t + jnp.asarray(axis, dtype) * fn(qj[ci])
        return R.T, t

    def _net_pose_fn(self, i, p, dtype):
        """Returns net_pose(qj) -> (E, r): parent-body -> child-body map as
        a function of the joint's local coordinates (offsets composed in),
        plus the static coordinate index tuple."""
        spec = self.joints[i]
        idxs = self._coords_of_body[i]
        E_T = p["tree_E"][i].astype(dtype)
        r_T = p["tree_r"][i].astype(dtype)
        cE = p["child_E"][i].astype(dtype)
        cr = p["child_r"][i].astype(dtype)

        def net(qj):
            if spec.kind == "custom":
                E_j, r_j = self._custom_rel_pose(spec, qj)
            elif spec.kind == "weld":
                E_j = jnp.eye(3, dtype=dtype)
                r_j = jnp.zeros(3, dtype=dtype)
            elif spec.kind == "revolute":
                E_j = rodrigues(jnp.asarray(spec.axis, dtype), qj[0]).T
                r_j = jnp.zeros(3, dtype=dtype)
            else:  # prismatic
                E_j = jnp.eye(3, dtype=dtype)
                r_j = jnp.asarray(spec.axis, dtype) * qj[0]
            E, r = self._compose(E_T, r_T, E_j, r_j)
            return self._compose(E, r, cE.T, -cE @ cr)

        return net, idxs

    @staticmethod
    def _rel_velocity(net, qj, uj):
        """Relative spatial velocity (child coords) of a joint from the net
        pose map: omega from E Edot^T, linear from E rdot."""
        (E, r), (Ed, rd) = jax.jvp(net, (qj,), (uj,))
        Mw = E @ Ed.T
        om = jnp.stack([Mw[2, 1], Mw[0, 2], Mw[1, 0]])
        return jnp.concatenate([om, E @ rd])

    def _joint_net(self, i, p, q):
        """Net (E, r) parent-body -> child-body map and S (child coords).

        Chain: parent offset frame -> joint transform -> inverse child
        offset frame (OpenSim joints attach between two PhysicalOffsetFrames;
        tree_E/tree_r give the joint frame pose on the parent side,
        child_E/child_r its pose on the child side)."""
        spec = self.joints[i]
        if spec.kind == "custom":
            net, idxs = self._net_pose_fn(i, p, q.dtype)
            qj = q[jnp.asarray(idxs)] if idxs else jnp.zeros(0, q.dtype)
            E, r = net(qj)
            return E, r, None
        E_j, r_j, S = self._joint_EjrjS(i, p, q)
        E_T = p["tree_E"][i].astype(q.dtype)
        r_T = p["tree_r"][i].astype(q.dtype)
        cE = p["child_E"][i].astype(q.dtype)
        cr = p["child_r"][i].astype(q.dtype)
        E, r = self._compose(E_T, r_T, E_j, r_j)
        # inverse child offset: F_c coords -> B_c coords
        E, r = self._compose(E, r, cE.T, -cE @ cr)
        if S is not None:
            # motion subspace from joint-frame coords to child-body coords
            Z = jnp.zeros((3, 3), dtype=q.dtype)
            Xc = jnp.block([[cE.T, Z], [-cE.T @ skew(-cE @ cr), cE.T]])
            S = Xc @ S
        return E, r, S

    def _Xup_S(self, i, p, q):
        """6x6 motion transform parent->body i and motion subspace."""
        E, r, S = self._joint_net(i, p, q)
        Z = jnp.zeros((3, 3), dtype=q.dtype)
        Xup = jnp.block([[E, Z], [-E @ skew(r), E]])
        return Xup, S

    def frames(self, p, q):
        """World pose per body: list of (A, o) with A = E_{body<-world},
        o = body origin in world coordinates."""
        out = []
        for i in range(self.nb):
            E_ip, r_ip, _ = self._joint_net(i, p, q)
            pa = self.parents[i]
            if pa == GROUND:
                A = E_ip
                o = r_ip
            else:
                A_p, o_p = out[pa]
                A = E_ip @ A_p
                o = o_p + A_p.T @ r_ip
            out.append((A, o))
        return out

    def station_position(self, p, q, body: int, location):
        """World position of a point fixed in ``body`` (GROUND allowed)."""
        loc = jnp.asarray(location, dtype=q.dtype)
        if body == GROUND:
            return loc
        A, o = self.frames(p, q)[body]
        return o + A.T @ loc

    def station_positions(self, p, q, stations: Sequence[StationSpec]):
        """Stack world positions for many stations (shares one FK pass)."""
        frames = self.frames(p, q)
        out = []
        for s in stations:
            loc = jnp.asarray(s.location, dtype=q.dtype)
            if s.body == GROUND:
                out.append(loc)
            else:
                A, o = frames[s.body]
                out.append(o + A.T @ loc)
        return jnp.stack(out)

    def mass_center(self, p, q):
        """System center of mass in world coordinates (the reference's
        Model::calcMassCenterPosition, used by MocoGoal's
        divide-by-displacement normalization, MocoGoal.cpp:49-57)."""
        frames = self.frames(p, q)
        total = jnp.zeros((), dtype=q.dtype)
        com = jnp.zeros(3, dtype=q.dtype)
        for i in range(self.nb):
            mi = p["mass"][i].astype(q.dtype)
            A, o = frames[i]
            com = com + mi * (o + A.T @ p["com"][i].astype(q.dtype))
            total = total + mi
        return com / jnp.maximum(total, 1e-12)

    def station_velocity(self, p, q, u, body: int, location):
        """World-frame velocity of a station via jvp of its position."""
        pos = lambda qq: self.station_position(p, qq, body, location)
        return jax.jvp(pos, (q,), (u,))[1]

    # -------------------------------------------------------------- dynamics
    def _body_motion(self, i, p, q, u, udot):
        """(Xup, S (6,d)|None, vJ, aJ_partial, idxs) for body i.

        aJ_partial = S qdd + Sdot qd (the crm(v) vJ term is added by the
        caller). Simple joints use the constant-S fast path; custom joints
        derive S and Sdot via autodiff of the net pose map."""
        dtype = q.dtype
        spec = self.joints[i]
        if spec.kind != "custom":
            Xup, S = self._Xup_S(i, p, q)
            ci = self._coord_of_body[i]
            if S is None:
                z = jnp.zeros(6, dtype=dtype)
                return Xup, None, z, z, ()
            return (Xup, S[:, None], S * u[ci], S * udot[ci], (ci,))
        net, idxs = self._net_pose_fn(i, p, dtype)
        ii = jnp.asarray(idxs)
        qj, uj, aj = q[ii], u[ii], udot[ii]
        E, r = net(qj)
        Z = jnp.zeros((3, 3), dtype=dtype)
        Xup = jnp.block([[E, Z], [-E @ skew(r), E]])
        vJ_fn = lambda qq, uu: self._rel_velocity(net, qq, uu)
        vJ, aJ = jax.jvp(vJ_fn, (qj, uj), (uj, aj))
        S = jax.jacfwd(vJ_fn, argnums=1)(qj, uj)
        return Xup, S, vJ, aJ, idxs

    def rnea(self, p, q, u, udot):
        """Inverse dynamics: generalized forces balancing (q, u, udot) under
        gravity and velocity-product terms.  Featherstone RBDA table 5.1,
        generalized to multi-dof joints with q-dependent motion subspaces."""
        dtype = q.dtype
        g = p["gravity"].astype(dtype)
        a_base = jnp.concatenate([jnp.zeros(3, dtype=dtype), -g])
        v = [None] * self.nb
        a = [None] * self.nb
        f = [None] * self.nb
        Xups = [None] * self.nb
        Ss = [None] * self.nb
        for i in range(self.nb):
            Xup, S, vJ, aJ, idxs = self._body_motion(i, p, q, u, udot)
            Xups[i] = Xup
            Ss[i] = S
            pa = self.parents[i]
            v_p = jnp.zeros(6, dtype=dtype) if pa == GROUND else v[pa]
            a_p = a_base if pa == GROUND else a[pa]
            v[i] = Xup @ v_p + vJ
            a[i] = Xup @ a_p + aJ + crm(v[i]) @ vJ
            I = spatial_inertia(p["mass"][i].astype(dtype),
                                p["com"][i].astype(dtype),
                                p["inertia"][i].astype(dtype))
            f[i] = I @ a[i] + crf(v[i]) @ (I @ v[i])
        tau = jnp.zeros(self.nq, dtype=dtype)
        for i in reversed(range(self.nb)):
            idxs = self._coords_of_body[i]
            if Ss[i] is not None:
                tau = tau.at[jnp.asarray(idxs)].set(Ss[i].T @ f[i])
            pa = self.parents[i]
            if pa != GROUND:
                f[pa] = f[pa] + Xups[i].T @ f[i]
        return tau

    def bias_forces(self, p, q, u):
        """C(q,u) + gravity terms: rnea with zero acceleration."""
        return self.rnea(p, q, u, jnp.zeros_like(u))

    def mass_matrix(self, p, q):
        """Joint-space inertia matrix via the composite-rigid-body
        algorithm, generalized to multi-dof joints."""
        dtype = q.dtype
        zu = jnp.zeros(self.nq, dtype=dtype)
        Ic = []
        Xups = []
        Ss = []
        for i in range(self.nb):
            Xup, S, _, _, _ = self._body_motion(i, p, q, zu, zu)
            Xups.append(Xup)
            Ss.append(S)
            Ic.append(spatial_inertia(p["mass"][i].astype(dtype),
                                      p["com"][i].astype(dtype),
                                      p["inertia"][i].astype(dtype)))
        for i in reversed(range(self.nb)):
            pa = self.parents[i]
            if pa != GROUND:
                Ic[pa] = Ic[pa] + Xups[i].T @ Ic[i] @ Xups[i]
        if self.nq == 0:
            return jnp.zeros((0, 0), dtype=dtype)
        H = jnp.zeros((self.nq, self.nq), dtype=dtype)

        def set_block(H, rows, cols, B):
            r = jnp.asarray(rows)[:, None]
            c = jnp.asarray(cols)[None, :]
            return H.at[r, c].set(B)

        for i in range(self.nb):
            ci = self._coords_of_body[i]
            if Ss[i] is None:
                continue
            F = Ic[i] @ Ss[i]  # (6, d_i)
            H = set_block(H, ci, ci, Ss[i].T @ F)
            j = i
            while self.parents[j] != GROUND:
                F = Xups[j].T @ F
                j = self.parents[j]
                cj = self._coords_of_body[j]
                if cj:
                    B = Ss[j].T @ F  # (d_j, d_i)
                    H = set_block(H, cj, ci, B)
                    H = set_block(H, ci, cj, B.T)
        return H

    def forward_dynamics(self, p, q, u, tau_applied):
        """udot = M(q)^{-1} (tau_applied - bias(q, u))."""
        M = self.mass_matrix(p, q)
        b = self.bias_forces(p, q, u)
        return jnp.linalg.solve(M, tau_applied - b)

    def joint_reaction_wrenches(self, p, q, u, udot,
                                body_wrenches_world=None):
        """Spatial reaction each joint transmits to its child body.

        Returns (nb, 6) rows of [moment; force] expressed in ground, with
        the moment taken about the joint's child-frame origin — the quantity
        Simbody's calcReactionOnChildExpressedInGround reports and the
        reference's MocoJointReactionGoal consumes
        (MocoJointReactionGoal.cpp:117-154). Computed by the RNEA backward
        pass: the force transmitted across joint i balances the Newton-Euler
        dynamics of the subtree rooted at body i, minus applied body
        wrenches (``body_wrenches_world``: (nb, 6) world wrenches at body
        origins). Gravity enters via the fictitious base acceleration, so
        reactions include gravity loads automatically.
        """
        dtype = q.dtype
        g = p["gravity"].astype(dtype)
        a_base = jnp.concatenate([jnp.zeros(3, dtype=dtype), -g])
        frames = self.frames(p, q)
        v = [None] * self.nb
        a = [None] * self.nb
        f = [None] * self.nb
        Xups = [None] * self.nb
        for i in range(self.nb):
            Xup, S, vJ, aJ, idxs = self._body_motion(i, p, q, u, udot)
            Xups[i] = Xup
            pa = self.parents[i]
            v_p = jnp.zeros(6, dtype=dtype) if pa == GROUND else v[pa]
            a_p = a_base if pa == GROUND else a[pa]
            v[i] = Xup @ v_p + vJ
            a[i] = Xup @ a_p + aJ + crm(v[i]) @ vJ
            I = spatial_inertia(p["mass"][i].astype(dtype),
                                p["com"][i].astype(dtype),
                                p["inertia"][i].astype(dtype))
            f[i] = I @ a[i] + crf(v[i]) @ (I @ v[i])
            if body_wrenches_world is not None:
                A, o = frames[i]
                n_b = A @ body_wrenches_world[i, :3]
                f_b = A @ body_wrenches_world[i, 3:]
                f[i] = f[i] - jnp.concatenate([n_b, f_b])
        for i in reversed(range(self.nb)):
            pa = self.parents[i]
            if pa != GROUND:
                f[pa] = f[pa] + Xups[i].T @ f[i]
        out = []
        for i in range(self.nb):
            A, o = frames[i]
            n_w = A.T @ f[i][:3]
            fl_w = A.T @ f[i][3:]
            # shift moment from the body origin to the joint's child-frame
            # origin: m_X = m_O - (X - O) x F, X - O = A^T child_r
            r_w = A.T @ jnp.asarray(self._child_r[i], dtype=dtype)
            n_w = n_w - jnp.cross(r_w, fl_w)
            out.append(jnp.concatenate([n_w, fl_w]))
        return jnp.stack(out)


class MechModelBuilder:
    """Imperative builder mirroring how reference models are assembled
    programmatically (cf. ModelFactory, reference
    Moco/Moco/Components/ModelFactory.h:39-90)."""

    def __init__(self, gravity=(0.0, -9.80665, 0.0)):
        self._bodies: list[BodySpec] = []
        self._joints: list[JointSpec] = []
        self._parents: list[int] = []
        self._tree_E: list[np.ndarray] = []
        self._tree_r: list[np.ndarray] = []
        self._child_E: list[np.ndarray] = []
        self._child_r: list[np.ndarray] = []
        self._name_to_idx: dict[str, int] = {"ground": GROUND}
        self._gravity = np.asarray(gravity, dtype=np.float64)

    def add_body(self, name, mass=0.0, com=(0, 0, 0), inertia=None,
                 joint_name=None, kind="weld", parent="ground", axis=(0, 0, 1),
                 tree_r=(0, 0, 0), tree_E=None, coord_name=None,
                 child_r=(0, 0, 0), child_E=None, joint_label=None,
                 coord_names=(), custom_axes=()):
        """Add a body and the joint that connects it to ``parent``.

        ``tree_r``/``tree_E`` give the joint frame pose in the parent frame;
        ``child_r``/``child_E`` its pose in the child frame (OpenSim's
        two-sided offset frames). ``coord_name`` defaults to
        ``<joint_name>_coord`` for non-weld joints.
        """
        if inertia is None:
            inertia = np.zeros((3, 3))
        inertia = np.asarray(inertia, dtype=np.float64)
        if inertia.shape == (3,):
            inertia = np.diag(inertia)
        if tree_E is None:
            tree_E = np.eye(3)
        if child_E is None:
            child_E = np.eye(3)
        if joint_name is None:
            joint_name = f"{name}_joint"
        if kind not in _VALID_KINDS:
            raise ValueError(f"unknown joint kind {kind!r}")
        if kind == "custom":
            assert coord_names and custom_axes, \
                "custom joints need coord_names and custom_axes"
            coord_name = coord_names[0]
        elif kind != "weld" and coord_name is None:
            coord_name = f"{joint_name}_coord"
        ax = np.asarray(axis, dtype=np.float64)
        n = np.linalg.norm(ax)
        if kind not in ("weld", "custom"):
            ax = ax / n
        self._bodies.append(BodySpec(name, float(mass),
                                     tuple(np.asarray(com, dtype=np.float64)),
                                     tuple(map(tuple, inertia))))
        self._joints.append(JointSpec(joint_name, kind, tuple(ax), coord_name,
                                      joint_label or joint_name,
                                      tuple(coord_names),
                                      tuple(custom_axes)))
        self._parents.append(self._name_to_idx[parent])
        self._tree_E.append(np.asarray(tree_E, dtype=np.float64))
        self._tree_r.append(np.asarray(tree_r, dtype=np.float64))
        self._child_E.append(np.asarray(child_E, dtype=np.float64))
        self._child_r.append(np.asarray(child_r, dtype=np.float64))
        self._name_to_idx[name] = len(self._bodies) - 1
        return self._name_to_idx[name]

    def body_index(self, name: str) -> int:
        return self._name_to_idx[name]

    def finalize(self) -> MechModel:
        return MechModel(self._bodies, self._joints, self._parents,
                         np.stack(self._tree_E), np.stack(self._tree_r),
                         self._gravity, np.stack(self._child_E),
                         np.stack(self._child_r))
