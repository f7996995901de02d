"""Muscle-path wrapping surfaces.

Cylinder wrap via the obstacle-set method (Garner & Pandy 2000), the
geometry behind OpenSim's WrapCylinder (used 40x by the reference's
subject_walk_armless_18musc.osim gait model). Fully differentiable:

* in the cylinder cross-section, the shortest path from P to Q around a
  circle of radius R is tangent-arc-tangent;
* developing (unrolling) the cylinder + tangent planes, the 3D shortest
  path is a straight line, so its length is
  ``sqrt(L_plane^2 + dz^2)`` with ``L_plane = d_P + R*arc + d_Q``, and the
  tangent points' axial coordinates interpolate linearly in developed
  arc length;
* the wrap engages only when the planar segment crosses the circle; at
  grazing incidence the wrapped and straight lengths agree, so the switch
  (`jnp.where`) is continuous.

Validated against the reference's golden gait solution: the implied
muscle-tendon lengths extracted from the implicit-tendon equilibrium of
std_testMocoInverse_subject_18musc_solution.sto and the inverse-dynamics
residual at the golden iterate.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class WrapCylinderSpec:
    """Cylinder fixed in a body. ``translation``/``xyz_rotation`` give the
    cylinder frame pose in the body (axis = local z). ``quadrant``
    restricts which side of the cylinder the path may wrap around
    (OpenSim WrapObject quadrant: 'all', '+x', '-x', '+y', '-y')."""
    name: str
    body: int
    translation: tuple
    xyz_rotation: tuple
    radius: float
    quadrant: str = "all"

    def rotation(self):
        """Body->cylinder coordinate map E (numpy, static)."""
        rx, ry, rz = self.xyz_rotation
        cx, sx = np.cos(rx), np.sin(rx)
        cy, sy = np.cos(ry), np.sin(ry)
        cz, sz = np.cos(rz), np.sin(rz)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return (Rx @ Ry @ Rz).T


_AXIS = {"x": 0, "y": 1}


def _wrap_2d(p, q, R, quadrant_sign, quadrant_axis):
    """Planar tangent-arc-tangent around the circle of radius R.

    Returns (planar_length, engaged, tp, tq, dp, dq, arc):
    tangent-point angles tp (entry) and tq (exit), tangent lengths dp/dq,
    and the arc angle. ``engaged`` is False when the straight segment
    clears the circle or the wrap would be on the inactive side."""
    rp = jnp.sqrt(p @ p)
    rq = jnp.sqrt(q @ q)
    # tangent lengths (guard points inside the circle: clamp)
    dp = jnp.sqrt(jnp.maximum(rp ** 2 - R ** 2, 1e-12))
    dq = jnp.sqrt(jnp.maximum(rq ** 2 - R ** 2, 1e-12))
    # angles of p, q and tangent half-angles
    ap = jnp.arctan2(p[1], p[0])
    aq = jnp.arctan2(q[1], q[0])
    bp = jnp.arccos(jnp.clip(R / jnp.maximum(rp, R + 1e-12), -1.0, 1.0))
    bq = jnp.arccos(jnp.clip(R / jnp.maximum(rq, R + 1e-12), -1.0, 1.0))

    # Two tangent-point pairings; for each, the arc's travel direction is
    # fixed by tangent consistency: the incoming segment direction at the
    # entry tangent point must match the arc's velocity there.
    def candidate(tp, tq):
        Tp = R * jnp.stack([jnp.cos(tp), jnp.sin(tp)])
        d_ccw = jnp.stack([-jnp.sin(tp), jnp.cos(tp)])
        sigma = jnp.sign(jnp.sum((Tp - p) * d_ccw) + 1e-16)
        arc = jnp.mod(sigma * (tq - tp), 2 * jnp.pi)
        mid = tp + sigma * 0.5 * arc
        return dp + R * arc + dq, mid, arc

    tp_a, tq_a = ap + bp, aq - bq
    tp_b, tq_b = ap - bp, aq + bq
    len_a, mid_a, arc_a = candidate(tp_a, tq_a)
    len_b, mid_b, arc_b = candidate(tp_b, tq_b)

    if quadrant_axis is None:
        pick_a = len_a < len_b
        engaged_side = jnp.asarray(True)
    else:
        # pick the pairing whose arc midpoint lies on the active side
        mid_pt_a = jnp.stack([jnp.cos(mid_a), jnp.sin(mid_a)])
        mid_pt_b = jnp.stack([jnp.cos(mid_b), jnp.sin(mid_b)])
        ok_a = quadrant_sign * mid_pt_a[quadrant_axis] >= 0
        ok_b = quadrant_sign * mid_pt_b[quadrant_axis] >= 0
        pick_a = jnp.where(ok_a & ok_b, len_a < len_b, ok_a)
        engaged_side = ok_a | ok_b

    planar = jnp.where(pick_a, len_a, len_b)
    tp_s = jnp.where(pick_a, tp_a, tp_b)
    tq_s = jnp.where(pick_a, tq_a, tq_b)
    arc_s = jnp.where(pick_a, arc_a, arc_b)

    # does the straight planar segment cross the circle?
    d = q - p
    dd = d @ d
    tpar = jnp.clip(-(p @ d) / jnp.maximum(dd, 1e-16), 0.0, 1.0)
    closest = p + tpar * d
    crosses = (closest @ closest) < R ** 2
    if quadrant_axis is not None:
        # OpenSim mandatory far-side wrap (WrapCylinder::wrapLine with
        # _wrapSign): when the straight segment passes on the side
        # OPPOSITE the active quadrant, the path must still wrap around
        # the quadrant side (e.g. psoas over the pelvic brim, quadrant
        # -y: the chord passes above the brim center, the muscle bends
        # under it)
        far_side = quadrant_sign * closest[quadrant_axis] < 0
        crosses = crosses | far_side
    return planar, crosses & engaged_side, tp_s, tq_s, dp, dq, arc_s


def _quadrant_args(quadrant):
    if quadrant in (None, "all", ""):
        return None, 1.0
    sign = -1.0 if quadrant.startswith("-") else 1.0
    return _AXIS[quadrant.lstrip("+-")], sign


def cylinder_wrap(P, Q, radius, quadrant="all"):
    """Shortest path P -> (around cylinder, axis = z, centered at origin)
    -> Q. P, Q: (3,) points in the cylinder frame.

    Returns (length, engaged, T1, T2): T1/T2 are the 3D tangent points on
    the cylinder surface (z placed by unrolled development), valid when
    ``engaged``; length falls back to |PQ| when the wrap does not engage.
    """
    p2, q2 = P[:2], Q[:2]
    axis, sign = _quadrant_args(quadrant)
    planar, engaged, tp, tq, dp, dq, arc = _wrap_2d(p2, q2, radius, sign,
                                                    axis)
    dz = Q[2] - P[2]
    wrapped = jnp.sqrt(planar ** 2 + dz ** 2)
    straight = jnp.sqrt(jnp.sum((Q - P) ** 2) + 1e-30)
    # wrapped >= straight always holds geometrically; the max guards the
    # near-grazing region where both are equal to rounding
    length = jnp.where(engaged, jnp.maximum(wrapped, straight), straight)
    # tangent-point axial placement: linear in developed arc length
    denom = jnp.maximum(planar, 1e-12)
    z1 = P[2] + dz * dp / denom
    z2 = Q[2] - dz * dq / denom
    T1 = jnp.stack([radius * jnp.cos(tp), radius * jnp.sin(tp), z1])
    T2 = jnp.stack([radius * jnp.cos(tq), radius * jnp.sin(tq), z2])
    return length, engaged, T1, T2


def cylinder_wrap_length(P, Q, radius, quadrant="all"):
    """Length-only wrapper around :func:`cylinder_wrap`."""
    return cylinder_wrap(P, Q, radius, quadrant)[0]


def chained_wrap_length(a, b, cyl_frames):
    """Segment a->b over multiple cylinders applied sequentially (OpenSim
    GeometryPath::applyWrapObjects applies each PathWrap in order, with
    earlier wraps' tangent points acting as via points for later ones —
    e.g. med_gas over Gastroc_at_condyles + GasMed_at_shank,
    subject_walk_armless_18musc.osim).

    ``cyl_frames``: list of (to_cyl, from_cyl, radius, quadrant) for each
    cylinder IN PATH ORDER (proximal first). Tangent points of each
    engaged wrap become the endpoints of its neighbors' sub-segments.
    Returns the total a->b length."""
    straight = jnp.linalg.norm(b - a + 1e-30)
    if len(cyl_frames) == 1:
        to_c, from_c, R, quad = cyl_frames[0]
        L, e, T1, T2 = cylinder_wrap(to_c(a), to_c(b), R, quad)
        return L
    # evaluate each wrap on (a, b) independently, then chain engaged ones
    results = []
    for (to_c, from_c, R, quad) in cyl_frames:
        L, e, T1, T2 = cylinder_wrap(to_c(a), to_c(b), R, quad)
        T1w, T2w = from_c(T1), from_c(T2)
        arc = L - jnp.linalg.norm(T1w - a + 1e-30) - \
            jnp.linalg.norm(b - T2w + 1e-30)
        results.append((L, e, T1w, T2w, jnp.maximum(arc, 0.0)))
    # two-cylinder chain (the only multi-wrap case in the reference
    # models); first cylinder is proximal (nearer a)
    (L1, e1, T1a, T1b, arc1), (L2, e2, T2a, T2b, arc2) = results
    chain = (jnp.linalg.norm(T1a - a + 1e-30) + arc1 +
             jnp.linalg.norm(T2a - T1b + 1e-30) + arc2 +
             jnp.linalg.norm(b - T2b + 1e-30))
    return jnp.where(e1 & e2, jnp.maximum(chain, straight),
                     jnp.where(e1, L1, jnp.where(e2, L2, straight)))
