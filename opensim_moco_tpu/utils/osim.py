"""OpenSim .osim model parser -> opensim_moco_tpu Model.

Parses the subset of the OpenSim 4.x XML model format needed by the
BASELINE configs (2D_gait.osim for example2DWalking MocoTrack;
subject_walk_armless_18musc.osim for MocoInverse):

* Body (mass, mass_center, inertia)
* PinJoint / SliderJoint / PlanarJoint / WeldJoint with two-sided
  PhysicalOffsetFrames (translation + body-fixed x-y-z orientation)
* DeGrooteFregly2016Muscle with GeometryPath of PathPoint /
  ConditionalPathPoint / MovingPathPoint (SimmSpline / MultiplierFunction)
* CoordinateActuator
* SmoothSphereHalfSpaceForce + ContactSphere / ContactHalfSpace
* CoordinateCouplerConstraint (LinearFunction / SimmSpline couplings)

Cited structures: reference Moco/Examples/C++/example2DWalking/2D_gait.osim,
Moco/Tests/subject_walk_armless_18musc.osim.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET

import numpy as np

from ..models import muscle as dgf
from ..models.mech import GROUND, MechModelBuilder
from ..models.model import Model


def _vec(text, n=3):
    return np.array([float(x) for x in text.split()])


def _euler_xyz_to_E(o):
    """Body-fixed x-y-z rotation sequence -> coordinate map parent->frame.

    R = Rx Ry Rz (active orientation of the frame in its parent);
    E = R^T maps parent coordinates to frame coordinates."""
    cx, sx = np.cos(o[0]), np.sin(o[0])
    cy, sy = np.cos(o[1]), np.sin(o[1])
    cz, sz = np.cos(o[2]), np.sin(o[2])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rx @ Ry @ Rz).T


def _find_text(el, tag, default=None):
    c = el.find(tag)
    return c.text.strip() if c is not None and c.text else default


def _parse_frames(joint_el):
    """Map offset-frame name -> (socket_parent_path, translation, E)."""
    frames = {}
    fr = joint_el.find("frames")
    if fr is None:
        return frames
    for f in fr.findall("PhysicalOffsetFrame"):
        name = f.get("name")
        parent = _find_text(f, "socket_parent")
        t = _vec(_find_text(f, "translation", "0 0 0"))
        o = _vec(_find_text(f, "orientation", "0 0 0"))
        frames[name] = (parent, t, _euler_xyz_to_E(o))
    return frames


def _body_of_socket(path):
    """'/bodyset/femur_r' or '/ground' -> body name."""
    return path.rstrip("/").split("/")[-1]


class _SimmSpline:
    def __init__(self, x, y):
        from .splines import CubicSpline
        self.spline = CubicSpline(np.asarray(x), np.asarray(y))

    def __call__(self, v):
        return self.spline(v)


def _parse_function(el):
    """Parse a function element (SimmSpline, LinearFunction, Constant,
    MultiplierFunction) into a callable."""
    if el is None:
        return None
    tag = el.tag
    if tag == "SimmSpline" or tag == "NaturalCubicSpline":
        x = _vec(_find_text(el, "x"))
        y = _vec(_find_text(el, "y"))
        return _SimmSpline(x, y)
    if tag == "LinearFunction":
        coeffs = _vec(_find_text(el, "coefficients"), 2)
        return lambda v, c=coeffs: c[0] * v + c[1]
    if tag == "Constant":
        val = float(_find_text(el, "value", "0"))
        return lambda v, c=val: c + 0.0 * v
    if tag == "MultiplierFunction":
        inner_el = el.find("function")
        inner = _parse_function(list(inner_el)[0]) if inner_el is not None \
            else None
        scale = float(_find_text(el, "scale", "1"))
        return lambda v, f=inner, s=scale: s * f(v)
    if tag == "PiecewiseLinearFunction":
        x = _vec(_find_text(el, "x"))
        y = _vec(_find_text(el, "y"))
        import jax.numpy as jnp
        return lambda v, xx=x, yy=y: jnp.interp(v, jnp.asarray(xx),
                                                jnp.asarray(yy))
    raise ValueError(f"unsupported function {tag}")


def _parse_spatial_transform(st, coords):
    """TransformAxis list -> custom_axes tuples (shared by 3.x/4.x)."""
    axes = []
    order = ["rotation1", "rotation2", "rotation3",
             "translation1", "translation2", "translation3"]
    ax_els = {a.get("name"): a for a in st.findall("TransformAxis")}
    for axname in order:
        a = ax_els.get(axname)
        if a is None:
            axes.append(((0.0, 0.0, 1.0), None, 0))
            continue
        axis = tuple(_vec(_find_text(a, "axis", "0 0 1")))
        cn_el = a.find("coordinates")
        cn = (cn_el.text.strip().split()
              if cn_el is not None and cn_el.text else [])
        fn = None
        for child in a:
            if child.tag in ("LinearFunction", "SimmSpline",
                            "NaturalCubicSpline", "Constant",
                            "MultiplierFunction", "PiecewiseLinearFunction"):
                fn = _parse_function(child)
                break
            if child.tag == "function" and len(child):
                fn = _parse_function(list(child)[0])
                break
        if fn is None:
            axes.append((axis, None, 0))
            continue
        ci = coords.index(cn[0]) if cn else 0
        axes.append((axis, fn, ci))
    return tuple(axes)


def _build_tree_v3(model_el, builder, body_props, coord_info, weld_joints):
    """OpenSim 3.x: each Body carries its Joint; insert topologically."""
    bodyset = model_el.find("BodySet")
    pend = []
    for b in bodyset.find("objects").findall("Body"):
        name = b.get("name")
        if name == "ground":
            continue
        jel = b.find("Joint")
        joint = list(jel)[0] if jel is not None and len(jel) else None
        pend.append((name, joint))
    placed = {"ground"}
    while pend:
        progressed = False
        remaining = []
        for name, joint in pend:
            parent = _find_text(joint, "parent_body", "ground")
            if parent not in placed:
                remaining.append((name, joint))
                continue
            progressed = True
            placed.add(name)
            mass, com, I = body_props[name]
            jname = joint.get("name")
            tree_r = _vec(_find_text(joint, "location_in_parent", "0 0 0"))
            tree_E = _euler_xyz_to_E(_vec(
                _find_text(joint, "orientation_in_parent", "0 0 0")))
            child_r = _vec(_find_text(joint, "location", "0 0 0"))
            child_E = _euler_xyz_to_E(_vec(
                _find_text(joint, "orientation", "0 0 0")))
            coords = []
            cset = joint.find("CoordinateSet")
            if cset is not None and cset.find("objects") is not None:
                for c in cset.find("objects").findall("Coordinate"):
                    cname = c.get("name")
                    rng = _vec(_find_text(c, "range", "-10 10"), 2)
                    dv = float(_find_text(c, "default_value", "0"))
                    coord_info[cname] = {"range": (rng[0], rng[1]),
                                         "default": dv, "joint": jname}
                    coords.append(cname)
            kwargs = dict(mass=mass, com=com, inertia=I, joint_name=jname,
                          parent=parent, tree_r=tree_r, tree_E=tree_E,
                          child_r=child_r, child_E=child_E,
                          joint_label=jname)
            if joint.tag == "WeldJoint" or jname in weld_joints or \
                    not coords:
                builder.add_body(name, kind="weld", **kwargs)
            elif joint.tag == "CustomJoint":
                st = joint.find("SpatialTransform")
                axes = _parse_spatial_transform(st, coords)
                builder.add_body(name, kind="custom", coord_names=coords,
                                 custom_axes=axes, **kwargs)
            elif joint.tag == "PinJoint":
                builder.add_body(name, kind="revolute", axis=(0, 0, 1),
                                 coord_name=coords[0], **kwargs)
            elif joint.tag == "SliderJoint":
                builder.add_body(name, kind="prismatic", axis=(1, 0, 0),
                                 coord_name=coords[0], **kwargs)
            else:
                raise NotImplementedError(f"v3 joint {joint.tag}")
        if not progressed:
            raise ValueError(f"unresolvable body tree: {remaining}")
        pend = remaining


def parse_osim(path, gravity=None, weld_joints=(), weld_q=None):
    """Parse an .osim file into a finalized Model.

    ``weld_joints``: joint names to replace with welds at the default
    coordinate values (ModOpReplaceJointsWithWelds analogue).
    Returns (model, info) where info carries name maps.
    """
    source_path = path  # `path` is reused for muscle paths below
    tree = ET.parse(path)
    root = tree.getroot()
    model_el = root.find("Model")
    g = _vec(_find_text(model_el, "gravity", "0 -9.80665 0")) \
        if gravity is None else np.asarray(gravity)

    builder = MechModelBuilder(gravity=g)
    weld_q = dict(weld_q or {})

    # ---- bodies (+ attached wrap objects)
    bodyset = model_el.find("BodySet")
    body_props = {}
    wrap_objects = {}  # name -> dict(body_name, translation, rot, radius, q)
    for b in bodyset.find("objects").findall("Body"):
        name = b.get("name")
        mass = float(_find_text(b, "mass", "0"))
        com = _vec(_find_text(b, "mass_center", "0 0 0"))
        # OpenSim <=3.x uses inertia_xx..; 4.x a 6-vector
        itxt = _find_text(b, "inertia")
        if itxt is not None:
            in6 = _vec(itxt, 6)
        else:
            in6 = np.array([float(_find_text(b, f"inertia_{c}", "0"))
                            for c in ("xx", "yy", "zz", "xy", "xz", "yz")])
        if in6.size == 6:
            I = np.array([[in6[0], in6[3], in6[4]],
                          [in6[3], in6[1], in6[5]],
                          [in6[4], in6[5], in6[2]]])
        else:
            I = np.diag(in6[:3])
        body_props[name] = (mass, com, I)
        wos = b.find("WrapObjectSet")
        if wos is not None:
            objs = wos.find("objects")
            if objs is not None:
                for w in objs.findall("WrapCylinder"):
                    wrap_objects[w.get("name")] = {
                        "body_name": name,
                        "translation": tuple(_vec(
                            _find_text(w, "translation", "0 0 0"))),
                        "xyz_rotation": tuple(_vec(
                            _find_text(w, "xyz_body_rotation", "0 0 0"))),
                        "radius": float(_find_text(w, "radius", "0.02")),
                        "quadrant": _find_text(w, "quadrant", "all"),
                    }

    # ---- joints (define the tree)
    jointset = model_el.find("JointSet")
    coord_info = {}  # coord name -> (range, default, clamped)
    added = set()
    if jointset is None:
        # OpenSim 3.x: joints nested inside bodies
        _build_tree_v3(model_el, builder, body_props, coord_info,
                       weld_joints)
        joint_iter = []
    else:
        joint_iter = jointset.find("objects")
    # JointSet order is arbitrary in OpenSim (the file can list a child
    # joint before the joint that creates its parent body, e.g.
    # subject_walk_armless.osim lists mtp_l before subtalar_l); sort
    # topologically from ground like Model::finalizeConnections
    if joint_iter is not None and len(list(joint_iter)):
        def _pc(j):
            fr = _parse_frames(j)
            p = _body_of_socket(fr[_find_text(j, "socket_parent_frame")][0])
            c = _body_of_socket(fr[_find_text(j, "socket_child_frame")][0])
            return p, c
        pending = [(j,) + _pc(j) for j in joint_iter]
        known = {"ground"}
        ordered = []
        while pending:
            ready = [e for e in pending if e[1] in known]
            if not ready:
                # disconnected subtree (or loop joint): keep file order
                ready = [pending[0]]
            for e in ready:
                ordered.append(e[0])
                known.add(e[2])
                pending.remove(e)
        joint_iter = ordered
    for j in joint_iter:
        jtag = j.tag
        jname = j.get("name")
        frames = _parse_frames(j)
        pf = _find_text(j, "socket_parent_frame")
        cf = _find_text(j, "socket_child_frame")
        p_sock, p_t, p_E = frames[pf]
        c_sock, c_t, c_E = frames[cf]
        parent_body = _body_of_socket(p_sock)
        child_body = _body_of_socket(c_sock)
        mass, com, I = body_props[child_body]

        coords = []
        cel = j.find("coordinates")
        if cel is not None:
            for c in cel.findall("Coordinate"):
                cname = c.get("name")
                rng = _vec(_find_text(c, "range", "-10 10"), 2)
                dv = float(_find_text(c, "default_value", "0"))
                coord_info[cname] = {"range": (rng[0], rng[1]),
                                     "default": dv, "joint": jname}
                coords.append(cname)

        parent = "ground" if parent_body == "ground" else parent_body
        if jtag == "CustomJoint" and jname not in weld_joints:
            # SpatialTransform: rotation1..3 + translation1..3, each an
            # axis + function(coordinate)
            axes = _parse_spatial_transform(j.find("SpatialTransform"),
                                            coords)
            builder.add_body(child_body, mass=mass, com=com, inertia=I,
                             joint_name=jname, kind="custom", parent=parent,
                             tree_r=p_t, tree_E=p_E, child_r=c_t,
                             child_E=c_E, coord_names=tuple(coords),
                             custom_axes=tuple(axes), joint_label=jname)
        elif jtag == "WeldJoint" or jname in weld_joints:
            builder.add_body(child_body, mass=mass, com=com, inertia=I,
                             joint_name=jname, kind="weld", parent=parent,
                             tree_r=p_t, tree_E=p_E, child_r=c_t, child_E=c_E)
        elif jtag == "PinJoint":
            builder.add_body(child_body, mass=mass, com=com, inertia=I,
                             joint_name=jname, kind="revolute", parent=parent,
                             axis=(0, 0, 1), tree_r=p_t, tree_E=p_E,
                             child_r=c_t, child_E=c_E, coord_name=coords[0])
        elif jtag == "SliderJoint":
            builder.add_body(child_body, mass=mass, com=com, inertia=I,
                             joint_name=jname, kind="prismatic", parent=parent,
                             axis=(1, 0, 0), tree_r=p_t, tree_E=p_E,
                             child_r=c_t, child_E=c_E, coord_name=coords[0])
        elif jtag == "PlanarJoint":
            # Simbody planar mobilizer: q = [theta_z, tx, ty]; decompose as
            # rz about the joint frame, then tx, ty in the rotated frame.
            # Chain: parent -(rz)-> i1 -(tx)-> i2 -(ty)-> child.
            # Simbody planar mobilizer: q = [theta_z, tx, ty], translations
            # along the PARENT (F) frame axes, rotation about z at the
            # translated origin => chain tx -> ty -> rz.
            rz_name, tx_name, ty_name = coords
            builder.add_body(f"_{jname}_tx", mass=0.0, joint_name=f"{jname}",
                             kind="prismatic", parent=parent, axis=(1, 0, 0),
                             tree_r=p_t, tree_E=p_E, coord_name=tx_name,
                             joint_label=jname)
            builder.add_body(f"_{jname}_ty", mass=0.0,
                             joint_name=f"{jname}_ty", kind="prismatic",
                             parent=f"_{jname}_tx", axis=(0, 1, 0),
                             coord_name=ty_name, joint_label=jname)
            builder.add_body(child_body, mass=mass, com=com, inertia=I,
                             joint_name=f"{jname}_rz", kind="revolute",
                             parent=f"_{jname}_ty", axis=(0, 0, 1),
                             child_r=c_t, child_E=c_E, coord_name=rz_name,
                             joint_label=jname)
        else:
            raise NotImplementedError(f"joint type {jtag}")
        added.add(child_body)

    mech = builder.finalize()
    model = Model(mech)
    body_idx = {b.name: i for i, b in enumerate(mech.bodies)}
    body_idx["ground"] = GROUND

    def coord_index(cname):
        return mech.coord_names.index(cname)

    # ---- markers (MarkerSet): body-fixed stations consumed by the
    # marker-tracking path (reference MocoTrack.cpp:235-270 reads the
    # model's MarkerSet to pair with TRC marker trajectories)
    ms_el = model_el.find("MarkerSet")
    if ms_el is not None and ms_el.find("objects") is not None:
        for mk in ms_el.find("objects").findall("Marker"):
            frame = _find_text(mk, "socket_parent_frame") or \
                _find_text(mk, "body", "")
            bname = _body_of_socket(frame)
            if bname in body_idx:
                model.markers[mk.get("name")] = (
                    body_idx[bname],
                    tuple(_vec(_find_text(mk, "location", "0 0 0"))))

    # ---- forces
    forceset = model_el.find("ForceSet")
    contact_geo = {}
    cgs = model_el.find("ContactGeometrySet")
    if cgs is not None:
        for cg in cgs.find("objects"):
            name = cg.get("name")
            frame = _body_of_socket(_find_text(cg, "socket_frame", "/ground"))
            loc = _vec(_find_text(cg, "location", "0 0 0"))
            radius = float(_find_text(cg, "radius", "0"))
            contact_geo[name] = {"type": cg.tag, "body": frame,
                                 "location": loc, "radius": radius}

    # forces live either in ForceSet/objects or in the model's free
    # <components> list (2D_gait.osim uses the latter)
    force_els = []
    if forceset is not None and forceset.find("objects") is not None:
        force_els += list(forceset.find("objects"))
    comps = model_el.find("components")
    if comps is not None:
        force_els += list(comps)

    muscle_names = []
    muscle_wraps = {}
    if True:
        for f in force_els:
            tag = f.tag
            name = f.get("name")
            if tag == "DeGrooteFregly2016Muscle" or tag == \
                    "Millard2012EquilibriumMuscle" or tag == "Thelen2003Muscle":
                # DeGrooteFregly2016Muscle::replaceMuscles copies the
                # source muscle's activation time constants and curve
                # strains (DeGrooteFregly2016Muscle.cpp:954-981), so the
                # defaults here are per source type: Millard2012
                # (0.010/0.040), Thelen2003 (0.015/0.050), DGF
                # (0.015/0.060). Validated against the golden gait
                # solution's activation defects.
                tau_defaults = {
                    "Millard2012EquilibriumMuscle": ("0.01", "0.04"),
                    "Thelen2003Muscle": ("0.015", "0.05"),
                    "DeGrooteFregly2016Muscle": ("0.015", "0.06"),
                }[tag]
                # curve strains live in nested curve objects for Millard
                def _curve_strain(curve_tag, default):
                    c = f.find(curve_tag)
                    if c is not None:
                        v = _find_text(c, "strain_at_one_norm_force")
                        if v is not None:
                            return v
                    return default
                passive_strain = _find_text(
                    f, "passive_fiber_strain_at_one_norm_force",
                    _curve_strain(
                        "FiberForceLengthCurve",
                        "0.7" if tag == "Millard2012EquilibriumMuscle"
                        else "0.6"))
                tendon_strain = _find_text(
                    f, "tendon_strain_at_one_norm_force",
                    _curve_strain("TendonForceLengthCurve", "0.049"))
                params = dgf.default_muscle_params(
                    max_isometric_force=float(
                        _find_text(f, "max_isometric_force", "1000")),
                    optimal_fiber_length=float(
                        _find_text(f, "optimal_fiber_length", "0.1")),
                    tendon_slack_length=float(
                        _find_text(f, "tendon_slack_length", "0.2")),
                    pennation_angle_at_optimal=float(
                        _find_text(f, "pennation_angle_at_optimal", "0")),
                    max_contraction_velocity=float(
                        _find_text(f, "max_contraction_velocity", "10")),
                    activation_time_constant=float(
                        _find_text(f, "activation_time_constant",
                                   tau_defaults[0])),
                    deactivation_time_constant=float(
                        _find_text(f, "deactivation_time_constant",
                                   tau_defaults[1])),
                    active_force_width_scale=float(
                        _find_text(f, "active_force_width_scale", "1")),
                    fiber_damping=float(_find_text(f, "fiber_damping", "0")),
                    passive_fiber_strain_at_one_norm_force=float(
                        passive_strain),
                    tendon_strain_at_one_norm_force=float(tendon_strain),
                )
                ignore_act = _find_text(f, "ignore_activation_dynamics",
                                        "false") == "true"
                ignore_ten = _find_text(f, "ignore_tendon_compliance",
                                        "false") == "true"
                # excitation bounds: min_control if serialized, else the
                # Millard/Thelen minimum_activation (default 0.01), which
                # the muscle promotes to its minControl and replaceMuscles
                # copies (DeGrooteFregly2016Muscle.cpp:995-996)
                min_ctrl = _find_text(f, "min_control")
                if min_ctrl is None:
                    min_ctrl = _find_text(
                        f, "minimum_activation",
                        "0.01" if tag != "DeGrooteFregly2016Muscle"
                        else "0")
                max_ctrl = _find_text(f, "max_control", "1")
                # path points
                gp = f.find("GeometryPath")
                pps = gp.find("PathPointSet").find("objects")
                path = []
                for pp in pps:
                    ptag = pp.tag
                    psock = _find_text(pp, "socket_parent_frame")
                    pbody = (_body_of_socket(psock) if psock
                             else _find_text(pp, "body", "ground"))
                    bi = body_idx[pbody]
                    if ptag == "PathPoint":
                        loc = _vec(_find_text(pp, "location", "0 0 0"))
                        path.append(("fixed", bi, tuple(loc)))
                    elif ptag == "ConditionalPathPoint":
                        loc = _vec(_find_text(pp, "location", "0 0 0"))
                        rng = _vec(_find_text(pp, "range", "-10 10"), 2)
                        csock = _find_text(pp, "socket_coordinate")
                        cname = (_body_of_socket(csock) if csock
                                 else _find_text(pp, "coordinate"))
                        ci = coord_index(cname)
                        path.append(("conditional", bi, tuple(loc), ci,
                                     rng[0], rng[1]))
                    elif ptag == "MovingPathPoint":
                        default_loc = _vec(_find_text(pp, "location",
                                                      "0 0 0"))
                        fns = []
                        for k, ax in enumerate(("x", "y", "z")):
                            fel = pp.find(f"{ax}_location")
                            fn = _parse_function(list(fel)[0]) \
                                if fel is not None and len(fel) else None
                            csock = _find_text(pp, f"socket_{ax}_coordinate")
                            if csock:
                                ci = coord_index(_body_of_socket(csock))
                            else:
                                cname = _find_text(pp, f"{ax}_coordinate")
                                ci = coord_index(cname) if cname else None
                            if fn is None or ci is None:
                                # constant component from the default location
                                fn = (lambda v, c=float(default_loc[k]):
                                      c + 0.0 * v)
                                ci = 0
                            fns.append((fn, ci))
                        path.append(("moving", bi, tuple(fns)))
                    else:
                        raise NotImplementedError(f"path point {ptag}")
                model.add_muscle(name, path=path, params=params,
                                 ignore_activation_dynamics=ignore_act,
                                 ignore_tendon_compliance=ignore_ten,
                                 min_control=float(min_ctrl),
                                 max_control=float(max_ctrl))
                muscle_names.append(name)
                pws = gp.find("PathWrapSet")
                if pws is not None and pws.find("objects") is not None:
                    for pw in pws.find("objects").findall("PathWrap"):
                        rng = _vec(_find_text(pw, "range", "-1 -1"), 2)
                        muscle_wraps.setdefault(name, []).append(
                            (_find_text(pw, "wrap_object"),
                             (int(rng[0]), int(rng[1]))))
            elif tag == "CoordinateActuator":
                cname = _find_text(f, "coordinate")
                gain = float(_find_text(f, "optimal_force", "1"))
                mn = float(_find_text(f, "min_control", "-inf"))
                mx = float(_find_text(f, "max_control", "inf"))
                model.add_coordinate_actuator(name, coord_index(cname),
                                              optimal_force=gain,
                                              min_control=mn, max_control=mx)
            elif tag == "SmoothSphereHalfSpaceForce":
                sph = contact_geo[_body_of_socket(
                    _find_text(f, "socket_sphere"))]
                model.add_sphere_contact(
                    name, body=body_idx[sph["body"]],
                    location=tuple(sph["location"]), radius=sph["radius"],
                    stiffness=float(_find_text(f, "stiffness", "1e6")),
                    dissipation=float(_find_text(f, "dissipation", "2")),
                    static_friction=float(
                        _find_text(f, "static_friction", "0.8")),
                    dynamic_friction=float(
                        _find_text(f, "dynamic_friction", "0.8")),
                    viscous_friction=float(
                        _find_text(f, "viscous_friction", "0.5")),
                    transition_velocity=float(
                        _find_text(f, "transition_velocity", "0.2")),
                    constant_contact_force=float(
                        _find_text(f, "constant_contact_force", "1e-5")),
                    hertz_smoothing=float(
                        _find_text(f, "hertz_smoothing", "300")),
                    hunt_crossley_smoothing=float(
                        _find_text(f, "hunt_crossley_smoothing", "50")),
                    derivative_smoothing=float(
                        _find_text(f, "derivative_smoothing", "1e-5")))

    # ---- constraints (CoordinateCouplerConstraint)
    coupler_list = []
    conset = model_el.find("ConstraintSet")
    if conset is not None:
        for c in conset.find("objects"):
            if c.tag != "CoordinateCouplerConstraint":
                continue
            dep = _find_text(c, "dependent_coordinate_name")
            ind_el = c.find("independent_coordinate_names")
            ind = ind_el.text.strip().split() if ind_el is not None else []
            fel = c.find("coupled_coordinates_function")
            fn = _parse_function(list(fel)[0]) if fel is not None else None
            di = coord_index(dep)
            ii = coord_index(ind[0])
            coupler_list.append({"name": c.get("name"), "dependent": dep,
                                 "independent": ind[0], "fn": fn})
            model.couplers.append((di, ii, fn))

            def make_phi(di=di, ii=ii, fn=fn):
                import jax.numpy as jnp

                def phi(mp, q):
                    return jnp.atleast_1d(q[di] - fn(q[ii]))

                return phi

            model.add_kinematic_constraint(c.get("name"), make_phi())

    # ---- assign PathWrap cylinders with their candidate segments
    if muscle_wraps:
        from ..models.wrap import WrapCylinderSpec

        new_muscles = []
        for mi, ms in enumerate(model.muscles):
            wraps = muscle_wraps.get(ms.name)
            if not wraps:
                new_muscles.append(ms)
                continue
            nseg = len(ms.path) - 1
            spec_list = []
            for wname, rng in wraps:
                wo = wrap_objects[wname]
                spec = WrapCylinderSpec(
                    wname, body_idx[wo["body_name"]], wo["translation"],
                    wo["xyz_rotation"], wo["radius"], wo["quadrant"])
                # PathWrap range (1-based path-point window r0..r1): the
                # wrap may act on any segment incident to that window,
                # segments r0-1 .. r1-1 0-based. Validated against the
                # reference golden gait solution: psoas' PS_at_brim range
                # "2 3" engages on the P3->P4 segment at hip extension.
                # -1 -1 = all.
                if rng[0] > 0:
                    cands = tuple(range(rng[0] - 1, min(rng[1], nseg)))
                else:
                    cands = tuple(range(nseg))
                spec_list.append((spec, cands))
            new_muscles.append(dataclasses.replace(
                ms, wraps=tuple(spec_list)))
        model.muscles = new_muscles
        model.finalize()

    info = {"coord_info": coord_info, "muscles": muscle_names,
            "body_idx": body_idx, "wrap_objects": wrap_objects,
            "couplers": coupler_list}
    # provenance for tree-structure ModOps (ModOpReplaceJointsWithWelds)
    model._source = {"path": source_path, "gravity": gravity,
                     "weld_joints": tuple(weld_joints), "weld_q": weld_q}
    return model, info


def parse_external_loads(xml_path, base_dir=None, lowpass_hz=None):
    """Parse an OpenSim ExternalLoads XML + its datafile into specs usable
    with Model.add_external_force (ModOpAddExternalLoads analogue).

    Returns a list of dicts: {name, body_name, force_fn, point_fn,
    torque_fn} with time-interpolating jnp closures."""
    import os

    import jax.numpy as jnp

    from .tables import read_sto

    tree = ET.parse(xml_path)
    root = tree.getroot()
    el = root.find("ExternalLoads")
    datafile = _find_text(el, "datafile")
    base = base_dir or os.path.dirname(os.path.abspath(xml_path))
    table = read_sto(os.path.join(base, datafile))
    if lowpass_hz:
        from .processors import filter_lowpass
        table = filter_lowpass(table, lowpass_hz)
    times = np.asarray(table.time)

    def interp3(prefix, suffixes=("x", "y", "z")):
        cols = []
        for s in suffixes:
            name = prefix + s
            if name not in table.column_names:
                return None
            cols.append(np.asarray(table.column(name)))
        data = np.stack(cols, axis=1)
        # the reference's ExternalForce samples its data through GCVSpline
        # of degree 5 (ExternalForce::computeForce); a quintic
        # interpolating spline matches it far better than linear interp
        from .splines import QuinticSpline
        spline = QuinticSpline(times, data)

        def fn(t, s=spline):
            return s(t)

        return fn

    out = []
    for f in el.find("objects").findall("ExternalForce"):
        body = _find_text(f, "applied_to_body")
        fid = _find_text(f, "force_identifier")
        pid = _find_text(f, "point_identifier")
        tid = _find_text(f, "torque_identifier")
        out.append({
            "name": f.get("name"),
            "body_name": body,
            "force_fn": interp3(fid),
            "point_fn": interp3(pid),
            "torque_fn": interp3(tid) if tid else None,
        })
    return out
