"""Table and model processing pipelines.

TableProcessor / TabOp* and ModelProcessor / ModOp* analogues (reference
Common/TableProcessor.h, Moco/Moco/ModelOperators.h:29-335): small
composable operations applied before a tool consumes a table or model.
Python callables compose with `|` like the reference's operator chains.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np

from .tables import StoTable


def filter_lowpass(table: StoTable, cutoff_hz: float,
                   order: int = 3) -> StoTable:
    """Zero-phase Butterworth low-pass (reference filterLowpass,
    MocoUtilities.cpp:199-208: Storage::pad + Storage::lowpassIIR, a
    3rd-order Butterworth run forward+backward; validated to reproduce
    the golden testMocoInverse prescribed kinematics to ~1e-5)."""
    from scipy.signal import butter, filtfilt

    dt = np.mean(np.diff(table.time))
    wn = min(0.999, 2.0 * cutoff_hz * dt)
    b, a = butter(order, wn)
    data = filtfilt(b, a, table.data, axis=0)
    return StoTable(table.time, table.column_names, data, table.metadata)


def convert_degrees_to_radians(table: StoTable) -> StoTable:
    """inDegrees=yes tables -> radians (reference convertTableToStorage +
    Model::getSimbodyEngine().convertDegreesToRadians)."""
    if not table.in_degrees():
        return table
    meta = dict(table.metadata)
    meta["inDegrees"] = "no"
    return StoTable(table.time, table.column_names,
                    np.deg2rad(table.data), meta)


def resample_table(table: StoTable, new_time) -> StoTable:
    new_time = np.asarray(new_time)
    data = np.stack([np.interp(new_time, table.time, table.data[:, j])
                     for j in range(table.data.shape[1])], axis=1)
    return StoTable(new_time, table.column_names, data, table.metadata)


class TableProcessor:
    """table | op | op ... (reference Common/TableProcessor.h)."""

    def __init__(self, table_or_path):
        if isinstance(table_or_path, str):
            from .tables import read_sto
            self.table = read_sto(table_or_path)
        else:
            self.table = table_or_path
        self.ops: list[Callable] = []

    def __or__(self, op: Callable) -> "TableProcessor":
        out = TableProcessor(self.table)
        out.ops = self.ops + [op]
        return out

    def process(self) -> StoTable:
        t = self.table
        for op in self.ops:
            t = op(t)
        return t


def TabOpLowPassFilter(cutoff_hz):
    return lambda t: filter_lowpass(t, cutoff_hz)


def TabOpConvertDegreesToRadians():
    return convert_degrees_to_radians


# ---- model operators (subset; grows with the component library) ---------

def ModOpAddReserves(optimal_force=1.0, bound=None):
    """Add a reserve CoordinateActuator to every coordinate
    (reference ModOpAddReserves, ModelOperators.h:310;
    ModelFactory::createReserveActuators). Names follow the reference:
    ``reserve_`` + coordinate path with '/'->'_' (so solution columns line
    up with golden files, e.g. reserve_jointset_hip_r_hip_flexion_r)."""

    def op(model):
        paths = model.coordinate_paths() if model._finalized else None
        if paths is None:
            model.finalize()
            paths = model.coordinate_paths()
        for i, cname in enumerate(model.mech.coord_names):
            pname = paths[i].strip("/").replace("/", "_")
            lo = -np.inf if bound is None else -bound
            hi = np.inf if bound is None else bound
            model.add_coordinate_actuator(f"reserve_{pname}", i,
                                          optimal_force=optimal_force,
                                          min_control=lo, max_control=hi)
        return model

    return op


def ModOpIgnoreActivationDynamics():
    def op(model):
        model.muscles = [
            type(m)(m.name, m.path, True, m.ignore_tendon_compliance,
                    m.tendon_dynamics_implicit, m.ignore_passive_fiber_force)
            for m in model.muscles]
        return model

    return op


def ModOpIgnoreTendonCompliance():
    def op(model):
        model.muscles = [
            type(m)(m.name, m.path, m.ignore_activation_dynamics, True,
                    m.tendon_dynamics_implicit, m.ignore_passive_fiber_force)
            for m in model.muscles]
        return model

    return op


def ModOpIgnorePassiveFiberForcesDGF():
    def op(model):
        model.muscles = [
            type(m)(m.name, m.path, m.ignore_activation_dynamics,
                    m.ignore_tendon_compliance, m.tendon_dynamics_implicit,
                    True)
            for m in model.muscles]
        return model

    return op


def ModOpTendonComplianceDynamicsModeDGF(mode="implicit"):
    def op(model):
        model.muscles = [
            type(m)(m.name, m.path, m.ignore_activation_dynamics,
                    m.ignore_tendon_compliance, mode == "implicit",
                    m.ignore_passive_fiber_force)
            for m in model.muscles]
        return model

    return op


def ModOpScaleMaxIsometricForce(factor):
    def op(model):
        for mp in model._muscle_params:
            mp["max_isometric_force"] = mp["max_isometric_force"] * factor
        return model

    return op


def ModOpReplaceMusclesWithDeGrooteFregly2016():
    """Identity in this framework: every muscle is natively a
    DeGrooteFregly2016 muscle (reference ModOpReplaceMusclesWithDGF,
    ModelOperators.h:143; DeGrooteFregly2016Muscle::replaceMuscles). The
    .osim parser already maps Thelen2003/Millard2012 parameter sets onto
    DGF parameters when reading foreign models.

    Crucially, the reference's replaceMuscles copies ONLY the
    PathPointSet — the PathWrapSet is silently dropped
    (DeGrooteFregly2016Muscle.cpp:1009-1021), so converted muscles run on
    straight via-point paths. The shipped golden gait solutions encode
    exactly this (validated: implied muscle-tendon lengths from
    std_testMocoInverse_subject_18musc_solution.sto match the wrap-free
    paths to <0.3 mm). This op reproduces
    that behavior."""
    import dataclasses

    def op(model):
        model.muscles = [dataclasses.replace(m, wraps=())
                         for m in model.muscles]
        return model

    return op


def ModOpRemoveMuscles():
    """Remove all muscles (reference ModOpRemoveMuscles,
    ModelOperators.h:301)."""

    def op(model):
        model.muscles = []
        model._muscle_params = []
        return model

    return op


def ModOpFiberDampingDGF(damping):
    """Set fiber damping on all DGF muscles (reference ModOpFiberDampingDGF,
    ModelOperators.h:236)."""

    def op(model):
        for mp in model._muscle_params:
            mp["fiber_damping"] = mp["fiber_damping"] * 0.0 + damping
        return model

    return op


def ModOpScaleActiveFiberForceCurveWidthDGF(scale):
    """Scale the active force-length curve width (reference
    ModOpScaleActiveFiberForceCurveWidthDGF, ModelOperators.h:246)."""

    def op(model):
        for mp in model._muscle_params:
            mp["active_force_width_scale"] = \
                mp["active_force_width_scale"] * scale
        return model

    return op


def ModOpPassiveFiberStrainAtOneNormForceDGF(strain):
    """Set passive fiber strain at one norm force (reference
    ModOpPassiveFiberStrainAtOneNormForceDGF, ModelOperators.h:256)."""

    def op(model):
        for mp in model._muscle_params:
            mp["passive_fiber_strain_at_one_norm_force"] = \
                mp["passive_fiber_strain_at_one_norm_force"] * 0.0 + strain
        return model

    return op


def ModOpAddExternalLoads(xml_path):
    """Apply measured external loads from an OpenSim ExternalLoads XML
    (reference ModOpAddExternalLoads, ModelOperators.h:326)."""

    def op(model):
        from .osim import parse_external_loads

        body_idx = {b.name: i for i, b in enumerate(model.mech.bodies)}
        for s in parse_external_loads(xml_path):
            model.add_external_force(s["name"], body_idx[s["body_name"]],
                                     s["force_fn"], s["point_fn"],
                                     s["torque_fn"])
        return model

    return op


def ModOpReplaceJointsWithWelds(joint_names):
    """Weld the named joints (reference ModOpReplaceJointsWithWelds,
    ModelOperators.h:318; ModelFactory::replaceJointWithWeldJoint).

    Welding changes the kinematic tree, so the model is re-parsed from its
    source .osim with the additional welds; apply this op before ops that
    mutate muscles/forces (the reference's tools use it first as well,
    e.g. testMocoInverse.cpp:123)."""

    def op(model):
        from .osim import parse_osim

        src = getattr(model, "_source", None)
        if src is None:
            raise ValueError(
                "ModOpReplaceJointsWithWelds requires a model parsed from "
                "an .osim file (kinematic-tree changes re-parse the source);"
                " pass weld_joints= to parse_osim for built models")
        new_model, _ = parse_osim(
            src["path"], gravity=src.get("gravity"),
            weld_joints=tuple(src.get("weld_joints", ())) +
            tuple(joint_names), weld_q=src.get("weld_q"))
        return new_model

    return op


class ModelProcessor:
    """model | op | op ... (reference ModelProcessor.h:47-159)."""

    def __init__(self, model):
        self.model = model
        self.ops: list[Callable] = []

    def __or__(self, op: Callable) -> "ModelProcessor":
        out = ModelProcessor(self.model)
        out.ops = self.ops + [op]
        return out

    def process(self):
        m = self.model
        for op in self.ops:
            m = op(m)
        return m
