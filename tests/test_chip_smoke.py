"""The GPU entry points and what they rest on, checked on the CPU.

chip_smoke.py and bench.py refuse a host without a GPU; every jitted entry
of the solve path traces its matmuls at full precision; the scaling pass
runs on the default device; the compilation cache lands at a fixed path;
and chip_smoke's phases and comparisons work at a tiny size. One test,
marked ``gpu``, runs phase (a) on a card and skips without one.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opensim_moco_tpu import config
from opensim_moco_tpu.examples import kirk_min_effort_study
from opensim_moco_tpu.solver import ipm
from opensim_moco_tpu.solver.kkt import CompiledStructure
from opensim_moco_tpu.solver.nlp import NLP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _dot_precisions(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn.params["precision"]
        for v in eqn.params.values():
            yield from _sub_precisions(v)


def _sub_precisions(v):
    if hasattr(v, "eqns"):
        yield from _dot_precisions(v)
    elif hasattr(getattr(v, "jaxpr", None), "eqns"):
        yield from _dot_precisions(v.jaxpr)
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _sub_precisions(x)


def _kirk(mesh=5):
    tr = kirk_min_effort_study(mesh).transcription()
    nlp = tr.make_nlp()
    z0 = tr.initial_guess(dtype=np.float32)
    return tr, nlp, z0


def _compiled_structure(nlp):
    s = nlp.structure
    return CompiledStructure(s.var_blocks, s.con_blocks, s.border_vars,
                             s.border_cons, nlp.n, nlp.m)


def _scaling_pass_jaxprs(monkeypatch, nlp, cs, z0):
    """The jaxprs of everything gradient_scaling jits, as it traces them."""
    jaxprs = []
    real_jit = jax.jit

    def recording_jit(fn, *a, **k):
        jitted = real_jit(fn, *a, **k)

        def call(*args):
            jaxprs.append(jax.make_jaxpr(fn)(*args))
            return jitted(*args)

        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    ipm.gradient_scaling(nlp, cs, z0)
    monkeypatch.undo()
    return [j.jaxpr for j in jaxprs]


@pytest.mark.parametrize("entry", ["make_solver", "run_chunk", "init",
                                   "finalize", "scaling_pass"])
def test_solve_entries_trace_dots_at_highest_precision(entry, monkeypatch):
    """A GPU runs float32 dots in TF32 unless asked for more: every jitted
    entry of the solve path must trace each dot_general at HIGHEST."""
    _, nlp, z0 = _kirk()
    # a quadratic term puts a dot into the objective, which finalize
    # evaluates (the Hessian stays block-diagonal)
    base = nlp.objective
    nlp = dataclasses.replace(nlp, objective=lambda z: base(z) + 1e-3 * z @ z)
    opts = ipm.IPMOptions(max_iter=3)
    z = jnp.asarray(z0)
    if entry == "make_solver":
        jaxprs = [jax.make_jaxpr(ipm.make_solver(nlp, opts,
                                                 scale_z0=z0))(z).jaxpr]
    elif entry == "scaling_pass":
        jaxprs = _scaling_pass_jaxprs(monkeypatch, nlp,
                                      _compiled_structure(nlp), z0)
    else:
        init, run_chunk, finalize = ipm.make_chunked_solver(nlp, opts,
                                                            scale_z0=z0)
        carry = jax.eval_shape(init, z)
        fn, args = {"init": (init, (z,)),
                    "run_chunk": (run_chunk, (carry, 2)),
                    "finalize": (finalize, (carry,))}[entry]
        jaxprs = [jax.make_jaxpr(fn)(*args).jaxpr]
    precisions = [p for j in jaxprs for p in _dot_precisions(j)]
    assert precisions, "no dot_general traced"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), set(precisions)


def _dense_scaling(nlp, z0):
    g = np.asarray(jax.grad(nlp.objective)(jnp.asarray(z0)))
    J = np.asarray(jax.jacfwd(nlp.constraints)(jnp.asarray(z0)))
    f_scale = min(1.0, 100.0 / max(np.max(np.abs(g)), 1e-8))
    c_scale = np.minimum(1.0, 100.0 / np.maximum(np.max(np.abs(J), axis=1),
                                                 1e-8))
    return f_scale, c_scale


@pytest.mark.parametrize("structured", [True, False])
def test_scaling_pass_asks_for_no_cpu_device(structured, monkeypatch):
    """make_solver(scale_z0=...) runs its scaling pass on the default
    device: with jax.devices("cpu") failing, as on a host restricted to
    its GPU, it still builds and solves, and the factors match a dense
    evaluation."""
    _, nlp, z0 = _kirk()
    if not structured:
        nlp = NLP(n=nlp.n, m=nlp.m, objective=nlp.objective,
                  constraints=nlp.constraints, lb=nlp.lb, ub=nlp.ub)
    real_devices = jax.devices

    def devices(backend=None):
        if backend == "cpu":
            raise RuntimeError("Unknown backend cpu")
        return real_devices(backend)

    monkeypatch.setattr(jax, "devices", devices)
    cs = _compiled_structure(nlp) if structured else None
    f_scale, c_scale = ipm.gradient_scaling(nlp, cs, z0)
    f_ref, c_ref = _dense_scaling(nlp, z0)
    np.testing.assert_allclose(f_scale, f_ref, rtol=1e-6)
    np.testing.assert_allclose(c_scale, c_ref, rtol=1e-6)
    res = jax.jit(ipm.make_solver(nlp, ipm.IPMOptions(tol=1e-6),
                                  scale_z0=z0))(jnp.asarray(z0))
    assert bool(res.converged)


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_dir(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = config.use_compilation_cache()
        if env_set:
            assert path == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert path == os.path.join(ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_guard_rejects_cpu():
    with pytest.raises(SystemExit, match="no GPU found"):
        config.check_gpu(jax.devices())


def _has_gpu():
    if shutil.which("nvidia-smi") is None:
        return False
    return subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                          timeout=60).returncode == 0


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_fail_without_gpu(script):
    """On a host without a card the script exits non-zero at start-up and
    prints no result."""
    if _has_gpu():
        pytest.skip("a GPU is present: the script would run in full")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert '"ok"' not in proc.stdout and '"metric"' not in proc.stdout


def test_bench_lane_failure_exits(monkeypatch):
    """A lane that raises ends bench.main: no result is printed."""
    monkeypatch.setattr(config, "require_gpu", lambda: jax.devices())
    monkeypatch.setattr(config, "use_compilation_cache", lambda: "")

    def broken(full_dynamics):
        raise FloatingPointError("lane failed")

    monkeypatch.setattr(bench, "lane_hanging", broken)
    with pytest.raises(FloatingPointError):
        bench.main()


TINY_MESH, TINY_BATCH = 5, 2


@pytest.fixture(scope="module")
def tiny():
    tr = bench.hanging_transcription(full_dynamics=True, mesh=TINY_MESH)
    return tr, chip_smoke.f64_optimum(tr)


def test_phase_main_tiny_float32(tiny):
    """Phase (a) as the smoke runs it (float32, x64 off, the float64 side
    in the CPU child), at B=2 and mesh 5: every converged lane holds up
    in float64."""
    _, opt = tiny
    code = ("import json, chip_smoke as s; r = s.phase_main(mesh=%d, "
            "batch=%d); print(json.dumps({k: (v.tolist() if hasattr("
            "v, 'tolist') else v) for k, v in r.items()}))"
            % (TINY_MESH, TINY_BATCH))
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="0")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (out["batch"], out["mesh"]) == (TINY_BATCH, TINY_MESH)
    for key in ("scaling_pass_s", "compile_s", "warm_wall_s_per_batch",
                "iterations_mean", "iterations_max", "strict"):
        assert np.isfinite(out[key]), key
    # the child's optimum is the in-process float64 solve
    assert abs(out["ref_tf"] - opt["tf"]) < 1e-9
    conv = np.asarray(out["lane_converged"])
    assert conv.shape == (TINY_BATCH,) and conv.any()
    excess = np.subtract(out["lane_f64_violation"], out["lane_kkt"])[conv]
    assert np.all(excess <= chip_smoke.VIOLATION_SLACK), excess
    obj_err = np.asarray(out["lane_objective_rel_err"])[conv]
    assert np.all(obj_err <= chip_smoke.OBJECTIVE_RTOL), obj_err


def _passing_main_result():
    conv = np.array([True] * chip_smoke.MIN_STRICT + [False])
    B = conv.size
    kkt = np.full(B, 1e-3)
    return {"converged": chip_smoke.MIN_CONVERGED,
            "strict": chip_smoke.MIN_STRICT, "lane_converged": conv,
            "lane_kkt": kkt, "lane_f64_violation": kkt.copy(),
            "lane_objective_rel_err": np.zeros(B),
            "median_dtf_converged": chip_smoke.TF_MEDIAN_TOL}


@pytest.mark.parametrize("broken", [
    None, "converged", "strict", "lane_f64_violation",
    "lane_objective_rel_err", "median_dtf_converged"])
def test_check_main_reports_each_failed_limit(broken):
    out = _passing_main_result()
    if broken in ("converged", "strict"):
        out[broken] -= 1
    elif broken == "median_dtf_converged":
        out[broken] *= 1.01
    elif broken == "lane_f64_violation":
        out[broken][0] += 2 * chip_smoke.VIOLATION_SLACK
    elif broken == "lane_objective_rel_err":
        out[broken][0] = 2 * chip_smoke.OBJECTIVE_RTOL
    failed = chip_smoke.check_main(out)
    assert len(failed) == (broken is not None), failed
    # a lane that did not converge is not held to the float64 checks
    out = _passing_main_result()
    out["lane_f64_violation"][-1] = 1.0
    out["lane_objective_rel_err"][-1] = 1.0
    assert chip_smoke.check_main(out) == []


def test_lane_check_flags_a_perturbed_result(tiny):
    """The float64 lane check finds the optimum feasible and a copy with
    one state shifted infeasible; it reports the objective as is."""
    tr, opt = tiny
    z = np.asarray(opt["z"])
    bad = z.copy()
    o = tr.offsets
    bad[o["states"][0] + tr.ny * (tr.G // 2)] += 0.1  # mid-grid height
    chk = chip_smoke.f64_lane_check(tr, np.stack([z, bad]))
    assert chk["violation"][0] <= opt["kkt"] * (1 + 1e-6)
    assert chk["violation"][1] > 10 * opt["kkt"]
    nlp = tr.make_nlp()
    np.testing.assert_allclose(chk["objective"][0],
                               float(nlp.objective(jnp.asarray(z))),
                               rtol=1e-12)


def test_phase_study():
    out = chip_smoke.phase_study()
    assert out["failed"] == []
    assert abs(out["sliding_mass"]["final_time"] - 0.4) < 2e-3
    assert "compile" in out["double_pendulum"]


def test_phase_four_on_virtual_devices():
    out = chip_smoke.phase_four(jax.devices(), sliding_mesh=8,
                                lanes_per_device=2, kirk_mesh=12)
    assert out["failed"] == []
    assert out["batch_axis"]["devices"] == len(jax.devices())


@pytest.mark.gpu
def test_phase_main_on_gpu():
    """Phase (a) at full size on the card, in a process of its own (this
    one is held to the CPU)."""
    if not _has_gpu():
        pytest.skip("needs an NVIDIA GPU")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    code = ("import json, chip_smoke as s; from opensim_moco_tpu.config "
            "import require_gpu; require_gpu(); "
            "print(json.dumps(s.check_main(s.phase_main())))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
