"""Command-line interface.

Analogue of the reference executable (reference
Moco/Executable/opensim-moco.cpp:38-90: `run`, `print-xml`, `visualize`).
Study configurations are JSON documents (the .omoco XML role).

Usage:
    python -m opensim_moco_tpu run <study.json>
    python -m opensim_moco_tpu print-config <example-name>
    python -m opensim_moco_tpu run-example <example-name> [--out solution.sto]
    python -m opensim_moco_tpu report <solution.sto> [--out report.pdf]
"""

from __future__ import annotations

import argparse
import json
import sys


EXAMPLES = ("sliding_mass", "kirk_min_effort", "double_pendulum_swingup",
            "hanging_muscle", "gait2d_tracking", "gait_inverse")


def _get_example(name, **kwargs):
    from . import examples as ex
    fn = getattr(ex, f"{name}_study")
    out = fn(**kwargs)
    return out if isinstance(out, tuple) else (out, None)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m opensim_moco_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run-example",
                          help="solve a built-in example study")
    runp.add_argument("name", choices=EXAMPLES)
    runp.add_argument("--out", default=None, help="solution .sto path")
    runp.add_argument("--mesh-intervals", type=int, default=None)

    cfg = sub.add_parser("print-config",
                         help="print an example's solver configuration")
    cfg.add_argument("name", choices=EXAMPLES)

    runj = sub.add_parser("run", help="solve a JSON study document "
                          "(the .omoco analogue)")
    runj.add_argument("config", help="path to study .json")
    runj.add_argument("--out", default=None, help="solution .sto path")

    rep = sub.add_parser("report", help="multi-page PDF trajectory report "
                         "(the reference report.py utility)")
    rep.add_argument("sto", nargs="+", help="solution/trajectory .sto files")
    rep.add_argument("--out", default="report.pdf")
    rep.add_argument("--reference", default=None,
                     help="reference .sto overlaid behind the solutions")
    rep.add_argument("--title", default=None)

    vis = sub.add_parser("visualize", help="stick-figure animation of a "
                         "solution (MocoUtilities visualize analogue, "
                         "headless)")
    vis.add_argument("config", help="study .json the solution came from "
                     "(provides the model)")
    vis.add_argument("sto", help="solution .sto")
    vis.add_argument("--out", default="visualize.gif",
                     help=".gif for animation, .png for a filmstrip")

    args = ap.parse_args(argv)

    if args.cmd == "visualize":
        from .utils.studyconfig import load_study
        from .utils.tables import sto_to_trajectory
        from .utils.visualize import visualize
        tool, _ = load_study(args.config)
        traj = sto_to_trajectory(args.sto)
        visualize(tool.model, traj, args.out)
        print(f"wrote {args.out}")
        return 0

    if args.cmd == "report":
        from .utils.report import generate_report
        from .utils.tables import read_sto, sto_to_trajectory
        trajs = [sto_to_trajectory(p) for p in args.sto]
        ref = read_sto(args.reference) if args.reference else None
        generate_report(trajs, args.out, labels=list(args.sto),
                        reference=ref, title=args.title)
        print(f"wrote {args.out}")
        return 0

    if args.cmd == "run":
        from .utils.studyconfig import load_study
        tool, cfg = load_study(args.config)
        sol = tool.solve()
        print(f"success={sol.success} objective={sol.objective:.6f} "
              f"iterations={sol.num_iterations} "
              f"duration={sol.solver_duration:.2f}s")
        if args.out:
            from .utils.tables import trajectory_to_sto
            trajectory_to_sto(sol.unseal(), args.out)
            print(f"wrote {args.out}")
        return 0 if sol.success else 1

    if args.cmd == "print-config":
        study, _ = _get_example(args.name)
        import dataclasses
        print(json.dumps({
            "solver_options": dataclasses.asdict(study.solver_options),
            "ipm_options": dataclasses.asdict(study.ipm_options),
        }, indent=2, default=str))
        return 0

    if args.cmd == "run-example":
        kwargs = {}
        if args.mesh_intervals:
            kwargs["num_mesh_intervals"] = args.mesh_intervals
        study, guess = _get_example(args.name, **kwargs)
        sol = study.solve(guess=guess)
        print(f"success={sol.success} objective={sol.objective:.6f} "
              f"iterations={sol.num_iterations} "
              f"duration={sol.solver_duration:.2f}s")
        if args.out:
            from .utils.tables import trajectory_to_sto
            trajectory_to_sto(sol.unseal(), args.out)
            print(f"wrote {args.out}")
        return 0 if sol.success else 1


if __name__ == "__main__":
    sys.exit(main())
