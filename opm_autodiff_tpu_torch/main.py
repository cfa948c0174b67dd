"""CLI driver: ``python -m opm_autodiff_tpu_torch.main CASE.DATA``.

The port's twin of the reference package's CLI (the ``flow`` binary's
shape): parse the deck, run the schedule on the GPU (``--device cuda``,
the default) or the CPU (``--device cpu``), write the summary next to the
deck (CASE.csv / CASE.npz) and print the run report.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="opm_autodiff_tpu_torch",
        description="fully-implicit black-oil simulator (PyTorch/CUDA)")
    p.add_argument("deck", help="ECLIPSE .DATA input deck")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--output-dir", default=None,
                   help="directory for output files (default: deck's)")
    p.add_argument("--linear-solver", default="zline",
                   choices=["zline", "jacobi"],
                   help="preconditioner of the f32 BiCGStab")
    p.add_argument("--tolerance-cnv", type=float, default=1e-2)
    p.add_argument("--tolerance-mb", type=float, default=1e-6)
    p.add_argument("--newton-max-iterations", type=int, default=20)
    p.add_argument("--initial-time-step-in-days", type=float, default=1.0)
    p.add_argument("--solver-restart-factor", type=float, default=0.33)
    p.add_argument("--time-step-control", default="iterationcount",
                   choices=["pid", "iterationcount"])
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    import dataclasses

    from opm_autodiff_tpu_torch.device import resolve_device
    from opm_autodiff_tpu_torch.io.state import load_state
    from opm_autodiff_tpu_torch.simulator import Simulator, SimulatorOptions
    from opm_autodiff_tpu_torch.solvers.newton import NewtonParams
    from opm_autodiff_tpu_torch.solvers.timestepper import TimeStepParams

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    opts = SimulatorOptions(
        newton=dataclasses.replace(
            NewtonParams(), linear_precond=args.linear_solver,
            tol_cnv=args.tolerance_cnv, tol_mb=args.tolerance_mb,
            max_iter=args.newton_max_iterations),
        tstep=dataclasses.replace(
            TimeStepParams(),
            initial_dt_days=args.initial_time_step_in_days,
            restart_factor=args.solver_restart_factor,
            control=args.time_step_control),
        verbose=0 if args.quiet else 1)
    t0 = time.perf_counter()
    state = load_state(args.deck)
    sim = Simulator(state, opts, device=device)
    sim.run()
    wall = time.perf_counter() - t0
    base = os.path.splitext(os.path.basename(args.deck))[0]
    out_dir = args.output_dir or os.path.dirname(os.path.abspath(args.deck))
    os.makedirs(out_dir, exist_ok=True)
    sim.summary.to_csv(os.path.join(out_dir, base + ".csv"))
    sim.summary.to_npz(os.path.join(out_dir, base + ".npz"))
    if not args.quiet:
        print(f"{sim.report.summary_line()} total={wall:.2f}s "
              f"device={device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
