"""Adaptive sub-stepping with failure-driven chopping.

Rebuild of AdaptiveTimeSteppingEbos (reference:
opm/simulators/timestepping/AdaptiveTimeSteppingEbos.hpp:357 ``step``):
run the Newton solver on a trial dt; on failure chop dt by
``restart_factor`` (default 0.33, :522) up to ``max_restarts``; on success
grow dt with the configured policy (reference TimeStepControl.hpp:35-133):

  * "iterationcount" — SimpleIterationCountTimeStepControl: scale by
    target/actual Newton iterations;
  * "pid" (default, like the reference's PID+IterationCount) — classic
    PID on the relative solution change e_n with gains kP/kI/kD, capped
    by the iteration-count factor.

Failures are status codes from the Newton layer, not exceptions.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TimeStepParams:
    # reference AdaptiveTimeSteppingEbos defaults
    initial_fraction: float = 1.0   # first substep = fraction of report step
    restart_factor: float = 0.33
    growth_factor: float = 3.0      # max growth per step
    max_restarts: int = 10
    target_iterations: int = 8      # SimpleIterationCountTimeStepControl
    min_dt_days: float = 1e-3
    max_dt_days: float = 365.0
    initial_dt_days: float = 1.0
    # below this chopped dt, shut consistently-failing wells instead of
    # chopping further (reference: MinTimeStepBeforeShuttingProblematic-
    # WellsInDays = 0.01, AdaptiveTimeSteppingEbos.hpp:209,:549-586)
    shut_wells_dt_days: float = 0.01
    control: str = "iterationcount"  # "iterationcount" | "pid"
    # PIDTimeStepControl defaults (reference TimeStepControl.cpp)
    pid_tolerance: float = 3e-2
    pid_kp: float = 0.075
    pid_ki: float = 0.175
    pid_kd: float = 0.01


@dataclasses.dataclass
class SubStepReport:
    time_days: float
    dt_days: float
    newton_iterations: int
    linear_iterations: int
    restarts: int


class _PidState:
    def __init__(self):
        self.errors = [None, None, None]  # e_{n-2}, e_{n-1}, e_n

    def push(self, e: float):
        self.errors = [self.errors[1], self.errors[2], max(e, 1e-12)]

    def factor(self, p: TimeStepParams) -> float:
        e2, e1, e0 = self.errors
        if e0 is None:
            return p.growth_factor
        f = (p.pid_tolerance / e0) ** p.pid_ki
        if e1 is not None:
            f *= (e1 / e0) ** p.pid_kp
            if e2 is not None:
                f *= ((e1 * e1) / (e0 * e2)) ** p.pid_kd
        return f


def run_report_step(step_days: float, suggested_dt_days: float, solve_fn,
                    params: TimeStepParams, pid_state: _PidState | None = None,
                    shut_problem_wells=None):
    """Advance one report step of length ``step_days``.

    ``solve_fn(dt_seconds)`` runs a Newton solve from the current committed
    state and returns (converged, iterations, linear_iterations, commit)
    where ``commit()`` advances the committed state and returns the
    relative solution change of the accepted substep (for PID control).

    ``shut_problem_wells()`` (optional) force-shuts consistently-failing
    wells and returns True if any were shut; it is tried when the chopped
    dt would fall below ``shut_wells_dt_days`` — on success the substep
    retries at the SAME dt instead of chopping (reference:
    AdaptiveTimeSteppingEbos.hpp:549-586).
    Returns (reports, next_dt).
    """
    if step_days <= 0.0:  # zero-length trailing schedule-state step
        return [], suggested_dt_days
    t = 0.0
    dt = min(suggested_dt_days, step_days, params.max_dt_days)
    reports = []
    pid = pid_state or _PidState()
    while t < step_days - 1e-9:
        dt = min(dt, step_days - t)
        restarts = 0
        while True:
            ok, iters, lin_iters, commit = solve_fn(dt * 86400.0)
            if ok:
                rel_change = commit() or 1e-12
                reports.append(SubStepReport(t + dt, dt, iters, lin_iters,
                                             restarts))
                t += dt
                iter_factor = params.target_iterations / max(iters, 1)
                if params.control == "pid":
                    pid.push(rel_change)
                    factor = min(pid.factor(params), iter_factor)
                else:
                    factor = iter_factor
                factor = min(max(factor, params.restart_factor),
                             params.growth_factor)
                dt = min(dt * factor, params.max_dt_days)
                break
            restarts += 1
            new_dt = dt * params.restart_factor
            if (new_dt <= params.shut_wells_dt_days
                    and shut_problem_wells is not None
                    and shut_problem_wells()):
                # retry the same dt with the problematic wells shut
                continue
            if restarts > params.max_restarts or dt <= params.min_dt_days:
                raise RuntimeError(
                    f"substep failed after {restarts} restarts at "
                    f"t={t:.2f}d dt={dt:.4f}d")
            dt = new_dt
    return reports, dt
