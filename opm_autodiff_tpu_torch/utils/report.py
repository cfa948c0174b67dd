"""Performance/iteration accounting (reference: SimulatorReport,
opm/simulators/timestepping/SimulatorReport.hpp:30 — assemble/solve/update
wall times, Newton + linear iteration counts, per step and total;
SURVEY.md §5 tracing)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StepReport:
    wall_time: float = 0.0
    newton_iterations: int = 0
    linear_iterations: int = 0
    substeps: int = 0


@dataclasses.dataclass
class SimulatorReport:
    steps: list = dataclasses.field(default_factory=list)

    def add_step(self, **kw):
        self.steps.append(StepReport(**kw))

    @property
    def total_newton_iterations(self) -> int:
        return sum(s.newton_iterations for s in self.steps)

    @property
    def total_linear_iterations(self) -> int:
        return sum(s.linear_iterations for s in self.steps)

    @property
    def total_wall_time(self) -> float:
        return sum(s.wall_time for s in self.steps)

    @property
    def total_substeps(self) -> int:
        return sum(s.substeps for s in self.steps)

    def summary_line(self) -> str:
        return (f"steps={len(self.steps)} substeps={self.total_substeps} "
                f"newton={self.total_newton_iterations} "
                f"linear={self.total_linear_iterations} "
                f"wall={self.total_wall_time:.2f}s")
