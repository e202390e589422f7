"""Solver status codes.

The same integer codes as ``simplex_tpu.status`` so that the two packages'
results compare field by field. ``RUNNING`` is carried in the solver state
while the pivot loop runs; every other code is terminal.
"""

from __future__ import annotations

import enum


class SolveStatus(enum.IntEnum):
    """Integer status codes carried in the solver state."""

    RUNNING = 0
    OPTIMAL = 1
    UNBOUNDED = 2
    MAX_ITER = 3
    SINGULAR = 4  # pivot element too small or a non-finite pricing value
    INFEASIBLE = 5  # the general-form route: phase 1 or presolve found no point

    def describe(self) -> str:
        return {
            SolveStatus.RUNNING: "Still running.",
            SolveStatus.OPTIMAL: "Optimum found.",
            SolveStatus.UNBOUNDED: "Problem unbounded.",
            SolveStatus.MAX_ITER: "MAX_ITER exceeded.",
            SolveStatus.SINGULAR: "Pivot element too small (theta overflow).",
            SolveStatus.INFEASIBLE: "Problem infeasible.",
        }[self]
