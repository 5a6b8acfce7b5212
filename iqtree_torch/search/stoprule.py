"""Search stop conditions: unsuccessful-iteration count (the default,
100 iterations, and never before `min_iterations`: -nstep under -bb), a
fixed iteration count (-n) and a wall-clock limit (-maxtime)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class StopRule:
    unsuccess_iteration: int = 100
    min_iterations: int = 0
    max_seconds: Optional[float] = None
    fixed_iterations: Optional[int] = None

    cur_iteration: int = 0
    last_improved_iteration: int = 0
    improved_iterations: List[int] = field(default_factory=list)  # newest first
    start_time: float = field(default_factory=time.time)

    def iteration_done(self, improved: bool) -> None:
        self.cur_iteration += 1
        if improved:
            self.last_improved_iteration = self.cur_iteration
            self.improved_iterations.insert(0, self.cur_iteration)

    def should_stop(self) -> bool:
        if (self.max_seconds is not None
                and time.time() - self.start_time >= self.max_seconds):
            return True
        if self.fixed_iterations is not None:
            return self.cur_iteration >= self.fixed_iterations
        if self.cur_iteration < self.min_iterations:
            return False
        return (self.cur_iteration - self.last_improved_iteration
                >= self.unsuccess_iteration)
