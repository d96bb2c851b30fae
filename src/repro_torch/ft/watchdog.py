"""Fault-tolerance runtime pieces that do not need real hardware (the
port's own copy of the reference package's watchdog module, stdlib
only):

  StragglerWatchdog — per-step timing stats; flags slow steps (the
      escalation ladder times each attempt with it).
  HeartbeatMonitor — host liveness state machine: nodes miss
      heartbeats -> suspected -> dead -> restore-from-checkpoint
      callback fires exactly once per incident.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than `threshold` x rolling median."""
    threshold: float = 2.0
    window: int = 50
    min_samples: int = 5
    _durations: List[float] = dataclasses.field(default_factory=list)
    slow_steps: List[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, duration_s: float) -> bool:
        """Returns True if this step is a straggler."""
        hist = self._durations[-self.window:]
        self._durations.append(duration_s)
        if len(hist) < self.min_samples:
            return False
        med = statistics.median(hist)
        if duration_s > self.threshold * med:
            self.slow_steps.append(step)
            return True
        return False

    @property
    def median(self) -> Optional[float]:
        if not self._durations:
            return None
        return statistics.median(self._durations[-self.window:])


@dataclasses.dataclass
class HeartbeatMonitor:
    """Host liveness: miss `suspect_after` beats -> suspected; miss
    `dead_after` -> dead, fire on_failure(host) once."""
    hosts: List[str]
    interval_s: float = 10.0
    suspect_after: int = 2
    dead_after: int = 5
    on_failure: Optional[Callable[[str], None]] = None
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self._last: Dict[str, float] = {h: now for h in self.hosts}
        self._dead: Dict[str, bool] = {h: False for h in self.hosts}

    def beat(self, host: str):
        if host not in self._dead:
            # elastic join: an unknown host starts beating mid-run;
            # register it instead of KeyError-ing in status()/poll()
            self.hosts.append(host)
            self._dead[host] = False
        self._last[host] = self.clock()
        if self._dead.get(host):
            # host came back: rejoin as fresh (elastic re-add)
            self._dead[host] = False

    def status(self, host: str) -> str:
        missed = (self.clock() - self._last[host]) / self.interval_s
        if self._dead[host]:
            return "dead"
        if missed >= self.dead_after:
            return "dead"
        if missed >= self.suspect_after:
            return "suspected"
        return "alive"

    def poll(self) -> List[str]:
        """Advance the state machine; returns newly-dead hosts."""
        newly_dead = []
        for h in self.hosts:
            if not self._dead[h] and self.status(h) == "dead":
                self._dead[h] = True
                newly_dead.append(h)
                if self.on_failure is not None:
                    self.on_failure(h)
        return newly_dead

    @property
    def alive_hosts(self) -> List[str]:
        return [h for h in self.hosts if not self._dead[h]]
