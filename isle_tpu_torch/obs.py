"""Observability: channelized logging, phase timers and SpMM FLOP
accounting. The port's copy of isle_tpu/obs.py's Logger, Timer and
OpCounter (reference include/logger.h:19-95, include/timer.h:17-122,
include/matUtils.h:270-308).

Logger channels: info, warning and error print unless quiet; timer
prints and goes to <run_dir>/timerLog.txt; diagnostic goes to
<run_dir>/diagnosticLog.txt. add_sink hands a channel's messages to a
callback as well (the handle API's log sinks).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional


class Logger:
    CHANNELS = ("info", "warning", "error", "timer", "diagnostic")

    def __init__(self, run_dir: Optional[str] = None, quiet: bool = False):
        self.quiet = quiet
        self.sinks: Dict[str, List[Callable[[str], None]]] = {
            c: [] for c in self.CHANNELS
        }
        self._files = {}
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._files["timer"] = open(
                os.path.join(run_dir, "timerLog.txt"), "a")
            self._files["diagnostic"] = open(
                os.path.join(run_dir, "diagnosticLog.txt"), "a")

    def add_sink(self, channel: str, fn: Callable[[str], None]) -> None:
        self.sinks[channel].append(fn)

    def log(self, channel: str, msg: str) -> None:
        line = msg if msg.endswith("\n") else msg + "\n"
        if not self.quiet and channel in ("info", "warning", "error",
                                          "timer"):
            print(line, end="", flush=True)
        f = self._files.get(channel)
        if f:
            f.write(line)
            f.flush()
        for fn in self.sinks[channel]:
            fn(msg)

    def info(self, msg: str) -> None:
        self.log("info", msg)

    def warning(self, msg: str) -> None:
        self.log("warning", "WARNING: " + msg)

    def diag(self, msg: str) -> None:
        self.log("diagnostic", msg)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()


class Timer:
    """Phase timer: `next("label")` reports the wall and CPU time since the
    previous mark and restarts the clock; `phases` keeps (label, wall,
    cpu) of every mark."""

    def __init__(self, logger: Optional[Logger] = None):
        self.logger = logger
        self.t0_wall = time.perf_counter()
        self.t0_cpu = time.process_time()
        self.start_wall = self.t0_wall
        self.phases: List[tuple] = []

    def next(self, label: str) -> float:
        wall = time.perf_counter() - self.t0_wall
        cpu = time.process_time() - self.t0_cpu
        self.phases.append((label, wall, cpu))
        if self.logger:
            self.logger.log(
                "timer", f"Time for {label}: {cpu:.3f}s user, {wall:.3f}s wall")
        self.t0_wall = time.perf_counter()
        self.t0_cpu = time.process_time()
        return wall

    def diag(self, msg: str) -> None:
        if self.logger:
            self.logger.diag(msg)

    def report_total(self, label: str = "total") -> float:
        t = time.perf_counter() - self.start_wall
        if self.logger:
            self.logger.log("timer", f"Total time for {label}: {t:.3f}s wall")
        return t


class OpCounter:
    """SpMM operator profiling: call count, seconds, FLOPs -> GFLOP/s."""

    def __init__(self, name: str = "spmm"):
        self.name = name
        self.calls = 0
        self.seconds = 0.0
        self.flops = 0

    def add(self, seconds: float, flops: int, calls: int = 1) -> None:
        self.calls += calls
        self.seconds += seconds
        self.flops += flops

    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9 if self.seconds > 0 else 0.0

    def summary(self) -> str:
        return (
            f"{self.name}: {self.calls} calls, {self.seconds:.3f}s, "
            f"{self.flops / 1e9:.2f} GFLOP, {self.gflops():.1f} GFLOP/s"
        )
