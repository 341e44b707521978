"""Observability: channelized logging, phase timers with spans and
counters inside their stages, and the eigensolver's operator count. The
port's copy of isle_tpu/obs.py's Logger, Timer and OpCounter (reference
include/logger.h:19-95, include/timer.h:17-122,
include/matUtils.h:270-308).

Logger channels: info, warning and error print unless quiet; timer
prints and goes to <run_dir>/timerLog.txt; diagnostic goes to
<run_dir>/diagnosticLog.txt. add_sink hands a channel's messages to a
callback as well (the handle API's log sinks).

Spans and counters log nothing: they stay in memory on their Timer, and
recent_timers() hands out the process's last Timers (the in-memory
export a benchmark or an embedding host process reads). While a
torch.profiler records, each span is also a record_function range named
SPAN_MARK + its name, on the trace's clock beside the kernels and copies
it launches.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Callable, Deque, Dict, List, Optional


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
    cpu) of every mark.

    Inside a stage, `span(name)` times a piece of the host's work: `spans`
    keeps (name, parent, start, end) on time.perf_counter, the parent the
    innermost open span, else the open stage (the label of the next
    `next()`; None until then). `count(name, n)` adds to `counters`.
    Spans time the host only: none waits for the device."""

    def __init__(self, logger: Optional[Logger] = None):
        self.logger = logger
        self.t0_wall = time.perf_counter()
        self.t0_cpu = time.process_time()
        self.start_wall = self.t0_wall
        self.phases: List[tuple] = []
        self.spans: List[tuple] = []
        self.counters: Dict[str, int] = {}
        self._open: List[str] = []  # the open spans' names, innermost last
        self._stage_spans = 0  # index of the open stage's first span
        _RECENT.append(self)

    def next(self, label: str) -> float:
        wall = time.perf_counter() - self.t0_wall
        cpu = time.process_time() - self.t0_cpu
        self.phases.append((label, wall, cpu))
        if self.logger:
            self.logger.log(
                "timer", f"Time for {label}: {cpu:.3f}s user, {wall:.3f}s wall")
        spans = self.spans
        for i in range(self._stage_spans, len(spans)):
            if spans[i][1] is None:  # a span of the stage just closed
                spans[i] = (spans[i][0], label) + spans[i][2:]
        self._stage_spans = len(spans)
        self.t0_wall = time.perf_counter()
        self.t0_cpu = time.process_time()
        return wall

    def span(self, name: str) -> "Span":
        return Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def span_seconds(self) -> Dict[str, float]:
        """Seconds per span name, each span whole."""
        out: Dict[str, float] = {}
        for name, _, start, end in self.spans:
            out[name] = out.get(name, 0.0) + (end - start)
        return out

    def self_seconds(self) -> Dict[str, float]:
        """Seconds per span name less the time of the spans directly
        inside it."""
        out = self.span_seconds()
        for i, (name, parent, start, end) in enumerate(self.spans):
            # a span is recorded at its end, so its parent comes after it:
            # the first later span of that name that holds it
            for pname, _, pstart, pend in self.spans[i + 1:]:
                if pname == parent and pstart <= start and end <= pend:
                    out[parent] -= end - start
                    break
        return out

    def diag(self, msg: str) -> None:
        if self.logger:
            self.logger.diag(msg)

    def report_total(self, label: str = "total") -> float:
        t = time.perf_counter() - self.start_wall
        if self.logger:
            self.logger.log("timer", f"Total time for {label}: {t:.3f}s wall")
        return t


SPAN_MARK = "isle: "  # the prefix of a span's range in a profiler trace

# the process's last Timers, oldest first (recent_timers)
_RECENT: Deque[Timer] = collections.deque(maxlen=256)
_profiler = None  # torch.autograd.profiler, bound at the first span


def recent_timers() -> List[Timer]:
    """The last 256 Timers made in this process, oldest first."""
    return list(_RECENT)


def _profiler_on() -> bool:
    """Whether a torch.profiler records: a flag of torch's Python side,
    read without a call into the dispatcher."""
    global _profiler
    if _profiler is None:
        import torch.autograd.profiler as _profiler
    return _profiler._is_profiler_enabled


class Span:
    """Timer.span's context manager; see Timer."""

    __slots__ = ("timer", "name", "parent", "start", "range")

    def __init__(self, timer: Timer, name: str):
        self.timer = timer
        self.name = name

    def __enter__(self) -> "Span":
        t = self.timer
        self.parent = t._open[-1] if t._open else None
        t._open.append(self.name)
        self.range = None
        if _profiler_on():
            import torch

            self.range = torch.profiler.record_function(
                SPAN_MARK + self.name)
            self.range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter()
        if self.range is not None:
            self.range.__exit__(*exc)
        t = self.timer
        t._open.pop()
        t.spans.append((self.name, self.parent, self.start, end))


_NO_SPAN = contextlib.nullcontext()


def span(timer, name: str):
    """timer.span(name) for a Timer, else a context that does nothing: for
    functions whose `timer` may be None, or any object that only takes
    diagnostic lines."""
    return Span(timer, name) if isinstance(timer, Timer) else _NO_SPAN


def count(timer, name: str, n: int = 1) -> None:
    """timer.count(name, n) for a Timer, else nothing (see span)."""
    if isinstance(timer, Timer):
        timer.count(name, n)


STAGE_MARK = "isle stage end: "  # the name of a trace's stage markers


@contextlib.contextmanager
def profiler_trace(profile_dir: str, logger: Logger, on_card: bool,
                   name: str = "train"):
    """GpuConfig.profile_dir: run the body inside a torch.profiler trace
    (CPU activities and, on the card, CUDA ones) and write its Chrome
    trace to <profile_dir>/<name>_<pid>_<time>.json, as isle_tpu's trainer
    wraps its pipeline in a jax.profiler trace (isle_tpu/trainer.py:
    286-298). Where the profiler cannot start, a warning is logged and the
    body runs untraced. With an empty profile_dir nothing of the profiler
    is imported. Yields the trace's path, or None when untraced."""
    if not profile_dir:
        yield None
        return
    try:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(profile_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if on_card:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # whatever the profiler's back end raises
        logger.warning(f"torch profiler unavailable: {e}")
        yield None
        return
    path = os.path.join(
        profile_dir,
        f"{name}_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json")
    try:
        yield path
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)
        logger.info(f"profiler trace written to {path}")


def mark_stage_in_trace(label: str) -> None:
    """A zero-length annotation at a stage's end, so that a reader of the
    trace can cut it into the trainer's stages."""
    import torch

    with torch.profiler.record_function(STAGE_MARK + label):
        pass


class OpCounter:
    """The eigensolver's operator applies: a call count."""

    def __init__(self, name: str = "spmm"):
        self.name = name
        self.calls = 0

    def add(self, calls: int = 1) -> None:
        self.calls += calls

    def summary(self) -> str:
        return f"{self.name}: {self.calls} calls"
