"""The device trace of the measured window: a torch.profiler session, its
events moved onto the host's perf_counter clock, and the busy time as the
union of the device's intervals (kernels, copies and sets on any stream
counted once where they overlap).
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

MARK = "benchkit.window_open"


def union(intervals: List[Tuple[float, float]], a: float, b: float):
    """(seconds covered, merged intervals) of ``intervals`` clipped to
    [a, b].  Overlapping intervals, as of several streams, count once."""
    clipped = sorted((max(s, a), min(e, b)) for s, e in intervals
                     if e > a and s < b)
    merged: List[List[float]] = []
    for s, e in clipped:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [tuple(m) for m in merged]


def gaps(merged: List[Tuple[float, float]], a: float, b: float):
    """The idle intervals of [a, b] between merged busy intervals."""
    out, t = [], a
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if b > t:
        out.append((t, b))
    return out


@dataclass
class DeviceEvents:
    events: List[Tuple[str, float, float]] = field(default_factory=list)

    def kernels(self, name: str) -> List[float]:
        """Durations (s) of the kernels whose name holds ``name``."""
        return [e - s for n, s, e in self.events if name in n]

    def by_name(self, a: float, b: float) -> List[Tuple[str, float]]:
        tot: Dict[str, float] = defaultdict(float)
        for n, s, e in self.events:
            if e > a and s < b:
                tot[n] += min(e, b) - max(s, a)
        return sorted(tot.items(), key=lambda kv: -kv[1])


class Session:
    """torch.profiler over the window.  ``start()`` at the window's
    opening, ``stop()`` once the run has returned."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.t_mark = None

    def start(self) -> None:
        self.prof.start()
        with self.torch.profiler.record_function(MARK):
            self.t_mark = time.perf_counter()

    def stop(self) -> DeviceEvents:
        torch = self.torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        evs = self.prof.events()
        mark = [e for e in evs if e.name == MARK]
        if not mark:
            raise RuntimeError("the profiler lost the window's marker")
        # profiler microseconds -> perf_counter seconds
        off = self.t_mark - mark[0].time_range.start / 1e6
        out = DeviceEvents()
        for e in evs:
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out.events.append((e.name, e.time_range.start / 1e6 + off,
                                   e.time_range.end / 1e6 + off))
        return out
