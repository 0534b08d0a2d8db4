"""Reduction of a torch.profiler trace of a stretch of the window: device
time by operation name, the union of device-busy intervals, the longest
idle gaps labelled with what the host was doing, and the device time that
each named host range (an autograd Function's forward or backward node, or
one of the harness's own ranges) launched."""

from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

# The harness's host range around each window step (a record_function).
STEP = "perfbench.step"


class TraceSummary:
    """What the readers need from one profiled stretch. Times in seconds."""

    def __init__(self, busy_s: float, window_s: float, device_ops: List[Tuple[str, float]],
                 idle_gaps: List[Tuple[str, float]], range_device_s: Dict[str, float],
                 steps: int):
        self.busy_s, self.window_s = busy_s, window_s
        self.device_ops = device_ops  # every device op name, by time, descending
        self.idle_gaps = idle_gaps
        self.range_device_s = range_device_s
        self.steps = steps

    @property
    def idle_share(self) -> Optional[float]:
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 1.0 - self.busy_s / self.window_s


def _is_device(event) -> bool:
    """A device operation (kernel, copy, set): a host range's mirror on the
    device timeline (a user annotation) is none."""
    from torch.autograd import DeviceType
    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False)
            and not event.name.startswith("perfbench."))


def summarize(prof, steps: int, top: int = 10) -> TraceSummary:
    """The stretch runs from the first host event (the profiler starts with
    the device synchronized, at a step's start) to the last event's end."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    device = [e for e in events if _is_device(e)]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    if not events:
        return TraceSummary(0.0, 0.0, [], [], {}, steps)
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)

    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, gaps, last = 0.0, [], start
    for a, b in spans:
        if a > last:
            gaps.append((last, a))
        busy += max(0.0, b - max(a, last))
        last = max(last, b)
    if end > last:
        gaps.append((last, end))

    by_name: Dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    device_ops = sorted(((k, v / 1e6) for k, v in by_name.items()), key=lambda kv: -kv[1])

    host_sorted = sorted(host, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host_sorted]
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        labelled.append((_host_label(host_sorted, starts, (a + b) / 2), (b - a) / 1e6))

    ranges: Dict[str, float] = {}
    for e in host:
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = getattr(e, "cuda_time_total", 0.0)
        if total:
            ranges[e.name] = ranges.get(e.name, 0.0) + total / 1e6
    return TraceSummary(busy / 1e6, (end - start) / 1e6, device_ops, labelled, ranges, steps)


def _host_label(host, starts, t: float) -> str:
    """The innermost host event running at time t (its name), or 'idle
    host' where none is."""
    best = None
    i = bisect.bisect_right(starts, t)
    for e in host[max(0, i - 2000):i]:
        if e.time_range.start <= t <= e.time_range.end:
            if best is None or e.time_range.start >= best.time_range.start:
                best = e
    return best.name if best is not None else "idle host"


def device_s_matching(summary: TraceSummary, pattern: str) -> float:
    """Device seconds of the ops whose name matches the regex `pattern`."""
    rx = re.compile(pattern)
    return sum(v for k, v in summary.device_ops if rx.search(k))
