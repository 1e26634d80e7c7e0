"""The harness's own spans and the reduction of a profiled sub-window.

Spans are taken only in a traced run (``--trace 1``): host-clock intervals
around the harness's calls into the program, also marked in the profiler
(``record_function``) while it runs, so that an idle gap on the device can
be put down to what the host was doing.  The profiled sub-window is
reduced in memory: no trace file is written.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "kgbench.window"
# the card's tracing now and then returns no device event at all: such a
# window is profiled again, up to this many times in all
PROFILE_ATTEMPTS = 3


class Spans:
    """Host seconds of the harness's calls, by span name; off unless
    ``enabled``.  ``profiling`` also marks each span in the profiler."""

    def __init__(self, enabled: bool, profiling: bool = False):
        self.enabled = enabled
        self.profiling = profiling
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def _timed(self, name: str):
        marker = contextlib.nullcontext()
        if self.profiling:
            from torch.profiler import record_function
            marker = record_function(name)
        with marker:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)

    def __call__(self, name: str):
        return self._timed(name) if self.enabled else contextlib.nullcontext()


def short_name(name: str) -> str:
    """A kernel's function name without its scope, return type, template
    arguments and parameters; a copy's or a fill's name as it is."""
    name = name.strip()
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)", "")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    scope = "".join(out).split("(")[0].strip().split(" ")[-1].split("::")
    return "::".join(scope[-2:]) if scope[-1] == "kernel" else (
        scope[-1] or name)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)   # short name -> seconds
    gap_s: dict = field(default_factory=dict)      # host span -> idle s
    device_events: int = 0


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_profile(prof) -> TraceSummary | None:
    """The window's length, the device's busy seconds (the union of every
    device operation's interval inside the window), each kernel's summed
    seconds, and the idle seconds by the innermost harness span open at
    each gap's middle.  None when the trace holds no device event."""
    from torch.autograd import DeviceType
    device, spans, window = [], [], None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith("kgbench."):
            # the harness's spans, which the profiler also mirrors onto
            # the device's timeline: no device operation
            if e.device_type != DeviceType.CUDA:
                if e.name == WINDOW:
                    window = (start, end)
                else:
                    spans.append((e.name, start, end))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, start, end))
    if window is None or not device:
        return None
    lo, hi = window
    inside = [(name, max(a, lo), min(b, hi)) for name, a, b in device
              if b > lo and a < hi]
    busy = _union([(a, b) for _, a, b in inside])
    kernel_s = defaultdict(float)
    for name, a, b in inside:
        kernel_s[short_name(name)] += (b - a) / 1e6
    spans.sort(key=lambda s: s[1])
    starts = [s[1] for s in spans]
    gap_s = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        at = bisect.bisect_right(starts, mid)
        open_spans = [s for s in spans[max(0, at - 8):at] if s[2] >= mid]
        label = (min(open_spans, key=lambda s: s[2] - s[1])[0]
                 if open_spans else WINDOW)
        gap_s[label] += (b - a) / 1e6
    return TraceSummary(
        window_s=(hi - lo) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernel_s=dict(kernel_s), gap_s=dict(gap_s),
        device_events=len(device))


def profile_window(device, body):
    """``body(spans)`` under the profiler, inside the WINDOW span and up to
    a synchronisation, reduced by reduce_profile, at most PROFILE_ATTEMPTS
    times until the trace holds a device event.  Returns the summary, or
    None where no attempt's did."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for _ in range(PROFILE_ATTEMPTS):
        spans = Spans(True, profiling=True)
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                body(spans)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        summary = reduce_profile(prof)
        if summary is not None or device.type != "cuda":
            return summary
    return None


def matching(kernel_s: dict, patterns) -> float | None:
    """Summed seconds of the kernels whose name holds any of
    ``patterns``; None when none ran."""
    hits = [s for name, s in kernel_s.items()
            if any(p in name for p in patterns)]
    return sum(hits) if hits else None


def breakdown(summary: TraceSummary) -> dict:
    top = sorted(summary.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary.gap_s.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
