"""The traced run's profiler window, reduced in memory.

`Window` runs `torch.profiler` (host and device activity) over the traced
part of a run and reduces its raw events to a `Trace`: the spans the
benchmark's hooks opened (`torch.profiler.record_function`), every host
launch with its correlation id and thread, and every device activity
(kernels, copies, sets) with the correlation id of its launch.  No trace
file is written.

A span's device time is the time of the device activities launched while
it was open on the launching thread (the span and every span inside it),
whatever runs them.  Busy time is the union of the device activities'
intervals inside the window; the idle gaps are labelled by the innermost
span open, at the gap's start, on the thread that launched the most work.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

#: Span names the benchmark's own host code opens; `WINDOW_SPAN` bounds
#: the traced window.
WINDOW_SPAN = "bench.window"
OUTSIDE_SPANS = "host.outside_spans"


@dataclasses.dataclass
class Trace:
    """Raw events of one profiler window, times in ns on one clock.

    spans: (name, thread, start, end) of the benchmark's spans;
    launches: correlation id -> (thread, time) of each host launch;
    device: (name, start, end, correlation id) of each device activity."""
    spans: list
    launches: dict
    device: list

    def window(self) -> tuple[int, int]:
        """(start, end) of the window span, else of everything seen."""
        for name, _, s, e in self.spans:
            if name == WINDOW_SPAN:
                return s, e
        times = [t for _, t in self.launches.values()]
        times += [x for _, s, e, _ in self.device for x in (s, e)]
        return (min(times), max(times)) if times else (0, 0)

    def _enclosing(self) -> dict:
        """correlation id -> names of every span open around its launch on
        the launching thread, innermost last."""
        items = collections.defaultdict(list)
        for name, tid, s, e in self.spans:
            if name != WINDOW_SPAN:
                items[tid].append((s, 0, e, name))
        for cid, (tid, t) in self.launches.items():
            items[tid].append((t, 1, cid, None))
        out = {}
        for seq in items.values():
            stack = []                  # (end, name) of the open spans
            for t, kind, x, name in sorted(seq, key=lambda i: i[:2]):
                while stack and stack[-1][0] < t:
                    stack.pop()
                if kind == 0:
                    stack.append((x, name))
                else:
                    out[x] = [n for _, n in stack]
        return out

    def span_device_s(self) -> dict:
        """Span name -> seconds of device activity launched inside it."""
        enclosing = self._enclosing()
        total = collections.defaultdict(int)
        for _, s, e, cid in self.device:
            for name in set(enclosing.get(cid, ())):
                total[name] += e - s
        return {k: v / 1e9 for k, v in total.items()}

    def busy_intervals(self) -> list:
        """The union of the device activities, clipped to the window."""
        lo, hi = self.window()
        merged = []
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def window_s(self) -> float:
        lo, hi = self.window()
        return (hi - lo) / 1e9

    def top_device_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device activities that took longest
        in all, inside the window."""
        lo, hi = self.window()
        total = collections.defaultdict(int)
        for name, s, e, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                total[name] += e - s
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_by_host_span(self, n: int = 10) -> list:
        """[[span, seconds]]: the device's idle time inside the window,
        summed by the innermost span open at each gap's start on the
        thread that launched the most work, longest first."""
        lo, hi = self.window()
        counts = collections.Counter(tid for tid, _ in
                                     self.launches.values())
        if not counts:
            return []
        main = counts.most_common(1)[0][0]
        spans = sorted((s, e, name) for name, tid, s, e in self.spans
                       if tid == main and name != WINDOW_SPAN)
        starts = [s for s, _, _ in spans]

        def label(t):
            inner = [(s, name) for s, e, name in
                     spans[:bisect.bisect_right(starts, t)] if e >= t]
            return max(inner)[1] if inner else OUTSIDE_SPANS

        idle = collections.defaultdict(int)
        cursor = lo
        for s, e in self.busy_intervals() + [[hi, hi]]:
            if s > cursor:
                idle[label(cursor)] += s - cursor
            cursor = max(cursor, e)
        top = sorted(idle.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]


def from_kineto(events) -> Trace:
    """A `Trace` from ``prof.profiler.kineto_results.events()``: spans are
    the host-side events whose names start with "layer." or "bench.",
    launches every other host event that carries a correlation id (its
    CUDA runtime or driver call), device every device-side event that is
    not a span's device-side shadow."""
    spans, launches, device = [], {}, []
    for ev in events:
        name = ev.name()
        on_device = ev.device_type().name == "CUDA"
        is_span = name.startswith(("layer.", "bench."))
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if on_device:
            if not is_span:
                device.append((name, start, end, ev.correlation_id()))
        elif is_span:
            spans.append((name, ev.start_thread_id(), start, end))
        elif ev.correlation_id():
            launches[ev.correlation_id()] = (ev.start_thread_id(), start)
    return Trace(spans, launches, device)


class Window:
    """`with Window(enabled) as w:` profiles the block when `enabled`,
    inside a `WINDOW_SPAN`; `w.trace` is the reduced `Trace` after it
    (None when disabled)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace = None
        self._prof = self._span = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            import torch
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._span = record_function(WINDOW_SPAN)
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import torch
            self._span.__exit__(None, None, None)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            self.trace = from_kineto(
                self._prof.profiler.kineto_results.events())
        return False
