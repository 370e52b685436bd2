"""The traced run's readings: the program's spans per request on the host
clock, and the device's operations from torch.profiler, on one time line.

Spans: the program's profiler (sha2cq_tpu_torch.utils.profiling) is
switched on for the window, its per-request totals are taken and reset
after each request, and its `phase` and `marker` are wrapped so that every
span of the serving thread is also kept as an interval.  Device: a
torch.profiler over the window (CPU and CUDA activity); a record_function
at its start, read on both clocks, puts the device's operations on the host
clock.
"""
from __future__ import annotations

import contextlib
import threading
import time


class Tracer:
    def __init__(self, device: str, span: str):
        self.device = device
        self.span = span        # the name of the served call's own span
        self.requests = []      # per request: {"totals": the profiler's}
        self.intervals = []     # (name, start, end) of the serving thread
        self.ops = []           # (name, start, end) on the device, host clock
        self.busy = None        # merged busy intervals, on a card only

    # -- the program's spans
    def _wrap_profiler(self):
        from sha2cq_tpu_torch.utils.profiling import profiler
        self.profiler = profiler
        main = threading.get_ident()
        phase, marker = profiler.phase, profiler.marker
        keep = self.intervals

        @contextlib.contextmanager
        def traced_phase(name):
            t0 = time.perf_counter()
            try:
                with phase(name):
                    yield
            finally:
                if threading.get_ident() == main:
                    keep.append((name, t0, time.perf_counter()))

        def traced_marker(scope):
            mark = marker(scope)
            last = [time.perf_counter()]

            def wrapped(name):
                mark(name)
                now = time.perf_counter()
                if threading.get_ident() == main:
                    keep.append((f"{scope}/{name}", last[0], now))
                last[0] = now
            return wrapped

        profiler.phase, profiler.marker = traced_phase, traced_marker
        profiler.reset()
        profiler.enable()

    def _unwrap_profiler(self):
        p = self.profiler
        del p.phase, p.marker          # the class's methods again
        p.disable()
        p.reset()

    def before_request(self):
        self.profiler.reset()

    def after_request(self, start: float, end: float):
        self.requests.append({"totals": self.profiler.timings()})
        self.intervals.append((self.span, start, end))

    # -- the device
    def start(self):
        """Spans on; on a card also a torch.profiler over CPU and CUDA
        activity (a CPU run has no device to trace)."""
        self._wrap_profiler()
        self.prof = None
        if not self.device.startswith("cuda"):
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        with record_function("cardbench.anchor"):
            self.anchor = time.perf_counter()

    def stop(self, rec):
        self.window_s = rec.t_end - rec.t0
        self._unwrap_profiler()
        if self.prof is None:
            return              # no device: busy stays None, nothing to read
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        events = self.prof.events()
        anchor = [e for e in events if e.name == "cardbench.anchor"]
        offset = self.anchor - anchor[0].time_range.start / 1e6
        self.ops = sorted(
            (e.name, e.time_range.start / 1e6 + offset,
             e.time_range.end / 1e6 + offset)
            for e in events if e.device_type == DeviceType.CUDA)
        self.prof = None
        self.busy = merge([(s, e) for _, s, e in self.ops], rec.t0, rec.t_end)
        self.busy_s = sum(e - s for s, e in self.busy)

    def busy_within(self, start: float, end: float) -> float:
        """Seconds of [start, end] in which an operation ran on the device."""
        return sum(max(0.0, min(e, end) - max(s, start)) for s, e in self.busy)

    def spans(self, name: str):
        """The serving thread's intervals of the span `name`."""
        return [(s, e) for n, s, e in self.intervals if n == name]

    def breakdown(self, rec) -> dict:
        """The device operations that took most time, and the device's idle
        time by the program's innermost span on the serving thread (the
        harness between requests where none is open), ten of each."""
        by_op = {}
        for name, s, e in self.ops:
            by_op[name] = by_op.get(name, 0.0) + (e - s)
        gaps, prev = [], rec.t0
        for s, e in self.busy + [(rec.t_end, rec.t_end)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        idle = {}
        segs = labels(self.intervals, rec.t0, rec.t_end, "between requests")
        j = 0
        for gs, ge in gaps:
            while j < len(segs) and segs[j][1] <= gs:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < ge:
                a, b, name = segs[k]
                idle[name] = idle.get(name, 0.0) + min(b, ge) - max(a, gs)
                k += 1

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda x: -x[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(idle)}


def labels(intervals, lo: float, hi: float, none: str):
    """[lo, hi] cut into (start, end, name) segments, each named after the
    shortest of the intervals (name, start, end) open over it, or `none`."""
    import heapq
    events = sorted([(s, 0, i) for i, (_, s, _e) in enumerate(intervals)] +
                    [(e, 1, i) for i, (_, _s, e) in enumerate(intervals)])
    open_, closed, out = [], set(), []
    t = lo
    for when, kind, i in events + [(hi, 2, -1)]:
        when = min(max(when, lo), hi)
        while open_ and open_[0][1] in closed:
            heapq.heappop(open_)
        if when > t:
            out.append((t, when, intervals[open_[0][1]][0] if open_ else none))
            t = when
        if kind == 0:
            name, s, e = intervals[i]
            heapq.heappush(open_, (e - s, i))
        elif kind == 1:
            closed.add(i)
    return out


def merge(intervals, lo: float, hi: float):
    """Union of intervals, clipped to [lo, hi], as sorted disjoint pairs."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out
