"""Per-phase prover profiling (SURVEY §5 names this greenfield work: the
reference declares a `profile` feature with zero uses, Cargo.toml:76).

Usage:
    from sha2cq_tpu_torch.utils.profiling import profiler
    with profiler.phase("h_eval"):
        ...
    print(profiler.report())

Enabled when SHA2CQ_PROFILE is set (any nonempty value) or after
profiler.enable(); zero overhead otherwise (a no-op context manager).

The span log: while enabled, each closed phase and each marker section
appends one record (`Span`) to an in-memory log, read with
profiler.log(): its name and path, start and end on time.perf_counter(),
the thread, a trace id, its own span id, its parent's span id, and the
counts taken inside it.  A phase opened on a thread with no open phase
starts a trace (the trace id is its own span id); a nested phase takes its
root's trace and its opener as parent; a thread that called adopt(trace)
opens its roots in that trace.  A marker's sections share the trace of the
phase open where the marker was made (or a trace of their own) and have
that phase as parent.  The log keeps the newest LOG_MAX records and counts
those it dropped (`dropped`); reset() clears the totals and leaves the log,
clear_log() empties it.  The log writes no file and starts no thread.

Optionally traces the device too: set SHA2CQ_TORCH_TRACE=/dir to wrap
every top-level profiled region in torch.profiler.profile (CPU activity,
plus CUDA when a card is visible) and write one Chrome trace per region
call, <dir>/<region>.<call>.json.  One trace runs at a time: a top-level
region another thread opens meanwhile is timed but not traced.

The port's own copy of sha2cq_tpu/utils/profiling.py; its device trace
(SHA2CQ_TORCH_TRACE) takes the place of the JAX package's
SHA2CQ_JAX_TRACE (an xprof trace around each region).
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, NamedTuple, Optional, Tuple

LOG_MAX = 1 << 16       # records the span log keeps


class Span(NamedTuple):
    """One record of the span log."""
    name: str
    path: str
    start: float                # time.perf_counter()
    end: float
    thread: int                 # threading.get_ident()
    trace: int
    span: int
    parent: Optional[int]       # the opener's span id; None for a root
    counts: Dict[str, int]      # profiler.count calls inside, not in a child


class _Open:
    """A phase open on its thread's stack."""
    __slots__ = ("name", "span", "trace", "counts")

    def __init__(self, name: str, span: int, trace: int):
        self.name, self.span, self.trace, self.counts = name, span, trace, {}


class Profiler:
    def __init__(self):
        self._enabled = bool(os.environ.get("SHA2CQ_PROFILE"))
        self._trace_dir = os.environ.get("SHA2CQ_TORCH_TRACE") or None
        self._tracing = threading.Lock()
        self._records: "OrderedDict[str, Tuple[float, int]]" = OrderedDict()
        self._counts: Dict[str, int] = {}
        self._log: "deque[Span]" = deque(maxlen=LOG_MAX)
        self._log_lock = threading.Lock()
        self._dropped = 0
        self._ids = itertools.count(1)      # span and trace ids
        # per-thread phase stacks: the prover prefetches the device h
        # pipeline on a background thread, whose nested phases must not
        # corrupt the main thread's path nesting
        self._local = threading.local()

    @property
    def _stack(self) -> List[_Open]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # -- control
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    def reset(self) -> None:
        """Clear the totals (timings and counts); the span log stays."""
        self._records.clear()
        self._counts.clear()

    # -- measurement
    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a named region.  Nested regions are recorded under
        'outer/inner' paths."""
        if not self._enabled:
            yield
            return
        stack = self._stack
        top = stack[-1] if stack else None
        sid = next(self._ids)
        opened = _Open(name, sid, top.trace if top else self._root_trace(sid))
        stack.append(opened)
        path = "/".join(o.name for o in stack)
        traced = bool(self._trace_dir) and len(stack) == 1 and \
            self._tracing.acquire(blocking=False)
        t0 = time.perf_counter()
        try:
            with self._trace(path) if traced else contextlib.nullcontext():
                yield
        finally:
            t1 = time.perf_counter()
            tot, cnt = self._records.get(path, (0.0, 0))
            self._records[path] = (tot + t1 - t0, cnt + 1)
            stack.pop()
            self._append(Span(name, path, t0, t1, threading.get_ident(),
                              opened.trace, sid, top.span if top else None,
                              opened.counts))
            if traced:
                self._tracing.release()

    @contextlib.contextmanager
    def _trace(self, path: str):
        """torch.profiler around one region; its Chrome trace goes to
        <trace dir>/<path>.<call>.json."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self._trace_dir, exist_ok=True)
        call = self._records.get(path, (0.0, 0))[1]
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            self._trace_dir, f"{path.replace('/', '_')}.{call}.json"))

    def marker(self, scope: str):
        """Sequential section timing with single-line call sites:

            mark = profiler.marker("create_proof")
            ...work...
            mark("witness")        # records time since marker creation
            ...more work...
            mark("commitments")    # records time since previous mark

        Each call records the elapsed time since the previous call under
        'scope/name', and one span of the log.  No-op when disabled."""
        if not self._enabled:
            return lambda name: None
        stack = self._stack
        top = stack[-1] if stack else None
        trace = top.trace if top else self._root_trace(next(self._ids))
        parent = top.span if top else None
        state = {"t": time.perf_counter()}

        def mark(name: str) -> None:
            now = time.perf_counter()
            path = f"{scope}/{name}"
            tot, cnt = self._records.get(path, (0.0, 0))
            self._records[path] = (tot + (now - state["t"]), cnt + 1)
            tot, cnt = self._records.get(scope, (0.0, 0))
            self._records[scope] = (tot + (now - state["t"]), cnt)
            self._append(Span(name, path, state["t"], now,
                              threading.get_ident(), trace, next(self._ids),
                              parent, {}))
            state["t"] = now

        return mark

    def count(self, name: str, inc: int = 1) -> None:
        """Count an event (no timing): on the card, the bytes a copy moves
        between host and device and the times the host waits for the card,
        which a span's time alone cannot tell apart from host work.  Added
        to the totals (counts(), report()) and to the innermost open phase
        of the calling thread, whose log record carries it."""
        if not self._enabled:
            return
        self._counts[name] = self._counts.get(name, 0) + inc
        stack = getattr(self._local, "stack", None)
        if stack:
            c = stack[-1].counts
            c[name] = c.get(name, 0) + inc

    # -- traces across threads
    def trace_id(self) -> Optional[int]:
        """The trace of this thread's innermost open phase (or the one it
        adopted); None if there is none."""
        stack = getattr(self._local, "stack", None)
        if stack:
            return stack[-1].trace
        return getattr(self._local, "trace", None)

    def adopt(self, trace: Optional[int]) -> None:
        """Open this thread's root phases in `trace` (a trace_id() read on
        the thread that started this one); None: each starts its own."""
        self._local.trace = trace

    def _root_trace(self, new: int) -> int:
        return getattr(self._local, "trace", None) or new

    # -- the span log
    def _append(self, span: Span) -> None:
        with self._log_lock:
            if len(self._log) == LOG_MAX:
                self._dropped += 1
            self._log.append(span)

    def log(self) -> List[Span]:
        """The span log, oldest record first."""
        with self._log_lock:
            return list(self._log)

    @property
    def dropped(self) -> int:
        """Records the log dropped, oldest first, to keep LOG_MAX."""
        return self._dropped

    def clear_log(self) -> None:
        with self._log_lock:
            self._log.clear()
            self._dropped = 0

    # -- reporting
    def timings(self) -> Dict[str, float]:
        return {k: v[0] for k, v in self._records.items()}

    def counts(self) -> Dict[str, int]:
        return dict(self._counts)

    def report(self, title: str = "prover phases") -> str:
        if not self._records:
            return f"[{title}] (no profiling records)"
        total = sum(v[0] for k, v in self._records.items() if "/" not in k)
        lines = [f"[{title}] total {total:.3f}s"]
        for path, (dt, cnt) in self._records.items():
            indent = "  " * path.count("/")
            name = path.rsplit("/", 1)[-1]
            pct = 100.0 * dt / total if total and "/" not in path else 0.0
            suffix = f" ({pct:4.1f}%)" if "/" not in path else ""
            times = f" x{cnt}" if cnt > 1 else ""
            lines.append(f"  {indent}{name:<28s} {dt:8.3f}s{times}{suffix}")
        for name, n in sorted(self._counts.items()):
            lines.append(f"  {name:<30s} = {n}")
        return "\n".join(lines)


profiler = Profiler()
