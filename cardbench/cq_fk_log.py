"""The program's span log per table preprocessed, for the per-layer
readers of a traced run on a card: sha2cq_tpu_torch.utils.profiling.
profiler.log(), read after the window.  A table is a trace whose root span
is `cq_fk` (plonk/static_tables.fk_cached_quotients) and lies inside one
of the window's request spans; each reader gives the median over the
window's tables, or None where there is none to read: a run without a
device trace (on the CPU), a program that keeps no span log, or one that
opens no such span."""
from statistics import median

ROOT = "cq_fk"


def tables(record) -> list:
    """The records of each table of the window, one list a trace."""
    if record.tracer is None or record.tracer.busy is None:
        return []
    from sha2cq_tpu_torch.utils.profiling import profiler
    log = getattr(profiler, "log", None)
    if log is None:
        return []
    spans = log()
    by_trace = {}
    for s in spans:
        by_trace.setdefault(s.trace, []).append(s)
    return [by_trace[s.trace] for s in spans
            if s.name == ROOT and s.parent is None and any(
                a <= s.start and s.end <= b for a, b in record.window.spans)]


def span_seconds(record, name: str):
    """Median over the tables of the seconds in spans `name`."""
    per = [sum(s.end - s.start for s in trace if s.name == name)
           for trace in tables(record)
           if any(s.name == name for s in trace)]
    return median(per) if per else None


def count(record, name: str):
    """Median over the tables of the count `name`, summed over each
    table's spans; None where no table counted it."""
    per = [sum(s.counts.get(name, 0) for s in trace)
           for trace in tables(record)
           if any(name in s.counts for s in trace)]
    return float(median(per)) if per else None
