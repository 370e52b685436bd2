"""The benchmark's harness, general over cells.

A cell of BENCHMARK.json names a configuration and a traffic mix; each is
a file found by name (configs/<config>.json, traffic/<traffic>.json), and
the configuration names the system that serves the traffic
(systems/<system>.py).  Each metric is a file of its own: an end-to-end
metric end_to_end/<name>.py, a per-layer metric metrics/<name>.py, each
with `read(record)` returning a number or None.  A new cell, configuration,
traffic mix or metric is a new file and a new entry; nothing here names one.

A system module has:
  setup(config, traffic, seed, device) -> state   fixed parts, warm-up
  request(state, index) -> request                 drawn from (seed, index)
  serve(state, request) -> answer                  the timed call
  check(state, served) -> {name: (number, limit)}  the plain reference,
                                                   run after the window
and, for per-layer readers, SPAN: the name of the served call's span.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "sha2cq_tpu")


def load_module(path: str):
    """A module loaded from its file (names may hold dots)."""
    name = "cardbench_" + re.sub(r"\W", "_", os.path.relpath(path, HERE))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _file(kind: str, name: str, ext: str, base: str = HERE) -> str:
    """<base>/<kind>/<name><ext>, or the same under this folder."""
    for root in (base, HERE):
        path = os.path.join(root, kind, name + ext)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no {kind} file {name + ext!r} under {base}")


def resolve(bench: dict, workload: str, base: str = HERE):
    """The cell `workload` of a BENCHMARK.json object: its entry, its
    configuration and traffic (parsed), its system module and its metrics
    (each entry with its reader); files are looked for under `base` first,
    then under this folder."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    with open(_file("configs", cell["config"], ".json", base)) as f:
        config = json.load(f)
    with open(_file("traffic", cell["traffic"], ".json", base)) as f:
        traffic = json.load(f)

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return SimpleNamespace(
        name=workload, cell=cell, config=config,
        traffic=traffic,
        system=load_module(_file("systems", config["system"], ".py", base)),
        end_to_end=[(m, load_module(_file("end_to_end", m["name"], ".py", base)))
                    for m in bench["end_to_end"] if mine(m)],
        per_layer=[(m, load_module(_file("metrics", m["name"], ".py", base)))
                   for m in bench["per_layer"] if mine(m)])


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load."""
    loaded = {n.split(".")[0] for n, m in list(sys.modules.items())
              if m is not None}
    return sorted(loaded & set(FORBIDDEN))


def window(system, state, seconds: float, tracer=None):
    """Serve requests back to back, one client, until `seconds` have passed
    since the first; the last one runs to its end.  Returns the record:
    the served (request, answer) pairs, each request's start and end on
    the host clock, and failures."""
    served, spans, failures = [], [], []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        req = system.request(state, i)
        if tracer:
            tracer.before_request()
        start = time.perf_counter()
        try:
            out = system.serve(state, req)
        except Exception as e:          # a failed request, counted as such
            failures.append(f"request {i}: {type(e).__name__}: {e}")
            out = None
        end = time.perf_counter()
        if tracer:
            tracer.after_request(start, end)
        if out is not None:
            served.append((req, out))
        spans.append((start, end))
        i += 1
    return SimpleNamespace(t0=t0, t_end=spans[-1][1], spans=spans,
                           served=served, failures=failures,
                           attempted=len(spans))


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, out=sys.stdout, err=sys.stderr) -> dict:
    """One run of a cell: set-up (timed from `t_start`), the window, the
    reference check and the metrics.  Returns the result object without
    the device's name and count (run.py adds them) and writes the report
    lines to `out` and `err`; the compared numbers come last in both."""
    import torch
    system = cell.system
    on_card = device.startswith("cuda")
    state = system.setup(cell.config, cell.traffic, seed, device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    tracer = None
    if trace:
        from cardbench.trace import Tracer
        tracer = Tracer(device, system.SPAN)
        tracer.start()
    rec = window(system, state, seconds, tracer)
    if tracer:
        tracer.stop(rec)
    dev = {}
    if on_card:
        dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        if tracer:
            dev.update(busy_s=tracer.busy_s, window_s=tracer.window_s)
    t_check = time.perf_counter()
    compared = system.check(state, rec.served)
    check_s = time.perf_counter() - t_check
    record = SimpleNamespace(cell=cell, state=state, window=rec,
                             setup_s=setup_s, tracer=tracer)
    metrics = {}
    for entry, reader in (cell.per_layer if trace else cell.end_to_end):
        value = reader.read(record)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    lat = sorted(e - s for s, e in rec.spans)
    print(f"[cardbench] cell={cell.name} seed={seed} trace={int(trace)} "
          f"window_s={rec.t_end - rec.t0:.6f} requests={rec.attempted} "
          f"served={len(rec.served)} median_request_s={lat[len(lat) // 2]:.6f} "
          f"max_request_s={lat[-1]:.6f} setup_s={setup_s:.6f} "
          f"check_s={check_s:.6f} "
          f"peak_device_bytes={dev.get('memory_peak_bytes', 'not measured')}",
          file=out, flush=True)
    if tracer:
        for req in tracer.requests:
            print("[cardbench] spans " + json.dumps(req["totals"]), file=out)
    for line in rec.failures + getattr(state, "findings", []):
        print(f"[cardbench] {line}", file=err, flush=True)
    result = {"correct": not rec.failures and all(
                  v <= lim for v, lim in compared.values()),
              "attempted": rec.attempted, "failed": len(rec.failures),
              "metrics": metrics, "device": dev}
    if tracer and tracer.busy is not None:
        result["breakdown"] = tracer.breakdown(rec)
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, (v, lim) in compared.items()}
    for name, c in result["compared"].items():
        print(f"compared {name} = {c['value']} (limit {c['limit']})",
              file=err, flush=True)
    return result
