"""System `cq_tables`: the CQ prover-side preprocessing (cached quotients,
by Feist-Khovratovich) of SHA-256 circuit32's lookup tables through
sha2cq_tpu_torch's StaticTableValues.many, the batched call its SHA-256
setup makes, over a TableSRS's G1 powers made from the configuration's
fixed secret.

Set-up: refuses at once a program with no device FK entry
(plonk.static_tables.fk_cached_quotients and StaticTableValues.many);
then the tables' columns (reference/sha2_tables.py at the configuration's
word bits), the SRS's G1 powers (made by the program's native code on the
first run in a checkout, then read from $CARDBENCH_CACHE/srs) and one
warm-up table outside the window, which fills the program's SRS-side
transform, with the program's span log on: the set-up raises, and the run
prints no result, where that warm-up ran no group NTT on the device under
a cq_fk span.
Traffic: request i is one sigma half-table, drawn by (seed, i) from the
traffic's tables; serving it is StaticTableValues.many over its columns,
and the answer is each column's cached quotients (affine points).
The check (after the window, in worker processes that are all gone when
it returns): the reference's columns of each served table equal the
program's tables32 columns; the first answer of each distinct column is
held in full to its definition (reference/cq_tables.py: a combination
with 64-bit weights drawn from the seed over every point, and 64 rows
drawn from the seed point for point); every later answer of that column
has to be identical to the first.  quotients_wrong counts the column
answers that fail.  The control (`control`) serves each column the answer
of its neighbour in the table.
"""
from __future__ import annotations

import contextlib
import hashlib
import random
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context, resource_tracker
from types import SimpleNamespace

from cardbench.reference import bn254, cq_tables, sha2_tables
from cardbench.systems import witness_commit

SPAN = "cq_fk"
CHECK_WORKERS = 6
HOST_REFUSAL = ("the program preprocesses this configuration's tables on "
                "the host: StaticTableValues.many ran no device group NTT")


def _secret(config) -> int:
    return int(config["srs_secret"], 0) % bn254.R


def setup(config, traffic, seed, device):
    from sha2cq_tpu_torch.plonk import static_tables as ST
    if not (hasattr(ST, "fk_cached_quotients") and
            hasattr(ST.StaticTableValues, "many")):
        raise RuntimeError(HOST_REFUSAL + " (no device FK entry)")
    from sha2cq_tpu_torch.poly.kzg import params as KP
    w, n = config["word_bits"], config["table_rows"]
    if traffic["rows"] != n or len(traffic["columns"]) != \
            config["columns_per_table"] or n != 1 << (w // 2):
        raise ValueError("the traffic's tables are not the configuration's")
    cols = sha2_tables.tables(w)
    tables = {t: [cols[f"s256_{w}_{t}_{c}"] for c in traffic["columns"]]
              for t in traffic["tables"]}
    s, size = _secret(config), 1 << config["srs_log2"]
    srs = witness_commit._cached_points(
        "g1", s, size, lambda: KP._g1_powers_of_s(s, size))
    state = SimpleNamespace(config=config, traffic=traffic, seed=seed,
                            device=device, tables=tables, srs_g1=srs)
    if not _ran_on_device(lambda: serve(state, request(state, "warm-up")),
                          device):
        raise RuntimeError(HOST_REFUSAL)
    return state


def _ran_on_device(call, device) -> bool:
    """Whether `call` transformed points in a cq_group_ntt span inside a
    root span cq_fk (and, on a card, launched the group NTT kernel), read
    from the program's span log with the profiler on for the call; the
    profiler is left as it was."""
    from sha2cq_tpu_torch.ops import cuda_field as CF
    from sha2cq_tpu_torch.utils.profiling import profiler
    was = profiler.enabled
    launched = CF.launches.get("g1_ntt", 0)
    profiler.enable()
    profiler.clear_log()
    try:
        call()
        spans = profiler.log()
    finally:
        if not was:
            profiler.disable()
        profiler.reset()
        profiler.clear_log()
    roots = {sp.trace for sp in spans if sp.name == SPAN and sp.parent is None}
    ntt = any(sp.name == "cq_group_ntt" and sp.trace in roots and
              sp.counts.get("group_ntt_points", 0) > 0 for sp in spans)
    on_card = not device.startswith("cuda") or \
        CF.launches.get("g1_ntt", 0) > launched
    return ntt and on_card


def request(state, index):
    """Request `index`: the name of a table, drawn from (seed, index)."""
    rng = random.Random(f"{state.seed}:{index}")
    return SimpleNamespace(index=index,
                           table=rng.choice(state.traffic["tables"]))


def serve(state, req):
    from sha2cq_tpu_torch.plonk.static_tables import StaticTableValues
    opened = StaticTableValues.many(state.tables[req.table], state.srs_g1)
    return [tv.qs for tv in opened]


@contextlib.contextmanager
def control(state):
    """StaticTableValues.many serving each column the cached quotients of
    the next column of its table: right points, wrong column."""
    from sha2cq_tpu_torch.plonk.static_tables import StaticTableValues
    real = StaticTableValues.__dict__["many"]

    def shifted(cls, columns, srs_g1):
        out = real.__func__(cls, columns, srs_g1)
        qs = [tv.qs for tv in out]
        for j, tv in enumerate(out):
            tv.qs = qs[(j + 1) % len(qs)]
        return out
    StaticTableValues.many = classmethod(shifted)
    try:
        yield
    finally:
        StaticTableValues.many = real


def _key(values) -> str:
    return hashlib.sha256(repr(values).encode()).hexdigest()[:16]


def check(state, served) -> dict:
    """The served tables' columns against the program's, then every
    column answer against its definition or its column's first answer."""
    from sha2cq_tpu_torch.models.sha import tables32
    w = state.config["word_bits"]
    scheme = tables32.HalfScheme(w)
    findings, wrong = [], 0
    program = {}
    for t in sorted({req.table for req, _ in served}):
        cols = tables32.sigma_half_columns(scheme, t[:-1], hi=t[-1] == "h")
        program[t] = [cols[c] for c in state.traffic["columns"]] == \
            state.tables[t]
        if not program[t]:
            findings.append(f"table {t}: the reference's columns are not "
                            "the program's")
    first, same = {}, {}
    for i, (req, answer) in enumerate(served):
        cols = state.tables[req.table]
        if not program[req.table] or len(answer) != len(cols):
            wrong += len(cols)
            findings.append(f"request {i} ({req.table}): not checked whole")
            continue
        for name, values, qs in zip(state.traffic["columns"], cols, answer):
            key = _key(values)
            if key not in first:
                first[key] = (values, qs)
                same[key] = 1
            elif qs == first[key][1]:
                same[key] += 1
            else:
                wrong += 1
                findings.append(f"request {i} ({req.table}.{name}) differs "
                                "from its column's first answer")
    s = _secret(state.config)
    jobs = [(values, qs, s, f"{state.seed}:{key}")
            for key, (values, qs) in first.items()]
    state.srs_g1 = None
    try:
        with ProcessPoolExecutor(CHECK_WORKERS,
                                 mp_context=get_context("spawn")) as pool:
            results = list(pool.map(cq_tables.check_column, jobs))
    finally:
        # the spawn pool starts multiprocessing's resource tracker, which
        # would otherwise end only after this process
        stop = getattr(resource_tracker._resource_tracker, "_stop", None)
        if stop is not None:
            stop()
    for key, ok in zip(first, results):
        if not ok:
            wrong += same[key]
            findings.append(f"column {key}: its answer is not its cached "
                            "quotients")
    findings.append(f"{len(served)} tables, {len(first)} distinct columns "
                    "checked in full")
    state.findings = findings
    return {"quotients_wrong": (wrong, 0)}
