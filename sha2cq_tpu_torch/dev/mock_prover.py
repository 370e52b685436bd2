"""MockProver: interpret a circuit into in-memory cell grids and check every
constraint row by row (reference halo2_proofs/src/dev.rs:294-1363).

Differences from the reference, by design:
  - static (CQ) lookups ARE checked against the registered tables — the
    reference silently ignores them (dev.rs:345-351, a known gap flagged in
    SURVEY.md §1-L4); we have the table values available, so we check.
  - failures are typed records (VerifyFailure dataclass with kind /
    constraint index / column / FailureLocation / cell values) with an
    emitter (emit_failures), mirroring dev/failure.rs:119 +
    failure/emitter.rs.
  - multi-phase challenges ARE supported: synthesis is re-run per phase with
    deterministic (hash-derived) challenge values revealed phase by phase,
    mirroring the real prover's phase protocol — a circuit that consumes a
    challenge before its phase produces garbage witnesses and fails gates.
  - gate failures carry the enclosing region name; advice cells queried by
    an active gate but never assigned are reported ("unassigned"), like the
    reference's cell-coverage checks (dev.rs:979+).

The port's own copy of sha2cq_tpu/dev/mock_prover.py.
"""
from __future__ import annotations

import hashlib

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..circuit import SimpleFloorPlanner, Value, planner_for
from ..fields.host import FR_MOD
from ..plonk.circuit_ir import Column, ConstraintSystem, Expression, Selector, StaticTableId

P = FR_MOD


class _MockAssignment:
    def __init__(self, n: int, cs: ConstraintSystem, instance: List[List[int]],
                 usable_rows: int):
        self.n = n
        self.cs = cs
        self.usable_rows = usable_rows
        self.advice = [[0] * n for _ in range(cs.num_advice_columns)]
        self.advice_assigned = [[False] * n for _ in range(cs.num_advice_columns)]
        self.fixed = [[0] * n for _ in range(cs.num_fixed_columns)]
        self.selectors = [[False] * n for _ in range(cs.num_selectors)]
        self.instance = instance
        self.copies: List[Tuple[Column, int, Column, int]] = []
        self.static_tables: Dict[StaticTableId, object] = {}
        self.current_region = None
        self.challenges: Dict[int, int] = {}
        self.regions: List[Tuple[str, int, int]] = []   # (name, min_row, max_row)

    # Assignment protocol
    def enter_region(self, name):
        self.current_region = [name, None, None]

    def exit_region(self):
        if self.current_region and self.current_region[1] is not None:
            self.regions.append(tuple(self.current_region))
        self.current_region = None

    def _touch(self, row: int) -> None:
        r = self.current_region
        if r is not None:
            r[1] = row if r[1] is None else min(r[1], row)
            r[2] = row if r[2] is None else max(r[2], row)

    def get_challenge(self, challenge) -> Value:
        v = self.challenges.get(challenge.index)
        return Value.known(v) if v is not None else Value.unknown()

    def assign_advice(self, column: Column, row: int, value: Value) -> None:
        if row >= self.usable_rows:
            raise ValueError(f"not enough rows available (row {row})")
        self._touch(row)
        self.advice[column.index][row] = value.assign()
        self.advice_assigned[column.index][row] = True

    def assign_fixed(self, column: Column, row: int, value: Value) -> None:
        if row >= self.usable_rows:
            raise ValueError(f"not enough rows available (row {row})")
        self._touch(row)
        self.fixed[column.index][row] = value.assign()

    def enable_selector(self, selector: Selector, row: int) -> None:
        if row >= self.usable_rows:
            raise ValueError(f"not enough rows available (row {row})")
        self.selectors[selector.index][row] = True

    def assign_advice_slice(self, column: Column, row0: int, values) -> None:
        hi = row0 + len(values)
        if hi > self.usable_rows:
            raise ValueError(f"not enough rows available (rows {row0}..{hi})")
        self._touch(row0)
        self._touch(hi - 1)
        from ..fields.host import FR_MOD
        self.advice[column.index][row0:hi] = [v % FR_MOD for v in values]
        self.advice_assigned[column.index][row0:hi] = [True] * len(values)

    def assign_fixed_slice(self, column: Column, row0: int, values) -> None:
        hi = row0 + len(values)
        if hi > self.usable_rows:
            raise ValueError(f"not enough rows available (rows {row0}..{hi})")
        self._touch(row0)
        self._touch(hi - 1)
        from ..fields.host import FR_MOD
        self.fixed[column.index][row0:hi] = [v % FR_MOD for v in values]

    def query_instance(self, column: Column, row: int) -> Value:
        return Value.known(self.instance[column.index][row])

    def copy(self, col_a: Column, row_a: int, col_b: Column, row_b: int) -> None:
        self.copies.append((col_a, row_a, col_b, row_b))

    def register_static_table(self, table_id: StaticTableId, table) -> None:
        self.static_tables[table_id] = table

    def next_phase(self) -> None:
        pass


@dataclass
class FailureLocation:
    """Where a failure happened (reference dev/failure.rs:25-60
    FailureLocation::{InRegion, OutsideRegion})."""
    region: Optional[str]    # region name, None when outside any region
    row: int

    def __str__(self):
        if self.region is None:
            return f"on row {self.row} (outside any region)"
        return f"in region '{self.region}' at row {self.row}"


@dataclass
class VerifyFailure:
    """Typed failure record (reference dev/failure.rs:119 VerifyFailure).

    kind: "gate" (ConstraintNotSatisfied) | "unassigned" (CellNotAssigned) |
          "lookup" | "static_lookup" | "permutation".
    name: gate/lookup name or permutation cell pair.
    row / location: row of the violation and its region attribution.
    constraint_index: which polynomial of the gate (gate kind only).
    column: "<kind>[<index>]" of the offending cell (unassigned/permutation).
    cell_values: [(query description, value)] for every cell the failing
          constraint read — the reference emitter's assignment listing
          (dev/failure/emitter.rs:96-170).
    """
    kind: str
    name: str
    row: int
    detail: str = ""
    location: Optional[FailureLocation] = None
    constraint_index: Optional[int] = None
    column: Optional[str] = None
    cell_values: Optional[List[Tuple[str, int]]] = None

    def __str__(self):
        return f"{self.kind} '{self.name}' violated at row {self.row} {self.detail}"

    def emit(self) -> str:
        """Multi-line human-readable rendering (failure/emitter.rs style)."""
        head = {
            "gate": f"Constraint {self.constraint_index} in gate '{self.name}' "
                    f"is not satisfied {self.location or f'on row {self.row}'}",
            "unassigned": f"Cell {self.column} queried by active gate "
                          f"'{self.name}' is not assigned "
                          f"{self.location or f'on row {self.row}'}",
            "lookup": f"Lookup '{self.name}' input does not exist in table "
                      f"{self.location or f'on row {self.row}'}",
            "static_lookup": f"Static (CQ) lookup '{self.name}' input does not "
                             f"exist in table "
                             f"{self.location or f'on row {self.row}'}",
            "permutation": f"Equality constraint {self.name} is not satisfied "
                           f"{self.location or f'on row {self.row}'}",
        }.get(self.kind, str(self))
        lines = [head]
        if self.detail:
            lines.append(f"  {self.detail}")
        if self.cell_values:
            lines.append("  Assigned cell values:")
            lines += [f"    {q} = {_fmt_fr(v)}" for q, v in self.cell_values]
        return "\n".join(lines)


def _fmt_fr(v: int) -> str:
    """Small field values print as integers, large ones as 0x… (the emitter's
    readable-scalar convention)."""
    return str(v) if v < 1 << 16 else hex(v)


def emit_failures(failures: List["VerifyFailure"]) -> str:
    """Render a failure list the way the reference prints VerifyFailure
    (one emitted block per failure)."""
    return "\n".join(f.emit() for f in failures)


def _collect_queries(expr: Expression, advice_out: set, fixed_out: set) -> None:
    if expr.kind == "advice":
        advice_out.add((expr.column.index, expr.rotation))
    elif expr.kind == "fixed":
        fixed_out.add((expr.column.index, expr.rotation))
    if expr.a is not None:
        _collect_queries(expr.a, advice_out, fixed_out)
    if expr.b is not None:
        _collect_queries(expr.b, advice_out, fixed_out)


def _selectors_of(gate) -> set:
    out: set = set()

    def walk(e):
        if e.kind == "selector":
            out.add(e.value)
        if e.a is not None:
            walk(e.a)
        if e.b is not None:
            walk(e.b)

    for poly in gate.polys:
        walk(poly)
    return out


class MockProver:
    def __init__(self, k: int, cs: ConstraintSystem, assignment: _MockAssignment):
        self.k = k
        self.n = 1 << k
        self.cs = cs
        self.a = assignment

    @staticmethod
    def run(k: int, circuit, instance: List[List[int]]) -> "MockProver":
        cs = ConstraintSystem()
        config = type(circuit).configure(cs)
        n = 1 << k
        if n < cs.minimum_rows():
            raise ValueError(f"k = {k} is too small for this circuit")
        usable_rows = n - (cs.blinding_factors() + 1)
        inst = [list(col) + [0] * (n - len(col)) for col in instance]
        assignment = _MockAssignment(n, cs, inst, usable_rows)
        # phase protocol: re-synthesize per phase, revealing deterministic
        # challenge values after each phase (mirrors prover.rs:299-391)
        for phase in cs.phases():
            assignment.regions.clear()
            planner_for(circuit).synthesize(assignment, circuit, config, cs.constants)
            for ch_idx, ch_phase in enumerate(cs.challenge_phase):
                if ch_phase == phase + 1 and ch_idx not in assignment.challenges:
                    digest = hashlib.blake2b(
                        f"mock-challenge-{ch_idx}".encode(), digest_size=32).digest()
                    assignment.challenges[ch_idx] = int.from_bytes(digest, "little") % P
        return MockProver(k, cs, assignment)

    def _region_of(self, row: int) -> str:
        return self._loc(row).region or "?"

    def _loc(self, row: int) -> FailureLocation:
        for name, lo, hi in self.a.regions:
            if lo <= row <= hi:
                return FailureLocation(str(name), row)
        return FailureLocation(None, row)

    def _cell_values(self, expr: Expression, row: int) -> List[Tuple[str, int]]:
        """Every cell the expression reads at `row`, with its value — the
        emitter's assignment listing (failure/emitter.rs:96-170)."""
        out: List[Tuple[str, int]] = []
        seen = set()

        def walk(e):
            if e.kind in ("advice", "fixed", "instance"):
                key = (e.kind, e.column.index, e.rotation)
                if key not in seen:
                    seen.add(key)
                    rot = f"@{e.rotation}" if e.rotation else ""
                    out.append((f"{e.kind}[{e.column.index}]{rot}",
                                self._cell(e.kind, e.column.index,
                                           row + e.rotation)))
            elif e.kind == "challenge" and ("ch", e.value) not in seen:
                seen.add(("ch", e.value))
                out.append((f"challenge[{e.value}]",
                            self.a.challenges.get(e.value, 0)))
            if e.a is not None:
                walk(e.a)
            if e.b is not None:
                walk(e.b)

        walk(expr)
        return out

    # ------------------------------------------------------------------
    def _cell(self, kind: str, col_index: int, row: int) -> int:
        row %= self.n
        if kind == "advice":
            return self.a.advice[col_index][row]
        if kind == "fixed":
            return self.a.fixed[col_index][row]
        if kind == "instance":
            return self.a.instance[col_index][row]
        raise ValueError(kind)

    def _eval(self, expr: Expression, row: int) -> int:
        ops = {
            "const": lambda v: v,
            "selector": lambda e: 1 if self.a.selectors[e.value][row] else 0,
            "fixed": lambda e: self._cell("fixed", e.column.index, row + e.rotation),
            "advice": lambda e: self._cell("advice", e.column.index, row + e.rotation),
            "instance": lambda e: self._cell("instance", e.column.index, row + e.rotation),
            "challenge": lambda e: self.a.challenges.get(e.value, 0),
            "neg": lambda a: (-a) % P,
            "sum": lambda a, b: (a + b) % P,
            "prod": lambda a, b: (a * b) % P,
            "scaled": lambda a, v: (a * v) % P,
        }
        # evaluate_lazy: zero-product short-circuit — selector-gated gates
        # skip the whole constraint body on inactive rows
        # (reference circuit.rs:867-1026)
        return expr.evaluate_lazy(ops, 0)

    def verify(self) -> List[VerifyFailure]:
        failures: List[VerifyFailure] = []
        usable = self.a.usable_rows

        # gates: every poly must vanish on every usable row
        for gate in self.cs.gates:
            for poly_idx, poly in enumerate(gate.polys):
                for row in range(usable):
                    if self._eval(poly, row) != 0:
                        failures.append(VerifyFailure(
                            "gate", gate.name, row,
                            f"(constraint {poly_idx}, region "
                            f"'{self._region_of(row)}')",
                            location=self._loc(row),
                            constraint_index=poly_idx,
                            cell_values=self._cell_values(poly, row)))

        # unassigned-cell coverage: an advice cell queried by a gate that is
        # active on a region row (some fixed/selector factor nonzero there)
        # must have been explicitly assigned (dev.rs:979+ analogue)
        region_rows = set()
        for _, lo, hi in self.a.regions:
            region_rows.update(range(lo, min(hi + 1, usable)))
        for gate in self.cs.gates:
            queries = set()
            gates_fixed = set()
            for poly in gate.polys:
                _collect_queries(poly, queries, gates_fixed)
            if not gates_fixed:
                continue
            for row in sorted(region_rows):
                active = any(
                    self._cell("fixed", ci, row + rot) != 0
                    for ci, rot in gates_fixed) or any(
                    self.a.selectors[si][row] for si in _selectors_of(gate))
                if not active:
                    continue
                for ci, rot in queries:
                    r = (row + rot) % self.n
                    if r < usable and not self.a.advice_assigned[ci][r]:
                        failures.append(VerifyFailure(
                            "unassigned", gate.name, r,
                            f"advice[{ci}] queried by an active gate but "
                            f"never assigned",
                            location=self._loc(r), column=f"advice[{ci}]"))

        # dynamic lookups: each input row (theta-compressed tuple) must appear
        # in the table tuple set
        for lk in self.cs.lookups:
            table_rows = set()
            for row in range(usable):
                table_rows.add(tuple(self._eval(t, row) for t in lk.table_expressions))
            for row in range(usable):
                inp = tuple(self._eval(i, row) for i in lk.input_expressions)
                if inp not in table_rows:
                    failures.append(VerifyFailure(
                        "lookup", lk.name, row, f"{inp}",
                        location=self._loc(row),
                        cell_values=[(f"input[{i}]", v)
                                     for i, v in enumerate(inp)]))

        # static lookups (improvement over the reference MockProver)
        for sl in self.cs.static_lookups:
            tables = []
            for tid in sl.table_ids:
                t = self.a.static_tables.get(tid)
                if t is None:
                    failures.append(VerifyFailure(
                        "static_lookup", sl.name, -1, f"table {tid.name} not registered"))
                    tables = None
                    break
                tables.append(t)
            if tables is None:
                continue
            values = [getattr(t.opened, "values", t.opened) if t.opened is not None else None
                      for t in tables]
            if any(v is None for v in values):
                continue  # committed-only tables can't be checked in the mock
            row_sets = set(zip(*values))
            for row in range(usable):
                tup = tuple(self._eval(e, row) for e in sl.input_expressions)
                if tup not in row_sets:
                    failures.append(VerifyFailure(
                        "static_lookup", sl.name, row, f"{tup}",
                        location=self._loc(row),
                        cell_values=[(f"input[{i}]", v)
                                     for i, v in enumerate(tup)]))

        # permutation: copy constraints must hold
        for (ca, ra, cb, rb) in self.a.copies:
            va = self._cell(ca.kind, ca.index, ra)
            vb = self._cell(cb.kind, cb.index, rb)
            if va != vb:
                failures.append(VerifyFailure(
                    "permutation", f"{ca}={cb}", ra, f"{va} != {vb} (row {rb})",
                    location=self._loc(ra), column=f"{ca.kind}[{ca.index}]",
                    cell_values=[(f"{ca.kind}[{ca.index}]@row{ra}", va),
                                 (f"{cb.kind}[{cb.index}]@row{rb}", vb)]))
        return failures

    def assert_satisfied(self) -> None:  # noqa: D102
        failures = self.verify()
        if failures:
            raise AssertionError(
                "circuit not satisfied:\n" + emit_failures(failures))
